"""The one traffic generator: a mix file of parameters in, a seeded stream
of requests out.

A mix (``bench/traffic/<cell>.json``)::

    {"loop": "closed",            # or "open": requests sent on a schedule
     "clients": 1,                # closed: callers, each one request in flight
     "rate": null,                # open: requests per second (Poisson arrivals)
     "n": [[1024, 1], [2048, 1]], # signal sides, each with a whole weight
     "batch": {"points": 67108864},  # or a whole number of signals a request
     "rehearse": {"n": [[32, 1]], "batch": 1}}  # sizes of a CPU rehearsal

Every seed sends the same sizes in the same proportions: the stream is made
of blocks that hold each side ``weight`` times, each block in its own seeded
order.  So a seed changes the order of the work and the data, never how
much work there is.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["arrivals", "batch_of", "requests", "shapes", "validate"]

_LOOPS = ("closed", "open")


def validate(t: dict) -> dict:
    """``t`` unchanged, or ValueError naming what is wrong with it."""
    if t.get("loop", "closed") not in _LOOPS:
        raise ValueError(f"loop must be one of {_LOOPS}, got {t.get('loop')!r}")
    if int(t.get("clients", 1)) < 1:
        raise ValueError("clients must be at least 1")
    if t.get("loop") == "open" and not float(t.get("rate") or 0) > 0:
        raise ValueError("an open loop needs a rate above 0 (requests/s)")
    if not t.get("n"):
        raise ValueError("n must list [side, weight] pairs")
    for side, weight in t["n"]:
        if int(side) < 2 or int(weight) < 1:
            raise ValueError(f"bad [side, weight] {[side, weight]}")
        batch_of(t, side)
    return t


def batch_of(t: dict, n: int) -> int:
    """Signals a request of side ``n`` carries: a number, or
    ``{"points": P}`` for P / n² signals (P a multiple of n²)."""
    batch = t.get("batch", 1)
    if isinstance(batch, dict):
        points = int(batch["points"])
        if points % (n * n):
            raise ValueError(f"{points} points a request is no whole number "
                             f"of {n} x {n} signals")
        return points // (n * n)
    if int(batch) < 1:
        raise ValueError("batch must be at least 1")
    return int(batch)


def shapes(t: dict) -> list[tuple[int, int]]:
    """Every (side, batch) the mix sends, in the file's order."""
    return [(int(n), batch_of(t, n)) for n, _ in t["n"]]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, stream])


def requests(t: dict, seed: int) -> Iterator[tuple[int, int]]:
    """The endless stream of (side, batch), in seeded blocks."""
    block = [shape for shape, (_, w) in zip(shapes(t), t["n"])
             for _ in range(int(w))]
    rng = _rng(seed, 1)
    while True:
        for i in rng.permutation(len(block)):
            yield block[i]


def arrivals(t: dict, seed: int) -> Iterator[float]:
    """Seconds from the window's start at which an open loop sends each
    request: Poisson arrivals at ``rate``."""
    rng = _rng(seed, 2)
    mean = 1.0 / float(t["rate"])
    due = 0.0
    while True:
        due += float(rng.exponential(mean))
        yield due
