"""The measured window: requests sent in a closed or an open loop, each
timed on the host clock from when it was due to when its answer is ready,
and a seeded sample of the answers kept for the check."""

from __future__ import annotations

import contextlib
import random
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

from bench import traffic as traffic_mod

__all__ = ["Record", "Reservoir", "run_window"]


@dataclass
class Record:
    """One request: its (side, batch), the input slot it used, and host
    seconds (``time.perf_counter``) at which it was due, was sent, had been
    enqueued (the call returned) and was done (the synchronise returned)."""
    shape: tuple[int, int]
    slot: int
    due: float
    start: float
    enqueued: float
    end: float
    ok: bool

    @property
    def latency(self) -> float:
        return self.end - self.due


class Reservoir:
    """One answer of each shape, drawn with the seed uniformly among all
    that the window produced (reservoir sampling), so that the answers held,
    and the memory they take, do not grow with the window.

    ``held`` are placeholders of the same size (set-up's answers), held from
    the window's start so that the memory the harness holds stays the same
    all through it; the window's first answer of a shape replaces its
    placeholder, and ``sampled`` holds the window's answers only."""

    def __init__(self, seed: int, held: dict | None = None):
        self._rng = random.Random(seed)
        self._seen: dict[Any, int] = {}
        self.kept: dict[Any, Any] = dict(held or {})

    def offer(self, key, item) -> None:
        seen = self._seen[key] = self._seen.get(key, 0) + 1
        if self._rng.randrange(seen) == 0:
            self.kept[key] = item

    @property
    def sampled(self) -> dict:
        return {key: item for key, item in self.kept.items() if key in self._seen}


@dataclass
class Window:
    records: list[Record]
    start: float
    end: float
    errors: list[str]

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run_window(t: dict, seed: int, seconds: float,
               call: Callable[[tuple[int, int], int], Any],
               reservoir: Reservoir, *, slots: int,
               client: Callable[[], tuple[Any, Callable[[], None]]],
               span: Callable[[str], Any] = lambda name: contextlib.nullcontext(),
               min_requests: int = 0) -> Window:
    """Send ``t``'s requests for ``seconds``.

    ``call(shape, slot)`` sends one request and returns its answer, maybe
    before the device has made it; the requests of a shape use its
    ``slots`` inputs in turn; ``client()`` gives each caller a context
    to run in and the function that waits for its answers (one CUDA stream
    and its ``synchronize``).  A closed loop keeps ``clients`` callers with
    one request in flight each; an open loop sends on a seeded Poisson
    schedule and times each request from when it was due.  No request is
    sent after ``seconds`` (but the first ``min_requests``); the window ends
    when the last answer is ready.
    """
    stream = traffic_mod.requests(t, seed)
    due_times = (traffic_mod.arrivals(t, seed) if t.get("loop") == "open"
                 else None)
    sent: dict[tuple[int, int], int] = {}
    records: list[Record] = []
    errors: list[str] = []
    lock = threading.Lock()
    start = time.perf_counter()
    stop_at = start + seconds

    def next_request():
        with lock:
            due = None
            if due_times is not None:
                due = start + next(due_times)
                if due >= stop_at:
                    return None
            elif time.perf_counter() >= stop_at and sum(sent.values()) >= min_requests:
                return None
            shape = next(stream)
            slot = sent.get(shape, 0) % slots
            sent[shape] = sent.get(shape, 0) + 1
            return shape, slot, due

    def caller():
        context, sync = client()
        with context:
            while (req := next_request()) is not None:
                shape, slot, due = req
                if due is not None:
                    time.sleep(max(0.0, due - time.perf_counter()))
                t0 = time.perf_counter()
                answer, ok = None, True
                try:
                    with span("bench.execute"):
                        answer = call(shape, slot)
                    t1 = time.perf_counter()
                    with span("bench.sync"):
                        sync()
                except Exception:  # a failed request is counted, not fatal
                    ok, t1 = False, time.perf_counter()
                    with lock:
                        errors.append(traceback.format_exc())
                t2 = time.perf_counter()
                with lock:
                    records.append(Record(shape, slot, t0 if due is None else due,
                                          t0, t1, t2, ok))
                    if ok:
                        reservoir.offer(shape, (slot, answer))
                answer = None

    clients = int(t.get("clients", 1)) if due_times is None else 1
    with span("bench.window"):
        if clients == 1:
            caller()
        else:
            threads = [threading.Thread(target=caller) for _ in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
    end = max((r.end for r in records), default=time.perf_counter())
    return Window(records, start, end, errors)
