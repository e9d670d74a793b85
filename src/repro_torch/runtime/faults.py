"""Deterministic fault injection for the self-healing runtime.

Counterpart of ``repro.runtime.faults``.  Chaos testing a planner needs
faults that are *reproducible* and that cost real work.  The per-process
``FaultInjector`` carries three fault families:

* **Per-rank slowdown** — ``slow_group(device, factor)`` multiplies the
  local-phase work of one mesh position.  The hook
  (``repro_torch.core.pfft_dist._faulted_fft``) wraps that rank's row FFT
  in ``repeated``: the FFT genuinely runs ``factor`` times on
  exactly-rescaled inputs, so wall time scales like a real straggler
  (thermal throttle, noisy neighbour) while the output stays
  bit-identical — no sleeps.
* **Fail-the-kth-execute** — ``fail_execute(call)`` schedules one call of
  a ``ResilientPlan`` to raise (default: ``DeviceLostError``, the elastic
  recovery trigger).  One-shot: the fault clears when it fires, so the
  wrapper's retry proceeds.
* **Wisdom-store chaos** — ``corrupt_wisdom`` tears the JSON in place
  (a crashed writer), ``locked_wisdom`` holds the store's exclusive flock
  (a wedged writer) so ``record_wisdom(lock_timeout_s=...)`` can be
  driven into its timeout path.

The injector is per process: under SPMD every rank sets the same faults,
as a test script does, so every rank takes the same decisions.  The port
runs eagerly, so the hook reads the injector at *call* time (the
reference reads it at trace time); every mutation still bumps ``epoch``.

This module imports nothing of ``repro_torch`` — the injection hook in
``core.pfft_dist`` imports *it* lazily, so no cycle forms.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

__all__ = ["DeviceLostError", "FaultInjector", "get_injector", "inject",
           "lost_host", "repeated", "retry_with_backoff", "corrupt_wisdom",
           "locked_wisdom"]


class DeviceLostError(RuntimeError):
    """A device (or host) dropped out of the mesh.

    ``lost`` names the positions along the FFT mesh axis that died; empty
    means "unknown — re-derive the survivors" (``ResilientPlan`` does so
    by a check-in on the process group's store).
    """

    def __init__(self, lost: Sequence[int] = (), message: str | None = None):
        self.lost = tuple(int(i) for i in lost)
        super().__init__(message or f"device(s) lost at mesh positions "
                         f"{list(self.lost) or '<unknown>'}")


def lost_host(host: int, local: int) -> tuple[int, ...]:
    """Mesh-axis positions of host ``host`` on a host-major FFT axis with
    ``local`` devices per host — the ``lost=`` payload of a whole-host
    ``DeviceLostError``."""
    host, local = int(host), int(local)
    return tuple(range(host * local, (host + 1) * local))


class FaultInjector:
    """Per-process fault switchboard (see module docstring)."""

    def __init__(self):
        self.epoch = 0
        self.log: list[dict] = []
        self._slow: dict[int, int] = {}      # mesh position -> repeat count
        self._fail_at: dict[int, BaseException] = {}  # call index -> exc

    def _record(self, kind: str, **fields) -> None:
        # "wall" stamps are monotonic (perf_counter), only ever *subtracted*
        # against other stamps — never interpreted as an absolute epoch.
        self.log.append({"kind": kind, "wall": time.perf_counter(), **fields})

    # ---- per-device slowdown ----

    def slow_group(self, device: int, factor: float) -> None:
        """Multiply mesh position ``device``'s local-phase work by
        ``factor`` (rounded to an integer repeat count; <= 1 clears)."""
        reps = max(int(round(factor)), 1)
        if reps <= 1:
            self._slow.pop(int(device), None)
        else:
            self._slow[int(device)] = reps
        self.epoch += 1
        self._record("slow_group", device=int(device), repeats=reps)

    def local_repeats(self, p: int) -> list[int] | None:
        """Per-position repeat counts for a ``p``-device FFT axis, or
        None when no slowdown is active (the hook's zero-overhead path)."""
        if not self._slow:
            return None
        reps = [int(self._slow.get(i, 1)) for i in range(int(p))]
        return reps if any(r > 1 for r in reps) else None

    def repeat_for(self, device: int) -> int:
        return int(self._slow.get(int(device), 1))

    # ---- scheduled execute failures ----

    def fail_execute(self, call: int, exc: BaseException | None = None, *,
                     lost: Sequence[int] = ()) -> None:
        """Make the ``call``-th execute (0-based) raise ``exc`` (default:
        ``DeviceLostError`` over ``lost``)."""
        if exc is None:
            exc = DeviceLostError(lost=lost)
        self._fail_at[int(call)] = exc
        self._record("fail_execute", call=int(call), exc=type(exc).__name__)

    def fail_host(self, call: int, host: int, local: int) -> None:
        """Make the ``call``-th execute raise ``DeviceLostError`` over a
        *whole host* of a host-major FFT axis: positions
        ``host*local .. host*local + local - 1`` (``local`` devices per
        host).  The whole-host-granular loss is the one the elastic
        rebuild can keep host-major — the recovery path must re-plan
        under a reduced host count, not a flat axis."""
        self.fail_execute(call, lost=lost_host(host, local))

    def check_execute(self, call: int) -> None:
        exc = self._fail_at.pop(int(call), None)
        if exc is not None:
            self._record("execute_failed", call=int(call),
                         exc=type(exc).__name__)
            raise exc

    # ---- lifecycle ----

    @property
    def active(self) -> bool:
        return bool(self._slow or self._fail_at)

    def clear(self) -> None:
        had_slow = bool(self._slow)
        self._slow.clear()
        self._fail_at.clear()
        if had_slow:
            self.epoch += 1
        self._record("clear")


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


@contextlib.contextmanager
def inject():
    """Scoped injection: yields the process's injector, clears it on exit
    (the epoch advances)."""
    inj = get_injector()
    try:
        yield inj
    finally:
        inj.clear()


def repeated(fn: Callable, reps: int) -> Callable:
    """Run linear ``fn`` ``reps`` times with the extra work feeding the
    output, returning output bit-identical to one run.

    Repeat ``k`` feeds ``x * 2**e_k`` and rescales by the same power of
    two — exact in floating point — then folds with ``0.5 * (out +
    out_k)`` (exact when the operands are equal), so the output equals
    one run's bit for bit whenever ``fn`` is deterministic (the CUDA row
    kernels are).  The distinct scales and the fold are what keep every
    repeat real work under a compiler too.  Exponents cycle through
    1..20; the realistic straggler range (2-8x) is far below that.
    """
    reps = int(reps)
    if reps <= 1:
        return fn

    def run(x):
        out = fn(x)
        for k in range(1, reps):
            scale = 2.0 ** (1 + (k - 1) % 20)
            out = 0.5 * (out + fn(x * scale) / scale)
        return out

    return run


def retry_with_backoff(fn: Callable, *, attempts: int = 3,
                       base_s: float = 0.05, factor: float = 2.0,
                       exceptions: tuple = (Exception,),
                       sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff;
    re-raises the last failure when the budget is exhausted."""
    delay = float(base_s)
    for attempt in range(max(int(attempts), 1)):
        try:
            return fn()
        except exceptions:
            if attempt >= attempts - 1:
                raise
            sleep(delay)
            delay *= factor


# ---- wisdom-store chaos ----

def corrupt_wisdom(path: str) -> None:
    """Tear the wisdom store in place — truncated JSON, as a writer that
    crashed mid-write (without the atomic-replace discipline) would
    leave.  Readers must treat it as a miss, never an error."""
    with open(path, "w") as fh:
        fh.write('{"version": 3, "entries": {')


@contextlib.contextmanager
def locked_wisdom(path: str):
    """Hold the store's exclusive flock for the duration of the block, so
    a concurrent ``record_wisdom(lock_timeout_s=...)`` sees a wedged
    writer and times out instead of blocking forever."""
    import fcntl
    fh = open(path + ".lock", "w")
    try:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield
    finally:
        fh.close()
