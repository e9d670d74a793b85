"""Read the program's own spans (``repro_torch.*``, recorded by
``repro_torch._trace.span`` under the profiler) out of a window's trace.

The spans arrive in ``Trace.host_ops``, on the profiler's clock, beside the
CUDA runtime calls that put work on the card.  With one caller and one
stream the card runs that work in launch order, so the i-th launching call
of the window made the i-th device operation by start time; a device
operation belongs to the innermost phase span that holds its launching
call.  Where the two counts differ, nothing is attributed.  Every reader
gives a mean a request done, in ms, and ``None`` where the trace holds no
program span (a program without spans) or nothing to read.
"""

from __future__ import annotations

import bisect

from bench.devtrace import _innermost, union_us

__all__ = ["EXECUTE", "LAUNCH", "PREFIX", "device_ms", "host_ms",
           "launching_calls", "self_ms"]

PREFIX = "repro_torch."
EXECUTE = PREFIX + "execute"
LAUNCH = PREFIX + "launch"
PHASES = (PREFIX + "phase1", PREFIX + "phase2")
# CUDA runtime and driver calls that each put one operation on the card.
LAUNCHING = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")


def _spans(run, name: str | None = None) -> list[tuple[str, float, float]]:
    ops = run.trace.host_ops if run.trace is not None else []
    if name is None:
        return [h for h in ops if h[0].startswith(PREFIX)]
    return [h for h in ops if h[0] == name]


def _per_request(run, total_us: float) -> float | None:
    done = len(run.done)
    return total_us / done / 1e3 if done else None


def _has_program_spans(run) -> bool:
    return bool(_spans(run, EXECUTE))


def host_ms(run, name: str) -> float | None:
    """Host time inside the spans called ``name``."""
    if not _has_program_spans(run):
        return None
    return _per_request(run, union_us([(a, b) for _, a, b in _spans(run, name)]))


def self_ms(run, name: str) -> float | None:
    """Host time inside the spans called ``name`` that no other program span
    within them covers."""
    if not _has_program_spans(run):
        return None
    inner = sorted((a, b) for n, a, b in _spans(run) if n != name)
    starts = [a for a, _ in inner]
    total = 0.0
    for _, a, b in _spans(run, name):
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        total += (b - a) - union_us([(s, min(e, b)) for s, e in inner[lo:hi]])
    return _per_request(run, total)


def launching_calls(run) -> list[tuple[str, float, float]]:
    """The runtime calls in the window that each put an operation on the
    card, in the order they were made."""
    w0, w1 = run.trace.window
    return sorted((h for h in run.trace.host_ops
                   if h[0].startswith(LAUNCHING) and w0 <= h[1] <= w1),
                  key=lambda h: h[1])


def device_ms(run, phase: str) -> float | None:
    """Device time of the operations launched inside the spans called
    ``phase``; ``None`` where the launching calls and the device operations
    do not pair one to one."""
    if not _has_program_spans(run) or not run.trace.device_ops:
        return None
    calls = launching_calls(run)
    ops = sorted(run.trace.device_ops, key=lambda o: o[1])
    if len(calls) != len(ops):
        return None
    phases = sorted((h for h in _spans(run) if h[0] in PHASES), key=lambda h: h[1])
    starts = [h[1] for h in phases]
    total = sum(b - a for (_, t, _), (_, a, b) in zip(calls, ops)
                if _innermost(phases, starts, t) == phase)
    return _per_request(run, total)
