"""Reduce a ``torch.profiler`` (CUPTI) trace of the window to what the
per-layer readers need: every device operation (kernels and copies) inside
the window with its interval, the harness's own host spans, the host
operations, and from them the device's busy union and its idle gaps, each
named by what the host was doing."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["Trace", "from_profiler", "idle_gaps", "top_ops", "union_us"]

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    """Intervals in microseconds on the profiler's clock."""
    window: tuple[float, float]
    device_ops: list[tuple[str, float, float]]
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    host_ops: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device_ops]) / 1e6

    @property
    def op_s(self) -> float:
        """The device operations' summed time (overlaps counted twice)."""
        return sum(b - a for _, a, b in self.device_ops) / 1e6


def union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= reach:
            continue
        total += b - max(a, reach)
        reach = b
    return total


def from_profiler(prof) -> Trace:
    """The window of ``bench.window``'s span and what lies in it.  Device
    operations are whatever CUPTI recorded on the card (kernels, copies,
    sets), less the device-side copies of host annotations."""
    from torch.profiler import DeviceType
    device, spans, host = [], [], []
    for e in prof.events():
        name = e.name
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (name.startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                device.append((name, a, b))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, a, b))
        else:
            host.append((name, a, b))
    windows = [(a, b) for name, a, b in spans if name == SPAN_PREFIX + "window"]
    if not windows:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = windows[0]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    return Trace((w0, w1), inside,
                 sorted((s for s in spans if s[0] != SPAN_PREFIX + "window"),
                        key=lambda s: s[1]),
                 sorted((h for h in host if h[2] > w0 and h[1] < w1),
                        key=lambda h: h[1]))


def top_ops(trace: Trace, k: int = 10) -> list[list]:
    """The ``k`` device operations that took most time, by name, in s."""
    by_name: dict[str, float] = {}
    for name, a, b in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:k]]


def _innermost(events: list[tuple[str, float, float]], starts: list[float],
               t: float, reach: int = 256) -> str | None:
    """The latest-starting event that contains ``t`` (events sorted by start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if events[j][2] >= t:
            return events[j][0]
    return None


def idle_gaps(trace: Trace, k: int = 10) -> list[list]:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle: the harness span (``execute``: inside the
    program's call; ``sync``: waiting for the card; ``harness``: between
    requests) and the innermost host operation there; the ``k`` largest."""
    busy = sorted((a, b) for _, a, b in trace.device_ops)
    gaps, reach = [], trace.window[0]
    for a, b in busy:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if trace.window[1] > reach:
        gaps.append((reach, trace.window[1]))
    span_starts = [s[1] for s in trace.spans]
    host_starts = [h[1] for h in trace.host_ops]
    by_label: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        span = _innermost(trace.spans, span_starts, mid)
        label = span[len(SPAN_PREFIX):] if span else "harness"
        op = _innermost(trace.host_ops, host_starts, mid)
        if op:
            label += "/" + op
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda x: -x[1])[:k]]
