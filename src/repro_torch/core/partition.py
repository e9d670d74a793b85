"""POPTA / HPOPTA data-partitioning algorithms (paper Step 1, Alg. 2).

Given discrete speed functions of ``p`` abstract processors and a workload of
``n`` rows, find an integer distribution ``d`` (sum = n) minimising the
parallel execution time ``max_i t_i(d_i)``.  Because the time functions are
arbitrary discrete profiles (non-monotonic, non-convex — that is the whole
point of the paper), the optimum may be *load-imbalanced*.

Algorithmic contract follows Lastovetsky & Reddy (POPTA, homogeneous —
identical speed functions) and Khaleghzadeh et al. (HPOPTA, heterogeneous).
We implement the min-max partition exactly:

  * candidate makespans tau are the values of the time curves;
  * binary search for the smallest feasible tau;
  * feasibility of tau = subset-sum reachability over the per-processor
    allowed sets {x : t_i(x) <= tau}, computed with FFT convolutions of 0/1
    indicator vectors (O(p * n log n) per check);
  * backtracking recovers a witness distribution, preferring assignments with
    smaller predicted time (secondary objective).

This is exact on the per-row-granularity time curves produced by
``SpeedFunction.time_curve`` (linear interpolation between FPM sample points,
which is also what the original works assume between measured points).
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:  # scipy is optional; np.convolve fallback below is fine for small n
    from scipy.signal import fftconvolve as _fftconvolve
except Exception:  # pragma: no cover
    _fftconvolve = None

from repro_torch.core.fpm import FPMSet, SpeedFunction

__all__ = [
    "PartitionResult",
    "popta",
    "hpopta",
    "lb_partition",
    "partition_rows",
]


@dataclasses.dataclass
class PartitionResult:
    d: np.ndarray  # (p,) int64 distribution, sum == n
    tau: float  # predicted makespan max_i t_i(d_i)
    method: str  # "POPTA" | "HPOPTA" | "LB"
    predicted_times: np.ndarray  # (p,) per-processor predicted times

    def __post_init__(self) -> None:
        self.d = np.asarray(self.d, dtype=np.int64)
        self.predicted_times = np.asarray(self.predicted_times, dtype=np.float64)


def _conv01(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Boolean 'sum reachability' convolution, truncated to length n+1."""
    if _fftconvolve is not None and len(a) * len(b) > 1 << 16:
        c = _fftconvolve(a.astype(np.float64), b.astype(np.float64))[: n + 1]
        return c > 0.5
    c = np.convolve(a.astype(np.float64), b.astype(np.float64))[: n + 1]
    return c > 0.5


def _feasible(time_curves: list[np.ndarray], n: int, tau: float, keep: bool = False):
    """Is there d (sum=n) with t_i(d_i) <= tau for all i?  Optionally keep
    the per-prefix reach arrays for backtracking."""
    reach = np.zeros(n + 1, dtype=bool)
    reach[0] = True
    prefixes = [reach.copy()] if keep else None
    for t in time_curves:
        allowed = (t <= tau).astype(np.float64)
        if not allowed.any():
            return (False, None) if keep else False
        reach = _conv01(reach, allowed, n)
        if keep:
            prefixes.append(reach.copy())
        if not reach.any():
            return (False, None) if keep else False
    ok = bool(reach[n])
    return (ok, prefixes) if keep else ok


def hpopta(time_curves: list[np.ndarray], n: int) -> PartitionResult:
    """Exact heterogeneous min-max partition of n rows over p processors.

    ``time_curves[i]`` has length n+1; entry x is the predicted time of
    assigning x rows to processor i (entry 0 must be 0; inf = infeasible).
    """
    p = len(time_curves)
    curves = [np.asarray(t, dtype=np.float64) for t in time_curves]
    for t in curves:
        if len(t) != n + 1:
            raise ValueError("each time curve must have length n+1")
        if t[0] != 0.0:
            raise ValueError("t(0) must be 0")

    cand = np.unique(np.concatenate([t[np.isfinite(t)] for t in curves]))
    cand = cand[cand >= 0.0]
    if len(cand) == 0:
        raise ValueError("no finite time values — cannot partition")

    # Binary search the smallest feasible candidate makespan.
    lo, hi = 0, len(cand) - 1
    if not _feasible(curves, n, float(cand[hi])):
        raise ValueError("workload infeasible even at max tau (all-inf curves?)")
    while lo < hi:
        mid = (lo + hi) // 2
        if _feasible(curves, n, float(cand[mid])):
            hi = mid
        else:
            lo = mid + 1
    tau = float(cand[lo])

    _, prefixes = _feasible(curves, n, tau, keep=True)
    # Backtrack: walk processors in reverse, picking for each an allowed x
    # such that the remaining sum stays reachable by the prefix before it.
    d = np.zeros(p, dtype=np.int64)
    rem = n
    for i in range(p - 1, -1, -1):
        t = curves[i]
        xs = np.arange(rem + 1)
        ok = (t[: rem + 1] <= tau) & prefixes[i][rem - xs]
        if not ok.any():  # pragma: no cover — cannot happen if feasible
            raise RuntimeError("backtracking failed")
        ok_xs = xs[ok]
        # Secondary objective: among feasible choices, smallest predicted time.
        d[i] = int(ok_xs[np.argmin(t[ok_xs])])
        rem -= int(d[i])
    assert rem == 0
    times = np.array([curves[i][d[i]] for i in range(p)])
    return PartitionResult(d=d, tau=tau, method="HPOPTA", predicted_times=times)


def popta(time_curve: np.ndarray, p: int, n: int) -> PartitionResult:
    """Homogeneous case: one (averaged) time curve shared by all p processors."""
    res = hpopta([time_curve] * p, n)
    return PartitionResult(d=res.d, tau=res.tau, method="POPTA",
                           predicted_times=res.predicted_times)


def lb_partition(n: int, p: int) -> PartitionResult:
    """PFFT-LB distribution: rows split as evenly as possible."""
    base, extra = divmod(n, p)
    d = np.full(p, base, dtype=np.int64)
    d[:extra] += 1
    return PartitionResult(d=d, tau=float("nan"), method="LB",
                           predicted_times=np.full(p, np.nan))


def partition_rows(n: int, fpms: FPMSet, eps: float, y: int | None = None) -> PartitionResult:
    """Paper Algorithm 2 (PARTITION).

    Sections the speed functions by the plane y = N; if the max pointwise
    variation exceeds ``eps`` the functions are heterogeneous -> HPOPTA, else
    the harmonic-average function is built and POPTA is used.
    """
    y = n if y is None else y
    variation = fpms.max_variation_at_plane(y)
    if variation > eps:
        curves = [f.time_curve(n, y) for f in fpms]
        return hpopta(curves, n)
    avg: SpeedFunction = fpms.averaged()
    return popta(avg.time_curve(n, y), fpms.p, n)
