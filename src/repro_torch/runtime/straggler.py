"""Straggler detection + FPM-based work re-partitioning.

Counterpart of ``repro.runtime.straggler`` (numpy over the port's
``core.fpm`` and ``core.partition``).  A device that slows down (thermal
throttle, failing memory, noisy neighbour) drags every synchronous step.
The monitor keeps an EWMA of each group's observed step time; when a group
drifts past ``threshold`` x the median, it synthesises *degraded speed
functions* (observed slowdown folded into the group's FPM) and re-runs
HPOPTA — the paper's heterogeneous partitioning case applied online.  The
caller applies the new distribution at the next call boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fpm import FPMSet, SpeedFunction
from repro_torch.core.partition import PartitionResult, hpopta

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    n_groups: int
    alpha: float = 0.2          # EWMA factor
    threshold: float = 1.3      # drift multiple of the median that triggers

    def __post_init__(self):
        self._ewma = np.full(self.n_groups, np.nan)

    def record(self, group: int, step_time: float) -> None:
        if np.isnan(self._ewma[group]):
            self._ewma[group] = step_time
        else:
            self._ewma[group] = (self.alpha * step_time
                                 + (1 - self.alpha) * self._ewma[group])

    def reset(self) -> None:
        """Forget all observations.  The self-healing runtime calls this
        after a hot-swap: the drift that triggered the re-plan must not
        re-trigger against the new schedule's (different) step times."""
        self._ewma = np.full(self.n_groups, np.nan)

    @property
    def ewma(self) -> np.ndarray:
        return self._ewma.copy()

    def slow_groups(self) -> list[int]:
        if np.any(np.isnan(self._ewma)):
            return []
        med = float(np.median(self._ewma))
        return [i for i, t in enumerate(self._ewma) if t > self.threshold * med]

    def relative_speeds(self) -> np.ndarray:
        """Normalised observed speeds (1.0 = median group).

        Groups without a sample yet are neutral 1.0 — the same warm-up
        guard ``slow_groups`` has, so a partially-warmed monitor never
        leaks NaN into FPM synthesis (the median is taken over the
        sampled groups only)."""
        rel = np.ones(self.n_groups)
        seen = ~np.isnan(self._ewma)
        if not seen.any():
            return rel
        med = float(np.median(self._ewma[seen]))
        if med > 0:
            rel[seen] = med / self._ewma[seen]
        return rel

    def degraded_fpms(self, base: SpeedFunction | FPMSet) -> FPMSet:
        """Per-group speed functions with the observed drift folded in.

        Group ``i``'s baseline speed grid (its own ``FPMSet`` entry, or a
        shared ``SpeedFunction``) is scaled by its observed relative
        speed — the paper's heterogeneous-FPM input, synthesised online.
        This is what the self-healing re-planner hands to
        ``tune_dist_schedule``."""
        rel = self.relative_speeds()
        fns = []
        for i in range(self.n_groups):
            f = base[i] if isinstance(base, FPMSet) else base
            fns.append(SpeedFunction(f.xs, f.ys, f.speed * rel[i],
                                     name=f"group{i}"))
        return FPMSet(fns)

    def repartition(self, base_fpm: SpeedFunction, n_rows: int,
                    y: int) -> PartitionResult | None:
        """If stragglers exist, scale the baseline FPM by each group's
        observed relative speed and re-run HPOPTA.  Returns None when no
        repartition is needed (keeps the current distribution stable)."""
        if not self.slow_groups():
            return None
        curves = [f.time_curve(n_rows, y)
                  for f in self.degraded_fpms(base_fpm)]
        return hpopta(curves, n_rows)
