"""Functional Performance Models (FPMs).

The paper's central data structure: a *discrete 3-D speed function*

    S_i = { ((x, y), s_i(x, y)) }

where ``s_i(x, y)`` is the speed of abstract processor ``i`` executing ``x``
row 1-D FFTs of length ``y``.  Speed follows the paper's normalisation

    s(x, y) = 2.5 * x * y * log2(y) / t

with ``t`` the wall time of the run (so "speed" is FLOP/s under the standard
5/2 * N log2 N complex-FFT flop count).

FPMs are host-side model objects (numpy), built either from real measurements
(``build_fpm`` with a timing callback) or synthetically (tests / dry-runs).
They are the *input* to the partitioning (POPTA/HPOPTA) and padding
algorithms; nothing in here touches a device.  The ``.npz`` + ``.json``
sidecar format of ``save_fpms``/``load_fpms`` is the one ``repro.core.fpm``
writes, so either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "SpeedFunction",
    "FPMSet",
    "fft_flops",
    "build_fpm",
    "save_fpms",
    "load_fpms",
]


def fft_flops(x: np.ndarray | float, y: np.ndarray | float) -> np.ndarray:
    """Paper's flop count for ``x`` complex 1-D FFTs of length ``y``: 2.5·x·y·log2 y."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return 2.5 * x * y * np.log2(np.maximum(y, 2.0))


@dataclasses.dataclass
class SpeedFunction:
    """Discrete speed function s(x, y) of one abstract processor.

    ``xs``: 1-D int array of row-count sample points (ascending).
    ``ys``: 1-D int array of row-length sample points (ascending).
    ``speed``: float array of shape (len(xs), len(ys)); NaN marks unmeasured
    points (e.g. sizes that exceed memory, paper §V-B).
    """

    xs: np.ndarray
    ys: np.ndarray
    speed: np.ndarray
    name: str = "P"

    def __post_init__(self) -> None:
        self.xs = np.asarray(self.xs, dtype=np.int64)
        self.ys = np.asarray(self.ys, dtype=np.int64)
        self.speed = np.asarray(self.speed, dtype=np.float64)
        if self.speed.shape != (len(self.xs), len(self.ys)):
            raise ValueError(
                f"speed shape {self.speed.shape} != ({len(self.xs)}, {len(self.ys)})"
            )
        if np.any(np.diff(self.xs) <= 0) or np.any(np.diff(self.ys) <= 0):
            raise ValueError("xs / ys sample points must be strictly ascending")
        if np.any(self.speed[np.isfinite(self.speed)] <= 0):
            raise ValueError("speeds must be positive")

    # ---- plane sections (paper Figs 9-12) ----

    def section_y(self, y: int) -> np.ndarray:
        """Intersect with the plane ``y = const``: speed vs x (len(xs),).

        Linear interpolation along y when ``y`` is off-grid (clamped at ends).
        """
        return self._interp_along(self.ys, self.speed, y, axis=1)

    def section_x(self, x: int) -> np.ndarray:
        """Intersect with the plane ``x = const``: speed vs y (len(ys),)."""
        return self._interp_along(self.xs, self.speed, x, axis=0)

    @staticmethod
    def _interp_along(grid: np.ndarray, table: np.ndarray, v: float, axis: int) -> np.ndarray:
        v = float(np.clip(v, grid[0], grid[-1]))
        j = int(np.searchsorted(grid, v, side="right") - 1)
        j = min(max(j, 0), len(grid) - 2) if len(grid) > 1 else 0
        if len(grid) == 1:
            return np.take(table, 0, axis=axis)
        g0, g1 = float(grid[j]), float(grid[j + 1])
        w = 0.0 if g1 == g0 else (v - g0) / (g1 - g0)
        lo = np.take(table, j, axis=axis)
        hi = np.take(table, j + 1, axis=axis)
        # NaN-safe: if one endpoint unmeasured, fall back to the other.
        out = (1.0 - w) * lo + w * hi
        out = np.where(np.isnan(out), np.where(np.isnan(lo), hi, lo), out)
        return out

    # ---- time queries ----

    def speed_at(self, x: float, y: float) -> float:
        """Bilinear interpolation of speed at (x, y)."""
        col = self._interp_along(self.ys, self.speed, y, axis=1)  # (len(xs),)
        return float(self._interp_along(self.xs, col[:, None], x, axis=0)[0])

    def time_at(self, x: float, y: float) -> float:
        """Predicted execution time of x row-FFTs of length y (x=0 -> 0)."""
        if x <= 0:
            return 0.0
        s = self.speed_at(x, y)
        if not np.isfinite(s) or s <= 0:
            return float("inf")
        return float(fft_flops(x, y) / s)

    def time_curve(self, n_rows: int, y: float) -> np.ndarray:
        """Time of assigning 0..n_rows rows of length y: array (n_rows+1,).

        This is the per-row-granularity time function handed to POPTA/HPOPTA;
        speed is linearly interpolated between the x sample points.
        """
        xs_f = np.arange(n_rows + 1, dtype=np.float64)
        sec = self.section_y(int(round(y)))  # speed vs xs grid at this y
        valid = np.isfinite(sec)
        if not np.any(valid):
            t = np.full(n_rows + 1, np.inf)
            t[0] = 0.0
            return t
        sp = np.interp(xs_f, self.xs[valid].astype(np.float64), sec[valid])
        t = fft_flops(xs_f, y) / np.maximum(sp, 1e-30)
        t[0] = 0.0
        return t


@dataclasses.dataclass
class FPMSet:
    """The full model input S = {S_1, ..., S_p} of PFFT-FPM."""

    functions: list[SpeedFunction]

    @property
    def p(self) -> int:
        return len(self.functions)

    def __iter__(self):
        return iter(self.functions)

    def __getitem__(self, i: int) -> SpeedFunction:
        return self.functions[i]

    def max_variation_at_plane(self, y: int) -> float:
        """max over x-grid of (max_i s_i - min_i s_i) / min_i s_i  (paper Step 1b)."""
        curves = np.stack([f.section_y(y) for f in self.functions])  # (p, m)
        ok = np.all(np.isfinite(curves), axis=0)
        if not np.any(ok):
            return 0.0
        hi = curves[:, ok].max(axis=0)
        lo = curves[:, ok].min(axis=0)
        return float(np.max((hi - lo) / np.maximum(lo, 1e-30)))

    def averaged(self) -> SpeedFunction:
        """S_avg with s_avg = p / sum_j 1/s_j  (harmonic mean, paper Step 1c)."""
        f0 = self.functions[0]
        inv = np.zeros_like(f0.speed)
        for f in self.functions:
            if f.speed.shape != f0.speed.shape:
                raise ValueError("averaging requires a common (xs, ys) grid")
            inv = inv + 1.0 / f.speed
        return SpeedFunction(f0.xs, f0.ys, self.p / inv, name="S_avg")


def build_fpm(
    xs: Sequence[int],
    ys: Sequence[int],
    timer: Callable[[int, int], float],
    name: str = "P",
) -> SpeedFunction:
    """Build a speed function by timing ``timer(x, y) -> seconds`` on a grid.

    ``timer`` returning NaN/inf marks the point unmeasured (paper: memory cap).
    """
    xs = np.asarray(list(xs), dtype=np.int64)
    ys = np.asarray(list(ys), dtype=np.int64)
    sp = np.full((len(xs), len(ys)), np.nan)
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            t = float(timer(int(x), int(y)))
            if np.isfinite(t) and t > 0:
                sp[i, j] = fft_flops(x, y) / t
    return SpeedFunction(xs, ys, sp, name=name)


def save_fpms(path: str, fpms: FPMSet) -> None:
    arrs: dict[str, np.ndarray] = {}
    meta = []
    for i, f in enumerate(fpms):
        arrs[f"xs_{i}"] = f.xs
        arrs[f"ys_{i}"] = f.ys
        arrs[f"speed_{i}"] = f.speed
        meta.append(f.name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, p=np.int64(fpms.p), **arrs)
    os.replace(tmp, path)
    with open(path + ".json", "w") as fh:
        json.dump({"names": meta}, fh)


def load_fpms(path: str) -> FPMSet:
    data = np.load(path)
    p = int(data["p"])
    names = ["P"] * p
    if os.path.exists(path + ".json"):
        with open(path + ".json") as fh:
            names = json.load(fh)["names"]
    fns = [
        SpeedFunction(data[f"xs_{i}"], data[f"ys_{i}"], data[f"speed_{i}"], name=names[i])
        for i in range(p)
    ]
    return FPMSet(fns)
