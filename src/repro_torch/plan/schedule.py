"""SegmentSchedule — heterogeneous per-segment execution plans.

The paper's whole point is that abstract processors are *not*
interchangeable: PFFT-FPM feeds each processor its own row count and
PFFT-FPM-PAD its own pad length, both read off that processor's speed
function.  Yet until this module the planner forced one global
``PlanConfig`` onto every segment — the exact homogeneity assumption the
FPM technique exists to break.  A ``SegmentSchedule`` is the ordered list
of ``(segment, PlanConfig)`` entries that replaces it:

* ``SegmentPlan`` — one non-empty segment: which processor (``index``),
  how many rows, the *effective FFT length* it transforms at (N, its
  FPM-chosen ``N_padded_i``, or its Bluestein length), and the
  ``PlanConfig`` variant it executes with.
* ``SegmentSchedule`` — the frozen, hashable sequence of those entries
  for one N x N problem.  ``homogeneous(...)`` builds the degenerate
  schedule a single config implies (the ``config=`` API shim);
  ``batch_groups()`` groups entries by ``(length, config)`` — the
  dispatch plan the executor (``repro_torch.core.pfft``) runs, generalising
  ``plan_segment_batches``'s by-length-only grouping.

Schedules are the wisdom wire format from schema v2 on
(``to_dict``/``from_dict``), so a tuner that once picked "slow segment
keeps the library FFT, pow2-padded fast segments take the CUDA kernel"
serves that exact mix to every later session.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Sequence

import numpy as np

from repro_torch.plan.config import PlanConfig

__all__ = ["SegmentPlan", "SegmentSchedule"]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One segment's entry: processor ``index`` runs ``rows`` row-FFTs at
    effective ``length`` under ``config``."""

    index: int
    rows: int
    length: int
    config: PlanConfig

    def __post_init__(self) -> None:
        if self.rows <= 0:
            raise ValueError(f"segment {self.index}: rows must be > 0, got {self.rows}")
        if self.length <= 0:
            raise ValueError(
                f"segment {self.index}: length must be > 0, got {self.length}")
        if not isinstance(self.config, PlanConfig):
            raise TypeError(
                f"segment {self.index}: config must be a PlanConfig, "
                f"got {type(self.config).__name__}")

    def to_dict(self) -> dict[str, Any]:
        return {"index": self.index, "rows": self.rows,
                "length": self.length, "config": self.config.to_dict()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SegmentPlan":
        known = {"index", "rows", "length", "config"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SegmentPlan fields: {sorted(unknown)}")
        return cls(index=int(d["index"]), rows=int(d["rows"]),
                   length=int(d["length"]),
                   config=PlanConfig.from_dict(d["config"]))


def _effective_length(n: int, pad_lengths, i: int) -> int:
    """Effective FFT length of segment i: N, or its pad/Bluestein length."""
    if pad_lengths is not None and int(pad_lengths[i]) > n:
        return int(pad_lengths[i])
    return n


@dataclasses.dataclass(frozen=True)
class SegmentSchedule:
    """Ordered per-segment plans for one N x N problem (frozen, hashable)."""

    n: int
    entries: tuple[SegmentPlan, ...]

    def __post_init__(self) -> None:
        if not self.entries:
            raise ValueError("a SegmentSchedule needs at least one entry")
        object.__setattr__(self, "entries", tuple(self.entries))
        idx = [e.index for e in self.entries]
        if any(b <= a for a, b in zip(idx, idx[1:])):
            raise ValueError(
                f"entries must have strictly ascending segment indices, got {idx}")
        if self.total_rows > self.n:
            raise ValueError(
                f"entries cover {self.total_rows} rows, more than N={self.n}")

    # ---- construction ---------------------------------------------------

    @classmethod
    def from_parts(cls, n: int, d, pad_lengths,
                   configs: Sequence[PlanConfig]) -> "SegmentSchedule":
        """Build from a distribution + per-segment pad lengths + configs.

        ``d=None`` means one whole-matrix segment (the cost model's
        convention).  Empty segments (``d[i] == 0``) get no entry, like
        every executor loop in ``repro_torch.core.pfft``.
        """
        if d is None:
            return cls(n=n, entries=(SegmentPlan(
                index=0, rows=n, length=_effective_length(n, pad_lengths, 0),
                config=configs[0]),))
        d = np.asarray(d)
        entries = []
        for i, rows in enumerate(d):
            if rows <= 0:
                continue
            entries.append(SegmentPlan(
                index=i, rows=int(rows),
                length=_effective_length(n, pad_lengths, i),
                config=configs[i]))
        return cls(n=n, entries=tuple(entries))

    @classmethod
    def homogeneous(cls, config: PlanConfig, n: int, d=None,
                    pad_lengths=None) -> "SegmentSchedule":
        """The degenerate schedule one global config used to imply — the
        bridge that keeps the ``config=`` API a thin shim."""
        p = 1 if d is None else len(np.asarray(d))
        return cls.from_parts(n, d, pad_lengths, [config] * p)

    # ---- views ----------------------------------------------------------

    def __iter__(self) -> Iterator[SegmentPlan]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def total_rows(self) -> int:
        return sum(e.rows for e in self.entries)

    @property
    def common_config(self) -> PlanConfig | None:
        """The single config shared by every entry, or None when mixed."""
        cfgs = {e.config for e in self.entries}
        return next(iter(cfgs)) if len(cfgs) == 1 else None

    @property
    def configs(self) -> tuple[PlanConfig, ...]:
        """Distinct configs in first-appearance order."""
        seen: dict[PlanConfig, None] = {}
        for e in self.entries:
            seen.setdefault(e.config, None)
        return tuple(seen)

    @property
    def anchor_config(self) -> PlanConfig:
        """The representative config: the common one, else the entry with
        the most rows (the makespan-dominant segment) — what
        ``PfftPlan.config`` reports for a heterogeneous schedule."""
        common = self.common_config
        if common is not None:
            return common
        return max(self.entries, key=lambda e: e.rows).config

    def matches(self, d, pad_lengths=None) -> bool:
        """Does this schedule describe exactly the non-empty segments of
        ``d`` (+ pad lengths)?  Wisdom hits from another partition are
        treated as misses via this check."""
        if d is None:
            probe = [(0, self.n)]
        else:
            d = np.asarray(d)
            probe = [(i, int(rows)) for i, rows in enumerate(d) if rows > 0]
        if len(probe) != len(self.entries):
            return False
        return all(e.index == i and e.rows == rows
                   and e.length == _effective_length(self.n, pad_lengths, i)
                   for e, (i, rows) in zip(self.entries, probe))

    # ---- the dispatch plan ----------------------------------------------

    def batch_groups(self) -> list[tuple[int, PlanConfig, np.ndarray]]:
        """Dispatch groups ``[(length, config, row_indices), ...]``.

        Entries sharing ``(length, config)`` share one FFT dispatch —
        ``plan_segment_batches`` generalised from by-length to
        by-(length, config), so a slow segment on the library FFT and a
        same-length fast segment on the kernel land in *different*
        dispatches while same-variant segments still share one.  An entry
        whose config says ``batched=False`` opts out of sharing and gets
        a dispatch of its own (the paper's literal per-group call).
        """
        groups: dict[tuple, tuple[int, PlanConfig, list[np.ndarray]]] = {}
        off = 0
        for e in self.entries:
            key: tuple = (e.length, e.config)
            if not e.config.batched:
                key += (e.index,)
            rows = np.arange(off, off + e.rows, dtype=np.int64)
            if key in groups:
                groups[key][2].append(rows)
            else:
                groups[key] = (e.length, e.config, [rows])
            off += e.rows
        return [(length, cfg, np.concatenate(idx))
                for length, cfg, idx in groups.values()]

    # ---- wisdom wire format ---------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {"n": self.n, "entries": [e.to_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SegmentSchedule":
        known = {"n", "entries"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SegmentSchedule fields: {sorted(unknown)}")
        return cls(n=int(d["n"]),
                   entries=tuple(SegmentPlan.from_dict(e) for e in d["entries"]))

    def describe(self) -> str:
        """Compact human tag: one ``rows@length:variant`` term per dispatch
        group, e.g. ``24@96:radix=xla,batched + 72@128:radix=4,batched``."""
        return " + ".join(
            f"{len(idx)}@{length}:{cfg.describe()}"
            for length, cfg, idx in self.batch_groups())
