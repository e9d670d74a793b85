"""PlanConfig — the single description of *how* a PFFT executes.

Counterpart of ``repro.plan.config``: same seven fields, same validation,
same ``to_dict`` wire format, so a config crosses between the packages as a
plain dict.  One hashable value names an execution variant:

* ``radix`` selects the row-FFT implementation: ``None`` is the library
  FFT (``torch.fft``), ``2`` the pure-tensor radix-2 Stockham, ``4`` the
  CUDA radix-4 kernel (half the passes).
* ``fused`` runs each (row FFT, transpose) phase as one fused kernel
  launch — no intermediate matrix in device memory.
* ``batched`` groups same-length segments into one FFT dispatch per
  distinct plan (``plan_segment_batches``).
* ``pad`` names the padding strategy: ``"none"``, ``"fpm"`` (FPM-chosen
  pad-and-crop, the paper's PFFT-FPM-PAD / distributed ``'crop'``), or
  ``"czt"`` (exact Bluestein at a model-chosen length).
* ``pipeline_panels`` software-pipelines the distributed all_to_all
  against per-panel FFTs (``pfft2_distributed``).
* ``real`` runs the real-input half-spectrum pipeline: the row phase is
  an rfft (two real rows packed per complex FFT), the column phase works
  on ``N//2+1`` spectral columns, and the distributed transpose moves
  ~half the bytes.  Incompatible with ``pad="czt"`` — Bluestein has no
  half-spectrum form here.
* ``exchange`` names the distributed-transpose collective layout:
  ``"flat"`` is one ``all_to_all`` over the whole mesh axis; ``"hier"``
  is the hierarchical two-stage form on host-major meshes — a local
  pre-permutation plus an intra-host shuffle on the fast tier, then a
  coarser inter-host exchange that aggregates each host's traffic into
  ``hosts - 1`` slow-tier messages instead of ``p - local`` (see
  DESIGN.md §Multi-host topology).  On meshes without host structure
  ``"hier"`` degrades to the flat program.

The dataclass is frozen so configs can key dicts and be deduplicated; the
dict round-trip (``to_dict``/``from_dict``) is the wisdom wire format.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal

PadStrategy = Literal["none", "fpm", "czt"]

_VALID_RADIX = (None, 2, 4)
_VALID_PAD = ("none", "fpm", "czt")
_VALID_EXCHANGE = ("flat", "hier")

__all__ = ["PlanConfig", "PadStrategy", "normalize_pad"]


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    radix: int | None = None
    fused: bool = False
    batched: bool = True
    pad: str = "none"
    pipeline_panels: int = 1
    real: bool = False
    exchange: str = "flat"

    def __post_init__(self) -> None:
        if self.radix not in _VALID_RADIX:
            raise ValueError(f"radix must be one of {_VALID_RADIX}, got {self.radix!r}")
        if self.pad not in _VALID_PAD:
            raise ValueError(f"pad must be one of {_VALID_PAD}, got {self.pad!r}")
        if self.exchange not in _VALID_EXCHANGE:
            raise ValueError(
                f"exchange must be one of {_VALID_EXCHANGE}, got {self.exchange!r}")
        if self.pipeline_panels < 1:
            raise ValueError(f"pipeline_panels must be >= 1, got {self.pipeline_panels}")
        if self.fused and self.pad != "none":
            raise ValueError("fused phases have no per-segment padding; pad must be 'none'")
        if self.real and self.pad == "czt":
            raise ValueError("the real half-spectrum pipeline has no Bluestein "
                             "form; real configs cannot use pad='czt'")

    # ---- derived views -------------------------------------------------

    @property
    def fft_backend(self) -> str:
        """Row-FFT backend implied by ``radix`` (see ``repro_torch.fft.fft_rows``)."""
        return {None: "torch", 2: "stockham", 4: "cuda"}[self.radix]

    @property
    def use_stockham(self) -> bool:
        """Back-compat view of the legacy ``use_stockham`` boolean."""
        return self.radix == 2

    @property
    def dist_padded(self) -> str | None:
        """``pfft2_distributed``'s ``padded`` vocabulary for this strategy."""
        return {"none": None, "fpm": "crop", "czt": "czt"}[self.pad]

    def row_fft_kwargs(self, backend: str | None = None) -> dict[str, Any]:
        """``fft_rows`` kwargs for this config (the one place the
        backend-override + radix-only-for-the-kernel gating lives).
        ``backend`` is an explicit override, e.g. tests forcing the kernel.
        """
        eff = backend if backend is not None else self.fft_backend
        return {"backend": eff,
                "radix": self.radix if eff == "cuda" else None}

    # ---- legacy-flag bridge --------------------------------------------

    @classmethod
    def from_flags(cls, *, use_stockham: bool = False, fused: bool = False,
                   batched: bool = True, pad: str = "none",
                   pipeline_panels: int = 1) -> "PlanConfig":
        """Map the legacy loose booleans onto a config (deprecation shims)."""
        return cls(radix=2 if use_stockham else None, fused=bool(fused),
                   batched=bool(batched), pad=pad,
                   pipeline_panels=int(pipeline_panels))

    # ---- wisdom wire format --------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PlanConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown PlanConfig fields: {sorted(unknown)}")
        return cls(**d)

    def describe(self) -> str:
        """Short human-readable tag (benchmark records, log lines).  The
        library backend keeps the reference's spelling ``radix=xla`` so
        that tags of the two packages compare equal."""
        parts = [f"radix={self.radix or 'xla'}"]
        if self.fused:
            parts.append("fused")
        parts.append("batched" if self.batched else "looped")
        if self.pad != "none":
            parts.append(f"pad={self.pad}")
        if self.pipeline_panels > 1:
            parts.append(f"panels={self.pipeline_panels}")
        if self.real:
            parts.append("real")
        if self.exchange != "flat":
            parts.append(f"exch={self.exchange}")
        return ",".join(parts)


def normalize_pad(config: PlanConfig, pad: str) -> PlanConfig:
    """Force a method's pad semantics onto a config.

    ``pad`` is semantics, not a tunable: the method owns it (the schedule
    executor consults the entry's pad to pick czt-vs-crop, so an explicit
    ``PlanConfig(pad="czt")`` handed to PFFT-FPM-PAD must still run the
    paper's padded-signal crop, not Bluestein — and vice versa).
    ``fused`` drops with it on padded methods: fused phases have no
    per-segment padding.  The single home of the rule — ``core.api`` and
    the algorithm entry points (``core.pfft``) both normalize through it,
    so their pad semantics can never drift apart again.
    """
    if config.pad == pad:
        return config
    return dataclasses.replace(
        config, pad=pad, fused=config.fused and pad == "none")
