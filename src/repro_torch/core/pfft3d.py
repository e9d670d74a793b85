"""3-D DFT extension (the paper's stated future work, §VII), planner-grade.

Counterpart of the single-host part of ``repro.core.pfft3d``.  The
row-column decomposition generalises: a 3-D DFT is three passes of batched
1-D FFTs with axis rotations between them.  Everything routes through the
same ``PlanConfig`` machinery as the 2-D pipeline:

* ``pfft3_lb`` / ``pfft3_fpm`` — LB / FPM partitioning of the *plane*
  dimension (x-y planes of the cube play the role the rows played in
  2-D), each segment's row FFTs running through the shared dispatch
  program ``core.pfft._group_row_ffts``;
* ``pfft3_fpm_pad`` — per-processor padded transform lengths from the
  FPMs.  The pad strategy is *semantics owned by the method*: any
  explicit config is normalized through ``plan.config.normalize_pad``, so
  a drifted ``PlanConfig(pad="czt")`` still runs the paper's
  padded-signal crop.

Each pass runs the schedule's dispatch groups (``SegmentSchedule.
batch_groups`` over the planes): same-length segments share one dispatch,
so an unpadded pass is one launch of the row kernel under ``radix=4``,
and a batch of cubes goes through each group together.  The axis
rotations (the reference's ``jnp.moveaxis``) are explicit contiguous
copies: the row kernels refuse strided input.

``pfft3_pencil``, ``pfft3_slab`` and ``pfft3_distributed`` (the reference's
mesh pipelines) belong to the distributed slice and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.core.fpm import FPMSet
from repro_torch.core.partition import lb_partition, partition_rows
from repro_torch.core.pfft import _group_row_ffts, _grouped_rows, device_groups
from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["pfft3_lb", "pfft3_fpm", "pfft3_fpm_pad", "pfft3_distributed",
           "pfft3_pencil", "pfft3_slab"]


def _require_cube(m: torch.Tensor) -> int:
    if m.ndim != 3 or len(set(m.shape)) != 1:
        raise ValueError("pfft3 operates on cubic N^3 signals")
    return m.shape[0]


def plane_groups(n: int, d: np.ndarray, pads, config: PlanConfig,
                 device: torch.device) -> list[tuple]:
    """The dispatch groups of one axis pass over the ``n`` planes (the
    homogeneous schedule of ``config`` over ``d`` and ``pads``), with
    their plane indices as tensors on ``device``.  A plan makes them
    once."""
    schedule = SegmentSchedule.homogeneous(config, n, np.asarray(d), pads)
    return device_groups(schedule, device)


def _axis_pass(m: torch.Tensor, groups: list[tuple],
               backend: str | None = None) -> torch.Tensor:
    """Batched 1-D FFTs along the last axis of ``(..., n, n, n)`` cubes,
    planes (axis -3) split into dispatch groups.  Each group's planes of
    every cube flatten to rows and run the shared dispatch program
    (``_group_row_ffts``) once at the group's effective length — the same
    pad-and-crop / czt semantics the 2-D segments execute."""
    n = m.shape[-1]
    planes = m.reshape(m.shape[:-3] + (n, n * n))

    def program(rows, length, cfg):
        out = _group_row_ffts(rows.reshape(-1, n), length, n, cfg, backend)
        return out.reshape(-1, n * n)

    return _grouped_rows(planes, groups, n * n, program).reshape(m.shape)


def _pfft3(m: torch.Tensor, d: np.ndarray, pads=None,
           config: PlanConfig | None = None, backend: str | None = None,
           groups: list[tuple] | None = None) -> torch.Tensor:
    """Three passes with axis rotation: z, then y, then x.  ``m`` is one
    cube or a ``(..., n, n, n)`` stack; ``groups`` is ``plane_groups``
    made ahead (a plan does, once)."""
    n = m.shape[-1]
    if m.ndim < 3 or len(set(m.shape[-3:])) != 1:
        raise ValueError("pfft3 operates on cubic N^3 signals")
    cfg = config if config is not None else PlanConfig()
    if groups is None:
        groups = plane_groups(n, d, pads, cfg, m.device)
    m = m.contiguous()
    for _ in range(3):
        m = _axis_pass(m, groups, backend)             # FFT along last axis
        m = m.movedim(-1, -3).contiguous()  # rotate axes (z,y,x) -> (x,z,y)
    return m


def pfft3_lb(m, p: int, *, config: PlanConfig | None = None,
             backend: str | None = None) -> torch.Tensor:
    m = as_tensor(m)
    n = _require_cube(m)
    cfg = normalize_pad(config if config is not None else PlanConfig(),
                        "none")
    return _pfft3(m, lb_partition(n, p).d, config=cfg, backend=backend)


def pfft3_fpm(m, fpms: FPMSet, eps: float = 0.05, *,
              config: PlanConfig | None = None,
              return_partition: bool = False):
    m = as_tensor(m)
    n = _require_cube(m)
    cfg = normalize_pad(config if config is not None else PlanConfig(),
                        "none")
    part = partition_rows(n, fpms, eps)
    out = _pfft3(m, part.d, config=cfg)
    return (out, part) if return_partition else out


def pfft3_fpm_pad(m, fpms: FPMSet, eps: float = 0.05, *,
                  config: PlanConfig | None = None,
                  return_partition: bool = False):
    """PFFT3-FPM-PAD: per-processor padded lengths from the FPMs, the
    paper's padded-signal semantics (DFT of the zero-padded signal
    cropped back to N bins, per pass).

    The method owns the pad strategy: any explicit ``config=`` is
    normalized to ``pad="fpm"`` (``normalize_pad``, shared with the 2-D
    entry points), and pad lengths come from the shared
    ``plan.pads.fpm_pad_lengths``."""
    from repro_torch.plan.pads import fpm_pad_lengths  # lazy: plan imports core
    m = as_tensor(m)
    n = _require_cube(m)
    cfg = normalize_pad(config if config is not None else PlanConfig(),
                        "fpm")
    part = partition_rows(n, fpms, eps)
    pads = fpm_pad_lengths(fpms, part.d, n)
    out = _pfft3(m, part.d, pads, config=cfg)
    return (out, part, pads) if return_partition else out


def _distributed(name: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the mesh pipelines of the 3-D transform are not in "
            "repro_torch yet; they come with the distributed slice")
    entry.__name__ = name
    entry.__doc__ = (f"The reference's ``{name}`` (a device mesh); raises "
                     "``NotImplementedError`` until the distributed slice.")
    return entry


pfft3_pencil = _distributed("pfft3_pencil")
pfft3_slab = _distributed("pfft3_slab")
pfft3_distributed = _distributed("pfft3_distributed")
