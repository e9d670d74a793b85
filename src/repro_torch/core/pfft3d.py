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

The mesh pipelines run SPMD over ``torch.distributed``, one process per
device, as ``core.pfft_dist`` does in 2-D: each takes and returns *this
rank's* block.

* ``pfft3_slab`` — the 1-D slab decomposition: three rounds of (local
  FFTs, all_to_all rotation) over one mesh axis;
* ``pfft3_pencil`` — the pencil decomposition on a 2-D ``(r, c)`` mesh
  (``launch.mesh.make_pfft3_mesh``): each rank owns an ``(N/r, N/c, N)``
  pencil, so only *two* exchange rounds are needed (round 1 over the ``c``
  axis, round 2 over the ``r`` axis), each software-pipelined against the
  next panel's FFTs like ``pfft2_distributed``'s panels.  Heterogeneous
  schedules lower as device-group programs (``plan.groups``) indexed by
  the flattened ``(r, c)`` coordinate.

Dataflow of the pencil (rank (i, j), block axes in brackets):

    (N/r, N/c, N) [a0, a1, a2]   --FFT a2->k2--
    --exchange over c (split k2, concat a1) + swap-->
    (N/r, N/c, N) [a0, k2, a1]   --FFT a1->k1--
    --exchange over r (split k1, concat a0) + rotate-->
    (N/c, N/r, N) [k2, k1, a0]   --FFT a0->k0--  => [k2, k1, k0]

Every exchange is one ``all_to_all_single`` of a contiguous send stack
(``core.pfft_dist._send_recv``, or its two-stage hierarchical form): the
pack into the stack is a copy (a view on a group of one rank), and so is
placing the received panels in the next round's layout (the reference's
``swapaxes`` / ``moveaxis``).
Every local pass runs the 2-D pipeline's local program
(``core.pfft_dist._local_fft``): under ``radix=4`` that is one launch of
the row-FFT kernel per pass and panel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.core.fpm import FPMSet
from repro_torch.core.partition import lb_partition, partition_rows
from repro_torch.core.pfft import _group_row_ffts, _grouped_rows, device_groups
from repro_torch.core.pfft_dist import (_exchange_fn, _local_fft,
                                        default_dist_pad_len,
                                        require_mesh_divisible,
                                        validate_spmd_schedule)
from repro_torch.launch.mesh import axis_size, mesh_host_shape
from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.groups import DeviceGroupProgram, device_group_program
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


# ---------------------------------------------------------------- distributed

def _pencil_rows_fft(n: int, *, padded: str | None, pad_len: int,
                     config: PlanConfig, backend: str | None,
                     program: DeviceGroupProgram | None = None,
                     mesh=None, axis_names: tuple[str, str] | None = None):
    """Local row-FFT program on a 3-D block's last axis.

    Flattens the two leading (pencil) axes to rows, runs the 2-D local
    program (``_local_fft`` — crop / czt / plain, as in the 2-D pipeline)
    and reshapes back.  With a ``program``, this rank runs the config of
    its device group, found by the *flattened* (r, c) coordinate
    ``i_r * c + i_c`` of the oriented axes — the reference's ``lax.switch``
    index; the collectives stay outside.
    """
    if program is not None:
        ax_r, ax_c = axis_names
        flat = (mesh.get_local_rank(ax_r) * axis_size(mesh, ax_c)
                + mesh.get_local_rank(ax_c))
        config = program.configs[program.group_of_device[flat]]
    fft = functools.partial(_local_fft, n=n, padded=padded, pad_len=pad_len,
                            config=config, backend=backend)

    def run(block: torch.Tensor) -> torch.Tensor:
        a, b = block.shape[0], block.shape[1]
        return fft(block.reshape(a * b, block.shape[-1])).reshape(a, b, n)

    return run


def _pencil_phase(block: torch.Tensor, fft3, exchange, g: int, panels: int,
                  split_dim: int, perm: tuple[int, ...]) -> torch.Tensor:
    """One (local FFTs, exchange, local rearrange) round over a group of
    ``g`` ranks.

    The FFT'd block's last axis is split into ``g`` panels, panel ``q`` sent
    to the group's rank ``q`` (the pack: one copy).  The received stack
    ``(g, a, b, k)`` — rank ``q``'s ``(a, b)`` block of this rank's panel
    ``k`` — is permuted by ``perm`` into the next round's layout, where the
    rank axis and the axis after it merge (the reference's concatenation
    after its ``all_to_all``): one copy.  ``panels=k > 1``
    software-pipelines the round: the block is chunked into ``k`` panels
    along ``split_dim`` — an axis the exchange does not touch, which
    ``perm`` lands on axis 0 — and panel ``i``'s exchange is started
    (``async_op=True``) before panel ``i+1``'s FFTs; each panel's result
    lands where the monolithic round puts it, so the two are equal element
    for element.
    """
    k = max(panels, 1)
    chunk = block.shape[split_dim] // k

    def send_stack(part: torch.Tensor) -> torch.Tensor:
        x = fft3(part)
        a, b, n = x.shape
        return x.reshape(a, b, g, n // g).permute(2, 0, 1, 3).contiguous()

    pending = [exchange(send_stack(block.narrow(split_dim, i * chunk, chunk)),
                        async_op=k > 1)
               for i in range(k)]
    out = None
    for i, started in enumerate(pending):
        moved = started.wait().permute(perm)
        if out is None:
            at = perm.index(0)
            shape = list(moved.shape)
            shape[at:at + 2] = [shape[at] * shape[at + 1]]
            shape[0] *= k
            out = moved.new_empty(shape)
        out[i * chunk:(i + 1) * chunk].view(moved.shape).copy_(moved)
    return out


# The placements, as ``perm`` of the received ``(q, a, b, k)`` stack:
# round 1 ``out[a0, k2, q·A1 + a1]`` (the reference's concat along a1 and
# ``swapaxes(1, 2)``), round 2 ``out[k2, k1, q·A0 + a0]`` (concat along a0
# and ``moveaxis(0, -1)``), the slab's rotation ``out[k, q·A + a, y]``
# (concat along the planes and ``moveaxis(-1, 0)``).
_SWAP = (1, 3, 0, 2)
_ROTATE = (2, 3, 0, 1)
_SLAB = (3, 0, 1, 2)


def _rank_block(block, shape: tuple[int, ...], what: str) -> torch.Tensor:
    """This rank's block as a contiguous tensor of ``shape``, checked."""
    block = as_tensor(block)
    if tuple(block.shape) != shape:
        raise ValueError(f"{what} takes this rank's {shape} block of the "
                         f"N^3 cube, got {tuple(block.shape)}")
    return block.contiguous()


def pfft3_pencil(
    m: torch.Tensor,
    mesh,
    axis_names: tuple[str, str] = ("fft_r", "fft_c"),
    *,
    config: PlanConfig | None = None,
    schedule: SegmentSchedule | None = None,
    pad_len: int | None = None,
    backend: str | None = None,
    transpose_back: bool = True,
) -> torch.Tensor:
    """Distributed 3-D DFT on a 2-D mesh (pencil decomposition).

    ``m`` is this rank's ``(N/r, N/c, N)`` pencil: rank ``(i, j)`` of the
    ``(axis_names[0], axis_names[1])`` mesh holds ``cube[i·N/r:(i+1)·N/r,
    j·N/c:(j+1)·N/c, :]``; every rank of the mesh calls it alike.  The
    transform needs two exchange rounds (module docstring's dataflow).
    ``config.pipeline_panels=k`` chunks each round into ``k``
    software-pipelined panels (k must divide both N/r and N/c);
    ``config.pad`` selects the local padding semantics exactly as in
    ``pfft2_distributed`` ('fpm' -> pad-and-crop, 'czt' -> Bluestein);
    ``config.exchange="hier"`` runs round 2 (the ``r`` axis, the one a
    host-major pencil mesh spreads over hosts) in two grouped stages.  A
    heterogeneous ``schedule`` lowers to a device-group program over the
    r*c flattened ranks.

    ``transpose_back=False`` returns the raw ``(N/c, N/r, N)`` block
    ``[k2, k1, k0]``: rank ``(i, j)`` holds ``raw[j·N/c:(j+1)·N/c,
    i·N/r:(i+1)·N/r, :]`` of the global ``raw = fftn(cube).transpose(2, 1,
    0)``.  ``True`` (the default) returns its local permute ``(2, 1, 0)``,
    the ``(N, N/r, N/c)`` block ``fftn(cube)[:, i·N/r:(i+1)·N/r,
    j·N/c:(j+1)·N/c]`` (``fftn`` order, laid out ``P(None, r, c)``): one
    local copy, no exchange.
    """
    ax_r, ax_c = axis_names
    r = axis_size(mesh, ax_r)
    c = axis_size(mesh, ax_c)
    m = as_tensor(m)
    if m.ndim != 3:
        raise ValueError("pfft3 operates on cubic N^3 signals")
    n = m.shape[-1]
    require_mesh_divisible(n, r, ax_r)
    require_mesh_divisible(n, c, ax_c)
    m = _rank_block(m, (n // r, n // c, n), "pfft3_pencil")
    if schedule is not None:
        if config is not None:
            raise ValueError("pass either schedule= or config=, not both")
        config = validate_spmd_schedule(schedule)
        if pad_len is None:
            pad_len = max(e.length for e in schedule)
    if config is None:
        config = PlanConfig()
    if config.fused:
        raise ValueError(
            "the 3-D pencil pipeline is unfused (the fused kernel's "
            f"transposed exchange is a 2-D layout), got {config.describe()}")
    padded = config.dist_padded
    if pad_len is None:
        pad_len = default_dist_pad_len(n, padded)
    k = config.pipeline_panels
    if k > 1 and ((n // r) % k or (n // c) % k):
        raise ValueError(
            f"pipeline_panels={k} must divide both pencil extents "
            f"N/{ax_r}={n // r} and N/{ax_c}={n // c}")
    program = None
    if schedule is not None and schedule.common_config is None:
        program = device_group_program(schedule, r * c, pad_len=pad_len)
        pad_len = program.pad_len  # the lowering owns the uniform length
    fft3 = _pencil_rows_fft(n, padded=padded, pad_len=pad_len, config=config,
                            backend=backend, program=program, mesh=mesh,
                            axis_names=(ax_r, ax_c))
    # On a host-major pencil mesh only the r axis spans hosts (the c-axis
    # communicators live inside one host — make_pfft3_mesh's layout), so
    # only round 2 takes the hierarchical form; with no exploitable host
    # shape it is the flat round.
    exchange_c = _exchange_fn(mesh, ax_c, None)
    exchange_r = _exchange_fn(
        mesh, ax_r,
        mesh_host_shape(mesh, ax_r) if config.exchange == "hier" else None)
    # Round 1: FFT a2 -> k2, exchange over c (split k2, concat a1), swap
    # back to pencil layout.  Panels split a0, untouched by the exchange.
    block = _pencil_phase(m, fft3, exchange_c, c, k, 0, _SWAP)  # [a0, k2, a1]
    # Round 2: FFT a1 -> k1, exchange over r (split k1, concat a0), rotate.
    # Panels split k2, which the rotation lands on axis 0.
    block = _pencil_phase(block, fft3, exchange_r, r, k, 1,
                          _ROTATE)                       # [k2, k1, a0]
    # Pass 3: FFT a0 -> k0; no exchange left.
    out = fft3(block)                                    # [k2, k1, k0]
    if not transpose_back:
        return out
    return out.permute(2, 1, 0).contiguous()


def pfft3_slab(m: torch.Tensor, mesh, axis_name: str = "fft", *,
               config: PlanConfig | None = None,
               pad_len: int | None = None,
               backend: str | None = None) -> torch.Tensor:
    """Distributed 3-D DFT, x-planes spread over one mesh axis (slab).

    ``m`` is this rank's ``(N/p, N, N)`` slab (rank at position ``q`` holds
    planes ``q·N/p ...``) and the result its ``(N/p, N, N)`` slab of
    ``fftn`` order.  Each of the three passes FFTs the local last axis,
    then performs the distributed axis rotation: an exchange of last-axis
    panels concatenated along the plane axis — three exchange rounds where
    the pencil needs two.  Local FFTs run the shared ``_local_fft`` program
    under ``config``; ``config.exchange="hier"`` runs every rotation in two
    grouped stages on a host-major axis (``make_fft_mesh(hosts=)``).
    """
    p = axis_size(mesh, axis_name)
    m = as_tensor(m)
    if m.ndim != 3:
        raise ValueError("pfft3 operates on cubic N^3 signals")
    n = m.shape[-1]
    require_mesh_divisible(n, p, axis_name)
    m = _rank_block(m, (n // p, n, n), "pfft3_slab")
    cfg = config if config is not None else PlanConfig()
    padded = cfg.dist_padded
    if pad_len is None:
        pad_len = default_dist_pad_len(n, padded)
    fft3 = _pencil_rows_fft(n, padded=padded, pad_len=pad_len, config=cfg,
                            backend=backend)
    rotate = _exchange_fn(
        mesh, axis_name,
        mesh_host_shape(mesh, axis_name) if cfg.exchange == "hier" else None)
    block = m
    for _ in range(3):
        # FFT the last axis, exchange its panels (concat the plane axis),
        # rotate locally: (n/p, n, n) again.
        block = _pencil_phase(block, fft3, rotate, p, 1, 0, _SLAB)
    return block


def pfft3_distributed(m: torch.Tensor, mesh, axis_name="fft",
                      **kw) -> torch.Tensor:
    """Distributed 3-D DFT; dispatches on the mesh decomposition.

    A single ``axis_name`` runs the 1-D slab path (``pfft3_slab``); a
    pair of axis names runs the two-exchange pencil path
    (``pfft3_pencil``).  Keyword arguments pass through.
    """
    if isinstance(axis_name, (tuple, list)):
        return pfft3_pencil(m, mesh, tuple(axis_name), **kw)
    return pfft3_slab(m, mesh, axis_name, **kw)
