"""Distributed 2-D PFFT over a ``torch.distributed`` device mesh.

Counterpart of ``repro.core.pfft_dist``.  The paper's 4-step pipeline maps
onto a 1-D decomposition over a mesh axis: each rank holds a contiguous
block of rows, and the paper's transposes become ``all_to_all`` exchanges.
The port runs it SPMD, one process per device: every entry point takes
*this rank's* ``(N/p, N)`` row block and returns this rank's ``(N/p, N)``
block of the result, where the reference takes and returns the whole
sharded matrix.

    rows (N/p, N) --local row FFT--> --all_to_all + local transpose-->
    cols (N/p, N) --local row FFT (== column FFT)-->
    --all_to_all back + local transpose--> rows, transformed.

The local phases are the port's row FFTs: ``radix=4`` runs the row-FFT
kernel (K1), ``fused`` the fused row-FFT -> transposed-store kernel (K2),
the real pipeline's first phase the packed real row-FFT kernel (K3).

Every exchange is one ``all_to_all_single`` of a stack of ``p`` contiguous
panels, panel ``q`` for the rank at position ``q``: packing the block into
that stack is a copy (``_pack``), and so is placing the received panels
transposed into the output; the fused phase's kernel writes the stack
itself, so it has only the second.  ``exchange="hier"`` sends the same
stack through two grouped stages (``hier_all_to_all``).  With
``pipeline_panels=k`` each phase transforms ``k`` row panels and starts
panel ``i``'s exchange (``async_op=True``) before panel ``i+1``'s FFT; the
received panels are placed in the monolithic phase's order, so the output
is the same element for element.

Padding: ``padded='crop'`` is the paper's PFFT-FPM-PAD (the padded
signal's DFT cropped to N bins), ``padded='czt'`` the exact N-point DFT via
Bluestein at the padded length.  A heterogeneous schedule lowers to a
device-group program (``repro_torch.plan.groups``): each rank runs its own
group's config at the uniform length, between the same collectives.

The fault hook (``_faulted_fft``) applies ``repro_torch.runtime``'s
per-rank slowdown to the local FFT of each phase; without an active fault
it is the identity.  The port runs eagerly, so the hook reads the injector
at call time, where the reference reads it at trace time.
"""

from __future__ import annotations

import functools
import warnings
from typing import Literal

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import complex_result_type
from repro_torch.core.padding import pad_to_smooth
from repro_torch.core.pfft import czt_dft
from repro_torch.fft.fft2d import fft_rows, fft_rows_then_transpose, rfft_rows
from repro_torch.launch.mesh import (axis_size, hier_process_groups,
                                     mesh_host_shape)
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.groups import (DeviceGroupProgram, device_group_program,
                                     spmd_program_config)
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["pfft2_distributed", "rpfft2_distributed", "irpfft2_distributed",
           "make_pfft2_fn", "ragged_row_layout", "hier_all_to_all",
           "validate_spmd_schedule", "default_dist_pad_len",
           "require_mesh_divisible"]

# Inverse of PlanConfig.dist_padded: the ``padded`` vocabulary of this
# module mapped back onto the planner's pad strategies.
_PAD_FROM_PADDED = {"crop": "fpm", "czt": "czt", None: "none"}


def default_dist_pad_len(n: int, padded: str | None) -> int:
    """Default local FFT length under each padding semantics: the
    model-free smooth size for 'crop', the next pow2 >= 2N-1 for 'czt'
    (Bluestein's linear-convolution length), N otherwise.  The single
    home of the rule — ``pfft2_distributed`` applies it and the dist
    tuner's local-phase probe (``plan.tune``) times the very same
    program the end-to-end race ran."""
    if padded == "crop":
        return pad_to_smooth(n)
    if padded == "czt":
        return 1 << int(np.ceil(np.log2(2 * n - 1)))
    return n


def require_mesh_divisible(n: int, p: int, axis_name: str) -> None:
    """The shared divisibility check of every distributed entry point: the
    mesh axis size must divide N (SPMD shards are equal-sized)."""
    if int(p) > 0 and n % int(p):
        raise ValueError(
            f"N={n} must be divisible by mesh axis {axis_name}={int(p)}")


def _hier_groups(hosts: int, local: int) -> tuple[list, list]:
    """Axis positions of the two hierarchical-exchange stages on a
    host-major axis: intra groups are each host's contiguous run of
    ``local`` positions, inter groups collect local rank ``L`` of every
    host.  ``launch.mesh`` builds one process group per list."""
    intra = [[H * local + L for L in range(local)] for H in range(hosts)]
    inter = [[H * local + L for H in range(hosts)] for L in range(local)]
    return intra, inter


# ---------------------------------------------------------------- exchange

class _Pending:
    """A started exchange: ``wait()`` returns the received stack."""

    def __init__(self, recv: torch.Tensor, work, keep=()) -> None:
        self._recv, self._work, self._keep = recv, work, keep

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._recv


def _send_recv(send: torch.Tensor, group, async_op: bool = False) -> _Pending:
    """One ``all_to_all_single`` of a contiguous ``(g, ...)`` stack over a
    group of ``g`` ranks: ``send[q]`` goes to group rank ``q``, and
    ``recv[q]`` came from it.  Complex data crosses as its float view."""
    recv = torch.empty_like(send)
    real = torch.view_as_real if send.is_complex() else (lambda t: t)
    work = dist.all_to_all_single(real(recv), real(send), group=group,
                                  async_op=async_op)
    return _Pending(recv, work, keep=(send,))


def _hier_send_recv(send: torch.Tensor, hosts: int, local: int, groups,
                    async_op: bool = False) -> _Pending:
    """The exchange of ``_send_recv`` in two grouped stages on a host-major
    axis of ``hosts x local`` ranks.

    Stage 1 regroups the ``p`` panels local-major and exchanges within the
    host: each rank then holds, per host ``H``, the panels its host's ranks
    address to local rank ``L`` of host ``H``.  Stage 2 regroups them
    host-major and exchanges across hosts among the ranks of one local
    index, ``hosts - 1`` slow-tier messages per rank instead of ``p -
    local``.  The panel from position ``(H, L)`` lands at ``recv[H*local +
    L]``, as in the flat exchange.  Stage 1 completes before stage 2 is
    started; ``async_op`` applies to stage 2, the inter-host one.
    """
    intra, inter = groups
    rest = send.shape[1:]
    s1 = send.view((hosts, local) + rest).transpose(0, 1).contiguous()
    r1 = _send_recv(s1, intra).wait()                         # (local, hosts, ...)
    s2 = r1.transpose(0, 1).contiguous()                      # (hosts, local, ...)
    pending = _send_recv(s2, inter, async_op)
    return _Pending(pending._recv.view(send.shape), pending._work,
                    keep=pending._keep)


def _exchange_fn(mesh, axis_name: str, host_shape: tuple[int, int] | None):
    """The exchange of one phase: the flat collective, or the hierarchical
    pair when the axis is host-major with hosts > 1 and local > 1 —
    degenerate hierarchies are the flat program with extra steps."""
    if host_shape is not None and host_shape[0] > 1 and host_shape[1] > 1:
        hosts, local = host_shape
        groups = hier_process_groups(mesh, axis_name)
        return lambda send, async_op=False: _hier_send_recv(
            send, hosts, local, groups, async_op)
    group = mesh.get_group(axis_name)
    return lambda send, async_op=False: _send_recv(send, group, async_op)


def _pack(x: torch.Tensor, p: int, width: int | None = None) -> torch.Tensor:
    """The send stack of an ``(r, cols)`` block (contiguous, or the column
    crop of a wider one): ``(p, r, width/p)``, panel ``q`` the block's
    column panel ``q``.  ``width`` > ``cols`` zero-fills the columns past
    ``cols`` (the real pipeline's half spectrum padded to a width the axis
    divides).  One copy."""
    r, cols = x.shape
    width = cols if width is None else int(width)
    w = width // p
    send = (x.new_zeros if width > cols else x.new_empty)((p, r, w))
    dst = send.permute(1, 0, 2)                               # (r, p, w) view
    full = cols // w
    dst[:, :full].copy_(x[:, :full * w].reshape(r, full, w))
    if full < p and cols % w:
        dst[:, full, :cols % w].copy_(x[:, full * w:])
    return send


def _transposed(recv: torch.Tensor) -> torch.Tensor:
    """The received stack ``(p, r, w)`` of a (split columns, concatenate
    rows) exchange, as the transpose of the ``(p·r, w)`` matrix it stands
    for: ``(w, p·r)``, one copy."""
    p, r, w = recv.shape
    return recv.reshape(p * r, w).T.contiguous()


def hier_all_to_all(x: torch.Tensor, mesh, *, axis_name: str = "fft",
                    split_axis: int, concat_axis: int) -> torch.Tensor:
    """Hierarchical tiled ``all_to_all`` of this rank's 2-D block over a
    host-major mesh axis: ``jax.lax.all_to_all(x, split_axis, concat_axis,
    tiled=True)``'s output, element for element, with ``hosts - 1``
    inter-host messages per rank instead of ``p - local``
    (``_hier_send_recv``).  ``(split_axis, concat_axis)`` is ``(1, 0)``
    (the unfused phases) or ``(0, 1)`` (the fused phase's transposed
    exchange); the axis's size must divide the split axis."""
    hosts, local = mesh_host_shape(mesh, axis_name)
    groups = hier_process_groups(mesh, axis_name)
    p = hosts * local
    if (split_axis, concat_axis) == (1, 0):
        recv = _hier_send_recv(_pack(x, p), hosts, local, groups).wait()
        return recv.reshape(-1, recv.shape[-1])
    if (split_axis, concat_axis) == (0, 1):
        send = x.contiguous().view((p, -1) + tuple(x.shape[1:]))
        recv = _hier_send_recv(send, hosts, local, groups).wait()
        return recv.permute(1, 0, 2).reshape(x.shape[0] // p, -1)
    raise ValueError("2-D blocks exchange with (split_axis, concat_axis) "
                     f"(1, 0) or (0, 1), got ({split_axis}, {concat_axis})")


# ------------------------------------------------------------- local phase

def _local_fft(block: torch.Tensor, n: int, *, padded: str | None,
               pad_len: int, config: PlanConfig,
               backend: str | None) -> torch.Tensor:
    """Row FFTs on a local block under the selected padding semantics."""
    if padded == "czt":
        return czt_dft(block, pad_len)
    kw = config.row_fft_kwargs(backend)
    if padded == "crop" and pad_len > n:
        block = torch.nn.functional.pad(block, (0, pad_len - n))
        return fft_rows(block, **kw)[:, :n]
    return fft_rows(block, **kw)


def _faulted_fft(fft, mesh, axis_name: str):
    """Apply the fault layer's per-rank slowdown to a local row FFT.

    When the process's ``FaultInjector`` has an active slowdown, this
    rank's FFT is wrapped in ``repeated`` with the repeat count of its
    position along ``axis_name``: it genuinely runs its FFT ``factor``
    times (bit-identical output via exact power-of-two rescaling), so an
    injected straggler costs real time exactly where a throttled device
    would.  With no active fault the function is returned untouched — zero
    overhead, and no launch beyond the healthy program's.

    The injector is read when the phase is called (the port is eager): a
    fault set between two calls applies from the next one, where the
    reference's traced programs see it only after a re-trace.
    """
    from repro_torch.runtime.faults import get_injector, repeated  # lazy: no cycle
    reps = get_injector().local_repeats(axis_size(mesh, axis_name))
    if reps is None:
        return fft
    return repeated(fft, reps[mesh.get_local_rank(axis_name)])


def _local_phase(block: torch.Tensor, mesh, axis_name: str, n: int, *,
                 padded: str | None, pad_len: int, config: PlanConfig,
                 backend: str | None = None, pipeline_panels: int = 1,
                 program: DeviceGroupProgram | None = None,
                 host_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """One (row FFT -> distributed transpose) phase on this rank's block.

    block: ``(n_loc, N)`` contiguous.  Returns ``(N/p, N)``: this rank's
    block of the *transposed, row-transformed* matrix.

    ``config.fused`` runs the local (row FFT, transpose) as one fused
    kernel launch (``fft_rows_then_transpose``) whose ``(N, n_loc)`` output
    is already the send stack of the transposed exchange (split rows,
    concatenate columns); unfused configs run FFT -> pack -> exchange, and
    both place the received panels transposed into the output.  Either
    local FFT goes through the fault hook (``_faulted_fft``).  A
    ``program`` (device-group program) runs this rank's group's config;
    heterogeneous schedules never take the fused path.  ``host_shape``
    (hosts, local) routes the exchange through the hierarchical stages.

    ``pipeline_panels=k > 1`` transforms the rows in ``k`` panels and
    starts each panel's exchange (asynchronously) before the next panel's
    FFT, then waits on them in order; each panel's received columns land
    where the monolithic phase puts them.
    """
    p = axis_size(mesh, axis_name)
    fused = config.fused and padded is None and program is None
    exchange = _exchange_fn(mesh, axis_name, host_shape)
    if program is not None:
        pos = mesh.get_local_rank(axis_name)
        config = program.configs[program.group_of_device[pos]]
    n_loc = block.shape[0]
    k = pipeline_panels
    if k > 1 and n_loc % k:
        raise ValueError(
            f"_local_phase: pipeline_panels={k} must divide local rows "
            f"{n_loc}; refusing to silently run the monolithic phase "
            "instead of the requested pipelined one")
    k = max(k, 1)
    c, w = n_loc // k, n // p
    if fused:
        # radix=2 means the pure-tensor Stockham elsewhere, not a kernel
        # radix: only an explicit radix-4 reaches the kernel.
        fft = functools.partial(fft_rows_then_transpose, backend=backend,
                                radix=config.radix if config.radix == 4 else None)
    else:
        fft = functools.partial(_local_fft, n=n, padded=padded,
                                pad_len=pad_len, config=config, backend=backend)
    fft = _faulted_fft(fft, mesh, axis_name)

    def send_stack(rows: torch.Tensor) -> torch.Tensor:
        if fused:
            return fft(rows).view(p, w, c)
        return _pack(fft(rows), p)

    pending = [exchange(send_stack(block[i * c:(i + 1) * c]), async_op=k > 1)
               for i in range(k)]
    out = torch.empty((w, p, k, c), dtype=complex_result_type(block),
                      device=block.device)
    for i, started in enumerate(pending):
        recv = started.wait()            # fused (p, w, c); unfused (p, c, w)
        out[:, :, i, :] = (recv.permute(1, 0, 2) if fused
                           else recv.permute(2, 0, 1))
    return out.view(w, n)


# ------------------------------------------------------------------- plans

def validate_spmd_schedule(schedule: SegmentSchedule,
                           pad_len: int | None = None) -> PlanConfig:
    """Eagerly reject schedules that genuinely cannot lower to one SPMD
    program; return the schedule's *program config* (the common config,
    or the anchor of a groupable mix — its program-level knobs are shared
    by every entry; ``repro_torch.plan.groups.spmd_program_config``).
    Mixed effective lengths always lower (every group transforms at the
    schedule's max entry length); ``pad_len`` is kept for the reference's
    signature."""
    del pad_len
    return spmd_program_config(schedule)


def _coerce_dist_config(config: PlanConfig | None,
                        schedule: SegmentSchedule | None,
                        padded: str | None,
                        use_stockham: bool | None,
                        pipeline_panels: int | None,
                        pad_len: int | None = None) -> PlanConfig:
    """Fold the legacy loose kwargs into a ``PlanConfig`` (deprecated shims).

    A ``schedule`` resolves to its program config; ``validate_spmd_schedule``
    raises eagerly for the mixes the grouped lowering cannot express.
    ``pfft2_distributed`` builds the device-group program itself (it knows
    the mesh size).
    """
    if schedule is not None:
        if config is not None:
            raise ValueError("pass either schedule= or config=, not both")
        config = validate_spmd_schedule(schedule, pad_len)
    if config is not None:
        if use_stockham is not None or pipeline_panels is not None:
            raise ValueError(
                f"pass either {'schedule=' if schedule is not None else 'config='}"
                " or the legacy kwargs (use_stockham/pipeline_panels), not both")
        if padded is not None and config.dist_padded != padded:
            raise ValueError(
                f"config.pad={config.pad!r} conflicts with padded={padded!r}")
        return config
    if use_stockham is not None or pipeline_panels is not None:
        warnings.warn(
            "pfft2_distributed: use_stockham=/pipeline_panels= are "
            "deprecated; pass config=PlanConfig(...) (see repro_torch.plan)",
            DeprecationWarning, stacklevel=3)
    return PlanConfig(
        radix=2 if use_stockham else None,
        pad=_PAD_FROM_PADDED[padded],
        pipeline_panels=int(pipeline_panels) if pipeline_panels else 1)


def _dtype_name(dtype) -> str:
    """A numpy or torch dtype's name (``"complex64"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _resolve_dist_plan_kw(n: int, mesh, axis_name: str, *,
                          padded: str | None, dtype, tune: str,
                          wisdom: str | None,
                          pad_len: int | None) -> dict:
    """Plan a raw ``pfft2_distributed`` call as ``plan_pfft(mesh=)`` plans
    it, through the same resolution (``core.api._resolve_schedule``: the
    wisdom key of the method the pad strategy implies over the even row
    split, the first rank's lookup and fitted constants, the distributed
    tuner, the first rank's record), so every rank picks the same program
    by one set of rules.  Returned as executor kwargs: ``{"config": cfg}``
    for a homogeneous pick, ``{"schedule": sched}`` for a device-group
    one."""
    from repro_torch.core.api import _resolve_schedule  # lazy: api imports this
    from repro_torch.core.partition import lb_partition
    from repro_torch.launch.mesh import mesh_device

    if tune not in ("off", "estimate", "measure"):
        raise ValueError(f"tune must be 'off'|'estimate'|'measure', got {tune!r}")
    method = {None: "lb", "crop": "fpm-pad", "czt": "fpm-czt"}[padded]
    schedule, _ = _resolve_schedule(
        n, method, lb_partition(n, axis_size(mesh, axis_name)), None, None,
        tune, wisdom, None, _dtype_name(dtype), mesh_device(mesh),
        mesh=mesh, axis_name=axis_name, pad_len=pad_len)
    if schedule.common_config is not None:
        return {"config": schedule.common_config}
    return {"schedule": schedule}


def _local_block(block: torch.Tensor, p: int, what: str) -> int:
    """N of this rank's ``(N/p, N)`` block, checked (so p divides N)."""
    if block.ndim != 2 or block.shape[0] * p != block.shape[1]:
        raise ValueError(
            f"{what} takes this rank's (N/{p}, N) row block of a square "
            f"N x N matrix, got {tuple(block.shape)}")
    return int(block.shape[1])


def pfft2_distributed(
    block: torch.Tensor,
    mesh,
    axis_name: str = "fft",
    *,
    config: PlanConfig | None = None,
    schedule: SegmentSchedule | None = None,
    padded: Literal["crop", "czt", None] = None,
    pad_len: int | None = None,
    use_stockham: bool | None = None,
    backend: str | None = None,
    pipeline_panels: int | None = None,
    tune: str = "off",
    wisdom: str | None = None,
) -> torch.Tensor:
    """Distributed 2-D DFT of a square N x N matrix whose rows are spread
    over ``axis_name``: ``block`` is this rank's ``(N/p, N)`` row block
    (rank at position ``i`` holds rows ``i·N/p ...``), and the result is
    this rank's ``(N/p, N)`` block of the transform.  Every rank of the
    mesh calls it alike.

    ``config`` selects the execution variant: its ``pad`` strategy maps to
    the ``padded`` semantics ('fpm' -> 'crop', 'czt' -> 'czt'), ``radix``
    the local row-FFT backend (4: the kernel), ``fused`` the fused kernel
    feeding a transposed exchange, ``pipeline_panels=k`` the panels each
    phase overlaps with its exchange (k must divide N/p), ``exchange``
    the flat or the hierarchical exchange (the hierarchy comes from the
    mesh: on a mesh without one, ``"hier"`` runs the flat exchange).
    ``schedule`` routes a planner ``SegmentSchedule`` here: a homogeneous
    one runs its common config, a heterogeneous one lowers to a
    device-group program at the schedule's max entry length.  The loose
    ``use_stockham=``/``pipeline_panels=`` kwargs are deprecated shims.

    ``tune=``/``wisdom=`` plan the call when no config/schedule is given,
    as ``plan_pfft(mesh=...)`` does.  ``pad_len``: the local FFT length
    (defaults to the smooth size for 'crop', the next pow2 >= 2N-1 for
    'czt').
    """
    p = axis_size(mesh, axis_name)
    n = _local_block(block, p, "pfft2_distributed")
    if (tune != "off" or wisdom is not None) and config is None \
            and schedule is None:
        resolved = _resolve_dist_plan_kw(
            n, mesh, axis_name, padded=padded, dtype=block.dtype,
            tune=tune, wisdom=wisdom, pad_len=pad_len)
        config = resolved.get("config")
        schedule = resolved.get("schedule")
    config = _coerce_dist_config(config, schedule, padded, use_stockham,
                                 pipeline_panels, pad_len)
    if schedule is not None and pad_len is None:
        pad_len = max(e.length for e in schedule)
    padded = config.dist_padded
    panels = config.pipeline_panels
    if panels > 1 and (n // p) % panels:
        raise ValueError(
            f"pipeline_panels={panels} must divide local rows {n // p}")
    if pad_len is None:
        pad_len = default_dist_pad_len(n, padded)
    program = None
    if schedule is not None and schedule.common_config is None:
        program = device_group_program(schedule, p, pad_len=pad_len)
        pad_len = program.pad_len
    host_shape = (mesh_host_shape(mesh, axis_name)
                  if config.exchange == "hier" else None)

    def phase(x: torch.Tensor) -> torch.Tensor:
        return _local_phase(x, mesh, axis_name, n, padded=padded,
                            pad_len=pad_len, config=config, backend=backend,
                            pipeline_panels=panels, program=program,
                            host_shape=host_shape)

    # Phase 1: row FFTs + distributed transpose.
    # Phase 2: (original-)column FFTs + distributed transpose back.
    return phase(phase(block.contiguous()))


# ---------------------------------------------------------------------------
# Real-input distributed pipeline: the exchanges move only half-spectrum
# panels — ~half the bytes per phase of the complex path.
# ---------------------------------------------------------------------------

def _validate_real_dist(config: PlanConfig | None,
                        schedule: SegmentSchedule | None) -> PlanConfig:
    """The real distributed path's program config, validated: homogeneous,
    unfused, monolithic and flat, as in the reference (panels, the fused
    exchange, per-rank groups and the hierarchy stay complex-path
    features)."""
    if schedule is not None:
        if config is not None:
            raise ValueError("pass either schedule= or config=, not both")
        config = validate_spmd_schedule(schedule)
        if schedule.common_config is None:
            raise ValueError(
                "rpfft2_distributed runs homogeneous schedules only; "
                f"got {schedule.describe()}")
    if config is None:
        config = PlanConfig(real=True)
    if not config.real:
        raise ValueError(
            f"rpfft2_distributed needs a real config, got {config.describe()}")
    if config.fused or config.pipeline_panels > 1:
        raise ValueError(
            "the real distributed path is unfused and monolithic "
            f"(fused/panels are complex-path features), got {config.describe()}")
    if config.exchange != "flat":
        raise ValueError(
            "the real distributed path exchanges padded half-spectrum "
            "panels over the flat collective only (hier is a complex-path "
            f"feature for now), got {config.describe()}")
    return config


def rpfft2_distributed(
    block: torch.Tensor,
    mesh,
    axis_name: str = "fft",
    *,
    config: PlanConfig | None = None,
    schedule: SegmentSchedule | None = None,
    pad_len: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """Distributed real-input 2-D DFT: this rank's ``(N/p, N)`` real row
    block in, its ``(N/p, N//2+1)`` block of the half spectrum out.

    Phase 1 rffts the rows (two real rows per complex FFT; K3 under
    ``radix=4``) and exchanges only the ``halfspec_cols(n, p)`` surviving
    spectral columns (zero-padded to a width the axis divides); phase 2
    runs complex FFTs over the spread spectral rows (K1 under ``radix=4``)
    and exchanges the same half-width panel back.  ``config.pad='fpm'``
    pads the local FFT length to ``pad_len`` with the crop semantics; a
    homogeneous ``schedule``'s max entry length becomes ``pad_len``.
    """
    from repro_torch.plan.cost import halfspec_cols  # lazy: plan imports core

    config = _validate_real_dist(config, schedule)
    if schedule is not None and pad_len is None:
        pad_len = max(e.length for e in schedule)
    padded = config.dist_padded
    p = axis_size(mesh, axis_name)
    n = _local_block(block, p, "rpfft2_distributed")
    if not block.is_floating_point():
        raise ValueError(
            f"the real pipeline takes a real-valued matrix, got {block.dtype}")
    if pad_len is None:
        pad_len = default_dist_pad_len(n, padded)
    nh = n // 2 + 1
    hc = halfspec_cols(n, p)
    kw = config.row_fft_kwargs(backend)
    exchange = _exchange_fn(mesh, axis_name, None)

    def local_rfft(rows: torch.Tensor) -> torch.Tensor:
        if padded == "crop" and pad_len > n:
            rows = torch.nn.functional.pad(rows, (0, pad_len - n))
            return rfft_rows(rows, **kw)[:, :nh]
        return rfft_rows(rows, **kw)

    def local_fft(rows: torch.Tensor) -> torch.Tensor:
        if padded == "crop" and pad_len > n:
            rows = torch.nn.functional.pad(rows, (0, pad_len - n))
            return fft_rows(rows, **kw)[:, :n]
        return fft_rows(rows, **kw)

    h = local_rfft(block.contiguous())                        # (n/p, nh)
    h = _transposed(exchange(_pack(h, p, hc)).wait())         # (hc/p, n)
    f = local_fft(h)                                          # (hc/p, n)
    recv = exchange(_pack(f, p)).wait()                       # (p, hc/p, n/p)
    return recv.reshape(hc, n // p)[:nh].T.contiguous()       # (n/p, nh)


def irpfft2_distributed(h: torch.Tensor, mesh, axis_name: str = "fft", *,
                        n: int | None = None) -> torch.Tensor:
    """Distributed inverse of ``rpfft2_distributed``: this rank's
    ``(N/p, N//2+1)`` block of the half spectrum in, its ``(N/p, N)`` real
    block out.  ``n`` is the original last-axis length (default assumes it
    was even).  Both exchanges move the forward transform's half-width
    panel; the FFTs are the library's, as in the reference."""
    from repro_torch.plan.cost import halfspec_cols  # lazy: plan imports core

    nh = h.shape[-1]
    if n is None:
        n = 2 * (nh - 1)
    p = axis_size(mesh, axis_name)
    if h.ndim != 2 or h.shape[0] * p != n:
        raise ValueError(
            f"expected this rank's ({n}/{p}, {nh}) block of the ({n}, {nh}) "
            f"half spectrum, got {tuple(h.shape)}")
    hc = halfspec_cols(n, p)
    exchange = _exchange_fn(mesh, axis_name, None)
    g = _transposed(exchange(_pack(h.contiguous(), p, hc)).wait())  # (hc/p, n)
    g = torch.fft.ifft(g, dim=-1)
    recv = exchange(_pack(g, p)).wait()                       # (p, hc/p, n/p)
    g = recv.reshape(hc, n // p)[:nh].T                       # (n/p, nh)
    return torch.fft.irfft(g, n=n, dim=-1)


def make_pfft2_fn(mesh, n: int, axis_name: str = "fft", **kw):
    """The distributed 2-D DFT closed over a mesh, planned *now*: a
    ``schedule=`` is SPMD-validated (and a heterogeneous one lowered
    against this mesh) and ``tune=``/``wisdom=`` resolve to a concrete
    config here, on every rank alike, so the returned callable only runs
    ``pfft2_distributed`` on this rank's ``(N/p, N)`` block (the plan is
    keyed for complex64 signals, the pipeline's working type)."""
    if kw.get("schedule") is not None:
        sched = kw["schedule"]
        validate_spmd_schedule(sched, kw.get("pad_len"))
        if sched.common_config is None:
            device_group_program(sched, axis_size(mesh, axis_name),
                                 pad_len=kw.get("pad_len"))
    tune = kw.pop("tune", "off")
    wisdom = kw.pop("wisdom", None)
    if (tune != "off" or wisdom is not None) \
            and kw.get("config") is None and kw.get("schedule") is None:
        kw.update(_resolve_dist_plan_kw(
            n, mesh, axis_name, padded=kw.pop("padded", None),
            dtype=np.complex64, tune=tune, wisdom=wisdom,
            pad_len=kw.get("pad_len")))

    def fn(block: torch.Tensor) -> torch.Tensor:
        if tuple(block.shape[-1:]) != (n,):
            raise ValueError(f"planned for N={n}, got a block of shape "
                             f"{tuple(block.shape)}")
        return pfft2_distributed(block, mesh, axis_name, **kw)

    return fn


def ragged_row_layout(d: np.ndarray, p: int) -> tuple[int, np.ndarray]:
    """Block-ragged realisation of an uneven HPOPTA distribution under SPMD.

    SPMD shards must be equal-sized, so each of the ``p`` groups gets a
    buffer of ``max(d)`` rows; group i's valid-row count is d[i] and the
    remainder is masked padding.  Returns (rows_per_shard, valid_counts).
    """
    d = np.asarray(d, dtype=np.int64)
    if len(d) != p:
        raise ValueError("distribution length must equal group count")
    return int(d.max()), d.copy()
