"""Cost model: price a ``PlanConfig`` from the FPMs + structural counts.

Counterpart of ``repro.plan.cost``: the same model form, term for term, with
the port's backend names (``torch`` / ``stockham`` / ``cuda``).  The paper's
thesis is that *measured* speed functions, not fixed heuristics, should drive
execution decisions.  This module is the "estimate" half of the FFTW-style
planner: it predicts the wall time of a candidate config from

* the FPM-predicted per-processor segment times (``time_at``) — or a
  nominal flop rate when no FPM is supplied,
* per-backend compute multipliers (the library FFT vs the pure-tensor
  Stockham vs the CUDA kernel, whose radix sets the pass count via
  ``stockham_stage_count``),
* the device-memory round trip of the intermediate matrix that ``fused``
  removes,
* kernel dispatch counts (``plan_segment_batches`` for the batched path),
* and the all_to_all term that ``pipeline_panels`` overlaps.

Absolute seconds are not the point — *ranking* is.  ``CostParams``
carries the platform constants: ``for_backend("cuda")`` holds constants
fitted on an H100 (``plan/calibrate.py::fit_cost_params`` over measured
races of the kernels), ``for_backend("cpu")`` the reference's host
constants, so that estimate rankings on the host equal the reference's.
``mode="measure"`` exists for when the constants are wrong.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np

from repro_torch.core.fpm import FPMSet, fft_flops
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["CommTiers", "CostParams", "comm_phase_time", "dist_comm_bytes",
           "dist_comm_time", "estimate_cost", "estimate_grouped_cost",
           "estimate_schedule_cost", "estimate_pfft3_cost", "exchange_time",
           "halfspec_cols", "phase_dispatch_count", "pfft3_comm_bytes"]

_COMPLEX64_BYTES = 8
# Bluestein computes one N-point DFT as ~3 length-m FFTs (forward, kernel
# forward is precomputable but the conv needs fwd+inv) + pointwise chirps.
_CZT_FFT_FACTOR = 3.0
# Real rows pack pairwise into one complex FFT, so the row phase does
# ~half the complex-path flops; the column phase still runs full-length
# FFTs but over ~half the columns.  Pack/unpack lane work eats part of
# the ideal 0.5, hence 0.55.
_REAL_COMPUTE_FACTOR = 0.55


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Platform constants of the estimate cost model (see module docstring)."""

    nominal_flops: float            # assumed flop/s when no FPM is given
    dispatch_overhead_s: float      # fixed cost per kernel dispatch
    hbm_bytes_per_s: float          # effective bandwidth, intermediate matrix
    backend_factor: Mapping[str, float]  # compute multiplier per fft backend
    fused_factor: float             # multiplier for the fused kernel's compute
    panel_overlap: float = 0.6      # fraction of comm hidden per extra panel
    # Two-tier interconnect: the legacy names price the *intra-host* tier
    # (device-to-device inside one box — the only tier that exists on a
    # single-host mesh, so every pre-multi-host call site keeps its
    # meaning); the ``inter_*`` pair prices the slower host-to-host tier
    # the hierarchical exchange aggregates traffic onto.
    interconnect_bytes_per_s: float = 2e10  # intra-host all_to_all bandwidth
    comm_latency_s: float = 0.0     # intra-host per-collective launch cost
    inter_bytes_per_s: float = 2.5e9   # inter-host (network) bandwidth
    inter_latency_s: float = 2e-5      # inter-host per-message latency

    @classmethod
    def for_backend(cls, backend: str | None = None) -> "CostParams":
        """Constants for a device type: ``"cuda"`` (the default, like
        every entry point of the port) or ``"cpu"``."""
        if backend is None:
            backend = "cuda"
        if backend == "cpu":
            # The reference's host constants, field for field (its
            # xla / stockham / pallas are torch / stockham / cuda here):
            # the estimate rankings of both packages on the host agree.
            return cls(
                nominal_flops=2e9,
                dispatch_overhead_s=5e-5,
                hbm_bytes_per_s=2e10,
                backend_factor={"torch": 1.0, "stockham": 8.0, "cuda": 300.0},
                fused_factor=300.0,
                panel_overlap=0.0,
                interconnect_bytes_per_s=1e10,
                comm_latency_s=5e-5,
                inter_bytes_per_s=2e9,
                inter_latency_s=2e-4,
            )
        if backend == "cuda":
            # Fitted on NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name,
            # power.limit), 2026-10-17: ``fit_cost_params`` over the wisdom
            # store of ``chip_smoke.py``'s phase ``planner`` (nine measured
            # plans, lb and rfft-lb at N = 1024 ... 8192 and fpm-pad at 8192,
            # plus the raced lb pots, wall seconds), its line "step": "fit".
            # nominal_flops is not fitted (the factors absorb it): the
            # library's rate at 8192^2, fft_flops / torch.fft.fft's 0.3769
            # ms.  The fit's least squares gave negative torch and cuda
            # factors, so those two are the values it fell back on: 1 by
            # the choice of nominal_flops, and K1 / torch.fft.fft at 8192^2
            # (1.2x).  The comm fields keep the dataclass defaults: nothing
            # on one card reads them; the distributed slice fits them.
            return cls(
                nominal_flops=5.7868e12,
                dispatch_overhead_s=0.000358519900842242,
                hbm_bytes_per_s=141276227871.88187,
                backend_factor={"torch": 1.0, "stockham": 116.95899013015845,
                                "cuda": 1.2},
                fused_factor=0.8376901555116018,
            )
        raise ValueError(f"no cost constants for backend {backend!r} "
                         "(the port plans for 'cuda' or 'cpu')")


def halfspec_cols(n: int, p: int = 1) -> int:
    """Spectral columns the real half-spectrum pipeline carries.

    ``N//2+1`` Hermitian-unique bins, rounded up to a multiple of ``p``
    when distributed so the all_to_all splits evenly across devices
    (``rpfft2_distributed`` pads the panel to this width and crops after).
    """
    nh = n // 2 + 1
    if p <= 1:
        return nh
    return -(-nh // p) * p


class CommTiers(NamedTuple):
    """Per-tier byte volume of one exchange round (see ``dist_comm_bytes``)."""

    intra: float  # bytes crossing the fast intra-host tier
    inter: float  # bytes crossing the slow inter-host tier

    @property
    def total(self) -> float:
        return self.intra + self.inter


def comm_phase_time(bytes_: float, bytes_per_s: float,
                    latency_s: float) -> float:
    """Seconds of one comm phase: ``bytes/bandwidth + latency``, with the
    launch latency charged only when bytes actually move.

    The single home of the guarded form — a degenerate phase (1-wide
    axis, empty tier) costs nothing, it never issues a collective.  Both
    distributed tuners and both estimate models price phases through
    this, so the guard can never drift between them again.
    """
    if not bytes_:
        return 0.0
    return float(bytes_) / bytes_per_s + latency_s


def dist_comm_bytes(n: int, p: int, *, itemsize: int = _COMPLEX64_BYTES,
                    real: bool = False, hosts: int | None = None,
                    exchange: str = "flat") -> float | CommTiers:
    """Cross-device bytes of one phase's ``all_to_all`` over ``p`` devices.

    Each device holds an (N/p, N) block and keeps its own diagonal tile,
    so (p-1)/p of the matrix crosses the interconnect per phase (0 on a
    1-device mesh — the degenerate exchange is a local reshuffle).
    ``real=True`` prices the half-spectrum panel: ``halfspec_cols(n, p)``
    columns instead of ``n`` — the ~2x comm saving the rfft2 pipeline is
    for.

    ``hosts=None`` (every pre-multi-host call site) returns the legacy
    flat total as a float.  ``hosts=h`` returns the per-tier ``CommTiers``
    breakdown on an ``h``-host host-major axis (``l = p/h`` devices per
    host), for ``exchange`` = ``"flat"`` or ``"hier"``:

    * flat — of the ``M(p-1)/p`` exchanged bytes (M = whole-matrix
      bytes), the fraction with a same-host peer stays on the fast tier:
      intra ``M(l-1)/p``, inter ``M(p-l)/p``.
    * hier — the intra-host stage is a full-width all_to_all within each
      host, ``M(l-1)/l`` (more fast-tier volume: that is the aggregation
      cost), and the inter stage still moves ``M(h-1)/h = M(p-l)/p``; the
      win is slow-tier *message count*, priced in ``exchange_time``.
    """
    if p <= 1:
        return 0.0 if hosts is None else CommTiers(0.0, 0.0)
    cols = halfspec_cols(n, p) if real else n
    matrix = float(n) * float(cols) * itemsize
    total = matrix * (p - 1) / p
    if hosts is None:
        return total
    h = max(int(hosts), 1)
    if h <= 1 or p % h:
        return CommTiers(total, 0.0)
    l = p // h
    inter = matrix * (p - l) / p
    if exchange == "hier" and l > 1:
        return CommTiers(matrix * (l - 1) / l, inter)
    return CommTiers(matrix * (l - 1) / p, inter)


def exchange_time(total_bytes: float, p: int, *, params: "CostParams",
                  hosts: int = 1, exchange: str = "flat") -> float:
    """Seconds of one exchange round whose flat total volume is
    ``total_bytes`` over a ``p``-wide host-major axis.

    Single-host (or non-host-major) axes reduce to the legacy one-tier
    ``comm_phase_time``.  With ``hosts=h`` the volume splits across tiers
    per ``dist_comm_bytes`` and the slow tier pays a *per-message*
    latency: a flat all_to_all sends ``p - l`` inter-host messages per
    device, the hierarchical form aggregates them into ``h - 1`` — the
    latency saving that can buy back hier's extra intra-host volume.
    """
    if total_bytes <= 0 or p <= 1:
        return 0.0
    h = max(int(hosts), 1)
    if h <= 1 or p % h:
        return comm_phase_time(total_bytes, params.interconnect_bytes_per_s,
                               params.comm_latency_s)
    l = p // h
    matrix = float(total_bytes) * p / (p - 1)
    if exchange == "hier" and l > 1:
        intra, inter = matrix * (l - 1) / l, matrix * (p - l) / p
        inter_msgs = h - 1
    else:
        intra, inter = matrix * (l - 1) / p, matrix * (p - l) / p
        inter_msgs = p - l
    t = comm_phase_time(intra, params.interconnect_bytes_per_s,
                        params.comm_latency_s)
    if inter:
        t += inter / params.inter_bytes_per_s \
            + inter_msgs * params.inter_latency_s
    return t


def dist_comm_time(n: int, p: int, *, params: "CostParams", hosts: int = 1,
                   exchange: str = "flat",
                   itemsize: int = _COMPLEX64_BYTES,
                   real: bool = False) -> float:
    """Seconds of one 2-D phase's distributed transpose under the
    two-tier model (``dist_comm_bytes`` volume through
    ``exchange_time``)."""
    total = dist_comm_bytes(n, p, itemsize=itemsize, real=real)
    return exchange_time(total, p, params=params, hosts=hosts,
                         exchange=exchange)


def pfft3_comm_bytes(n: int, q: int, *,
                     itemsize: int = _COMPLEX64_BYTES) -> float:
    """Cross-device bytes of ONE pencil exchange round over a mesh axis of
    size ``q``.

    In a tiled all_to_all over ``q`` peers each device keeps ``1/q`` of
    its block and sends the rest, and every element of the N^3 cube lives
    on exactly one device, so one round moves ``N^3 * itemsize * (q-1)/q``
    bytes in total (0 on a degenerate 1-wide axis — the exchange is a
    local reshuffle).  The pencil transform prices *two* rounds (over the
    ``c`` axis, then the ``r`` axis) where the slab pays three — the
    saving ``estimate_pfft3_cost`` makes visible to the tuner.
    """
    if q <= 1:
        return 0.0
    return float(n) ** 3 * itemsize * (q - 1) / q


def estimate_pfft3_cost(config: PlanConfig, *, n: int, r: int = 1,
                        c: int = 1, params: CostParams | None = None,
                        pad_len: int | None = None,
                        itemsize: int = _COMPLEX64_BYTES,
                        hosts: int = 1) -> float:
    """Predicted seconds of the pencil-parallel 3-D PFFT under ``config``.

    Three local passes — each device transforms its ``N^2/(r*c)`` pencil
    rows at the effective length, paying the block's HBM round trip and a
    dispatch (plus one extra dispatch per extra pipeline panel) — and two
    priced exchange rounds: ``pfft3_comm_bytes`` over the ``c`` axis then
    the ``r`` axis, each overlapped by the panel factor exactly like the
    2-D model's comm term.  ``r = c = 1`` prices the single-host
    transform (no comm).  On a host-major pencil mesh (``hosts > 1``) the
    ``r`` axis is the one spanning hosts — its round goes through the
    two-tier ``exchange_time`` under ``config.exchange``, while ``c``-axis
    communicators live inside one host and stay on the fast tier.  Like
    the rest of the model, *ranking* is the point, not absolute seconds.
    """
    if params is None:
        params = CostParams.for_backend()
    q = max(int(r), 1) * max(int(c), 1)
    rows = max(n * n // q, 1)
    length = int(pad_len) if pad_len else n
    mult = _compute_multiplier(config, length, params)
    compute = float(fft_flops(rows, length)) / params.nominal_flops * mult
    traffic = 2.0 * rows * n * itemsize / params.hbm_bytes_per_s
    k = config.pipeline_panels
    phase = compute + traffic + k * params.dispatch_overhead_s
    comm = 0.0
    for q_ax, ax_hosts in ((int(c), 1), (int(r), max(int(hosts), 1))):
        bytes_ax = pfft3_comm_bytes(n, q_ax, itemsize=itemsize)
        t = exchange_time(bytes_ax, q_ax, params=params, hosts=ax_hosts,
                          exchange=config.exchange)
        if t and k > 1:
            t *= 1.0 - params.panel_overlap * (k - 1) / k
        comm += t
    return 3.0 * phase + comm


def _segment_work(n: int, d, pad_lengths) -> list[tuple[int, int]]:
    """(rows, effective FFT length) of each non-empty segment."""
    if d is None:
        return [(n, n)]
    d = np.asarray(d)
    out = []
    for i, rows in enumerate(d):
        if rows <= 0:
            continue
        length = n
        if pad_lengths is not None and int(pad_lengths[i]) > n:
            length = int(pad_lengths[i])
        out.append((int(rows), length))
    return out


def phase_dispatch_count(config: PlanConfig, n: int, d, pad_lengths) -> int:
    """Kernel dispatches of one (row FFT, transpose) phase under ``config``."""
    if config.fused:
        return 1
    if d is None:
        return 1
    if config.batched:
        from repro_torch.core.pfft import plan_segment_batches  # lazy: avoids cycle
        return max(len(plan_segment_batches(np.asarray(d), pad_lengths, n)), 1)
    return max(int((np.asarray(d) > 0).sum()), 1)


def _factor_term(config: PlanConfig, length: int) -> tuple[str, float]:
    """(factor name, scale) with the backend factor left symbolic: the
    modelled multiplier is ``scale * factor[name]`` (``fused_factor`` for
    name 'fused').  The one home of the fallback/branch logic — both the
    estimate model and the calibration fit (``plan/calibrate.py``) build
    on it, so they can never drift apart."""
    if config.fused:
        return "fused", 1.0
    if config.pad == "czt":
        # The exact Bluestein path runs ~3 library FFTs at the padded
        # length per transform (czt_dft), whatever the radix says.
        return "torch", _CZT_FFT_FACTOR
    backend = config.fft_backend
    if backend != "torch" and not _is_pow2(length):
        # Kernel backends need pow2 lengths (fft_rows sends any other
        # length to the library, and the model mirrors that).
        return "torch", 1.0
    if backend == "cuda":
        # Radix sets the Stockham pass count: radix 4 makes ceil(log2 n / 2)
        # trips over the data instead of log2 n.
        from repro_torch.kernels.fft.kernel import stockham_stage_count
        log2n = max(int(np.log2(length)), 1)
        return "cuda", stockham_stage_count(length, config.radix or 4) \
            / log2n * 2.0
    return backend, 1.0


def _compute_multiplier(config: PlanConfig, length: int,
                        params: CostParams) -> float:
    """Per-segment compute multiplier under ``params`` (see _factor_term)."""
    name, scale = _factor_term(config, length)
    factor = (params.fused_factor if name == "fused"
              else params.backend_factor[name])
    return factor * scale


def estimate_cost(config: PlanConfig, *, n: int, d=None, pad_lengths=None,
                  fpms: FPMSet | None = None,
                  params: CostParams | None = None,
                  comm_bytes: float = 0.0, batch: int = 1,
                  comm_time_s: float | None = None) -> float:
    """Predicted seconds for a full 2-D PFFT (two limb phases) under ``config``.

    ``d``/``pad_lengths`` describe the partition (None: single whole-matrix
    segment); ``fpms`` supplies measured per-processor times when available;
    ``comm_bytes`` is the per-phase all_to_all volume of the distributed
    pipeline (0 single-host); ``batch`` prices a cohort of stacked
    signals riding one batched dispatch (see ``estimate_schedule_cost``).

    Delegates to ``estimate_schedule_cost`` of the degenerate
    every-segment-alike schedule — one copy of the phase formula, so the
    tuner's hetero-vs-homo comparison is unbiased by construction.
    """
    schedule = SegmentSchedule.homogeneous(
        config, n, d, pad_lengths if d is not None else None)
    return estimate_schedule_cost(schedule, fpms=fpms, params=params,
                                  comm_bytes=comm_bytes, batch=batch,
                                  comm_time_s=comm_time_s)


def estimate_schedule_cost(schedule: SegmentSchedule, *,
                           fpms: FPMSet | None = None,
                           params: CostParams | None = None,
                           comm_bytes: float = 0.0, batch: int = 1,
                           comm_time_s: float | None = None) -> float:
    """Predicted seconds for a full 2-D PFFT under a (possibly
    heterogeneous) schedule: two limb phases, each costing

        makespan + HBM traffic + dispatches * overhead  (+ overlapped comm)

    Each segment is priced with *its own* entry's config (its FPM
    ``time_at`` times that config's backend multiplier via
    ``_factor_term``); the makespan is their max (abstract processors run
    concurrently — paper semantics); the dispatch count is the number of
    ``(length, config)`` groups; fused schedules never materialise the
    intermediate matrix; ``pipeline_panels=k`` overlaps the comm term at
    (k-1) extra dispatches.  ``estimate_cost`` is the degenerate
    homogeneous view of this same formula.

    ``batch`` prices a *cohort*: ``batch`` same-(n, dtype, method)
    signals stacked on a leading axis and run as one batched dispatch
    (the reference's vmapped ``PfftPlan.execute``; the port's loops).  Compute, HBM traffic,
    and comm volume scale with the batch while the per-dispatch
    overheads and the per-phase collective launch latency are paid once
    — the amortisation the serving layer's coalescing tick is priced by
    (predicted cohort cost is affine in the batch, so the tick assembler
    can solve for the largest admissible batch in closed form).
    """
    if params is None:
        params = CostParams.for_backend()
    n = schedule.n
    batch = max(int(batch), 1)

    def seg_time(e) -> float:
        if fpms is not None:
            t = fpms[e.index].time_at(e.rows, e.length)
        else:
            t = float(fft_flops(e.rows, e.length)) / params.nominal_flops
        t *= _compute_multiplier(e.config, e.length, params)
        if e.config.real:
            # Two real rows ride one complex FFT in phase 1 and phase 2
            # only touches the half spectrum; see _REAL_COMPUTE_FACTOR.
            t *= _REAL_COMPUTE_FACTOR
        return t

    makespan = batch * max((seg_time(e) for e in schedule.entries),
                           default=0.0)

    common = schedule.common_config
    fused = common is not None and common.fused
    all_real = all(e.config.real for e in schedule.entries) \
        and bool(schedule.entries)
    traffic = 0.0 if fused else (
        2.0 * batch * n * n * _COMPLEX64_BYTES / params.hbm_bytes_per_s)
    if all_real:
        # The intermediate matrix is the (n, n//2+1) half spectrum.
        traffic *= halfspec_cols(n) / n
    dispatches = 1 if fused else max(len(schedule.batch_groups()), 1)
    phase = makespan + traffic + dispatches * params.dispatch_overhead_s

    k = max(e.config.pipeline_panels for e in schedule.entries)
    comm = 0.0
    if comm_time_s is not None:
        # Tier-aware override: the caller already priced this phase's
        # exchange (``exchange_time`` on a host-major mesh) at batch=1.
        comm = float(comm_time_s) if comm_bytes else 0.0
    elif comm_bytes:
        # The all_to_all crosses the interconnect, not HBM; the fixed
        # collective-launch latency is paid once per phase (panels reuse
        # the issued collective stream).
        comm = comm_phase_time(batch * comm_bytes,
                               params.interconnect_bytes_per_s,
                               params.comm_latency_s)
    if k > 1:
        comm *= 1.0 - params.panel_overlap * (k - 1) / k
        phase += (k - 1) * params.dispatch_overhead_s

    return 2.0 * (phase + comm)


def estimate_grouped_cost(schedule: SegmentSchedule, *,
                          fpms: FPMSet | None = None,
                          params: CostParams | None = None,
                          comm_bytes: float = 0.0, batch: int = 1) -> float:
    """Predicted seconds for a schedule lowered as a *device-group program*
    (the reference's ``plan/groups.py``): the per-group makespan of
    ``estimate_schedule_cost`` plus the switch-dispatch overhead.

    The grouped SPMD program carries one branch per distinct config, so each phase carries the branch bodies of every
    group through compilation and dispatch — modelled as one extra
    dispatch overhead per extra branch per phase.  The makespan itself is
    the shared per-entry formula (each segment priced with its own FPM
    ``time_at`` and its own entry's backend multiplier), so the
    grouped-vs-homogeneous comparison in ``tune_dist_schedule`` differs
    from the single-host one only by this term.
    """
    if params is None:
        params = CostParams.for_backend()
    base = estimate_schedule_cost(schedule, fpms=fpms, params=params,
                                  comm_bytes=comm_bytes, batch=batch)
    branches = len(schedule.configs)
    if branches > 1:
        base += 2.0 * (branches - 1) * params.dispatch_overhead_s
    return base
