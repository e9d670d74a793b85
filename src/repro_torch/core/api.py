"""Plan-style user API (mirrors fftw's plan/execute/wisdom lifecycle).

    plan = plan_pfft(n=4096, fpms=fpms, method="fpm-pad", tune="estimate")
    out  = plan.execute(signal)     # reusable

Counterpart of ``repro.core.api`` for the 2-D methods.  The plan
captures everything host-side once — the partition ``d``, the pad lengths,
the execution schedule (``SegmentSchedule``: one ``PlanConfig`` per segment)
*and* the dispatch groups' row-index tensors, already on the plan's device —
so ``execute`` only launches device work: the analogue of building an fftw
plan once and calling ``fftw_execute`` repeatedly.  A single explicit
``config=`` becomes the degenerate one-entry-per-segment schedule.

The ``rfft-*`` methods plan the real-input transform: ``execute`` takes a
real (N, N) signal and returns its (N, N//2+1) half spectrum.

A plan lives on one device: ``device=None`` is the CUDA device and raises
when there is none; ``device="cpu"`` runs the kernels' plain PyTorch
versions on the host.

``tune`` selects how the variant is chosen (fftw's ESTIMATE/MEASURE):

* ``"off"`` — the default config (library FFT, batched dispatch), or an
  explicit ``config=``/legacy flags.
* ``"estimate"`` — rank the candidate space with the cost model
  (``repro_torch.plan.cost``, the constants of the plan's device type), per
  distinct effective FFT length (``tune_schedule``); no device work.
* ``"measure"`` — additionally time the Pareto top-k candidates per
  length group on the plan's device.

``wisdom=path`` consults/feeds the persistent store
(``repro_torch.plan.wisdom``, the reference's file format) keyed by (n,
dtype, p, method, backend = the plan's device type): a hit skips tuning
entirely, and a measured choice is recorded so fresh processes are served
from disk.  When the store holds enough measured entries, the estimate cost
model is re-calibrated from them (``repro_torch.plan.calibrate``) before
ranking.

The 3-D (``plan_pfft3``: cubic N^3 signals, the single-device axis
passes) and huge-1-D (``plan_pfft1_large``: the four-step pipeline) plans
follow the same lifecycle.  Every plan's ``execute`` takes leading batch
dimensions and runs each dispatch group of each phase once over the rows
of all the signals, so a batch costs the launches of one signal on the
unfused paths; ``execute_many`` stacks host signals into one such batch
(the serving layer's surface, ``repro_torch.launch.serve_fft``).

``plan_pfft(mesh=...)`` plans the distributed 2-D transform
(``core.pfft_dist``) over a ``torch.distributed`` ``DeviceMesh``: every rank
of the mesh plans alike (the decisions are agreed across ranks) and its
``execute`` takes and returns this rank's ``(N/p, N)`` row block.
``plan_pfft3(mesh=...)`` plans the pencil pipeline (``core.pfft3d.
pfft3_pencil``) over a 2-D mesh the same way; its ``execute`` takes this
rank's ``(N/r, N/c, N)`` pencil.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Literal

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch._trace import span
from repro_torch.core.fpm import FPMSet
from repro_torch.core.partition import PartitionResult, lb_partition, partition_rows
from repro_torch.core.pfft import (_complex_limb, _real_limb, device_groups,
                                   real_limb_groups)
from repro_torch.plan.calibrate import fit_cost_params
from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.cost import CostParams
from repro_torch.plan.schedule import SegmentSchedule
from repro_torch.plan.tune import tune_rfft, tune_schedule
from repro_torch.plan.wisdom import (lookup_wisdom, partition_digest,
                                     record_wisdom, topology_digest,
                                     wisdom_key)
from repro_torch.launch.mesh import first_rank_does, first_rank_value

Method = Literal["lb", "fpm", "fpm-pad", "fpm-czt",
                 "rfft-lb", "rfft-fpm", "rfft-fpm-pad"]
TuneMode = Literal["off", "estimate", "measure"]

_PAD_STRATEGY = {"lb": "none", "fpm": "none", "fpm-pad": "fpm",
                 "fpm-czt": "czt",
                 "rfft-lb": "none", "rfft-fpm": "none", "rfft-fpm-pad": "fpm"}

# The real-input half-spectrum pipeline: same partition/pad machinery as the
# base method (the name after the ``rfft-`` prefix), but the plan transforms
# a real (N, N) signal into its (N, N//2+1) half spectrum.  The executor
# routes on the schedule's ``real`` flag: a real-flagged schedule runs the
# half-spectrum limb, a complex-family one upcasts and crops to the same
# deliverable.  No ``rfft-fpm-czt``: the real pipeline has no Bluestein form.
_REAL_METHODS = frozenset({"rfft-lb", "rfft-fpm", "rfft-fpm-pad"})

__all__ = ["PfftPlan", "plan_pfft", "rfft2", "irfft2",
           "Pfft3Plan", "plan_pfft3",
           "Pfft1LargePlan", "plan_pfft1_large", "pfft1_large"]

def _base_method(method: str) -> str:
    """The partitioning family a method uses: ``rfft-fpm-pad`` pads and
    partitions exactly like ``fpm-pad``; the prefix only changes what the
    transform delivers."""
    return method[5:] if method in _REAL_METHODS else method


def _ctype_for(dtype: str) -> torch.dtype:
    return (torch.complex128 if np.dtype(dtype) == np.dtype(np.float64)
            else torch.complex64)


def _plan_groups(method: str, schedule: SegmentSchedule, d: np.ndarray,
                 device: torch.device, mesh=None):
    """The dispatch groups the plan's executor runs, made once on its
    device: the real limb's two phases for a real-flagged schedule of a
    real method, else the complex limb's; none for a distributed plan
    (each rank transforms its whole block)."""
    if mesh is not None:
        return []
    if method in _REAL_METHODS and schedule.anchor_config.real:
        return real_limb_groups(schedule, d, device)
    return device_groups(schedule, device)


@dataclasses.dataclass
class PfftPlan:
    n: int
    method: Method
    partition: PartitionResult
    pad_lengths: np.ndarray | None
    config: PlanConfig
    schedule: SegmentSchedule
    tuning: dict[str, Any]
    device: torch.device
    # The planned input dtype name ("complex64" | "complex128", or
    # "float32" | "float64" for the rfft-* methods).
    dtype: str = "complex64"
    # The dispatch groups with the row indices as tensors on ``device``
    # (``_plan_groups``), made once here so that execute copies no index to
    # the device.
    _groups: Any = dataclasses.field(default_factory=list, repr=False,
                                     compare=False)
    # A distributed plan's mesh (``core.pfft_dist`` runs it), kept so that
    # ``with_schedule`` rebuilds against the same ranks.
    mesh: Any = None
    axis_name: str = "fft"

    @property
    def rows(self) -> int:
        """Rows of the block ``execute`` takes: N, or N/p on a mesh."""
        return self.n if self.mesh is None else self.n // len(self.d)

    def _run(self, m: torch.Tensor) -> torch.Tensor:
        """Route as the reference's ``_build_raw`` does: a real method with
        a real-flagged schedule runs the half-spectrum limb; one with a
        complex-family schedule upcasts, runs the complex limb and crops.
        ``m`` is a contiguous ``(..., rows, n)`` stack."""
        if self.mesh is not None:
            if m.ndim == 2:
                return self._run_distributed(m)
            lead = m.shape[:-2]
            flat = m.reshape((-1,) + tuple(m.shape[-2:]))
            out = torch.stack([self._run_distributed(b) for b in flat])
            return out.reshape(lead + tuple(out.shape[-2:]))
        d = self.partition.d
        if self.method in _REAL_METHODS:
            if self.schedule.anchor_config.real:
                if not m.is_floating_point():
                    raise ValueError("the real pipeline takes a real-valued "
                                     f"matrix, got {m.dtype}")
                return _real_limb(m, d, self.schedule, self._groups)
            return _complex_limb(m.to(_ctype_for(self.dtype)), d,
                                 self.schedule,
                                 self._groups)[..., :self.n // 2 + 1]
        return _complex_limb(m, d, self.schedule, self._groups)

    def _run_distributed(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's block through ``core.pfft_dist``, routed on the
        schedule's family as ``_run`` routes."""
        from repro_torch.core import pfft_dist
        if self.method in _REAL_METHODS:
            if self.schedule.anchor_config.real:
                return pfft_dist.rpfft2_distributed(
                    block, self.mesh, self.axis_name, schedule=self.schedule)
            return pfft_dist.pfft2_distributed(
                block.to(_ctype_for(self.dtype)), self.mesh, self.axis_name,
                schedule=self.schedule)[:, :self.n // 2 + 1]
        return pfft_dist.pfft2_distributed(block, self.mesh, self.axis_name,
                                           schedule=self.schedule)

    def execute(self, m) -> torch.Tensor:
        """Run the planned transform; leading batch dims are batched.

        ``m``: ``(..., n, n)``, a tensor on the plan's device or a host
        array (copied there).  A batch gives what transforming each
        ``(n, n)`` signal alone gives, stacked: each dispatch group of each
        unfused phase runs once over the rows of all the signals (one
        launch of the row kernel per group under ``radix=4``, whatever the
        batch), and a fused schedule runs its two fused launches over them.
        The result is ``(..., n, n)``, or ``(..., n, n//2+1)`` for the
        ``rfft-*`` methods; a fused schedule returns it as a permuted view
        of its last launch's output, with the batch fastest in memory (no
        copy), so a batched fused result is not contiguous.  A fused
        ``rfft-*`` plan at n >= 16384 on a card writes that output with its
        row stride rounded up to a multiple of 4 elements, so its ``(...,
        n, n//2+1)`` half spectrum is such a view even unbatched;
        ``.contiguous()`` gives the dense copy.

        A distributed plan takes this rank's ``(..., n/p, n)`` row blocks
        and returns its blocks of the result, one distributed transform per
        signal of the batch; every rank of the mesh calls it alike.
        """
        with span("execute"):
            m = _on_plan_device(m, self.device)
            if m.ndim < 2 or tuple(m.shape[-2:]) != (self.rows, self.n):
                raise ValueError(
                    f"plan is for ({self.rows}, {self.n}) "
                    f"{'row blocks' if self.mesh is not None else 'signals'} "
                    f"(optionally with leading batch dims), got {tuple(m.shape)}")
            return self._run(m.contiguous())

    def execute_many(self, ms, *, pad_to: int | None = None,
                     stages: dict | None = None) -> list:
        """Serve a cohort: stack same-size signals into ONE batched execute.

        ``ms`` is a sequence of ``(n, n)`` host signals (many users'
        concurrent requests for the same transform); ``pad_to`` rounds the
        stack up with zero signals (computed and dropped).  Stacking,
        padding and unstacking happen on the host (numpy), so the device
        sees exactly one transfer in and one out, and the returned results
        are numpy views into the fetched batch — the copy back to the host
        is where the call waits for the device.  A ``stages`` dict receives
        the seconds of the four steps (``_execute_many``).
        """
        return _execute_many(self, ms, (self.rows, self.n), pad_to, stages)

    @property
    def d(self) -> np.ndarray:
        return self.partition.d

    def with_schedule(self, schedule: SegmentSchedule,
                      tuning: dict[str, Any] | None = None) -> "PfftPlan":
        """Same problem, new execution schedule: a fresh plan whose
        executor runs ``schedule`` on the captured partition and device."""
        return dataclasses.replace(
            self, schedule=schedule, config=schedule.anchor_config,
            tuning=dict(tuning) if tuning is not None else dict(self.tuning),
            _groups=_plan_groups(self.method, schedule, self.partition.d,
                                 self.device, self.mesh))


def _on_plan_device(m, device: torch.device) -> torch.Tensor:
    """A host array is copied to the plan's device; a tensor must already
    lie there."""
    if not isinstance(m, torch.Tensor):
        return as_tensor(m, device)
    if m.device != device:
        raise ValueError(
            f"plan lives on {device}, signal on {m.device}; move "
            "the signal or plan for its device")
    return m


def _execute_many(plan, ms, shape: tuple[int, ...], pad_to: int | None,
                  stages: dict | None = None) -> list:
    """The shared cohort-stacking core of every plan's ``execute_many``:
    host-side stack (+ zero-pad to the bucket), the copy to the plan's
    device, one batched ``execute``, the copy back and host-side unstack.
    See ``PfftPlan.execute_many`` for why.  The device is synchronized
    after the copy in and after the execute (the copy back waits for it
    anyway), so that ``stages``, when given, receives each step's seconds
    on the host's clock: ``stack_s``, ``to_device_s``, ``execute_s``,
    ``to_host_s``."""
    if not ms:
        return []
    arrs = [np.asarray(m) for m in ms]
    for m in arrs:
        if m.shape != shape:
            raise ValueError(
                f"execute_many stacks {shape} signals, got {m.shape}")
    cuda = plan.device.type == "cuda"
    t0 = time.perf_counter()
    batch = np.stack(arrs)
    b = len(arrs)
    if pad_to is not None and pad_to > b:
        batch = np.concatenate(
            [batch, np.zeros((pad_to - b,) + batch.shape[1:], batch.dtype)])
    t1 = time.perf_counter()
    dev = torch.from_numpy(batch).to(plan.device)
    if cuda:
        torch.cuda.synchronize(plan.device)
    t2 = time.perf_counter()
    res = plan.execute(dev)
    if cuda:
        torch.cuda.synchronize(plan.device)
    t3 = time.perf_counter()
    out = res.cpu().numpy()
    if stages is not None:
        stages.update(stack_s=t1 - t0, to_device_s=t2 - t1,
                      execute_s=t3 - t2, to_host_s=time.perf_counter() - t3)
    return [out[i] for i in range(b)]


def _resolve_schedule(n: int, method: Method, part: PartitionResult,
                      pads: np.ndarray | None, fpms: FPMSet | None,
                      tune: TuneMode, wisdom: str | None,
                      config: PlanConfig | None, dtype: str,
                      device: torch.device, mesh=None, axis_name: str = "fft",
                      pad_len: int | None = None
                      ) -> tuple[SegmentSchedule, dict[str, Any]]:
    """Pick the plan's execution schedule and say where it came from.

    Resolution order: explicit config > wisdom hit > tuner > default.
    A wisdom hit applies even at ``tune="off"`` — passing ``wisdom=path``
    *is* the request to use stored plans (FFTW reads wisdom regardless of
    planner rigor) — but only when the stored schedule still describes
    the current partition (a stale structure is a miss, never an error).
    ``tuning["source"]`` records which branch won.  The key's backend and
    the tuner's measurements are the plan's device.

    With a ``mesh``, the plan is for ``core.pfft_dist``: the key gains the
    mesh's ``topology_digest``, the tuner is the distributed one (measure
    races finalists end to end on this mesh), and a measured pick is
    recorded with its comm sample.  Every rank takes the first rank's
    wisdom lookup and fitted constants, the tuners rank times agreed over
    the axis, and the first rank alone writes the store (the others wait
    at a barrier): all ranks resolve the same schedule.  ``pad_len`` is a
    raw ``pfft2_distributed`` call's local FFT length, at which the
    distributed tuner races.
    """
    pad_strategy = _PAD_STRATEGY[method]
    real = method in _REAL_METHODS

    def normalize(cfg: PlanConfig) -> PlanConfig:
        """The method owns the pad semantics (``normalize_pad``: an
        explicit ``PlanConfig()`` on fpm-czt still runs Bluestein and a
        drifted ``pad="czt"`` on fpm-pad still runs the paper's crop).
        Real methods also own the transform: an explicit config is
        real-flagged so the executor runs the half-spectrum pipeline (a
        tuner-chosen complex fallback keeps its own flag — that flag *is*
        the race's verdict)."""
        cfg = normalize_pad(cfg, pad_strategy)
        if real and not cfg.real:
            cfg = dataclasses.replace(cfg, real=True)
        return cfg

    tuning: dict[str, Any] = {"mode": tune}
    if config is not None:
        tuning["source"] = "explicit"
        return SegmentSchedule.homogeneous(normalize(config), n, part.d,
                                           pads), tuning

    # The lb partition is a function of (n, p); the FPM partitions (and
    # pad lengths) depend on the FPMSet and eps, so they digest into the
    # key — a different model must not be served another model's plan.
    detail = (partition_digest(part.d, pads)
              if _base_method(method) != "lb" else None)
    topo = panels = None
    if mesh is not None:
        from repro_torch.plan.tune import dist_panel_space
        panels = dist_panel_space(n, len(part.d))
        topo = topology_digest(mesh, axis_name, panels=panels)
        tuning["topology"] = topo
    key = wisdom_key(n=n, dtype=dtype, p=len(part.d), method=method,
                     backend=device.type, detail=detail, topology=topo)
    tuning["wisdom_key"] = key

    def agreed(fn):
        """``fn()``, the first rank's answer on a mesh."""
        if mesh is None:
            return fn()
        return first_rank_value(mesh, axis_name, fn)

    if wisdom is not None:
        hit = agreed(lambda: lookup_wisdom(wisdom, key))
        if hit is not None:
            plan, entry = hit
            if isinstance(plan, SegmentSchedule):
                # Structure AND pad semantics must match: an entry whose
                # config pad drifted from the method's strategy would
                # execute the wrong transform (czt vs pad-and-crop), so
                # it is a miss like every other kind of drift.
                ok = (plan.matches(part.d, pads)
                      and all(e.config.pad == pad_strategy for e in plan))
                schedule = plan if ok else None
            else:
                schedule = SegmentSchedule.homogeneous(normalize(plan), n,
                                                       part.d, pads)
            if schedule is not None and mesh is not None:
                # A distributed plan must lower to one SPMD program (and a
                # real-family one to the real program's shape): anything
                # ``core.pfft_dist`` would refuse is a miss.
                from repro_torch.core import pfft_dist
                try:
                    if schedule.anchor_config.real:
                        pfft_dist._validate_real_dist(None, schedule)
                    else:
                        pfft_dist.validate_spmd_schedule(schedule)
                except ValueError:
                    schedule = None
            if schedule is not None:
                tuning["source"] = "wisdom"
                tuning["wisdom_entry"] = entry
                return schedule, tuning

    if tune == "off":
        tuning["source"] = "off"
        return SegmentSchedule.homogeneous(
            PlanConfig(pad=pad_strategy, real=real), n, part.d,
            pads), tuning

    params = None
    if wisdom is not None:
        # Enough measured entries on this device type re-fit the cost
        # constants (the committed ones below the sample threshold).
        params = agreed(lambda: fit_cost_params(wisdom, backend=device.type))
        tuning["calibrated"] = params != CostParams.for_backend(device.type)
    if real and mesh is not None:
        from repro_torch.plan.tune import tune_rfft_dist
        schedule, info = tune_rfft_dist(
            n, mesh, axis_name, mode=tune, pad=pad_strategy, fpms=fpms,
            params=params, panels=panels, dtype=np.dtype(dtype))
    elif mesh is not None:
        from repro_torch.plan.tune import tune_dist_schedule
        schedule, info = tune_dist_schedule(
            n, mesh, axis_name, pad_lengths=pads, mode=tune,
            pad=pad_strategy, pad_len=pad_len, fpms=fpms, params=params,
            panels=panels, dtype=np.dtype(dtype))
    elif real:
        schedule, info = tune_rfft(n, d=part.d, pad_lengths=pads,
                                   fpms=fpms, mode=tune, pad=pad_strategy,
                                   params=params, dtype=np.dtype(dtype),
                                   device=device)
    else:
        schedule, info = tune_schedule(n, d=part.d, pad_lengths=pads,
                                       fpms=fpms, mode=tune,
                                       pad=pad_strategy, params=params,
                                       dtype=np.dtype(dtype), device=device)
    tuning.update(info)
    tuning["source"] = tune
    if wisdom is not None and tune == "measure":
        if mesh is None:
            record_wisdom(wisdom, key, schedule, mode="measure",
                          time_s=info.get("time_s"))
        else:
            extra = _dist_wisdom_extra(topo, info)
            first_rank_does(mesh, axis_name, lambda: record_wisdom(
                wisdom, key, schedule, mode="measure",
                time_s=info.get("time_s"), extra=extra))
    return schedule, tuning


def _dist_wisdom_extra(topo: str, info: dict) -> dict:
    """What a measured distributed wisdom entry carries beside its plan:
    the topology and the comm sample (total and per tier) that
    ``fit_cost_params`` fits the interconnect constants from."""
    extra: dict = {"topology": topo}
    stats = info.get("dist", {})
    if stats.get("comm_time_meas_s") is not None:
        extra["comm_bytes"] = stats["comm_bytes"]
        extra["comm_time_s"] = stats["comm_time_meas_s"]
    if stats.get("comm_samples"):
        extra["comm_samples"] = stats["comm_samples"]
    if int(stats.get("hosts", 1)) > 1:
        extra["hosts"] = int(stats["hosts"])
    return extra


def plan_pfft(n: int, *, p: int | None = None, fpms: FPMSet | None = None,
              method: Method = "fpm", eps: float = 0.05,
              tune: TuneMode = "off", wisdom: str | None = None,
              config: PlanConfig | None = None, dtype: str = "complex64",
              mesh=None, axis_name: str = "fft",
              device: str | torch.device | None = None,
              use_stockham: bool | None = None,
              fused: bool | None = None) -> PfftPlan:
    """Build a reusable plan; see the module docstring for the lifecycle.

    ``method``: ``"lb"`` (needs ``p``), ``"fpm"``, ``"fpm-pad"``,
    ``"fpm-czt"`` (need ``fpms``), and their real-input forms
    ``"rfft-lb"``, ``"rfft-fpm"``, ``"rfft-fpm-pad"`` (``dtype="float32"``
    or ``"float64"``; ``execute`` returns the (N, N//2+1) half spectrum).
    ``config`` picks the execution variant; without one, ``wisdom=`` and
    ``tune=`` choose it (module docstring), else the default (library
    FFT).  For the ``rfft-*`` methods the tuner races the real pipeline
    against the upcast-and-crop complex fallback and the plan routes on
    the winner; ``plan.tuning["chosen_path"]`` says which side won.
    ``use_stockham=``/``fused=`` are deprecated shims for the legacy flag
    API (they build an explicit config, so tuning is skipped).

    ``mesh=`` (a ``DeviceMesh``, ``launch.mesh.make_fft_mesh``) plans for
    ``core.pfft_dist`` over its ``axis_name`` axis instead of the
    single-device limb; every rank calls it alike, and the plan lives on
    the rank's device (the host for a cpu mesh, the rank's card for a
    cuda one; ``device=`` must agree).  N must divide by the axis size.
    SPMD spreads rows evenly (one abstract processor per rank, N/p rows
    each), so the FPMs drive per-rank pad lengths and execution variants
    instead of row counts: plain ``"fpm"`` is refused (it would run as
    ``"lb"``), ``"fpm-pad"``/``"fpm-czt"`` need ``fpms`` covering exactly
    the axis, heterogeneous picks lower as device-group programs, and
    ``"rfft-fpm-pad"`` is refused (the real distributed program is
    unpadded).  ``execute`` then takes this rank's ``(N/p, N)`` block.
    """
    if tune not in ("off", "estimate", "measure"):
        raise ValueError(f"tune must be 'off'|'estimate'|'measure', got {tune!r}")
    if method not in _PAD_STRATEGY:
        raise ValueError(f"unknown method {method!r}")
    real = method in _REAL_METHODS
    base = _base_method(method)
    kind = np.dtype(dtype).kind
    if real and kind != "f":
        raise ValueError(
            f"method={method!r} transforms real input; pass dtype='float32' "
            f"or 'float64' (got {dtype!r})")
    if not real and kind == "f":
        raise ValueError(
            f"method={method!r} transforms complex input (got dtype="
            f"{dtype!r}); use an 'rfft-*' method for real signals")
    if mesh is not None:
        p = _check_mesh_plan(n, method, p, fpms, mesh, axis_name)
        device = _mesh_plan_device(mesh, device)
    if use_stockham is not None or fused is not None:
        if config is not None:
            raise ValueError("pass either config= or the legacy flags "
                             "(use_stockham/fused), not both")
        warnings.warn(
            "plan_pfft: use_stockham=/fused= are deprecated; pass "
            "config=PlanConfig(...) or let tune='estimate'|'measure' choose",
            DeprecationWarning, stacklevel=2)
        pad_strategy = _PAD_STRATEGY[method]
        # The flag API ignored fused= on the padded methods (pad semantics
        # are per-processor); the shim must too.
        config = PlanConfig.from_flags(
            use_stockham=bool(use_stockham),
            fused=bool(fused) and pad_strategy == "none",
            pad=pad_strategy)

    if base == "lb":
        if p is None:
            raise ValueError(f"method={method!r} requires p")
        part = lb_partition(n, p)
        pads = None
    else:
        if fpms is None:
            raise ValueError(f"method={method!r} requires fpms")
        # On a mesh SPMD spreads rows evenly: the FPMs drive per-rank pad
        # lengths and execution variants, not row counts.
        part = (lb_partition(n, p) if mesh is not None
                else partition_rows(n, fpms, eps))
        if base == "fpm-pad" and real:
            # Even pads only: the half-spectrum crop identity holds for any
            # length >= n, and the model picks among even beneficial lengths.
            from repro_torch.plan.pads import rfft_pad_lengths
            pads = rfft_pad_lengths(fpms, part.d, n)
        elif base == "fpm-pad":
            from repro_torch.plan.pads import fpm_pad_lengths
            pads = fpm_pad_lengths(fpms, part.d, n)
        elif base == "fpm-czt":
            from repro_torch.plan.pads import czt_fft_lengths
            pads = czt_fft_lengths(fpms, part.d, n, limit_ratio=2.0)
        else:
            pads = None

    device = resolve_device(device)
    schedule, tuning = _resolve_schedule(n, method, part, pads, fpms, tune,
                                         wisdom, config, dtype, device,
                                         mesh=mesh, axis_name=axis_name)
    return PfftPlan(n=n, method=method, partition=part, pad_lengths=pads,
                    config=schedule.anchor_config, schedule=schedule,
                    tuning=tuning, device=device, dtype=dtype,
                    _groups=_plan_groups(method, schedule, part.d, device,
                                         mesh),
                    mesh=mesh, axis_name=axis_name)


def _check_mesh_plan(n: int, method: str, p: int | None, fpms, mesh,
                     axis_name: str) -> int:
    """The mesh rules of ``plan_pfft`` (its docstring); returns p."""
    from repro_torch.launch.mesh import axis_size
    mesh_p = axis_size(mesh, axis_name)
    base = _base_method(method)
    if method in _REAL_METHODS and base == "fpm-pad":
        raise ValueError(
            "the distributed real path runs the homogeneous unpadded "
            "program; use method='rfft-lb' with mesh=, or plan "
            "'rfft-fpm-pad' single-device")
    if p is None:
        p = mesh_p
    elif p != mesh_p:
        raise ValueError(f"p={p} conflicts with mesh axis "
                         f"{axis_name!r} size {mesh_p}")
    if n % p:
        raise ValueError(f"N={n} must be divisible by mesh axis "
                         f"{axis_name}={p}")
    if base == "fpm":
        raise ValueError(
            "plan_pfft(mesh=...) spreads rows evenly, so plain "
            f"method={method!r} would run exactly as the 'lb' variant (its "
            "FPMs can only move the *row* split, which SPMD fixes) — use "
            "the 'lb' variant, or 'fpm-pad'/'fpm-czt' for FPM-driven "
            "per-rank pads and execution variants")
    if base != "lb" and fpms is not None and fpms.p != p:
        raise ValueError(
            f"plan_pfft(mesh=...) assigns one abstract processor per "
            f"rank: fpms covers {fpms.p} processors but the mesh axis "
            f"{axis_name!r} has {p} ranks")
    return p


def _mesh_plan_device(mesh, device) -> torch.device:
    """A distributed plan's device: the rank's (``launch.mesh.mesh_device``);
    an explicit ``device`` must be of the mesh's type."""
    from repro_torch.launch.mesh import mesh_device
    own = mesh_device(mesh)
    if device is not None and torch.device(device).type != own.type:
        raise ValueError(f"device={device!r} conflicts with the "
                         f"{mesh.device_type} mesh")
    return own


def rfft2(m, *, p: int | None = None, tune: TuneMode = "off",
          wisdom: str | None = None, mesh=None,
          axis_name: str = "fft") -> torch.Tensor:
    """One-shot planned real-input 2-D DFT -> (N, N//2+1) half spectrum.

    Builds an ``rfft-lb`` plan for ``m``'s size, dtype and device and
    executes it once.  A host array goes to the default (CUDA) device.  For
    the plan-once/run-many lifecycle (or the FPM methods) use
    ``plan_pfft(method='rfft-...')`` directly.  ``p`` defaults to 1, or to
    the axis size with ``mesh=``, where ``m`` is this rank's ``(N/p, N)``
    row block and the result its ``(N/p, N//2+1)`` block.
    """
    m = as_tensor(m)
    rows = m.shape[-1]
    if mesh is not None and m.ndim >= 2:
        from repro_torch.launch.mesh import axis_size
        rows = m.shape[-1] // axis_size(mesh, axis_name)
    if m.ndim < 2 or m.shape[-2] != rows:
        raise ValueError(
            f"rfft2 plans square (N, N) signals (this rank's (N/p, N) block "
            f"on a mesh), got {tuple(m.shape)}")
    plan = plan_pfft(m.shape[-1], p=p if p is not None or mesh is not None
                     else 1, method="rfft-lb", tune=tune, wisdom=wisdom,
                     dtype=str(m.dtype).removeprefix("torch."), mesh=mesh,
                     axis_name=axis_name,
                     device=m.device if mesh is None else None)
    return plan.execute(m)


def irfft2(h, *, n: int | None = None) -> torch.Tensor:
    """Inverse of ``rfft2``: half spectrum back to the real signal
    (``repro_torch.fft.irfft2``; pass ``n`` for odd original lengths)."""
    from repro_torch.fft.fft2d import irfft2 as _irfft2
    return _irfft2(h, n=n)


# ---------------------------------------------------------------------- 3-D

def _wisdom_config(wisdom: str | None, key: str, tuning: dict[str, Any]
                   ) -> PlanConfig | None:
    """A stored config for ``key`` (a schedule or another kind of entry
    is a miss), with ``tuning`` marked as served from wisdom."""
    if wisdom is None:
        return None
    hit = lookup_wisdom(wisdom, key)
    if hit is None or not isinstance(hit[0], PlanConfig):
        return None
    tuning["source"] = "wisdom"
    tuning["wisdom_entry"] = hit[1]
    return normalize_pad(hit[0], "none")


@dataclasses.dataclass
class Pfft3Plan:
    """A planned 3-D transform — same plan/execute/wisdom lifecycle as
    ``PfftPlan``, for cubic N^3 signals.

    Single-device plans run the axis passes (``core.pfft3d``) over an lb
    partition of the planes into ``p`` segments, with their dispatch
    groups' plane indices made once on the plan's device.  Distributed
    plans run the pencil pipeline (``pfft3_pencil``) on the captured 2-D
    mesh in the *tuned orientation* ``axis_names`` (which mesh axis plays
    row is a degree of freedom on rectangular meshes — see
    ``tune_pfft3``)."""
    n: int
    method: str
    config: PlanConfig
    tuning: dict[str, Any]
    device: torch.device
    p: int = 1
    dtype: str = "complex64"
    _groups: Any = dataclasses.field(default_factory=list, repr=False,
                                     compare=False)
    mesh: Any = None
    axis_names: tuple[str, str] | None = None

    @property
    def d(self) -> np.ndarray:
        return lb_partition(self.n, self.p).d

    @property
    def block_shape(self) -> tuple[int, int, int]:
        """The block ``execute`` takes: the cube, or on a mesh this rank's
        ``(N/r, N/c, N)`` pencil of the orientation ``axis_names``."""
        if self.mesh is None:
            return (self.n,) * 3
        from repro_torch.launch.mesh import axis_size
        r, c = (axis_size(self.mesh, a) for a in self.axis_names)
        return (self.n // r, self.n // c, self.n)

    def execute(self, m) -> torch.Tensor:
        """Run the planned transform.

        Single-device: leading batch dims are batched (each dispatch group
        of each pass runs once over the planes of all the cubes).  On a
        mesh: rank ``(i, j)`` — its coordinates along ``axis_names`` —
        passes ``cube[i·N/r:(i+1)·N/r, j·N/c:(j+1)·N/c, :]`` and gets its
        ``(N, N/r, N/c)`` block of ``fftn`` back (``pfft3_pencil``); every
        rank calls it alike, one cube per call."""
        from repro_torch.core.pfft3d import _pfft3, pfft3_pencil
        m = _on_plan_device(m, self.device)
        shape = self.block_shape
        if m.ndim < 3 or tuple(m.shape[-3:]) != shape:
            raise ValueError(
                f"plan is for {shape} "
                f"{'pencils' if self.mesh is not None else 'signals'} "
                f"(optionally with leading batch dims), got {tuple(m.shape)}")
        if self.mesh is None:
            return _pfft3(m, self.d, config=self.config, groups=self._groups)
        if m.ndim > 3:
            raise ValueError(
                "distributed pfft3 plans transform one cube per call "
                "(vmapping over shard_map is not supported); loop instead")
        return pfft3_pencil(m, self.mesh, self.axis_names, config=self.config)

    def execute_many(self, ms, *, pad_to: int | None = None,
                     stages: dict | None = None) -> list:
        """Serve a cohort of cubes in ONE batched execute — the 3-D
        sibling of ``PfftPlan.execute_many``."""
        return _execute_many(self, ms, (self.n,) * 3, pad_to, stages)


def _stored_pfft3(hit, axes0: tuple[str, str] | None):
    """(config, orientation) of a stored 3-D plan, or None: the entry must
    be a config, and on a mesh a stored orientation that names other axes
    than the mesh's (drifted) is a miss, not an error."""
    if hit is None or not isinstance(hit[0], PlanConfig):
        return None
    waxes = axes0
    stored = hit[1].get("pfft3_orientation")
    if axes0 is not None and stored is not None:
        waxes = tuple(stored)
        if sorted(waxes) != sorted(axes0):
            return None
    return normalize_pad(hit[0], "none"), waxes


def plan_pfft3(n: int, *, p: int | None = None, mesh=None,
               axis_names: tuple[str, str] = ("fft_r", "fft_c"),
               tune: TuneMode = "off", wisdom: str | None = None,
               config: PlanConfig | None = None, dtype: str = "complex64",
               device: str | torch.device | None = None) -> Pfft3Plan:
    """Plan the 3-D transform; see ``plan_pfft`` for the lifecycle.

    Without a mesh the plan runs the single-device axis passes over an lb
    partition of ``p`` segments (default 1; 1 <= p <= N).  Resolution
    order: explicit config > wisdom hit (also at ``tune="off"``) > tuner >
    default; the wisdom key's backend is the plan's device type, and a
    measured pick is recorded with its comm sample.

    ``mesh=`` plans the pencil-parallel pipeline over a 2-D r x c
    ``DeviceMesh`` (``launch.mesh.make_pfft3_mesh``; both ``axis_names``
    must exist on it, N must divide by both sizes, ``p`` must be r*c if
    given); every rank calls it alike and the plan lives on the rank's
    device.  The wisdom key gains the mesh's 2-D ``topology_digest``
    ('+'-joined per-axis terms, so a transposed mesh gets its own key);
    ``tune="measure"`` races config x panel x *orientation* finalists
    through the full two-exchange pipeline, each time the slowest rank's;
    a measured winner persists with its orientation
    (``extra["pfft3_orientation"]``), so a second plan on the same mesh is
    served from disk with nothing measured.  The first rank looks the store
    up and hands the answer to every rank, and alone writes it (the others
    wait at a barrier).
    """
    if tune not in ("off", "estimate", "measure"):
        raise ValueError(f"tune must be 'off'|'estimate'|'measure', got {tune!r}")
    if np.dtype(dtype).kind != "c":
        raise ValueError(
            f"plan_pfft3 transforms complex input, got dtype={dtype!r}")
    from repro_torch.core.pfft3d import plane_groups
    from repro_torch.core.pfft_dist import require_mesh_divisible
    from repro_torch.plan.tune import pfft3_panel_space, tune_pfft3

    method = "pfft3-lb"
    axes0 = panels = topo = None
    if mesh is not None:
        from repro_torch.launch.mesh import axis_size
        axes0 = tuple(axis_names)
        if len(axes0) != 2:
            raise ValueError(
                f"plan_pfft3(mesh=...) needs two axis names, got {axes0!r}")
        r, c = axis_size(mesh, axes0[0]), axis_size(mesh, axes0[1])
        require_mesh_divisible(n, r, axes0[0])
        require_mesh_divisible(n, c, axes0[1])
        q = r * c
        if p is not None and p != q:
            raise ValueError(f"p={p} conflicts with mesh {axes0[0]}x"
                             f"{axes0[1]} = {r}x{c} = {q} devices")
        device = _mesh_plan_device(mesh, device)
        panels = pfft3_panel_space(n, r, c)
        topo = topology_digest(mesh, axes0, panels=panels)
    else:
        q = int(p) if p is not None else 1
        if not 1 <= q <= n:
            raise ValueError(f"need 1 <= p <= N, got p={q} for N={n}")
        device = resolve_device(device)
    tuning: dict[str, Any] = {"mode": tune}

    def build(cfg: PlanConfig, waxes) -> Pfft3Plan:
        groups = [] if mesh is not None else plane_groups(
            n, lb_partition(n, q).d, None, cfg, device)
        return Pfft3Plan(n=n, method=method, config=cfg, tuning=tuning,
                         device=device, p=q, dtype=dtype, _groups=groups,
                         mesh=mesh, axis_names=waxes)

    def agreed(fn):
        """``fn()``, the first rank's answer on a mesh."""
        return fn() if mesh is None else first_rank_value(mesh, axes0, fn)

    if config is not None:
        tuning["source"] = "explicit"
        return build(normalize_pad(config, "none"), axes0)

    if topo is not None:
        tuning["topology"] = topo
    key = wisdom_key(n=n, dtype=dtype, p=q, method=method,
                     backend=device.type, topology=topo)
    tuning["wisdom_key"] = key
    if wisdom is not None:
        hit = agreed(lambda: lookup_wisdom(wisdom, key))
        stored = _stored_pfft3(hit, axes0)
        if stored is not None:
            tuning["source"] = "wisdom"
            tuning["wisdom_entry"] = hit[1]
            return build(*stored)

    if tune == "off":
        tuning["source"] = "off"
        return build(PlanConfig(), axes0)

    cfg, waxes, info = tune_pfft3(n, mesh, axis_names, mode=tune,
                                  panels=panels, dtype=np.dtype(dtype),
                                  device=device)
    tuning.update(info)
    tuning["source"] = tune
    if wisdom is not None and tune == "measure":
        stats = info["pfft3"]
        extra: dict[str, Any] = {}
        if topo is not None:
            extra.update(topology=topo, pfft3_orientation=list(waxes))
        if stats.get("comm_time_meas_s") is not None:
            extra["comm_bytes"] = stats["comm_bytes"]
            extra["comm_time_s"] = stats["comm_time_meas_s"]
        if int(stats.get("hosts", 1)) > 1:
            extra["hosts"] = int(stats["hosts"])

        def record():
            record_wisdom(wisdom, key, cfg, mode="measure",
                          time_s=info.get("time_s"), extra=extra or None)

        if mesh is None:
            record()
        else:
            first_rank_does(mesh, axes0, record)
    return build(cfg, waxes)


# ------------------------------------------------------------------ huge 1-D

@dataclasses.dataclass
class Pfft1LargePlan:
    """A planned four-step huge-1-D transform (``core.pfft_large``); the
    twiddle table is made once, on the plan's device."""
    n: int
    n1: int
    n2: int
    method: str
    config: PlanConfig
    tuning: dict[str, Any]
    device: torch.device
    dtype: str = "complex64"
    _twiddle: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)

    def execute(self, x) -> torch.Tensor:
        """Run the planned transform; leading batch dims are batched (each
        phase is one dispatch over the rows of all the lines)."""
        from repro_torch.core.pfft_large import pfft1_large_apply
        x = _on_plan_device(x, self.device)
        if x.ndim < 1 or int(x.shape[-1]) != self.n:
            raise ValueError(
                f"plan is for length-{self.n} 1-D signals "
                f"(optionally with leading batch dims), got {tuple(x.shape)}")
        return pfft1_large_apply(x, config=self.config, n1=self.n1,
                                 n2=self.n2, twiddle=self._twiddle)

    def execute_many(self, xs, *, pad_to: int | None = None,
                     stages: dict | None = None) -> list:
        """Serve a cohort of lines in ONE batched execute — the 1-D
        sibling of ``PfftPlan.execute_many``."""
        return _execute_many(self, xs, (self.n,), pad_to, stages)


def plan_pfft1_large(n: int, *, tune: TuneMode = "off",
                     wisdom: str | None = None,
                     config: PlanConfig | None = None,
                     dtype: str = "complex64", n1: int | None = None,
                     n2: int | None = None,
                     device: str | torch.device | None = None
                     ) -> Pfft1LargePlan:
    """Plan one huge 1-D line through the EFFT four-step pipeline.

    ``n1``/``n2`` pin the factorization (default: most-square split —
    ``four_step_factors``); a non-default split enters the wisdom key as
    a ``part=`` detail, since the best row-FFT variant depends on which
    lengths the two phases actually run at.  A config that sends a phase
    of a power-of-two length above ``MAX_LARGE_N`` to the complex row FFT
    raises ``KernelLengthError`` here, before the twiddle table is made.
    """
    if tune not in ("off", "estimate", "measure"):
        raise ValueError(f"tune must be 'off'|'estimate'|'measure', got {tune!r}")
    if np.dtype(dtype).kind != "c":
        raise ValueError(
            f"plan_pfft1_large transforms complex input, got dtype={dtype!r}")
    from repro_torch.core.pfft_large import four_step_factors, twiddle_table
    from repro_torch.kernels.fft.kernel import MAX_LARGE_N, KernelLengthError
    from repro_torch.plan.tune import tune_pfft1_large

    method = "pfft1-large"
    f1, f2 = four_step_factors(n, n1=n1, n2=n2)
    default = four_step_factors(n)
    detail = f"{f1}x{f2}" if (f1, f2) != default else None
    device = resolve_device(device)
    tuning: dict[str, Any] = {"mode": tune, "n1": f1, "n2": f2}

    def build(cfg: PlanConfig) -> Pfft1LargePlan:
        if cfg.row_fft_kwargs()["backend"] == "cuda":
            for length in (f2, f1):
                if length > MAX_LARGE_N and not length & (length - 1):
                    raise KernelLengthError("plan_pfft1_large", length, MAX_LARGE_N)
        return Pfft1LargePlan(n=n, n1=f1, n2=f2, method=method, config=cfg,
                              tuning=tuning, device=device, dtype=dtype,
                              _twiddle=twiddle_table(f1, f2, device))

    if config is not None:
        tuning["source"] = "explicit"
        return build(normalize_pad(config, "none"))

    key = wisdom_key(n=n, dtype=dtype, p=1, method=method,
                     backend=device.type, detail=detail)
    tuning["wisdom_key"] = key
    stored = _wisdom_config(wisdom, key, tuning)
    if stored is not None:
        return build(stored)

    if tune == "off":
        tuning["source"] = "off"
        return build(PlanConfig())

    cfg, info = tune_pfft1_large(n, n1=f1, n2=f2, mode=tune,
                                 dtype=np.dtype(dtype), device=device)
    tuning.update(info)
    tuning["source"] = tune
    if wisdom is not None and tune == "measure":
        record_wisdom(wisdom, key, cfg, mode="measure",
                      time_s=info.get("time_s"))
    return build(cfg)


def pfft1_large(x, *, tune: TuneMode = "off", wisdom: str | None = None,
                n1: int | None = None, n2: int | None = None) -> torch.Tensor:
    """One-shot planned four-step 1-D DFT of a long line.

    Convenience wrapper over ``plan_pfft1_large`` for ``x``'s length,
    dtype and device (a host array goes to the default, CUDA, device); use
    the plan directly for the plan-once/run-many lifecycle.
    """
    x = as_tensor(x)
    if x.ndim != 1:
        raise ValueError(
            f"pfft1_large transforms one 1-D line, got shape {tuple(x.shape)}")
    dt = x.dtype if x.is_complex() else torch.complex64
    plan = plan_pfft1_large(int(x.shape[0]), tune=tune, wisdom=wisdom,
                            dtype=str(dt).removeprefix("torch."), n1=n1,
                            n2=n2, device=x.device)
    return plan.execute(x.to(dt))
