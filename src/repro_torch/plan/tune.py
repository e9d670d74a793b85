"""Estimate/measure tuner — FFTW's planner loop over ``PlanConfig`` space.

Counterpart of ``repro.plan.tune``: the single-device tuners, the 3-D
(``tune_pfft3``, on one device or a pencil mesh) and huge-1-D
(``tune_pfft1_large``) ones, and the 2-D distributed ones
(``tune_dist_config``, ``tune_rfft_dist``, ``tune_dist_schedule``) that
plan for ``core.pfft_dist`` on a mesh.
``candidate_configs`` enumerates the valid variant space for a problem
(radix x fused x batched x pipeline_panels, pruned by structural
constraints); ``tune_config`` ranks it:

* ``mode="estimate"`` — cost model only (``plan.cost``), no device work.
  FFTW's ESTIMATE: instant, right whenever the model's ranking is.
* ``mode="measure"`` — time the ``top_k`` cheapest candidates on the device
  (``measure_configs``: interleaved round-robin, per-config min) and take
  the winner.  FFTW's MEASURE: pays seconds once so every later execute
  is served by the best plan.

Every ``measure_*`` and ``tune_*`` takes ``device=``: ``None`` is the CUDA
device (raising without one), ``"cpu"`` runs the kernels' plain versions.

The candidate pot never holds a configuration that cannot run: every row
kernel (K1-K4, and their four-step versions K1b-K4b above
``MAX_KERNEL_N``) takes power-of-two rows up to ``MAX_LARGE_N``.  So
``radix=4`` and ``fused`` are offered only where every power-of-two
effective length is at most ``MAX_LARGE_N``; up to there the pot is the
reference's, config for config, on every device.

The caller (``plan_pfft``) persists the result via ``plan.wisdom`` so
measurement happens once per (n, dtype, p, method, backend) per machine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.fpm import FPMSet, fft_flops
from repro_torch.kernels.fft.kernel import MAX_LARGE_N
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.cost import (CostParams, _compute_multiplier,
                                   _segment_work, comm_phase_time,
                                   dist_comm_bytes, dist_comm_time,
                                   estimate_cost, estimate_grouped_cost,
                                   estimate_schedule_cost)
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["candidate_configs", "segment_candidate_configs",
           "measure_configs", "measure_dist_configs", "tune_config",
           "tune_schedule", "tune_dist_config", "tune_dist_schedule",
           "grouped_dist_schedule", "dist_panel_space",
           "measure_rfft_configs", "measure_rfft_dist_configs",
           "tune_rfft", "tune_rfft_dist", "pfft3_panel_space",
           "measure_pfft3_configs", "tune_pfft3", "tune_pfft1_large"]


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


def _kernel_takes(length: int) -> bool:
    """Whether the CUDA row kernels run a row of ``length``: any length that
    is not a power of two goes to the library (``fft_rows``' rule), a power
    of two up to ``MAX_LARGE_N`` to the kernels; a longer power of two would
    raise ``KernelLengthError``."""
    return not _is_pow2(length) or length <= MAX_LARGE_N


def _params_for(params: CostParams | None, device) -> CostParams:
    """``params``, or the constants of the device type the plan runs on."""
    if params is not None:
        return params
    return CostParams.for_backend(
        None if device is None else torch.device(device).type)


def _noted(box: dict, key: str, prefix: str = ""):
    """A ``fallback`` for the measure helpers: writes ``prefix`` and the
    error's ``repr`` into ``box[key]`` and returns None."""
    def note(err: BaseException):
        box[key] = f"{prefix}{err!r}"
    return note


def _measure_with_retry(thunk, retries: int = 0, base_s: float = 0.05, *,
                        fallback=None):
    """Run a measurement thunk, retrying transient failures with
    exponential backoff.

    ``retries=0`` (the default) raises the first failure.  When a positive
    budget is spent, ``fallback(err)`` is returned (``_noted`` records why
    and gives None), or the error re-raised without one.
    """
    delay = float(base_s)
    for attempt in range(int(retries) + 1):
        try:
            return thunk()
        except Exception as err:
            if attempt >= retries:
                if retries <= 0 or fallback is None:
                    raise
                return fallback(err)
            time.sleep(delay)
            delay *= 2.0


def _agreed_measure(thunk, retries: int, mesh, axis_name,
                    base_s: float = 0.05, *, fallback=None):
    """``_measure_with_retry`` for a measurement every rank of a mesh runs
    alike (over ``axis_name``'s ranks, or the whole mesh for a sequence of
    names).

    Every rank runs ``thunk`` and catches its own failure; then the ranks
    agree whether any of them failed (``launch.mesh.agree_on_failure``).
    If one did, every rank sleeps the same backoff and retries, so all of
    them meet at the same collectives again.  When a positive budget is
    spent, every rank returns ``fallback`` of one ``RuntimeError`` carrying
    the first failing rank's error, so the fallback is the same on every
    rank (without a fallback, that error is raised).  With ``retries=0`` a
    rank that failed raises its own error, the others that ``RuntimeError``.

    Only a failure this rank returns from is covered: a rank that fails
    inside a collective leaves its peers stranded there, which is the loss
    path's business (``runtime.resilient``), not this helper's.
    """
    from repro_torch.launch.mesh import agree_on_failure  # lazy: launch is thin
    delay = float(base_s)
    for attempt in range(int(retries) + 1):
        err = out = None
        try:
            out = thunk()
        except Exception as caught:  # agreed below, then raised or retried
            err = caught
        first = agree_on_failure(err, mesh, axis_name)
        if first is None:
            return out
        if attempt >= retries:
            if err is not None and retries <= 0:
                raise err
            agreed = RuntimeError(f"a rank's measurement failed: {first}")
            if retries <= 0 or fallback is None:
                raise agreed from err
            return fallback(agreed)
        time.sleep(delay)
        delay *= 2.0


def candidate_configs(n: int, *, pad: str = "none", d=None,
                      panels: Sequence[int] = (1,),
                      pad_lengths=None) -> list[PlanConfig]:
    """Valid ``PlanConfig`` candidates for an n x n problem.

    ``pad`` is fixed by the method (it is semantics, not a tunable);
    ``fused`` requires a power-of-two N the kernel takes and no
    per-segment padding; the kernel radices require a power-of-two N (and
    the czt path runs library FFTs inside ``czt_dft`` whatever the radix
    says, so czt enumerates only the dispatch structure); ``radix=4`` also
    requires that the row kernels take every effective length (``n`` and
    each busy segment's ``pad_lengths`` entry), and ``fused`` that they
    take ``n`` (``_kernel_takes``); ``batched`` only matters when the
    partition has more than one non-empty segment.
    """
    radices: list[int | None] = [None]
    if pad != "czt" and _is_pow2(n):
        radices.append(2)
        lengths = [length for _, length in _segment_work(n, d, pad_lengths)]
        if all(_kernel_takes(length) for length in [n] + lengths):
            radices.append(4)
    multi_segment = d is None or int((np.asarray(d) > 0).sum()) > 1
    batch_opts = (True, False) if multi_segment else (True,)

    out: list[PlanConfig] = []
    for k in panels:
        for radix in radices:
            for batched in batch_opts:
                out.append(PlanConfig(radix=radix, batched=batched, pad=pad,
                                      pipeline_panels=k))
        if pad == "none" and _is_pow2(n) and _kernel_takes(n):
            # Fused collapses each phase to one dispatch; segmentation (and
            # therefore batched) is moot, and the kernel is radix-4.
            out.append(PlanConfig(radix=4, fused=True, pipeline_panels=k))
    return out


def segment_candidate_configs(length: int, *, pad: str = "none"
                              ) -> list[PlanConfig]:
    """Per-segment variants for one effective FFT length.

    A segment entry tunes only what is segment-local: the row-FFT backend
    (``radix``).  Phase-global knobs stay out of the per-segment space —
    ``fused`` collapses the whole matrix into one dispatch, ``batched``
    and ``pipeline_panels`` shape the phase, and they are all covered by
    the homogeneous envelope ``tune_schedule`` compares against.  The czt
    path has a single per-segment shape (``czt_dft`` at the entry's
    length), so it contributes exactly one candidate.  ``radix=4`` needs
    a power-of-two length the complex row FFT takes.
    """
    if pad == "czt":
        return [PlanConfig(pad="czt")]
    radices: list[int | None] = [None]
    if _is_pow2(length):
        radices.append(2)
        if _kernel_takes(length):
            radices.append(4)
    return [PlanConfig(radix=r, pad=pad) for r in radices]


def _length_backend(cfg: PlanConfig, length: int) -> tuple[str, int | None]:
    """Effective (backend, radix) for one length: kernel backends send
    non-pow2 lengths to the library (``fft_rows``); the one home of that
    rule for behavior keys and Pareto dedup."""
    kw = cfg.row_fft_kwargs()
    if kw["backend"] != "torch" and not _is_pow2(length):
        return "torch", None
    return kw["backend"], kw["radix"]


def _signal(shape: tuple[int, ...], dtype, device) -> torch.Tensor:
    """The measurement input: seeded numpy noise (``default_rng(0)``, as
    the reference's), moved to ``device``."""
    rng = np.random.default_rng(0)
    dt = np.dtype(dtype)
    x = rng.standard_normal(shape)
    if dt.kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(dt)).to(resolve_device(device))


def _timed_min(pairs, x: torch.Tensor, rounds: int,
               events: dict | None = None) -> dict:
    """{item: best wall seconds} over ``rounds`` shuffled-interleaved
    episodes.

    The shared timing discipline of every measure harness here: an
    untimed same-fn warm run before each timed one (evict the shuffled
    neighbour's allocator/cache state), per-item min across rounds.  On
    CUDA each timed run sits between two ``torch.cuda.synchronize()``
    calls and is timed with ``time.perf_counter()``: wall time, because
    the host's Python dispatch is what batched-vs-looped trades and what
    the cost model prices as ``dispatch_overhead_s``.  ``events``, when
    given, receives {item: best CUDA-event seconds} of the same runs (the
    device's share; nothing on the CPU).  ``pairs``: [(item, fn)].
    """
    cuda = x.is_cuda
    rng = np.random.default_rng(1)
    times = {item: float("inf") for item, _ in pairs}
    device_times = {item: float("inf") for item, _ in pairs}
    for _ in range(max(rounds, 1)):
        for i in rng.permutation(len(pairs)):
            item, fn = pairs[int(i)]
            fn(x)  # warm: evict neighbour's state
            if cuda:
                torch.cuda.synchronize(x.device)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            fn(x)
            if cuda:
                stop.record()
                torch.cuda.synchronize(x.device)
            times[item] = min(times[item], time.perf_counter() - t0)
            if cuda:
                device_times[item] = min(device_times[item],
                                         start.elapsed_time(stop) * 1e-3)
    if events is not None and cuda:
        events.update(device_times)
    return times


def _warmed(pairs, x: torch.Tensor) -> list:
    """Run each fn once, untimed: the first launch on a card is where the
    kernels' library is built and the caches are filled."""
    for _, fn in pairs:
        fn(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return pairs


def _limb_fn(item: PlanConfig | SegmentSchedule, n: int, d_eff, pad_lengths,
             device: torch.device):
    """The complex limb of one item as a plan runs it: its schedule and
    dispatch groups made once, here, outside the timed runs."""
    from repro_torch.core.pfft import _pfft_limb, device_groups  # lazy: core imports plan
    schedule = (item if isinstance(item, SegmentSchedule)
                else SegmentSchedule.homogeneous(item, n, d_eff, pad_lengths))
    groups = device_groups(schedule, device)
    return lambda m: _pfft_limb(m, d_eff, schedule=schedule, groups=groups)


def measure_configs(configs: Sequence[PlanConfig | SegmentSchedule], n: int,
                    *, d=None, pad_lengths=None, dtype=np.complex64,
                    rounds: int = 3, device=None,
                    events: dict | None = None
                    ) -> dict[PlanConfig | SegmentSchedule, float]:
    """Seconds of the limb per config on ``device``: {config: best_s}.

    Interleaved in a per-round *shuffled* order, per-config min over
    ``rounds``, with an untimed same-config warm run before every timed
    one: close variants (batched vs looped) differ by far less than the
    episode-to-episode jitter, and a fixed visiting order would tax each
    config by whatever allocator/cache state its fixed neighbour leaves
    behind.  Shuffling varies the predecessor; min keeps each config's
    best-context episode.  This is the shared harness of measure-mode
    tuning and the planner microbenchmark.  ``events`` receives the CUDA
    event times (``_timed_min``).

    ``d=None`` means one whole-matrix segment (the cost model's
    convention).  Items may be ``PlanConfig``s *or* ``SegmentSchedule``s
    (both hashable) — ``tune_schedule``'s measure mode races assembled
    heterogeneous schedules against homogeneous configs in one pot.
    """
    x = _signal((n, n), dtype, device)
    d_eff = np.asarray(d) if d is not None else np.array([n], dtype=np.int64)
    pairs = _warmed([(item, _limb_fn(item, n, d_eff, pad_lengths, x.device))
                     for item in configs], x)
    return _timed_min(pairs, x, rounds, events)


def _behavior_key(cfg: PlanConfig, n: int, d, pad_lengths) -> tuple:
    """What program actually runs under ``cfg`` for this problem.

    Kernel backends send non-power-of-two effective lengths to the
    library (``fft_rows``), so e.g. radix=None/2/4 are one and the same
    program when every padded length is non-pow2 — measuring more than
    one of them wastes the measure budget on rubber-stamping.
    """
    lengths = sorted({length for _, length in _segment_work(n, d, pad_lengths)})
    if cfg.fused:
        return ("fused", cfg.real, cfg.exchange, tuple(lengths))
    per_len = [(length,) + _length_backend(cfg, length) for length in lengths]
    return (cfg.batched, cfg.pipeline_panels, cfg.real, cfg.exchange,
            tuple(per_len))


def _measured_info(info: dict, measured: dict, events: dict, describe) -> None:
    """The measure audit trail: wall seconds (``measured``) and, on CUDA,
    the event seconds of the same runs (``measured_event_s``)."""
    info["measured"] = [(describe(c), float(t)) for c, t in measured.items()]
    if events:
        info["measured_event_s"] = [(describe(c), float(events[c]))
                                    for c in measured]


def tune_config(n: int, *, d=None, pad_lengths=None, fpms: FPMSet | None = None,
                mode: str = "estimate", pad: str = "none",
                params: CostParams | None = None, top_k: int = 3,
                panels: Sequence[int] = (1,), comm_bytes: float = 0.0,
                dtype=np.complex64, reps: int = 3, device=None
                ) -> tuple[PlanConfig, dict]:
    """Pick the best ``PlanConfig`` for the problem; returns (config, info).

    ``info`` carries the full ranking (``"ranked"``: (config dict, predicted
    seconds), cheapest first) and, in measure mode, the times of the
    ``top_k`` finalists on ``device`` (``"measured"``) — the planner's audit
    trail, also persisted into wisdom entries.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    if d is not None:
        d = np.asarray(d)

    cands = candidate_configs(n, pad=pad, d=d, panels=panels,
                              pad_lengths=pad_lengths)
    params = _params_for(params, device)
    ranked = sorted(
        ((cfg, estimate_cost(cfg, n=n, d=d, pad_lengths=pad_lengths,
                             fpms=fpms, params=params, comm_bytes=comm_bytes))
         for cfg in cands),
        key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), float(c)) for cfg, c in ranked],
    }

    if mode == "estimate":
        return ranked[0][0], info

    if comm_bytes:
        raise ValueError(
            "measure mode with comm_bytes needs the mesh the bytes cross: "
            "tune_dist_config / tune_dist_schedule race on one")
    # One finalist per distinct *program*: ties in the ranking are often
    # configs whose differences are erased by the routing rules.
    finalists, seen = [], set()
    for cfg, _ in ranked:
        key = _behavior_key(cfg, n, d, pad_lengths)
        if key not in seen:
            seen.add(key)
            finalists.append(cfg)
        if len(finalists) >= max(top_k, 1):
            break
    events: dict = {}
    measured = measure_configs(finalists, n, d=d, pad_lengths=pad_lengths,
                               dtype=dtype, rounds=reps, device=device,
                               events=events)
    winner = min(measured, key=measured.get)
    _measured_info(info, measured, events, PlanConfig.to_dict)
    info["time_s"] = float(measured[winner])
    return winner, info


def _measure_length_group(configs: Sequence[PlanConfig], rows: int,
                          length: int, n: int, dtype, rounds: int,
                          device=None, events: dict | None = None
                          ) -> dict[PlanConfig, float]:
    """Seconds of one dispatch group's row-FFT program per config.

    The program is exactly what the schedule executor runs for a
    ``(length, config)`` group (``core.pfft._group_row_ffts``): take
    ``rows`` rows of the N-wide matrix, pad to ``length`` (or chirp-Z at
    it), transform, crop.  Same shuffled-interleaved-min discipline as
    ``measure_configs``.
    """
    from repro_torch.core.pfft import _group_row_ffts  # lazy: core imports plan

    x = _signal((rows, n), dtype, device)
    pairs = _warmed([(cfg, lambda m, c=cfg: _group_row_ffts(m, length, n, c, None))
                     for cfg in configs], x)
    return _timed_min(pairs, x, rounds, events)


def tune_schedule(n: int, *, d=None, pad_lengths=None,
                  fpms: FPMSet | None = None, mode: str = "estimate",
                  pad: str = "none", params: CostParams | None = None,
                  top_k: int = 3, panels: Sequence[int] = (1,),
                  comm_bytes: float = 0.0, dtype=np.complex64, reps: int = 3,
                  device=None) -> tuple[SegmentSchedule, dict]:
    """Pick the best per-segment execution schedule; returns (schedule, info).

    The heterogeneous generalisation of ``tune_config``: candidate
    configs are priced *per distinct effective FFT length*, each segment
    with its own FPM ``time_at``, so a slow processor can keep the
    library FFT while pow2-padded fast processors take the kernel in the
    same phase.

    * Single-length problems are the homogeneous problem and delegate to
      ``tune_config`` (whose candidate space also covers
      ``fused``/``batched=False``/``pipeline_panels``).
    * Otherwise, estimate mode picks the per-group argmin under the
      makespan objective, then keeps the heterogeneous schedule only if
      it beats the best *homogeneous* config's estimate (dispatch counts
      included) — the makespan can only improve, but extra dispatch
      groups are not free.
    * Measure mode times only the Pareto top-``top_k`` candidates per
      length group (distinct behaviors, cheapest-estimate first), then
      races the assembled schedule against the homogeneous winner end to
      end; ``info["time_s"]`` is the winner's limb time.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    if d is not None:
        d = np.asarray(d)
    params = _params_for(params, device)

    # (processor index, rows, effective length) of each non-empty segment.
    idx = [i for i, rows in enumerate(np.asarray(d))
           if rows > 0] if d is not None else [0]
    segments = [(i, rows, length) for i, (rows, length)
                in zip(idx, _segment_work(n, d, pad_lengths))]
    groups: dict[int, list[tuple[int, int]]] = {}
    for i, rows, length in segments:
        groups.setdefault(length, []).append((i, rows))

    if len(groups) <= 1:
        cfg, info = tune_config(n, d=d, pad_lengths=pad_lengths, fpms=fpms,
                                mode=mode, pad=pad, params=params,
                                top_k=top_k, panels=panels,
                                comm_bytes=comm_bytes, dtype=dtype, reps=reps,
                                device=device)
        schedule = SegmentSchedule.homogeneous(cfg, n, d, pad_lengths)
        info["chosen"] = "homogeneous"
        info["schedule"] = schedule.to_dict()
        return schedule, info

    if mode == "measure" and comm_bytes:
        raise ValueError(
            "measure mode with comm_bytes needs the mesh the bytes cross: "
            "tune_dist_config / tune_dist_schedule race on one")

    def group_time(cfg: PlanConfig, members, length: int) -> float:
        """Estimated makespan contribution of one length group under cfg."""
        def seg_t(i: int, rows: int) -> float:
            if fpms is not None:
                t = fpms[i].time_at(rows, length)
            else:
                t = float(fft_flops(rows, length)) / params.nominal_flops
            return t * _compute_multiplier(cfg, length, params)
        return max(seg_t(i, rows) for i, rows in members)

    info: dict = {"mode": mode, "groups": {}}
    picks: dict[int, PlanConfig] = {}
    for length, members in groups.items():
        cands = segment_candidate_configs(length, pad=pad)
        ranked = sorted(((cfg, group_time(cfg, members, length))
                         for cfg in cands), key=lambda kv: kv[1])
        info["groups"][str(length)] = [(c.to_dict(), float(t))
                                       for c, t in ranked]
        if mode == "estimate":
            picks[length] = ranked[0][0]
            continue
        # Pareto finalists: one per distinct program (the pow2 routing
        # erases radix differences), cheapest-estimate first, at most top_k.
        finalists, seen = [], set()
        for cfg, _ in ranked:
            key = (cfg.pad,) + _length_backend(cfg, length)
            if key not in seen:
                seen.add(key)
                finalists.append(cfg)
            if len(finalists) >= max(top_k, 1):
                break
        events: dict = {}
        measured = _measure_length_group(
            finalists, rows=sum(r for _, r in members), length=length,
            n=n, dtype=dtype, rounds=reps, device=device, events=events)
        picks[length] = min(measured, key=measured.get)
        info.setdefault("group_measured", {})[str(length)] = [
            (c.to_dict(), float(t)) for c, t in measured.items()]
        if events:
            info.setdefault("group_measured_event_s", {})[str(length)] = [
                (c.to_dict(), float(events[c])) for c in measured]

    p = len(d) if d is not None else 1
    default = PlanConfig(pad=pad)
    # Per-processor config: its length group's pick (idle processors get
    # the default; they have no schedule entry anyway).
    eff = {i: length for i, _, length in segments}
    cfg_list = [picks.get(eff.get(i, n), default) for i in range(p)]
    hetero = SegmentSchedule.from_parts(n, d, pad_lengths, cfg_list)
    est_hetero = estimate_schedule_cost(hetero, fpms=fpms, params=params,
                                        comm_bytes=comm_bytes)

    # Homogeneous envelope: the full candidate space under one config.
    homo_ranked = sorted(
        ((cfg, estimate_cost(cfg, n=n, d=d, pad_lengths=pad_lengths,
                             fpms=fpms, params=params, comm_bytes=comm_bytes))
         for cfg in candidate_configs(n, pad=pad, d=d, panels=panels,
                                      pad_lengths=pad_lengths)),
        key=lambda kv: kv[1])
    homo_cfg, est_homo = homo_ranked[0]
    homo = SegmentSchedule.homogeneous(homo_cfg, n, d, pad_lengths)
    info["ranked"] = [(c.to_dict(), float(t)) for c, t in homo_ranked]
    info["heterogeneous"] = {"schedule": hetero.to_dict(),
                             "est_s": float(est_hetero)}
    info["homogeneous"] = {"config": homo_cfg.to_dict(),
                           "est_s": float(est_homo)}

    if mode == "estimate":
        winner = homo if est_homo < est_hetero else hetero
    else:
        events = {}
        raced = measure_configs([hetero, homo], n, d=d,
                                pad_lengths=pad_lengths, dtype=dtype,
                                rounds=reps, device=device, events=events)
        winner = min(raced, key=raced.get)
        _measured_info(info, raced, events, SegmentSchedule.describe)
        info["time_s"] = float(raced[winner])
    info["chosen"] = ("heterogeneous" if len(winner.configs) > 1
                      else "homogeneous")
    info["schedule"] = winner.to_dict()
    return winner, info


# ------------------------------------------------------------------- real

def _require_real_dtype(dtype) -> np.dtype:
    """Validate a real-pipeline input dtype; returns the np.dtype."""
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(
            f"the real pipeline tunes float32/float64 inputs, got {dt.name}")
    return dt


def _real_candidates(cands: Sequence[PlanConfig],
                     lengths: Sequence[int] = ()) -> list[PlanConfig]:
    """The real-flagged twins of a complex candidate list (czt dropped —
    the real pipeline has no Bluestein form; ``radix=4`` dropped unless the
    real kernels take every effective length in ``lengths``)."""
    real4 = all(_kernel_takes(length) for length in lengths)
    return [dataclasses.replace(c, real=True) for c in cands
            if c.pad != "czt" and (real4 or c.radix != 4)]


def _family_finalists(ranked, n: int, d, pad_lengths, top_k: int
                      ) -> list[PlanConfig]:
    """Distinct-program finalists that always include the best candidate
    of *each* family (real and complex), so measure mode genuinely races
    real-vs-complex rather than burning every slot on one side."""
    finalists, seen = [], set()
    for cfg, _ in ranked:
        key = _behavior_key(cfg, n, d, pad_lengths)
        if key not in seen:
            seen.add(key)
            finalists.append(cfg)
        if len(finalists) >= max(top_k, 1):
            break
    for want_real in (True, False):
        if not any(c.real == want_real for c in finalists):
            best = next((c for c, _ in ranked if c.real == want_real), None)
            if best is not None:
                finalists.append(best)
    return finalists


def measure_rfft_configs(configs: Sequence[PlanConfig], n: int, *, d=None,
                         pad_lengths=None, dtype=np.float32, rounds: int = 3,
                         device=None, events: dict | None = None
                         ) -> dict[PlanConfig, float]:
    """Seconds of the half-spectrum limb per config on ``device``.

    ``real`` configs run ``_rpfft_limb`` on the real input; complex
    fallback configs run ``_pfft_limb`` on the upcast input and crop to
    the half spectrum — the *same* (N, N//2+1) deliverable with the same
    partition and pad lengths, so the race is apples-to-apples (the
    padded real phase equals the padded complex phase's half spectrum
    bin for bin — see ``core.pfft.halfspec_distribution``).  Each
    config's schedule and dispatch groups are made once, outside the
    timed runs, as a plan makes them.
    """
    from repro_torch.core.pfft import _rpfft_limb, real_limb_groups  # lazy

    dt = _require_real_dtype(dtype)
    ctype = torch.complex64 if dt == np.dtype(np.float32) else torch.complex128
    nh = n // 2 + 1
    d_eff = np.asarray(d) if d is not None else np.array([n], dtype=np.int64)
    x = _signal((n, n), dt, device)
    pairs = []
    for cfg in configs:
        if cfg.real:
            schedule = SegmentSchedule.homogeneous(cfg, n, d_eff, pad_lengths)
            groups = real_limb_groups(schedule, d_eff, x.device)
            fn = (lambda m, s=schedule, g=groups:
                  _rpfft_limb(m, d_eff, schedule=s, groups=g))
        else:
            limb = _limb_fn(cfg, n, d_eff, pad_lengths, x.device)
            fn = lambda m, f=limb: f(m.to(ctype))[:, :nh]
        pairs.append((cfg, fn))
    return _timed_min(_warmed(pairs, x), x, rounds, events)


def tune_rfft(n: int, *, d=None, pad_lengths=None, fpms: FPMSet | None = None,
              mode: str = "estimate", pad: str = "none",
              params: CostParams | None = None, top_k: int = 3,
              dtype=np.float32, reps: int = 3, device=None
              ) -> tuple[SegmentSchedule, dict]:
    """Tune a real-input half-spectrum problem; returns (schedule, info).

    The candidate pot holds *both families*: real-flagged configs (the
    rfft pipeline) and their complex twins (upcast + crop fallback), so
    the planner picks real-vs-complex per (n, dtype) on the cost model —
    or, in measure mode, on a race on ``device`` whose finalists always
    include the best of each family.  ``info["chosen_path"]`` says which
    side won; the returned schedule's configs carry the ``real`` flag the
    executor routes on.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    _require_real_dtype(dtype)
    if pad == "czt":
        raise ValueError("the real pipeline has no Bluestein form")
    if d is not None:
        d = np.asarray(d)
    params = _params_for(params, device)

    complex_cands = candidate_configs(n, pad=pad, d=d, pad_lengths=pad_lengths)
    lengths = [n] + [length for _, length in _segment_work(n, d, pad_lengths)]
    cands = _real_candidates(complex_cands, lengths) + complex_cands
    ranked = sorted(
        ((cfg, estimate_cost(cfg, n=n, d=d, pad_lengths=pad_lengths,
                             fpms=fpms, params=params))
         for cfg in cands),
        key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), float(c)) for cfg, c in ranked],
    }

    if mode == "estimate":
        winner = ranked[0][0]
    else:
        finalists = _family_finalists(ranked, n, d, pad_lengths, top_k)
        events: dict = {}
        measured = measure_rfft_configs(finalists, n, d=d,
                                        pad_lengths=pad_lengths, dtype=dtype,
                                        rounds=reps, device=device,
                                        events=events)
        winner = min(measured, key=measured.get)
        _measured_info(info, measured, events, PlanConfig.to_dict)
        info["time_s"] = float(measured[winner])
    info["chosen_path"] = "real" if winner.real else "complex"
    schedule = SegmentSchedule.homogeneous(winner, n, d, pad_lengths)
    info["schedule"] = schedule.to_dict()
    return schedule, info


# ------------------------------------------------------- pfft3 / huge 1-D

def pfft3_panel_space(n: int, r: int, c: int, max_panels: int = 8
                      ) -> tuple[int, ...]:
    """Candidate ``pipeline_panels`` for an N^3 problem on an r x c pencil
    mesh: the powers of two up to ``max_panels`` dividing *both* local
    extents (the pencil pipeline splits panels along whichever block axis
    the current exchange leaves alone, so k must divide N/r and N/c
    alike).  The one home of the rule — the pencil tuner and
    ``plan_pfft3(mesh=...)`` enumerate (and digest) the same space; without
    a mesh ``tune_pfft3`` offers k = 1 alone.
    """
    import math

    r, c = int(r), int(c)
    if r <= 0 or c <= 0 or n % r or n % c:
        return (1,)
    g = math.gcd(n // r, n // c)
    ks = [k for k in (1, 2, 4, 8) if k <= max_panels and g % k == 0]
    return tuple(ks) or (1,)


def _pass_length(n: int, cfg: PlanConfig, pad_len: int | None) -> int:
    """The effective row length of one local pass: ``pad_len``, else the
    reference's default per pad semantics (the model-free smooth size for
    the crop, the next power of two >= 2N-1 for czt, N otherwise)."""
    if pad_len is not None:
        return int(pad_len)
    if cfg.dist_padded == "crop":
        from repro_torch.core.padding import pad_to_smooth  # lazy: core imports plan
        return pad_to_smooth(n)
    if cfg.dist_padded == "czt":
        return 1 << int(np.ceil(np.log2(2 * n - 1)))
    return n


def _measure_pfft3_local_pass(cfg: PlanConfig, n: int, length: int, dtype,
                              rounds: int, device=None) -> float:
    """Seconds of one *local* axis pass of the single-device transform:
    the row-FFT program over the cube's N^2 rows at the effective length.
    Subtracting three of these from the end-to-end time leaves what the
    rotations (and, on a mesh, the exchanges) cost."""
    from repro_torch.core.pfft import _group_row_ffts  # lazy: core imports plan

    x = _signal((n * n, n), dtype, device)
    pairs = _warmed([(cfg, lambda b: _group_row_ffts(b, length, n, cfg, None))],
                    x)
    return _timed_min(pairs, x, rounds)[cfg]


def measure_pfft3_configs(configs: Sequence[PlanConfig], n: int, mesh,
                          axis_names: Sequence[str] = ("fft_r", "fft_c"), *,
                          pad_len: int | None = None, dtype=np.complex64,
                          rounds: int = 3, events: dict | None = None
                          ) -> dict[PlanConfig, float]:
    """End-to-end seconds of ``pfft3_pencil`` per config on ``mesh``.

    The 3-D sibling of ``measure_dist_configs``: times the full pencil
    pipeline — three local passes, both exchange rounds, pipelined panels,
    the final local permute — with the shuffled-interleaved per-config-min
    harness (``_timed_min``), each time the slowest of all ``r*c`` ranks.
    Every rank holds the same seeded ``(N/r, N/c, N)`` pencil of the
    orientation ``axis_names``; one call races one orientation (callers —
    ``tune_pfft3`` — merge per-orientation races themselves).  ``events``
    receives the CUDA-event times.
    """
    from repro_torch.core.pfft3d import pfft3_pencil  # lazy: core imports plan
    from repro_torch.launch.mesh import axis_size

    axes = tuple(axis_names)
    r, c = axis_size(mesh, axes[0]), axis_size(mesh, axes[1])
    x = _mesh_signal((n // r, n // c, n), dtype, mesh)
    pairs = [(cfg, lambda b, cfg=cfg: pfft3_pencil(
        b, mesh, axes, config=cfg, pad_len=pad_len)) for cfg in configs]
    return _agreed_times(_warmed(pairs, x), x, rounds, mesh, axes, events)


def tune_pfft3(n: int, mesh=None,
               axis_names: Sequence[str] = ("fft_r", "fft_c"), *,
               mode: str = "estimate", pad: str = "none",
               pad_len: int | None = None,
               params: CostParams | None = None, top_k: int = 3,
               panels: Sequence[int] | None = None, dtype=np.complex64,
               reps: int = 3, measure_retries: int = 0, device=None
               ) -> tuple[PlanConfig, tuple[str, str] | None, dict]:
    """Pick the best (config, pencil orientation) for the 3-D transform.

    Returns ``(config, axes, info)`` where ``axes`` is the winning
    ``(row_axis, col_axis)`` orientation of ``pfft3_pencil`` on a mesh —
    on a rectangular r x c mesh the first exchange crosses the *column*
    axis, so swapping which mesh axis plays row changes which round moves
    which fraction of the cube.  Both orientations enter the estimate
    ranking (priced via ``estimate_pfft3_cost`` with the hosts of the
    orientation's row axis), a host-major axis adds the hierarchical
    exchange as a config dimension, and measure mode races the distinct
    finalists of each orientation through the full pencil pipeline
    (``measure_pfft3_configs``), each time the slowest rank's, so every
    rank picks alike.  A 1-rank mesh falls back to the estimate
    (``info["measure_fallback"]``).  ``measure_retries`` retries a failed
    measurement (on a mesh, agreed over its ranks: ``_agreed_measure``),
    then falls back to the estimate ranking (``info["measure_fallback"]``)
    or, for the comm sample alone, records ``comm_sample_error``; 0 raises
    the first failure.  ``panels`` defaults to ``pfft3_panel_space`` of
    the mesh.

    ``mesh=None`` is the single-device problem (``axes=None``): on one
    device every ``pipeline_panels`` runs the same program, so the pot
    holds k = 1 alone.  The ranking prices each candidate with
    ``estimate_pfft3_cost`` at r = c = 1; measure mode times the
    finalists' ``pfft3_lb(m, 1, config=c)`` on ``device`` (wall time
    between two synchronizations, the CUDA-event time beside it).

    After a measured run ``info["pfft3"]`` carries ``local_pass_s`` (one
    local pass of the winner) and ``comm_time_meas_s = total − 3·pass``
    (clamped at 0): both exchange rounds on a mesh, the rotations on one
    device.  The candidate pot is ``candidate_configs``' (no ``radix=4``
    where N is a power of two above ``MAX_LARGE_N``), batched and unfused.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    if mesh is not None:
        return _tune_pfft3_mesh(n, mesh, tuple(axis_names), mode=mode,
                                pad=pad, pad_len=pad_len, params=params,
                                top_k=top_k, panels=panels, dtype=dtype,
                                reps=reps, measure_retries=measure_retries)
    r = c = 1
    params = _params_for(params, device)
    from repro_torch.plan.cost import estimate_pfft3_cost

    # ``batched`` shapes segment dispatch (one whole-cube segment here)
    # and the 3-D pipeline is unfused by construction — both knobs would
    # only burn finalist slots on identical or invalid programs.
    cands = [cfg for cfg in candidate_configs(n, pad=pad, d=None)
             if cfg.batched and not cfg.fused]
    ranked = sorted(((cfg, estimate_pfft3_cost(cfg, n=n, r=r, c=c,
                                               params=params,
                                               pad_len=pad_len))
                     for cfg in cands), key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), None, float(t)) for cfg, t in ranked],
        "pfft3": {"r": r, "c": c, "hosts": 1, "axis_names": None,
                  "comm_bytes": 0.0, "comm_time_est_s": 0.0},
        "orientation": None,
    }
    if mode == "estimate":
        return ranked[0][0], None, info

    # One finalist per distinct program.
    finalists, seen = [], set()
    for cfg, _ in ranked:
        key = _behavior_key(cfg, n, None, None)
        if key not in seen:
            seen.add(key)
            finalists.append(cfg)
        if len(finalists) >= max(top_k, 1):
            break

    from repro_torch.core.pfft3d import pfft3_lb  # lazy: core imports plan
    events: dict = {}

    def run_races() -> dict:
        x = _signal((n, n, n), dtype, device)
        pairs = _warmed([(cfg, lambda m, c=cfg: pfft3_lb(m, 1, config=c))
                         for cfg in finalists], x)
        return _timed_min(pairs, x, reps, events)

    measured = _measure_with_retry(
        run_races, measure_retries, fallback=_noted(
            info, "measure_fallback", f"measurement failed after {measure_retries} retries: "))
    if measured is None:
        return ranked[0][0], None, info
    winner = min(measured, key=measured.get)
    info["measured"] = [(cfg.to_dict(), None, float(t))
                        for cfg, t in measured.items()]
    if events:
        info["measured_event_s"] = [(cfg.to_dict(), None, float(events[cfg]))
                                    for cfg in measured]
    info["time_s"] = float(measured[winner])
    local_s = _measure_with_retry(
        lambda: _measure_pfft3_local_pass(winner, n,
                                          _pass_length(n, winner, pad_len),
                                          dtype, reps, device),
        measure_retries,
        fallback=_noted(info["pfft3"], "comm_sample_error"))
    if local_s is None:
        return winner, None, info
    info["pfft3"]["local_pass_s"] = float(local_s)
    info["pfft3"]["comm_time_meas_s"] = float(
        max(measured[winner] - 3.0 * local_s, 0.0))
    info["pfft3"]["exchange"] = winner.exchange
    return winner, None, info


def _tune_pfft3_mesh(n: int, mesh, axes0: tuple[str, str], *, mode: str,
                     pad: str, pad_len: int | None,
                     params: CostParams | None, top_k: int,
                     panels: Sequence[int] | None, dtype, reps: int,
                     measure_retries: int = 0
                     ) -> tuple[PlanConfig, tuple[str, str], dict]:
    """``tune_pfft3`` on a pencil mesh (its docstring)."""
    from repro_torch.launch.mesh import axis_size, mesh_host_shape  # lazy
    from repro_torch.plan.cost import estimate_pfft3_cost, pfft3_comm_bytes

    r, c = axis_size(mesh, axes0[0]), axis_size(mesh, axes0[1])
    if n % r or n % c:
        raise ValueError(f"N={n} must be divisible by both mesh axes "
                         f"({axes0[0]}={r}, {axes0[1]}={c})")
    if panels is None:
        panels = pfft3_panel_space(n, r, c)
    params = _mesh_params(params, mesh)
    comm_bytes = pfft3_comm_bytes(n, c) + pfft3_comm_bytes(n, r)
    host_shapes = {a: mesh_host_shape(mesh, a) for a in axes0}

    # ``batched`` shapes segment dispatch (one whole-pencil segment here)
    # and the pencil pipeline is unfused by construction — both knobs
    # would only burn finalist slots on identical or invalid programs.
    cands = [cfg for cfg in candidate_configs(n, pad=pad, d=None,
                                              panels=panels)
             if cfg.batched and not cfg.fused]
    if any(h > 1 and l > 1 for h, l in host_shapes.values()):
        # Some orientation puts a host-major axis under the row exchange:
        # race the hierarchical form as its own config dimension.
        cands += [dataclasses.replace(cfg, exchange="hier")
                  for cfg in cands if not cfg.real]
    # Which mesh axis plays "row"; on a square mesh the transposed program
    # is the same.
    orientations = [axes0, (axes0[1], axes0[0])] if r != c else [axes0]

    def est(cfg: PlanConfig, waxes: tuple[str, str]) -> float:
        # Hosts ride the orientation's row axis (the only exchange the
        # hierarchical form applies to); a non-host-major row axis prices
        # — and runs — as flat.
        return estimate_pfft3_cost(
            cfg, n=n, r=axis_size(mesh, waxes[0]), c=axis_size(mesh, waxes[1]),
            params=params, pad_len=pad_len, hosts=host_shapes[waxes[0]][0])

    ranked = sorted(((cfg, waxes, est(cfg, waxes))
                     for cfg in cands for waxes in orientations),
                    key=lambda kv: kv[2])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), list(waxes), float(t))
                   for cfg, waxes, t in ranked],
        "pfft3": {
            "r": r, "c": c,
            "hosts": int(host_shapes[axes0[0]][0]),
            "axis_names": list(axes0),
            "comm_bytes": float(comm_bytes),
            "comm_time_est_s": float(
                sum(comm_phase_time(b, params.interconnect_bytes_per_s,
                                    params.comm_latency_s)
                    for b in (pfft3_comm_bytes(n, c),
                              pfft3_comm_bytes(n, r)))),
        },
    }
    if mode == "measure" and r * c <= 1:
        info["measure_fallback"] = "1-device mesh: measure == estimate"
    if mode == "estimate" or r * c <= 1:
        cfg, waxes, _ = ranked[0]
        info["orientation"] = list(waxes)
        return cfg, waxes, info

    # One finalist per distinct *pencil* program: the single-device
    # behavior key, the panel count and the orientation (which round
    # crosses which communicator).
    finalists, seen = [], set()
    for cfg, waxes, _ in ranked:
        key = (_behavior_key(cfg, n, None, None), cfg.pipeline_panels, waxes)
        if key not in seen:
            seen.add(key)
            finalists.append((cfg, waxes))
        if len(finalists) >= max(top_k, 1):
            break
    def run_races() -> tuple[dict, dict]:
        measured, device_s = {}, {}
        for waxes in orientations:
            group = [cfg for cfg, wa in finalists if wa == waxes]
            if not group:
                continue
            events: dict = {}
            times = measure_pfft3_configs(group, n, mesh, waxes,
                                          pad_len=pad_len, dtype=dtype,
                                          rounds=reps, events=events)
            for cfg, t in times.items():
                measured[(cfg, waxes)] = t
                if cfg in events:
                    device_s[(cfg, waxes)] = events[cfg]
        return measured, device_s

    races = _agreed_measure(
        run_races, measure_retries, mesh, axes0, fallback=_noted(
            info, "measure_fallback", f"measurement failed after {measure_retries} retries: "))
    if races is None:
        cfg, waxes, _ = ranked[0]
        info["orientation"] = list(waxes)
        return cfg, waxes, info
    measured, device_s = races
    wcfg, waxes = min(measured, key=measured.get)
    info["measured"] = [(cfg.to_dict(), list(wa), float(t))
                        for (cfg, wa), t in measured.items()]
    if device_s:
        info["measured_event_s"] = [(cfg.to_dict(), list(wa), float(t))
                                    for (cfg, wa), t in device_s.items()]
    info["time_s"] = float(measured[(wcfg, waxes)])
    info["orientation"] = list(waxes)

    # Comm sample: end-to-end minus the three measured local passes of the
    # winning program, clamped at 0 (pipelined panels can hide comm).
    eff_len = pad_len
    if eff_len is None:
        from repro_torch.core.pfft_dist import default_dist_pad_len  # lazy
        eff_len = default_dist_pad_len(n, wcfg.dist_padded)
    local_s = _agreed_measure(
        lambda: _measure_local_phase(wcfg, n, (n // r) * (n // c),
                                     eff_len, dtype, reps, mesh, axes0),
        measure_retries, mesh, axes0,
        fallback=_noted(info["pfft3"], "comm_sample_error"))
    if local_s is None:
        return wcfg, waxes, info
    info["pfft3"]["local_pass_s"] = float(local_s)
    info["pfft3"]["comm_time_meas_s"] = float(
        max(measured[(wcfg, waxes)] - 3.0 * local_s, 0.0))
    info["pfft3"]["exchange"] = wcfg.exchange
    return wcfg, waxes, info


def tune_pfft1_large(n: int, *, n1: int | None = None, n2: int | None = None,
                     mode: str = "estimate",
                     params: CostParams | None = None, top_k: int = 3,
                     dtype=np.complex64, reps: int = 3, device=None
                     ) -> tuple[PlanConfig, dict]:
    """Tune the four-step huge-1-D transform; returns (config, info).

    The four-step decomposition runs two row-FFT phases at lengths n2 and
    n1 (``core.pfft_large``), so the estimate prices each phase at its
    own length with the config's backend multiplier — a radix kernel that
    helps the pow2 side may be a library no-op on the other.  ``radix=4``
    is offered only where the complex row FFT takes both phase lengths (a
    power of two above ``MAX_LARGE_N`` would raise ``KernelLengthError``);
    each factor of a power-of-two n up to 2^56 does.  Measure
    mode times the production ``pfft1_large_apply`` end to end on
    ``device``, with each candidate's twiddle table made once, outside the
    timed runs, as a plan makes it.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    from repro_torch.core.pfft_large import four_step_factors  # lazy

    n1, n2 = four_step_factors(n, n1=n1, n2=n2)
    params = _params_for(params, device)

    radices: list[int | None] = [None]
    if _is_pow2(n1) or _is_pow2(n2):
        radices.append(2)
        if _kernel_takes(n1) and _kernel_takes(n2):
            radices.append(4)
    cands = [PlanConfig(radix=rad) for rad in radices]

    def est(cfg: PlanConfig) -> float:
        compute = (
            float(fft_flops(n1, n2)) / params.nominal_flops
            * _compute_multiplier(cfg, n2, params)
            + float(fft_flops(n2, n1)) / params.nominal_flops
            * _compute_multiplier(cfg, n1, params))
        itemsize = np.dtype(dtype).itemsize
        traffic = 4.0 * n * itemsize / params.hbm_bytes_per_s
        return compute + traffic + 2.0 * params.dispatch_overhead_s

    ranked = sorted(((cfg, est(cfg)) for cfg in cands), key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), float(t)) for cfg, t in ranked],
        "four_step": {"n1": int(n1), "n2": int(n2)},
    }
    if mode == "estimate":
        return ranked[0][0], info

    from repro_torch.core.pfft_large import pfft1_large_apply, twiddle_table

    finalists, seen = [], set()
    for cfg, _ in ranked:
        key = (_length_backend(cfg, n1), _length_backend(cfg, n2))
        if key not in seen:
            seen.add(key)
            finalists.append(cfg)
        if len(finalists) >= max(top_k, 1):
            break
    x = _signal((n,), dtype, device)
    tw = twiddle_table(n1, n2, x.device)
    pairs = _warmed([(cfg, lambda v, c=cfg: pfft1_large_apply(
        v, config=c, n1=n1, n2=n2, twiddle=tw)) for cfg in finalists], x)
    events: dict = {}
    measured = _timed_min(pairs, x, reps, events)
    winner = min(measured, key=measured.get)
    _measured_info(info, measured, events, PlanConfig.to_dict)
    info["time_s"] = float(measured[winner])
    return winner, info


# ------------------------------------------------------------- distributed
#
# The distributed tuners plan for ``core.pfft_dist`` on a ``DeviceMesh``:
# every rank of the mesh calls them alike (SPMD), measures on its own
# device, and ranks the times agreed over the axis (each item's slowest
# rank, ``launch.mesh.max_over_axis``), so every rank picks the same
# program and meets the others at the same collectives.  The shuffled
# visiting order of ``_timed_min`` is seeded, hence the same on every rank.
# A failed measurement is retried, or given up for a fallback, on every
# rank together (``_agreed_measure``).

def dist_panel_space(n: int, p: int, max_panels: int = 8) -> tuple[int, ...]:
    """Candidate ``pipeline_panels`` for an n x n problem on p devices:
    the powers of two up to ``max_panels`` that divide the local row count
    (``pfft2_distributed`` requires k | N/p).  The one home of the rule —
    the tuner and ``plan_pfft(mesh=...)`` enumerate (and digest) the same
    space."""
    if p <= 0 or n % p:
        return (1,)
    n_loc = n // p
    ks = [k for k in (1, 2, 4, 8) if k <= max_panels and n_loc % k == 0]
    return tuple(ks) or (1,)


def _agreed_times(pairs, x: torch.Tensor, rounds: int, mesh, axis_name,
                  events: dict | None = None) -> dict:
    """``_timed_min`` on this rank, then each item's time the maximum over
    the ranks of the axis, or of the whole mesh for a sequence of axis
    names (and so the CUDA-event times in ``events``)."""
    from repro_torch.launch.mesh import max_over_axis  # lazy: launch is thin
    local_events: dict = {}
    times = _timed_min(pairs, x, rounds, local_events)
    items = list(times)
    agreed = dict(zip(items, max_over_axis([times[i] for i in items], mesh,
                                           axis_name)))
    if events is not None and local_events:
        events.update(zip(items, max_over_axis(
            [local_events[i] for i in items], mesh, axis_name)))
    return agreed


def _mesh_signal(shape: tuple[int, ...], dtype, mesh) -> torch.Tensor:
    """``_signal`` on the device of this rank of ``mesh``: every rank holds
    the same seeded block (the times do not depend on the values)."""
    from repro_torch.launch.mesh import mesh_device  # lazy: launch is thin
    return _signal(shape, dtype, mesh_device(mesh))


def _measure_local_phase(cfg: PlanConfig, n: int, rows: int, pad_len: int,
                         dtype, rounds: int, mesh, axis_name) -> float:
    """Seconds of one *local* phase limb of the distributed pipeline: the
    row-FFT program one rank runs on its ``rows`` rows — its (N/p, N) block
    in 2-D, its (N/r · N/c, N) pencil in 3-D — without the exchange, the
    slowest rank's over ``axis_name`` (the whole mesh for a sequence of
    names).  Subtracting one per phase (two in 2-D, three passes of the
    pencil) from the end-to-end time is what turns a distributed
    measurement into a *comm* sample."""
    from repro_torch.core.pfft_dist import _local_fft  # lazy: core imports plan

    x = _mesh_signal((max(rows, 1), n), dtype, mesh)
    pairs = _warmed([(cfg, lambda b: _local_fft(
        b, n, padded=cfg.dist_padded, pad_len=pad_len, config=cfg,
        backend=None))], x)
    return min(_agreed_times(pairs, x, rounds, mesh, axis_name).values())


def _measure_tier_exchange(mesh, axis_name: str, n: int, hosts: int,
                           local: int, tier: str, dtype,
                           rounds: int) -> float:
    """Seconds of ONE grouped exchange over only ``tier``'s groups (the
    intra-host stage or the inter-host stage of the hierarchical exchange)
    of the row-spread N x N matrix, so the sample's byte count is the
    per-exchange tier volume ``dist_comm_bytes(..., hosts=,
    exchange="hier")`` predicts — what ``plan/calibrate.py`` fits the two
    comm tiers from."""
    from repro_torch.core.pfft_dist import _pack, _send_recv  # lazy
    from repro_torch.launch.mesh import hier_process_groups

    intra, inter = hier_process_groups(mesh, axis_name)
    group, size = (intra, local) if tier == "intra" else (inter, hosts)
    x = _mesh_signal((n // (hosts * local), n), dtype, mesh)
    pairs = _warmed([(tier, lambda b: _send_recv(_pack(b, size), group).wait())],
                    x)
    return min(_agreed_times(pairs, x, rounds, mesh, axis_name).values())


def measure_dist_configs(configs: Sequence[PlanConfig | SegmentSchedule],
                         n: int, mesh, axis_name: str = "fft", *,
                         pad_len: int | None = None, dtype=np.complex64,
                         rounds: int = 3, events: dict | None = None
                         ) -> dict[PlanConfig | SegmentSchedule, float]:
    """End-to-end seconds of ``pfft2_distributed`` per config on ``mesh``.

    Unlike ``measure_configs`` (the single-device limb), this times the
    full pipeline — both exchanges, pipelined panels, fused local phases
    — on the caller's mesh, with the shuffled-interleaved per-config-min
    harness (``_timed_min``) and each time the slowest rank's.  Items may
    be ``PlanConfig``s or ``SegmentSchedule``s (a schedule runs at its own
    entry lengths, so ``pad_len`` applies only to bare configs).
    ``events`` receives the CUDA-event times.
    """
    from repro_torch.core.pfft_dist import pfft2_distributed  # lazy
    from repro_torch.launch.mesh import axis_size

    x = _mesh_signal((n // axis_size(mesh, axis_name), n), dtype, mesh)
    pairs = []
    for item in configs:
        kw = ({"schedule": item} if isinstance(item, SegmentSchedule)
              else {"config": item, "pad_len": pad_len})
        pairs.append((item, lambda b, kw=kw: pfft2_distributed(
            b, mesh, axis_name, **kw)))
    return _agreed_times(_warmed(pairs, x), x, rounds, mesh, axis_name,
                         events)


def _mesh_params(params: CostParams | None, mesh) -> CostParams:
    """``params``, or the constants of the mesh's device type."""
    return params if params is not None else CostParams.for_backend(
        mesh.device_type)


def tune_dist_config(n: int, mesh, axis_name: str = "fft", *,
                     mode: str = "estimate", pad: str = "none",
                     pad_len: int | None = None, fpms: FPMSet | None = None,
                     params: CostParams | None = None, top_k: int = 3,
                     panels: Sequence[int] | None = None,
                     dtype=np.complex64, reps: int = 3,
                     measure_retries: int = 0
                     ) -> tuple[PlanConfig, dict]:
    """Pick the best ``PlanConfig`` for ``pfft2_distributed`` on ``mesh``.

    The distributed sibling of ``tune_config``: candidates are ranked with
    the comm term filled in from the mesh (``dist_comm_bytes``, the
    two-tier ``dist_comm_time`` on a host-major axis), and
    ``mode="measure"`` races the ``top_k`` distinct finalists through the
    *full* pipeline on the mesh (``measure_dist_configs``).  On a 1-rank
    mesh measure falls back to estimate (there is no interconnect to
    measure) and ``info["measure_fallback"]`` says so.

    ``info["dist"]`` carries the topology facts and, after a measured run,
    the comm sample: ``comm_time_meas_s = total − 2·local_phase`` (clamped
    at 0), the number ``plan/calibrate.py`` fits the interconnect from,
    and on a host-major axis one sample per tier.

    ``measure_retries`` retries a failed measurement, agreed over the
    axis's ranks (``_agreed_measure``): when the budget is spent, every
    rank serves the estimate ranking (``info["measure_fallback"]``), or
    keeps its measured winner and records the lost comm/tier sample
    (``comm_sample_error``, ``tier_sample_error``).  0 raises the first
    failure.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    from repro_torch.launch.mesh import axis_size, mesh_host_shape  # lazy

    p = axis_size(mesh, axis_name)
    if n % p:
        raise ValueError(f"N={n} must be divisible by mesh axis "
                         f"{axis_name}={p}")
    if panels is None:
        panels = dist_panel_space(n, p)
    params = _mesh_params(params, mesh)
    comm_bytes = dist_comm_bytes(n, p)
    hosts, local = mesh_host_shape(mesh, axis_name)

    # ``batched`` shapes the segment dispatch plan; the dist pipeline has
    # one whole-block segment per rank, so the knob would only burn
    # finalist slots on identical programs.
    cands = [c for c in candidate_configs(n, pad=pad, d=None, panels=panels)
             if c.batched]
    if hosts > 1 and local > 1:
        # Host-major axis: the hierarchical exchange is a real program
        # alternative — race it as its own config dimension.
        cands += [dataclasses.replace(c, exchange="hier")
                  for c in cands if not c.real]
    ranked = sorted(
        ((cfg, estimate_cost(
            cfg, n=n, fpms=fpms, params=params, comm_bytes=comm_bytes,
            comm_time_s=dist_comm_time(n, p, params=params, hosts=hosts,
                                       exchange=cfg.exchange)))
         for cfg in cands),
        key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), float(c)) for cfg, c in ranked],
        "dist": {
            "devices": p,
            "hosts": int(hosts),
            "axis_name": axis_name,
            "comm_bytes": float(comm_bytes),
            # Both phases, like the measured sample it is judged against.
            "comm_time_est_s": float(2.0 * comm_phase_time(
                comm_bytes, params.interconnect_bytes_per_s,
                params.comm_latency_s)),
        },
    }

    if mode == "estimate":
        return ranked[0][0], info
    if p <= 1:
        # Nothing distributed to time: the 1-rank exchange is a local copy
        # and an end-to-end race would just re-measure the limb.
        info["measure_fallback"] = "1-device mesh: measure == estimate"
        return ranked[0][0], info

    # One finalist per distinct *distributed* program: the single-device
    # behavior key plus the panel count.
    finalists, seen = [], set()
    for cfg, _ in ranked:
        key = (_behavior_key(cfg, n, None, None), cfg.pipeline_panels)
        if key not in seen:
            seen.add(key)
            finalists.append(cfg)
        if len(finalists) >= max(top_k, 1):
            break
    events: dict = {}
    measured = _agreed_measure(
        lambda: measure_dist_configs(finalists, n, mesh, axis_name,
                                     pad_len=pad_len, dtype=dtype,
                                     rounds=reps, events=events),
        measure_retries, mesh, axis_name, fallback=_noted(
            info, "measure_fallback", f"measurement failed after {measure_retries} retries: "))
    if measured is None:
        # Retries spent on every rank alike: serve the estimate ranking
        # (the self-healing re-planner must always get a plan).
        return ranked[0][0], info
    winner = min(measured, key=measured.get)
    _measured_info(info, measured, events, PlanConfig.to_dict)
    info["time_s"] = float(measured[winner])

    # Comm sample: end-to-end minus the two measured local phases of the
    # winning config, clamped at 0 (pipelined panels can hide comm).
    eff_len = pad_len
    if eff_len is None:
        from repro_torch.core.pfft_dist import default_dist_pad_len  # lazy
        eff_len = default_dist_pad_len(n, winner.dist_padded)
    local_s = _agreed_measure(
        lambda: _measure_local_phase(winner, n, n // p, eff_len, dtype,
                                     reps, mesh, axis_name),
        measure_retries, mesh, axis_name,
        fallback=_noted(info["dist"], "comm_sample_error"))
    if local_s is None:
        # The winner stands; only the comm sample is lost this round.
        return winner, info
    info["dist"]["local_phase_s"] = float(local_s)
    info["dist"]["comm_time_meas_s"] = float(
        max(measured[winner] - 2.0 * local_s, 0.0))
    info["dist"]["exchange"] = winner.exchange
    if hosts > 1 and local > 1:
        # Per-tier samples, so calibrate can fit the intra- and inter-host
        # comm params separately; ``msgs`` is the slow-tier message count
        # of the timed exchange (the latency multiplier).
        tiers = dist_comm_bytes(n, p, hosts=hosts, exchange="hier")
        samples = []
        for tier, tier_bytes, msgs in (("intra", tiers.intra, 1),
                                       ("inter", tiers.inter, hosts - 1)):
            if not tier_bytes:
                continue
            t = _agreed_measure(
                lambda tier=tier: _measure_tier_exchange(
                    mesh, axis_name, n, hosts, local, tier, dtype, reps),
                measure_retries, mesh, axis_name,
                fallback=_noted(info["dist"], "tier_sample_error"))
            if t is None:
                break
            samples.append({"tier": tier, "bytes": float(tier_bytes),
                            "msgs": int(msgs), "time_s": float(t)})
        if samples:
            info["dist"]["comm_samples"] = samples
    return winner, info


def measure_rfft_dist_configs(configs: Sequence[PlanConfig], n: int, mesh,
                              axis_name: str = "fft", *,
                              pad_len: int | None = None, dtype=np.float32,
                              rounds: int = 3, events: dict | None = None
                              ) -> dict[PlanConfig, float]:
    """End-to-end seconds of the distributed half-spectrum transform per
    config: ``real`` configs run ``rpfft2_distributed`` (half-width
    panels), complex fallbacks the upcast ``pfft2_distributed`` cropped to
    the half spectrum — same deliverable on the same mesh, same harness as
    ``measure_dist_configs``."""
    from repro_torch.core.pfft_dist import (pfft2_distributed,  # lazy
                                            rpfft2_distributed)
    from repro_torch.launch.mesh import axis_size

    dt = _require_real_dtype(dtype)
    ctype = torch.complex64 if dt == np.dtype(np.float32) else torch.complex128
    nh = n // 2 + 1
    x = _mesh_signal((n // axis_size(mesh, axis_name), n), dt, mesh)
    pairs = []
    for cfg in configs:
        if cfg.real:
            fn = (lambda b, c=cfg: rpfft2_distributed(
                b, mesh, axis_name, config=c, pad_len=pad_len))
        else:
            fn = (lambda b, c=cfg: pfft2_distributed(
                b.to(ctype), mesh, axis_name, config=c,
                pad_len=pad_len)[:, :nh])
        pairs.append((cfg, fn))
    return _agreed_times(_warmed(pairs, x), x, rounds, mesh, axis_name,
                         events)


def _measure_local_real_phases(cfg: PlanConfig, n: int, p: int, pad_len: int,
                               dtype, rounds: int, mesh,
                               axis_name: str) -> float:
    """Combined seconds of the real pipeline's two *local* phase programs
    (rfft on the (N/p, N) row block + complex FFT on the (hc/p, N)
    spectral block) — the subtraction term that turns an end-to-end real
    measurement into a comm sample, mirroring ``_measure_local_phase``."""
    from repro_torch.core.pfft import _group_row_ffts, _group_row_rffts  # lazy
    from repro_torch.plan.cost import halfspec_cols

    dt = _require_real_dtype(dtype)
    ctype = np.complex64 if dt == np.dtype(np.float32) else np.complex128
    hc = halfspec_cols(n, p)
    x1 = _mesh_signal((max(n // p, 1), n), dt, mesh)
    x2 = _mesh_signal((max(hc // p, 1), n), ctype, mesh)
    length = pad_len if cfg.pad == "fpm" else n
    p1 = _warmed([(cfg, lambda b: _group_row_rffts(b, length, n, cfg, None))],
                 x1)
    p2 = _warmed([(cfg, lambda b: _group_row_ffts(b, length, n, cfg, None))],
                 x2)
    t1 = min(_agreed_times(p1, x1, rounds, mesh, axis_name).values())
    t2 = min(_agreed_times(p2, x2, rounds, mesh, axis_name).values())
    return t1 + t2


def tune_rfft_dist(n: int, mesh, axis_name: str = "fft", *,
                   mode: str = "estimate", pad: str = "none",
                   pad_len: int | None = None, fpms: FPMSet | None = None,
                   params: CostParams | None = None, top_k: int = 3,
                   panels: Sequence[int] | None = None, dtype=np.float32,
                   reps: int = 3, measure_retries: int = 0
                   ) -> tuple[SegmentSchedule, dict]:
    """Tune the distributed real-input transform on ``mesh``.

    Real candidates are priced with the *half-spectrum* comm term
    (``dist_comm_bytes(real=True)``) and their complex twins with the
    full-panel term; measure mode races both families end to end through
    their distributed programs.  The real program is homogeneous, unfused
    and monolithic (``rpfft2_distributed``), so real candidates enumerate
    only the row-FFT backend; complex fallbacks keep the panel/fused
    space.  ``info["dist"]`` carries both byte counts, their ratio and
    (measured) the winner's comm sample.  ``measure_retries`` as in
    ``tune_dist_config``.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    _require_real_dtype(dtype)
    if pad == "czt":
        raise ValueError("the real pipeline has no Bluestein form")
    from repro_torch.launch.mesh import axis_size  # lazy: launch is thin

    p = axis_size(mesh, axis_name)
    if n % p:
        raise ValueError(f"N={n} must be divisible by mesh axis "
                         f"{axis_name}={p}")
    if panels is None:
        panels = dist_panel_space(n, p)
    params = _mesh_params(params, mesh)
    comm_complex = dist_comm_bytes(n, p)
    comm_real = dist_comm_bytes(n, p, real=True)

    complex_cands = [c for c in candidate_configs(n, pad=pad, d=None,
                                                  panels=panels) if c.batched]
    real_cands = [c for c in _real_candidates(complex_cands, [n, pad_len or n])
                  if not c.fused and c.pipeline_panels == 1]
    ranked = sorted(
        ((cfg, estimate_cost(cfg, n=n, fpms=fpms, params=params,
                             comm_bytes=comm_real if cfg.real
                             else comm_complex))
         for cfg in real_cands + complex_cands),
        key=lambda kv: kv[1])
    info: dict = {
        "mode": mode,
        "ranked": [(cfg.to_dict(), float(c)) for cfg, c in ranked],
        "dist": {
            "devices": p,
            "axis_name": axis_name,
            "comm_bytes_complex": float(comm_complex),
            "comm_bytes_real": float(comm_real),
            "comm_ratio_real": (float(comm_real / comm_complex)
                                if comm_complex else 0.0),
        },
    }

    def finish(winner: PlanConfig) -> tuple[SegmentSchedule, dict]:
        info["chosen_path"] = "real" if winner.real else "complex"
        info["dist"]["comm_bytes"] = float(comm_real if winner.real
                                           else comm_complex)
        d = np.full(p, n // p, dtype=np.int64) if p > 0 else None
        schedule = SegmentSchedule.homogeneous(winner, n, d)
        info["schedule"] = schedule.to_dict()
        return schedule, info

    if mode == "estimate":
        return finish(ranked[0][0])
    if p <= 1:
        info["measure_fallback"] = "1-device mesh: measure == estimate"
        return finish(ranked[0][0])

    finalists = _family_finalists(ranked, n, None, None, top_k)
    events: dict = {}
    measured = _agreed_measure(
        lambda: measure_rfft_dist_configs(finalists, n, mesh, axis_name,
                                          pad_len=pad_len, dtype=dtype,
                                          rounds=reps, events=events),
        measure_retries, mesh, axis_name, fallback=_noted(
            info, "measure_fallback", f"measurement failed after {measure_retries} retries: "))
    if measured is None:
        return finish(ranked[0][0])
    winner = min(measured, key=measured.get)
    _measured_info(info, measured, events, PlanConfig.to_dict)
    info["time_s"] = float(measured[winner])

    eff_len = pad_len
    if eff_len is None:
        from repro_torch.core.pfft_dist import default_dist_pad_len  # lazy
        eff_len = default_dist_pad_len(n, winner.dist_padded)
    ctype = (np.complex64 if np.dtype(dtype) == np.dtype(np.float32)
             else np.complex128)
    local_s = _agreed_measure(
        lambda: (_measure_local_real_phases(winner, n, p, eff_len, dtype,
                                            reps, mesh, axis_name)
                 if winner.real else
                 2.0 * _measure_local_phase(winner, n, n // p, eff_len,
                                            ctype, reps, mesh, axis_name)),
        measure_retries, mesh, axis_name,
        fallback=_noted(info["dist"], "comm_sample_error"))
    if local_s is None:
        return finish(winner)
    info["dist"]["local_phase_s"] = float(local_s)
    info["dist"]["comm_time_meas_s"] = float(
        max(measured[winner] - local_s, 0.0))
    return finish(winner)


def grouped_dist_schedule(n: int, p: int, *, pad_lengths=None,
                          fpms: FPMSet | None = None, pad: str = "none",
                          params: CostParams | None = None
                          ) -> SegmentSchedule | None:
    """The model-driven heterogeneous candidate for a p-rank mesh.

    One entry per rank (N/p rows — the SPMD shard), each assigned the
    ``segment_candidate_configs`` argmin of *its own* predicted time: its
    FPM's ``time_at`` (or the nominal flop rate) at its own declared
    effective length, times the candidate's backend multiplier.  Returns
    ``None`` when the assembly degenerates to a single config or p <= 1;
    the caller prices the survivor with ``estimate_grouped_cost``.
    ``params`` defaults to the CUDA constants, as every entry point's.
    """
    if p <= 1 or n % p:
        return None
    if params is None:
        params = CostParams.for_backend()
    if fpms is not None and fpms.p != p:
        fpms = None  # one abstract processor per rank or no FPM at all
    n_loc = n // p
    d = np.full(p, n_loc, dtype=np.int64)

    def seg_time(i: int, cfg: PlanConfig, length: int) -> float:
        if fpms is not None:
            t = fpms[i].time_at(n_loc, length)
        else:
            t = float(fft_flops(n_loc, length)) / params.nominal_flops
        return t * _compute_multiplier(cfg, length, params)

    cfgs = []
    for i in range(p):
        length = n
        if pad_lengths is not None and int(pad_lengths[i]) > n:
            length = int(pad_lengths[i])
        cands = segment_candidate_configs(length, pad=pad)
        cfgs.append(min(cands, key=lambda c: seg_time(i, c, length)))
    schedule = SegmentSchedule.from_parts(n, d, pad_lengths, cfgs)
    return schedule if len(schedule.configs) > 1 else None


def tune_dist_schedule(n: int, mesh, axis_name: str = "fft", *,
                       pad_lengths=None, mode: str = "estimate",
                       pad: str = "none", pad_len: int | None = None,
                       fpms: FPMSet | None = None,
                       params: CostParams | None = None, top_k: int = 3,
                       panels: Sequence[int] | None = None,
                       dtype=np.complex64, reps: int = 3,
                       measure_retries: int = 0
                       ) -> tuple[SegmentSchedule, dict]:
    """Schedule-shaped distributed tuner; returns (schedule, info).

    The homogeneous candidate space is ``tune_dist_config``'s.  On top of
    it the tuner grows the heterogeneous candidate of
    ``grouped_dist_schedule`` (a device-group program), priced with
    ``estimate_grouped_cost`` against the homogeneous winner;
    ``mode="measure"`` races the two end to end through the actual
    grouped ``pfft2_distributed`` program on the mesh
    (``info["grouped_measured"]``).  This is what ``plan_pfft(mesh=...)``
    resolves through.  ``measure_retries`` as in ``tune_dist_config``; a
    grouped race whose retries are spent falls back to the estimate's pick
    on every rank (``info["measure_fallback"]``).
    """
    from repro_torch.launch.mesh import axis_size  # lazy: launch is thin

    p = axis_size(mesh, axis_name)
    if pad_len is None and pad_lengths is not None:
        # The schedule runs at the uniform max effective length, so the
        # homogeneous finalists are raced (and the comm sample taken) at
        # that very length.
        lengths = [int(x) for x in pad_lengths if int(x) > n]
        if lengths:
            pad_len = max(lengths)
    cfg, info = tune_dist_config(n, mesh, axis_name, mode=mode, pad=pad,
                                 pad_len=pad_len, fpms=fpms, params=params,
                                 top_k=top_k, panels=panels, dtype=dtype,
                                 reps=reps, measure_retries=measure_retries)
    params = _mesh_params(params, mesh)
    d = np.full(p, n // p, dtype=np.int64) if p > 0 else None
    homo = SegmentSchedule.homogeneous(cfg, n, d, pad_lengths)
    hetero = grouped_dist_schedule(n, p, pad_lengths=pad_lengths, fpms=fpms,
                                   pad=pad, params=params)
    if hetero is None:
        info["chosen"] = "homogeneous"
        info["schedule"] = homo.to_dict()
        return homo, info

    fpms_dev = fpms if fpms is not None and fpms.p == p else None
    comm_bytes = dist_comm_bytes(n, p)
    est_hetero = estimate_grouped_cost(hetero, fpms=fpms_dev, params=params,
                                       comm_bytes=comm_bytes)
    est_homo = estimate_grouped_cost(homo, fpms=fpms_dev, params=params,
                                     comm_bytes=comm_bytes)
    info["heterogeneous"] = {"schedule": hetero.to_dict(),
                             "est_s": float(est_hetero)}
    info["homogeneous"] = {"config": cfg.to_dict(), "est_s": float(est_homo)}

    if mode == "estimate" or "measure_fallback" in info:
        winner = hetero if est_hetero < est_homo else homo
    else:
        events: dict = {}
        raced = _agreed_measure(
            lambda: measure_dist_configs([homo, hetero], n, mesh,
                                         axis_name, dtype=dtype,
                                         rounds=reps, events=events),
            measure_retries, mesh, axis_name, fallback=_noted(
                info, "measure_fallback",
                f"grouped race failed after {measure_retries} retries: "))
        if raced is None:
            winner = hetero if est_hetero < est_homo else homo
        else:
            winner = min(raced, key=raced.get)
            info["grouped_measured"] = [(s.describe(), float(t))
                                        for s, t in raced.items()]
            if events:
                info["grouped_measured_event_s"] = [
                    (s.describe(), float(events[s])) for s in raced]
            info["time_s"] = float(raced[winner])
    info["chosen"] = ("heterogeneous" if len(winner.configs) > 1
                      else "homogeneous")
    info["schedule"] = winner.to_dict()
    return winner, info
