"""Estimate/measure tuner — FFTW's planner loop over ``PlanConfig`` space.

Counterpart of the single-device part of ``repro.plan.tune``.
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

The candidate pot never holds a configuration that cannot run: the CUDA
kernels take power-of-two rows up to ``MAX_KERNEL_N``, so ``radix=4`` is
offered only where every power-of-two effective length fits, and ``fused``
only where ``n`` does.  Up to that length the pot is the reference's,
config for config, on every device.

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
from repro_torch.kernels.fft.kernel import MAX_KERNEL_N
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.cost import (CostParams, _compute_multiplier,
                                   _segment_work, estimate_cost,
                                   estimate_schedule_cost)
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["candidate_configs", "segment_candidate_configs",
           "measure_configs", "tune_config", "tune_schedule",
           "measure_rfft_configs", "tune_rfft"]


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


def _kernel_takes(length: int) -> bool:
    """Whether the CUDA row kernels run a row of ``length``: any length
    that is not a power of two goes to the library (``fft_rows``' rule),
    a power of two up to ``MAX_KERNEL_N`` to the kernel; a longer power
    of two would raise ``KernelLengthError``."""
    return not _is_pow2(length) or length <= MAX_KERNEL_N


def _params_for(params: CostParams | None, device) -> CostParams:
    """``params``, or the constants of the device type the plan runs on."""
    if params is not None:
        return params
    return CostParams.for_backend(
        None if device is None else torch.device(device).type)


def _measure_with_retry(thunk, retries: int = 0, base_s: float = 0.05):
    """Run a measurement thunk, retrying transient failures with
    exponential backoff; re-raises after the budget is exhausted.

    ``retries=0`` (the default) raises the first failure: a measurement
    that fails is never replaced by anything else here.  The distributed
    tuners (a later slice) are its callers.
    """
    delay = float(base_s)
    for attempt in range(int(retries) + 1):
        try:
            return thunk()
        except Exception:
            if attempt >= retries:
                raise
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
    requires that the kernel takes every effective length (``n`` and each
    busy segment's ``pad_lengths`` entry); ``batched`` only matters when
    the partition has more than one non-empty segment.
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
    a power-of-two length the kernel takes.
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
            "measure mode with comm_bytes needs the mesh the bytes cross — "
            "distributed tuning comes with the distributed slice")
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
            "measure mode with comm_bytes needs the mesh the bytes cross — "
            "distributed tuning comes with the distributed slice")

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


def _real_candidates(cands: Sequence[PlanConfig]) -> list[PlanConfig]:
    """The real-flagged twins of a complex candidate list (czt dropped —
    the real pipeline has no Bluestein form)."""
    return [dataclasses.replace(c, real=True) for c in cands
            if c.pad != "czt"]


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
    cands = _real_candidates(complex_cands) + complex_cands
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
