"""Calibrate ``CostParams`` from measured wisdom entries.

Counterpart of ``repro.plan.calibrate``, with the port's backend names as
the factor columns and ``backend=None`` meaning ``"cuda"``.

The estimate cost model ships hard-coded per-backend constants
(``CostParams.for_backend``).  Once a machine has accumulated measured
wisdom — tuner measure runs, microbenchmark sweeps — those entries *are*
ground truth for this host, so the constants can be fit back from them
instead of trusted: the paper's model-over-heuristics thesis applied to
our own cost model.

``fit_cost_params`` solves the model's own per-phase equation

    time/2 = base_seconds · factor[backend] + dispatches · c_d
             + traffic_bytes · (1/BW_hbm)

as a least-squares system over the measured entries, with one unknown
per backend factor (torch / stockham / cuda / fused), the dispatch
overhead ``c_d``, and the inverse HBM bandwidth (the traffic term used
to be subtracted with the hard-coded constant; with varied measured
sizes it is identifiable, so it is now a fitted column — the ROADMAP's
``hbm_bytes_per_s`` calibration.  ``nominal_flops`` stays fixed: the
backend factors multiply it, so a flop-rate error is absorbed by them
and a separate unknown would be unidentifiable).  The symbolic factor
decomposition comes from ``cost._factor_term`` — the estimate model and
this fit share one branch logic and cannot drift.  Each entry
contributes its makespan-dominant segment's flop-time as the factor
feature (schedule entries carry exact (rows, length, config) structure;
bare-config entries assume the even LB partition — the shape the
microbenchmark warms).  With fewer than ``min_entries`` measured
entries, or when the fit degenerates (a factor column absent or a
non-positive solution), the hard-coded constants are kept
component-wise — calibration refines, never breaks.

Distributed (``topo=``) entries additionally carry measured comm
samples; the interconnect constants are fit per *tier* as the line

    time = msgs · latency + bytes · (1/BW)

Legacy end-to-end samples (``comm_bytes`` + ``comm_time_s``, two
all_to_all phases per transform, so ``time = comm_time/2, msgs = 1``)
feed the intra tier — on a single-host axis the whole exchange rides
the legacy = intra-tier constants.  Tier-tagged ``comm_samples`` from
multi-host tuning runs feed their own tier, fitting
``inter_bytes_per_s``/``inter_latency_s`` separately (the two-tier comm
model of DESIGN.md §Multi-host topology).  Per tier: two or more
samples with distinct byte counts fit both constants, one pins the
bandwidth alone, zero keeps the defaults.

File-path fits are cached per (path, mtime): ``plan_pfft(wisdom=...)``
calibrates on every tuned call, and re-running lstsq over an unchanged
store would tax the plan-once hot path for nothing.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core.fpm import fft_flops
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.cost import (_COMPLEX64_BYTES, _factor_term, CostParams,
                             phase_dispatch_count)
from repro_torch.plan.schedule import SegmentSchedule
from repro_torch.plan.wisdom import load_wisdom

__all__ = ["fit_cost_params"]

_COLS = ("dispatch", "torch", "stockham", "cuda", "fused", "hbm")
_FIT_CACHE: dict[tuple, CostParams] = {}


def _parse_key(key: str) -> dict[str, str]:
    out = {}
    for part in key.split("|"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def _entry_structure(entry: dict, n: int, p: int):
    """((rows, length, config) per segment, dispatches, fused) of one entry."""
    if "schedule" in entry:
        sched = SegmentSchedule.from_dict(entry["schedule"])
        segs = [(e.rows, e.length, e.config) for e in sched.entries]
        common = sched.common_config
        fused = common is not None and common.fused
        dispatches = 1 if fused else len(sched.batch_groups())
        return segs, dispatches, fused
    cfg = PlanConfig.from_dict(entry["config"])
    from repro_torch.core.partition import lb_partition  # lazy: core imports plan
    d = lb_partition(n, p).d
    segs = [(int(rows), n, cfg) for rows in d if rows > 0]
    dispatches = phase_dispatch_count(cfg, n, d, None)
    return segs, dispatches, cfg.fused


def _factor_feature(rows: int, length: int, cfg: PlanConfig,
                    nominal_flops: float) -> tuple[str, float]:
    """(factor column, base seconds) such that the modelled segment time
    is ``base * factor[column]`` — ``cost._factor_term`` with the flop
    time folded in."""
    name, scale = _factor_term(cfg, length)
    return name, float(fft_flops(rows, length)) / nominal_flops * scale


def _fit_tier(samples: list, latency: float, bw: float
              ) -> tuple[float, float]:
    """Fit one comm tier's ``(latency_s, bytes_per_s)`` from per-launch
    samples ``(bytes, seconds, msgs)``: the line ``t = msgs·lat + b/BW``
    (``msgs`` is the launch's slow-tier message count — 1 for an
    intra-tier or legacy flat launch, ``hosts − 1`` for the inter stage
    of a hierarchical exchange).  >= 2 samples with distinct byte counts
    fit both constants, exactly 1 fits the bandwidth with the default
    latency, non-positive solutions keep the defaults component-wise.
    """
    if not samples:
        return latency, bw
    if len({b for b, _, _ in samples}) >= 2:
        A = np.array([[m, b] for b, _, m in samples])
        y = np.array([t for _, t, _ in samples])
        try:
            x, *_ = np.linalg.lstsq(A, y, rcond=None)
        except np.linalg.LinAlgError:
            x = None
        if x is not None:
            if x[0] > 0:
                latency = float(x[0])
            if x[1] > 0:
                bw = 1.0 / float(x[1])
    else:
        b0, t0, m0 = samples[0]
        if t0 > m0 * latency:
            bw = b0 / (t0 - m0 * latency)
    return latency, bw


def _fit_comm_params(entries: dict, backend: str,
                     params: CostParams) -> CostParams:
    """Fold measured comm samples into ``params``'s interconnect constants.

    Samples are distributed wisdom entries (``topo=`` keys) carrying the
    extras ``tune_dist_config`` records, in two forms fit as two tiers
    (``_fit_tier``):

    * ``comm_bytes``/``comm_time_s`` — the legacy end-to-end sample;
      ``comm_time_s`` covers both phases, so it contributes
      ``(bytes, time/2, 1)`` to the *intra* tier (on a single-host axis
      the whole exchange rides the legacy = intra-tier constants);
    * ``comm_samples`` — tier-tagged per-launch samples from the grouped
      tier microbench (``_measure_tier_exchange``), each
      ``{tier, bytes, time_s, msgs}`` already per-exchange (no halving);
      the ``inter`` ones are what make ``inter_bytes_per_s`` /
      ``inter_latency_s`` fittable at all.
    """
    tiers: dict[str, list] = {"intra": [], "inter": []}
    for key, entry in entries.items():
        if not isinstance(entry, dict) or "|topo=" not in key:
            continue
        if _parse_key(key).get("backend") != backend:
            continue
        try:
            bytes_, t = float(entry["comm_bytes"]), float(entry["comm_time_s"])
            if bytes_ > 0 and t > 0:
                tiers["intra"].append((bytes_, t / 2.0, 1))
        except (KeyError, TypeError, ValueError):
            pass
        for s in entry.get("comm_samples") or []:
            try:
                tier = s["tier"]
                bytes_, t = float(s["bytes"]), float(s["time_s"])
                msgs = int(s.get("msgs", 1))
            except (KeyError, TypeError, ValueError):
                continue
            if tier in tiers and bytes_ > 0 and t > 0 and msgs > 0:
                tiers[tier].append((bytes_, t, msgs))
    if not tiers["intra"] and not tiers["inter"]:
        return params
    latency, bw = _fit_tier(tiers["intra"], params.comm_latency_s,
                            params.interconnect_bytes_per_s)
    inter_lat, inter_bw = _fit_tier(tiers["inter"], params.inter_latency_s,
                                    params.inter_bytes_per_s)
    return dataclasses.replace(params, comm_latency_s=latency,
                               interconnect_bytes_per_s=bw,
                               inter_latency_s=inter_lat,
                               inter_bytes_per_s=inter_bw)


def fit_cost_params(store: str | dict, *, backend: str | None = None,
                    min_entries: int = 8) -> CostParams:
    """Least-squares ``CostParams`` from a wisdom store's measured entries.

    ``store`` is a wisdom file path or the entries dict ``load_wisdom``
    returns.  Only entries measured on ``backend`` (default: ``"cuda"``)
    contribute.  Returns the fitted params, or the
    hard-coded ``CostParams.for_backend(backend)`` when fewer than
    ``min_entries`` measured entries exist; degenerate components fall
    back individually.  Interconnect constants are fit separately from
    the distributed entries' comm samples (``_fit_comm_params``) and need
    no minimum beyond their own — one dist measurement already beats the
    hard-coded bandwidth guess.
    """
    if backend is None:
        backend = "cuda"
    cache_key = None
    if isinstance(store, str):
        try:
            mtime = os.stat(store).st_mtime_ns
        except OSError:
            mtime = None
        cache_key = (os.path.abspath(store), mtime, backend, min_entries)
        if cache_key in _FIT_CACHE:
            return _FIT_CACHE[cache_key]
        entries = load_wisdom(store)
    else:
        entries = store
    defaults = CostParams.for_backend(backend)

    A_rows, b_rows = [], []
    for key, entry in entries.items():
        if not isinstance(entry, dict) or "time_s" not in entry:
            continue
        if "|topo=" in key:
            # Distributed entries time the *whole* pipeline, all_to_all
            # included; feeding them into the compute-side equation would
            # bill comm seconds to a backend factor.  They contribute
            # through _fit_comm_params instead.
            continue
        fields = _parse_key(key)
        if fields.get("backend") != backend:
            continue
        try:
            n, p = int(fields["n"]), int(fields["p"])
            segs, dispatches, fused = _entry_structure(entry, n, p)
        except (KeyError, TypeError, ValueError):
            continue  # schema drift is never an error, just not a sample
        if not segs:
            continue
        traffic_bytes = 0.0 if fused else 2.0 * n * n * _COMPLEX64_BYTES
        b = float(entry["time_s"]) / 2.0
        # Makespan-dominant segment: largest *modeled* time under the
        # default factors (a tiny segment on a slow backend can dominate
        # a large library one, so raw flop-time would credit the
        # measured seconds to the wrong backend column).  Mixed schedules
        # attribute the whole makespan to that segment's backend — an
        # approximation, exact for homogeneous entries.
        def modeled(cb):
            col, base = cb
            factor = (defaults.fused_factor if col == "fused"
                      else defaults.backend_factor[col])
            return base * factor
        col, base = max(
            (_factor_feature(rows, length, cfg, defaults.nominal_flops)
             for rows, length, cfg in segs),
            key=modeled)
        row = np.zeros(len(_COLS))
        row[0] = dispatches
        row[_COLS.index(col)] = base
        row[_COLS.index("hbm")] = traffic_bytes
        A_rows.append(row)
        b_rows.append(b)

    fitted = defaults
    if len(b_rows) >= min_entries:
        A = np.asarray(A_rows)
        b = np.asarray(b_rows)
        try:
            x, *_ = np.linalg.lstsq(A, b, rcond=None)
        except np.linalg.LinAlgError:
            x = None
        if x is not None:
            c_d = float(x[0]) if x[0] > 0 else defaults.dispatch_overhead_s
            factors = dict(defaults.backend_factor)
            for name in ("torch", "stockham", "cuda"):
                j = _COLS.index(name)
                if np.any(A[:, j] > 0) and x[j] > 0:
                    factors[name] = float(x[j])
            j = _COLS.index("fused")
            fused_factor = (float(x[j]) if np.any(A[:, j] > 0) and x[j] > 0
                            else defaults.fused_factor)
            j = _COLS.index("hbm")
            hbm = (1.0 / float(x[j]) if np.any(A[:, j] > 0) and x[j] > 0
                   else defaults.hbm_bytes_per_s)
            fitted = dataclasses.replace(defaults, dispatch_overhead_s=c_d,
                                         backend_factor=factors,
                                         fused_factor=fused_factor,
                                         hbm_bytes_per_s=hbm)
    fitted = _fit_comm_params(entries, backend, fitted)
    if cache_key is not None:
        if len(_FIT_CACHE) > 64:
            _FIT_CACHE.clear()
        _FIT_CACHE[cache_key] = fitted
    return fitted
