"""PFFT-LB / PFFT-FPM / PFFT-FPM-PAD — the paper's parallel 2-D DFT methods.

Counterpart of ``repro.core.pfft``.  Three layers:

1. **Abstract-processor versions** — faithful to the paper's Algorithms
   1/3/6/7: the N rows are split into ``p`` segments per the distribution
   ``d``; each dispatch group's row FFTs run as a *separate* FFT call (like
   the paper's per-group ``fftw_plan_many_dft`` calls), then transpose, row
   FFTs again, transpose.

2. **PFFT-FPM-PAD** — each segment's row length is padded ``N -> N_padded_i``
   chosen from that processor's FPM (paper Alg. 7).  NOTE on semantics: like
   the paper (and its fftw implementation, which sets the transform size to
   N_padded), the padded method computes the DFT *of the zero-padded signal*
   cropped back to N bins — a spectral interpolation, not the exact N-point
   DFT.  Tests validate it against exactly that oracle.

3. **PFFT-FPM-CZT (beyond paper)** — exact N-point DFT with full padding
   freedom via the Bluestein/chirp-Z identity: the N-point DFT is computed
   with FFTs of any model-chosen length m >= 2N-1.

The real-input variants (``rpfft_*``, ``_rpfft_limb``) transform a real
signal into its (N, N//2+1) half spectrum: phase 1 runs packed real row FFTs
over the N rows, phase 2 complex row FFTs over the N//2+1 surviving spectral
rows under the prefix-clipped schedule.

Functions take their device from the tensor they are given.  The row phases
refuse non-contiguous input on the kernel path, so the limb makes each
transposed copy explicitly (``.T.contiguous()``); its time is part of the
unfused path's time.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch._trace import span
from repro_torch.core.fpm import FPMSet
from repro_torch.core.partition import PartitionResult, lb_partition, partition_rows
from repro_torch.fft.fft2d import (fft_rows, fft_rows_then_transpose,
                                   rfft_rows, rfft_rows_then_transpose)
from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.schedule import SegmentPlan, SegmentSchedule

__all__ = [
    "pfft_lb",
    "pfft_fpm",
    "pfft_fpm_pad",
    "pfft_fpm_czt",
    "rpfft_lb",
    "rpfft_fpm",
    "rpfft_fpm_pad",
    "czt_dft",
    "device_groups",
    "halfspec_distribution",
    "real_limb_groups",
    "segment_row_ffts",
    "segment_row_rffts",
    "plan_segment_batches",
]


def _coerce_config(config: PlanConfig | None, caller: str, **flags) -> PlanConfig:
    """Fold the legacy loose booleans into a ``PlanConfig``.

    ``flags`` values of ``None`` mean "not passed"; any explicit value
    triggers a deprecation warning — one config object is the only way every
    variant stays choosable from a single point.
    """
    passed = {k: v for k, v in flags.items() if v is not None}
    if config is not None:
        if passed:
            raise ValueError(
                f"{caller}: pass either config= or the legacy flags "
                f"({', '.join(sorted(passed))}), not both")
        return config
    if passed:
        warnings.warn(
            f"{caller}: the {', '.join(sorted(passed))} kwarg(s) are "
            "deprecated; pass config=PlanConfig(...) (see repro_torch.plan)",
            DeprecationWarning, stacklevel=3)
    return PlanConfig.from_flags(**passed)


def _segments(d: np.ndarray) -> list[tuple[int, int]]:
    offs = np.concatenate([[0], np.cumsum(np.asarray(d))])
    return [(int(offs[i]), int(offs[i + 1])) for i in range(len(d))]


def plan_segment_batches(d: np.ndarray, pad_lengths, n: int, configs=None):
    """Group the segments of distribution ``d`` into dispatch batches.

    Without ``configs``, groups by effective FFT length alone and returns
    ``{fft_length: row_indices}``: all rows transformed at the same
    length form one batch — one FFT dispatch per distinct *plan*, the
    moral equivalent of the paper sharing an ``fftw_plan_many_dft`` across
    same-shaped groups.  len(result) is the dispatch count of the batched
    ``segment_row_ffts``.

    With ``configs`` (one ``PlanConfig`` per processor — a heterogeneous
    schedule's assignment), groups by ``(effective_length, config)`` and
    returns ``{(length, config): row_indices}``: same-length segments on
    *different* execution variants get different dispatches, so a slow
    segment can keep the library FFT while a fast one takes the kernel
    in the same phase (see ``repro_torch.plan.schedule``).  A
    ``batched=False`` config opts its segment out of sharing — those
    entries keep their per-segment key ``(length, config, index)`` so
    ``len(result)`` stays the executor's true dispatch count.
    """
    if configs is not None:
        sched = SegmentSchedule.from_parts(n, d, pad_lengths, list(configs))
        out: dict[tuple, np.ndarray] = {}
        for length, cfg, idx in sched.batch_groups():
            key = ((length, cfg) if cfg.batched
                   else (length, cfg, int(idx[0])))
            out[key] = idx
        return out
    groups: dict[int, list[np.ndarray]] = {}
    for i, (lo, hi) in enumerate(_segments(d)):
        if hi == lo:
            continue
        length = n
        if pad_lengths is not None and int(pad_lengths[i]) > n:
            length = int(pad_lengths[i])
        groups.setdefault(length, []).append(np.arange(lo, hi, dtype=np.int64))
    return {length: np.concatenate(idx) for length, idx in groups.items()}


def device_groups(schedule: SegmentSchedule, device: torch.device) -> list[tuple]:
    """``schedule.batch_groups()`` with each group's row indices also as an
    ``int64`` tensor on ``device``: ``[(length, config, idx, idx_tensor)]``.

    A plan computes this once; ``segment_row_ffts`` then gathers and
    scatters with index tensors that already lie on the device instead of
    copying them over in every call.
    """
    return [(length, cfg, idx, torch.from_numpy(idx).to(device))
            for length, cfg, idx in schedule.batch_groups()]


def _row_fft(rows: torch.Tensor, config: PlanConfig,
             backend: str | None) -> torch.Tensor:
    """Row FFTs under ``config``'s backend (``backend`` is an explicit
    override, e.g. the test suite forcing the kernel)."""
    return fft_rows(rows, **config.row_fft_kwargs(backend))


def _group_row_ffts(rows: torch.Tensor, length: int, n: int,
                    config: PlanConfig, backend: str | None) -> torch.Tensor:
    """One dispatch group's program: transform ``rows`` at effective
    ``length`` under ``config``, cropped back to N bins.

    ``pad='czt'`` entries run the exact Bluestein transform at the
    entry's length (``czt_dft``); pad-and-crop entries zero-pad, FFT,
    and crop (the paper's padded-signal semantics); unpadded entries
    FFT in place.
    """
    if config.pad == "czt" and length > n:
        return czt_dft(rows, length)
    if length > n:
        rows = torch.nn.functional.pad(rows, (0, length - n))
        return _row_fft(rows, config, backend)[:, :n]
    return _row_fft(rows, config, backend)


def segment_row_ffts(m, d: np.ndarray, *, pad_lengths=None,
                     config: PlanConfig | None = None,
                     schedule: SegmentSchedule | None = None,
                     use_stockham: bool | None = None,
                     backend: str | None = None,
                     batched: bool | None = None,
                     groups: list[tuple] | None = None) -> torch.Tensor:
    """Step 2/4 of PFFT-FPM: processor i runs row FFTs on its d_i rows.

    ``m`` is ``(rows, n)`` or a ``(..., rows, n)`` stack of such matrices;
    each dispatch group runs once over its rows of all of them.

    ``pad_lengths[i]`` (optional) is N_padded for processor i; rows are
    zero-padded to that length, transformed, and cropped back to N bins
    (or chirp-Z-transformed at it when the config says ``pad='czt'``).

    ``schedule`` (a ``repro_torch.plan.SegmentSchedule``) is the general
    form: each segment executes its own entry's config, and dispatch groups
    are ``(effective_length, config)`` — same-length segments on the same
    variant share one FFT dispatch, segments on different variants get
    their own.  ``config`` is the homogeneous shim: it becomes the
    degenerate every-segment-alike schedule.  The loose
    ``use_stockham=``/``batched=`` kwargs are deprecated shims.

    ``groups`` is ``device_groups(schedule, m.device)`` computed ahead (a
    plan does, once); without it the index tensors are made in this call.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    if schedule is not None:
        if (config is not None or pad_lengths is not None
                or use_stockham is not None or batched is not None):
            raise ValueError(
                "segment_row_ffts: pass either schedule= (which carries its "
                "own lengths) or config=/pad_lengths=/legacy flags, not both")
    else:
        config = _coerce_config(config, "segment_row_ffts",
                                use_stockham=use_stockham, batched=batched)
        schedule = SegmentSchedule.homogeneous(config, n, d, pad_lengths)
    if int(np.sum(np.asarray(d))) != m.shape[-2]:
        raise ValueError(
            f"distribution sums to {int(np.sum(np.asarray(d)))} rows, "
            f"matrix has {m.shape[-2]}")
    if schedule.total_rows != m.shape[-2]:
        raise ValueError(
            f"schedule covers {schedule.total_rows} rows, "
            f"matrix has {m.shape[-2]}")

    if groups is None:
        groups = device_groups(schedule, m.device)
    return _grouped_rows(m, groups, n, lambda rows, length, cfg:
                         _group_row_ffts(rows, length, n, cfg, backend))


def _grouped_rows(m: torch.Tensor, groups: list[tuple], width: int,
                  program) -> torch.Tensor:
    """Run each dispatch group's ``program(rows, length, config)`` ONCE
    over its rows of every matrix of ``m``: ``(..., rows, n)`` ->
    ``(..., rows, width)``.

    The group's rows (axis -2) of all leading matrices are gathered with
    the group's index tensor and flattened into one ``(B·g, n)`` row
    block, so a batch of B signals costs one dispatch per group, as one
    signal does.  A single group covering every row in order needs no
    gather or scatter at all.  Every row belongs to exactly one group, so
    the result needs no initial value.
    """
    lead, rows, n = m.shape[:-2], m.shape[-2], m.shape[-1]
    if len(groups) == 1:
        length, cfg, idx, _ = groups[0]
        if len(idx) == rows and np.array_equal(idx, np.arange(rows)):
            res = program(m.reshape(-1, n), length, cfg)
            return res.reshape(lead + (rows, width))
    axis = m.ndim - 2
    out = torch.empty(lead + (rows, width), dtype=complex_result_type(m),
                      device=m.device)
    for length, cfg, _, idx_t in groups:
        sel = m.index_select(axis, idx_t)
        res = program(sel.reshape(-1, n), length, cfg)
        out.index_copy_(axis, idx_t,
                        res.reshape(sel.shape[:-1] + (width,)).to(out.dtype))
    return out


def _pfft_limb(m, d: np.ndarray, *, pad_lengths=None,
               config: PlanConfig | None = None,
               schedule: SegmentSchedule | None = None,
               use_stockham: bool | None = None,
               fused: bool | None = None,
               groups: list[tuple] | None = None) -> torch.Tensor:
    """Paper Algorithm 3 (PFFT_LIMB): rows -> T -> rows -> T.

    ``schedule`` runs each segment under its own entry's config (the
    heterogeneous executor); ``config`` is the homogeneous shim (it
    becomes the degenerate schedule).  A homogeneous ``fused=True``
    schedule with no per-segment padding runs each (row FFTs, transpose)
    phase as one fused kernel launch — segmentation is then purely a
    scheduling notion, so the fused whole-matrix transform computes the
    identical value with no intermediate matrix.  Padded distributions
    keep the segment path (the pad semantics are per-processor).  The
    loose ``use_stockham=``/``fused=`` kwargs are deprecated shims.
    """
    m = as_tensor(m)
    if schedule is not None:
        if (config is not None or pad_lengths is not None
                or use_stockham is not None or fused is not None):
            raise ValueError(
                "_pfft_limb: pass either schedule= (which carries its own "
                "lengths) or config=/pad_lengths=/legacy flags, not both")
    else:
        config = _coerce_config(config, "_pfft_limb",
                                use_stockham=use_stockham, fused=fused)
        schedule = SegmentSchedule.homogeneous(config, m.shape[-1], d,
                                               pad_lengths)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("PFFT operates on square N x N signal matrices")
    return _complex_limb(m.contiguous(), d, schedule, groups)


def _fused_config(schedule: SegmentSchedule) -> PlanConfig | None:
    """The schedule's config when it runs the fused phases, else None.  A
    homogeneous ``fused=True`` schedule with no padding fuses:
    segmentation without padding is purely a scheduling notion, so the
    whole-matrix fused phase computes the identical value."""
    common = schedule.common_config
    if (common is not None and common.fused
            and all(e.length == schedule.n for e in schedule)):
        return common
    return None


def _complex_limb(m: torch.Tensor, d: np.ndarray, schedule: SegmentSchedule,
                  groups: list[tuple] | None) -> torch.Tensor:
    """Algorithm 3 on a contiguous ``(..., n, n)`` stack of signals.

    The unfused phases run each dispatch group once over the rows of all
    the signals (``_grouped_rows``), so a batch costs the launches of one
    signal; the transposed copies are made explicitly.  So do the fused
    phases (``_fused_phases``; ``fft_rows_then_transpose`` itself computes
    the unfused value when the kernel does not apply: non-pow2 N, types
    wider than float32).
    """
    fused = _fused_config(schedule)
    if fused is not None:
        return _fused_phases(m, fft_rows_then_transpose, fused)
    if groups is None:
        groups = device_groups(schedule, m.device)
    with span("phase1"):
        m = segment_row_ffts(m, d, schedule=schedule, groups=groups)
        m = m.transpose(-1, -2).contiguous()
    with span("phase2"):
        m = segment_row_ffts(m, d, schedule=schedule, groups=groups)
        return m.transpose(-1, -2).contiguous()


def _fused_phases(m: torch.Tensor, first, config: PlanConfig) -> torch.Tensor:
    """The two fused phases of a contiguous ``(..., n, n)`` stack: ``first``
    (``fft_rows_then_transpose``, or ``rfft_rows_then_transpose`` for the
    real limb, width w = n or n//2+1), then ``fft_rows_then_transpose``.
    radix=2 means the pure-tensor Stockham backend elsewhere, not a kernel
    radix: only an explicit radix-4 reaches the fused kernel (None lets it
    auto-pick 4).

    A stack of B matrices runs as B·n rows: phase 1 writes ``(w, B·n)``,
    whose ``(w·B, n)`` rows are exactly phase 2's rows of every matrix,
    and phase 2 writes ``(n, w·B)`` — the result in ``(n, w, B)`` order,
    returned as its ``(B, n, w)`` permuted view, with the batch fastest in
    memory: no copy is made, so for B > 1 the result is not contiguous.
    Two launches whatever B: on the H100 this beats transforming the
    matrices one at a time at N = 1024 ... 8192 and B = 2 and 8 (PERF.md).

    Phase 2 lets its kernel pad the row stride of its output to a multiple
    of 4 elements (``pad_stride``).  From N = 16384 on a card, a real
    limb's w·B rows (w = n//2+1 is odd) are written at a stride of w·B
    rounded up to a multiple of 4 (where B is not a multiple of 4), so that
    each 32-byte run of the transposed store is a whole sector; the result
    is a view of that buffer, not contiguous even at B = 1, and
    ``.contiguous()`` gives the dense copy.  A complex limb's n·B rows are a multiple of 4 already
    and are written dense.
    """
    radix = config.radix if config.radix == 4 else None
    n = m.shape[-1]
    flat = m.reshape(-1, n)
    b = flat.shape[0] // n
    with span("phase1"):
        h = first(flat, radix=radix)                             # (w, B·n)
    w = h.shape[0]
    with span("phase2"):
        z = fft_rows_then_transpose(h.reshape(w * b, n), radix=radix,
                                    pad_stride=True)             # (n, w·B)
    return z.reshape(n, w, b).permute(2, 0, 1).reshape(m.shape[:-2] + (n, w))


def pfft_lb(m, p: int, *, use_stockham: bool | None = None,
            fused: bool | None = None,
            config: PlanConfig | None = None) -> torch.Tensor:
    """PFFT-LB (paper §III-B): even row distribution over p processors."""
    m = as_tensor(m)
    cfg = _coerce_config(config, "pfft_lb",
                         use_stockham=use_stockham, fused=fused)
    d = lb_partition(m.shape[0], p).d
    return _pfft_limb(m, d, config=cfg)


def pfft_fpm(m, fpms: FPMSet, eps: float = 0.05, *,
             use_stockham: bool | None = None, fused: bool | None = None,
             config: PlanConfig | None = None,
             return_partition: bool = False):
    """PFFT-FPM (paper §III-C / Alg. 1): FPM-optimal (possibly imbalanced)
    row distribution, then the 4-step row-column pipeline."""
    m = as_tensor(m)
    n = m.shape[0]
    cfg = _coerce_config(config, "pfft_fpm",
                         use_stockham=use_stockham, fused=fused)
    part: PartitionResult = partition_rows(n, fpms, eps)
    out = _pfft_limb(m, part.d, config=cfg)
    return (out, part) if return_partition else out


def pfft_fpm_pad(m, fpms: FPMSet, eps: float = 0.05, *,
                 use_stockham: bool | None = None,
                 config: PlanConfig | None = None,
                 return_partition: bool = False):
    """PFFT-FPM-PAD (paper §III-D): PFFT-FPM + per-processor row padding
    N -> N_padded_i determined from the FPMs (padded-signal DFT semantics).

    The method owns the pad strategy: any explicit ``config=`` is
    normalized to ``pad="fpm"`` (``normalize_pad``, shared with
    ``core.api``), so a drifted ``PlanConfig(pad="czt")`` still runs the
    paper's padded-signal crop rather than Bluestein."""
    from repro_torch.plan.pads import fpm_pad_lengths  # lazy: plan imports core
    m = as_tensor(m)
    n = m.shape[0]
    cfg = _coerce_config(config, "pfft_fpm_pad", use_stockham=use_stockham)
    cfg = normalize_pad(cfg, "fpm")
    part = partition_rows(n, fpms, eps)
    pads = fpm_pad_lengths(fpms, part.d, n)
    out = _pfft_limb(m, part.d, pad_lengths=pads, config=cfg)
    return (out, part, pads) if return_partition else out


# ---------------------------------------------------------------------------
# Real-input (half-spectrum) variants: rows are real, phase 1 runs rffts
# (two rows per complex FFT), phase 2 transforms only the N//2+1
# Hermitian-unique spectral columns.
# ---------------------------------------------------------------------------

def halfspec_distribution(d: np.ndarray, nh: int) -> np.ndarray:
    """Clip a row distribution to the first ``nh`` half-spectrum rows.

    Phase 2 of the real pipeline transforms the ``nh = N//2+1`` surviving
    spectral rows; prefix-clipping keeps spectral row ``j < nh`` on the
    *same* processor that owns row ``j`` in the complex path, so a padded
    real transform computes exactly ``complex_result[:, :nh]`` (identical
    per-row pad lengths).
    """
    d = np.asarray(d)
    offs = np.concatenate([[0], np.cumsum(d)])
    lo = np.minimum(offs[:-1], nh)
    hi = np.minimum(offs[1:], nh)
    return (hi - lo).astype(np.int64)


def _clip_schedule(schedule: SegmentSchedule, d: np.ndarray,
                   nh: int) -> tuple[np.ndarray, SegmentSchedule]:
    """(clipped distribution, clipped schedule) covering ``nh`` rows.

    Entries keep their index/length/config; rows shrink per
    ``halfspec_distribution`` and emptied segments drop out.
    """
    d2 = halfspec_distribution(d, nh)
    entries = []
    for e in schedule.entries:
        rows = int(d2[e.index])
        if rows <= 0:
            continue
        entries.append(SegmentPlan(index=e.index, rows=rows,
                                   length=e.length, config=e.config))
    return d2, SegmentSchedule(n=schedule.n, entries=tuple(entries))


def real_limb_groups(schedule: SegmentSchedule, d: np.ndarray,
                     device: torch.device) -> tuple[list[tuple], list[tuple]]:
    """The real limb's dispatch groups on ``device``: those of phase 1
    (``schedule`` over the N real rows) and of phase 2 (the prefix-clipped
    schedule over the N//2+1 spectral rows).  A plan computes both once."""
    _, clipped = _clip_schedule(schedule, np.asarray(d), schedule.n // 2 + 1)
    return device_groups(schedule, device), device_groups(clipped, device)


def _group_row_rffts(rows: torch.Tensor, length: int, n: int,
                     config: PlanConfig, backend: str | None) -> torch.Tensor:
    """One dispatch group's real phase-1 program: rfft ``rows`` at
    effective ``length``, cropped to the N//2+1 half spectrum.

    The crop identity: for any pad length L >= N, bins 0..N//2 of the
    length-L transform are exactly the first N//2+1 bins the complex
    pad-and-crop path keeps — so the padded real phase equals the padded
    complex phase's half spectrum, column for column.
    """
    nh = n // 2 + 1
    if config.pad == "czt":
        raise ValueError("the real pipeline has no Bluestein form "
                         "(PlanConfig rejects real+czt)")
    kwargs = config.row_fft_kwargs(backend)
    if length > n:
        rows = torch.nn.functional.pad(rows, (0, length - n))
        return rfft_rows(rows, **kwargs)[:, :nh]
    return rfft_rows(rows, **kwargs)


def segment_row_rffts(m, d: np.ndarray, *, pad_lengths=None,
                      config: PlanConfig | None = None,
                      schedule: SegmentSchedule | None = None,
                      backend: str | None = None,
                      groups: list[tuple] | None = None) -> torch.Tensor:
    """Real phase 1: processor i runs row rffts on its d_i real rows.

    The (..., rows, N) real matrices come back as the (..., rows, N//2+1)
    complex half spectra; grouping/dispatch semantics are exactly
    ``segment_row_ffts``'s (same ``SegmentSchedule.batch_groups``), and
    ``groups`` is ``device_groups(schedule, m.device)`` computed ahead.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    nh = n // 2 + 1
    if schedule is not None:
        if config is not None or pad_lengths is not None:
            raise ValueError(
                "segment_row_rffts: pass either schedule= (which carries "
                "its own lengths) or config=/pad_lengths=, not both")
    else:
        if config is None:
            config = PlanConfig(real=True)
        schedule = SegmentSchedule.homogeneous(config, n, d, pad_lengths)
    if int(np.sum(np.asarray(d))) != m.shape[-2]:
        raise ValueError(
            f"distribution sums to {int(np.sum(np.asarray(d)))} rows, "
            f"matrix has {m.shape[-2]}")
    if schedule.total_rows != m.shape[-2]:
        raise ValueError(
            f"schedule covers {schedule.total_rows} rows, "
            f"matrix has {m.shape[-2]}")

    if groups is None:
        groups = device_groups(schedule, m.device)
    return _grouped_rows(m, groups, nh, lambda rows, length, cfg:
                         _group_row_rffts(rows, length, n, cfg, backend))


def _rpfft_limb(m, d: np.ndarray, *, pad_lengths=None,
                config: PlanConfig | None = None,
                schedule: SegmentSchedule | None = None,
                groups: tuple[list[tuple], list[tuple]] | None = None
                ) -> torch.Tensor:
    """Real PFFT_LIMB: real rows -> T -> complex rows on the half spectrum.

    Returns the (N, N//2+1) half spectrum of the 2-D DFT (``rfft2``
    layout).  Phase 1 rffts each segment (half the complex FFTs via row
    packing); phase 2 runs *complex* row FFTs over the nh surviving
    spectral rows under the prefix-clipped schedule
    (``halfspec_distribution``), so per-processor pad lengths apply to
    exactly the rows the complex path would pad.  A homogeneous
    ``fused=True`` schedule with no padding runs both phases as fused
    kernel launches, like ``_pfft_limb``.  ``groups`` is
    ``real_limb_groups(schedule, d, m.device)`` computed ahead (a plan
    does, once); without it the index tensors are made in this call.
    """
    m = as_tensor(m)
    if schedule is not None:
        if config is not None or pad_lengths is not None:
            raise ValueError(
                "_rpfft_limb: pass either schedule= (which carries its own "
                "lengths) or config=/pad_lengths=, not both")
    else:
        if config is None:
            config = PlanConfig(real=True)
        schedule = SegmentSchedule.homogeneous(config, m.shape[-1], d,
                                               pad_lengths)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("PFFT operates on square N x N signal matrices")
    if not m.is_floating_point():
        raise ValueError(
            f"the real pipeline takes a real-valued matrix, got {m.dtype}")
    return _real_limb(m.contiguous(), d, schedule, groups)


def _real_limb(m: torch.Tensor, d: np.ndarray, schedule: SegmentSchedule,
               groups: tuple[list[tuple], list[tuple]] | None
               ) -> torch.Tensor:
    """The real limb on a contiguous ``(..., n, n)`` stack of real
    signals -> ``(..., n, n//2+1)``; batches as ``_complex_limb`` does."""
    nh = m.shape[-1] // 2 + 1
    fused = _fused_config(schedule)
    if fused is not None:
        return _fused_phases(m, rfft_rows_then_transpose, fused)
    if groups is None:
        groups = real_limb_groups(schedule, d, m.device)
    with span("phase1"):
        h = segment_row_rffts(m, d, schedule=schedule, groups=groups[0])
        h = h.transpose(-1, -2).contiguous()                  # (..., nh, n)
    d2, sched2 = _clip_schedule(schedule, np.asarray(d), nh)
    with span("phase2"):
        h = segment_row_ffts(h, d2, schedule=sched2, groups=groups[1])
        return h.transpose(-1, -2).contiguous()               # (..., n, nh)


def _real_config(config: PlanConfig | None) -> PlanConfig:
    """Default/force the ``real`` flag for the rpfft entry points."""
    if config is None:
        return PlanConfig(real=True)
    return config if config.real else dataclasses.replace(config, real=True)


def rpfft_lb(m, p: int, *, config: PlanConfig | None = None) -> torch.Tensor:
    """Real-input PFFT-LB: even row distribution, half-spectrum output.

    Under ``fused=True`` at N >= 16384 on a card, the ``(N, N//2+1)`` half
    spectrum comes back as a view whose row stride is rounded up to a
    multiple of 4 elements (``_fused_phases``); ``.contiguous()`` gives the
    dense copy.  The same holds for ``rpfft_fpm``."""
    m = as_tensor(m)
    cfg = _real_config(config)
    d = lb_partition(m.shape[0], p).d
    return _rpfft_limb(m, d, config=cfg)


def rpfft_fpm(m, fpms: FPMSet, eps: float = 0.05, *,
              config: PlanConfig | None = None,
              return_partition: bool = False):
    """Real-input PFFT-FPM: FPM-optimal row distribution, half-spectrum
    output.  The partition is computed for the full N rows (phase 1 sees
    all of them); phase 2 prefix-clips it to the half spectrum.  A fused
    schedule at N >= 16384 returns a view with padded rows (``rpfft_lb``)."""
    m = as_tensor(m)
    n = m.shape[0]
    cfg = _real_config(config)
    part: PartitionResult = partition_rows(n, fpms, eps)
    out = _rpfft_limb(m, part.d, config=cfg)
    return (out, part) if return_partition else out


def rpfft_fpm_pad(m, fpms: FPMSet, eps: float = 0.05, *,
                  config: PlanConfig | None = None,
                  return_partition: bool = False):
    """Real-input PFFT-FPM-PAD: per-processor row padding chosen by
    ``rfft_pad_lengths`` (even lengths only), padded-signal DFT semantics
    — the output equals the complex ``pfft_fpm_pad`` result's first
    N//2+1 columns, bin for bin."""
    from repro_torch.plan.pads import rfft_pad_lengths  # lazy: plan imports core
    m = as_tensor(m)
    n = m.shape[0]
    cfg = normalize_pad(_real_config(config), "fpm")
    part = partition_rows(n, fpms, eps)
    pads = rfft_pad_lengths(fpms, part.d, n)
    out = _rpfft_limb(m, part.d, pad_lengths=pads, config=cfg)
    return (out, part, pads) if return_partition else out


# ---------------------------------------------------------------------------
# Beyond paper: exact N-point DFT at arbitrary (model-chosen) FFT length.
# ---------------------------------------------------------------------------

def _czt_chirp(n: int) -> np.ndarray:
    """Bluestein chirp c_j = exp(-i*pi*(j^2 mod 2N)/N), j = 0..N-1.

    Computed on the host in ``int64``: a device-side 32-bit ``j*j`` wraps
    for j >= 46341 and the chirp — hence the "exact" transform — would be
    silently wrong for every N > 46340.  ``np.int64`` squares stay exact
    to N ~ 2^31, and the reduced residue (< 2N) keeps the float64 angle
    small, which is the whole point of the mod-2N identity.
    """
    j = np.arange(n, dtype=np.int64)
    return np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)


@functools.lru_cache(maxsize=16)
def _czt_tables(n: int, m_fft: int, ctype: torch.dtype,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(chirp, FFT of the wrapped conjugate-chirp kernel) on ``device``.

    Both depend only on the sizes, so a plan's repeated calls reuse them
    instead of rebuilding the chirp on the host and copying it over.  The
    cache is small and bounded; callers must not write to the tensors.
    """
    chirp = torch.from_numpy(_czt_chirp(n)).to(device=device, dtype=ctype)
    # Kernel b_j = conj(chirp)_{|j|}, wrapped for circular convolution.
    b = torch.zeros(m_fft, dtype=ctype, device=device)
    b[:n] = chirp.conj()
    b[m_fft - n + 1:] = chirp.conj()[1:n].flip(0)
    return chirp, torch.fft.fft(b)


def czt_dft(x, m_fft: int | None = None) -> torch.Tensor:
    """Exact N-point DFT along the last axis via Bluestein's chirp-Z trick.

    DFT_N(x)[k] = conj(c_k) * IFFT_m( FFT_m(x*conj(c)) * FFT_m(c') )[k]
    with chirp c_j = exp(i*pi*j^2/N) and any FFT length m >= 2N-1.  ``m_fft``
    is the model-chosen fast length (defaults to next power of two).  The
    inner FFTs are the library's, as in the reference.
    """
    x = as_tensor(x)
    n = x.shape[-1]
    if m_fft is None:
        m_fft = 1 << int(np.ceil(np.log2(2 * n - 1)))
    if m_fft < 2 * n - 1:
        raise ValueError(f"m_fft={m_fft} < 2N-1={2 * n - 1}")
    ctype = complex_result_type(x)
    if not x.numel():
        return torch.empty(x.shape, dtype=ctype, device=x.device)
    chirp, b_hat = _czt_tables(n, int(m_fft), ctype, x.device)
    a = torch.zeros(x.shape[:-1] + (m_fft,), dtype=ctype, device=x.device)
    a[..., :n] = x * chirp
    conv = torch.fft.ifft(torch.fft.fft(a, dim=-1) * b_hat, dim=-1)
    return (conv[..., :n] * chirp).to(ctype)


def pfft_fpm_czt(m, fpms: FPMSet, eps: float = 0.05, *,
                 return_partition: bool = False):
    """PFFT-FPM with exact padded transforms: each processor runs its row
    DFTs through the chirp-Z identity at an FPM-chosen smooth FFT length.
    Output equals the exact 2-D DFT (unlike PFFT-FPM-PAD's interpolation).

    Executes through the schedule path, so same-length czt segments share
    one Bluestein dispatch (``plan_segment_batches`` semantics)."""
    from repro_torch.plan.pads import czt_fft_lengths  # lazy: plan imports core
    m = as_tensor(m)
    n = m.shape[0]
    part = partition_rows(n, fpms, eps)
    lens = czt_fft_lengths(fpms, part.d, n, limit_ratio=2.0)
    out = _pfft_limb(m, part.d, pad_lengths=lens,
                     config=PlanConfig(pad="czt"))
    return (out, part, lens) if return_partition else out
