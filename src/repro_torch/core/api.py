"""Plan-style user API (mirrors fftw's plan/execute lifecycle).

    plan = plan_pfft(n=4096, fpms=fpms, method="fpm-pad",
                     config=PlanConfig(radix=4))
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

Not in this package yet, and refused with ``NotImplementedError`` rather than
quietly ignored: ``tune="estimate"|"measure"`` and ``wisdom=`` (the planner
slice) and ``mesh=`` (the distributed slice).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Literal

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.core.fpm import FPMSet
from repro_torch.core.partition import PartitionResult, lb_partition, partition_rows
from repro_torch.core.pfft import (_pfft_limb, _rpfft_limb, device_groups,
                                   real_limb_groups)
from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.schedule import SegmentSchedule

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

__all__ = ["PfftPlan", "plan_pfft", "rfft2", "irfft2"]


def _base_method(method: str) -> str:
    """The partitioning family a method uses: ``rfft-fpm-pad`` pads and
    partitions exactly like ``fpm-pad``; the prefix only changes what the
    transform delivers."""
    return method[5:] if method in _REAL_METHODS else method


def _ctype_for(dtype: str) -> torch.dtype:
    return (torch.complex128 if np.dtype(dtype) == np.dtype(np.float64)
            else torch.complex64)


def _plan_groups(method: str, schedule: SegmentSchedule, d: np.ndarray,
                 device: torch.device):
    """The dispatch groups the plan's executor runs, made once on its
    device: the real limb's two phases for a real-flagged schedule of a
    real method, else the complex limb's."""
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

    def _run(self, m: torch.Tensor) -> torch.Tensor:
        """Route as the reference's ``_build_raw`` does: a real method with
        a real-flagged schedule runs the half-spectrum limb; one with a
        complex-family schedule upcasts, runs the complex limb and crops."""
        d = self.partition.d
        if self.method in _REAL_METHODS:
            if self.schedule.anchor_config.real:
                return _rpfft_limb(m, d, schedule=self.schedule,
                                   groups=self._groups)
            return _pfft_limb(m.to(_ctype_for(self.dtype)), d,
                              schedule=self.schedule,
                              groups=self._groups)[:, :self.n // 2 + 1]
        return _pfft_limb(m, d, schedule=self.schedule, groups=self._groups)

    def execute(self, m) -> torch.Tensor:
        """Run the planned transform; leading batch dims are looped.

        ``m``: ``(..., n, n)``, a tensor on the plan's device or a host
        array (copied there).  A batch gives what transforming each
        ``(n, n)`` signal alone gives, stacked — the fused kernel takes one
        matrix at a time, so the batch is a loop of launches.  The result
        is ``(..., n, n)``, or ``(..., n, n//2+1)`` for the ``rfft-*``
        methods.
        """
        if not isinstance(m, torch.Tensor):
            m = as_tensor(m, self.device)
        if m.device != self.device:
            raise ValueError(
                f"plan lives on {self.device}, signal on {m.device}; move "
                "the signal or plan for its device")
        if m.ndim < 2 or tuple(m.shape[-2:]) != (self.n, self.n):
            raise ValueError(
                f"plan is for ({self.n}, {self.n}) signals "
                f"(optionally with leading batch dims), got {tuple(m.shape)}")
        if m.ndim == 2:
            return self._run(m)
        lead = m.shape[:-2]
        flat = m.reshape((-1, self.n, self.n))
        out = torch.stack([self._run(x) for x in flat])
        return out.reshape(lead + out.shape[1:])

    def execute_many(self, ms, *, pad_to: int | None = None) -> list:
        """Serve a cohort: stack same-size signals into ONE batched execute.

        ``ms`` is a sequence of ``(n, n)`` host signals (many users'
        concurrent requests for the same transform).  Stacking, padding
        with zero signals up to ``pad_to``, and unstacking happen on the
        host (numpy), so the device sees exactly one transfer in and one
        out; the returned results are numpy views into the fetched batch.
        """
        if not ms:
            return []
        shape = (self.n, self.n)
        arrs = [np.asarray(m) for m in ms]
        for m in arrs:
            if m.shape != shape:
                raise ValueError(
                    f"execute_many stacks {shape} signals, got {m.shape}")
        batch = np.stack(arrs)
        b = len(arrs)
        if pad_to is not None and pad_to > b:
            batch = np.concatenate(
                [batch, np.zeros((pad_to - b,) + batch.shape[1:], batch.dtype)])
        out = self.execute(torch.from_numpy(batch).to(self.device)).cpu().numpy()
        return [out[i] for i in range(b)]

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
                                 self.device))


def _resolve_schedule(n: int, method: Method, part: PartitionResult,
                      pads: np.ndarray | None, config: PlanConfig | None
                      ) -> tuple[SegmentSchedule, dict[str, Any]]:
    """The plan's execution schedule and where it came from: an explicit
    config, else the default (library FFT, batched dispatch).  The method
    owns the pad semantics (``normalize_pad``): an explicit ``PlanConfig()``
    on fpm-czt still runs Bluestein and a drifted ``pad="czt"`` on fpm-pad
    still runs the paper's crop.  Real methods also own the transform: an
    explicit config is real-flagged so the executor runs the half-spectrum
    pipeline."""
    pad_strategy = _PAD_STRATEGY[method]
    real = method in _REAL_METHODS
    if config is not None:
        cfg, source = normalize_pad(config, pad_strategy), "explicit"
        if real and not cfg.real:
            cfg = dataclasses.replace(cfg, real=True)
    else:
        cfg, source = PlanConfig(pad=pad_strategy, real=real), "off"
    return (SegmentSchedule.homogeneous(cfg, n, part.d, pads),
            {"mode": "off", "source": source})


def plan_pfft(n: int, *, p: int | None = None, fpms: FPMSet | None = None,
              method: Method = "fpm", eps: float = 0.05,
              tune: TuneMode = "off", wisdom: str | None = None,
              config: PlanConfig | None = None, dtype: str = "complex64",
              mesh=None, device: str | torch.device | None = None,
              use_stockham: bool | None = None,
              fused: bool | None = None) -> PfftPlan:
    """Build a reusable plan; see the module docstring for the lifecycle.

    ``method``: ``"lb"`` (needs ``p``), ``"fpm"``, ``"fpm-pad"``,
    ``"fpm-czt"`` (need ``fpms``), and their real-input forms
    ``"rfft-lb"``, ``"rfft-fpm"``, ``"rfft-fpm-pad"`` (``dtype="float32"``
    or ``"float64"``; ``execute`` returns the (N, N//2+1) half spectrum).
    ``config`` picks the execution variant (default: library FFT).
    ``use_stockham=``/``fused=`` are deprecated shims for the legacy flag
    API (they build an explicit config).
    """
    if tune not in ("off", "estimate", "measure"):
        raise ValueError(f"tune must be 'off'|'estimate'|'measure', got {tune!r}")
    if method not in _PAD_STRATEGY:
        raise ValueError(f"unknown method {method!r}")
    if tune != "off":
        raise NotImplementedError(
            f"tune={tune!r}: the planner (cost model, tuner) is not in "
            "repro_torch yet; it comes with the planner slice — pass an "
            "explicit config=PlanConfig(...)")
    if wisdom is not None:
        raise NotImplementedError(
            "wisdom=: the wisdom store is not in repro_torch yet; it comes "
            "with the planner slice")
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: distributed plans are not in repro_torch yet; they come "
            "with the distributed slice")
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
    if use_stockham is not None or fused is not None:
        if config is not None:
            raise ValueError("pass either config= or the legacy flags "
                             "(use_stockham/fused), not both")
        warnings.warn(
            "plan_pfft: use_stockham=/fused= are deprecated; pass "
            "config=PlanConfig(...)", DeprecationWarning, stacklevel=2)
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
        part = partition_rows(n, fpms, eps)
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
    schedule, tuning = _resolve_schedule(n, method, part, pads, config)
    return PfftPlan(n=n, method=method, partition=part, pad_lengths=pads,
                    config=schedule.anchor_config, schedule=schedule,
                    tuning=tuning, device=device, dtype=dtype,
                    _groups=_plan_groups(method, schedule, part.d, device))


def rfft2(m, *, p: int = 1, tune: TuneMode = "off", wisdom: str | None = None,
          mesh=None) -> torch.Tensor:
    """One-shot planned real-input 2-D DFT -> (N, N//2+1) half spectrum.

    Builds an ``rfft-lb`` plan for ``m``'s size, dtype and device and
    executes it once.  A host array goes to the default (CUDA) device.  For
    the plan-once/run-many lifecycle (or the FPM methods) use
    ``plan_pfft(method='rfft-...')`` directly.
    """
    m = as_tensor(m)
    if m.ndim < 2 or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"rfft2 plans square (N, N) signals, got {tuple(m.shape)}")
    plan = plan_pfft(m.shape[-1], p=p, method="rfft-lb", tune=tune,
                     wisdom=wisdom, dtype=str(m.dtype).removeprefix("torch."),
                     mesh=mesh, device=m.device)
    return plan.execute(m)


def irfft2(h, *, n: int | None = None) -> torch.Tensor:
    """Inverse of ``rfft2``: half spectrum back to the real signal
    (``repro_torch.fft.irfft2``; pass ``n`` for odd original lengths)."""
    from repro_torch.fft.fft2d import irfft2 as _irfft2
    return _irfft2(h, n=n)
