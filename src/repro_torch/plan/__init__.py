"""Execution planning: ``PlanConfig`` names a variant, ``SegmentSchedule``
assigns one per segment (the heterogeneous generalisation — slow processors
keep the library FFT while fast ones take the kernel), and ``pads`` holds the
shared FPM pad/CZT-length selection.  The user entry point is
``repro_torch.core.api.plan_pfft(config=...)``."""

from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.schedule import SegmentPlan, SegmentSchedule
from repro_torch.plan.pads import (czt_fft_lengths, fpm_pad_lengths,
                                   rfft_pad_lengths)

__all__ = [
    "PlanConfig", "normalize_pad",
    "SegmentPlan", "SegmentSchedule",
    "czt_fft_lengths", "fpm_pad_lengths", "rfft_pad_lengths",
]
