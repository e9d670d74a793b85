"""The paper's primary contribution: FPMs, POPTA/HPOPTA partitioning,
padding selection, the PFFT-LB / PFFT-FPM / PFFT-FPM-PAD algorithms, and
their 3-D and huge-1-D (four-step) extensions."""

from repro_torch.core.fpm import SpeedFunction, FPMSet, build_fpm, save_fpms, load_fpms, fft_flops
from repro_torch.core.partition import PartitionResult, popta, hpopta, lb_partition, partition_rows
from repro_torch.core.padding import determine_pad_length, smooth_candidates, pad_to_smooth, is_smooth
from repro_torch.core.pfft import (pfft_lb, pfft_fpm, pfft_fpm_pad, pfft_fpm_czt,
                                   czt_dft, segment_row_ffts, plan_segment_batches,
                                   rpfft_lb, rpfft_fpm, rpfft_fpm_pad,
                                   halfspec_distribution, segment_row_rffts)
from repro_torch.core.api import (plan_pfft, PfftPlan, rfft2, irfft2,
                                  plan_pfft3, Pfft3Plan, plan_pfft1_large,
                                  Pfft1LargePlan, pfft1_large)
from repro_torch.core.pfft3d import (pfft3_lb, pfft3_fpm, pfft3_fpm_pad,
                                     pfft3_distributed, pfft3_pencil, pfft3_slab)
from repro_torch.core.pfft_large import four_step_factors, pfft1_large_apply
from repro_torch.plan.config import PlanConfig

__all__ = [
    "SpeedFunction", "FPMSet", "build_fpm", "save_fpms", "load_fpms", "fft_flops",
    "PartitionResult", "popta", "hpopta", "lb_partition", "partition_rows",
    "determine_pad_length", "smooth_candidates", "pad_to_smooth", "is_smooth",
    "pfft_lb", "pfft_fpm", "pfft_fpm_pad", "pfft_fpm_czt", "czt_dft",
    "segment_row_ffts", "plan_segment_batches",
    "rpfft_lb", "rpfft_fpm", "rpfft_fpm_pad",
    "halfspec_distribution", "segment_row_rffts",
    "plan_pfft", "PfftPlan", "rfft2", "irfft2", "PlanConfig",
    "plan_pfft3", "Pfft3Plan", "plan_pfft1_large", "Pfft1LargePlan",
    "pfft1_large", "pfft3_lb", "pfft3_fpm", "pfft3_fpm_pad",
    "pfft3_distributed", "pfft3_pencil", "pfft3_slab",
    "four_step_factors", "pfft1_large_apply",
]
