"""Model-driven execution planning (the FFTW plan/wisdom lifecycle).

One selection point for every execution variant: ``PlanConfig`` names a
variant, ``SegmentSchedule`` assigns one per segment (the heterogeneous
generalisation — slow processors keep the library FFT while fast ones take
the kernel), ``groups`` lowers heterogeneous schedules to device-group
programs for the distributed pipeline, ``cost`` prices it from the FPMs
plus structural counts, ``tune`` picks one (estimate = model only, measure
= time the finalists on the device; ``tune_schedule`` prices per distinct
effective FFT length, ``tune_dist_schedule`` races on a mesh),
``wisdom`` persists the choice per (n, dtype, p, method, backend),
``cache`` keeps built plans hot in a bounded LRU fronting the wisdom store,
``calibrate`` fits the cost constants back from measured wisdom, and
``pads`` holds the shared FPM pad/CZT-length selection.  The user entry
point is ``repro_torch.core.api.plan_pfft(tune=..., wisdom=...)``.
"""

from repro_torch.plan.config import PlanConfig, normalize_pad
from repro_torch.plan.cache import CacheStats, PlanCache
from repro_torch.plan.groups import (DeviceGroupProgram, device_group_program,
                                     spmd_program_config)
from repro_torch.plan.schedule import SegmentPlan, SegmentSchedule
from repro_torch.plan.pads import (czt_fft_lengths, fpm_pad_lengths,
                                   rfft_pad_lengths)
from repro_torch.plan.cost import (CommTiers, CostParams, comm_phase_time,
                                   dist_comm_bytes, dist_comm_time,
                                   estimate_cost, estimate_grouped_cost,
                                   estimate_pfft3_cost,
                                   estimate_schedule_cost, exchange_time,
                                   halfspec_cols, pfft3_comm_bytes,
                                   phase_dispatch_count)
from repro_torch.plan.wisdom import (WISDOM_VERSION, load_wisdom,
                                     lookup_wisdom, partition_digest,
                                     record_wisdom, topology_digest,
                                     wisdom_key)
from repro_torch.plan.tune import (candidate_configs, dist_panel_space,
                                   grouped_dist_schedule, measure_configs,
                                   measure_dist_configs, measure_rfft_configs,
                                   measure_pfft3_configs,
                                   measure_rfft_dist_configs,
                                   pfft3_panel_space,
                                   segment_candidate_configs, tune_config,
                                   tune_dist_config, tune_dist_schedule,
                                   tune_pfft1_large, tune_pfft3, tune_rfft,
                                   tune_rfft_dist, tune_schedule)
from repro_torch.plan.calibrate import fit_cost_params

__all__ = [
    "PlanConfig", "normalize_pad",
    "CacheStats", "PlanCache",
    "DeviceGroupProgram", "device_group_program", "spmd_program_config",
    "SegmentPlan", "SegmentSchedule",
    "czt_fft_lengths", "fpm_pad_lengths", "rfft_pad_lengths",
    "CommTiers", "CostParams", "comm_phase_time", "dist_comm_bytes",
    "dist_comm_time", "estimate_cost",
    "estimate_grouped_cost", "estimate_pfft3_cost",
    "estimate_schedule_cost", "exchange_time", "halfspec_cols",
    "pfft3_comm_bytes", "phase_dispatch_count",
    "WISDOM_VERSION", "load_wisdom", "lookup_wisdom", "partition_digest",
    "record_wisdom", "topology_digest", "wisdom_key",
    "candidate_configs", "dist_panel_space", "grouped_dist_schedule",
    "measure_configs", "measure_dist_configs", "measure_pfft3_configs",
    "measure_rfft_configs",
    "measure_rfft_dist_configs", "segment_candidate_configs", "tune_config",
    "tune_dist_config", "tune_dist_schedule", "tune_rfft", "tune_rfft_dist",
    "tune_schedule", "pfft3_panel_space", "tune_pfft3", "tune_pfft1_large",
    "fit_cost_params",
]
