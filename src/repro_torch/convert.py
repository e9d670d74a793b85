"""Carry the reference package's state across to this one.

The system has no weights; its state is the model input (FPMs), the plan
(partition, config, schedule) and the signal.  The reference's objects are
handed over as numpy arrays and plain dicts — this package never imports the
reference — and come out as this package's objects, so that both compute from
the same FPMs, partition and schedule.  FPM files need no converter:
``load_fpms`` reads what the reference's ``save_fpms`` writes, and the other
way round.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.core.fpm import FPMSet, SpeedFunction
from repro_torch.core.partition import PartitionResult
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["fpms_from_arrays", "partition_from_arrays", "config_from_dict",
           "schedule_from_dict", "signal_to_tensor"]


def fpms_from_arrays(functions: Iterable[Sequence]) -> FPMSet:
    """``[(xs, ys, speed, name), ...]`` -> ``FPMSet`` (arrays are copied)."""
    return FPMSet([SpeedFunction(np.array(xs), np.array(ys), np.array(speed),
                                 name=str(name))
                   for xs, ys, speed, name in functions])


def partition_from_arrays(d, tau: float, method: str,
                          predicted_times) -> PartitionResult:
    return PartitionResult(d=np.array(d), tau=float(tau), method=str(method),
                           predicted_times=np.array(predicted_times))


def config_from_dict(d: dict[str, Any]) -> PlanConfig:
    """A ``PlanConfig.to_dict()`` of either package -> this package's."""
    return PlanConfig.from_dict(dict(d))


def schedule_from_dict(d: dict[str, Any]) -> SegmentSchedule:
    """A ``SegmentSchedule.to_dict()`` of either package -> this package's."""
    return SegmentSchedule.from_dict(d)


def signal_to_tensor(signal: np.ndarray,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """A host array -> a tensor on ``device`` (``None``: the CUDA device,
    raising when there is none), dtype kept."""
    return as_tensor(np.asarray(signal), device)
