"""The self-healing runtime: fault injection, straggler detection, elastic
rebuilds over ``torch.distributed``, checkpoints, and ``ResilientPlan``
(counterpart of ``repro.runtime``).  Importing it builds no kernel, touches
no CUDA state and creates no process group."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.elastic import (RebuildResult, largest_fft_axis,
                                         largest_grid, rebuild_fft_mesh,
                                         rebuild_mesh, reshard)
from repro_torch.runtime.faults import (DeviceLostError, FaultInjector,
                                        corrupt_wisdom, get_injector, inject,
                                        locked_wisdom, repeated,
                                        retry_with_backoff)

__all__ = [
    "CheckpointManager",
    "StragglerMonitor",
    "RebuildResult",
    "largest_fft_axis",
    "largest_grid",
    "rebuild_fft_mesh",
    "rebuild_mesh",
    "reshard",
    "DeviceLostError",
    "FaultInjector",
    "corrupt_wisdom",
    "get_injector",
    "inject",
    "locked_wisdom",
    "repeated",
    "retry_with_backoff",
    "ResilientPlan",
]


def __getattr__(name):
    # ResilientPlan pulls in the plan API; keep the package import light
    # for callers that only want the monitors.
    if name == "ResilientPlan":
        from repro_torch.runtime.resilient import ResilientPlan
        return ResilientPlan
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
