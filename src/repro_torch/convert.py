"""Carry the reference package's state across to this one.

The FFT system has no weights; its state is the model input (FPMs), the
plan (partition, config, schedule) and the signal.  The LM scaffold's state
is its parameter tree.  The reference's objects are handed over as numpy
arrays and plain dicts — this package never imports the reference — and come
out as this package's objects, so that both compute from the same FPMs,
partition, schedule and weights.  FPM files need no converter: ``load_fpms``
reads what the reference's ``save_fpms`` writes, and the other way round.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.fpm import FPMSet, SpeedFunction
from repro_torch.core.partition import PartitionResult
from repro_torch.models.transformer import TransformerLM, _hybrid_layout
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["fpms_from_arrays", "partition_from_arrays", "config_from_dict",
           "schedule_from_dict", "signal_to_tensor", "lm_params_from_arrays"]


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


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor of its own copy; bfloat16 (``ml_dtypes``)
    crosses bit for bit through its 16-bit integer view."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_arrays(tree: dict[str, Any], cfg: ArchConfig,
                          device: str | torch.device | None = None):
    """The reference's LM parameter pytree -> this package's model.

    ``tree`` is the reference's ``init_params`` result as nested dicts (and,
    for xLSTM's ``blocks``, a list) of numpy arrays.  Transformer layers are
    stacked on a leading axis (``tree["layers"]["attn"]["wq"]["w"][i]`` is
    layer ``i``'s; an MoE layer's experts ``tree["layers"]["moe"]["wg"]`` are
    (L, E, d, f), its router float32); the hybrid's Mamba2 blocks on two,
    (n_groups, g, ...), its ``shared`` block a plain dict.  Every leaf must
    fill one parameter of the same shape and dtype, and every parameter must
    be filled.
    """
    model = TransformerLM(cfg, resolve_device(device))
    leaves = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            leaves[path] = node

    walk(tree, ())
    # the stacked subtrees: their leading axes, which the module indexes
    stacked = {"layers": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        g, n_groups = _hybrid_layout(cfg)
        stacked["mamba"] = (n_groups, g)
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = tuple(name.split("."))
            lead = stacked.get(parts[0], ())
            path = parts[:1] + parts[1 + len(lead):]
            index = tuple(int(i) for i in parts[1:1 + len(lead)])
            if path not in leaves:
                raise KeyError(f"the parameter tree has no leaf {'/'.join(path)}")
            used.add(path)
            arr = np.asarray(leaves[path])
            if arr.shape[:len(lead)] != lead:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[:len(lead)]} stacked "
                                 f"layers for a config of {lead}")
            value = _leaf_tensor(arr[index])
            if tuple(value.shape) != tuple(param.shape) or value.dtype != param.dtype:
                raise ValueError(
                    f"{name}: leaf is {tuple(value.shape)} {value.dtype}, the "
                    f"parameter {tuple(param.shape)} {param.dtype}")
            param.copy_(value)
    extra = set(leaves) - used
    if extra:
        raise KeyError(f"leaves with no parameter: "
                       f"{sorted('/'.join(p) for p in extra)}")
    return model
