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
from repro_torch.models.transformer import TransformerLM, stacked_leaf
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["fpms_from_arrays", "partition_from_arrays", "config_from_dict",
           "schedule_from_dict", "signal_to_tensor", "lm_params_from_arrays",
           "lm_arrays_from_params"]


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


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (never a view of it); bfloat16 as float32
    (exactly)."""
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy())


def lm_arrays_from_params(model: TransformerLM, cfg: ArchConfig,
                          tensors: dict[str, torch.Tensor | None] | None = None):
    """This package's model -> the reference's LM parameter tree, the inverse
    of ``lm_params_from_arrays``: nested dicts (the xLSTM's ``blocks`` a
    list) of numpy arrays, transformer layers stacked on a leading axis and
    the hybrid's Mamba2 blocks on (n_groups, g).

    With ``tensors`` (a dict keyed by parameter name: gradients, moments,
    residuals), those are laid out instead of the parameters; a ``None``
    entry (a parameter the loss did not reach) comes out as float32 zeros.
    bfloat16 comes out as float32, exactly."""
    pieces: dict[tuple, dict[tuple, np.ndarray]] = {}
    leads = {}
    for name, param in model.named_parameters():
        path, index, lead = stacked_leaf(name, cfg)
        t = param if tensors is None else tensors[name]
        arr = (np.zeros(tuple(param.shape), np.float32) if t is None
               else _host(t))
        pieces.setdefault(path, {})[index] = arr
        leads[path] = lead
    tree: dict[str, Any] = {}
    for path, parts in pieces.items():
        lead = leads[path]
        if lead:
            first = next(iter(parts.values()))
            arr = np.empty(lead + first.shape, first.dtype)
            for index, part in parts.items():
                arr[index] = part
        else:
            arr = parts[()]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    if "blocks" in tree:   # the xLSTM's list of blocks
        tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


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
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, index, lead = stacked_leaf(name, cfg)
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
