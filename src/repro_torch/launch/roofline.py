"""Roofline terms of one traced step of the port on an H100 (counterpart of
``repro.launch.roofline``).

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes accessed / HBM_bw
    collective = collective_bytes / link_bw

per rank: the port's program is SPMD, one process per card, so the counts
of one traced rank are the per-device program's.  Where the reference reads
FLOPs and bytes off ``compiled.cost_analysis()`` and the collectives off the
partitioned HLO text (``collective_bytes``, kept here as the same string
function), the port counts them over one eager step with ``StepCounter``, a
``TorchDispatchMode`` that sees every aten op the step dispatches (on fake
tensors too, so a production-size step is counted without allocating it).
MODEL_FLOPS = 6*N*D (6*N_active*D for MoE) gives the useful-compute ratio.

``HW`` holds the datasheet figures of the 700 W H100 SXM, not measured:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, and 50 GB/s a
card for a collective: one 400 Gb/s NDR InfiniBand port per H100, the rate
a 16-wide mesh axis pays once it leaves an 8-card NVLink node.  NVLink 4
(450 GB/s each way inside a node) is the faster in-node rate that no
production mesh axis stays within.
"""

from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import Iterable

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig, ShapeCfg

__all__ = ["HW", "RooflineTerms", "collective_bytes", "roofline_terms",
           "model_flops", "param_count",
           "active_param_count", "StepCounter", "tensor_bytes"]


@dataclasses.dataclass(frozen=True)
class HW:
    """H100 SXM (700 W) datasheet constants (module docstring)."""
    peak_flops: float = 989e12     # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12        # B/s per card
    ici_bw: float = 50e9           # B/s per card across nodes (one NDR port)


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+((?:\([^)]*\)|[a-z0-9\[\],{}/ ]+?))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.IGNORECASE)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Per-collective-kind output bytes summed over an HLO module's text.
    '-start' ops counted, '-done' skipped (same buffer)."""
    out: dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue
        kind = m.group(2).lower()
        out[kind] = out.get(kind, 0) + _shape_bytes(m.group(1))
    return out


def param_count(params: nn.Module | Iterable[torch.Tensor]) -> int:
    """Elements of every parameter of a module (or of every tensor of an
    iterable), on any device, meta and fake tensors included; a DTensor
    counts whole."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params
    return int(sum(int(np.prod(t.shape)) for t in tensors))


def model_flops(cfg: ArchConfig, shape: ShapeCfg, n_params: int,
                n_active: int | None = None) -> float:
    """6*N*D (training) / 2*N*D (inference fwd) with D = processed tokens.
    MoE uses active params."""
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def active_param_count(cfg: ArchConfig, n_params: int) -> int:
    """Approximate active params for MoE archs (experts scaled by top_k/E)."""
    if cfg.moe is None:
        return n_params
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    expert_params = cfg.n_layers * 3 * cfg.d_model * cfg.moe.d_expert * E
    if cfg.mlp == "gelu":
        expert_params = cfg.n_layers * 2 * cfg.d_model * cfg.moe.d_expert * E
    rest = n_params - expert_params
    return int(rest + expert_params * k / E)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: dict[str, int]
    model_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline actually achievable: useful
        model FLOPs over (bound time x fleet peak)."""
        denom = self.bound_s * self.chips * HW().peak_flops
        return self.model_flops / denom if denom else float("nan")

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed, "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops, "chips": self.chips,
            "dominant": self.dominant, "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(cost: dict, hlo_text: str, chips: int,
                   mflops: float, hw: HW = HW(), *,
                   coll_bytes: dict[str, int] | None = None) -> RooflineTerms:
    """cost: {"flops", "bytes accessed"} of one rank's step (a
    ``StepCounter``'s ``cost()``); fleet totals are those times ``chips``
    (the terms below are per-step wall-clock seconds).  The collective term
    comes from ``hlo_text``'s collectives or, in the port, from
    ``coll_bytes`` (a ``StepCounter``'s, by kind), which replaces them."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll = dict(coll_bytes) if coll_bytes is not None else collective_bytes(hlo_text)
    coll_total = float(sum(coll.values()))
    return RooflineTerms(
        compute_s=flops_dev / hw.peak_flops,
        memory_s=bytes_dev / hw.hbm_bw,
        collective_s=coll_total / hw.ici_bw,
        flops=flops_dev * chips,
        bytes_accessed=bytes_dev * chips,
        coll_bytes=coll,
        model_flops=mflops,
        chips=chips,
    )


# --------------------------------------------------- counting a traced step

def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def tensor_bytes(tree) -> int:
    """The bytes this rank holds of every tensor of ``tree`` (nested dicts,
    lists, tuples, named tuples, modules' parameters): a DTensor's local
    block; a storage shared by several counts once."""
    seen: dict[int, int] = {}

    def walk(x):
        if isinstance(x, nn.Module):
            x = list(x.parameters())
        if isinstance(x, torch.Tensor):
            t = _local(x)
            seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return sum(seen.values())


# the reference's collective kinds by op name (``_c10d_functional.*`` and
# the in-place ``c10d.*`` ops alike); ``wait_tensor`` only hands back the
# buffer its collective wrote, and a barrier moves nothing
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"))
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
                    "monitored_barrier")
# ops that move no data: allocation and metadata
_METADATA = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "lift_fresh_copy", "detach",
             "alias", "_unsafe_view", "_reshape_alias", "set_", "resize_"}


def _collective_kind(func) -> str | None:
    if func.namespace not in ("_c10d_functional", "c10d"):
        return None
    name = func._opname
    if name in _NOT_COLLECTIVES:
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return name


def _tensors(tree, out: list) -> list:
    """The tensors of an op's arguments or result (nested lists, tuples and
    dicts), each DTensor as its local block, into ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(tensors: list) -> int:
    """The bytes the tensors hold, each element once: a dimension of stride
    0 (a broadcast, as ``expand`` makes) holds one copy of its elements, so
    ``matmul`` counts the same whether it folds a batch into ``mm`` or
    broadcasts a weight into ``bmm`` (which it picks by strides that fake
    and real tensors may give a size-1 dimension differently)."""
    total = 0
    for t in tensors:
        if t.numel():
            total += t.element_size() * math.prod(
                n for n, st in zip(t.shape, t.stride()) if st)
    return total


class StepCounter(TorchDispatchMode):
    """Counts one traced step, rank-local, op by op:

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s own per-op
      formulas (its ``flop_registry``: matmuls, attention, convolutions) on
      each op's local tensors; a rematerialised forward counts again, as it
      runs again;
    * ``bytes_accessed``: the bytes of every op's tensor inputs and outputs
      (a DTensor's local block, a broadcast dimension once; views, metadata
      and allocation ops left out): what the eager program reads and
      writes, op by op, with no fusion;
    * ``coll_bytes``: the output bytes of each collective, by the
      reference's kind names (``wait_tensor`` not counted again);
    * ``peak_bytes``: the peak of the live bytes of the storages the step
      created (weak references: a storage counts until it is freed);
      tensors that existed before the step (its arguments) do not count.

    ``cost()`` is the reference's ``cost_analysis()`` dict."""

    def __init__(self) -> None:
        super().__init__()
        self._flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict[str, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}

    def cost(self) -> dict[str, float]:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes_accessed)}

    def _freed(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        # the storage's Python object lives as long as the storage itself
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._freed, key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self._flop_registry.get(func.overloadpacket)
        if count is not None:
            local = tree_map_only(DTensor, _local, (args, kwargs, out))
            self.flops += int(count(*local[0], **local[1], out_val=local[2]))
        name = func._opname
        if func.namespace == "prim" or func.is_view or name in _METADATA \
                or name in _NOT_COLLECTIVES:
            return out
        outs = _tensors(out, [])
        kind = _collective_kind(func)
        if kind is not None:
            # an in-place c10d op without a tensor result wrote its first argument
            written = outs or _tensors(args[:1], [])
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + _nbytes(written)
        self.bytes_accessed += _nbytes(_tensors((args, kwargs), [])) + _nbytes(outs)
        if not func._schema.is_mutable:   # else it wrote tensors it was given
            for t in outs:
                self._track(t)
        return out
