"""Gradient compression for bandwidth-bound reduction (counterpart of
``repro.optim.grad_compress``).

Two codecs and an error-feedback wrapper:

* int8: per-tensor absmax-scaled symmetric quantisation (8x over f32);
* topk: magnitude top-k sparsification (values + indices);
* error feedback: the residual (g - decompress(compress(g))) is carried to
  the next step, which is what keeps compressed SGD/Adam convergent.

``compressed_psum`` is the collective over a ``torch.distributed`` process
group: each rank quantises with the group's largest scale (an ``all_reduce``
MAX of the float32 scales), the int8 payloads are summed in int32 (an
``all_reduce`` SUM), and the sum is rescaled.  Used by ``train.step`` when
``TrainCfg.grad_compress != 'none'``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import distribute_whole

__all__ = ["int8_compress", "int8_decompress", "topk_compress",
           "topk_decompress", "error_feedback_update", "compressed_psum"]


def _scale(g: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(g)).to(torch.float32) / 127.0 + 1e-12


def _quantise(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round-half-to-even of g / scale, clipped to ±127, as int8."""
    return torch.clamp(torch.round(g.to(torch.float32) / scale),
                       -127, 127).to(torch.int8)


def int8_compress(g: torch.Tensor):
    scale = _scale(g)
    return _quantise(g, scale), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_compress(g: torch.Tensor, k_frac: float = 0.05):
    """The ``max(1, int(size·k_frac))`` entries of largest magnitude: (their
    values, their flat indices, g's shape).  Among equal magnitudes the
    choice may differ from the reference's ``lax.top_k``."""
    flat = g.to(torch.float32).reshape(-1)
    k = max(1, int(flat.numel() * k_frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx, tuple(g.shape)


def topk_decompress(vals, idx, shape) -> torch.Tensor:
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=torch.float32,
                      device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def error_feedback_update(g: torch.Tensor, residual: torch.Tensor,
                          codec: str = "int8", **kw):
    """Compress (g + residual); return (decompressed, new_residual).

    DTensors (of one layout) are compressed whole: the int8 scale is the
    largest magnitude of the whole tensor, the top-k support its k largest,
    not a block's.  Both are gathered, compressed on every rank alike, and
    each rank keeps its blocks of the results."""
    if isinstance(g, DTensor):
        dec, new_r = error_feedback_update(g.full_tensor(),
                                           residual.full_tensor(), codec, **kw)
        return (distribute_whole(dec, g.device_mesh, g.placements),
                distribute_whole(new_r, residual.device_mesh, residual.placements))
    total = g.to(torch.float32) + residual
    if codec == "int8":
        dec = int8_decompress(*int8_compress(total))
    elif codec == "topk":
        dec = topk_decompress(*topk_compress(total, **kw))
    else:
        raise ValueError(codec)
    return dec.to(g.dtype), total - dec


def compressed_psum(grads: Any, group=None):
    """int8-quantised sum of ``grads`` (a tensor, or nested dicts, lists and
    tuples of tensors) over the ranks of ``group`` (the default group when one is
    initialised; without one, a world of this process alone: the identity
    up to quantisation).

    The scales are maxed across the group first, so the int8 payloads share
    a codebook and sum exactly in int32 (no per-rank decompression
    traffic)."""
    world = dist.is_available() and dist.is_initialized()

    def one(g):
        scale = _scale(g)
        if world:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        total = _quantise(g, scale).to(torch.int32)
        if world:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.to(torch.float32) * scale).to(g.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return one(node)

    return walk(grads)
