"""Attention: GQA for train / prefill / decode with a KV cache.

Counterpart of the GQA half of ``repro.models.attention`` (MLA comes with
the MoE configs, ROADMAP M11b).  ``_sdpa`` is the reference's: einsum over
the (KV, G) head grouping, scores in f32 with masked entries at -1e30, an f32
softmax cast to ``v``'s dtype before the PV product, and causal queries split
into ``q_chunk`` blocks, one after the other, so that the scores of one block
are (B, H, q_chunk, S).  A cache is updated in place: a prefill of T tokens
writes rows [pos0, pos0 + T), a decode step appends one; a write that would
run past the cache raises (``jax.lax.dynamic_update_slice`` clamps it).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.layers import Dense, apply_rope, dense

__all__ = ["gqa_init", "gqa_apply", "gqa_init_cache", "GQA"]


# ---------------------------------------------------------------------------
# core scaled-dot-product with GQA grouping, causal masking, q-chunking
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, q_pos, kv_len, *, causal: bool, q_chunk: int | None):
    """q: (B,Tq,H,hd); k,v: (B,Tk,KV,hd); q_pos: (Tq,) absolute positions;
    kv_len: int or None — valid prefix length of k/v (cache).  Query head
    ``h`` attends with KV head ``h // G``."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = float(1.0 / np.sqrt(hd))
    kpos = torch.arange(Tk, device=q.device)

    def block(q_blk, pos_blk):
        t = q_blk.shape[1]
        qg = q_blk.reshape(B, t, KV, G, hd)
        s = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
        mask = torch.ones((t, Tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= pos_blk[:, None]
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = s.masked_fill(~mask, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgts,bskh->btkgh", p, v)
        return o.reshape(B, t, H, v.shape[-1])

    if q_chunk is None or Tq <= q_chunk or Tq % q_chunk:
        return block(q, q_pos)
    outs = [block(q[:, i:i + q_chunk], q_pos[i:i + q_chunk])
            for i in range(0, Tq, q_chunk)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Projections ``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd), ``wo``."""

    def __init__(self, d: int, n_heads: int, n_kv: int, hd: int, *,
                 bias: bool = False, dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.wq = Dense(d, n_heads * hd, bias=bias, dtype=dtype, device=device, gen=gen)
        self.wk = Dense(d, n_kv * hd, bias=bias, dtype=dtype, device=device, gen=gen)
        self.wv = Dense(d, n_kv * hd, bias=bias, dtype=dtype, device=device, gen=gen)
        self.wo = Dense(n_heads * hd, d, dtype=dtype, device=device, gen=gen)


def gqa_init(gen, d: int, n_heads: int, n_kv: int, hd: int, *,
             bias: bool = False, dtype=torch.bfloat16, device=None) -> GQA:
    return GQA(d, n_heads, n_kv, hd, bias=bias, dtype=dtype, device=device,
               gen=gen)


def gqa_init_cache(batch: int, max_len: int, n_kv: int, hd: int,
                   dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    device = resolve_device(device)
    return {name: torch.zeros((batch, max_len, n_kv, hd), dtype=dtype,
                              device=device) for name in ("k", "v")}


def gqa_apply(p: GQA, x, *, n_heads: int, n_kv: int, hd: int, rope_mode: str,
              rope_theta: float, causal: bool = True,
              q_chunk: int | None = 1024, cache=None, pos0: int = 0):
    """x: (B, T, d).  cache=None: full self-attention over x (train / encoder).
    cache given: prefill (T>1) writes [pos0, pos0+T), decode (T==1) appends,
    in place.  Returns (out, cache)."""
    B, T, _ = x.shape
    q = dense(p.wq, x).reshape(B, T, n_heads, hd)
    k = dense(p.wk, x).reshape(B, T, n_kv, hd)
    v = dense(p.wv, x).reshape(B, T, n_kv, hd)
    pos = pos0 + torch.arange(T, device=x.device)
    q = apply_rope(q, pos, rope_mode, rope_theta)
    k = apply_rope(k, pos, rope_mode, rope_theta)

    if cache is None:
        o = _sdpa(q, k, v, pos, None, causal=causal, q_chunk=q_chunk)
    else:
        max_len = cache["k"].shape[1]
        if not 0 <= pos0 <= max_len - T:
            raise ValueError(
                f"KV cache overflow: writing positions [{pos0}, {pos0 + T}) "
                f"into a cache of {max_len}")
        cache["k"][:, pos0:pos0 + T] = k.to(cache["k"].dtype)
        cache["v"][:, pos0:pos0 + T] = v.to(cache["v"].dtype)
        o = _sdpa(q, cache["k"], cache["v"], pos, pos0 + T, causal=True,
                  q_chunk=q_chunk)
    return dense(p.wo, o.reshape(B, T, n_heads * hd)), cache
