"""Attention: GQA (train / prefill / decode with a KV cache) and MLA
(DeepSeek-V2 multi-head latent attention with a compressed-KV cache).

Counterpart of ``repro.models.attention``.  ``_sdpa`` is the reference's:
einsum over the (KV, G) head grouping, scores in f32 with masked entries at
-1e30, an f32 softmax cast to ``v``'s dtype before the PV product, and causal
queries split into ``q_chunk`` blocks, one after the other, so that the
scores of one block are (B, H, q_chunk, S).  A cache is updated in place: a prefill of T tokens
writes rows [pos0, pos0 + T), a decode step appends one; a write that would
run past the cache raises (``jax.lax.dynamic_update_slice`` clamps it).
MLA is the reference's expanded form: k and v are decompressed per head
over the whole latent cache at every call.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.layers import Dense, Norm, apply_norm, apply_rope, dense

__all__ = [
    "gqa_init", "gqa_apply", "gqa_init_cache",
    "mla_init", "mla_apply", "mla_init_cache",
    "GQA", "MLA",
]


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
        _write_cache(cache, {"k": k, "v": v}, pos0)
        o = _sdpa(q, cache["k"], cache["v"], pos, pos0 + T, causal=True,
                  q_chunk=q_chunk)
    return dense(p.wo, o.reshape(B, T, n_heads * hd)), cache


def _write_cache(cache: dict[str, torch.Tensor], rows: dict[str, torch.Tensor],
                 pos0: int) -> None:
    """Write each of ``rows`` (B, T, ...) into ``cache`` at [pos0, pos0 + T)
    in place; a write past the end raises."""
    T = next(iter(rows.values())).shape[1]
    max_len = next(iter(cache.values())).shape[1]
    if not 0 <= pos0 <= max_len - T:
        raise ValueError(
            f"KV cache overflow: writing positions [{pos0}, {pos0 + T}) "
            f"into a cache of {max_len}")
    for name, value in rows.items():
        cache[name][:, pos0:pos0 + T] = value.to(cache[name].dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed latent KV + decoupled RoPE key
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """``wq`` (d, H*(nope+rope)), ``w_dkv`` (d, kv_lora+rope), ``kv_norm``
    (an RMSNorm of kv_lora, whatever the model's norm), ``w_uk`` (kv_lora,
    H*nope), ``w_uv`` (kv_lora, H*v_dim), ``wo`` (H*v_dim, d)."""

    def __init__(self, d: int, n_heads: int, *, kv_lora: int, nope: int,
                 rope: int, v_dim: int, dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        H = n_heads
        self.wq = Dense(d, H * (nope + rope), dtype=dtype, device=device, gen=gen)
        self.w_dkv = Dense(d, kv_lora + rope, dtype=dtype, device=device, gen=gen)
        self.kv_norm = Norm(kv_lora, device=device)
        self.w_uk = Dense(kv_lora, H * nope, dtype=dtype, device=device, gen=gen)
        self.w_uv = Dense(kv_lora, H * v_dim, dtype=dtype, device=device, gen=gen)
        self.wo = Dense(H * v_dim, d, dtype=dtype, device=device, gen=gen)


def mla_init(gen, d: int, n_heads: int, *, kv_lora: int, nope: int, rope: int,
             v_dim: int, dtype=torch.bfloat16, device=None) -> MLA:
    return MLA(d, n_heads, kv_lora=kv_lora, nope=nope, rope=rope, v_dim=v_dim,
               dtype=dtype, device=device, gen=gen)


def mla_init_cache(batch: int, max_len: int, kv_lora: int, rope: int,
                   dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    """The compressed latent ``ckv`` (B, max_len, kv_lora) and the one shared
    rope key ``krope`` (B, max_len, rope): (kv_lora + rope) per token instead
    of 2*H*hd."""
    device = resolve_device(device)
    return {"ckv": torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, rope), dtype=dtype,
                                 device=device)}


def mla_apply(p: MLA, x, *, n_heads: int, kv_lora: int, nope: int, rope: int,
              v_dim: int, rope_theta: float, q_chunk: int | None = 1024,
              cache=None, pos0: int = 0):
    """x: (B, T, d), always causal.  The rope parts of q and the shared rope
    key rotate in mode ``"full"``, whatever the model's ``rope_mode``; the
    scores scale by 1/sqrt(nope + rope).  Returns (out, cache)."""
    B, T, _ = x.shape
    H = n_heads
    q = dense(p.wq, x).reshape(B, T, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    pos = pos0 + torch.arange(T, device=x.device)
    q_rope = apply_rope(q_rope, pos, "full", rope_theta)

    dkv = dense(p.w_dkv, x)
    ckv = apply_norm(p.kv_norm, dkv[..., :kv_lora])
    krope = apply_rope(dkv[..., kv_lora:][:, :, None, :], pos, "full",
                       rope_theta)[:, :, 0, :]

    if cache is not None:
        _write_cache(cache, {"ckv": ckv, "krope": krope}, pos0)
        ckv, krope, kv_len = cache["ckv"], cache["krope"], pos0 + T
    else:
        kv_len = None

    # expanded form: decompress k and v per head
    S = ckv.shape[1]
    k_nope = dense(p.w_uk, ckv).reshape(B, S, H, nope)
    v = dense(p.w_uv, ckv).reshape(B, S, H, v_dim)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rope)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    o = _sdpa(qfull, k, v, pos, kv_len, causal=True, q_chunk=q_chunk)
    return dense(p.wo, o.reshape(B, T, H * v_dim)), cache
