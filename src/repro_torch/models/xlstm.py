"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory with recurrent gating, sequential).

Counterpart of ``repro.models.xlstm``.  mLSTM is linear-attention-like:
prefill runs the stabilised chunkwise algorithm (intra-chunk quadratic with a
log-gate decay matrix, the (hd x hd) matrix memory carried from chunk to
chunk), decode is the same at a chunk of one.  sLSTM has a true nonlinear
recurrence through its hidden state (recurrent weights ``r``), so it steps
through time in every mode.  Where the reference scans (``lax.scan`` over
chunks, over time steps), this module loops in Python.  A cache is updated in
place: its tensors hold the new state after the call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.layers import (Dense, Norm, _chunk_len, _store, _weight,
                                      apply_norm, dense)

__all__ = [
    "mlstm_init", "mlstm_apply", "mlstm_init_cache",
    "slstm_init", "slstm_apply", "slstm_init_cache",
    "MLSTM", "SLSTM",
]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq``/``wk``/``wv`` (d, H*hd), the input and forget gates ``wi``/``wf``
    (d, H), ``out_norm`` (an RMSNorm of H*hd) and ``wo`` (H*hd, d)."""

    def __init__(self, d: int, n_heads: int, hd: int, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "gen": gen}
        self.wq = Dense(d, n_heads * hd, **kw)
        self.wk = Dense(d, n_heads * hd, **kw)
        self.wv = Dense(d, n_heads * hd, **kw)
        self.wi = Dense(d, n_heads, **kw)
        self.wf = Dense(d, n_heads, **kw)
        self.out_norm = Norm(n_heads * hd, device=device)
        self.wo = Dense(n_heads * hd, d, **kw)


def mlstm_init(gen, d: int, n_heads: int, hd: int, dtype=torch.bfloat16,
               device=None) -> MLSTM:
    return MLSTM(d, n_heads, hd, dtype, device, gen)


def mlstm_init_cache(batch: int, n_heads: int, hd: int,
                     device=None) -> dict[str, torch.Tensor]:
    """float32 ``C`` (B, H, hd, hd), ``n`` (B, H, hd) and the running max
    ``m`` (B, H) at -1e30."""
    device = resolve_device(device)
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), device=device),
        "n": torch.zeros((batch, n_heads, hd), device=device),
        "m": torch.full((batch, n_heads), -1e30, device=device),
    }


def _mlstm_chunk(state, inputs, hd: int):
    """One chunk of the stabilised chunkwise mLSTM.
    q,k,v: (B,L,H,hd); logi,logf: (B,L,H).  Returns ((C, n, m), h)."""
    C, n, m = state
    q, k, v, logi, logf = inputs
    q, k, v = q.float() / float(np.sqrt(hd)), k.float(), v.float()
    cumf = torch.cumsum(logf, dim=1)                     # (B,L,H) inclusive
    # log weight of source s at target t (s<=t): cumf_t - cumf_s + logi_s
    lw = cumf[:, :, None, :] - cumf[:, None, :, :] + logi[:, None, :, :]
    L = q.shape[1]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    lw = lw.masked_fill(~mask[None, :, :, None], float("-inf"))
    # carried-state weight at target t: cumf_t + m  (m is the running max)
    lw_state = cumf + m[:, None, :]
    m_new_t = torch.maximum(lw.amax(dim=2), lw_state)   # (B,L,H) per-target max
    w = torch.exp(lw - m_new_t[:, :, None, :])          # (B,t,s,H)
    w_state = torch.exp(lw_state - m_new_t)             # (B,L,H)

    qk = torch.einsum("btkh,bskh->btsk", q, k)           # (B,t,s,H)
    num_intra = torch.einsum("btsh,bshd->bthd", qk * w, v)
    num_state = torch.einsum("bthd,bhde->bthe", q, C) * w_state[..., None]
    # Normaliser: n_t = sum_s w_ts k_s accumulated, then dotted with q_t.
    ksum = torch.einsum("btsh,bshd->bthd", w, k)         # (B,t,H,hd)
    den = (torch.einsum("bthd,bthd->bth", q, ksum)
           + torch.einsum("bthd,bhd->bth", q, n) * w_state)
    h = (num_intra + num_state) / torch.clamp(den.abs(), min=1.0)[..., None]

    # State carry to the next chunk.
    mc = m_new_t[:, -1]                                  # (B,H) new running max
    dec_state = torch.exp(cumf[:, -1] + m - mc)          # (B,H)
    src_w = torch.exp(cumf[:, -1][:, None, :] - cumf + logi - mc[:, None, :])
    C_new = (dec_state[..., None, None] * C
             + torch.einsum("bsh,bshd,bshe->bhde", src_w, k, v))
    n_new = dec_state[..., None] * n + torch.einsum("bsh,bshd->bhd", src_w, k)
    return (C_new, n_new, mc), h


def mlstm_apply(p: MLSTM, x, *, n_heads: int, hd: int, chunk: int = 64,
                cache=None):
    """x: (B, T, d), T a multiple of ``min(chunk, T)``.  Returns (out,
    cache): the cache (or None) holds the state after the last position."""
    B, T, _ = x.shape
    q = dense(p.wq, x).reshape(B, T, n_heads, hd)
    k = dense(p.wk, x).reshape(B, T, n_heads, hd)
    v = dense(p.wv, x).reshape(B, T, n_heads, hd)
    logi = dense(p.wi, x).float()                        # log input gate
    logf = F.logsigmoid(dense(p.wf, x).float())

    st = ((cache["C"], cache["n"], cache["m"]) if cache is not None else
          tuple(mlstm_init_cache(B, n_heads, hd, x.device).values()))
    Lc = _chunk_len(chunk, T, "mlstm")
    hs = []
    for s in range(0, T, Lc):
        st, h = _mlstm_chunk(st, tuple(a[:, s:s + Lc] for a in (q, k, v, logi, logf)),
                             hd)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, T, n_heads * hd).to(x.dtype)
    out = dense(p.wo, apply_norm(p.out_norm, h))
    if cache is not None:
        _store(cache, dict(zip(("C", "n", "m"), st)))
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The four gates' (i, f, z, o) feed-forward ``w`` (d, 4*H*hd), each
    head's gates in its own 4*hd columns; the block-diagonal recurrent ``r``
    (H, hd, 4*hd) drawn normal / sqrt(hd); ``out_norm``; ``wo``."""

    def __init__(self, d: int, n_heads: int, hd: int, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        self.w = Dense(d, 4 * n_heads * hd, dtype=dtype, device=device, gen=gen)
        self.r = _weight((n_heads, hd, 4 * hd), float(1.0 / np.sqrt(hd)), dtype,
                         device, gen)
        self.out_norm = Norm(n_heads * hd, device=device)
        self.wo = Dense(n_heads * hd, d, dtype=dtype, device=device, gen=gen)


def slstm_init(gen, d: int, n_heads: int, hd: int, dtype=torch.bfloat16,
               device=None) -> SLSTM:
    return SLSTM(d, n_heads, hd, dtype, device, gen)


def slstm_init_cache(batch: int, n_heads: int, hd: int,
                     device=None) -> dict[str, torch.Tensor]:
    """float32 ``c``, ``n``, ``h`` and ``m`` (B, H, hd), all zeros."""
    device = resolve_device(device)
    return {name: torch.zeros((batch, n_heads, hd), device=device)
            for name in ("c", "n", "h", "m")}


def slstm_apply(p: SLSTM, x, *, n_heads: int, hd: int, cache=None):
    """x: (B, T, d), one recurrent step a position.  Returns (out, cache)."""
    B, T, _ = x.shape
    wx = dense(p.w, x).reshape(B, T, n_heads, 4 * hd).float()
    r = p.r.float()
    c, n, h, m = ((cache["c"], cache["n"], cache["h"], cache["m"]) if cache is not None
                  else tuple(slstm_init_cache(B, n_heads, hd, x.device).values()))
    hs = []
    for t in range(T):
        g = wx[:, t] + torch.einsum("bkd,kdf->bkf", h, r)     # (B,H,4hd)
        gi, gf, gz, go = torch.split(g, hd, dim=-1)
        # stabilised exponential gating
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        i = torch.exp(gi - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(gz)
        n = f * n + i
        h = torch.sigmoid(go) * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, T, n_heads * hd).to(x.dtype)
    out = dense(p.wo, apply_norm(p.out_norm, out))
    if cache is not None:
        _store(cache, {"c": c, "n": n, "h": h, "m": m})
    return out, cache
