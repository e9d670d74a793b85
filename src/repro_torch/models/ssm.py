"""Mamba2 (SSD) blocks — chunked scan for prefill, O(1)-state decode.

Counterpart of ``repro.models.ssm``.  State-space recurrence with a scalar
decay per head (Mamba2's SSD form):

    h_t = exp(-dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)      h: (H, P, N)
    y_t = C_t · h_t + D * x_t

Prefill runs the chunkwise algorithm (intra-chunk quadratic in log-decay
space, the state carried from chunk to chunk in a Python loop where the
reference scans); a decode step of one token with a cache takes the
recurrent update.  A cache (``conv`` (B, d_conv-1, ch) and ``ssm`` (B, H, P,
N), float32) is updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import SSMCfg
from repro_torch.models.layers import (Dense, Norm, _chunk_len, _store, _weight,
                                      apply_norm, dense)

__all__ = ["mamba2_init", "mamba2_apply", "mamba2_init_cache", "Mamba2"]


def _dims(d_model: int, cfg: SSMCfg):
    d_inner = cfg.expand * d_model
    H = d_inner // cfg.head_dim
    return d_inner, H


class Mamba2(nn.Module):
    """``in_proj`` (d, 2*d_inner + 2*N + H; columns z | xBC | dt), the
    depthwise ``conv_w`` (d_conv, ch) drawn normal * 0.2 and ``conv_b``
    (zeros) over the ch = d_inner + 2*N channels of xBC, float32 ``A_log``
    (log of 1 ... 16), ``D`` (ones) and ``dt_bias`` (zeros) per head,
    ``out_norm`` (an RMSNorm of d_inner) and ``out_proj``."""

    def __init__(self, d_model: int, cfg: SSMCfg, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        d_inner, H = _dims(d_model, cfg)
        N = cfg.d_state
        conv_ch = d_inner + 2 * N  # x-part + B + C go through the short conv
        self.in_proj = Dense(d_model, 2 * d_inner + 2 * N + H, dtype=dtype,
                             device=device, gen=gen)
        self.conv_w = _weight((cfg.d_conv, conv_ch), 0.2, dtype, device, gen)
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype, device=device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H,
                                                           device=device)))
        self.D = nn.Parameter(torch.ones(H, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, device=device))
        self.out_norm = Norm(d_inner, device=device)
        self.out_proj = Dense(d_inner, d_model, dtype=dtype, device=device, gen=gen)


def mamba2_init(gen, d_model: int, cfg: SSMCfg, dtype=torch.bfloat16,
                device=None) -> Mamba2:
    return Mamba2(d_model, cfg, dtype, device, gen)


def mamba2_init_cache(batch: int, d_model: int, cfg: SSMCfg,
                      dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    device = resolve_device(device)
    d_inner, H = _dims(d_model, cfg)
    conv_ch = d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.head_dim, cfg.d_state), dtype=dtype,
                           device=device),
    }


def _split(p: Mamba2, x, d_inner: int, N: int, H: int):
    zxbcdt = dense(p.in_proj, x)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = F.softplus(zxbcdt[..., -H:].float() + p.dt_bias)
    return z, xbc, dt


def _causal_conv(p: Mamba2, xbc, cfg: SSMCfg, conv_state=None):
    """Depthwise causal conv of width d_conv, tap 0 on the oldest position,
    in ``xbc``'s dtype; returns (out, new_state)."""
    B = xbc.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((B, cfg.d_conv - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    T = xbc.shape[1]
    out = sum(full[:, i:i + T] * p.conv_w[i] for i in range(cfg.d_conv))
    out = F.silu(out + p.conv_b)
    new_state = full[:, -(cfg.d_conv - 1):] if cfg.d_conv > 1 else pad
    return out, new_state


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int, h0):
    """Chunked SSD scan.
    xh: (B,T,H,P); Bm/Cm: (B,T,N); dt: (B,T,H); A: (H,) (positive decay rate);
    h0: (B,H,P,N) initial state.  Returns (y float32 (B,T,H,P), h_final)."""
    T = xh.shape[1]
    if T % chunk:
        raise ValueError(f"sequence of {T} must divide by ssm chunk {chunk}")
    h = h0.float()
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    ys = []
    for s in range(0, T, chunk):
        xc, bc, cc = (a[:, s:s + chunk].float() for a in (xh, Bm, Cm))
        dtc = dt[:, s:s + chunk]                      # (B,L,H)
        cum = torch.cumsum(dtc * (-A), dim=1)         # (B,L,H) inclusive log-decay
        # Intra-chunk: y_t += sum_{s<=t} C_t·B_s exp(cum_t - cum_s) dt_s x_s,
        # the upper triangle masked in log space before exp.
        seg = cum[:, :, None, :] - cum[:, None, :, :]            # (B,L_t,L_s,H)
        decay = torch.exp(seg.masked_fill(~mask[None, :, :, None], float("-inf")))
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        w = cb[..., None] * decay * dtc[:, None, :, :]           # (B,t,s,H)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xc)
        # Inter-chunk: y_t += C_t · (exp(cum_t) * h_in)
        y_inter = torch.einsum("btn,bhpn,bth->bthp", cc, h, torch.exp(cum))
        # State: h_out = exp(cum_L) h_in + sum_s exp(cum_L - cum_s) dt_s B_s x_s
        tot = cum[:, -1]                                         # (B,H)
        rdec = torch.exp(tot[:, None, :] - cum) * dtc            # (B,L,H)
        h = (torch.exp(tot)[:, :, None, None] * h
             + torch.einsum("blh,bln,blhp->bhpn", rdec, bc, xc))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def mamba2_apply(p: Mamba2, x, cfg: SSMCfg, *, cache=None):
    """x: (B, T, d_model) -> (B, T, d_model).  cache: {'conv', 'ssm'} for
    prefill and decode, written in place; T == 1 with a cache takes the
    recurrent step.  Returns (out, cache)."""
    Bsz, T, _ = x.shape
    d_inner, H = _dims(x.shape[-1], cfg)
    N, P = cfg.d_state, cfg.head_dim
    z, xbc, dt = _split(p, x, d_inner, N, H)
    A = torch.exp(p.A_log)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(p, xbc, cfg, conv_state)
    xpart = xbc[..., :d_inner].reshape(Bsz, T, H, P)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    Dx = p.D[None, None, :, None] * xpart.float()

    if cache is not None and T == 1:
        dA = torch.exp(-dt[:, 0] * A)                            # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xpart[:, 0].float())
        h_new = dA[:, :, None, None] * cache["ssm"] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h_new)[:, None] + Dx
    else:
        h0 = (cache["ssm"] if cache is not None
              else xpart.new_zeros((Bsz, H, P, N), dtype=torch.float32))
        y, h_new = _ssd_chunked(xpart, Bm, Cm, dt, A, _chunk_len(cfg.chunk, T, "ssm"),
                                h0)
        y = y + Dx

    y = y.reshape(Bsz, T, d_inner).to(x.dtype)
    y = apply_norm(p.out_norm, y * F.silu(z))
    out = dense(p.out_proj, y)
    if cache is not None:
        _store(cache, {"conv": new_conv, "ssm": h_new})
    return out, cache
