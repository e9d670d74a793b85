"""Mixture-of-Experts block: top-k token-choice routing with grouped capacity
dispatch, plus optional shared experts (DeepSeek style).

Counterpart of ``repro.models.moe``.  Tokens are routed within groups (the
batch rows) with a per-group capacity C of ``moe_capacity(T)`` slots per
expert.  Each (token, choice) takes the next free slot of its expert, counted
in choice-major order (every token's first choice, then every token's second
choice, ...); one whose slot reaches C is dropped and adds exactly zero.  The
reference expresses dispatch and combine as (G, T, E, C) one-hot einsums;
here they are index operations on the same slots: the kept (token, choice)
rows are scattered into an (E, G·C, d) buffer, the experts run as batched
products over E, and each token gathers its kept slots back, weighted by its
gates.  The same slots, drops and gates, and so the same function.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoECfg
from repro_torch.models import sharding
from repro_torch.models.layers import MLP, Dense, _weight, apply_mlp

__all__ = ["moe_init", "moe_apply", "moe_capacity", "MoE"]


class MoE(nn.Module):
    """``router`` (a float32 ``Dense`` d -> E), the experts' raw ``wg``,
    ``wu`` (E, d, f) and ``wd`` (E, f, d), and ``shared`` (one ``MLP`` of
    width ``n_shared·f``) when ``n_shared > 0``.  ``wg`` is there under
    ``mlp_kind="gelu"`` too, unused, as in the reference's tree."""

    def __init__(self, d: int, cfg: MoECfg, *, mlp_kind: str = "swiglu",
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        E, f = cfg.n_experts, cfg.d_expert
        scale = float(1.0 / np.sqrt(d))
        self.router = Dense(d, E, scale=scale, dtype=torch.float32,
                            device=device, gen=gen)
        self.wg = _weight((E, d, f), scale, dtype, device, gen)
        self.wu = _weight((E, d, f), scale, dtype, device, gen)
        self.wd = _weight((E, f, d), float(1.0 / np.sqrt(f)), dtype, device, gen)
        self.shared = (MLP(d, cfg.n_shared * f, mlp_kind, dtype, device, gen)
                       if cfg.n_shared else None)


def moe_init(gen, d: int, cfg: MoECfg, *, mlp_kind: str = "swiglu",
             dtype=torch.bfloat16, device=None) -> MoE:
    return MoE(d, cfg, mlp_kind=mlp_kind, dtype=dtype, device=device, gen=gen)


def moe_capacity(tokens_per_group: int, cfg: MoECfg) -> int:
    c = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)  # a multiple of 8, as the reference pads


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in ``dtype``, by the same ops on every tensor:
    ``F.one_hot`` scatters into zeros on real tensors but compares against
    an ``arange`` on fake ones, which the dry-run would count apart."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: MoE, x: torch.Tensor, cfg: MoECfg):
    """The routing of x (G, T, d): float32 ``probs`` (G, T, E), renormalised
    ``gate_vals`` and ``gate_idx`` (G, T, k), each (token, choice)'s slot
    ``pos`` in its expert's buffer (G, T, k) and ``keep = pos < C``."""
    G, T, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ p.router.w                                 # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)              # (G, T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # slot = how many earlier (choice-major, token) entries of the group
    # chose the same expert
    idx_f = gate_idx.transpose(1, 2).reshape(G, k * T)               # choice-major
    oh = _one_hot(idx_f, E, torch.int64)                             # (G, kT, E)
    before = (torch.cumsum(oh, dim=1) - oh).gather(2, idx_f[..., None])[..., 0]
    pos = before.reshape(G, k, T).transpose(1, 2)                    # (G, T, k)
    return probs, gate_vals, gate_idx, pos, pos < moe_capacity(T, cfg)


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoECfg, *,
              mlp_kind: str = "swiglu"):
    """x: (G, T, d) -> (G, T, d) plus the aux load-balancing loss (a float32
    scalar; on a mesh, this rank's share of it).  G (batch rows) are the
    routing groups."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(T, cfg)
    probs, gate_vals, gate_idx, pos, keep = _route(p, x, cfg)

    # dispatch: slot (e, g, c) of an (E, G, C) buffer, a dropped entry to
    # one spare row past the end (written, never read)
    g_idx = torch.arange(G, device=x.device)[:, None, None]
    slot = torch.where(keep, (gate_idx * G + g_idx) * C + pos, E * G * C)
    rows = x[:, :, None, :].expand(G, T, k, d).reshape(G * T * k, d)
    xe = x.new_zeros((E * G * C + 1, d)).index_copy_(0, slot.reshape(-1), rows)
    xe = xe[:-1].view(E, G * C, d)
    if mlp_kind == "swiglu":
        h = F.silu(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wu)
    else:
        h = F.gelu(torch.bmm(xe, p.wu), approximate="tanh")
    ye = torch.bmm(h, p.wd).view(E * G * C, d)

    # combine: each token's kept slots weighted by its gates (in x's dtype,
    # as the reference casts them), a dropped entry reading a zero row
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    picked = ye[slot.reshape(-1)].view(G, T, k, d)
    gates = gate_vals.to(x.dtype)
    y = (picked.float() * gates.float()[..., None]).sum(2).to(x.dtype)

    if p.shared is not None:
        y = y + apply_mlp(p.shared, x, kind=mlp_kind)

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e, f_e over the
    # first choice only.  On a mesh whose data ranks each hold their own
    # rows, f_e is the mean over all of them and P_e this rank's share of
    # it (aux is linear in P_e): the shares sum to the whole batch's aux.
    frac_tokens = sharding.data_mean(
        _one_hot(gate_idx[..., 0], E, torch.float32).mean((0, 1)))
    frac_probs = probs.mean((0, 1))
    if sharding.data_ranks() > 1:
        frac_probs = frac_probs / sharding.data_ranks()
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
