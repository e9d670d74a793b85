"""Shared model layers: norms, RoPE variants, MLPs, embeddings.

Counterpart of ``repro.models.layers``.  Each layer is an ``nn.Module``
whose parameters carry the reference's names (``w``/``b``, ``scale``/
``bias``, ``wg``/``wu``/``wd``, ``table``); the reference's functions stay
as thin functions over the modules (``dense(p, x)``, ``apply_norm(p, x)``,
...).  The ``*_init`` functions draw from an explicit ``torch.Generator`` with
the reference's scales (normal / sqrt(d_in), embeddings normal * 0.02, zero
biases, unit norm scales); without one the weights are left unset for a
loader to fill (``repro_torch.convert.lm_params_from_arrays``).  Compute
dtype is the model's (bf16 by default) with f32 norms, RoPE and softmax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch._device import resolve_device

__all__ = [
    "dense_init", "dense", "norm_init", "apply_norm", "rope_freqs",
    "apply_rope", "mlp_init", "apply_mlp", "embed_init",
    "Dense", "Norm", "MLP", "Embed",
]


def _weight(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
            device, gen: torch.Generator | None) -> nn.Parameter:
    """``normal(shape) * scale`` drawn in f32 from ``gen`` and cast to
    ``dtype``; left unset without a generator."""
    device = resolve_device(device)
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(generator=gen)
    return nn.Parameter((w * scale).to(dtype))


def _chunk_len(chunk: int, T: int, what: str) -> int:
    """``min(chunk, T)``, which must divide T (the reference asserts)."""
    Lc = min(chunk, T)
    if T % Lc:
        raise ValueError(f"sequence of {T} must divide by {what} chunk {Lc}")
    return Lc


def _store(cache: dict[str, torch.Tensor], new: dict[str, torch.Tensor]) -> None:
    """Write each of ``new`` into ``cache`` in place."""
    for name, value in new.items():
        cache[name].copy_(value)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` of shape (d_in, d_out), as the reference."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 scale: float | None = None, dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        scale = float(1.0 / np.sqrt(d_in)) if scale is None else float(scale)
        self.w = _weight((d_in, d_out), scale, dtype, device, gen)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=self.w.device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, dtype=torch.bfloat16,
               device=None) -> Dense:
    return Dense(d_in, d_out, bias=bias, scale=scale, dtype=dtype,
                 device=device, gen=gen)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), f32 parameters."""

    def __init__(self, d: int, kind: str = "rmsnorm", dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
                     if kind == "layernorm" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self, x, self.kind)


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None) -> Norm:
    return Norm(d, kind, dtype, device)


def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to ``x``'s dtype; the layernorm is hand-rolled as
    mean and variance, as in the reference."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p.scale
    return out.to(x.dtype)


def rope_freqs(hd: int, mode: str, theta: float = 10000.0) -> tuple[int, np.ndarray]:
    """Return (n_rot, inv_freq) — how many leading dims of the head get
    rotated and their inverse frequencies (numpy float32, as the reference).

    mode: 'full' (all dims), 'half' (chatglm-style 2d rope: first half),
    'partial25' (stablelm-style: first quarter), 'none'.
    """
    frac = {"full": 1.0, "half": 0.5, "partial25": 0.25, "none": 0.0}[mode]
    n_rot = int(hd * frac) // 2 * 2
    if n_rot == 0:
        return 0, np.zeros((0,), np.float32)
    inv = 1.0 / (theta ** (np.arange(0, n_rot, 2, dtype=np.float32) / n_rot))
    return n_rot, inv


@functools.lru_cache(maxsize=32)
def _inv_freq(hd: int, mode: str, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs``' float32 table on ``device``, copied there once: a
    real tensor even under a ``FakeTensorMode`` (the dry-run), so that the
    cache never hands one mode's fake tensor to a later step."""
    with unset_fake_temporarily():
        return torch.from_numpy(rope_freqs(hd, mode, theta)[1]).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, mode: str,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  Rotates
    interleaved pairs (dims 0::2 with 1::2) of the first ``n_rot`` dims in
    f32."""
    hd = x.shape[-1]
    n_rot, _ = rope_freqs(hd, mode, theta)
    if n_rot == 0:
        return x
    inv = _inv_freq(hd, mode, theta, x.device)
    ang = positions[..., :, None].float() * inv        # (..., T, n_rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :n_rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, x[..., n_rot:]], dim=-1)


class MLP(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or GELU (``wu``, ``wd``)."""

    def __init__(self, d: int, d_ff: int, kind: str = "swiglu",
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.kind = kind
        if kind == "swiglu":
            self.wg = Dense(d, d_ff, dtype=dtype, device=device, gen=gen)
        self.wu = Dense(d, d_ff, dtype=dtype, device=device, gen=gen)
        self.wd = Dense(d_ff, d, dtype=dtype, device=device, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x, self.kind)


def mlp_init(gen, d: int, d_ff: int, kind: str = "swiglu",
             dtype=torch.bfloat16, device=None) -> MLP:
    return MLP(d, d_ff, kind, dtype, device, gen)


def apply_mlp(p: MLP, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation by default, and so is this."""
    if kind == "swiglu":
        return dense(p.wd, F.silu(dense(p.wg, x)) * dense(p.wu, x))
    return dense(p.wd, F.gelu(dense(p.wu, x), approximate="tanh"))


class Embed(nn.Module):
    """The (vocab, d) token table."""

    def __init__(self, vocab: int, d: int, dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.table = _weight((vocab, d), 0.02, dtype, device, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()]


def embed_init(gen, vocab: int, d: int, dtype=torch.bfloat16,
               device=None) -> Embed:
    return Embed(vocab, d, dtype, device, gen)
