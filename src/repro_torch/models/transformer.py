"""LM assembly for the transformer-layer families: dense, moe, vlm and audio.

Counterpart of ``repro.models.transformer`` for the configs of transformer
layers: GQA or MLA attention, an MLP or an MoE block (the ``ssm``/``hybrid``
families come with ROADMAP M11c and raise ``NotImplementedError`` here).
The model is an ``nn.Module`` (``TransformerLM``) whose layers are an
``nn.ModuleList``, run one after the other where the reference scans over
stacked layers.  The cache keeps the reference's stacked layout, each of the
layer cache's tensors with a leading n_layers axis (GQA's ``k`` and ``v`` of
(n_layers, B, max_len, KV, hd), MLA's ``ckv`` and ``krope`` of (n_layers, B,
max_len, ·)), and is updated in place.

Entry points, as in the reference, with the parameters being the module:

    init_params(gen, cfg, device=)               -> TransformerLM
    forward(params, batch, cfg)                  -> (hidden, aux)
    init_cache(cfg, batch, max_len, device=)
    prefill(params, batch, cfg, cache)           -> (last_logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

Training (``loss_fn``, remat) comes with ROADMAP M11d.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (Dense, Embed, MLP, Norm, _weight,
                                       apply_mlp, apply_norm, dense)

__all__ = ["init_params", "init_cache", "prefill", "decode_step", "forward",
           "Q_CHUNK", "TransformerLM"]

Q_CHUNK = 512  # query-chunk for causal attention (memory bound at 32k)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg: ArchConfig) -> None:
    """Only the transformer-layer families are here."""
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family (xLSTM / Zamba2 blocks) is "
            "not ported yet (ROADMAP Queue 1, M11c)")


# ---------------------------------------------------------------------------
# transformer layer
# ---------------------------------------------------------------------------

class TransformerLayer(nn.Module):
    """Pre-norm attention + feed-forward: ``ln1``, ``attn`` (MLA when the
    config has ``mla``, else GQA), ``ln2``, and ``moe`` when the config has
    experts, else ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, dt = cfg.d_model, _dt(cfg)
        self.ln1 = Norm(d, cfg.norm, device=device)
        self.ln2 = Norm(d, cfg.norm, device=device)
        if cfg.mla is not None:
            m = cfg.mla
            self.attn = attn.MLA(d, cfg.n_heads, kv_lora=m.kv_lora_rank,
                                 nope=m.qk_nope_dim, rope=m.qk_rope_dim,
                                 v_dim=m.v_head_dim, dtype=dt, device=device,
                                 gen=gen)
        else:
            self.attn = attn.GQA(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 bias=cfg.qkv_bias, dtype=dt, device=device,
                                 gen=gen)
        if cfg.moe is not None:
            self.moe = moe_mod.MoE(d, cfg.moe, mlp_kind=cfg.mlp, dtype=dt,
                                   device=device, gen=gen)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dtype=dt, device=device, gen=gen)


def _init_tf_layer(gen, cfg: ArchConfig, device=None) -> TransformerLayer:
    return TransformerLayer(cfg, device, gen)


def _apply_tf_layer(p: TransformerLayer, x, cfg: ArchConfig, *, cache=None,
                    pos0: int = 0, causal: bool = True,
                    q_chunk: int | None = Q_CHUNK):
    """Returns (x, cache, aux): aux is the MoE block's load-balancing loss
    (0.0 without experts)."""
    h = apply_norm(p.ln1, x, cfg.norm)
    if cfg.mla is not None:
        m = cfg.mla
        a, new_cache = attn.mla_apply(p.attn, h, n_heads=cfg.n_heads,
                                      kv_lora=m.kv_lora_rank, nope=m.qk_nope_dim,
                                      rope=m.qk_rope_dim, v_dim=m.v_head_dim,
                                      rope_theta=cfg.rope_theta, q_chunk=q_chunk,
                                      cache=cache, pos0=pos0)
    else:
        a, new_cache = attn.gqa_apply(p.attn, h, n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, hd=cfg.hd,
                                      rope_mode=cfg.rope_mode,
                                      rope_theta=cfg.rope_theta, causal=causal,
                                      q_chunk=q_chunk, cache=cache, pos0=pos0)
    x = x + a
    h = apply_norm(p.ln2, x, cfg.norm)
    if cfg.moe is not None:
        f, aux = moe_mod.moe_apply(p.moe, h, cfg.moe, mlp_kind=cfg.mlp)
    else:
        f, aux = apply_mlp(p.mlp, h, kind=cfg.mlp), 0.0
    return x + f, new_cache, aux


def _layer_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    if cfg.mla is not None:
        return attn.mla_init_cache(batch, max_len, cfg.mla.kv_lora_rank,
                                   cfg.mla.qk_rope_dim, _dt(cfg), device)
    return attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, _dt(cfg),
                               device)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (unless tied), ``layers`` and,
    for audio, ``mask_embed`` — the reference's parameter tree, with the
    stacked layers as a ``ModuleList``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        _check_family(cfg)
        device = resolve_device(device)
        dt = _dt(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, device, gen)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab, dtype=dt, device=device,
                              gen=gen))
        self.layers = nn.ModuleList(_init_tf_layer(gen, cfg, device)
                                    for _ in range(cfg.n_layers))
        self.mask_embed = (_weight((cfg.d_model,), 0.02, dt, device, gen)
                           if cfg.modality == "audio" else None)

    def forward(self, batch: dict[str, torch.Tensor]):
        return forward(self, batch, self.cfg)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device=None) -> TransformerLM:
    """The model with weights drawn from ``gen`` (a generator on ``device``)
    at the reference's scales; the reference's PRNG stream is not
    reproduced."""
    return TransformerLM(cfg, device, gen)


def _embed_inputs(params: TransformerLM, batch, cfg: ArchConfig):
    """Token / frame / patch embeddings."""
    dt = _dt(cfg)
    if cfg.modality == "audio":
        x = batch["features"].to(dt)
        if "mask" in batch:
            m = batch["mask"][..., None]
            x = torch.where(m, params.mask_embed[None, None, :], x)
        return x
    tok = params.embed(batch["tokens"])
    if cfg.modality == "vision" and "patches" in batch:
        return torch.cat([batch["patches"].to(dt), tok], dim=1)
    return tok


def forward(params: TransformerLM, batch, cfg: ArchConfig, *,
            q_chunk: int | None = Q_CHUNK):
    """Full-sequence forward (encoder / prefill-style).  Returns
    (hidden (B,T,d), aux_loss); non-causal for encoder-only configs."""
    x = _embed_inputs(params, batch, cfg)
    causal = not cfg.encoder_only
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, _, a = _apply_tf_layer(layer, x, cfg, causal=causal, q_chunk=q_chunk)
        aux = aux + a
    return apply_norm(params.final_norm, x, cfg.norm), aux


def logits_fn(params: TransformerLM, hidden, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return hidden @ params.embed.table.T
    return dense(params.lm_head, hidden)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """The layer cache's tensors stacked on a leading n_layers axis, zeros."""
    _check_family(cfg)
    one = _layer_cache(cfg, batch, max_len, device)
    return {name: t.new_zeros((cfg.n_layers,) + t.shape) for name, t in one.items()}


def _stacked_layer_step(params: TransformerLM, x, cfg: ArchConfig, caches,
                        pos0: int, q_chunk: int | None):
    """Run the layers in turn, each on its slice of the stacked cache (a view:
    the writes land in ``caches``)."""
    for i, layer in enumerate(params.layers):
        c = {name: t[i] for name, t in caches.items()}
        x, _, _ = _apply_tf_layer(layer, x, cfg, cache=c, pos0=pos0,
                                  q_chunk=q_chunk)
    return x, caches


def prefill(params: TransformerLM, batch, cfg: ArchConfig, cache, *,
            q_chunk: int | None = Q_CHUNK):
    """Process the prompt, filling the cache from position 0.  Returns
    (last-position logits, cache)."""
    x = _embed_inputs(params, batch, cfg)
    x, cache = _stacked_layer_step(params, x, cfg, cache, 0, q_chunk)
    h = apply_norm(params.final_norm, x[:, -1:], cfg.norm)
    return logits_fn(params, h, cfg)[:, 0], cache


def decode_step(params: TransformerLM, cache, tokens, pos, cfg: ArchConfig):
    """One decode step: tokens (B,) int32, pos the current length (an int).
    Returns (logits (B, V), cache)."""
    x = _embed_inputs(params, {"tokens": tokens[:, None]}, cfg)
    x, cache = _stacked_layer_step(params, x, cfg, cache, int(pos), None)
    h = apply_norm(params.final_norm, x, cfg.norm)
    return logits_fn(params, h, cfg)[:, 0], cache
