"""Generic LM assembly for every architecture family of the registry.

Counterpart of ``repro.models.transformer``:

* dense / moe / vlm / audio: transformer layers (GQA or MLA attention, an
  MLP or an MoE block) in an ``nn.ModuleList`` ``layers``, run one after the
  other where the reference scans over stacked layers.  The cache keeps the
  reference's stacked layout, each of the layer cache's tensors with a
  leading n_layers axis (GQA's ``k`` and ``v`` of (n_layers, B, max_len, KV,
  hd), MLA's ``ckv`` and ``krope`` of (n_layers, B, max_len, ·)).
* ssm (xLSTM): ``blocks``, pre-norm mLSTM / sLSTM blocks with a residual;
  the cache is a list of one state dict a block.
* hybrid (Zamba2): ``mamba``, n_groups x g Mamba2 blocks (the last group
  padded to g; its padded blocks hold parameters, as the reference's
  stacked tree does, but are not run), and ``shared``, one attention + MLP
  block applied at the start of every group with its own KV cache per
  group.  The cache is ``{"attn": {k, v} (n_groups, B, max_len, KV, hd),
  "mamba": {conv, ssm} (n_groups, g, B, ...)}``.

Every cache is updated in place.  The model is an ``nn.Module``
(``TransformerLM``, whatever the family).

Entry points, as in the reference, with the parameters being the module:

    init_params(gen, cfg, device=)               -> TransformerLM
    forward(params, batch, cfg, remat=)          -> (hidden, aux)
    loss_fn(params, batch, cfg)                  -> (loss, metrics)
    init_cache(cfg, batch, max_len, device=)
    prefill(params, batch, cfg, cache)           -> (last_logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

``remat=True`` recomputes each transformer layer and each hybrid group in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does; so does every vocabulary chunk of ``loss_fn``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (Dense, Embed, MLP, Norm, _weight,
                                       apply_mlp, apply_norm, dense)
from repro_torch.models.sharding import constrain_batch

__all__ = ["init_params", "loss_fn", "init_cache", "prefill", "decode_step",
           "forward", "Q_CHUNK", "TransformerLM"]

Q_CHUNK = 512  # query-chunk for causal attention (memory bound at 32k)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


TF_FAMILIES = ("dense", "moe", "vlm", "audio")


def _maybe_remat(fn, remat: bool):
    """``fn``, recomputed in the backward pass instead of saving its
    intermediates when ``remat`` and autograd is recording."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


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
    return constrain_batch(x + f), new_cache, aux


def _layer_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    if cfg.mla is not None:
        return attn.mla_init_cache(batch, max_len, cfg.mla.kv_lora_rank,
                                   cfg.mla.qk_rope_dim, _dt(cfg), device)
    return attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, _dt(cfg),
                               device)


# ---------------------------------------------------------------------------
# xLSTM stack
# ---------------------------------------------------------------------------

def _xlstm_block_kinds(cfg: ArchConfig) -> list[str]:
    k = cfg.xlstm.slstm_every
    return ["slstm" if (i % k == k - 1) else "mlstm" for i in range(cfg.n_layers)]


class XLSTMBlock(nn.Module):
    """Pre-norm ``ln`` and the ``core``: an mLSTM or an sLSTM."""

    def __init__(self, kind: str, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.kind = kind
        self.ln = Norm(cfg.d_model, cfg.norm, device=device)
        core = xlstm_mod.MLSTM if kind == "mlstm" else xlstm_mod.SLSTM
        self.core = core(cfg.d_model, cfg.n_heads, cfg.hd, _dt(cfg), device, gen)


def _apply_xlstm(params: "TransformerLM", x, cfg: ArchConfig, caches=None):
    """Each block in turn, on its own state dict of ``caches`` (written in
    place).  Returns (x, caches)."""
    for i, blk in enumerate(params.blocks):
        h = apply_norm(blk.ln, x, cfg.norm)
        c = caches[i] if caches is not None else None
        if blk.kind == "mlstm":
            o, _ = xlstm_mod.mlstm_apply(blk.core, h, n_heads=cfg.n_heads,
                                         hd=cfg.hd, chunk=cfg.xlstm.chunk, cache=c)
        else:
            o, _ = xlstm_mod.slstm_apply(blk.core, h, n_heads=cfg.n_heads,
                                         hd=cfg.hd, cache=c)
        x = constrain_batch(x + o)
    return x, caches


# ---------------------------------------------------------------------------
# hybrid (Zamba2): Mamba2 groups + a shared attention block
# ---------------------------------------------------------------------------

def _hybrid_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(g blocks a group, n_groups), the last group padded to g."""
    g = cfg.hybrid.shared_attn_every
    return g, -(-cfg.n_layers // g)


def _hybrid_valid(cfg: ArchConfig) -> list[list[bool]]:
    """valid[group][j]: whether block j of the group is one of the n_layers
    (the rest pad the last group)."""
    g, n_groups = _hybrid_layout(cfg)
    return [[gi * g + j < cfg.n_layers for j in range(g)] for gi in range(n_groups)]


class SharedBlock(nn.Module):
    """The hybrid's one attention + MLP block: ``ln``, ``attn`` (GQA),
    ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, dt = cfg.d_model, _dt(cfg)
        self.ln = Norm(d, cfg.norm, device=device)
        self.attn = attn.GQA(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype=dt,
                             device=device, gen=gen)
        self.ln2 = Norm(d, cfg.norm, device=device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dtype=dt, device=device, gen=gen)


def _apply_hybrid(params: "TransformerLM", x, cfg: ArchConfig, caches=None,
                  pos0: int = 0, q_chunk: int | None = Q_CHUNK,
                  remat: bool = False):
    """Per group: the shared block (pre-norm attention + MLP, on the group's
    KV cache), then the group's Mamba2 blocks with no pre-norm, each adding
    its output; a padded block is skipped (x and its cache pass unchanged,
    where the reference computes it and selects the old values; its
    parameters get no gradient, the reference's zeros).  ``remat``
    recomputes each group in the backward pass (without a cache only).
    Returns (x, caches)."""
    valid = _hybrid_valid(cfg)
    group = _maybe_remat(_hybrid_group, remat and caches is None)
    for gi in range(len(params.mamba)):
        x = group(params, x, cfg, caches, gi, valid[gi], pos0, q_chunk)
    return x, caches


def _hybrid_group(params: "TransformerLM", x, cfg: ArchConfig, caches,
                  gi: int, valid: list[bool], pos0: int,
                  q_chunk: int | None):
    """Group ``gi`` of ``_apply_hybrid``: returns x."""
    shared, group = params.shared, params.mamba[gi]
    h = apply_norm(shared.ln, x, cfg.norm)
    ac = ({name: t[gi] for name, t in caches["attn"].items()}
          if caches is not None else None)
    a, _ = attn.gqa_apply(shared.attn, h, n_heads=cfg.n_heads,
                          n_kv=cfg.n_kv_heads, hd=cfg.hd,
                          rope_mode=cfg.rope_mode, rope_theta=cfg.rope_theta,
                          causal=True, q_chunk=q_chunk, cache=ac, pos0=pos0)
    x = x + a
    x = constrain_batch(
        x + apply_mlp(shared.mlp, apply_norm(shared.ln2, x, cfg.norm),
                      kind=cfg.mlp))
    for j, block in enumerate(group):
        if not valid[j]:
            continue
        mc = ({name: t[gi, j] for name, t in caches["mamba"].items()}
              if caches is not None else None)
        o, _ = ssm_mod.mamba2_apply(block, x, cfg.ssm, cache=mc)
        x = constrain_batch(x + o)
    return x


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (unless tied), for audio
    ``mask_embed``, and the family's stack: ``layers`` (a ``ModuleList``
    where the reference stacks), ``blocks`` (xLSTM), or ``mamba`` (a
    ``ModuleList`` of n_groups ``ModuleList``s of g) and ``shared``
    (hybrid) — the reference's parameter tree."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dt = _dt(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, device, gen)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab, dtype=dt, device=device,
                              gen=gen))
        if cfg.family in TF_FAMILIES:
            self.layers = nn.ModuleList(_init_tf_layer(gen, cfg, device)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.blocks = nn.ModuleList(XLSTMBlock(kind, cfg, device, gen)
                                        for kind in _xlstm_block_kinds(cfg))
        elif cfg.family == "hybrid":
            g, n_groups = _hybrid_layout(cfg)
            self.mamba = nn.ModuleList(
                nn.ModuleList(ssm_mod.Mamba2(cfg.d_model, cfg.ssm, dt, device, gen)
                              for _ in range(g))
                for _ in range(n_groups))
            self.shared = SharedBlock(cfg, device, gen)
        else:
            raise ValueError(cfg.family)
        self.mask_embed = (_weight((cfg.d_model,), 0.02, dt, device, gen)
                           if cfg.modality == "audio" else None)

    def forward(self, batch: dict[str, torch.Tensor]):
        return forward(self, batch, self.cfg)


def stacked_leaf(name: str, cfg: ArchConfig):
    """Where parameter ``name`` lives in the reference's parameter tree: (the
    leaf's path of keys, the index into its stacked leading axes, those
    axes).  Transformer layers are stacked on one axis, the hybrid's Mamba2
    blocks on (n_groups, g); the xLSTM's ``blocks`` are a list (their index
    stays in the path)."""
    stacked = {"layers": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        g, n_groups = _hybrid_layout(cfg)
        stacked["mamba"] = (n_groups, g)
    parts = tuple(name.split("."))
    lead = stacked.get(parts[0], ())
    return (parts[:1] + parts[1 + len(lead):],
            tuple(int(i) for i in parts[1:1 + len(lead)]), lead)


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
            remat: bool = False, q_chunk: int | None = Q_CHUNK):
    """Full-sequence forward (train / encoder / prefill-style).  Returns
    (hidden (B,T,d), aux_loss); non-causal for encoder-only configs.
    ``remat`` recomputes each transformer layer and each hybrid group in the
    backward pass (the xLSTM stack is not rematerialised, as in the
    reference)."""
    x = constrain_batch(_embed_inputs(params, batch, cfg))
    causal = not cfg.encoder_only
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in TF_FAMILIES:
        def body(layer, x):
            x, _, a = _apply_tf_layer(layer, x, cfg, causal=causal, q_chunk=q_chunk)
            return x, a
        body = _maybe_remat(body, remat)
        for layer in params.layers:
            x, a = body(layer, x)
            aux = aux + a
    elif cfg.family == "ssm":
        x, _ = _apply_xlstm(params, x, cfg)
    else:
        x, _ = _apply_hybrid(params, x, cfg, q_chunk=q_chunk, remat=remat)
    return apply_norm(params.final_norm, x, cfg.norm), aux


def logits_fn(params: TransformerLM, hidden, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return hidden @ params.embed.table.T
    return dense(params.lm_head, hidden)


def _chunk_ce(h: torch.Tensor, t: torch.Tensor, head: torch.Tensor):
    """(the summed cross-entropy of rows ``h`` against targets ``t`` over
    the float32 logits ``h @ head``, the number of valid targets ``t >=
    0``); a target of -1 adds nothing."""
    lg = (h @ head).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, torch.clamp(t, min=0)[:, None].long())[:, 0]
    valid = t >= 0
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def loss_fn(params: TransformerLM, batch, cfg: ArchConfig, *,
            remat: bool = True, vocab_chunk: int | None = 512,
            q_chunk: int | None = Q_CHUNK):
    """Causal-LM CE (decoder) or masked-prediction CE (encoder), averaged
    over the valid targets (``t >= 0``, at least 1), plus ``0.01·aux``.
    Returns (loss, {"ce", "aux", "tokens"}).

    The vocabulary projection and the CE run over chunks of ``vocab_chunk``
    rows of the flattened (B·T) positions (``None``: one chunk), each
    recomputed in the backward pass, so the (chunk, V) float32 logits are
    never all held at once.  The last chunk is short where the reference
    pads it with rows of target -1, which add nothing.  For vision the
    patch positions get target -1."""
    hidden, aux = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk)
    targets = batch["targets"]
    if cfg.modality == "vision":
        pad = targets.new_full(tuple(batch["patches"].shape[:2]), -1)
        targets = torch.cat([pad, targets], dim=1)
    B, T, d = hidden.shape
    head = params.embed.table.T if cfg.tie_embeddings else params.lm_head.w
    hidden2 = constrain_batch(hidden.reshape(B * T, d))
    tflat = targets.reshape(B * T)
    chunk = B * T if vocab_chunk is None else vocab_chunk
    ce = _maybe_remat(_chunk_ce, True)
    sums, counts = zip(*(ce(hidden2[i:i + chunk], tflat[i:i + chunk], head)
                         for i in range(0, B * T, chunk)))
    count = torch.stack(counts).sum()
    loss = torch.stack(sums).sum() / torch.clamp(count, min=1)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux, "tokens": count}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _stacked(one: dict[str, torch.Tensor], lead: tuple[int, ...]) -> dict:
    """Zeros of ``one``'s tensors under the leading axes ``lead``."""
    return {name: t.new_zeros(lead + t.shape) for name, t in one.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """The empty cache of ``cfg``'s family (module docstring); an xLSTM's
    state does not grow with ``max_len``."""
    if cfg.family in TF_FAMILIES:
        return _stacked(_layer_cache(cfg, batch, max_len, device), (cfg.n_layers,))
    if cfg.family == "ssm":
        return [xlstm_mod.mlstm_init_cache(batch, cfg.n_heads, cfg.hd, device)
                if k == "mlstm" else
                xlstm_mod.slstm_init_cache(batch, cfg.n_heads, cfg.hd, device)
                for k in _xlstm_block_kinds(cfg)]
    if cfg.family == "hybrid":
        g, n_groups = _hybrid_layout(cfg)
        kv = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, _dt(cfg),
                                 device)
        state = ssm_mod.mamba2_init_cache(batch, cfg.d_model, cfg.ssm, device=device)
        return {"attn": _stacked(kv, (n_groups,)),
                "mamba": _stacked(state, (n_groups, g))}
    raise ValueError(cfg.family)


def _stacked_layer_step(params: TransformerLM, x, cfg: ArchConfig, caches,
                        pos0: int, q_chunk: int | None):
    """Run the layers in turn, each on its slice of the stacked cache (a view:
    the writes land in ``caches``)."""
    for i, layer in enumerate(params.layers):
        c = {name: t[i] for name, t in caches.items()}
        x, _, _ = _apply_tf_layer(layer, x, cfg, cache=c, pos0=pos0,
                                  q_chunk=q_chunk)
    return x, caches


def _cached_step(params: TransformerLM, x, cfg: ArchConfig, cache, pos0: int,
                 q_chunk: int | None):
    """The family's stack over ``x`` from position ``pos0``, on ``cache``."""
    if cfg.family in TF_FAMILIES:
        return _stacked_layer_step(params, x, cfg, cache, pos0, q_chunk)
    if cfg.family == "ssm":
        return _apply_xlstm(params, x, cfg, caches=cache)
    return _apply_hybrid(params, x, cfg, caches=cache, pos0=pos0, q_chunk=q_chunk)


def prefill(params: TransformerLM, batch, cfg: ArchConfig, cache, *,
            q_chunk: int | None = Q_CHUNK):
    """Process the prompt, filling the cache from position 0.  Returns
    (last-position logits, cache)."""
    x = _embed_inputs(params, batch, cfg)
    x, cache = _cached_step(params, x, cfg, cache, 0, q_chunk)
    h = apply_norm(params.final_norm, x[:, -1:], cfg.norm)
    return logits_fn(params, h, cfg)[:, 0], cache


def decode_step(params: TransformerLM, cache, tokens, pos, cfg: ArchConfig):
    """One decode step: tokens (B,) int32, pos the current length (an int).
    Returns (logits (B, V), cache)."""
    x = _embed_inputs(params, {"tokens": tokens[:, None]}, cfg)
    x, cache = _cached_step(params, x, cfg, cache, int(pos), None)
    h = apply_norm(params.final_norm, x, cfg.norm)
    return logits_fn(params, h, cfg)[:, 0], cache
