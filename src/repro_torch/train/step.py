"""train_step / serve_step builders (counterpart of ``repro.train.step``).

train_step: microbatched gradient accumulation in float32, global-norm
clip, AdamW, cosine-warmup schedule, optional error-feedback gradient
compression (int8 or top-k, applied to the accumulated gradient as a
cross-group reduction would see it).  It runs eagerly on one device: the
parameters are the ``TransformerLM`` module, updated in place with the
moments and residuals; ``grad_shardings`` (a mesh's gradient layout) comes
with the trainer on a mesh, ROADMAP M11d-b.

serve_step: one decode token against the KV cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, TrainCfg
from repro_torch.models import transformer as model
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import error_feedback_update
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["TrainState", "init_train_state", "make_train_step", "make_serve_step"]


class TrainState(NamedTuple):
    params: model.TransformerLM
    opt: OptState
    residual: dict  # error-feedback residuals by parameter name ({} when off)


def init_train_state(gen: torch.Generator, cfg: ArchConfig, tcfg: TrainCfg,
                     device=None) -> TrainState:
    """The model drawn from ``gen`` (a generator on ``device``; ``None``: the
    CUDA device), zero float32 moments, and zero float32 residuals when
    ``tcfg.grad_compress`` is on."""
    params = model.init_params(gen, cfg, device=device)
    opt = adamw_init(params)
    residual = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.named_parameters()}
                if tcfg.grad_compress != "none" else {})
    return TrainState(params, opt, residual)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i is rows [i·b/n, (i+1)·b/n) of every tensor (views)."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by microbatches {n}")
        for i, part in enumerate(torch.split(x, b // n)):
            out[i][k] = part
    return out


def _compress(grads: dict, residual: dict, params: dict, cfg: ArchConfig,
              codec: str) -> None:
    """Error-feedback compression of ``grads`` with ``residual`` (both by
    parameter name, updated in place; a ``None`` gradient is zeros).  The
    codec sees the reference's leaves: the parameters a stacked leaf holds
    (every layer's, every Mamba2 block's) are compressed together, with one
    int8 scale and one top-k over all of them."""
    groups: dict[tuple, list[str]] = {}
    for name in params:
        groups.setdefault(model.stacked_leaf(name, cfg)[0], []).append(name)
    for names in groups.values():
        g = [torch.zeros(params[k].shape, dtype=torch.float32,
                         device=params[k].device) if grads[k] is None else grads[k]
             for k in names]
        dec, new_r = error_feedback_update(
            torch.stack(g), torch.stack([residual[k] for k in names]), codec=codec)
        for k, d, nr in zip(names, dec, new_r):
            grads[k], residual[k] = d, nr


def make_train_step(cfg: ArchConfig, tcfg: TrainCfg, grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss`` (the microbatches' mean), ``lr``, ``grad_norm`` (0-d tensors).

    Each microbatch's gradients come from ``torch.autograd.grad`` and are
    added into float32 buffers (``.grad`` would sum them in the parameter's
    dtype); a parameter the loss does not reach has a zero gradient.  The
    sum is divided by the microbatch count, compressed with error feedback
    over the reference's leaves when ``tcfg.grad_compress`` is on
    (``_compress``), then clipped and applied by ``adamw_update`` at
    ``cosine_warmup(opt.step)``.  The state's module, moments and residuals
    are updated in place."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings lays gradients out over a mesh; the trainer on a "
            "mesh is ROADMAP M11d-b")

    def train_step(state: TrainState, batch):
        params = state.params
        names, plist = zip(*params.named_parameters())
        nmb = tcfg.microbatches
        gsum: list[torch.Tensor | None] = [None] * len(plist)
        lsum = None
        with torch.enable_grad():
            for mb in _split_microbatches(batch, nmb):
                loss, _ = model.loss_fn(params, mb, cfg, remat=tcfg.remat)
                grads = torch.autograd.grad(loss, plist, allow_unused=True)
                for i, g in enumerate(grads):
                    if g is None:
                        continue
                    if gsum[i] is None:
                        gsum[i] = g.to(torch.float32, copy=True)
                    else:
                        gsum[i].add_(g)
                loss = loss.detach()
                lsum = loss if lsum is None else lsum + loss
                del grads
        grads = {k: None if g is None else g.div_(nmb) for k, g in zip(names, gsum)}

        residual = state.residual
        if tcfg.grad_compress != "none":
            _compress(grads, residual, dict(zip(names, plist)), cfg,
                      tcfg.grad_compress)

        lr = cosine_warmup(state.opt.step, lr=tcfg.lr, warmup=tcfg.warmup,
                           total=tcfg.total_steps)
        params, opt, om = adamw_update(grads, state.opt, params, tcfg, lr)
        metrics = {"loss": lsum / nmb, "lr": lr, **om}
        return TrainState(params, opt, residual), metrics

    return train_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens (B,), pos) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, cfg)
    return serve_step
