"""train_step / serve_step builders (counterpart of ``repro.train.step``).

train_step: microbatched gradient accumulation in float32, global-norm
clip, AdamW, cosine-warmup schedule, optional error-feedback gradient
compression (int8 or top-k, applied to the accumulated gradient as a
cross-group reduction would see it).  It runs eagerly: the parameters are
the ``TransformerLM`` module, updated in place with the moments and
residuals, on one device or, as DTensors, on a ("data", "model") mesh
(``make_train_step``).

serve_step: one decode token against the KV cache.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement

from repro_torch.configs.base import ArchConfig, TrainCfg
from repro_torch.models import sharding
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
    ``tcfg.grad_compress`` is on; each moment and residual is laid out as
    its parameter (``runtime.elastic.reshard`` puts the state on a mesh)."""
    params = model.init_params(gen, cfg, device=device)
    opt = adamw_init(params)
    residual = ({k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.named_parameters()}
                if tcfg.grad_compress != "none" else {})
    return TrainState(params, opt, residual)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i is rows [i·b/n, (i+1)·b/n) of every tensor of the global
    batch (views)."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by microbatches {n}")
        for i, part in enumerate(torch.split(x, b // n)):
            out[i][k] = part
    return out


def _mesh_of(tensors) -> DeviceMesh | None:
    """The mesh of the first DTensor of ``tensors`` (None: one device)."""
    return next((t.device_mesh for t in tensors if isinstance(t, DTensor)), None)


def _own_rows(mb: dict, mesh: DeviceMesh) -> dict:
    """This rank's rows of a whole microbatch, laid out by the reference's
    batch specs on ``mesh`` (the rows split over the data axes, the same
    on every rank of the others)."""
    specs = sharding.sanitize_pspecs(sharding.batch_pspecs(mb), mb, mesh)
    data = sharding.data_ranks()
    out = {}
    for k, x in mb.items():
        if data > 1 and specs[k][0] is None:
            raise ValueError(f"a microbatch of {x.shape[0]} rows does not "
                             f"split over {data} data ranks")
        out[k] = sharding.local_block(x, mesh, sharding.placements(specs[k], mesh))
    return out


def _sum_over_data(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` (a plain tensor each rank holds) summed over the data ranks."""
    for i, axis in enumerate(mesh.mesh_dim_names):
        if axis in sharding.DATA_AXES and mesh.size(i) > 1:
            dist.all_reduce(x, group=mesh.get_group(i))
    return x


def _compress(grads: dict, residual: dict, params: dict, cfg: ArchConfig,
              codec: str) -> None:
    """Error-feedback compression of ``grads`` with ``residual`` (both by
    parameter name, updated in place; a ``None`` gradient is zeros).  The
    codec sees the reference's leaves: the parameters a stacked leaf holds
    (every layer's, every Mamba2 block's) are compressed together, with one
    int8 scale and one top-k over all of them (on a mesh, over the whole
    stacked leaf, not a block of it)."""
    groups: dict[tuple, list[str]] = {}
    for name in params:
        groups.setdefault(model.stacked_leaf(name, cfg)[0], []).append(name)
    for names in groups.values():
        g = [torch.zeros_like(params[k], dtype=torch.float32) if grads[k] is None
             else grads[k] for k in names]
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
    are updated in place.

    On a mesh (the module's parameters are DTensors, ``TrainState`` laid out
    by ``launch.train``), the batch is the global one (whole on every rank,
    or a DTensor of it), microbatch i its global rows [i·b/n, (i+1)·b/n),
    and each rank runs the model on its own rows of it (split over the data
    axes) with the parameters gathered whole (``sharding.whole_parameters``):
    each microbatch's gradients reduce-scatter onto the parameters' layout,
    or onto ``grad_shardings`` (specs or placements by parameter name, the
    reference's pinned accumulator layout; a name it lacks keeps its
    parameter's), where the float32 buffers are laid out.  A rank's loss is
    its rows' share of the global mean (its CE summed over the global valid
    count; an MoE's aux its share, ``models.moe``), so the shares sum to
    the one-device loss and their gradients to its gradient.  Off a mesh
    ``grad_shardings`` has nothing to lay out."""
    grad_shardings = grad_shardings or {}

    def layout(name: str, mesh: DeviceMesh):
        spec = grad_shardings.get(name)
        if spec is None or all(isinstance(p, Placement) for p in spec):
            return spec
        return sharding.placements(spec, mesh)

    def microbatch_grads(params, plist, mb, mesh):
        """(this rank's loss share, its gradients) of one microbatch."""
        if mesh is None:
            loss, _ = model.loss_fn(params, mb, cfg, remat=tcfg.remat)
            return loss, torch.autograd.grad(loss, plist, allow_unused=True)
        with sharding.whole_parameters(params):
            _, metrics = model.loss_fn(params, mb, cfg, remat=tcfg.remat)
            tokens = metrics["tokens"]
            count = _sum_over_data(tokens.detach().clone(), mesh)
            share = (metrics["ce"] * (tokens / torch.clamp(count, min=1))
                     + 0.01 * metrics["aux"])
            return share, torch.autograd.grad(share, plist, allow_unused=True)

    def train_step(state: TrainState, batch):
        params = state.params
        names, plist = zip(*params.named_parameters())
        mesh = _mesh_of(plist)
        nmb = tcfg.microbatches
        if mesh is not None:
            batch = {k: x.full_tensor() if isinstance(x, DTensor) else x
                     for k, x in batch.items()}
        gsum: list[torch.Tensor | None] = [None] * len(plist)
        lsum = None
        with torch.enable_grad(), contextlib.ExitStack() as ctx:
            if mesh is not None:
                ctx.enter_context(sharding.use_mesh(mesh))
            for mb in _split_microbatches(batch, nmb):
                if mesh is not None:
                    mb = _own_rows(mb, mesh)
                loss, grads = microbatch_grads(params, plist, mb, mesh)
                for i, g in enumerate(grads):
                    if g is None:
                        continue
                    if mesh is not None and layout(names[i], mesh) is not None:
                        g = g.redistribute(mesh, layout(names[i], mesh))
                    if gsum[i] is None:
                        gsum[i] = g.to(torch.float32, copy=True)
                    else:
                        gsum[i].add_(g)
                loss = loss.detach()
                lsum = loss if lsum is None else lsum + loss
                del grads
        if mesh is not None:
            lsum = _sum_over_data(lsum, mesh)
            # the optimizer updates each block where its parameter's lies
            gsum = [g if g is None or g.placements == p.placements
                    else g.redistribute(mesh, p.placements)
                    for g, p in zip(gsum, plist)]
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
