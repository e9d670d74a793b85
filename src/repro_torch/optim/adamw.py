"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro.optim.adamw``).

Moments are float32 whatever the parameter dtype (bf16 parameters, float32
state: the standard mixed-precision recipe), and the update runs in float32
before the cast back.  Where the reference maps over parameter pytrees, the
state here is flat: dicts of tensors keyed by parameter name (a module's
``named_parameters()`` names), and ``adamw_update`` writes the new
parameters and moments in place.  On a mesh the parameters, their moments
and gradients are DTensors of one layout a parameter: the update runs on
this rank's blocks, the clipping norm over the whole leaves.  A gradient
that is ``None`` (a parameter
the loss did not reach) counts as zeros, as the reference's zero cotangent
does: its moments decay toward zero and weight decay still applies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TrainCfg

__all__ = ["OptState", "adamw_init", "adamw_update"]


class OptState(NamedTuple):
    step: torch.Tensor              # int32, 0-d, on the parameters' device
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def _named(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a dict of tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def adamw_init(params) -> OptState:
    """Zero float32 moments for each parameter of ``params`` (a module or a
    dict of tensors; a DTensor's laid out as it is), and step 0."""
    named = _named(params)
    device = next(iter(named.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def _local(x):
    """A DTensor's block on this rank (an alias: writes land in it); a
    plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every tensor of ``tree`` (a dict
    or a sequence; ``None`` entries count as zeros), as a plain 0-d tensor.

    DTensors count whole: the sums of the blocks of the leaves split over
    the same mesh dimensions are added, then summed over those dimensions'
    groups (a block replicated over a dimension is counted once)."""
    leaves = [x for x in (tree.values() if isinstance(tree, dict) else tree)
              if x is not None]
    plain = [_sum_of_squares(x) for x in leaves if not isinstance(x, DTensor)]
    split: dict[tuple, list] = {}
    for x in leaves:
        if isinstance(x, DTensor):
            dims = tuple(i for i, p in enumerate(x.placements) if p.is_shard())
            split.setdefault((x.device_mesh, dims), []).append(
                _sum_of_squares(x.to_local()))
    for (mesh, dims), sums in split.items():
        total = torch.sum(torch.stack(sums))
        for i in dims:
            dist.all_reduce(total, group=mesh.get_group(i))
        plain.append(total)
    return torch.sqrt(torch.sum(torch.stack(plain)))


@torch.no_grad()
def adamw_update(grads: dict, opt: OptState, params, cfg: TrainCfg, lr):
    """One AdamW step of ``params`` (a module or a dict of tensors) by
    ``grads`` (a dict of the same names; ``None`` is zeros) at learning rate
    ``lr`` (a float or a 0-d tensor).  Writes the parameters and ``opt``'s
    moments in place; returns (params, the new ``OptState``, {"grad_norm"})."""
    named = _named(params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = opt.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    for name, p in named.items():
        # a DTensor parameter's moments and gradient are laid out as it is:
        # the update is elementwise, on this rank's blocks
        p, m, v = _local(p), _local(opt.m[name]), _local(opt.v[name])
        g = _local(grads.get(name))
        if g is None:
            m.mul_(b1)
            v.mul_(b2)
        else:
            g = g.to(torch.float32) * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, OptState(step, opt.m, opt.v), {"grad_norm": gnorm}
