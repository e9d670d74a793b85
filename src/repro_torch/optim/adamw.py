"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro.optim.adamw``).

Moments are float32 whatever the parameter dtype (bf16 parameters, float32
state: the standard mixed-precision recipe), and the update runs in float32
before the cast back.  Where the reference maps over parameter pytrees, the
state here is flat: dicts of tensors keyed by parameter name (a module's
``named_parameters()`` names), and ``adamw_update`` writes the new
parameters and moments in place.  A gradient that is ``None`` (a parameter
the loss did not reach) counts as zeros, as the reference's zero cotangent
does: its moments decay toward zero and weight decay still applies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

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
    dict of tensors), and step 0."""
    named = _named(params)
    device = next(iter(named.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every tensor of ``tree`` (a dict
    or a sequence; ``None`` entries count as zeros)."""
    leaves = [x for x in (tree.values() if isinstance(tree, dict) else tree)
              if x is not None]
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32))) for x in leaves])))


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
        m, v = opt.m[name], opt.v[name]
        g = grads.get(name)
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
