"""LR schedules (counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine decay to
    ``min_ratio·lr`` at ``total``.  A tensor ``step`` gives a float32 0-d
    tensor on its device (no host sync); an int gives a Python float."""
    if not isinstance(step, torch.Tensor):
        s = float(step)
        if s < warmup:
            return lr * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))
    s = step.to(torch.float32)
    warm = lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
