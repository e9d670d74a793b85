"""The serve_step factory (``repro.train.step``'s serving half; the train step
comes with training, ROADMAP M11d).

serve_step: one decode token against the KV cache.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as model

__all__ = ["make_serve_step"]


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens (B,), pos) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, cfg)
    return serve_step
