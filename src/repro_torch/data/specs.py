"""Shape and dtype stand-ins for every model input: the dry-run contract
(counterpart of ``repro.data.specs``).

``input_specs(cfg, shape)`` returns the exact dict a real global batch
would have, as tensors on the ``meta`` device (shape and dtype, no data, no
allocation): int32 tokens and targets, a bool mask, bf16 (or float32)
features and patches.  For decode shapes it holds the decode inputs, the
tokens (B,) and the position (); the cache comes from
``models.transformer.init_cache`` in the dry-run itself.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg

__all__ = ["input_specs"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    if shape.kind == "decode":
        return {"tokens": _sds((B,), torch.int32), "pos": _sds((), torch.int32)}

    if cfg.modality == "audio":
        d = {"features": _sds((B, S, cfg.d_model), dt),
             "mask": _sds((B, S), torch.bool)}
        if shape.kind == "train":
            d["targets"] = _sds((B, S), torch.int32)
        return d
    if cfg.modality == "vision":
        P = cfg.n_prefix_embeds
        d = {"tokens": _sds((B, S - P), torch.int32),
             "patches": _sds((B, P, cfg.d_model), dt)}
        if shape.kind == "train":
            d["targets"] = _sds((B, S - P), torch.int32)
        return d
    d = {"tokens": _sds((B, S), torch.int32)}
    if shape.kind == "train":
        d["targets"] = _sds((B, S), torch.int32)
    return d
