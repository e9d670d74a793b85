"""Optimizer, LR schedule and gradient compression (counterpart of
``repro.optim``).  Importing it touches no CUDA state and creates no
process group."""

from repro_torch.optim.adamw import adamw_init, adamw_update, OptState
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.grad_compress import (int8_compress, int8_decompress,
                                             topk_compress, topk_decompress,
                                             compressed_psum)

__all__ = ["adamw_init", "adamw_update", "OptState", "cosine_warmup",
           "int8_compress", "int8_decompress", "topk_compress",
           "topk_decompress", "compressed_psum"]
