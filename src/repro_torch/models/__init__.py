"""The LM scaffold's models: every family of the registry (dense, moe, vlm,
audio; xLSTM in ``models.xlstm``, Mamba2 in ``models.ssm``) and the
architecture registry.  Counterpart of ``repro.models`` without its sharding
specs (they come with the trainer on a mesh, ROADMAP M11d-b)."""

from repro_torch.models.transformer import (init_params, loss_fn, forward,
                                            init_cache, prefill, decode_step)
from repro_torch.models.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = [
    "init_params", "loss_fn", "forward", "init_cache", "prefill", "decode_step",
    "ARCH_IDS", "get_config", "get_smoke_config",
]
