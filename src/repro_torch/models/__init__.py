"""The LM scaffold's models: every family of the registry (dense, moe, vlm,
audio; xLSTM in ``models.xlstm``, Mamba2 in ``models.ssm``) and the
architecture registry.  Counterpart of ``repro.models`` without its sharding
specs and ``loss_fn`` (they come with training)."""

from repro_torch.models.transformer import (init_params, forward, init_cache,
                                            prefill, decode_step)
from repro_torch.models.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = [
    "init_params", "forward", "init_cache", "prefill", "decode_step",
    "ARCH_IDS", "get_config", "get_smoke_config",
]
