"""The LM scaffold's models: every family of the registry (dense, moe, vlm,
audio; xLSTM in ``models.xlstm``, Mamba2 in ``models.ssm``) and the
architecture registry, and the sharding specs of the mesh trainer
(``models.sharding``).  Counterpart of ``repro.models``."""

from repro_torch.models.transformer import (init_params, loss_fn, forward,
                                            init_cache, prefill, decode_step)
from repro_torch.models.sharding import param_pspecs, batch_pspecs, cache_pspecs
from repro_torch.models.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = [
    "init_params", "loss_fn", "forward", "init_cache", "prefill", "decode_step",
    "param_pspecs", "batch_pspecs", "cache_pspecs",
    "ARCH_IDS", "get_config", "get_smoke_config",
]
