"""Architecture registry: --arch <id> -> (FULL config, SMOKE config).

Counterpart of ``repro.models.registry`` over this package's copy of the
configs."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS = [
    "dbrx_132b",
    "deepseek_v2_lite_16b",
    "internlm2_1_8b",
    "qwen2_5_3b",
    "chatglm3_6b",
    "stablelm_3b",
    "llava_next_mistral_7b",
    "xlstm_125m",
    "zamba2_7b",
    "hubert_xlarge",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).FULL


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE
