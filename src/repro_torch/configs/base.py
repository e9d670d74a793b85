"""Architecture / run configuration schema.

One ``ArchConfig`` fully describes a model; ``src/repro_torch/configs/<id>.py``
each export ``FULL`` (the exact assigned config) and ``SMOKE`` (a reduced
same-family config for CPU tests).  Shapes are the assigned input-shape set.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["MoECfg", "MLACfg", "SSMCfg", "XLSTMCfg", "HybridCfg", "ArchConfig",
           "ShapeCfg", "SHAPES", "TrainCfg"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    n_shared: int = 0          # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # mamba2 SSD head dim
    chunk: int = 256
    remat_chunk: bool = False  # rematerialize intra-chunk SSD tensors in bwd


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_every: int = 2       # one sLSTM block every k blocks (rest mLSTM)
    proj_factor: float = 2.0
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    shared_attn_every: int = 6  # shared attention block every k SSM blocks


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qkv_bias: bool = False
    rope_mode: Literal["full", "half", "partial25", "none"] = "full"
    rope_theta: float = 10000.0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    hybrid: HybridCfg | None = None
    encoder_only: bool = False
    modality: Literal["text", "vision", "audio"] = "text"
    n_prefix_embeds: int = 0             # VLM patch / audio frame stub length
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def supports_decode(self) -> bool:
        return not self.encoder_only

    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context (state-based, no dense KV)?"""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 8          # grad-accumulation steps per train_step
    remat: bool = True
    grad_compress: Literal["none", "int8", "topk"] = "none"
    seed: int = 0
