"""stablelm-3b [dense]: 32L d2560 32H (MHA kv=32) d_ff=6912 vocab=50304,
partial (25%) rotary, layernorm. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=6912, vocab=50304, rope_mode="partial25",
    norm="layernorm",
)

SMOKE = ArchConfig(
    name="stablelm-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=256, rope_mode="partial25", norm="layernorm",
)
