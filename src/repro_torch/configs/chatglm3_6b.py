"""chatglm3-6b [dense]: 28L d4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
2d RoPE (rotate half the head dims). [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab=65024, rope_mode="half",
)

SMOKE = ArchConfig(
    name="chatglm3-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=256, rope_mode="half",
)
