"""qwen2.5-3b [dense]: 36L d2048 16H (GQA kv=2) d_ff=11008 vocab=151936,
QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048, n_heads=16,
    n_kv_heads=2, d_ff=11008, vocab=151936, qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=256, qkv_bias=True,
)
