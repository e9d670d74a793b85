"""internlm2-1.8b [dense]: 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92544,
)

SMOKE = ArchConfig(
    name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
)
