"""deepseek-v2-lite-16b [moe]: 27L d2048 16H, MLA kv_lora=512,
expert_ff=1408 vocab=102400, MoE 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]  (Brief lists both "64e" and "160 routed"; published
v2-lite has 64 routed — we use 64, noted in DESIGN.md.)"""
from repro_torch.configs.base import ArchConfig, MoECfg, MLACfg

FULL = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=96, vocab=256,
    mla=MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoECfg(n_experts=8, top_k=2, d_expert=96, n_shared=1),
)
