"""zamba2-7b [hybrid]: 81 Mamba2 blocks d3584 + shared attention block
(32H, MHA, d_ff=14336) every 6 blocks; ssm_state=64.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMCfg, HybridCfg

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid=HybridCfg(shared_attn_every=6),
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    hybrid=HybridCfg(shared_attn_every=2),
)
