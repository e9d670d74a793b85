"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) expert_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ArchConfig, MoECfg

FULL = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab=100352,
    moe=MoECfg(n_experts=16, top_k=4, d_expert=10752),
)

SMOKE = ArchConfig(
    name="dbrx-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
    moe=MoECfg(n_experts=4, top_k=2, d_expert=128),
)
