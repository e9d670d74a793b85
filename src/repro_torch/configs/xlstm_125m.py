"""xlstm-125m [ssm]: 12L d768 4H, alternating sLSTM + mLSTM blocks
(d_ff=0: blocks carry their own projections). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig, XLSTMCfg

FULL = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, rope_mode="none",
    xlstm=XLSTMCfg(slstm_every=2, chunk=64),
)

SMOKE = ArchConfig(
    name="xlstm-smoke", family="ssm", n_layers=2, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=0, vocab=256, rope_mode="none",
    xlstm=XLSTMCfg(slstm_every=2, chunk=16),
)
