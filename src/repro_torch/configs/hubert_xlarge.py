"""hubert-xlarge [audio]: encoder-only, 48L d1280 16H (MHA) d_ff=5120
vocab=504 (masked-prediction cluster targets); the conv feature frontend is
a STUB — input_specs provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, mlp="gelu",
    norm="layernorm", rope_mode="none", encoder_only=True, modality="audio",
)

SMOKE = ArchConfig(
    name="hubert-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=64, mlp="gelu", norm="layernorm",
    rope_mode="none", encoder_only=True, modality="audio",
)
