"""llava-next-mistral-7b [vlm]: Mistral backbone 32L d4096 32H (GQA kv=8)
d_ff=14336 vocab=32000; anyres vision frontend is a STUB — input_specs
provides precomputed patch embeddings (576 base-res patches).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, modality="vision",
    n_prefix_embeds=576,
)

SMOKE = ArchConfig(
    name="llava-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=256, modality="vision", n_prefix_embeds=16,
)
