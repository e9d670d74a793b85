"""The deterministic synthetic token stream (``repro.data``'s counterpart;
``input_specs`` comes with the dry-run)."""

from repro_torch.data.pipeline import SyntheticTokenPipeline, make_batch

__all__ = ["SyntheticTokenPipeline", "make_batch"]
