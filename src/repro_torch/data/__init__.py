"""The deterministic synthetic token stream and the dry-run's input
stand-ins (``repro.data``'s counterpart)."""

from repro_torch.data.pipeline import SyntheticTokenPipeline, make_batch
from repro_torch.data.specs import input_specs

__all__ = ["SyntheticTokenPipeline", "make_batch", "input_specs"]
