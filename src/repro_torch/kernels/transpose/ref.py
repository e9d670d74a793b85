"""Library oracle for the blocked transpose kernel."""

from __future__ import annotations

import torch

__all__ = ["transpose_ref"]


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()
