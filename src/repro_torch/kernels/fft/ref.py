"""Library oracle for the row-FFT kernel (``torch.fft``)."""

from __future__ import annotations

import torch

__all__ = ["fft_rows_ref"]


def fft_rows_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Reference: complex64 FFT along the last axis."""
    x = x.to(torch.complex64)
    return torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)
