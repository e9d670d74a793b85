"""Pure-tensor radix-2 1-D FFT (decimation-in-time, bit-reversal reorder).

The ``"stockham"`` row-FFT backend (``PlanConfig(radix=2)``): power-of-two
lengths only; ``repro_torch.fft.fft2d`` dispatches to ``torch.fft`` for
general lengths (the library picks Bluestein there — exactly the "slow
sizes" the paper's padding method routes around).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import as_tensor, complex_result_type

__all__ = ["fft1d_stockham", "bit_reverse_indices"]


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation for length n (n a power of two)."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"n must be a power of two, got {n}")
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def fft1d_stockham(x, *, inverse: bool = False) -> torch.Tensor:
    """Radix-2 FFT along the last axis. x: (..., n) complex, n = 2**k."""
    x = as_tensor(x)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    ctype = complex_result_type(x)
    x = x.to(ctype)
    if n == 1:
        return x

    x = x[..., torch.from_numpy(bit_reverse_indices(n)).to(x.device)]
    sign = 1.0 if inverse else -1.0
    real = torch.float64 if ctype == torch.complex128 else torch.float32
    size = 2
    while size <= n:
        half = size // 2
        ang = (sign * 2.0 * math.pi / size) * torch.arange(
            half, dtype=real, device=x.device)
        tw = torch.polar(torch.ones_like(ang), ang).to(ctype)
        xs = x.reshape(x.shape[:-1] + (n // size, size))
        even = xs[..., :half]
        odd = xs[..., half:] * tw
        x = torch.cat([even + odd, even - odd], dim=-1).reshape(x.shape)
        size *= 2
    if inverse:
        x = x / n
    return x
