"""Naive O(N^2) DFT — the testing oracle for everything FFT in this package.

Direct implementation of the paper's definition:

    M[k][l] = sum_i sum_j M[i][j] * w^{ki} * w^{lj},   w = exp(-2*pi*i/N)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_tensor, complex_result_type

__all__ = ["dft1d_naive", "dft2d_naive"]


def _dft_matrix(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def dft1d_naive(x, axis: int = -1) -> torch.Tensor:
    """O(N^2) DFT along ``axis``."""
    x = as_tensor(x)
    ctype = complex_result_type(x)
    w = _dft_matrix(x.shape[axis], ctype, x.device)
    moved = torch.movedim(x.to(ctype), axis, -1)
    return torch.movedim(torch.tensordot(moved, w, dims=([-1], [1])), -1, axis)


def dft2d_naive(m) -> torch.Tensor:
    """O(N^4-equivalent) 2-D DFT of a square (or rectangular) matrix."""
    return dft1d_naive(dft1d_naive(m, axis=-1), axis=-2)
