"""Row-column 2-D DFT (paper §III-A) built from 1-D FFTs.

``fft2d_rowcol`` is the sequential algorithm the parallel methods decompose:
row FFTs -> transpose -> row FFTs -> transpose.  It reduces the O(N^4)
direct 2-D DFT to O(N^2 log N).

``fused=True`` collapses each (row FFT, transpose) pair into one kernel
launch (``repro_torch.kernels.fused``): the transformed row block is written
straight to its transposed place, so the intermediate matrix between steps
1-2 and 3-4 never exists in device memory.

The real-input functions (``rfft_rows``, ``rfft2``, ``irfft2``) of the
reference wait for the slice that ports the packed-real kernels.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.fft.fft1d import fft1d_stockham

__all__ = ["fft2d_rowcol", "fft_rows", "fft_rows_then_transpose"]


def fft_rows(m, *, use_stockham: bool = False, backend: str | None = None,
             radix: int | None = None) -> torch.Tensor:
    """1-D FFT along the last axis.

    backend: None/'torch' -> ``torch.fft``; 'stockham' -> pure-tensor
    radix-2; 'cuda' -> the CUDA kernel (its plain version for a CPU tensor).
    Power-of-two lengths go to stockham/cuda; any other length goes to the
    library whatever the backend — that is the rule of the method, as in the
    reference, not a recovery path.  ``radix`` feeds the kernel's Stockham
    radix (None auto-selects; ``PlanConfig.radix`` lands here).
    """
    m = as_tensor(m)
    n = m.shape[-1]
    if backend is None:
        backend = "stockham" if use_stockham else "torch"
    if backend not in ("torch", "stockham", "cuda"):
        raise ValueError(f"unknown row-FFT backend {backend!r}")
    if backend == "cuda" and not (n & (n - 1)):
        from repro_torch.kernels.fft.ops import fft_rows_op
        return fft_rows_op(m, radix=radix)
    if backend == "stockham" and not (n & (n - 1)):
        return fft1d_stockham(m)
    return torch.fft.fft(m.to(complex_result_type(m)), dim=-1)


def fft_rows_then_transpose(m, *, backend: str | None = None,
                            radix: int | None = None) -> torch.Tensor:
    """One fused phase: ``FFT_rows(m).T`` without the intermediate matrix.

    Dispatches to the fused kernel when it applies (2-D input, power-of-two
    row length above 1, single-precision data — the kernel computes in
    float32, so wider types keep the full-precision path); otherwise
    computes the same value as ``fft_rows`` + a transposed copy so callers
    can use it unconditionally.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    eligible = (m.ndim == 2 and n > 1 and not (n & (n - 1))
                and complex_result_type(m) == torch.complex64)
    if eligible and backend in (None, "cuda", "fused"):
        from repro_torch.kernels.fused.ops import fft_rows_transpose_op
        return fft_rows_transpose_op(m, radix=radix)
    if backend == "fused":
        backend = None
    return fft_rows(m, backend=backend).transpose(-1, -2).contiguous()


def fft2d_rowcol(m, *, use_stockham: bool = False,
                 fused: bool = False) -> torch.Tensor:
    """2-D DFT via row-column decomposition, mirroring the paper's 4 steps:

      1. 1-D FFTs on rows
      2. transpose
      3. 1-D FFTs on rows (i.e. the original columns)
      4. transpose

    ``fused=True`` runs steps 1+2 and 3+4 as single fused launches
    (numerically equivalent; no intermediate matrix).
    """
    m = as_tensor(m)
    if fused:
        m = fft_rows_then_transpose(m)              # steps 1+2
        m = fft_rows_then_transpose(m)              # steps 3+4
        return m
    m = fft_rows(m, use_stockham=use_stockham)      # step 1
    m = m.transpose(-1, -2).contiguous()            # step 2
    m = fft_rows(m, use_stockham=use_stockham)      # step 3
    m = m.transpose(-1, -2).contiguous()            # step 4
    return m
