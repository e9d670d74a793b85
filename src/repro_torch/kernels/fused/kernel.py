"""Fused row FFT -> transposed write: the plain PyTorch version and the
launcher of the CUDA kernel ``csrc/fft_rows_transpose.cu``.

Counterpart of ``repro.kernels.fused.kernel``.  The unfused pipeline writes
the row-transformed matrix to device memory and reads it back to transpose
it; the fused kernel runs the same Stockham stage loop and stores each
transformed row block straight to its transposed place in the ``(n, rows)``
output, so the intermediate matrix never exists.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import (SMEM_BUDGET, check_kernel_input,
                                            fft_rows_plain, launch)

__all__ = ["fft_rows_transpose_cuda", "fft_rows_transpose_plain",
           "launch_count", "reset_launch_count"]

_launches = 0


def launch_count() -> int:
    """How many times ``fft_rows_transpose_cuda`` has launched its kernel."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def fft_rows_transpose_plain(x: torch.Tensor, *, inverse: bool = False,
                             radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: the plane stage loop, then a transposed
    copy.  (rows, n) complex64 -> (n, rows)."""
    return fft_rows_plain(x, inverse=inverse, radix=radix).T.contiguous()


def fft_rows_transpose_cuda(x: torch.Tensor, *, inverse: bool = False,
                            radix: int = 4, rows_per_cta: int = 1,
                            threads: int = 256) -> torch.Tensor:
    """Launch ``csrc/fft_rows_transpose.cu``: (rows, n) complex64 CUDA tensor
    -> ``FFT_rows(x).T`` of shape (n, rows).  Does not synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "fft_rows_transpose_cuda")
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if 2 * rows_per_cta * (n + 1) * 8 > SMEM_BUDGET:
        raise ValueError(
            f"fft_rows_transpose_cuda: rows_per_cta={rows_per_cta} rows of "
            f"length {n} need more than {SMEM_BUDGET} bytes of shared memory")
    out = torch.empty((n, rows), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    launch("repro_fft_rows_transpose", x, out, rows=rows, n=n, radix=radix,
           inverse=int(inverse), rows_per_cta=rows_per_cta, threads=threads)
    _launches += 1
    return out
