"""Public op for the fused row-FFT -> transpose kernel.

Same contract as ``repro_torch.kernels.fft.ops.fft_rows_op`` (complex in,
complex out, radix auto-selection, float32 compute, the CUDA kernel for a CUDA
tensor and the plain version for a CPU tensor) except that the result comes
back transposed: input ``(rows, n)`` -> output ``(n, rows)`` holding
``FFT_rows(x).T``.  The reference op's ``block_rows`` has no counterpart: the
kernel's launch shape is ``fft_rows_transpose_plan(n, rows)``.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import MAX_KERNEL_N
from repro_torch.kernels.fft.ops import prepare_rows, resolve_radix
from repro_torch.kernels.fused.kernel import (fft_rows_transpose_cuda,
                                              fft_rows_transpose_plain)
from repro_torch.kernels.fused.large import fft_rows_transpose_large_plain

__all__ = ["fft_rows_transpose_op"]


def fft_rows_transpose_op(x, *, inverse: bool = False, radix: int | None = None,
                          pad_stride: bool = False) -> torch.Tensor:
    """Fused ``FFT_rows(x).T``.  x: (rows, n) complex, n a power of two up
    to ``MAX_LARGE_N``: K2 (one launch) up to ``MAX_KERNEL_N``, the
    four-step K2b above (one launch over clusters at n <= 65536, two passes
    beyond; on the CPU, ``fft_rows_transpose_large_plain``).

    ``radix=None`` auto-selects; it chooses the plain version's stage loop
    up to ``MAX_KERNEL_N``, while the CUDA kernels' passes depend on ``n``
    only.  ``pad_stride=True`` lets the CUDA kernels from n = 16384 on write
    into rows padded to a multiple of 4 and return the ``(n, rows)`` view of
    that buffer (``kernels.fused.large.padded_out_stride``); the CPU's plain
    versions return a contiguous result whatever it says."""
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"fused op takes a 2-D matrix, got shape {tuple(x.shape)}")
    n = x.shape[1]
    x2 = prepare_rows(x, "fft_rows_transpose_op")
    radix = resolve_radix(n, radix, "fft_rows_transpose_op")
    out_dtype = complex_result_type(x)
    if n == 1:  # the length-1 DFT is the identity: only the transpose is left
        return x2.to(out_dtype).T.contiguous()
    if x2.is_cuda:
        out = fft_rows_transpose_cuda(x2, inverse=inverse, radix=radix,
                                      pad_stride=pad_stride)
    elif n > MAX_KERNEL_N:
        out = fft_rows_transpose_large_plain(x2, inverse=inverse)
    else:
        out = fft_rows_transpose_plain(x2, inverse=inverse, radix=radix)
    return out.to(out_dtype)
