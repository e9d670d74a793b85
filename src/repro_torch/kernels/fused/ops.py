"""Public op for the fused row-FFT -> transpose kernel.

Same contract as ``repro_torch.kernels.fft.ops.fft_rows_op`` (complex in,
complex out, radix auto-selection, float32 compute, the CUDA kernel for a CUDA
tensor and the plain version for a CPU tensor) except that the result comes
back transposed: input ``(rows, n)`` -> output ``(n, rows)`` holding
``FFT_rows(x).T``.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.ops import prepare_rows, resolve_call_params
from repro_torch.kernels.fused.kernel import (fft_rows_transpose_cuda,
                                              fft_rows_transpose_plain)

__all__ = ["fft_rows_transpose_op"]


def fft_rows_transpose_op(x, *, inverse: bool = False,
                          rows_per_cta: int | None = None,
                          radix: int | None = None) -> torch.Tensor:
    """Fused ``FFT_rows(x).T`` in one kernel launch.  x: (rows, n) complex."""
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"fused op takes a 2-D matrix, got shape {tuple(x.shape)}")
    rows, n = x.shape
    x2 = prepare_rows(x, "fft_rows_transpose_op")
    rows_per_cta, radix, threads = resolve_call_params(n, rows, rows_per_cta, radix)
    out_dtype = complex_result_type(x)
    if n == 1:  # the length-1 DFT is the identity: only the transpose is left
        return x2.to(out_dtype).T.contiguous()
    if x2.is_cuda:
        out = fft_rows_transpose_cuda(x2, inverse=inverse, radix=radix,
                                      rows_per_cta=rows_per_cta, threads=threads)
    else:
        out = fft_rows_transpose_plain(x2, inverse=inverse, radix=radix)
    return out.to(out_dtype)
