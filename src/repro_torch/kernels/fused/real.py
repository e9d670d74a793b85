"""Fused *real* row FFT -> transposed write: the plain PyTorch version, the
launcher of the CUDA kernel ``csrc/rfft_rows_transpose.cu`` and the public op.

Counterpart of ``repro.kernels.fused.real``: the real-pipeline sibling of
``kernels.fused``.  Two real rows are packed per complex Stockham FFT and
split as in ``kernels.fft.real``, and both half spectra are stored straight
to their transposed place in the ``(n//2+1, rows)`` output — phase 1 of the
fused real 2-D DFT, with no half-spectrum matrix in device memory between the
row transforms and the transpose.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import SMEM_BUDGET, check_kernel_input, launch
from repro_torch.kernels.fft.ops import resolve_call_params
from repro_torch.kernels.fft.real import prepare_real_rows, rfft_rows_plain

__all__ = ["launch_count", "reset_launch_count", "rfft_rows_transpose_cuda",
           "rfft_rows_transpose_op", "rfft_rows_transpose_plain"]

_launches = 0


def launch_count() -> int:
    """How many times ``rfft_rows_transpose_cuda`` has launched its kernel."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def rfft_rows_transpose_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: the packed real row FFT, then a
    transposed copy.  (rows, n) float32 -> (n//2+1, rows) complex64."""
    return rfft_rows_plain(x, radix=radix).T.contiguous()


def rfft_rows_transpose_cuda(x: torch.Tensor, *, radix: int = 4,
                             rows_per_cta: int = 1,
                             threads: int = 256) -> torch.Tensor:
    """Launch ``csrc/rfft_rows_transpose.cu``: (rows, n) float32 CUDA tensor
    -> ``rfft_rows(x).T`` of shape (n//2+1, rows), complex64.
    ``rows_per_cta`` counts row pairs.  Does not synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "rfft_rows_transpose_cuda", torch.float32)
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if 2 * rows_per_cta * (n + 1) * 8 > SMEM_BUDGET:
        raise ValueError(
            f"rfft_rows_transpose_cuda: rows_per_cta={rows_per_cta} row pairs "
            f"of length {n} need more than {SMEM_BUDGET} bytes of shared memory")
    out = torch.empty((n // 2 + 1, rows), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    launch("repro_rfft_rows_transpose", x, out, rows=rows, n=n, radix=radix,
           rows_per_cta=rows_per_cta, threads=threads)
    _launches += 1
    return out


def rfft_rows_transpose_op(x, *, rows_per_cta: int | None = None,
                           radix: int | None = None) -> torch.Tensor:
    """Fused ``rfft_rows(x).T`` in one kernel launch.

    x: (rows, n) real -> (n//2+1, rows) complex, the transposed half
    spectrum.  Computes in float32 and returns ``promote(x.dtype,
    complex64)``.
    """
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"fused op takes a 2-D matrix, got shape {tuple(x.shape)}")
    rows, n = x.shape
    x2 = prepare_real_rows(x, "rfft_rows_transpose_op")
    rows_per_cta, radix, threads = resolve_call_params(
        n, (rows + 1) // 2, rows_per_cta, radix,
        name="rfft_rows_transpose_op")
    out_dtype = complex_result_type(x)
    if n == 1:  # the length-1 DFT is the identity: only the transpose is left
        return x2.to(out_dtype).T.contiguous()
    if x2.is_cuda:
        out = rfft_rows_transpose_cuda(x2, radix=radix, rows_per_cta=rows_per_cta,
                                       threads=threads)
    else:
        out = rfft_rows_transpose_plain(x2, radix=radix)
    return out.to(out_dtype)
