"""The fused row FFT -> transposed write of long rows, K2b: the plain PyTorch
version and the launcher of the CUDA kernel
``csrc/fft_rows_transpose_large.cu``.

Counterpart of ``repro.kernels.fused.kernel.fft_rows_transpose_pallas`` at
the lengths the register-resident K2 (``kernels.fused.kernel``, n <=
``MAX_KERNEL_N``) cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to
``MAX_LARGE_N``.  K1b's four-step (``kernels.fft.large``) with two changes,
so that ``FFT_rows(x).T`` needs no pass of its own: pass A stores B in
``[k1][s][j2]`` order, the rows of one k1 side by side (``scratch_capacity``
of them, a power of two), and pass B sends row ``R = k1*cap + s`` and bin k2
to ``out[k1 + n1*k2, s]``, so that the rows a CTA stores side by side are
neighbouring output columns, as in K2.

Scratch and chunks are K1b's: at most ``scratch_rows(n)`` rows a chunk, two
launches a chunk, each chunk writing its columns of the ``(n, rows)``
output.  ``launch_count`` counts every CUDA launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import check_kernel_input, complex_rows_plan, launch
from repro_torch.kernels.fft.large import (_columns_pass, _rows_pass, kernel_split,
                                           large_split, scratch_capacity,
                                           scratch_rows)

__all__ = ["fft_rows_transpose_large_cuda", "fft_rows_transpose_large_plain",
           "launch_count", "reset_launch_count"]

_launches = 0


def launch_count() -> int:
    """CUDA launches of K2b since the last reset: two per chunk of rows."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def fft_rows_transpose_large_plain(x: torch.Tensor, *, inverse: bool = False,
                                   n1: int | None = None,
                                   n2: int | None = None) -> torch.Tensor:
    """K2b's plain version: (rows, n) complex64 -> ``FFT_rows(x).T`` of shape
    (n, rows) by K1b's passes (``kernels.fft.large``), with B stored as
    ``[k1][s][j2]`` and the transposed store ``out[k1 + n1*k2, s]``, each
    written out.  ``n1`` / ``n2`` pin the split."""
    rows, n = x.shape
    n1, n2 = large_split(n, n1=n1, n2=n2)
    b = _columns_pass(x, n1, n2, inverse).transpose(0, 1)    # B[k1][s][j2]
    c = _rows_pass(b, inverse)                                # C[k1][s][k2]
    return c.permute(2, 0, 1).reshape(n, rows)


def fft_rows_transpose_large_cuda(x: torch.Tensor, *,
                                  inverse: bool = False) -> torch.Tensor:
    """Launch ``csrc/fft_rows_transpose_large.cu``: (rows, n) complex64 CUDA
    tensor -> ``FFT_rows(x).T`` of shape (n, rows), both factors of the split
    (``kernel_split``) in the kernels' range; per chunk of
    rows, pass B's shape is ``complex_rows_plan(n2, cap*n1)`` with cap =
    ``scratch_capacity(chunk rows)``.  Does not synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "fft_rows_transpose_large_cuda")
    n1, n2 = kernel_split(n, None, "fft_rows_transpose_large_cuda")
    out = torch.empty((n, rows), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    chunk = scratch_rows(n)
    scratch = torch.empty((scratch_capacity(min(rows, chunk)), n), dtype=x.dtype,
                          device=x.device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        rows_per_cta, threads, *_ = complex_rows_plan(n2, scratch_capacity(r1 - r0) * n1)
        launch("repro_fft_rows_transpose_large", x[r0:r1], out[:, r0:],
               scratch=scratch.data_ptr(), rows=r1 - r0, n1=n1, n2=n2,
               inverse=int(inverse), out_stride=rows, rows_per_cta=rows_per_cta,
               threads=threads)
        _launches += 2
    return out
