"""Fused row FFT -> transposed write: the plain PyTorch version, the launch
plan and the launcher of the CUDA kernel ``csrc/fft_rows_transpose.cu``
(n <= 8192) and, at n = 16384, of ``csrc/fft_rows_transpose_cluster.cu``.

Counterpart of ``repro.kernels.fused.kernel``.  The unfused pipeline writes
the row-transformed matrix to device memory and reads it back to transpose
it; the fused kernel stores each transformed row straight to its transposed
place in the ``(n, rows)`` output, so the intermediate matrix never exists.

The CUDA kernel runs ``fft_rows.cu``'s register-resident passes
(``csrc/regfft.cuh``) in the launch shape of ``complex_rows_plan``, then
stores the rows of a CTA side by side in each output row; where a whole CTA
holds fewer rows than make a 32-byte sector (n >= 2048), the CTAs of a
thread-block cluster store their rows side by side, each a slice of the bins
(``fft_rows_transpose_plan``).  ``radix`` is validated, as in the reference,
and chooses the plain version's stage loop only.

At n = 16384, where that kernel's row would take a whole SM (1024 threads,
136 KiB) and no second CTA would hide its loads, the op launches K2b's
one-pass four-step cluster kernel (``csrc/fft_rows_transpose_cluster.cu``,
``kernels.fused.large``) in the shape ``transpose_cluster_plan(16384)``,
each row split over the CTAs of a cluster, four CTAs an SM.
``fft_rows_transpose_plan`` still gives the cluster rule at 16384: the
four-step's pass B (``csrc/fourstep.cuh``) stores rows of n2 = 16384 by it.
That kernel takes an output stride, so at 16384 ``pad_stride=True`` pads the
output's rows to whole sectors as K2b's launchers do
(``kernels.fused.large.padded_out_stride``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import (_CTA_THREADS, MAX_KERNEL_N, check_kernel_input,
                                            complex_rows_plan, fft_rows_plain, launch)
from repro_torch.kernels.fused.large import fft_rows_transpose_large_cuda, transposed_out

__all__ = ["STORE_CLUSTER", "fft_rows_transpose_cuda", "fft_rows_transpose_plain",
           "fft_rows_transpose_plan", "launch_count", "launch_count_16k",
           "padded_launch_count", "reset_launch_count"]

# CTAs of a cluster where a CTA holds one row (``kStoreCluster`` of
# ``csrc/fft_rows_transpose.cu``): 8 bytes of each row per output row, so a
# cluster stores 8 * STORE_CLUSTER = 32 contiguous bytes, a whole sector, of
# each.
STORE_CLUSTER = 4

_launches = 0
_launches_16k = 0
_launches_padded = 0


def launch_count() -> int:
    """How many times ``fft_rows_transpose_cuda`` has launched a kernel (either source)."""
    return _launches


def launch_count_16k() -> int:
    """The launches of the cluster kernel at n = 16384 among
    ``launch_count``'s."""
    return _launches_16k


def padded_launch_count() -> int:
    """The launches of the cluster kernel at n = 16384 that wrote their
    output at a row stride above its rows (``pad_stride=True``)."""
    return _launches_padded


def reset_launch_count() -> None:
    global _launches, _launches_16k, _launches_padded
    _launches = _launches_16k = _launches_padded = 0


def fft_rows_transpose_plain(x: torch.Tensor, *, inverse: bool = False,
                             radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: the plane stage loop, then a transposed
    copy.  (rows, n) complex64 -> (n, rows)."""
    return fft_rows_plain(x, inverse=inverse, radix=radix).T.contiguous()


def fft_rows_transpose_plan(n: int, rows: int) -> tuple[int, int, int, int]:
    """The launch shape of ``csrc/fft_rows_transpose.cu`` for ``rows`` rows of
    length ``n`` (n <= 8192; at 16384 the rule by which the four-step's pass
    B, ``csrc/fourstep.cuh``, stores rows of n2 = 16384):
    ``(rows_per_cta, threads, cluster, blocks)``.  Rows per CTA
    and threads are ``complex_rows_plan``'s; where the rows a whole CTA of
    256 threads holds (``max_rows``, at least one) give less than a 32-byte
    sector of each output row (n >= 2048), CTAs run in clusters of
    ``STORE_CLUSTER // max_rows`` over a grid padded to a multiple of it,
    else alone (``cluster`` 1)."""
    per_cta, threads, points, _, _ = complex_rows_plan(n, rows)
    max_rows = max(1, _CTA_THREADS * points // n)
    cluster = STORE_CLUSTER // max_rows if 8 * max_rows < 32 else 1
    ctas = -(-rows // per_cta)
    return per_cta, threads, cluster, -(-ctas // cluster) * cluster


def fft_rows_transpose_cuda(x: torch.Tensor, *, inverse: bool = False,
                            radix: int = 4, pad_stride: bool = False) -> torch.Tensor:
    """K2 on a (rows, n) complex64 CUDA tensor -> ``FFT_rows(x).T`` of shape
    (n, rows), contiguous; with ``pad_stride``, from n = ``MAX_KERNEL_N``
    on, a view of an ``(n, padded_out_stride(n, rows))`` buffer (every
    output row on a 32-byte boundary).  One launch a call: below
    ``MAX_KERNEL_N`` ``csrc/fft_rows_transpose.cu`` in the launch shape of
    ``fft_rows_transpose_plan`` (the C side picks the cluster from n), at
    ``MAX_KERNEL_N`` ``csrc/fft_rows_transpose_cluster.cu`` in the shape
    ``transpose_cluster_plan(n)``; rows longer than ``MAX_KERNEL_N`` (up to
    ``MAX_LARGE_N``) go to K2b
    (``kernels.fused.large.fft_rows_transpose_large_cuda``).  Does not
    synchronise."""
    global _launches, _launches_16k, _launches_padded
    rows, n = check_kernel_input(x, "fft_rows_transpose_cuda")
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if n > MAX_KERNEL_N:
        return fft_rows_transpose_large_cuda(x, inverse=inverse, pad_stride=pad_stride)
    out, stride = transposed_out(x, n, rows, pad_stride)
    if rows == 0:
        return out
    if n == MAX_KERNEL_N:
        launch("repro_fft_rows_transpose_cluster", x, out, rows=rows, n=n,
               inverse=int(inverse), out_stride=stride)
        _launches_16k += 1
        _launches_padded += stride > rows
    else:
        rows_per_cta, threads, *_ = fft_rows_transpose_plan(n, rows)
        launch("repro_fft_rows_transpose", x, out, rows=rows, n=n, radix=radix,
               inverse=int(inverse), rows_per_cta=rows_per_cta, threads=threads)
    _launches += 1
    return out if stride == rows else out[:, :rows]
