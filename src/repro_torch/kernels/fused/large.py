"""The fused row FFT -> transposed write of long rows, K2b: the plain PyTorch
version, the launch plan and the launcher of the CUDA kernels
``csrc/fft_rows_transpose_cluster.cu`` (n in ``TRANSPOSE_CLUSTER_LENGTHS``;
K2 launches it at 16384, ``kernels.fused.kernel``) and
``csrc/fft_rows_transpose_large.cu`` (the longer rows).

Counterpart of ``repro.kernels.fused.kernel.fft_rows_transpose_pallas`` at
the lengths the register-resident K2 (``kernels.fused.kernel``, n <=
``MAX_KERNEL_N``) cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to
``MAX_LARGE_N``.  K1b's four-step (``kernels.fft.large``) with the store
transposed, ``out[k1 + n1*k2, s]``.

At n = 32768 and 65536 (and for K2 at 16384) one kernel,
``csrc/fft_rows_transpose_cluster.cu``, computes it in one launch: K1b's cluster kernel
(``csrc/fourstep_cluster.cuh``) with a cluster of ``TRANSPOSE_CLUSTER_CTAS``
CTAs holding ``TRANSPOSE_CLUSTER_ROWS`` neighbouring signal rows, so that
each (k1, k2) of those rows goes out as one 32-byte run of an output row
(``transpose_cluster_plan`` mirrors its shape).  No scratch.

Above it the two passes of ``csrc/fft_rows_transpose_large.cu`` do it: pass
A stores B in ``[k1][s][j2]`` order, the rows of one k1 side by side
(``scratch_capacity`` of them, a power of two), and pass B sends row ``R =
k1*cap + s`` and bin k2 to ``out[k1 + n1*k2, s]``, so that the rows a CTA
stores side by side are neighbouring output columns, as in K2.  Scratch and
chunks are K1b's: at most ``scratch_rows(n)`` rows a chunk, two launches a
chunk, each chunk writing its columns of the ``(n, rows)`` output.

``launch_count`` counts every CUDA launch: one a call of the cluster kernel,
two a chunk of the two passes; ``two_pass_launch_count`` the latter alone.

Both write the ``(n, rows)`` output at a row stride, ``out_stride``.  At an
odd stride (the n/2 + 1 rows of a real limb's phase 2) the 32-byte run a
cluster stores in each output row straddles two sectors in three rows of
four; ``pad_stride=True`` lets the launchers write into an ``(n,
padded_out_stride(n, rows))`` buffer and return its first ``rows`` columns,
so that every run is a whole sector.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import _POINTS, check_kernel_input, launch
from repro_torch.kernels.fft.large import (_columns_pass, _rows_pass, kernel_split,
                                           large_split, rows_plan, scratch_capacity,
                                           scratch_rows, two_pass_split)

__all__ = ["TRANSPOSE_CLUSTER_CTAS", "TRANSPOSE_CLUSTER_LENGTHS",
           "TRANSPOSE_CLUSTER_ROWS", "fft_rows_transpose_cluster_cuda",
           "fft_rows_transpose_large_cuda", "fft_rows_transpose_large_plain",
           "launch_count", "padded_launch_count", "padded_out_stride",
           "reset_launch_count", "transpose_cluster_plan", "transposed_out",
           "two_pass_launch_count"]

# The lengths of the one-pass cluster kernel
# (``csrc/fft_rows_transpose_cluster.cu``; 16384 is K2's), its CTAs a
# cluster (a non-portable size) and signal rows a cluster (``kLog2Ctas`` and
# ``kLog2Rows`` there).
TRANSPOSE_CLUSTER_LENGTHS = (1 << 14, 1 << 15, 1 << 16)
TRANSPOSE_CLUSTER_CTAS = 16
TRANSPOSE_CLUSTER_ROWS = 4

_launches = 0
_two_pass_launches = 0
_padded_launches = 0


def launch_count() -> int:
    """CUDA launches of K2b since the last reset: one a call of the cluster
    kernel, two a chunk of rows of the two passes."""
    return _launches


def two_pass_launch_count() -> int:
    """The launches of the two passes (n above the cluster lengths) among
    ``launch_count``'s."""
    return _two_pass_launches


def padded_launch_count() -> int:
    """The calls of the cluster kernel and the chunks of the two passes that
    wrote their output at a row stride above its rows (``pad_stride=True``
    and rows not a multiple of 4)."""
    return _padded_launches


def reset_launch_count() -> None:
    global _launches, _two_pass_launches, _padded_launches
    _launches = _two_pass_launches = _padded_launches = 0


def padded_out_stride(n: int, rows: int) -> int:
    """The row stride of K2's or K2b's ``(n, rows)`` output where the caller
    lets it pad: ``rows`` rounded up to a multiple of
    ``TRANSPOSE_CLUSTER_ROWS`` (4 complex64, a 32-byte sector) where the
    kernel that serves ``n`` takes an ``out_stride`` (the cluster kernel from
    16384, the two passes above 65536), else ``rows``."""
    if n < TRANSPOSE_CLUSTER_LENGTHS[0]:
        return rows
    return -(-rows // TRANSPOSE_CLUSTER_ROWS) * TRANSPOSE_CLUSTER_ROWS


def transposed_out(x: torch.Tensor, n: int, rows: int,
                   pad_stride: bool) -> tuple[torch.Tensor, int]:
    """The output buffer of a transposed store of ``x``'s ``rows`` rows of
    length ``n``, ``(n, stride)``, and its stride: ``padded_out_stride(n,
    rows)`` where ``pad_stride``, else ``rows``.  The answer is the buffer's
    first ``rows`` columns."""
    stride = padded_out_stride(n, rows) if pad_stride else rows
    return torch.empty((n, stride), dtype=x.dtype, device=x.device), stride


def transpose_cluster_plan(n: int) -> tuple[int, int, int, int, int, int]:
    """The one-pass kernel's launch shape at ``n`` (``ClusterPlan`` of
    ``csrc/fourstep_cluster.cuh`` as ``csrc/fft_rows_transpose_cluster.cu``
    instantiates it): ``(n1, n2, ctas, rows_per_cluster, threads,
    smem_bytes)``, n2 = 32*ctas (each rank loads 32 columns) and n1 = n/n2.
    A cluster holds ``rows_per_cluster`` signal rows, and each of its CTAs
    runs n/(16*ctas) threads a row (16 points each, n2/ctas columns of n1
    and then n1/ctas rows of n2) over a buffer of (n/ctas)*17/16 complex64
    a row: at 16384 (32, 512), 256 threads and 34816 bytes, four CTAs an
    SM."""
    if n not in TRANSPOSE_CLUSTER_LENGTHS:
        raise ValueError(f"transpose_cluster_plan: no cluster kernel at length {n}; it "
                         f"takes {list(TRANSPOSE_CLUSTER_LENGTHS)}")
    ctas, rows = TRANSPOSE_CLUSTER_CTAS, TRANSPOSE_CLUSTER_ROWS
    n1, n2 = large_split(n, n2=32 * ctas)
    elements = n // ctas
    return (n1, n2, ctas, rows, rows * elements // _POINTS,
            8 * rows * (elements + -(-elements // 16)))


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


def fft_rows_transpose_cluster_cuda(x: torch.Tensor, *, inverse: bool = False,
                                    pad_stride: bool = False) -> torch.Tensor:
    """Launch ``csrc/fft_rows_transpose_cluster.cu`` once: (rows, n)
    complex64 CUDA tensor, n in ``TRANSPOSE_CLUSTER_LENGTHS``, ->
    ``FFT_rows(x).T`` of shape (n, rows) in the shape
    ``transpose_cluster_plan(n)``, contiguous; with ``pad_stride``, a view
    of an ``(n, padded_out_stride(n, rows))`` buffer.  No scratch.  Does not
    synchronise."""
    global _launches, _padded_launches
    rows, n = check_kernel_input(x, "fft_rows_transpose_cluster_cuda")
    transpose_cluster_plan(n)
    out, stride = transposed_out(x, n, rows, pad_stride)
    if rows == 0:
        return out
    launch("repro_fft_rows_transpose_cluster", x, out, rows=rows, n=n,
           inverse=int(inverse), out_stride=stride)
    _launches += 1
    _padded_launches += stride > rows
    return out if stride == rows else out[:, :rows]


def fft_rows_transpose_large_cuda(x: torch.Tensor, *, inverse: bool = False,
                                  pad_stride: bool = False) -> torch.Tensor:
    """K2b on a (rows, n) complex64 CUDA tensor -> ``FFT_rows(x).T`` of shape
    (n, rows), contiguous, or with ``pad_stride`` a view of an ``(n,
    padded_out_stride(n, rows))`` buffer.  At n in
    ``TRANSPOSE_CLUSTER_LENGTHS`` one launch of the cluster kernel
    (``fft_rows_transpose_cluster_cuda``); above,
    ``csrc/fft_rows_transpose_large.cu``'s two passes by chunk of
    ``scratch_rows(n)`` rows at the split of ``two_pass_split`` (both
    factors in the kernels' range, ``kernel_split``), pass A's shape
    ``columns_plan(n1)``, pass B's ``rows_plan(n2, cap*n1)`` with cap =
    ``scratch_capacity(chunk rows)``.  Does not synchronise."""
    global _launches, _two_pass_launches, _padded_launches
    rows, n = check_kernel_input(x, "fft_rows_transpose_large_cuda")
    if n in TRANSPOSE_CLUSTER_LENGTHS:
        return fft_rows_transpose_cluster_cuda(x, inverse=inverse, pad_stride=pad_stride)
    n1, n2 = kernel_split(n, two_pass_split(n)[0], "fft_rows_transpose_large_cuda")
    out, stride = transposed_out(x, n, rows, pad_stride)
    if rows == 0:
        return out
    chunk = scratch_rows(n)
    scratch = torch.empty((scratch_capacity(min(rows, chunk)), n), dtype=x.dtype,
                          device=x.device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        rows_per_cta, threads, _ = rows_plan(n2, scratch_capacity(r1 - r0) * n1)
        launch("repro_fft_rows_transpose_large", x[r0:r1], out[:, r0:],
               scratch=scratch.data_ptr(), rows=r1 - r0, n1=n1, n2=n2,
               inverse=int(inverse), out_stride=stride, rows_per_cta=rows_per_cta,
               threads=threads)
        _launches += 2
        _two_pass_launches += 2
        _padded_launches += stride > rows
    return out if stride == rows else out[:, :rows]
