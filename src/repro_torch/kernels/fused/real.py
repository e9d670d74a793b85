"""Fused *real* row FFT -> transposed write: the plain PyTorch version, the
launcher of the CUDA kernel ``csrc/rfft_rows_transpose.cu`` and the public op.

Counterpart of ``repro.kernels.fused.real``: the real-pipeline sibling of
``kernels.fused``.  Two real rows are packed per complex FFT and split as in
``kernels.fft.real``, and both half spectra are stored straight to their
transposed place in the ``(n//2+1, rows)`` output — phase 1 of the fused real
2-D DFT, with no half-spectrum matrix in device memory between the row
transforms and the transpose.

The CUDA kernel runs ``rfft_rows.cu``'s register-resident passes
(``csrc/regfft.cuh``) in the launch shape ``complex_rows_plan`` gives for the
row pairs, then stores the split transposed with the pairs of a CTA side by
side in each output row; where a CTA holds one pair (n = 4096 and 8192), the
CTAs of a thread-block cluster store their pairs side by side, each a slice
of the bins (``rfft_rows_transpose_plan``).  ``radix`` is validated, as in
the reference, and chooses the plain version's stage loop only.

That kernel stops at n = 8192.  At 16384, where its pair would take a whole
SM (1024 threads, 136 KiB) with no load in flight through its passes and
cluster store, the op launches ``csrc/rfft_rows_transpose_16k.cu``: each pair
split over the CTAs of a thread-block cluster as K2 at 16384 splits a complex
row (the four-step of ``csrc/fourstep_cluster.cuh``, the points sent to the
mirror slots of ``csrc/rfft_rows_cluster.cuh`` so that the split runs on
chip), four CTAs an SM, the cluster's pairs stored side by side: 8 CTAs of 2
pairs where the row count is a multiple of 4 (32-byte runs, whole sectors),
16 of 4 elsewhere (64-byte runs; ``rfft_transpose_16k_plan``)."""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import (_CTA_THREADS, _POINTS, MAX_KERNEL_N,
                                            check_kernel_input, complex_rows_plan, launch)
from repro_torch.kernels.fft.ops import resolve_radix
from repro_torch.kernels.fft.real import prepare_real_rows, rfft_rows_plain
from repro_torch.kernels.fused.real_large import (rfft_rows_transpose_large_cuda,
                                                  rfft_rows_transpose_large_plain)

__all__ = ["RFFT_TRANSPOSE_16K_SHAPE", "RFFT_TRANSPOSE_16K_WIDE_SHAPE", "STORE_CLUSTER",
           "launch_count", "launch_count_16k", "reset_launch_count",
           "rfft_rows_transpose_cuda", "rfft_rows_transpose_op",
           "rfft_rows_transpose_plain", "rfft_rows_transpose_plan",
           "rfft_transpose_16k_plan"]

# CTAs of a cluster that store their pairs side by side where a CTA holds
# one pair (``kStoreCluster`` of ``csrc/rfft_rows_transpose.cu``).
STORE_CLUSTER = 4
# (CTAs, pairs) a cluster of ``csrc/rfft_rows_transpose_16k.cu`` (K4 at n =
# MAX_KERNEL_N): where the row count is a multiple of 4, so that the 2 pairs'
# 4 real rows of a bin are whole 32-byte sectors (``kLog2Ctas``,
# ``kLog2Pairs`` there), and elsewhere (``kWideLog2Ctas``,
# ``kWideLog2Pairs``: 4 pairs, 64-byte runs).
RFFT_TRANSPOSE_16K_SHAPE = (8, 2)
RFFT_TRANSPOSE_16K_WIDE_SHAPE = (16, 4)

_launches = 0
_launches_16k = 0


def launch_count() -> int:
    """How many times ``rfft_rows_transpose_cuda`` has launched a kernel
    (either source)."""
    return _launches


def launch_count_16k() -> int:
    """The launches of ``csrc/rfft_rows_transpose_16k.cu`` (n = 16384) among
    ``launch_count``'s."""
    return _launches_16k


def reset_launch_count() -> None:
    global _launches, _launches_16k
    _launches = _launches_16k = 0


def rfft_rows_transpose_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: the packed real row FFT, then a
    transposed copy.  (rows, n) float32 -> (n//2+1, rows) complex64."""
    return rfft_rows_plain(x, radix=radix).T.contiguous()


def rfft_rows_transpose_plan(n: int, rows: int) -> tuple[int, int, int, int]:
    """The launch shape of ``csrc/rfft_rows_transpose.cu`` for ``rows`` real
    rows of length ``n`` < ``MAX_KERNEL_N``: ``(pairs_per_cta, threads,
    cluster, blocks)``.  Pairs per CTA and threads are
    ``complex_rows_plan``'s for the row pairs; where a CTA holds one pair (a
    pair needs the CTA's 256 threads or more, n = 4096 and 8192) CTAs run in
    clusters of ``STORE_CLUSTER``, over a grid padded to a multiple of it,
    else alone (``cluster`` 1)."""
    if n >= MAX_KERNEL_N:
        raise ValueError(f"rfft_rows_transpose_plan: the register kernel stops at "
                         f"{MAX_KERNEL_N // 2}; {n} is rfft_transpose_16k_plan's")
    pairs = (rows + 1) // 2
    per_cta, threads, points, _, _ = complex_rows_plan(n, pairs)
    cluster = STORE_CLUSTER if n // points >= _CTA_THREADS else 1
    ctas = -(-pairs // per_cta)
    return per_cta, threads, cluster, -(-ctas // cluster) * cluster


def rfft_transpose_16k_plan(rows: int) -> tuple[int, int, int, int, int, int, int]:
    """The launch of ``csrc/rfft_rows_transpose_16k.cu`` (``ClusterPlan`` of
    ``csrc/fourstep_cluster.cuh`` as its ``packed_transpose_kernel``
    instantiates it) for ``rows`` rows of n = ``MAX_KERNEL_N``: ``(n1, n2,
    ctas, pairs_per_cluster, threads, smem_bytes, blocks)``.  The cluster is
    ``RFFT_TRANSPOSE_16K_SHAPE`` where ``rows`` is a multiple of 4, else
    ``RFFT_TRANSPOSE_16K_WIDE_SHAPE``; n1 = 32 and n2 = n/n1 = 512 in both,
    each CTA running n/(16*ctas) threads a pair (16 points each, n2/ctas
    columns of n1, then n1/ctas rows of n2) over (n/ctas)*17/16 complex64 a
    pair: 256 threads and 34816 bytes, four CTAs an SM; ``blocks`` = ctas a
    cluster, ceil(pairs / pairs_per_cluster) clusters."""
    n, n1 = MAX_KERNEL_N, 32
    ctas, per = (RFFT_TRANSPOSE_16K_SHAPE if rows % 4 == 0
                 else RFFT_TRANSPOSE_16K_WIDE_SHAPE)
    elements = n // ctas
    clusters = -(-((rows + 1) // 2) // per)
    return (n1, n // n1, ctas, per, per * elements // _POINTS,
            8 * per * (elements + -(-elements // 16)), clusters * ctas)


def rfft_rows_transpose_cuda(x: torch.Tensor, *, radix: int = 4) -> torch.Tensor:
    """K4 on a (rows, n) float32 CUDA tensor -> ``rfft_rows(x).T`` of shape
    (n//2+1, rows), complex64, one launch a call: below ``MAX_KERNEL_N``
    ``csrc/rfft_rows_transpose.cu`` in the launch shape of
    ``rfft_rows_transpose_plan`` (the C side picks the cluster from n), at
    ``MAX_KERNEL_N`` ``csrc/rfft_rows_transpose_16k.cu`` over clusters
    (``rfft_transpose_16k_plan``, computed by the C side from n and rows);
    rows longer than ``MAX_KERNEL_N`` (up to ``MAX_LARGE_N``) go to K4b
    (``kernels.fused.real_large``).  Does not synchronise."""
    global _launches, _launches_16k
    rows, n = check_kernel_input(x, "rfft_rows_transpose_cuda", torch.float32)
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if n > MAX_KERNEL_N:
        return rfft_rows_transpose_large_cuda(x)
    out = torch.empty((n // 2 + 1, rows), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    if n == MAX_KERNEL_N:
        launch("repro_rfft_rows_transpose_16k", x, out, rows=rows, n=n)
        _launches_16k += 1
    else:
        pairs_per_cta, threads, *_ = rfft_rows_transpose_plan(n, rows)
        launch("repro_rfft_rows_transpose", x, out, rows=rows, n=n, radix=radix,
               rows_per_cta=pairs_per_cta, threads=threads)
    _launches += 1
    return out


def rfft_rows_transpose_op(x, *, radix: int | None = None) -> torch.Tensor:
    """Fused ``rfft_rows(x).T``.

    x: (rows, n) real -> (n//2+1, rows) complex, the transposed half
    spectrum; n a power of two up to ``MAX_LARGE_N``: K4 (one launch) up to
    ``MAX_KERNEL_N``, the four-step K4b above (on the CPU,
    ``rfft_rows_transpose_large_plain``).  ``radix=None`` auto-selects.
    Computes in float32 and returns ``promote(x.dtype, complex64)``.
    """
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"fused op takes a 2-D matrix, got shape {tuple(x.shape)}")
    n = x.shape[1]
    x2 = prepare_real_rows(x, "rfft_rows_transpose_op")
    radix = resolve_radix(n, radix, "rfft_rows_transpose_op")
    out_dtype = complex_result_type(x)
    if n == 1:  # the length-1 DFT is the identity: only the transpose is left
        return x2.to(out_dtype).T.contiguous()
    if x2.is_cuda:
        out = rfft_rows_transpose_cuda(x2, radix=radix)
    elif n > MAX_KERNEL_N:
        out = rfft_rows_transpose_large_plain(x2)
    else:
        out = rfft_rows_transpose_plain(x2, radix=radix)
    return out.to(out_dtype)
