"""The complex row FFT of long rows, K1b: the plain PyTorch version, the
launch plans and the launcher of the CUDA kernels ``csrc/fft_rows_cluster.cu``
(n <= ``CLUSTER_MAX_N``) and ``csrc/fft_rows_large.cu`` (above).

Counterpart of ``repro.kernels.fft.kernel.fft_rows_pallas`` at the lengths
the register-resident K1 (``kernels.fft.kernel``, n <= ``MAX_KERNEL_N``)
cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to ``MAX_LARGE_N``.
The four-step: with n = n1 * n2 (``large_split``) and row r viewed as
``A[j1][j2] = x[j1*n2 + j2]``,

    X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2]

At n = 2^15 ... 2^18 (``CLUSTER_LENGTHS``) one kernel,
``csrc/fft_rows_cluster.cu``, computes it in one launch: a thread-block
cluster of C = ``CLUSTER_CTAS[n]`` CTAs a row (8 up to 65536, 16 at 2^17 and
2^18, rows of 1 and 2 MiB), rank r running the length-n1 DFTs of its n2/C
columns, multiplying by the twiddle ``w_n^(k1*j2)`` (five sincospif a thread
and running products, to a few float32 ulps of ``large_twiddle``'s) and
sending each B[k1][j2] to the shared memory of the rank that owns row k1,
then the length-n2 DFTs of its n1/C rows of B and the transposed store
``out[k1 + n1*k2]`` (``cluster_plan`` mirrors its shape).  From 2^19 the
two passes of ``csrc/fft_rows_large.cu`` do it: pass A runs the column DFTs
and the twiddle, writing B in A's layout to a scratch buffer in device
memory, with the columns fastest in a warp (``columns_plan``: 32 columns a
CTA up to n1 = 512, so a warp moves 256 contiguous bytes of a row of the
view) and five base twiddles a thread; pass B runs the row DFTs and stores
them transposed (K2's function on each row's (n1, n2) matrix) in CTAs, or
clusters of them, that put at least ``STORE_ROWS`` rows side by side
(``rows_plan``: runs of 128 bytes or more).  The inverse conjugates the twiddles, and its 1/n1 and
1/n2 scales make 1/n.

Its fused and real siblings K2b, K3b, K4b (``kernels.fused.large``,
``kernels.fft.real_large``, ``kernels.fused.real_large``) run the same two
passes (``csrc/fourstep.cuh``) at every length and reuse ``_columns_pass``,
``_rows_pass`` and the chunking here.

Scratch (the two passes only): a call allocates ``torch.empty`` of at most
``SCRATCH_ELEMS`` complex64 elements (1 GiB), or of one row where a row alone
is larger (2 GiB at n = 2^28), and walks the rows in chunks of that many.
``launch_count`` counts every CUDA launch: one a call of the cluster kernel,
two a chunk of the two passes (pass A and pass B); ``two_pass_launch_count``
the latter alone, and ``long_cluster_launch_count`` the cluster kernel's at
n > 65536.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.fft.kernel import (_CTA_THREADS, _MIN_CTAS, _POINTS, MAX_KERNEL_N,
                                            check_kernel_input, launch,
                                            stockham_planes_radix4)

__all__ = ["CLUSTER_CTAS", "CLUSTER_LENGTHS", "CLUSTER_MAX_N", "COLUMNS", "MIN_FACTOR",
           "ROWS_THREADS", "SCRATCH_ELEMS", "STORE_ROWS", "cluster_plan", "columns_plan",
           "fft_rows_cluster_cuda", "fft_rows_large_cuda", "fft_rows_large_plain",
           "kernel_split", "large_split", "large_twiddle", "launch_count",
           "long_cluster_launch_count", "reset_launch_count",
           "rows_plan", "scratch_capacity", "scratch_rows", "two_pass_launch_count",
           "two_pass_split"]

# The kernel's factors n1 and n2 lie in [MIN_FACTOR, MAX_KERNEL_N]
# (``kMinLog2`` and ``kMaxLog2`` of ``csrc/fft_rows_large.cu``).
MIN_FACTOR = 128
# Pass A's columns a CTA in the complex modes where they fit (``kColumns`` of
# ``csrc/fourstep.cuh``), and the rows of B pass B stores side by side at
# least (``kStoreRows``: 128-byte runs).
COLUMNS = 32
STORE_ROWS = 16
# The threads a pass-B CTA may take to hold them (``kRowsThreads``).
ROWS_THREADS = 1024
# Complex64 elements of scratch a call allocates at most (1 GiB), unless one
# row alone is longer.
SCRATCH_ELEMS = 1 << 27
# The lengths of the one-pass cluster kernel (``csrc/fft_rows_cluster.cu``)
# and its CTAs a cluster at each (``log2_ctas`` there): a portable 8 up to
# 65536, a non-portable 16 above.
CLUSTER_CTAS = {1 << 15: 8, 1 << 16: 8, 1 << 17: 16, 1 << 18: 16}
CLUSTER_LENGTHS = tuple(CLUSTER_CTAS)
CLUSTER_MAX_N = max(CLUSTER_LENGTHS)

_launches = 0
_two_pass_launches = 0
_long_cluster_launches = 0


def launch_count() -> int:
    """CUDA launches of K1b since the last reset: one a call of the cluster
    kernel, two a chunk of rows of the two passes."""
    return _launches


def two_pass_launch_count() -> int:
    """The launches of the two passes (above ``CLUSTER_MAX_N``) among
    ``launch_count``'s."""
    return _two_pass_launches


def long_cluster_launch_count() -> int:
    """The launches of the cluster kernel at n > 65536 (2^17, 2^18) among
    ``launch_count``'s."""
    return _long_cluster_launches


def reset_launch_count() -> None:
    global _launches, _two_pass_launches, _long_cluster_launches
    _launches = _two_pass_launches = _long_cluster_launches = 0


def large_split(n: int, *, n1: int | None = None,
                n2: int | None = None) -> tuple[int, int]:
    """The four-step factors ``(n1, n2)`` of a power-of-two ``n``: by default
    the near-square ``n1 = 2^floor(log2(n) / 2)``, ``n2 = n / n1 >= n1``
    (pass A, the column pass, gets the shorter columns and so more of them a
    CTA); ``n1`` or ``n2`` pins the split.  Both are powers of two >= 2."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"large_split: length {n} must be a power of two >= 4")
    if n1 is None and n2 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
    n1 = n // n2 if n1 is None else int(n1)
    n2 = n // n1 if n2 is None else int(n2)
    if n1 < 2 or n2 < 2 or n1 & (n1 - 1) or n2 & (n2 - 1) or n1 * n2 != n:
        raise ValueError(f"large_split: ({n1}, {n2}) is not a split of {n} into "
                         "powers of two >= 2")
    return n1, n2


def columns_plan(n1: int) -> tuple[int, int, int]:
    """Pass A's launch shape in the complex modes (K1b, K2b) for columns of
    length ``n1`` (``ColPlan`` of ``csrc/fourstep.cuh``): ``(cols, threads,
    smem_bytes)``.  A CTA takes ``cols`` adjacent columns of one row, n1/16
    threads a column with 16 points each, thread t*cols + c on column c (the
    columns fastest): ``COLUMNS`` where they fit in 1024 threads (n1 <=
    512), so that a warp loads and stores 32 adjacent elements of a row of
    the view, 256 contiguous bytes; else as many as 1024 threads hold (16 at
    n1 = 1024 ... 1 at 16384).  The exchange buffer interleaves the columns
    (below 16 of them padded by ``cols`` slots a block of 16*cols) and
    takes as many bytes as regfft's for ``cols`` rows of n1."""
    group = n1 // _POINTS
    cols = COLUMNS if COLUMNS * group <= 1024 else 1024 // group
    elements = cols * n1
    return cols, cols * group, 8 * (elements + -(-elements // 16))


def rows_plan(n2: int, rows: int) -> tuple[int, int, int]:
    """Pass B's launch shape in the complex modes (``RowsPlan`` of
    ``csrc/fourstep.cuh``) for ``rows`` rows of B of length ``n2``:
    ``(rows_per_cta, threads, ctas)``.  A CTA holds as many rows as make
    ``STORE_ROWS`` (16: runs of 128 bytes) within ``ROWS_THREADS`` threads,
    and at least K1's CTA (``complex_rows_plan``: 32 rows at n2 = 128),
    fewer (down to one row or one warp) while the grid would not fill the
    card, as K1's; where fewer than ``STORE_ROWS`` fit (n2 >= 2048),
    ``ctas`` CTAs of a cluster (up to 16) store their rows side by side.  A
    warp's store then writes runs of 8*min(rows_per_cta*ctas, 32) bytes."""
    group = n2 // _POINTS
    wide = min(STORE_ROWS, max(1, ROWS_THREADS // group))
    most = max(max(1, _CTA_THREADS // group), wide)
    per_cta = most
    while per_cta > 1 and per_cta * group > 32 and -(-rows // per_cta) < _MIN_CTAS:
        per_cta //= 2
    ctas = 1 if most >= STORE_ROWS else min(16, STORE_ROWS // most)
    return per_cta, per_cta * group, ctas


def cluster_plan(n: int) -> tuple[int, int, int, int, int]:
    """The one-pass kernel's launch shape at ``n`` (``ClusterPlan`` of
    ``csrc/fourstep_cluster.cuh`` as ``csrc/fft_rows_cluster.cu``
    instantiates it): ``(n1, n2, ctas, threads, smem_bytes)``, the split
    ``large_split(n)``'s over ``CLUSTER_CTAS[n]`` CTAs.  A cluster holds one
    row; each CTA runs n/(16*ctas) threads (16 points each, n2/ctas columns
    of n1 and then n1/ctas rows of n2) over one buffer of (n/ctas)*17/16
    complex64."""
    if n not in CLUSTER_LENGTHS:
        raise ValueError(f"cluster_plan: no cluster kernel at length {n}; it takes "
                         f"{list(CLUSTER_LENGTHS)}")
    n1, n2 = large_split(n)
    ctas = CLUSTER_CTAS[n]
    elements = n // ctas
    return n1, n2, ctas, elements // _POINTS, 8 * (elements + -(-elements // 16))


def scratch_rows(n: int) -> int:
    """Rows of length ``n`` a call transforms per chunk (and holds in
    scratch): ``SCRATCH_ELEMS // n``, at least one."""
    return max(1, SCRATCH_ELEMS // n)


def scratch_capacity(rows: int) -> int:
    """Rows of scratch a transposed call (K2b) keeps per k1: the least power
    of two >= ``rows``, at most ``scratch_rows(n)`` for a chunk."""
    return 1 << max(0, rows - 1).bit_length()


def large_twiddle(m: torch.Tensor, n: int, *, inverse: bool = False) -> torch.Tensor:
    """``w_n^m = exp(sign*2*pi*i*m/n)`` for int64 ``m`` in [0, n), as pass A
    makes it: ``m = mh*2^14 + ml`` and ``w^m = w^(mh*2^14) * w^ml``, the
    cosine and sine of the exact float32 arguments ``mh*2^15/n`` and
    ``2*ml/n`` (times pi) each rounded to float32, as ``sincospif`` gives
    them to about an ulp, and their complex64 product.  One argument
    ``2m/n`` would not be exact in float32 above n = 2^24."""
    sign = 1.0 if inverse else -1.0
    log2n = n.bit_length() - 1

    def unit(a: torch.Tensor) -> torch.Tensor:
        angle = a.double() * math.pi
        return torch.complex(torch.cos(angle).float(), sign * torch.sin(angle).float())

    high = unit((m >> 14).float() * 2.0 ** (15 - log2n))
    low = unit((m & 16383).float() * 2.0 ** (1 - log2n))
    return high * low


def _columns_pass(x: torch.Tensor, n1: int, n2: int, inverse: bool) -> torch.Tensor:
    """Pass A, written out: the length-n1 DFTs down the columns of each
    row's (n1, n2) view (``stockham_planes_radix4``) times the twiddle of
    ``large_twiddle``.  (rows, n) complex64 -> B as a (rows, n1, n2) view,
    ``B[s][k1][j2]``."""
    rows, n = x.shape
    cols = torch.view_as_real(x.reshape(rows, n1, n2).transpose(1, 2).contiguous())
    re, im = stockham_planes_radix4(cols[..., 0], cols[..., 1], inverse=inverse)
    j2 = torch.arange(n2, device=x.device)[:, None]
    k1 = torch.arange(n1, device=x.device)[None, :]
    b = torch.complex(re, im) * large_twiddle(j2 * k1, n, inverse=inverse)
    return b.transpose(1, 2)


def _rows_pass(b: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Pass B's transforms: the length-n2 DFTs along the last axis of B as
    pass A stored it (a contiguous copy of the view ``b``)."""
    planes = torch.view_as_real(b.contiguous())
    re, im = stockham_planes_radix4(planes[..., 0], planes[..., 1], inverse=inverse)
    return torch.complex(re, im)


def fft_rows_large_plain(x: torch.Tensor, *, inverse: bool = False,
                         n1: int | None = None, n2: int | None = None) -> torch.Tensor:
    """K1b's plain version: (rows, n) complex64 -> its row-wise DFT by the
    same two passes, on whatever device ``x`` lies on: the length-n1 DFTs
    of the columns (``stockham_planes_radix4``), the twiddle of
    ``large_twiddle``, B stored as ``[s][k1][j2]``, the length-n2 DFTs of
    B's rows and the transposed store ``out[s, k1 + n1*k2]``, each written
    out.  ``n1`` / ``n2`` pin the split."""
    rows, n = x.shape
    n1, n2 = large_split(n, n1=n1, n2=n2)
    c = _rows_pass(_columns_pass(x, n1, n2, inverse), inverse)    # C[s][k1][k2]
    return c.transpose(1, 2).reshape(rows, n)


def two_pass_split(n: int) -> tuple[int, int]:
    """The two passes' default split ``(n1, n2)`` of a power of two ``n`` in
    [2^15, 2^28], the one that measured fastest on an H100 over n1 at every
    length 2^17 ... 2^27 (``examples/kernel_check_torch.py
    --four-step-two-pass-only``): n2 = 512 up to n = 2^20 (pass B in CTAs
    of 16 rows of 512 threads), above it the near-square split with n1 >= n2
    and n1 at most 4096 (pass A's CTA then holds at least 4 columns) while
    n2 stays at most ``MAX_KERNEL_N``; n1 at least ``MIN_FACTOR``.  The
    plain versions, the cluster kernels and the packed real kernels' two
    passes keep ``large_split``'s."""
    log2n = n.bit_length() - 1
    n2 = 512 if log2n <= 20 else max(1 << (log2n // 2), n // 4096)
    n2 = min(n2, MAX_KERNEL_N, n // MIN_FACTOR)
    return n // n2, n2


def kernel_split(n: int, n1: int | None, name: str) -> tuple[int, int]:
    """``large_split(n, n1=n1)`` where both factors lie in the kernels'
    range [``MIN_FACTOR``, ``MAX_KERNEL_N``]; ``name`` is the launcher named
    in the error."""
    n1, n2 = large_split(n, n1=n1)
    if not (MIN_FACTOR <= n1 <= MAX_KERNEL_N and MIN_FACTOR <= n2 <= MAX_KERNEL_N):
        raise ValueError(f"{name}: the split ({n1}, {n2}) of {n} has a "
                         f"factor outside [{MIN_FACTOR}, {MAX_KERNEL_N}]")
    return n1, n2


def fft_rows_cluster_cuda(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Launch ``csrc/fft_rows_cluster.cu`` once: (rows, n) complex64 CUDA
    tensor, n in ``CLUSTER_LENGTHS``, -> its row-wise DFT in the shape
    ``cluster_plan(n)``.  No scratch.  Does not synchronise."""
    global _launches, _long_cluster_launches
    rows, n = check_kernel_input(x, "fft_rows_cluster_cuda")
    cluster_plan(n)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    launch("repro_fft_rows_cluster", x, out, rows=rows, n=n, inverse=int(inverse))
    _launches += 1
    if n > 1 << 16:
        _long_cluster_launches += 1
    return out


def fft_rows_large_cuda(x: torch.Tensor, *, inverse: bool = False,
                        n1: int | None = None) -> torch.Tensor:
    """K1b on a (rows, n) complex64 CUDA tensor -> its row-wise DFT.  At n <=
    ``CLUSTER_MAX_N`` one launch of the cluster kernel in its rule's shape
    (``fft_rows_cluster_cuda``); above, ``csrc/fft_rows_large.cu``'s two
    passes by chunk of ``scratch_rows(n)`` rows at the split of
    ``two_pass_split`` (``n1`` pins it; both factors in [``MIN_FACTOR``,
    ``MAX_KERNEL_N``]); pass A's shape is ``columns_plan(n1)``, pass B's
    ``rows_plan(n2, chunk_rows*n1)``.  Does not synchronise."""
    global _launches, _two_pass_launches
    rows, n = check_kernel_input(x, "fft_rows_large_cuda")
    if n <= CLUSTER_MAX_N:
        if n1 is not None:
            raise ValueError(f"fft_rows_large_cuda: at n = {n} the cluster kernel runs "
                             "in the split of cluster_plan(n)")
        return fft_rows_cluster_cuda(x, inverse=inverse)
    n1, n2 = kernel_split(n, two_pass_split(n)[0] if n1 is None else n1,
                          "fft_rows_large_cuda")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    chunk = scratch_rows(n)
    scratch = torch.empty((min(rows, chunk), n), dtype=x.dtype, device=x.device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        rows_per_cta, threads, _ = rows_plan(n2, (r1 - r0) * n1)
        launch("repro_fft_rows_large", x[r0:r1], out[r0:r1],
               scratch=scratch.data_ptr(), rows=r1 - r0, n1=n1, n2=n2,
               inverse=int(inverse), rows_per_cta=rows_per_cta, threads=threads)
        _launches += 2
        _two_pass_launches += 2
    return out
