"""The packed real row FFT of long rows, K3b: the plain PyTorch version and
the launcher of the CUDA kernel ``csrc/rfft_rows_large.cu``, and the passes
it shares with K4b (``kernels.fused.real_large``).

Counterpart of ``repro.kernels.fft.real.rfft_rows_pallas`` at the lengths
the register-resident K3 (``kernels.fft.real``, n <= ``MAX_KERNEL_N``)
cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to
``MAX_LARGE_N``.  Two real rows a, b are packed as ``z = a + i*b`` by pass
A's load, K1b's pass A (``kernels.fft.large``) gives B, and pass B runs the
length-n2 DFTs of B's rows, ``Z[k1 + n1*k2]`` in row k1, bin k2, and splits
them in its epilogue (``slot_split``):

    A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2,   B[k] = (Z[k] - conj Z[(n-k) mod n]) / 2i

for k <= n/2, where the partner of row k1, bin k2 is row n1 - k1, bin
n2 - 1 - k2 (row 0: itself, bin (n2 - k2) mod n2).  A CTA of pass B holds
both rows of each slot (k1, n1 - k1) it splits, so Z never leaves the chip.
Stored as rows 2p and 2p + 1 of the half spectrum (K3b) or as columns of
its transpose (K4b).  An unpaired last row gets b = 0 and its B is not
stored.

Scratch: one buffer of at most ``scratch_rows(n)`` row pairs (1 GiB, or one
pair where a row is longer; K4b a power of two of them), walked in chunks
of that many pairs; two launches a chunk (passes A and B).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import (_CTA_THREADS, _MIN_CTAS, _POINTS,
                                            check_kernel_input, launch)
from repro_torch.kernels.fft.large import (_columns_pass, _rows_pass, kernel_split,
                                           large_split, scratch_capacity, scratch_rows)

__all__ = ["launch_count", "launch_real_large", "pack_pairs", "reset_launch_count",
           "rfft_rows_large_cuda", "rfft_rows_large_plain", "slot_split",
           "split_rows_plan"]

_launches = 0


def launch_count() -> int:
    """CUDA launches of K3b since the last reset: two per chunk of pairs."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def pack_pairs(x: torch.Tensor) -> torch.Tensor:
    """Pass A's load: (rows, n) float32 -> ((rows + 1) // 2, n) complex64,
    rows 2p and 2p + 1 as ``a + i*b``, b = 0 for an unpaired last row."""
    if x.shape[0] % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
    return torch.complex(x[0::2], x[1::2])


def slot_split(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass B's epilogue: pass B's rows ``C[p][k1][k2] = Z[p][k1 + n1*k2]``,
    (pairs, n1, n2) complex64, -> the (pairs, n//2+1) half spectra A and B of
    each pair.  Bin k = k1 + n1*k2 (k2 < n2/2, and k2 = n2/2 of row 0) is
    split against its partner (n - k) mod n: row n1 - k1, bin n2 - 1 - k2,
    or row 0, bin (n2 - k2) mod n2 where k1 = 0; in float32 planes as the
    kernel computes them."""
    pairs, n1, n2 = c.shape
    h = n2 // 2
    k1 = torch.arange(n1, device=c.device)[:, None]
    k2 = torch.arange(h + 1, device=c.device)[None, :]
    rows = ((n1 - k1) % n1).expand(n1, h + 1)
    bins = torch.where(k1 == 0, (n2 - k2) % n2, n2 - 1 - k2)
    zk, zr = c[:, :, :h + 1], c[:, rows, bins]
    a = torch.complex(0.5 * (zk.real + zr.real), 0.5 * (zk.imag - zr.imag))
    b = torch.complex(0.5 * (zk.imag + zr.imag), 0.5 * (zr.real - zk.real))

    def in_bin_order(s: torch.Tensor) -> torch.Tensor:
        """Bins k1 + n1*k2 of the first half, then bin n/2 (row 0, bin n2/2)."""
        return torch.cat([s[:, :, :h].transpose(1, 2).reshape(pairs, -1), s[:, 0, h:]], 1)

    return in_bin_order(a), in_bin_order(b)


def _packed_rows(x: torch.Tensor, n1: int | None, n2: int | None) -> torch.Tensor:
    """Passes A and B's DFTs of the packed pairs of ``x``: C[p][k1][k2]."""
    n1, n2 = large_split(x.shape[1], n1=n1, n2=n2)
    return _rows_pass(_columns_pass(pack_pairs(x), n1, n2, False), False)


def rfft_rows_large_plain(x: torch.Tensor, *, n1: int | None = None,
                          n2: int | None = None) -> torch.Tensor:
    """K3b's plain version: (rows, n) float32 -> (rows, n//2+1) complex64 by
    the same passes: the packing load, K1b's pass A
    (``kernels.fft.large._columns_pass``), pass B's DFTs and the slot split
    (``slot_split``), rows 2p and 2p + 1 stored side by side.  ``n1`` /
    ``n2`` pin the split."""
    rows, n = x.shape
    a, b = slot_split(_packed_rows(x, n1, n2))
    return torch.stack([a, b], dim=1).reshape(-1, n // 2 + 1)[:rows]


def split_rows_plan(n2: int, rows: int) -> tuple[int, int, int]:
    """Pass B's launch shape for ``rows`` rows of length ``n2`` (units x 2):
    ``(rows_per_cta, threads, cluster)``.  ``complex_rows_plan``'s rule with
    ``SplitPlan``'s rows a CTA (``csrc/fourstep.cuh``: twice regfft's, at
    most 32, where a CTA holds 4 or more, n2 <= 1024), fewer while the grid
    would not fill the card, and K2's cluster rule (``store_cluster`` of
    ``csrc/tstore.cuh``: 4 CTAs of one row, 2 of two); at least 2 rows, one
    slot, a cluster."""
    group = n2 // _POINTS
    max_rows = max(1, _CTA_THREADS // group)
    cluster = 4 // max_rows if max_rows < 4 else 1
    per_cta = min(32, 2 * max_rows) if max_rows >= 4 else max_rows
    while per_cta > 1 and per_cta * group > 32 and -(-rows // per_cta) < _MIN_CTAS:
        per_cta //= 2
    per_cta = max(per_cta, 2 // cluster)
    return per_cta, per_cta * group, cluster


def launch_real_large(fn_name: str, x: torch.Tensor, out: torch.Tensor, *,
                      transposed: bool) -> int:
    """Launch K3b (``transposed`` False: ``out`` is (rows, n//2+1)) or K4b
    (``out`` is (n//2+1, rows)) over ``x``'s (rows, n) float32 rows, chunk
    by chunk of ``scratch_rows(n)`` pairs, each chunk writing its rows (or
    columns) of ``out``.  K4b's scratch holds ``scratch_capacity`` pairs.
    Returns the launches made: two a chunk."""
    rows, n = x.shape
    n1, n2 = kernel_split(n, None, fn_name)
    pairs, chunk = (rows + 1) // 2, scratch_rows(n)
    first = min(pairs, chunk)
    scratch = torch.empty((scratch_capacity(first) if transposed else first, n),
                          dtype=torch.complex64, device=x.device)
    launches = 0
    for p0 in range(0, pairs, chunk):
        r0, r1 = 2 * p0, min(rows, 2 * (p0 + chunk))
        here = (r1 - r0 + 1) // 2
        held = scratch_capacity(here) if transposed else here   # pairs in scratch
        rows_per_cta, threads, _ = split_rows_plan(n2, held * n1)
        launch(fn_name, x[r0:r1], out[:, r0:] if transposed else out[r0:],
               scratch=scratch.data_ptr(), rows=r1 - r0, n1=n1, n2=n2,
               out_stride=out.stride(0), rows_per_cta=rows_per_cta, threads=threads)
        launches += 2
    return launches


def rfft_rows_large_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rfft_rows_large.cu``: (rows, n) float32 CUDA tensor ->
    its (rows, n//2+1) complex64 half spectrum per row.  Does not
    synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "rfft_rows_large_cuda", torch.float32)
    out = torch.empty((rows, n // 2 + 1), dtype=torch.complex64, device=x.device)
    if rows:
        _launches += launch_real_large("repro_rfft_rows_large", x, out, transposed=False)
    return out
