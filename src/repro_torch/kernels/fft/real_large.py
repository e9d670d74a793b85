"""The packed real row FFT of long rows, K3b: the plain PyTorch version and
the launcher of the CUDA kernel ``csrc/rfft_rows_large.cu``, and the passes
it shares with K4b (``kernels.fused.real_large``).

Counterpart of ``repro.kernels.fft.real.rfft_rows_pallas`` at the lengths
the register-resident K3 (``kernels.fft.real``, n <= ``MAX_KERNEL_N``)
cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to
``MAX_LARGE_N``.  Two real rows a, b are packed as ``z = a + i*b`` by pass
A's load, K1b's two passes (``kernels.fft.large``) give ``Z = DFT(z)`` in
natural order in a second scratch buffer, and pass C splits it:

    A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2,   B[k] = (Z[k] - conj Z[(n-k) mod n]) / 2i

for k <= n/2, stored as rows 2p and 2p + 1 of the half spectrum (K3b) or
as columns of its transpose (K4b).  An unpaired last row gets b = 0 and its
B is not stored.

Scratch: two buffers of at most ``scratch_rows(n)`` row pairs each (1 GiB
each, or one pair where a row is longer), walked in chunks of that many
pairs; three launches a chunk (passes A, B and C).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import check_kernel_input, complex_rows_plan, launch
from repro_torch.kernels.fft.large import (fft_rows_large_plain, kernel_split,
                                           scratch_rows)

__all__ = ["launch_count", "launch_real_large", "pack_pairs", "reset_launch_count",
           "rfft_rows_large_cuda", "rfft_rows_large_plain", "split_pairs"]

_launches = 0


def launch_count() -> int:
    """CUDA launches of K3b since the last reset: three per chunk of pairs."""
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


def split_pairs(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass C's arithmetic: (pairs, n) ``Z`` -> the (pairs, n//2+1) half
    spectra A and B of each pair, from Z[k] and Z[(n-k) mod n] in float32
    planes as the kernel computes them."""
    n = z.shape[-1]
    k = torch.arange(n // 2 + 1, device=z.device)
    zk, zr = z[:, :n // 2 + 1], z[:, (n - k) % n]
    a = torch.complex(0.5 * (zk.real + zr.real), 0.5 * (zk.imag - zr.imag))
    b = torch.complex(0.5 * (zk.imag + zr.imag), 0.5 * (zr.real - zk.real))
    return a, b


def rfft_rows_large_plain(x: torch.Tensor, *, n1: int | None = None,
                          n2: int | None = None) -> torch.Tensor:
    """K3b's plain version: (rows, n) float32 -> (rows, n//2+1) complex64 by
    the same passes: the packing load, K1b's passes
    (``fft_rows_large_plain``) and the split, rows 2p and 2p + 1 stored
    side by side.  ``n1`` / ``n2`` pin the split."""
    rows, n = x.shape
    a, b = split_pairs(fft_rows_large_plain(pack_pairs(x), n1=n1, n2=n2))
    return torch.stack([a, b], dim=1).reshape(-1, n // 2 + 1)[:rows]


def launch_real_large(fn_name: str, x: torch.Tensor, out: torch.Tensor, *,
                      transposed: bool) -> int:
    """Launch K3b (``transposed`` False: ``out`` is (rows, n//2+1)) or K4b
    (``out`` is (n//2+1, rows)) over ``x``'s (rows, n) float32 rows, chunk
    by chunk of ``scratch_rows(n)`` pairs, each chunk writing its rows (or
    columns) of ``out``.  Returns the launches made: three a chunk."""
    rows, n = x.shape
    n1, n2 = kernel_split(n, None, fn_name)
    pairs, chunk = (rows + 1) // 2, scratch_rows(n)
    scratch = torch.empty((2, min(pairs, chunk), n), dtype=torch.complex64,
                          device=x.device)
    launches = 0
    for p0 in range(0, pairs, chunk):
        r0, r1 = 2 * p0, min(rows, 2 * (p0 + chunk))
        rows_per_cta, threads, *_ = complex_rows_plan(n2, (r1 - r0 + 1) // 2 * n1)
        launch(fn_name, x[r0:r1], out[:, r0:] if transposed else out[r0:],
               scratch=scratch[0].data_ptr(), zbuf=scratch[1].data_ptr(), rows=r1 - r0,
               n1=n1, n2=n2, out_stride=out.stride(0), rows_per_cta=rows_per_cta,
               threads=threads)
        launches += 3
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
