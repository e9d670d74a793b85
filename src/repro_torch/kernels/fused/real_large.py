"""The fused real row FFT -> transposed write of long rows, K4b: the plain
PyTorch version and the launcher of the CUDA kernel
``csrc/rfft_rows_transpose_large.cu``.

Counterpart of ``repro.kernels.fused.real.rfft_rows_transpose_pallas`` at the
lengths the register-resident K4 (``kernels.fused.real``, n <=
``MAX_KERNEL_N``) cannot hold: power-of-two n from 2 * ``MAX_KERNEL_N`` up to
``MAX_LARGE_N``.  K3b (``kernels.fft.real_large``) with K2b's scratch
order: pass A stores the packed pairs' B as ``[k1][p][j2]``, so that a CTA
of pass B holds one slot (k1, n1 - k1) for neighbouring pairs and stores
its split transposed, ``out[k, 2p]`` and ``out[k, 2p + 1]``, the pairs
side by side.  Two launches a chunk of pairs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import check_kernel_input
from repro_torch.kernels.fft.real_large import _packed_rows, launch_real_large, slot_split

__all__ = ["launch_count", "reset_launch_count", "rfft_rows_transpose_large_cuda",
           "rfft_rows_transpose_large_plain"]

_launches = 0


def launch_count() -> int:
    """CUDA launches of K4b since the last reset: two per chunk of pairs."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def rfft_rows_transpose_large_plain(x: torch.Tensor, *, n1: int | None = None,
                                    n2: int | None = None) -> torch.Tensor:
    """K4b's plain version: (rows, n) float32 -> (n//2+1, rows) complex64,
    ``rfft_rows(x).T``, by K3b's passes with the split of pair p stored as
    columns 2p and 2p + 1.  ``n1`` / ``n2`` pin the split."""
    rows, n = x.shape
    a, b = slot_split(_packed_rows(x, n1, n2))
    return torch.stack([a.T, b.T], dim=2).reshape(n // 2 + 1, -1)[:, :rows].contiguous()


def rfft_rows_transpose_large_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rfft_rows_transpose_large.cu``: (rows, n) float32 CUDA
    tensor -> ``rfft_rows(x).T`` of shape (n//2+1, rows), complex64.  Does
    not synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "rfft_rows_transpose_large_cuda", torch.float32)
    out = torch.empty((n // 2 + 1, rows), dtype=torch.complex64, device=x.device)
    if rows:
        _launches += launch_real_large("repro_rfft_rows_transpose_large", x, out,
                                       transposed=True)
    return out
