"""Blocked out-of-place 2-D transpose (the paper's Appendix-A
``hcl_transpose_block``): the plain PyTorch version and the launcher of the
CUDA kernel ``csrc/transpose.cu``.

Counterpart of ``repro.kernels.transpose.kernel``: tile ``(i, j)`` of the
input is written as tile ``(j, i)`` of the output.  A transpose moves bits, so
the kernel is bit-exact for every element type it takes (1, 2, 4, 8 or 16
bytes); complex64 moves as one 8-byte element, where the reference moves two
float planes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft.kernel import launch

__all__ = ["ELEMENT_BYTES", "launch_count", "reset_launch_count",
           "transpose_cuda", "transpose_plain"]

# The element sizes the CUDA kernel is instantiated for.
ELEMENT_BYTES = (1, 2, 4, 8, 16)

_launches = 0


def launch_count() -> int:
    """How many times ``transpose_cuda`` has launched its kernel."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def transpose_plain(x: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """The kernel's plain version: the reference's tile loop, tile ``(i, j)``
    of ``block x block`` copied to tile ``(j, i)``; edge tiles are cut to
    the shape.  (r, c) -> (c, r), any dtype, on whatever device ``x`` lies
    on."""
    r, c = x.shape
    out = torch.empty((c, r), dtype=x.dtype, device=x.device)
    for i in range(0, r, block):
        for j in range(0, c, block):
            out[j:j + block, i:i + block] = x[i:i + block, j:j + block].T
    return out


def transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/transpose.cu``: (r, c) contiguous CUDA tensor -> its
    (c, r) transpose, bit for bit.  Does not synchronise."""
    global _launches
    if not x.is_cuda:
        raise ValueError(f"transpose_cuda: input must be a CUDA tensor, got {x.device}")
    if x.ndim != 2:
        raise ValueError(f"transpose_cuda: input must be 2-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("transpose_cuda: input must be contiguous")
    elem = x.element_size()
    if elem not in ELEMENT_BYTES:
        raise ValueError(
            f"transpose_cuda: elements of {elem} bytes ({x.dtype}); the kernel "
            f"moves elements of {ELEMENT_BYTES} bytes")
    if x.data_ptr() % elem:
        raise ValueError(f"transpose_cuda: input not aligned to its {elem}-byte elements")
    r, c = x.shape
    out = torch.empty((c, r), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    launch("repro_transpose", x, out, r=r, c=c, elem_bytes=elem)
    _launches += 1
    return out
