"""Public op for the blocked transpose kernel.

Counterpart of ``repro.kernels.transpose.ops``.  A CUDA tensor goes to the
CUDA kernel or the call raises; a CPU tensor goes to the kernel's plain
version.  Nothing is padded or cropped: the kernel masks its edge tiles.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor
from repro_torch.kernels.transpose.kernel import transpose_cuda, transpose_plain

__all__ = ["transpose_op"]


def transpose_op(x, *, block: int = 128) -> torch.Tensor:
    """``x.T`` of a 2-D array of any shape and dtype, bit-exact, as a new
    contiguous tensor.  ``block`` is the tile of the plain version (the
    reference's default); the CUDA kernel's tile is its own, 32 x 32."""
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"transpose_op takes a 2-D matrix, got shape {tuple(x.shape)}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if not x.is_contiguous():
        raise ValueError(
            "transpose_op: input must be contiguous (make the copy explicit "
            "with .contiguous())")
    if x.is_cuda:
        return transpose_cuda(x)
    return transpose_plain(x, block=block)
