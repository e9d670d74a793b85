"""Public op for the row-FFT kernel.

Counterpart of ``repro.kernels.fft.ops``.  Handles the leading batch
dimensions, the float32 compute type and the radix default; every row kernel
takes its launch shape from ``complex_rows_plan`` (the fused ones through
their own plans), so no op takes the reference's ``block_rows``.  A CUDA
tensor goes to the CUDA kernel or the call raises; a CPU tensor goes to the
kernel's plain PyTorch version.  Nothing is padded: the kernels mask their
ragged last block.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import (MAX_KERNEL_N, MAX_LARGE_N,
                                            KernelLengthError, fft_rows_cuda,
                                            fft_rows_plain)
from repro_torch.kernels.fft.large import fft_rows_large_plain

__all__ = ["fft_rows_op", "pick_radix", "prepare_rows", "resolve_radix"]


def pick_radix(n: int) -> int:
    """Radix for a power-of-two length: 4 whenever a radix-4 pass exists
    (n >= 4) — half the Stockham passes — else 2."""
    return 4 if n >= 4 else 2


def resolve_radix(n: int, radix: int | None, name: str) -> int:
    """Shared prologue of the row-FFT op wrappers: validate the length (a
    power of two up to ``MAX_LARGE_N``: every row op runs its four-step
    kernel above ``MAX_KERNEL_N``) and fill in the radix default.  ``name``
    is the op named in errors."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"cuda fft kernel requires power-of-two length, got {n}")
    if n > MAX_LARGE_N:
        raise KernelLengthError(name, n, MAX_LARGE_N)
    if radix is None:
        radix = pick_radix(n)
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    return radix


def prepare_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """The kernels compute in float32 whatever comes in: cast to complex64.
    Input that is not contiguous is refused, on either device, so that no
    hidden copy hides in a measured phase."""
    if not x.is_contiguous():
        raise ValueError(
            f"{name}: input must be contiguous (make the copy explicit with "
            ".contiguous())")
    return x if x.dtype == torch.complex64 else x.to(torch.complex64)


def fft_rows_op(x, *, inverse: bool = False,
                radix: int | None = None) -> torch.Tensor:
    """Complex row FFT via the CUDA kernel. x: (..., rows, n) complex, n a
    power of two up to ``MAX_LARGE_N``: K1 up to ``MAX_KERNEL_N``, the
    four-step K1b above (one launch over clusters at n <= 2^18, two passes
    beyond; on the CPU, ``fft_rows_large_plain``).

    ``radix=None`` auto-selects (radix 4 with radix-2 tail for n >= 4); it
    chooses the plain version's stage loop up to ``MAX_KERNEL_N``, while the
    CUDA kernels' passes and launch shape depend on ``n`` only
    (``complex_rows_plan``).  Computes in float32 and returns
    ``promote(x.dtype, complex64)``.
    """
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError(f"fft_rows_op takes (..., rows, n) input, got shape {tuple(x.shape)}")
    n = x.shape[-1]
    x2 = prepare_rows(x, "fft_rows_op").reshape(-1, n)
    radix = resolve_radix(n, radix, "fft_rows_op")
    out_dtype = complex_result_type(x)
    if n == 1:  # the length-1 DFT is the identity: no pass to run
        return x2.to(out_dtype).reshape(x.shape).clone()
    if x2.is_cuda:
        out = fft_rows_cuda(x2, inverse=inverse, radix=radix)
    elif n > MAX_KERNEL_N:
        out = fft_rows_large_plain(x2, inverse=inverse)
    else:
        out = fft_rows_plain(x2, inverse=inverse, radix=radix)
    return out.to(out_dtype).reshape(x.shape)
