"""Public op for the row-FFT kernel.

Counterpart of ``repro.kernels.fft.ops``.  Handles the leading batch
dimensions, the float32 compute type and the radix default, and, for the fused
complex kernel on ``csrc/stockham.cuh`` (``fft_rows_transpose.cu``), the launch
shape (rows per CTA from a shared-memory budget, threads from the butterflies
a CTA holds); the register-resident row kernels, the fused real one among
them, take theirs from ``complex_rows_plan``.  A CUDA tensor goes to the CUDA
kernel or the call raises; a CPU tensor goes to the kernel's plain PyTorch
version.  Nothing is padded: the kernels mask their ragged last block.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import (_MIN_CTAS, MAX_KERNEL_N, SMEM_BUDGET,
                                            KernelLengthError, fft_rows_cuda,
                                            fft_rows_plain)

__all__ = ["fft_rows_op", "pick_radix", "pick_rows_per_cta", "pick_threads",
           "prepare_rows", "resolve_call_params", "resolve_radix"]


def pick_radix(n: int) -> int:
    """Radix for a power-of-two length: 4 whenever a radix-4 pass exists
    (n >= 4) — half the Stockham passes — else 2."""
    return 4 if n >= 4 else 2


def pick_rows_per_cta(n: int, rows: int) -> int:
    """Rows one CTA of the fused complex kernel transforms: up to 16, so
    that a CTA's transposed store writes ``rows_per_cta * 8`` contiguous
    bytes per output row — a multiple of 4 (whole 32-byte sectors) when 4
    or more fit — bounded by two shared buffers of ``n + 1`` elements per
    row within ``SMEM_BUDGET``, and fewer (in steps of 4) while the grid
    would not fill the card."""
    r = min(16, SMEM_BUDGET // (2 * (n + 1) * 8))
    if r >= 4:
        r -= r % 4
    r = max(r, 1)
    while r > 4 and -(-rows // r) < _MIN_CTAS:
        r = max(4, r // 2)
    return max(1, min(r, max(rows, 1)))


def pick_threads(n: int, rows_per_cta: int, radix: int) -> int:
    """Threads per CTA: one per butterfly of a pass, within [64, 1024]."""
    butterflies = rows_per_cta * n // radix
    return int(min(1024, max(64, 1 << max(butterflies - 1, 0).bit_length())))


def resolve_radix(n: int, radix: int | None, name: str) -> int:
    """Shared prologue of the row-FFT op wrappers: validate the length and
    fill in the radix default.  ``name`` is the op named in errors."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"cuda fft kernel requires power-of-two length, got {n}")
    if n > MAX_KERNEL_N:
        raise KernelLengthError(name, n)
    if radix is None:
        radix = pick_radix(n)
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    return radix


def resolve_call_params(n: int, rows: int, rows_per_cta: int | None,
                        radix: int | None, *,
                        name: str = "fft_rows_transpose_op") -> tuple[int, int, int]:
    """``resolve_radix`` plus the launch shape of the fused complex kernel:
    fill in the rows_per_cta and threads defaults for ``rows`` rows."""
    radix = resolve_radix(n, radix, name)
    if rows_per_cta is None:
        rows_per_cta = pick_rows_per_cta(n, rows)
    return rows_per_cta, radix, pick_threads(n, rows_per_cta, radix)


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
    """Complex row FFT via the CUDA kernel. x: (..., rows, n) complex.

    ``radix=None`` auto-selects (radix 4 with radix-2 tail for n >= 4); it
    chooses the plain version's stage loop, while the CUDA kernel's passes
    and launch shape depend on ``n`` only (``complex_rows_plan``).
    Computes in float32 and returns ``promote(x.dtype, complex64)``.
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
    else:
        out = fft_rows_plain(x2, inverse=inverse, radix=radix)
    return out.to(out_dtype).reshape(x.shape)
