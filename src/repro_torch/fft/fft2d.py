"""Row-column 2-D DFT (paper §III-A) built from 1-D FFTs.

``fft2d_rowcol`` is the sequential algorithm the parallel methods decompose:
row FFTs -> transpose -> row FFTs -> transpose.  It reduces the O(N^4)
direct 2-D DFT to O(N^2 log N).

``fused=True`` collapses each (row FFT, transpose) pair into one kernel
launch (``repro_torch.kernels.fused``): the transformed row block is written
straight to its transposed place, so the intermediate matrix between steps
1-2 and 3-4 never exists in device memory.

The real-input functions (``rfft_rows``, ``rfft_rows_then_transpose``,
``rfft2``, ``irfft2``) return the ``n//2+1`` Hermitian-unique bins of each
real row: the kernel backends pack two real rows per complex FFT
(``repro_torch.kernels.fft.real``).
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.fft.fft1d import fft1d_stockham

__all__ = ["fft2d_rowcol", "fft_rows", "fft_rows_then_transpose",
           "irfft2", "rfft2", "rfft_rows", "rfft_rows_then_transpose"]

_BACKENDS = ("torch", "stockham", "cuda")


def fft_rows(m, *, use_stockham: bool = False, backend: str | None = None,
             radix: int | None = None) -> torch.Tensor:
    """1-D FFT along the last axis.

    backend: None/'torch' -> ``torch.fft``; 'stockham' -> pure-tensor
    radix-2; 'cuda' -> the CUDA kernel (its plain version for a CPU tensor).
    Power-of-two lengths go to stockham/cuda; any other length goes to the
    library whatever the backend — that is the rule of the method, as in the
    reference, not a recovery path.  ``radix`` feeds the kernel's Stockham
    radix (None auto-selects; ``PlanConfig.radix`` lands here).
    """
    m = as_tensor(m)
    n = m.shape[-1]
    if backend is None:
        backend = "stockham" if use_stockham else "torch"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown row-FFT backend {backend!r}")
    if backend == "cuda" and not (n & (n - 1)):
        from repro_torch.kernels.fft.ops import fft_rows_op
        return fft_rows_op(m, radix=radix)
    if backend == "stockham" and not (n & (n - 1)):
        return fft1d_stockham(m)
    if not m.numel():
        # No rows: the library refuses an empty batch, the result is empty.
        return torch.empty(m.shape, dtype=complex_result_type(m),
                           device=m.device)
    return torch.fft.fft(m.to(complex_result_type(m)), dim=-1)


def fft_rows_then_transpose(m, *, backend: str | None = None,
                            radix: int | None = None,
                            pad_stride: bool = False) -> torch.Tensor:
    """One fused phase: ``FFT_rows(m).T`` without the intermediate matrix.

    Dispatches to the fused kernel when it applies (2-D input, power-of-two
    row length above 1, single-precision data — the kernel computes in
    float32, so wider types keep the full-precision path); otherwise
    computes the same value as ``fft_rows`` + a transposed copy so callers
    can use it unconditionally.  ``pad_stride`` goes to the kernel's op
    (``fft_rows_transpose_op``): the result may then be a view whose rows
    are padded to a multiple of 4 elements.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    eligible = (m.ndim == 2 and n > 1 and not (n & (n - 1))
                and complex_result_type(m) == torch.complex64)
    if eligible and backend in (None, "cuda", "fused"):
        from repro_torch.kernels.fused.ops import fft_rows_transpose_op
        return fft_rows_transpose_op(m, radix=radix, pad_stride=pad_stride)
    if backend == "fused":
        backend = None
    return fft_rows(m, backend=backend).transpose(-1, -2).contiguous()


def _packed_rfft(m: torch.Tensor, fft_fn) -> torch.Tensor:
    """Real row FFT by packing two real rows per complex transform.

    ``fft_fn`` runs a complex FFT along the last axis; the conjugate split
    recovers both spectra (``kernels.fft.real`` runs the plane form of the
    same identity, and its CUDA kernel the same split in shared memory).
    Returns the (..., rows, n//2+1) half spectrum.
    """
    rows, n = m.shape[-2], m.shape[-1]
    ctype = complex_result_type(m)
    m = m.to(torch.float64 if ctype == torch.complex128 else torch.float32)
    if rows % 2:
        m = torch.nn.functional.pad(m, (0, 0, 0, 1))
    zf = fft_fn(torch.complex(m[..., 0::2, :], m[..., 1::2, :]))
    zrev = torch.cat([zf[..., :1], zf[..., 1:].flip(-1)], dim=-1).conj()
    out = torch.stack([0.5 * (zf + zrev), -0.5j * (zf - zrev)], dim=-2)
    out = out.reshape(out.shape[:-3] + (-1, n))
    return out[..., :rows, :n // 2 + 1]


def rfft_rows(m, *, backend: str | None = None,
              radix: int | None = None) -> torch.Tensor:
    """1-D *real* FFT along the last axis -> (..., n//2+1) half spectrum.

    Same backend vocabulary as ``fft_rows``: 'cuda' runs the packed
    two-rows-per-FFT kernel (its plain version for a CPU tensor), 'stockham'
    packs through the pure-tensor radix-2 Stockham, None/'torch' is the
    library rfft.  The kernel backends need ``(..., rows, n)`` input and a
    power-of-two length; anything else goes to the library, by the
    reference's own rule.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    if backend is None:
        backend = "torch"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown row-FFT backend {backend!r}")
    if backend == "cuda" and m.ndim >= 2 and not (n & (n - 1)):
        from repro_torch.kernels.fft.real import rfft_rows_op
        return rfft_rows_op(m, radix=radix)
    if backend == "stockham" and m.ndim >= 2 and not (n & (n - 1)):
        return _packed_rfft(m, fft1d_stockham)
    if not m.numel():
        return torch.empty(m.shape[:-1] + (n // 2 + 1,),
                           dtype=complex_result_type(m), device=m.device)
    return torch.fft.rfft(m, dim=-1)


def rfft_rows_then_transpose(m, *, backend: str | None = None,
                             radix: int | None = None) -> torch.Tensor:
    """One fused real phase: ``rfft_rows(m).T`` without the intermediate.

    Eligibility mirrors ``fft_rows_then_transpose`` (2-D input, power-of-two
    row length above 1, data that float32 represents); otherwise the unfused
    value as a contiguous copy, so callers can use it unconditionally.
    """
    m = as_tensor(m)
    n = m.shape[-1]
    eligible = (m.ndim == 2 and n > 1 and not (n & (n - 1))
                and complex_result_type(m) == torch.complex64)
    if eligible and backend in (None, "cuda", "fused"):
        from repro_torch.kernels.fused.real import rfft_rows_transpose_op
        return rfft_rows_transpose_op(m, radix=radix)
    if backend == "fused":
        backend = None
    return rfft_rows(m, backend=backend).transpose(-1, -2).contiguous()


def rfft2(m, *, backend: str | None = None,
          radix: int | None = None) -> torch.Tensor:
    """Real-input 2-D DFT -> the (..., n_rows, n//2+1) half spectrum.

    Matches ``torch.fft.rfft2``: real row FFTs (half the transforms via row
    packing), then full complex FFTs down the surviving half-spectrum
    columns, as row FFTs of the transposed half spectrum.
    """
    h = rfft_rows(m, backend=backend, radix=radix).transpose(-1, -2).contiguous()
    h = fft_rows(h, backend=backend, radix=radix)
    return h.transpose(-1, -2).contiguous()


def irfft2(h, *, n: int | None = None) -> torch.Tensor:
    """Inverse of ``rfft2``: (..., rows, nh) half spectrum -> real matrix.

    ``n`` is the last-axis length of the original signal; the default
    ``2 * (nh - 1)`` assumes it was even (pass ``n`` explicitly for odd).
    """
    h = as_tensor(h)
    if n is None:
        n = 2 * (h.shape[-1] - 1)
    if n < 1:
        raise ValueError("Shape should be positive.")
    if not h.numel():
        real = torch.float64 if h.dtype == torch.complex128 else torch.float32
        return torch.empty(h.shape[:-1] + (n,), dtype=real, device=h.device)
    return torch.fft.irfft(torch.fft.ifft(h, dim=-2), n=n, dim=-1)


def fft2d_rowcol(m, *, use_stockham: bool = False,
                 fused: bool = False) -> torch.Tensor:
    """2-D DFT via row-column decomposition, mirroring the paper's 4 steps:

      1. 1-D FFTs on rows
      2. transpose
      3. 1-D FFTs on rows (i.e. the original columns)
      4. transpose

    ``fused=True`` runs steps 1+2 and 3+4 as single fused launches
    (numerically equivalent; no intermediate matrix).
    """
    m = as_tensor(m)
    if fused:
        m = fft_rows_then_transpose(m)              # steps 1+2
        m = fft_rows_then_transpose(m)              # steps 3+4
        return m
    m = fft_rows(m, use_stockham=use_stockham)      # step 1
    m = m.transpose(-1, -2).contiguous()            # step 2
    m = fft_rows(m, use_stockham=use_stockham)      # step 3
    m = m.transpose(-1, -2).contiguous()            # step 4
    return m
