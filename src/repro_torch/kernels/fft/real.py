"""Batched *real* row FFT (two real rows packed per complex FFT): the plain
PyTorch version, the launcher of the CUDA kernel ``csrc/rfft_rows.cu`` and
the public op.

Counterpart of ``repro.kernels.fft.real``.  A real length-``n`` row has a
conjugate-symmetric spectrum, so only the ``n//2+1`` Hermitian-unique bins are
computed and stored.  Two real rows ``a, b`` are packed as ``z = a + i*b``, one
complex Stockham FFT (the stage loop of ``kernels.fft.kernel``) gives ``Z``,
and the conjugate split recovers both spectra:

    A[k] = (Z[k] + conj(Z[n-k])) / 2     = FFT(a)[k]
    B[k] = (Z[k] - conj(Z[n-k])) / 2i    = FFT(b)[k]

so the row phase runs half the complex FFTs.  The plain version works on
float planes like the reference (full-width split, then re-interleave and
crop); the CUDA kernel writes the ``n//2+1`` bins of each row straight to its
place, so the op pads, re-interleaves and crops nothing on the card.

The CUDA kernel holds a row pair's points in registers (``csrc/regfft.cuh``):
its passes and launch shape depend only on ``n`` and the pair count: the
shape is ``complex_rows_plan``'s, with a packed pair in the place of a row.  ``radix`` is validated,
as in the reference, and chooses the plain version's stage loop only.

That kernel stops at n = 8192.  At 16384, where its pair would take a whole
SM (1024 threads, 136 KiB) and nothing would hide its loads, the op
launches ``csrc/rfft_rows_16k.cu``: the same pair, passes and split in one
persistent CTA an SM that walks over the pairs, the next pair's row a and
part of its row b copied into shared memory (bulk copies on an mbarrier)
and the rest prefetched into L2 while the current pair runs
(``rfft_16k_plan``).  The bulk copies need a 16-byte aligned input there.
"""

from __future__ import annotations

import torch

from repro_torch._device import as_tensor, complex_result_type
from repro_torch.kernels.fft.kernel import (_POINTS, MAX_KERNEL_N, apply_stockham,
                                            check_kernel_input, complex_rows_plan,
                                            launch)
from repro_torch.kernels.fft.ops import resolve_radix
from repro_torch.kernels.fft.real_large import rfft_rows_large_cuda, rfft_rows_large_plain

__all__ = ["RFFT_16K_STAGED", "launch_count", "launch_count_16k", "prepare_real_rows",
           "reset_launch_count", "rfft_16k_plan", "rfft_rows_cuda", "rfft_rows_op",
           "rfft_rows_plain", "unpack_packed_fft"]

# Slices of 1024 floats of row b that ``csrc/rfft_rows_16k.cu`` (K3 at n =
# MAX_KERNEL_N) stages in shared memory with the next pair's row a
# (``kStaged`` there).
RFFT_16K_STAGED = 6

_launches = 0
_launches_16k = 0


def launch_count() -> int:
    """How many times ``rfft_rows_cuda`` has launched a kernel (either source)."""
    return _launches


def launch_count_16k() -> int:
    """The launches of ``csrc/rfft_rows_16k.cu`` (n = 16384) among
    ``launch_count``'s."""
    return _launches_16k


def reset_launch_count() -> None:
    global _launches, _launches_16k
    _launches = _launches_16k = 0


def _reverse_bins(x: torch.Tensor) -> torch.Tensor:
    """``x[..., (n - k) mod n]``: bin 0 stays, bins 1..n-1 reverse."""
    return torch.cat([x[..., :1], x[..., 1:].flip(-1)], dim=-1)


def unpack_packed_fft(zr: torch.Tensor, zi: torch.Tensor):
    """Split ``Z = FFT(a + i*b)`` planes into FFT(a) and FFT(b) planes.

    Returns ``(a_re, a_im, b_re, b_im)``, each full-width (callers crop to
    the half spectrum).
    """
    rzr = _reverse_bins(zr)
    rzi = _reverse_bins(zi)
    return ((zr + rzr) * 0.5, (zi - rzi) * 0.5,
            (zi + rzi) * 0.5, (rzr - zr) * 0.5)


def rfft_rows_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: (rows, n) float32 -> (rows, n//2+1)
    complex64, by the plane stage loop, the split, the row re-interleave and
    the crop.  An odd row count gets one zero row to pair with, as in the
    reference.  Runs on whatever device ``x`` lies on."""
    rows, n = x.shape
    if rows % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
    zr, zi = apply_stockham(x[0::2], x[1::2], radix=radix)
    a_re, a_im, b_re, b_im = unpack_packed_fft(zr, zi)
    out = torch.stack([torch.complex(a_re, a_im), torch.complex(b_re, b_im)], dim=1)
    return out.reshape(-1, n)[:rows, :n // 2 + 1].contiguous()


def rfft_16k_plan(rows: int, sms: int) -> tuple[int, int, int, int]:
    """The launch of ``csrc/rfft_rows_16k.cu`` for ``rows`` rows on a card
    of ``sms`` SMs: ``(ctas, threads, staged_bytes, smem_bytes)``.
    min(pairs, SMs) persistent CTAs of n/16 = 1024 threads, 16 points each
    (``complex_rows_plan``'s pair); a pair's staging copies its row a and
    the first ``RFFT_16K_STAGED`` slices of 1024 floats of its row b
    (``staged_bytes``, where b exists); shared memory holds the exchange
    buffer (n*17/16 complex64), the staging area and an 8-byte mbarrier
    padded to 16: one CTA an SM."""
    n = MAX_KERNEL_N
    group = n // _POINTS
    staged = 4 * (n + RFFT_16K_STAGED * group)
    return (min((rows + 1) // 2, sms), group, staged,
            8 * (n + -(-n // 16)) + staged + 16)


def rfft_rows_cuda(x: torch.Tensor, *, radix: int = 4) -> torch.Tensor:
    """K3 on a (rows, n) float32 CUDA tensor -> its (rows, n//2+1) complex64
    half spectrum per row, one launch a call: below ``MAX_KERNEL_N``
    ``csrc/rfft_rows.cu`` in the launch shape ``complex_rows_plan`` gives for
    its row pairs, at ``MAX_KERNEL_N`` ``csrc/rfft_rows_16k.cu``, persistent
    CTAs (``rfft_16k_plan``) on an input 16-byte aligned (else ValueError);
    rows longer than ``MAX_KERNEL_N`` (up to
    ``MAX_LARGE_N``) go to K3b (``kernels.fft.real_large``).  Does not
    synchronise."""
    global _launches, _launches_16k
    rows, n = check_kernel_input(x, "rfft_rows_cuda", torch.float32)
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if n > MAX_KERNEL_N:
        return rfft_rows_large_cuda(x)
    out = torch.empty((rows, n // 2 + 1), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    if n == MAX_KERNEL_N:
        if x.data_ptr() % 16:
            raise ValueError("rfft_rows_cuda: at n = 16384 the input must start on a "
                             "16-byte boundary (its rows are moved by bulk copies); "
                             f"this one starts at {x.data_ptr():#x}")
        launch("repro_rfft_rows_16k", x, out, rows=rows, n=n)
        _launches_16k += 1
    else:
        pairs_per_cta, threads, *_ = complex_rows_plan(n, (rows + 1) // 2)
        launch("repro_rfft_rows", x, out, rows=rows, n=n, radix=radix,
               rows_per_cta=pairs_per_cta, threads=threads)
    _launches += 1
    return out


def prepare_real_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """The real kernels compute in float32 whatever real type comes in.
    Complex input and input that is not contiguous are refused, on either
    device (no hidden copy in a measured phase)."""
    if x.is_complex():
        raise ValueError(f"{name}: takes real input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"{name}: input must be contiguous (make the copy explicit with "
            ".contiguous())")
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def rfft_rows_op(x, *, radix: int | None = None) -> torch.Tensor:
    """Real row FFT via the packed CUDA kernel.

    x: (..., rows, n) real -> (..., rows, n//2+1) complex half spectrum,
    matching ``torch.fft.rfft(x, dim=-1)``; n a power of two up to
    ``MAX_LARGE_N``: K3 up to ``MAX_KERNEL_N``, the four-step K3b above (on
    the CPU, ``rfft_rows_large_plain``).  ``radix=None`` auto-selects.
    Computes in float32 and returns ``promote(x.dtype, complex64)``.
    """
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError(f"rfft_rows_op takes (..., rows, n) input, got shape {tuple(x.shape)}")
    n = x.shape[-1]
    x2 = prepare_real_rows(x, "rfft_rows_op").reshape(-1, n)
    # The CUDA launch shape comes from complex_rows_plan.
    radix = resolve_radix(n, radix, "rfft_rows_op")
    out_dtype = complex_result_type(x)
    out_shape = tuple(x.shape[:-1]) + (n // 2 + 1,)
    if n == 1:  # the length-1 DFT is the identity
        return x2.to(out_dtype).reshape(out_shape)
    if x2.is_cuda:
        out = rfft_rows_cuda(x2, radix=radix)
    elif n > MAX_KERNEL_N:
        out = rfft_rows_large_plain(x2)
    else:
        out = rfft_rows_plain(x2, radix=radix)
    return out.to(out_dtype).reshape(out_shape)
