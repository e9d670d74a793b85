"""Batched row FFT (Stockham autosort, radix-4/radix-2): the plain PyTorch
version, the launch plan and the launcher of the CUDA kernel
``csrc/fft_rows.cu``.

Counterpart of ``repro.kernels.fft.kernel``.  The stage loop is the same in
both packages: the row is viewed as ``(ncur, s)``, a radix-r pass combines
the r parts ``v[t*m:(t+1)*m]`` of length ``m = ncur // r`` and writes slot
``u`` of butterfly ``j`` scaled by ``w_j^u``, ``w_j =
exp(sign*2*pi*i*j/ncur)``.  No pass needs a bit-reversal gather, which is why
the formulation suits a kernel: every pass is a strided read, a few adds and
multiplies, and a strided write.

The plain versions work on two float planes ``(re, im)`` like the reference,
so the two can be compared plane for plane; ``fft_rows_plain`` wraps them for
interleaved complex tensors, which is what the CUDA kernel reads and writes
(one ``float2`` per element, through ``torch.view_as_real``).

The CUDA row kernels (this one, the fused ``fft_rows_transpose.cu`` and the
packed real ones) hold each row's points in registers (``csrc/regfft.cuh``):
their passes (radix 16, then one radix-2^r pass, on the same ``(ncur, s)``
view) and launch shape depend only on ``n`` and the row count, and
``complex_rows_plan`` mirrors their instantiation table, n = 2 ... 16384
(the fused and the packed real kernels stop at 8192: at 16384 those ops
launch ``csrc/fft_rows_transpose_cluster.cu`` and ``csrc/rfft_rows_16k.cu``).
Longer rows, up to ``MAX_LARGE_N``, go to the four-step kernels: K1b
(``kernels.fft.large``: ``csrc/fft_rows_cluster.cu`` at n <= 2^18,
``csrc/fft_rows_large.cu`` above) and its fused and real
siblings K2b-K4b (K2b: ``csrc/fft_rows_transpose_cluster.cu`` at n <=
65536).  ``radix``
is validated, as in the reference, and chooses the plain version's stage
loop only.
"""

from __future__ import annotations

import math

import torch

from repro_torch._trace import span
from repro_torch.kernels import _build

__all__ = [
    "MAX_KERNEL_N",
    "MAX_LARGE_N",
    "SMEM_BUDGET",
    "KernelLaunchError",
    "KernelLengthError",
    "apply_stockham",
    "complex_rows_plan",
    "fft_rows_cuda",
    "fft_rows_plain",
    "launch_count",
    "reset_launch_count",
    "stockham_planes",
    "stockham_planes_radix4",
    "stockham_stage_count",
]

# Dynamic shared memory a CTA may opt in to on an H100 (227 KB).
SMEM_BUDGET = 232448
# The register-resident row kernels K1-K4 are instantiated for power-of-two n
# up to this length (``regfft::Plan<14>``: one row of 1024 threads a CTA) and
# no further.
MAX_KERNEL_N = 16384
# Every row op takes power-of-two rows up to this length: above
# MAX_KERNEL_N through the four-step kernels K1b-K4b, whose two factors are
# at most MAX_KERNEL_N each.
MAX_LARGE_N = 1 << 28
# Points of a row one thread of a register-resident kernel holds (at most),
# and the threads a CTA aims at when a row needs fewer (``csrc/regfft.cuh``).
_POINTS = 16
_CTA_THREADS = 256
# CTAs wanted before rows are packed more than one to a CTA (two waves of an
# H100's 132 SMs).
_MIN_CTAS = 264

_launches = 0


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused (bad configuration, no such device)."""


class KernelLengthError(ValueError):
    """A power-of-two row length above the kernels' top (``MAX_LARGE_N``);
    nothing switches to the library in their place."""

    def __init__(self, name: str, n: int, top: int = MAX_LARGE_N) -> None:
        super().__init__(
            f"{name}: power-of-two length {n} exceeds the kernel limit {top}; "
            "use the library backend (radix=None) for this length")


def launch_count() -> int:
    """How many times ``fft_rows_cuda`` has launched K1 (K1b's launches are
    ``kernels.fft.large.launch_count``)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def stockham_stage_count(n: int, radix: int = 2) -> int:
    """Number of Stockham passes over the data for a length-``n`` transform.

    radix 2: log2(n) passes.  radix 4 (with a radix-2 tail when log2(n) is
    odd): ceil(log2(n) / 2) passes.
    """
    if n & (n - 1) or n < 1:
        raise ValueError(f"length {n} must be a power of two")
    log2n = n.bit_length() - 1
    if radix == 2:
        return log2n
    if radix == 4:
        return (log2n + 1) // 2
    raise ValueError(f"unsupported radix {radix}")


def _twiddle_planes(m: int, angle_step: float, like: torch.Tensor):
    ang = angle_step * torch.arange(m, dtype=like.dtype, device=like.device)
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]


def _radix2_pass(re, im, batch, n, ncur, s, sign):
    m = ncur // 2
    vre = re.reshape(batch + (ncur, s))
    vim = im.reshape(batch + (ncur, s))
    are, aim = vre[..., :m, :], vim[..., :m, :]
    bre, bim = vre[..., m:, :], vim[..., m:, :]
    wre, wim = _twiddle_planes(m, sign * math.pi / m, re)
    dre, dim = are - bre, aim - bim
    re = torch.stack([are + bre, dre * wre - dim * wim],
                     dim=-2).reshape(batch + (n,))
    im = torch.stack([aim + bim, dre * wim + dim * wre],
                     dim=-2).reshape(batch + (n,))
    return re, im


def stockham_planes(re: torch.Tensor, im: torch.Tensor, *,
                    inverse: bool = False):
    """Stockham radix-2 FFT over the last axis of real/imag planes.

    Shapes (..., n), n a power of two.  Returns (re, im).
    """
    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length {n} must be a power of two")
    batch = tuple(re.shape[:-1])
    sign = 1.0 if inverse else -1.0
    ncur, s = n, 1
    while ncur > 1:
        re, im = _radix2_pass(re, im, batch, n, ncur, s, sign)
        ncur, s = ncur // 2, 2 * s
    if inverse:
        re = re / n
        im = im / n
    return re, im


def stockham_planes_radix4(re: torch.Tensor, im: torch.Tensor, *,
                           inverse: bool = False):
    """Mixed radix-4/radix-2 Stockham FFT over the last axis of planes.

    Same contract as ``stockham_planes`` but each radix-4 pass combines two
    radix-2 levels, so the data makes ceil(log2 n / 2) trips instead of
    log2 n.  When log2(n) is odd the final pass (ncur == 2) is radix-2.
    omega_4 = -+i, so the inner DFT-4 is adds and swaps only; the outer
    twiddles are w, w^2 = w*w and w^3 = w^2*w.
    """
    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length {n} must be a power of two")
    batch = tuple(re.shape[:-1])
    sign = 1.0 if inverse else -1.0
    ncur, s = n, 1
    while ncur > 1:
        if ncur % 4:  # ncur == 2: one radix-2 tail stage
            re, im = _radix2_pass(re, im, batch, n, ncur, s, sign)
            ncur, s = ncur // 2, 2 * s
            continue
        m = ncur // 4
        vre = re.reshape(batch + (ncur, s))
        vim = im.reshape(batch + (ncur, s))
        p0re, p0im = vre[..., 0 * m:1 * m, :], vim[..., 0 * m:1 * m, :]
        p1re, p1im = vre[..., 1 * m:2 * m, :], vim[..., 1 * m:2 * m, :]
        p2re, p2im = vre[..., 2 * m:3 * m, :], vim[..., 2 * m:3 * m, :]
        p3re, p3im = vre[..., 3 * m:4 * m, :], vim[..., 3 * m:4 * m, :]
        # DFT-4 across parts: even/odd sums, omega_4 = sign * i.
        e0re, e0im = p0re + p2re, p0im + p2im
        e1re, e1im = p0re - p2re, p0im - p2im
        o0re, o0im = p1re + p3re, p1im + p3im
        d3re, d3im = p1re - p3re, p1im - p3im
        o1re, o1im = -sign * d3im, sign * d3re
        s0re, s0im = e0re + o0re, e0im + o0im
        s1re, s1im = e1re + o1re, e1im + o1im
        s2re, s2im = e0re - o0re, e0im - o0im
        s3re, s3im = e1re - o1re, e1im - o1im
        w1re, w1im = _twiddle_planes(m, sign * 2.0 * math.pi / (4 * m), re)
        w2re = w1re * w1re - w1im * w1im
        w2im = 2.0 * w1re * w1im
        w3re = w2re * w1re - w2im * w1im
        w3im = w2re * w1im + w2im * w1re
        u1re = s1re * w1re - s1im * w1im
        u1im = s1re * w1im + s1im * w1re
        u2re = s2re * w2re - s2im * w2im
        u2im = s2re * w2im + s2im * w2re
        u3re = s3re * w3re - s3im * w3im
        u3im = s3re * w3im + s3im * w3re
        re = torch.stack([s0re, u1re, u2re, u3re], dim=-2).reshape(batch + (n,))
        im = torch.stack([s0im, u1im, u2im, u3im], dim=-2).reshape(batch + (n,))
        ncur, s = m, 4 * s
    if inverse:
        re = re / n
        im = im / n
    return re, im


def apply_stockham(re: torch.Tensor, im: torch.Tensor, *, radix: int = 2,
                   inverse: bool = False):
    """Dispatch to the radix-2 or mixed radix-4 stage loop."""
    if radix == 4:
        return stockham_planes_radix4(re, im, inverse=inverse)
    if radix == 2:
        return stockham_planes(re, im, inverse=inverse)
    raise ValueError(f"unsupported radix {radix}")


def fft_rows_plain(x: torch.Tensor, *, inverse: bool = False,
                   radix: int = 2) -> torch.Tensor:
    """The kernel's plain version: (rows, n) complex64 -> same, by the
    plane stage loop above.  Runs on whatever device ``x`` lies on."""
    planes = torch.view_as_real(x)
    re, im = apply_stockham(planes[..., 0], planes[..., 1], radix=radix,
                            inverse=inverse)
    return torch.complex(re, im)


def check_kernel_input(x: torch.Tensor, name: str,
                       dtype: torch.dtype = torch.complex64) -> tuple[int, int]:
    """What the row-FFT launchers require of their input (``dtype``:
    complex64, or float32 for the real kernels; a power-of-two length up to
    ``MAX_LARGE_N``); returns (rows, n)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: input must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: input must be {str(dtype).removeprefix('torch.')}, "
                         f"got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{name}: input must be 2-D (rows, n), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    rows, n = x.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: length {n} must be a power of two >= 2")
    if n > MAX_LARGE_N:
        raise KernelLengthError(name, n)
    return rows, n


def launch(fn_name: str, x: torch.Tensor, out: torch.Tensor, **args) -> None:
    """Launch one of the library's kernels, ``fn_name(in, out, *args,
    stream)``, on the current stream of ``x``'s device; raises when the
    launch is refused.  ``args`` are passed in the order given."""
    with span("launch"):
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, fn_name)(x.data_ptr(), out.data_ptr(),
                                        *args.values(), stream)
    if err != 0:
        detail = ", ".join(f"{k}={v}" for k, v in args.items())
        raise KernelLaunchError(f"{fn_name}({detail}) failed with CUDA error {err}")


def complex_rows_plan(n: int, rows: int) -> tuple[int, int, int, list[int], int]:
    """The launch shape of a register-resident row kernel for ``rows`` rows
    of length ``n`` (a power of two, 2 <= n <= 16384), as ``csrc/fft_rows.cu``
    and ``csrc/rfft_rows.cu`` (a packed pair of real rows in the place of a
    row) instantiate it: ``(rows_per_cta, threads, points_per_thread,
    radices, smem_bytes)``.

    A row is held by ``n / points_per_thread`` threads with
    ``points_per_thread = min(16, n)`` points each.  ``log2 n = 4q + r``
    gives ``q`` radix-16 passes and one radix-``2^r`` pass (below n = 16,
    one radix-n pass).  A CTA takes as many rows as make 256 threads, fewer
    (down to one row or one warp) while the grid would not fill the card.
    The exchange buffer holds the CTA's rows with one float2 of padding per
    16: 69632 bytes at n = 8192, so two CTAs share an SM; 139264 at 16384,
    one row of 1024 threads, one CTA an SM.
    """
    if n < 2 or n & (n - 1):
        raise ValueError(f"complex_rows_plan: length {n} must be a power of two >= 2")
    points = min(_POINTS, n)
    group = n // points
    log2n = n.bit_length() - 1
    log2p = points.bit_length() - 1
    radices = [points] * (log2n // log2p) + ([1 << log2n % log2p] if log2n % log2p else [])
    per_cta = max(1, _CTA_THREADS // group)
    while per_cta > 1 and per_cta * group > 32 and -(-rows // per_cta) < _MIN_CTAS:
        per_cta //= 2
    elements = per_cta * n
    return per_cta, per_cta * group, points, radices, 8 * (elements + -(-elements // 16))


def fft_rows_cuda(x: torch.Tensor, *, inverse: bool = False,
                  radix: int = 4) -> torch.Tensor:
    """Launch ``csrc/fft_rows.cu``: (rows, n) complex64 CUDA tensor -> its
    row-wise DFT, in the launch shape of ``complex_rows_plan``; rows longer
    than ``MAX_KERNEL_N`` (up to ``MAX_LARGE_N``) go to K1b
    (``kernels.fft.large.fft_rows_large_cuda``).  Does not synchronise."""
    global _launches
    rows, n = check_kernel_input(x, "fft_rows_cuda")
    if radix not in (2, 4):
        raise ValueError(f"unsupported radix {radix}")
    if n > MAX_KERNEL_N:
        # Imported here: kernels.fft.large imports this module.
        from repro_torch.kernels.fft.large import fft_rows_large_cuda
        return fft_rows_large_cuda(x, inverse=inverse)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rows_per_cta, threads, *_ = complex_rows_plan(n, rows)
    launch("repro_fft_rows", x, out, rows=rows, n=n, radix=radix,
           inverse=int(inverse), rows_per_cta=rows_per_cta, threads=threads)
    _launches += 1
    return out
