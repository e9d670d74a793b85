"""Shared helpers of the ``test_torch_*`` parity tests.

The same inputs, made with numpy from a seed, go through the JAX package
(``repro``, the reference, on the CPU with its Pallas kernels in interpret
mode) and through the PyTorch port (``repro_torch``, on ``device="cpu"``, where
its ops run the kernels' plain versions).  Only the tests import both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import repro.core as ref_core
from repro_torch import convert


def complex_signal(seed: int, *shape: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fpm_arrays(n: int, p: int = 3, *, hetero: bool = True, seed: int = 0):
    """Seeded random speed functions as plain arrays
    ``[(xs, ys, speed, name), ...]``: a smooth base surface times a random
    per-point factor (non-monotonic, as measured profiles are), scaled per
    processor when ``hetero``."""
    rng = np.random.default_rng(seed)
    xs = np.array(sorted({1, max(n // 8, 1), max(n // 4, 1), max(n // 2, 1), n}))
    ys = np.array(sorted({n // 2, n, n + n // 8, n + n // 4, 2 * n}))
    base = np.outer(xs, np.log2(np.maximum(ys, 2))) + 3.0
    out = []
    for i in range(p):
        if hetero or i == 0:
            speed = base * rng.uniform(0.6, 1.6, size=base.shape) * (i + 1.0)
        else:
            speed = out[0][2].copy()
        out.append((xs, ys, speed, f"P{i}"))
    return out


def both_fpms(n: int, p: int = 3, *, hetero: bool = True, seed: int = 0):
    """(reference FPMSet, port FPMSet) from the same arrays."""
    arrays = fpm_arrays(n, p, hetero=hetero, seed=seed)
    ref = ref_core.FPMSet([ref_core.SpeedFunction(xs, ys, sp, name=name)
                           for xs, ys, sp, name in arrays])
    return ref, convert.fpms_from_arrays(arrays)


def padding_fpm_arrays(n: int):
    """One slow/flat and two fast processors whose speed peaks at 2N, so that
    the FPM-chosen pad of the fast ones is 2N > N and the pad semantics of
    PFFT-FPM-PAD really engage (a power-of-two pad when N is one)."""
    xs = np.array(sorted({1, n // 2, n}))
    ys = np.array(sorted({n, 2 * n, 4 * n}))
    fast = np.tile([1e9, 4e9, 1e9], (len(xs), 1))
    slow = np.full((len(xs), len(ys)), 2.5e8)
    return [(xs, ys, slow if i == 0 else fast, f"P{i}") for i in range(3)]


def both_padding_fpms(n: int):
    arrays = padding_fpm_arrays(n)
    ref = ref_core.FPMSet([ref_core.SpeedFunction(xs, ys, sp, name=name)
                           for xs, ys, sp, name in arrays])
    return ref, convert.fpms_from_arrays(arrays)


def _pad(f):
    """Padded index of element f of a register-resident kernel's exchange
    buffer (``csrc/regfft.cuh``: one float2 of padding per 16)."""
    return f + (f >> 4)


def kernel_pass_model(z: torch.Tensor, plan, *, inverse: bool = False):
    """A register-resident kernel's passes (``csrc/regfft.cuh``) in float64,
    thread by thread, on the rows of ``z`` (complex rows, or packed real
    pairs), in the launch shape ``plan`` = ``(rows_per_cta, threads, points,
    radices, smem_bytes)`` of ``complex_rows_plan``:
    thread t of a row's group holds x[t + k*T] in its registers, runs
    ``points / r`` butterflies of radix r (butterfly b takes slots
    b + u*(points/r)), twiddles and writes slot u to y[(j*r + u)*s + q];
    ``inverse`` flips the sign and scales by 1/n.  Returns the transform and,
    per exchange access of every thread of a CTA of ``rows_per_cta`` rows,
    the worst number of a half-warp's 16 threads that hit one shared-memory
    bank."""
    rows, n = z.shape
    per_cta, _, points, radices, smem = plan
    sign = 1.0 if inverse else -1.0
    group = n // points
    t = torch.arange(group)
    mine = t[:, None] + torch.arange(points)[None, :] * group    # (T, points)
    x = z.to(torch.complex128)
    accesses = [mine[:, k] for k in range(points)]
    log2s = 0
    for pass_, r in enumerate(radices):
        b = points // r
        u = torch.arange(r)
        dft = torch.exp(sign * 2j * math.pi * torch.outer(u, u).double() / r)
        y = torch.einsum("uv,ptvb->ptub", dft, x[:, mine].reshape(rows, group, r, b))
        i = t[:, None] + torch.arange(b)[None, :] * group        # butterflies
        s, ncur = 1 << log2s, n >> log2s
        j, q = i >> log2s, i & (s - 1)
        y = y * torch.exp(sign * 2j * math.pi
                          * (j[:, None, :] * u[None, :, None]).double() / ncur)
        dest = ((j[:, None, :] * r + u[None, :, None]) << log2s) + q[:, None, :]
        assert sorted(dest.flatten().tolist()) == list(range(n))
        if pass_ < len(radices) - 1:
            accesses += [dest[:, uu, bb] for uu in range(r) for bb in range(b)]
        else:  # the last pass leaves natural order: its slots are its reads
            assert torch.equal(dest.reshape(group, points), mine)
        x = torch.empty_like(x)
        x[:, dest.flatten()] = y.reshape(rows, -1)
        log2s += r.bit_length() - 1
    worst = 1
    for a in accesses:  # every thread of a CTA, row by row
        f = (torch.arange(per_cta)[:, None] * n + a[None, :]).flatten()
        assert int(_pad(f).max()) < smem // 8
        for h in range(0, f.numel(), 16):
            banks = (_pad(f[h:h + 16]) % 16).tolist()
            worst = max(worst, max(banks.count(v) for v in banks))
    return (x / n if inverse else x), worst
