"""The register-resident complex row kernel K1 (``csrc/fft_rows.cu`` on
``csrc/regfft.cuh``) on the CPU: its launch plan, and a float64 model of its
passes, forward and inverse, against the DFT and against the JAX package's
``fft_rows_op`` (Pallas in interpret mode).

The CUDA source itself is compiled and checked on the card by
``chip_smoke.py``; here the index arithmetic, the twiddles, the 1/n scale of
the inverse and the exchange's bank pattern are, at every length the kernel
is instantiated for.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import complex_signal, kernel_pass_model, to_torch

from repro.kernels.fft.ops import fft_rows_op as ref_fft_rows_op

from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fft.ops import fft_rows_op

LENGTHS = [1 << e for e in range(1, 15)]
# Row counts of K1, and pair counts of K3, which launches the same plan with
# a packed pair of real rows in the place of a row.
ROW_COUNTS = [1, 4, 19, 37, 256, 4096, 8192, 100000]
# Shared memory of one SM an H100 gives to CTAs, and what it keeps per CTA.
SM_SMEM = 233472
CTA_RESERVED_SMEM = 1024


def plans(n):
    """Every distinct launch plan of K1 at length n over ROW_COUNTS."""
    out = []
    for rows in ROW_COUNTS:
        plan = port_kernel.complex_rows_plan(n, rows)
        if plan not in out:
            out.append(plan)
    return out


# ------------------------------------------------------------- launch plan

@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("n", LENGTHS)
def test_complex_rows_plan_fits_the_card(n, rows):
    per_cta, threads, points, radices, smem = port_kernel.complex_rows_plan(n, rows)
    group = n // points
    assert points == min(16, n) and int(np.prod(radices)) == n
    assert all(r == points for r in radices[:-1]) and radices[-1] <= points
    assert threads == per_cta * group <= 1024 and per_cta & (per_cta - 1) == 0
    assert 1 <= per_cta <= max(1, 256 // group) and (per_cta == 1 or threads >= 32)
    assert 8 * per_cta * n < smem <= port_kernel.SMEM_BUDGET
    # Rows are packed more than one to a CTA only while the grid fills the
    # card or a CTA would fall below one warp.
    if per_cta < max(1, 256 // group):
        assert -(-rows // (2 * per_cta)) < port_kernel._MIN_CTAS
        assert per_cta == 1 or threads <= 32 or -(-rows // per_cta) >= port_kernel._MIN_CTAS
    if n == 8192:  # two CTAs of 512 threads share an SM
        assert (per_cta, threads, radices) == (1, 512, [16, 16, 16, 2])
        assert smem == 69632 <= port_kernel.SMEM_BUDGET // 2
    if n == port_kernel.MAX_KERNEL_N:  # Plan<14>: one CTA of 1024 threads an SM
        assert (per_cta, threads, points, radices, smem) == (
            1, 1024, 16, [16, 16, 16, 4], 139264)
        assert smem <= port_kernel.SMEM_BUDGET < 2 * smem


def test_complex_rows_plan_refuses_other_lengths():
    for n in (0, 1, 3, 12):
        with pytest.raises(ValueError, match="power of two"):
            port_kernel.complex_rows_plan(n, 8)


def header_plan(log2n):
    """``regfft::Plan<LOG2N>`` of the CUDA header, computed as it does."""
    text = (_build.csrc_dir() / "regfft.cuh").read_text()
    max_points = int(re.search(r"kMaxPoints = (\d+);", text).group(1))
    cta_threads = int(re.search(r"kCtaThreads = (\d+);", text).group(1))
    n = 1 << log2n
    points = min(n, max_points)
    group = n // points
    max_rows = 1 if group >= cta_threads else cta_threads // group
    max_threads = max_rows * group
    min_blocks = 65536 // (max_threads * max(4 * points, 32))
    return points, max_rows, max_threads, min_blocks


@pytest.mark.parametrize("n", LENGTHS)
def test_complex_rows_plan_mirrors_the_cuda_header(n):
    """The plan's constants are the header's, its largest CTA is the
    header's MAX_ROWS, and the MIN_BLOCKS CTAs that ``__launch_bounds__``
    promises fit one SM's shared memory."""
    points, max_rows, max_threads, min_blocks = header_plan(n.bit_length() - 1)
    per_cta, threads, plan_points, _, smem = port_kernel.complex_rows_plan(n, 1 << 30)
    assert (plan_points, per_cta, threads) == (points, max_rows, max_threads)
    assert min_blocks >= 1 and min_blocks * (smem + CTA_RESERVED_SMEM) <= SM_SMEM
    for rows in ROW_COUNTS:
        assert port_kernel.complex_rows_plan(n, rows)[0] <= max_rows


def test_fft_rows_source_instantiates_every_length_in_both_directions():
    text = (_build.csrc_dir() / "fft_rows.cu").read_text()
    assert '#include "regfft.cuh"' in text and "stockham" not in text
    assert "fft_row<LOG2N, INV>" in text
    assert "launch<LOG2N, true>" in text and "launch<LOG2N, false>" in text
    for e in range(1, 15):
        assert f"case 1 << {e}: return launch_dir<{e}>(" in text
    assert "case 1 << 15" not in text
    assert "cudaErrorInvalidValue" in text  # any other shape is refused


# --------------------------------------------- K1's passes, in float64

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_k1_pass_model_is_the_dft_and_its_exchange_is_conflict_free(n, inverse):
    """Forward and inverse (with the 1/n scale) equal ``torch.fft`` in
    float64 at ``1e-9·n`` (over n for the inverse, whose values the 1/n
    scale shrinks by n), and every exchange access is conflict-free at
    every CTA size the plan gives."""
    rng = np.random.default_rng(n + inverse)
    a, b = rng.standard_normal((2, 3, n))
    z = torch.complex(torch.from_numpy(a), torch.from_numpy(b))
    want = torch.fft.ifft(z) if inverse else torch.fft.fft(z)
    for plan in plans(n):
        got, worst = kernel_pass_model(z, plan, inverse=inverse)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-9 if inverse else 1e-9 * n)
        assert worst == 1, (plan, worst)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_k1_pass_model_matches_reference_fft_rows_op(n, inverse):
    """The model of K1's passes on complex64 rows against the reference's
    Pallas kernel (interpret mode) at ``1e-3·sqrt(n)`` on the unscaled
    transform (over n for the inverse: at the forward's tolerance an inverse
    that wrote zeros would pass), and the port's op on the CPU (the plain
    version) against both."""
    x = complex_signal(7 * n + inverse, 5, n)
    want = np.asarray(ref_fft_rows_op(jnp.asarray(x), inverse=inverse))
    got, _ = kernel_pass_model(to_torch(x), port_kernel.complex_rows_plan(n, 5),
                               inverse=inverse)
    tol = 1e-3 * np.sqrt(n) / (n if inverse else 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    plain = fft_rows_op(to_torch(x), inverse=inverse)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0, atol=tol)
