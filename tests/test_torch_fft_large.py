"""K1b, the four-step complex row FFT of rows longer than K1 holds
(``csrc/fft_rows_cluster.cu`` at n <= 2^18, ``csrc/fft_rows_large.cu``
above, ``kernels/fft/large.py``), on the CPU: its plain version against the
reference's ``fft_rows_op`` (Pallas in interpret mode) and ``numpy.fft``,
its twiddles against float64, float64 models of the one-pass cluster kernel
(``k1b_cluster_model``) and of the two passes' column tiling and store, its
launch plans against the CUDA sources, the launcher's choice of kernel, and
the huge-1-D path through it.

The CUDA kernel runs only on the card (``chip_smoke.py``,
``examples/kernel_check_torch.py --fft-rows-large-only``).  Run these alone
with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_fft_large.py``.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (cluster_twiddle_model, complex_signal, k1b_cluster_model,
                           k1b_model, k2_store_model, kernel_pass_model, pass_a_model,
                           pass_a_twiddle_model, pass_b_plan, to_numpy, to_torch)

import repro.core.api as ref_api
import repro.core.pfft_large as ref_large
import repro.plan as ref_plan
from repro.kernels.fft.ops import fft_rows_op as ref_fft_rows_op

import repro_torch.core.api as port_api
import repro_torch.core.pfft_large as port_large
import repro_torch.plan as port_plan
from repro_torch import kernels as port_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fft import large as port_large_kernel
from repro_torch.kernels.fft.ops import fft_rows_op
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused import large as port_fused_large

SOURCE = "fft_rows_large.cu"
HEADER = "fourstep.cuh"
CLUSTER_SOURCE = "fft_rows_cluster.cu"
CLUSTER_HEADER = "fourstep_cluster.cuh"
CLUSTER_LENGTHS = port_large_kernel.CLUSTER_LENGTHS
# The cluster kernel's launch shapes: every length in the rule's CTAs, and
# 2^17 over the portable 8 CTAs, the variant the rule was timed against.
CLUSTER_SHAPES = [(n, None) for n in CLUSTER_LENGTHS] + [(1 << 17, 8)]


def tol(n, inverse):
    """``1e-3·sqrt(n)`` on the unscaled transform, over n for the inverse
    (its 1/n shrinks the values by n: at the forward's tolerance an inverse
    that wrote zeros would pass)."""
    return 1e-3 * np.sqrt(n) / (n if inverse else 1)


# ------------------------------------------------------- the plain version

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [32768, 65536])
def test_plain_version_matches_reference_and_numpy(n, inverse):
    """``fft_rows_large_plain`` at the default split, and the port's op on
    the CPU (which takes it above ``MAX_KERNEL_N``), against the
    reference's Pallas kernel and ``numpy.fft`` in float64."""
    x = complex_signal(n + inverse, 3, n)
    want = np.asarray(ref_fft_rows_op(jnp.asarray(x), inverse=inverse))
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
    got = to_numpy(port_large_kernel.fft_rows_large_plain(to_torch(x), inverse=inverse))
    op = to_numpy(fft_rows_op(to_torch(x), inverse=inverse))
    for a, b in ((got, want), (got, exact), (op, got)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol(n, inverse))
    np.testing.assert_array_equal(op, got)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("split", [(4, 16), (64, 8), (2, 16384)])
def test_plain_version_at_forced_splits(split, inverse):
    """Any split into powers of two, columns shorter or longer than rows,
    gives the DFT: the index arithmetic of both passes and the transposed
    store do not lean on the near-square default."""
    n1, n2 = split
    n = n1 * n2
    x = complex_signal(n1 + 7 * inverse, 5, n)
    got = port_large_kernel.fft_rows_large_plain(to_torch(x), inverse=inverse, n1=n1)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
    np.testing.assert_allclose(to_numpy(got), exact, rtol=0, atol=tol(n, inverse))
    got2 = port_large_kernel.fft_rows_large_plain(to_torch(x), inverse=inverse, n2=n2)
    np.testing.assert_array_equal(to_numpy(got2), to_numpy(got))


def test_large_split_default_and_refusals():
    """The default split is near-square with n1 <= n2, and at every length
    from 2^15 to ``MAX_LARGE_N`` both factors lie in the kernel's range;
    anything that is not a split into powers of two is refused."""
    for e in range(15, 29):
        n1, n2 = port_large_kernel.large_split(1 << e)
        assert n1 * n2 == 1 << e and n1 == 1 << (e // 2) and n1 <= n2 <= 2 * n1
        assert port_large_kernel.MIN_FACTOR <= n1 and n2 <= port_kernel.MAX_KERNEL_N
    assert port_large_kernel.large_split(1 << 15, n1=256) == (256, 128)
    assert port_large_kernel.large_split(1 << 15, n2=2) == (16384, 2)
    for kwargs in ({"n1": 3}, {"n1": 1 << 16}, {"n1": 4, "n2": 4}):
        with pytest.raises(ValueError, match="split"):
            port_large_kernel.large_split(1 << 15, **kwargs)
    with pytest.raises(ValueError, match="power of two"):
        port_large_kernel.large_split(3 * 1024)


# ---------------------------------------------------------------- twiddle

@pytest.mark.parametrize("n", [1 << 26, 1 << 28])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_split_matches_float64(n, inverse):
    """``large_twiddle`` (pass A's split w^(mh·2^14)·w^ml of two exact
    sincospif arguments) against float64 ``exp(±2πi·m/n)`` over sampled m,
    the ends and both sides of the split included: within 4 float32 ulps
    of 1.  One float argument 2m/n is not exact at these n, which is why
    the split is there."""
    rng = np.random.default_rng(n.bit_length() + inverse)
    m = np.concatenate([rng.integers(0, n, 4096),
                        [0, 1, 16383, 16384, 16385, n // 4, n // 2, n - 1]])
    got = port_large_kernel.large_twiddle(torch.from_numpy(m), n, inverse=inverse)
    sign = 1.0 if inverse else -1.0
    want = np.exp(sign * 2j * np.pi * m.astype(np.float64) / n)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=4 * 2.0 ** -24)
    single = (2.0 * m.astype(np.float32)) / np.float32(n)
    assert (single.astype(np.float64) != 2.0 * m / n).any()


# ------------------------------------------------------ the kernel's model

# The two passes' default split by log2 n (``two_pass_split``): n2 = 512 up
# to 2^20, then the near-square split with n1 >= n2 and n1 <= 4096 while n2
# <= 16384.
TWO_PASS_SPLIT = {15: (128, 256), 16: (128, 512), 17: (256, 512), 18: (512, 512),
                  19: (1024, 512), 20: (2048, 512), 21: (2048, 1024), 22: (2048, 2048),
                  23: (4096, 2048), 24: (4096, 4096), 25: (4096, 8192),
                  26: (4096, 16384), 27: (8192, 16384), 28: (16384, 16384)}


@pytest.mark.parametrize("e", range(15, 29))
def test_two_pass_split_at_every_length(e):
    """The two passes' default split (``two_pass_split``, which K1b's and
    K2b's launchers take unless ``n1`` pins it) at every
    length: ``TWO_PASS_SPLIT``, both factors in the kernels' range, n1 at
    most 4096 where n2 allows it (pass A's CTA holding 4 columns or more);
    ``large_split``, which the plain versions and the cluster kernels keep,
    unchanged (the near-square split, n1 <= n2)."""
    n = 1 << e
    n1, n2 = port_large_kernel.two_pass_split(n)
    assert (n1, n2) == TWO_PASS_SPLIT[e] and n1 * n2 == n
    # The launchers of K1b and K2b take it; K3b and K4b keep large_split's.
    assert port_large_kernel.kernel_split(n, n1, "k1b") == (n1, n2)
    assert port_large_kernel.kernel_split(n, None, "k3b") == port_large_kernel.large_split(n)
    for module in (port_large_kernel, port_fused_large):
        assert "kernel_split(n, two_pass_split(n)[0]" in open(module.__file__).read()
    assert port_large_kernel.MIN_FACTOR <= min(n1, n2)
    assert max(n1, n2) <= port_kernel.MAX_KERNEL_N
    assert n1 <= 4096 or n2 == port_kernel.MAX_KERNEL_N
    assert port_large_kernel.kernel_split(n, n2, "k1b") == (n2, n1)   # n1 pins it
    assert port_large_kernel.large_split(n) == (1 << e // 2, 1 << (e - e // 2))


def plans(n, rows, n1=None):
    """K1b's launch shapes for ``rows`` rows of ``n``: the split, pass A's
    plan (``columns_plan``) and pass B's (K1's CTA over rows*n1 rows of n2,
    and ``rows_plan``'s cluster)."""
    n1, n2 = port_large_kernel.kernel_split(
        n, port_large_kernel.two_pass_split(n)[0] if n1 is None else n1, "plans")
    plan_b, cluster = pass_b_plan(n2, rows * n1)
    return n1, n2, port_large_kernel.columns_plan(n1), plan_b, cluster


# Pass B's rows a CTA over a whole chunk, by n2 (16, or what 1024 threads
# hold, at least K1's 32 at 128), and its CTAs a cluster where 16 rows do
# not fit in one (1 elsewhere).
PASS_B_ROWS = {128: 32, 256: 16, 512: 16, 1024: 16, 2048: 8, 4096: 4, 8192: 2, 16384: 1}
PASS_B_CTAS = {2048: 2, 4096: 4, 8192: 8, 16384: 16}


def check_pass_a(pass_a, n1, *, whole=True):
    """Pass A's pattern: each simulated element loaded and stored once (all
    of them where ``whole``), every warp instruction of both on whole
    32-byte sectors where a CTA holds at least 4 columns, 256 contiguous
    bytes where it holds 32, and the column exchanges free of bank
    conflicts."""
    cols = pass_a["plan"][0]
    assert set(np.unique(pass_a["reads"])) <= {0, 1}
    assert set(np.unique(pass_a["writes"])) <= {0, 1}
    if whole:
        assert (pass_a["reads"] == 1).all()
        assert pass_a["writes"].sum() == pass_a["reads"].sum()
    assert pass_a["loads_whole"] == pass_a["stores_whole"] == (cols >= 4)
    assert pass_a["loads_256"] == pass_a["stores_256"] == (cols >= 32)
    assert pass_a["worst_bank"] == 1
    assert cols == (32 if n1 <= 512 else 16 * 1024 // n1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows, n1", [(1 << 15, 2, None), (1 << 15, 1, 256),
                                         (1 << 15, 3, 128), (1 << 16, 2, None),
                                         (1 << 17, 1, None), (1 << 18, 1, 2048)])
def test_k1b_model_is_the_dft_and_writes_each_element_once(n, rows, n1, inverse):
    """The model of K1b's two passes in their launch shapes: the DFT
    (``numpy.fft``, float64, ``1e-9·n``, over n for the inverse); pass A
    (``check_pass_a``) reads and writes each scratch element once, each warp
    instruction in whole 32-byte sectors (256 contiguous bytes where a CTA
    holds 32 columns), its column exchanges free of bank conflicts (padded
    where a CTA holds fewer than 16 columns, n1 = 2048 here); pass B writes
    each output element once, in bounds, and each warp's stores to one
    output row one contiguous run of 8·min(P·C, 32) bytes (P rows a CTA,
    fewer while the grid is small, C CTAs a cluster), 128 bytes or more
    where the CTAs hold all the rows they can."""
    x = complex_signal(n + rows + inverse, rows, n)
    n1, n2, plan_a, plan_b, cluster = plans(n, rows, n1)
    out, pass_a, writes_b, (nbytes, contiguous, full), _, _ = k1b_model(
        x, n1, n2, inverse=inverse)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-9 * (1 if inverse else n))
    check_pass_a(pass_a, n1)
    assert (pass_a["writes"] == 1).all()
    assert writes_b.shape == (rows * n,) and (writes_b == 1).all()
    assert contiguous.all() and full.any()
    wide = plan_b[0] * cluster
    assert nbytes[full].min() >= 8 * min(wide, 32)
    assert wide >= 16 or plan_b[0] < PASS_B_ROWS[n2]


@pytest.mark.parametrize("e", range(15, 29))
def test_k1b_store_pattern_at_every_length(e):
    """The pattern alone (no data) at every length K1b's two passes take:
    pass A over one row up to 2^22 (the model's arrays are n long), on its
    first, middle and last tiles above, per warp instruction (whole sectors
    where a CTA holds at least 4 columns, n1 <= 4096; 256 contiguous bytes
    where it holds 32, n1 <= 512; no bank conflict); pass B over a whole
    chunk of rows (``scratch_rows``), whose CTAs hold all the rows they can
    (``PASS_B_ROWS``), simulated on four clusters: each element written
    once, no bank conflict in its buffer, and every run contiguous and 128
    bytes (16 rows side by side, through a cluster of ``PASS_B_CTAS`` where
    a CTA holds fewer)."""
    n = 1 << e
    n1, n2 = port_large_kernel.two_pass_split(n)
    groups = n2 // port_large_kernel.columns_plan(n1)[0]
    if e <= 22:
        pass_a = pass_a_model(None, n1, n2, rows=1)
        check_pass_a(pass_a, n1)
        assert (pass_a["writes"] == 1).all()
    else:
        check_pass_a(pass_a_model(None, n1, n2, rows=1, tiles=[0, groups // 2, groups - 1]),
                     n1, whole=False)
    chunk = port_large_kernel.scratch_rows(n)
    plan_b, cluster = pass_b_plan(n2, chunk * n1)
    wide = plan_b[0] * cluster
    assert (plan_b[0], cluster) == (PASS_B_ROWS[n2], PASS_B_CTAS.get(n2, 1))
    assert wide == 16 and plan_b[1] == plan_b[0] * n2 // 16 <= 1024
    _, writes, worst, (nbytes, contiguous, full) = k2_store_model(None, 4 * wide, plan_b,
                                                                  cluster=cluster)
    assert (writes[:, :4 * wide] == 1).all() and contiguous.all() and full.all()
    assert worst == 1
    assert nbytes.min() >= 128 and nbytes.min() == 8 * min(wide, 32)
    cols, threads, smem = port_large_kernel.columns_plan(n1)
    assert threads <= 1024 and smem <= port_kernel.SMEM_BUDGET


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("e", range(19, 29))
def test_pass_a_twiddles_within_a_few_ulps(e, inverse):
    """Pass A's twiddles in the complex modes (five base values a thread,
    each ``large_twiddle``'s exact split, and running products:
    ``pass_a_twiddle_model``) against float64 ``exp(±2πi·k1·j2/n)`` at the
    two passes' split of every length they take, over sampled
    threads t and columns j2 (the ends included): the base values within 4
    float32 ulps of 1 (two roundings and one product), the products within
    10 (up to three more products of about an ulp each on inputs already
    off by up to 4; 6.9–7.5 measured)."""
    n = 1 << e
    n1, n2 = port_large_kernel.two_pass_split(n)
    g = n1 // 16
    rng = np.random.default_rng(e + 100 * inverse)
    t = np.concatenate([[0, g - 1], rng.integers(0, g, 30)])[:, None]
    j2 = np.concatenate([[0, 1, n2 - 1], rng.integers(0, n2, 61)])[None, :]
    got = pass_a_twiddle_model(n, g, t, j2, inverse=inverse)
    k1 = t[None] + np.arange(16)[:, None, None] * g
    sign = 1 if inverse else -1
    want = np.exp(sign * 2j * np.pi * ((k1 * j2) % n) / n)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got[0::4], want[0::4], rtol=0, atol=4 * 2.0 ** -24)
    np.testing.assert_allclose(got, want, rtol=0, atol=10 * 2.0 ** -24)


def test_columns_plan_mirrors_the_cuda_source():
    """Pass A's plans are the source's ``ColPlan`` (the complex modes: 32
    columns a CTA, the columns fastest) and ``PackedColPlan`` (K3b, K4b),
    pass B's its ``RowsPlan`` (``rows_plan``: 16 rows a CTA where 1024
    threads hold them, else clusters); the factors the source
    instantiates are [``MIN_FACTOR``, ``MAX_KERNEL_N``], both directions.
    The passes live in ``fourstep.cuh``, which the source includes."""
    text = "".join((_build.csrc_dir() / name).read_text() for name in (SOURCE, HEADER))
    assert f'#include "{HEADER}"' in text
    lo = int(re.search(r"kMinLog2 = (\d+);", text).group(1))
    hi = int(re.search(r"kMaxLog2 = (\d+);", text).group(1))
    assert 1 << lo == port_large_kernel.MIN_FACTOR and 1 << hi == port_kernel.MAX_KERNEL_N
    columns = int(re.search(r"constexpr int kColumns = (\d+);", text).group(1))
    store_rows = int(re.search(r"constexpr int kStoreRows = (\d+);", text).group(1))
    assert (columns, store_rows) == (port_large_kernel.COLUMNS, port_large_kernel.STORE_ROWS)
    assert "COLS = kColumns * G <= 1024 ? kColumns : 1024 / G;" in text
    assert "repro::regfft::kCtaThreads / G > 4" in text
    assert "COLS = WANT * G > 1024 ? 1024 / G : WANT;" in text
    assert text.count("MIN_BLOCKS = 65536 / (THREADS * 64);") == 2
    assert text.count("exchange_elems(CP::COLS, 1 << LOG2N1)") == 2
    rows_threads = int(re.search(r"constexpr int kRowsThreads = (\d+);", text).group(1))
    assert rows_threads == port_large_kernel.ROWS_THREADS
    assert "FIT = kRowsThreads / G >= 1 ? kRowsThreads / G : 1;" in text
    assert "WIDE = kStoreRows < FIT ? kStoreRows : FIT;" in text
    assert "MAX_ROWS = P::MAX_ROWS > WIDE ? P::MAX_ROWS : WIDE;" in text
    assert ": kStoreRows / MAX_ROWS > 16 ? 16 : kStoreRows / MAX_ROWS;" in text
    assert "rows_per_cta > RowsPlan<LOG2N2>::MAX_ROWS" in text
    assert "__launch_bounds__(RowsPlan<LOG2N2>::MAX_THREADS, RowsPlan<LOG2N2>::MIN_BLOCKS)" in text
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in text
    assert "constexpr bool kPersistentColumns = false;" in text
    for e in range(lo, hi + 1):
        n1 = 1 << e
        group = n1 // 16
        # PackedColPlan: at least 4 columns, 256 threads, at most 1024.
        packed = max(4, 256 // group) if n1 <= 4096 else 1024 // group
        packed = (packed, packed * group, 8 * (packed * n1 + -(-packed * n1 // 16)))
        for plan in (port_large_kernel.columns_plan(n1), packed):
            cols, threads, smem = plan
            assert threads == cols * group <= 1024 and cols & (cols - 1) == 0
            assert smem == 8 * (cols * n1 + -(-cols * n1 // 16)) <= port_kernel.SMEM_BUDGET
            assert 65536 // (threads * 64) * (smem + 1024) <= 233472
        assert port_large_kernel.columns_plan(n1)[0] == (32 if n1 <= 512 else 1024 // group)
        rows_per_cta, threads, cluster = port_large_kernel.rows_plan(n1, 1 << 20)
        assert (rows_per_cta, cluster) == (PASS_B_ROWS[n1], PASS_B_CTAS.get(n1, 1))
        assert threads == rows_per_cta * group <= 1024
        assert 8 * (rows_per_cta * n1 + rows_per_cta * n1 // 16) <= port_kernel.SMEM_BUDGET
        # Fewer rows a CTA while the grid would not fill the card, as K1's.
        assert port_large_kernel.rows_plan(n1, 64)[0] <= rows_per_cta
    # Pass A's loads, interleaved columns, twiddles and stores; pass B's
    # batched store.
    assert "const int c = threadIdx.x & (COLS - 1);" in text
    assert "const int t = threadIdx.x >> CP::LOG2COLS;" in text
    assert "column_fft<LOG2N1, COLS, INV>(v, smem, c, t);" in text
    assert "column_twiddles<INV, true>(v, t, G, j2, log2n);" in text
    assert "const int p0 = column_slot<COLS>((((j << 4) << log2s) + q) * COLS + c);" in text
    assert "buf[p0 + column_slot<COLS>((u << log2s) * COLS)] = v[u]" in text
    assert "const int r0 = column_slot<COLS>(t * COLS + c);" in text
    assert "v[k] = buf[r0 + column_slot<COLS>(k * G * COLS)]" in text
    assert "return x + ((x >> (4 + LOG2COLS)) << LOG2COLS);" in text
    assert "if constexpr (SPLIT) {\n            return twiddle<INV>(m, log2n);" in text
    assert "float2 w = base((t + 4 * kh * g) * j2);" in text
    assert "const float2 b = base(g * j2);" in text
    assert "(float)mh * exp2i(15 - log2n)" in text and "(float)ml * exp2i(1 - log2n)" in text
    assert "+ (t << log2k) + j2;" in text and "dst[k * dstep] = v[k];" in text
    assert "v[k] = x[k * step];" in text
    assert "fft_row<LOG2N2, INV>(v, smem, local * N, t)" in text
    assert ("out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)]"
            in text)
    assert "static_assert(packed_load(MODE)" in text
    assert "__sincosf" not in text.replace("No __sincosf", "")
    assert "Replaces the TPU kernel `fft_rows_pallas`" in text
    assert "Bound on this card: bytes" in text


def test_launcher_and_binding():
    """The C entry point is bound with its ten arguments (three pointers, a
    64-bit row count, the stream last); the launcher refuses a CPU tensor
    and a split outside the kernel's factors; the scratch of a call is at
    most 1 GiB, or one row where a row is longer."""
    restype, argtypes = _build._FUNCTIONS["repro_fft_rows_large"]
    assert len(argtypes) == 10 and argtypes[3] is _build._LL
    assert argtypes[:3] == [_build._PTR] * 3 and argtypes[-1] is _build._PTR
    assert "extern \"C\" int repro_fft_rows_large(" in (_build.csrc_dir() / SOURCE).read_text()
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_large_kernel.fft_rows_large_cuda(torch.ones((1, 1 << 15), dtype=torch.complex64))
    for n in (1 << 15, 1 << 20, 1 << 27, 1 << 28):
        rows = port_large_kernel.scratch_rows(n)
        assert rows * n * 8 <= max(1 << 30, n * 8) and rows >= 1
    assert port_large_kernel.scratch_rows(1 << 28) == 1
    assert port_large_kernel.scratch_rows(1 << 15) == 4096


# ------------------------------------------- the one-pass cluster kernel

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows, ctas", [(1 << 15, 1, None), (1 << 15, 3, None),
                                           (1 << 16, 2, None), (1 << 17, 1, None),
                                           (1 << 17, 1, 8), (1 << 18, 1, None)])
def test_k1b_cluster_model_is_the_dft(n, rows, ctas, inverse):
    """The model of the one-pass kernel in the rule's launch shape
    (``cluster_plan(n)``; at 2^17 also over 8 CTAs, the variant) is the
    DFT: ``numpy.fft`` in float64 to ``1e-9·n``, the inverse to ``1e-9``;
    every input element loaded once, every slab slot written once (by the
    rank and row that the point's k1 gives) and loaded once, every output
    element stored once."""
    x = complex_signal(n + 2 * rows + inverse, rows, n)
    model = k1b_cluster_model(x, n, inverse=inverse, ctas=ctas)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
    np.testing.assert_allclose(model["out"], exact, rtol=0, atol=1e-9 * (1 if inverse else n))
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, variant", CLUSTER_SHAPES)
def test_k1b_cluster_pattern(n, variant, inverse):
    """The launch shape ``cluster_plan(n)`` (and the 8-CTA variant at
    2^17), the pattern alone over 2 rows (the same in both directions: the
    direction changes no index): each element loaded, sent, read back and
    stored once, each point to its owner; every warp's load 32 consecutive
    elements from a 256-byte boundary; the remote stores and the output
    stores of every warp instruction whole 32-byte sectors, the output runs
    W = n1/C elements (at most a warp's 32) long; no bank conflict in the
    column exchanges, the remote stores, the row phase's loads or the
    staging; and the row DFT's own exchanges (regfft's, over W rows of n2)
    conflict-free too."""
    model = k1b_cluster_model(None, n, rows=2, inverse=inverse, ctas=variant)
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"] and model["loads_whole"] and model["stores_whole"]
    assert model["loads_256"] and model["worst_bank"] == 1
    n1, n2, ctas, threads, smem = port_large_kernel.cluster_plan(n)
    if variant is not None:
        ctas, threads = variant, n // variant // 16
        smem = 8 * (n // ctas + n // ctas // 16)
    assert set(model["store_runs"].tolist()) == {8 * min(n1 // ctas, 32)}
    w = n1 // ctas
    plan = (w, threads, 16, port_kernel.complex_rows_plan(n2, 1)[3], smem)
    _, worst = kernel_pass_model(torch.zeros((w, n2), dtype=torch.complex64), plan)
    assert worst == 1


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_twiddles_within_a_few_ulps(n, inverse):
    """The one-pass kernel's twiddles (five sincospif a thread and running
    products, ``cluster_twiddle_model``) against float64 ``exp(±2πi·k1·j2/n)``
    over every (k1, j2) of its split: within 6 float32 ulps of 1 (two
    roundings of about half an ulp each and up to three complex64 products
    of about an ulp each; 3.4-3.9 measured)."""
    n1, n2 = port_large_kernel.cluster_plan(n)[:2]
    g = n1 // 16
    t, j2 = np.arange(g)[:, None], np.arange(n2)[None, :]
    got = cluster_twiddle_model(n, g, t, j2, inverse=inverse)
    k1 = t[None] + np.arange(16)[:, None, None] * g
    want = np.exp((1 if inverse else -1) * 2j * np.pi * ((k1 * j2) % n) / n)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=6 * 2.0 ** -24)


def test_cluster_plan_mirrors_the_cuda_source():
    """``cluster_plan`` is the source's shape: ``CLUSTER_LENGTHS`` the
    lengths its entry dispatches, ``CLUSTER_CTAS[n]`` its ``log2_ctas`` at
    each (8 up to 65536, 16 above: non-portable, which ``launch_cluster``
    allows), the split ``large_split(n)``'s (log2 n1 = log2 n / 2, rounded
    down), and ``ClusterPlan``'s n/(16C) threads and (n/C)*17/16 float2 of
    shared memory, what the source's static_asserts require, and a CTA
    count an SM that fits its shared memory."""
    text = "".join((_build.csrc_dir() / name).read_text()
                   for name in (CLUSTER_SOURCE, CLUSTER_HEADER, HEADER))
    assert f'#include "{CLUSTER_HEADER}"' in text and f'#include "{HEADER}"' in text
    rule = re.search(r"constexpr int log2_ctas\(int log2n\) \{ return log2n <= (\d+) \? "
                     r"(\d+) : (\d+); \}", text)
    top, low, high = map(int, rule.groups())
    assert "launch_cluster<LOG2N / 2, LOG2N - LOG2N / 2, log2_ctas(LOG2N), INV>" in text
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in text
    entry = text[text.index('extern "C" int repro_fft_rows_cluster('):]
    assert [1 << int(e) for e in re.findall(r"case 1 << (\d+):", entry)] == list(
        CLUSTER_LENGTHS)
    assert port_large_kernel.CLUSTER_MAX_N == 1 << 18
    assert "ELEMS = repro::regfft::exchange_elems(W, N2);" in text
    assert "MIN_BLOCKS = 65536 / (THREADS * 64);" in text
    assert "COLS >= 32 && W >= 4" in text and "G2 >= 16" in text
    assert "C >= 2 && C <= 16" in text
    for n in CLUSTER_LENGTHS:
        n1, n2, ctas, threads, smem = port_large_kernel.cluster_plan(n)
        log2n = n.bit_length() - 1
        assert (n1, n2) == port_large_kernel.large_split(n) == (
            1 << log2n // 2, 1 << (log2n - log2n // 2))
        assert ctas == port_large_kernel.CLUSTER_CTAS[n] == 1 << (
            low if log2n <= top else high)
        assert ctas == (8 if n <= 1 << 16 else 16)
        cols, w = n2 // ctas, n1 // ctas
        assert threads == cols * (n1 // 16) == w * (n2 // 16) <= 1024
        assert cols >= 32 and w >= 4 and n2 >= 256 and 2 <= ctas <= 16
        assert smem == 8 * (w * n2 + -(-w * n2 // 16)) <= port_kernel.SMEM_BUDGET
        assert 65536 // (threads * 64) * (smem + 1024) <= 233472
    # The phases as the docstrings and the model describe them.
    assert "column_fft<LOG2N1, COLS, INV>(v, buf, c, t)" in text
    # column_fft and column_twiddles live in fourstep.cuh, shared with pass
    # A of the two passes; at COLS >= 16 the slot is f*COLS + c itself.
    assert "buf[p0 + column_slot<COLS>((u << log2s) * COLS)] = v[u]" in text
    assert "if constexpr (COLS >= 16) {\n        return x;" in text
    assert "column_twiddles<INV>(v, t, G1, j2, LOG2N)" in text
    assert "slab[(t + i * G1) * N2 + j2] = v[o * CP::PER_RANK + i]" in text
    assert "v[k] = buf[rho * N2 + t2 + k * G2]" in text
    assert "fft_row<LOG2N2, INV>(v, buf, rho * N2, t2)" in text
    assert "smem[slot(((((t2 + k * G2) << CP::LOG2W) + rho) << LOG2R) + g)] = v[k]" in text
    assert "float2* o = TRANSPOSED ? out : out + (s << LOG2N) + rank * W;" in text
    assert "o[k2 * N1 + q] = smem[slot(idx)]" in text
    assert text.count("cluster.sync()") == 2
    assert "repro::tstore::launch<CP::C>" in text
    assert "Replaces the TPU kernel `fft_rows_pallas`" in text
    assert "Bound on this card: bytes" in text


def test_cluster_binding():
    """The one-pass entry is bound with its six arguments (two pointers, a
    64-bit row count, n, the direction, the stream last): no launch shape
    and no scratch."""
    restype, argtypes = _build._FUNCTIONS["repro_fft_rows_cluster"]
    assert restype is _build._INT and len(argtypes) == 6
    assert argtypes[:2] == [_build._PTR] * 2 and argtypes[2] is _build._LL
    assert argtypes[3:5] == [_build._INT] * 2 and argtypes[-1] is _build._PTR
    assert [name for name in _build._FUNCTIONS if "cluster" in name] == [
        "repro_fft_rows_cluster", "repro_fft_rows_transpose_cluster"]
    text = (_build.csrc_dir() / CLUSTER_SOURCE).read_text()
    assert ('extern "C" int repro_fft_rows_cluster(const void* in, void* out, long long rows, '
            'int n,') in text
    assert text.count('extern "C"') == 1


def test_cluster_plan_refusals():
    for n in (1 << 14, 1 << 19, 3 << 14):
        with pytest.raises(ValueError, match="no cluster kernel"):
            port_large_kernel.cluster_plan(n)


@pytest.mark.parametrize("inverse", [False, True])
def test_launcher_takes_one_cluster_launch_up_to_65536(monkeypatch, inverse):
    """What ``fft_rows_large_cuda`` launches, with the launch recorded in
    place of the library: at 32768 and 65536 one launch of the cluster
    entry a call, counted once, with no scratch; above, the two passes a
    chunk (two counts each) with scratch; a pinned two-pass split is
    refused where the cluster kernel runs."""
    calls = []
    monkeypatch.setattr(port_large_kernel, "check_kernel_input",
                        lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_large_kernel, "launch",
                        lambda fn, x, out, **args: calls.append((fn, x.shape, args)))
    for n, rows in ((1 << 15, 2049), (1 << 16, 3)):
        port_large_kernel.reset_launch_count()
        calls.clear()
        out = port_large_kernel.fft_rows_large_cuda(
            torch.zeros((rows, n), dtype=torch.complex64), inverse=inverse)
        assert out.shape == (rows, n)
        assert calls == [("repro_fft_rows_cluster", (rows, n),
                          {"rows": rows, "n": n, "inverse": int(inverse)})]
        assert port_large_kernel.launch_count() == 1
        assert port_large_kernel.two_pass_launch_count() == 0
        with pytest.raises(ValueError, match="cluster kernel runs"):
            port_large_kernel.fft_rows_large_cuda(
                torch.zeros((1, n), dtype=torch.complex64), n1=128)
    port_large_kernel.reset_launch_count()
    calls.clear()
    port_large_kernel.fft_rows_large_cuda(torch.zeros((1, 1 << 19), dtype=torch.complex64),
                                          inverse=inverse)
    assert [c[0] for c in calls] == ["repro_fft_rows_large"]
    assert "scratch" in calls[0][2] and port_large_kernel.launch_count() == 2
    assert port_large_kernel.two_pass_launch_count() == 2
    port_large_kernel.reset_launch_count()
    assert port_large_kernel.two_pass_launch_count() == 0


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows", [(1 << 17, 3), (1 << 18, 2)])
def test_launcher_takes_one_cluster_launch_at_rows_of_1_and_2_mib(monkeypatch, n, rows,
                                                                  inverse):
    """At 2^17 and 2^18, with the launch recorded in place of the library:
    one launch of the cluster entry a call, counted once, also as a long
    cluster launch, none of the two passes, no scratch allocated beside the
    output; a pinned split is refused there."""
    calls, allocated = [], []
    monkeypatch.setattr(port_large_kernel, "check_kernel_input",
                        lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_large_kernel, "launch",
                        lambda fn, x, out, **args: calls.append((fn, x.shape, args)))
    empty = torch.empty
    monkeypatch.setattr(port_large_kernel.torch, "empty",
                        lambda *a, **k: allocated.append(a) or empty(*a, **k))
    port_large_kernel.reset_launch_count()
    out = port_large_kernel.fft_rows_large_cuda(
        torch.zeros((rows, n), dtype=torch.complex64), inverse=inverse)
    assert out.shape == (rows, n) and allocated == []
    assert calls == [("repro_fft_rows_cluster", (rows, n),
                      {"rows": rows, "n": n, "inverse": int(inverse)})]
    assert port_large_kernel.launch_count() == 1
    assert port_large_kernel.long_cluster_launch_count() == 1
    assert port_large_kernel.two_pass_launch_count() == 0
    with pytest.raises(ValueError, match="cluster kernel runs"):
        port_large_kernel.fft_rows_large_cuda(torch.zeros((1, n), dtype=torch.complex64),
                                              n1=256)
    port_large_kernel.reset_launch_count()
    assert port_large_kernel.long_cluster_launch_count() == 0


def test_cpu_op_launches_nothing():
    port_kernels.reset_launch_counts()
    fft_rows_op(to_torch(complex_signal(1, 2, 1 << 15)))
    counts = port_kernels.launch_counts()
    assert counts["fft_rows_large"] == 0 and set(counts.values()) == {0}
    assert _build._library is None


# ---------------------------------------------------- the path through K1b

@pytest.mark.parametrize("inverse", [False, True])
def test_pfft1_large_phase_through_k1b_matches_reference(inverse):
    """The huge-1-D four-step at N = 2^16 split (2, 32768) under
    ``radix=4``: its phase of 32768 goes through K1b (its plain version
    here), the reference's through its Pallas kernel; within the line
    tolerance of ``test_torch_pfft3d.py`` scaled by sqrt(N / 360)."""
    n = 1 << 16
    x = complex_signal(11 + inverse, n)
    if inverse:
        x = np.conj(x)
    cfg_r, cfg_p = ref_plan.PlanConfig(radix=4), port_plan.PlanConfig(radix=4)
    want = np.asarray(ref_large.pfft1_large_apply(jnp.asarray(x), config=cfg_r, n1=2))
    got = to_numpy(port_large.pfft1_large_apply(to_torch(x), config=cfg_p, n1=2))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.sqrt(n / 360))
    np.testing.assert_allclose(got, np.fft.fft(x.astype(np.complex128)), rtol=0,
                               atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("radix", [None, 4])
def test_plan_pfft1_large_at_a_pinned_split_matches_reference(radix):
    """``plan_pfft1_large`` at a pinned, non-square power-of-two split (2^14
    as 16 x 1024, ``n2=``), the way ``chip_smoke.py`` sends a phase of 2^17
    through K1b's cluster kernel: the same factors and wisdom key as the
    reference's plan, the same line (the port's kernels in their plain
    versions here) within the line tolerance of ``test_torch_pfft3d.py``
    scaled by sqrt(N / 360), and ``numpy.fft``."""
    n = 1 << 14
    ref_cfg = None if radix is None else ref_plan.PlanConfig(radix=radix)
    port_cfg = None if radix is None else port_plan.PlanConfig(radix=radix)
    want = ref_api.plan_pfft1_large(n, n2=1 << 10, config=ref_cfg)
    got = port_api.plan_pfft1_large(n, n2=1 << 10, config=port_cfg, device="cpu")
    assert (got.n1, got.n2) == (want.n1, want.n2) == (16, 1 << 10)
    assert got.tuning.get("wisdom_key") == want.tuning.get("wisdom_key")
    x = complex_signal(17 + (radix or 0), n)
    out = to_numpy(got.execute(to_torch(x)))
    np.testing.assert_allclose(out, np.asarray(want.execute(jnp.asarray(x))), rtol=0,
                               atol=2e-3 * np.sqrt(n / 360))
    np.testing.assert_allclose(out, np.fft.fft(x.astype(np.complex128)), rtol=0,
                               atol=1e-3 * np.sqrt(n))
