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
                           k1b_model, kernel_pass_model, to_numpy, to_torch)

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

def plans(n, rows, n1=None):
    """K1b's launch shapes for ``rows`` rows of ``n``: the split, pass A's
    columns a CTA, pass B's plan (K1's, over rows*n1 rows of n2) and its
    cluster (K2's rule)."""
    n1, n2 = port_large_kernel.large_split(n, n1=n1)
    cols = port_large_kernel.columns_plan(n1)[0]
    plan_b = port_kernel.complex_rows_plan(n2, rows * n1)
    cluster = port_fused_kernel.fft_rows_transpose_plan(n2, rows * n1)[2]
    return n1, n2, cols, plan_b, cluster


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows, n1", [(1 << 15, 2, None), (1 << 15, 1, 256),
                                         (1 << 16, 2, None), (1 << 17, 1, None)])
def test_k1b_model_is_the_dft_and_writes_each_element_once(n, rows, n1, inverse):
    """The model of K1b's two passes in their launch shapes: the DFT
    (``numpy.fft``, float64, ``1e-9·n``, over n for the inverse); pass A
    reads and writes each scratch element once, in bounds, and each step of
    a CTA in whole 32-byte sectors (its columns, at least 4, side by side);
    pass B writes each output element once, in bounds, and each warp's
    stores to one output row one contiguous run of 8·min(P·C, 32) bytes,
    K2's rule (P rows a CTA, fewer while the grid is small, C CTAs a
    cluster)."""
    x = complex_signal(n + rows + inverse, rows, n)
    n1, n2, cols, plan_b, cluster = plans(n, rows, n1)
    assert cols >= 4 and (n1 % (plan_b[0] * cluster)) == 0
    out, reads_a, writes_a, sectors_a, writes_b, (nbytes, contiguous, full) = k1b_model(
        x, n1, n2, cols, plan_b, cluster, inverse=inverse)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-9 * (1 if inverse else n))
    assert (reads_a == 1).all() and (writes_a == 1).all() and sectors_a
    assert writes_b.shape == (rows * n,) and (writes_b == 1).all()
    assert contiguous.all() and full.any()
    assert nbytes[full].min() >= 8 * min(plan_b[0] * cluster, 32)


@pytest.mark.parametrize("e", range(15, 29))
def test_k1b_store_pattern_at_every_length(e):
    """The pattern alone (no data) at every length K1b takes, one row:
    whole sectors in pass A wherever a CTA holds at least 4 columns (n1 <=
    4096: up to n = 2^25; at 8192 and 16384 it holds 2 and 1, what 1024
    threads hold), each element written once by both passes, and pass B's
    runs contiguous, of K2's width.  The model's arrays are n long, so
    this stops at what the host holds quickly: 2^22.  Over a whole chunk of
    rows (``scratch_rows``) pass B's CTAs hold all the rows they can, and
    its runs are a sector or more at every length."""
    if e <= 22:
        n1, n2, cols, plan_b, cluster = plans(1 << e, 1)
        _, reads_a, writes_a, sectors_a, writes_b, (nbytes, contiguous, full) = k1b_model(
            None, n1, n2, cols, plan_b, cluster, rows=1)
        assert (reads_a == 1).all() and (writes_a == 1).all() and (writes_b == 1).all()
        assert sectors_a and contiguous.all()
        assert nbytes[full].min() >= 8 * min(plan_b[0] * cluster, 32)
    n1, n2, _, plan_b, cluster = plans(1 << e, port_large_kernel.scratch_rows(1 << e))
    assert plan_b[0] == max(1, 256 * 16 // n2) and 8 * min(plan_b[0] * cluster, 32) >= 32
    cols, threads, smem = port_large_kernel.columns_plan(n1)
    assert threads <= 1024 and smem <= port_kernel.SMEM_BUDGET
    assert cols == (4 if n1 == 4096 else 2 if n1 == 8192 else 1 if n1 == 16384
                    else max(4, 256 // (n1 // 16)))


def test_columns_plan_mirrors_the_cuda_source():
    """Pass A's plan is the source's ``ColPlan`` and pass B's the register
    kernels' ``Plan``; the factors the source instantiates are
    [``MIN_FACTOR``, ``MAX_KERNEL_N``], both directions.  The passes live in
    ``fourstep.cuh``, which the source includes."""
    text = "".join((_build.csrc_dir() / name).read_text() for name in (SOURCE, HEADER))
    assert f'#include "{HEADER}"' in text
    lo = int(re.search(r"kMinLog2 = (\d+);", text).group(1))
    hi = int(re.search(r"kMaxLog2 = (\d+);", text).group(1))
    assert 1 << lo == port_large_kernel.MIN_FACTOR and 1 << hi == port_kernel.MAX_KERNEL_N
    assert "repro::regfft::kCtaThreads / G > 4" in text
    assert "COLS = WANT * G > 1024 ? 1024 / G : WANT;" in text
    assert "MIN_BLOCKS = 65536 / (THREADS * 64);" in text
    assert "exchange_elems(CP::COLS, 1 << LOG2N1)" in text
    for e in range(lo, hi + 1):
        n1 = 1 << e
        cols, threads, smem = port_large_kernel.columns_plan(n1)
        group = n1 // 16
        assert threads == cols * group <= 1024 and cols & (cols - 1) == 0
        assert smem == 8 * (cols * n1 + -(-cols * n1 // 16)) <= port_kernel.SMEM_BUDGET
        assert 65536 // (threads * 64) * (smem + 1024) <= 233472
    # Pass A's loads and stores, the twiddle split, pass B's batched store.
    assert "fft_row<LOG2N1, INV>(v, smem, c * N1, t)" in text
    assert "twiddle<INV>(k1 * j2, log2n)" in text
    assert "(float)mh * exp2i(15 - log2n)" in text and "(float)ml * exp2i(1 - log2n)" in text
    assert "fft_row<LOG2N2, INV>(v, smem, local * N, t)" in text
    assert ("out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)]"
            in text)
    assert "repro::tstore::store_cluster<LOG2N2, 8>(4)" in text
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
                   for name in (CLUSTER_SOURCE, CLUSTER_HEADER))
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
    assert "buf[(f0 + (u << log2s)) * COLS + c] = v[u]" in text
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
