"""K2b, K3b and K4b, the four-step fused and real row kernels of rows longer
than K2-K4 hold (``csrc/fft_rows_transpose_large.cu``,
``csrc/rfft_rows_large.cu``, ``csrc/rfft_rows_transpose_large.cu`` on
``csrc/fourstep.cuh``), on the CPU: their plain versions against the
reference's ops (Pallas in interpret mode) and ``numpy.fft``, at forced
splits, float64 models of K2b's ``[k1][s][j2]`` scratch and transposed store
and of pass C's split in both stores, their launch plans and bindings
against the CUDA sources, and the ``fft2d`` paths through them.

The CUDA kernels run only on the card (``chip_smoke.py``,
``examples/kernel_check_torch.py --large-fused-and-real-only``).  Run these
alone with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_fused_large.py``.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (SPLIT_THREADS, TILE_BINS, TILE_PAIRS, complex_signal,
                           k2b_model, split_model, to_numpy, to_torch)

import repro.fft.fft2d as ref_fft2d
from repro.kernels.fft.real import rfft_rows_op as ref_rfft_rows_op
from repro.kernels.fused.ops import fft_rows_transpose_op as ref_fused_op
from repro.kernels.fused.real import rfft_rows_transpose_op as ref_rfused_op

import repro_torch.fft.fft2d as port_fft2d
from repro_torch import kernels as port_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fft import large as port_large
from repro_torch.kernels.fft import real_large as port_real_large
from repro_torch.kernels.fft.real import rfft_rows_op
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused import large as port_fused_large
from repro_torch.kernels.fused import real_large as port_fused_real_large
from repro_torch.kernels.fused.ops import fft_rows_transpose_op
from repro_torch.kernels.fused.real import rfft_rows_transpose_op

SOURCES = {"fft_rows_transpose_large": "fft_rows_transpose_large.cu",
           "rfft_rows_large": "rfft_rows_large.cu",
           "rfft_rows_transpose_large": "rfft_rows_transpose_large.cu"}


def tol(n, inverse=False):
    """``1e-3·sqrt(n)`` on the unscaled transform, over n for the inverse
    (its 1/n shrinks the values by n)."""
    return 1e-3 * np.sqrt(n) / (n if inverse else 1)


def real_signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def source(name):
    return (_build.csrc_dir() / name).read_text()


# ------------------------------------------------------ the plain versions

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [32768, 65536])
def test_k2b_plain_version_matches_reference_and_numpy(n, inverse):
    """``fft_rows_transpose_large_plain`` at the default split, and the
    port's fused op on the CPU (which takes it above ``MAX_KERNEL_N``),
    against the reference's fused Pallas kernel and ``numpy.fft``, 3 rows."""
    x = complex_signal(n + 3 * inverse, 3, n)
    want = np.asarray(ref_fused_op(jnp.asarray(x), inverse=inverse))
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128)).T
    got = to_numpy(port_fused_large.fft_rows_transpose_large_plain(to_torch(x),
                                                                   inverse=inverse))
    op = to_numpy(fft_rows_transpose_op(to_torch(x), inverse=inverse))
    assert got.shape == (n, 3)
    for a, b in ((got, want), (got, exact)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol(n, inverse))
    np.testing.assert_array_equal(op, got)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("n", [32768, 65536])
def test_real_plain_versions_match_reference_and_numpy(n, rows, fused):
    """K3b's and K4b's plain versions, and the port's real ops on the CPU,
    against the reference's Pallas kernels and ``numpy.fft.rfft``; 3 rows
    leave an unpaired last one."""
    x = real_signal(n + rows + fused, rows, n)
    ref = ref_rfused_op if fused else ref_rfft_rows_op
    want = np.asarray(ref(jnp.asarray(x)))
    exact = np.fft.rfft(x.astype(np.float64), axis=-1)
    plain = (port_fused_real_large.rfft_rows_transpose_large_plain if fused
             else port_real_large.rfft_rows_large_plain)
    got = to_numpy(plain(to_torch(x)))
    op = to_numpy((rfft_rows_transpose_op if fused else rfft_rows_op)(to_torch(x)))
    assert got.dtype == np.complex64
    for a, b in ((got, want), (got, exact.T if fused else exact)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol(n))
    np.testing.assert_array_equal(op, got)


@pytest.mark.parametrize("kind", ["k2b", "k2b-inverse", "k3b", "k4b"])
@pytest.mark.parametrize("split", [(4, 16), (64, 8), (2, 16384)])
def test_plain_versions_at_forced_splits(split, kind):
    """Any split into powers of two gives the transform: the passes' index
    arithmetic, K2b's ``[k1][s][j2]`` scratch and the split do not lean on
    the near-square default; pinning n1 or n2 is the same split."""
    n1, n2 = split
    n = n1 * n2
    seed = n1 + len(kind)
    if kind.startswith("k2b"):
        inverse = kind.endswith("inverse")
        x = complex_signal(seed, 5, n)
        plain = port_fused_large.fft_rows_transpose_large_plain
        got = plain(to_torch(x), inverse=inverse, n1=n1)
        got2 = plain(to_torch(x), inverse=inverse, n2=n2)
        exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128)).T
    else:
        inverse = False
        x = real_signal(seed, 5, n)
        plain = (port_real_large.rfft_rows_large_plain if kind == "k3b"
                 else port_fused_real_large.rfft_rows_transpose_large_plain)
        got, got2 = plain(to_torch(x), n1=n1), plain(to_torch(x), n2=n2)
        exact = np.fft.rfft(x.astype(np.float64), axis=-1)
        exact = exact.T if kind == "k4b" else exact
    np.testing.assert_allclose(to_numpy(got), exact, rtol=0, atol=tol(n, inverse))
    np.testing.assert_array_equal(to_numpy(got2), to_numpy(got))


# ------------------------------------------------------ the kernels' models

def k2b_plans(n, rows, n1=None):
    """K2b's launch shapes for one chunk of ``rows`` rows: the split, pass
    A's columns a CTA, pass B's plan over cap*n1 rows of n2 and its cluster
    (K2's rule)."""
    n1, n2 = port_large.large_split(n, n1=n1)
    cap = port_large.scratch_capacity(rows)
    cols = port_large.columns_plan(n1)[0]
    plan_b = port_kernel.complex_rows_plan(n2, cap * n1)
    cluster = port_fused_kernel.fft_rows_transpose_plan(n2, cap * n1)[2]
    return n1, n2, cols, plan_b, cluster


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows, n1, stride, r0", [
    (1 << 15, 3, None, 3, 0), (1 << 15, 1, 256, 4, 2), (1 << 15, 5, None, 16385, 4096),
    (1 << 16, 2, None, 2, 0), (1 << 17, 1, None, 3, 1)])
def test_k2b_model_is_the_transposed_dft_and_writes_each_element_once(
        n, rows, n1, stride, r0, inverse):
    """The model of K2b's two passes in their launch shapes, one chunk of
    ``rows`` rows stored to columns ``r0 ...`` of an (n, ``stride``) output:
    ``FFT_rows(x).T`` (``numpy.fft``, float64, ``1e-9·n``, over n for the
    inverse); pass A reads each input element once and writes each scratch
    element of the chunk's rows once and none of the capacity's spare rows,
    every step of a CTA in whole 32-byte sectors both ways; pass B writes
    each element of the chunk's columns once and no other; each warp's
    stores to one output row are one contiguous run of K2's width, and a
    run never crosses a k1 (cap a multiple of the rows side by side)."""
    x = complex_signal(n + rows + inverse, rows, n)
    n1, n2, cols, plan_b, cluster = k2b_plans(n, rows, n1)
    out, reads_a, writes_a, sectors_a, writes_b, (nbytes, contiguous, full), cap = k2b_model(
        x, n1, n2, cols, plan_b, cluster, out_stride=stride, r0=r0, inverse=inverse)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128)).T
    np.testing.assert_allclose(out[:, r0:r0 + rows], exact, rtol=0,
                               atol=1e-9 * (1 if inverse else n))
    assert (reads_a == 1).all() and sectors_a
    per_row = writes_a.reshape(n1, cap, n2)
    assert (per_row[:, :rows] == 1).all() and (per_row[:, rows:] == 0).all()
    writes_b = writes_b.reshape(n, stride)
    assert (writes_b[:, r0:r0 + rows] == 1).all()
    assert writes_b.sum() == n * rows
    assert contiguous.all() and full.any()
    wide = plan_b[0] * cluster
    assert cap % wide == 0 or cap < wide
    if cap >= wide:
        assert nbytes[full].min() >= 8 * min(wide, 32)


@pytest.mark.parametrize("e", range(15, 29))
def test_k2b_store_pattern_at_every_length(e):
    """K2b's pattern at every length it takes, over a whole chunk of rows
    (``scratch_rows``, a power of two): the scratch of a chunk is at most 1
    GiB or one row; where a chunk holds at least the rows a store puts side
    by side (n <= 2^25), pass B's CTAs hold all the rows they can and a
    store never crosses a k1, so its runs are K2's, a sector or more; above,
    a chunk of 2 or 1 rows gives runs of 16 or 8 bytes.  The model's arrays
    are n * rows long, so it runs on one row up to 2^20."""
    n = 1 << e
    chunk = port_large.scratch_rows(n)
    assert chunk & (chunk - 1) == 0 and port_large.scratch_capacity(chunk) == chunk
    assert chunk * n * 8 <= max(1 << 30, n * 8)
    n1, n2, cols, plan_b, cluster = k2b_plans(n, chunk)
    wide = plan_b[0] * cluster
    assert (chunk >= wide) == (e <= 25)
    if chunk >= wide:
        assert chunk % wide == 0 and plan_b[0] == max(1, 256 * 16 // n2)
        assert 8 * min(wide, 32) >= 32
    if e <= 20:
        n1, n2, cols, plan_b, cluster = k2b_plans(n, 1)
        _, reads_a, writes_a, sectors_a, writes_b, runs, _ = k2b_model(
            None, n1, n2, cols, plan_b, cluster, rows=1)
        assert (reads_a == 1).all() and (writes_a == 1).all() and (writes_b == 1).all()
        assert sectors_a == (cols >= 4) and runs[1].all()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("rows, n", [(1, 1 << 15), (3, 1 << 15), (4, 1 << 15),
                                     (33, 1 << 15), (2, 1 << 16), (5, 1 << 17)])
def test_split_model_is_the_half_spectrum_and_writes_each_element_once(
        rows, n, transposed):
    """Pass C of K3b (row-major) and K4b (transposed, through the tile of 16
    pairs x 32 bins) on the packed pairs' DFTs: ``numpy.fft.rfft`` of the
    real rows (float64, ``1e-9·n``); each output element written once
    (K4b: to columns 2 ... of a wider output, nothing around them); every
    bin k read beside bin (n - k) mod n of its pair; each warp of K4b's
    store writes one contiguous run of one output row, 256 bytes wherever
    its tile holds 32 real rows."""
    x = np.random.default_rng(rows + n).standard_normal((rows, n))
    packed = np.vstack([x, np.zeros((1, n))]) if rows % 2 else x
    z = np.fft.fft(packed[0::2] + 1j * packed[1::2], axis=-1)
    exact = np.fft.rfft(x, axis=-1)
    c0, stride = (2, rows + 5) if transposed else (0, None)
    out, writes, partner_ok, runs = split_model(z, rows, n, transposed=transposed,
                                                out_stride=stride, c0=c0)
    assert partner_ok
    if transposed:
        np.testing.assert_allclose(out[:, c0:c0 + rows], exact.T, rtol=0, atol=1e-9 * n)
        assert (writes[:, c0:c0 + rows] == 1).all() and writes.sum() == exact.size
        nbytes, one_run = runs
        assert one_run.all() and nbytes.max() <= 8 * 2 * TILE_PAIRS
        if rows >= 2 * TILE_PAIRS:
            assert nbytes.max() == 256
    else:
        np.testing.assert_allclose(out, exact, rtol=0, atol=1e-9 * n)
        assert (writes == 1).all() and runs is None


# -------------------------------------------------- plans against the sources

def test_pass_c_and_the_store_orders_mirror_the_cuda_source():
    """Pass C's launch (threads, tile) and the index arithmetic the models
    above follow are the shared header's: K2b's pass-A store at (k1*cap +
    s)*n2 + j2 and pass-B store at (k1 + n1*k2)*out_stride + s, the split's
    partner (n - k) & (n - 1); K1b's orders unchanged."""
    text = source("fourstep.cuh")
    assert f"kSplitThreads = {SPLIT_THREADS};" in text
    assert f"kTilePairs = {TILE_PAIRS};" in text and f"kTileBins = {TILE_BINS};" in text
    assert "kTileStride = 2 * kTilePairs + 1;" in text
    assert "? scratch + (s << log2n2) + ((long long)t << log2k) + j2" in text
    assert "const int log2k = MODE == kTransposedStore ? log2cap + log2n2 : log2n2;" in text
    assert ("out[((r >> log2cap) + (k << log2n1)) * out_stride + (r & capmask)] = z[c];"
            in text)
    assert "if (r < rows && (r & capmask) < valid)" in text
    assert "row < rows && (!T || (row & capmask) < valid)" in text
    assert text.count("zp[(n - k) & (n - 1)]") == 2
    assert ("out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)]"
            in text)
    assert "columns_for<false, kPacked>(log2n1, in, scratch, pairs, log2n2, 0, rows, s)" in text
    assert "const bool has_b = 2 * s + 1 < real_rows;" in text
    for name, file in SOURCES.items():
        body = source(file)
        assert '#include "fourstep.cuh"' in body
        assert f'extern "C" int repro_{name}(' in body
        assert "Replaces the TPU kernel" in body and "Bound on this card: bytes" in body
    assert "while ((1LL << log2cap) < rows) ++log2cap;" in source(SOURCES[
        "fft_rows_transpose_large"])
    assert "real_rows_large<false>" in source(SOURCES["rfft_rows_large"])
    assert "real_rows_large<true>" in source(SOURCES["rfft_rows_transpose_large"])


@pytest.mark.parametrize("rows", [1, 2, 3, 4095, 4096, 4097, 16385])
def test_scratch_capacity_and_chunks(rows):
    """K2b's capacity a chunk is the least power of two >= its rows, never
    above the chunk (a power of two) nor its 1 GiB; a call of 16385 rows at
    32768 (phase 2 of the fused real plan) is 4 chunks of 4096 and one of 1
    row (capacity 1): 10 launches."""
    n = 1 << 15
    chunk = port_large.scratch_rows(n)
    cap = port_large.scratch_capacity(min(rows, chunk))
    assert cap >= min(rows, chunk) and cap & (cap - 1) == 0 and cap <= chunk
    assert cap < 2 * min(rows, chunk)
    sizes = [min(rows, r0 + chunk) - r0 for r0 in range(0, rows, chunk)]
    if rows == 16385:
        assert sizes == [4096] * 4 + [1] and port_large.scratch_capacity(sizes[-1]) == 1


def test_launchers_and_bindings():
    """The C entry points are bound with their argument lists (pointers,
    64-bit rows and output stride, the stream last); the launchers refuse a
    CPU tensor; the ops take every power of two up to ``MAX_LARGE_N`` and
    send a CUDA tensor above ``MAX_KERNEL_N`` to these launchers (their
    register-kernel launchers dispatch there)."""
    ptr, ll, int_ = _build._PTR, _build._LL, _build._INT
    assert _build._FUNCTIONS["repro_fft_rows_transpose_large"][1] == [
        ptr, ptr, ptr, ll, int_, int_, int_, ll, int_, int_, ptr]
    for name in ("repro_rfft_rows_large", "repro_rfft_rows_transpose_large"):
        assert _build._FUNCTIONS[name][1] == [ptr, ptr, ptr, ptr, ll, int_, int_, ll,
                                              int_, int_, ptr]
    xc = torch.ones((1, 1 << 15), dtype=torch.complex64)
    xr = torch.ones((2, 1 << 15))
    for launcher, x in ((port_fused_large.fft_rows_transpose_large_cuda, xc),
                        (port_real_large.rfft_rows_large_cuda, xr),
                        (port_fused_real_large.rfft_rows_transpose_large_cuda, xr)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launcher(x)
    for module, launcher in ((port_fused_kernel, "fft_rows_transpose_large_cuda"),
                             (port_kernels._real_kernel, "rfft_rows_large_cuda"),
                             (port_kernels._fused_real_kernel,
                              "rfft_rows_transpose_large_cuda")):
        text = open(module.__file__).read()
        assert re.search(rf"if n > MAX_KERNEL_N:\n\s+return {launcher}\(x", text)


def test_cpu_ops_launch_nothing():
    port_kernels.reset_launch_counts()
    x = to_torch(complex_signal(1, 2, 1 << 15))
    xr = to_torch(real_signal(1, 3, 1 << 15))
    fft_rows_transpose_op(x)
    rfft_rows_op(xr)
    rfft_rows_transpose_op(xr)
    counts = port_kernels.launch_counts()
    assert {"fft_rows_transpose_large", "rfft_rows_large",
            "rfft_rows_transpose_large"} <= set(counts)
    assert set(counts.values()) == {0}
    assert _build._library is None


# ---------------------------------------------------- the paths through them

@pytest.mark.parametrize("fn", ["fft_rows_then_transpose", "rfft_rows",
                                "rfft_rows_then_transpose"])
def test_fft2d_paths_at_32768_match_reference(fn):
    """``fft2d.fft_rows_then_transpose`` (default backend: the fused op),
    ``rfft_rows(backend="cuda")`` and ``rfft_rows_then_transpose`` at n =
    32768, through K2b, K3b and K4b's plain versions here, against the
    reference's ``repro.fft.fft2d`` functions (its Pallas kernels)."""
    n = 1 << 15
    if fn == "fft_rows_then_transpose":
        x = complex_signal(7, 3, n)
        got = port_fft2d.fft_rows_then_transpose(to_torch(x))
        want = ref_fft2d.fft_rows_then_transpose(jnp.asarray(x))
    else:
        x = real_signal(7, 3, n)
        kw = {"backend": "cuda"} if fn == "rfft_rows" else {}
        got = getattr(port_fft2d, fn)(to_torch(x), **kw)
        want = getattr(ref_fft2d, fn)(jnp.asarray(x),
                                      **({"backend": "pallas"} if kw else {}))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=tol(n))
