"""K2b, K3b and K4b, the four-step fused and real row kernels of rows longer
than K2-K4 hold (``csrc/fft_rows_transpose_large.cu``,
``csrc/rfft_rows_large.cu``, ``csrc/rfft_rows_transpose_large.cu`` on
``csrc/fourstep.cuh``), on the CPU: their plain versions against the
reference's ops (Pallas in interpret mode) and ``numpy.fft``, at forced
splits, float64 models of K2b's one-pass cluster kernel at n = 32768
(``csrc/fft_rows_transpose_cluster.cu`` on ``csrc/fourstep_cluster.cuh``), of
its two passes' ``[k1][s][j2]`` scratch and transposed store and of K3b's and
K4b's pass B with the slot split in both stores, their launch plans and
bindings against the CUDA sources, the launcher's choice of kernel, and the
``fft2d`` paths through them.

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

from _torch_parity import (complex_signal, k2_store_model, k2b_cluster_model, k2b_model,
                           kernel_pass_model, pass_a_model, pass_b_plan, real_pass_b_model,
                           to_numpy, to_torch)

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
CLUSTER_SOURCE = "fft_rows_transpose_cluster.cu"
CLUSTER_HEADER = "fourstep_cluster.cuh"
CLUSTER_LENGTHS = port_fused_large.TRANSPOSE_CLUSTER_LENGTHS


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

def check_pass_a(pass_a, rows, cap, n1, n2):
    """K2b's pass A pattern: each input element read once, each scratch
    element of the chunk's rows written once and none of the capacity's
    spare rows; every warp instruction on whole 32-byte sectors where a CTA
    holds at least 4 columns, 256 contiguous bytes where it holds 32; the
    column exchanges free of bank conflicts."""
    cols = pass_a["plan"][0]
    assert (pass_a["reads"] == 1).all()
    per_row = pass_a["writes"].reshape(n1, cap, n2)
    assert (per_row[:, :rows] == 1).all() and (per_row[:, rows:] == 0).all()
    assert pass_a["loads_whole"] == pass_a["stores_whole"] == (cols >= 4)
    assert pass_a["loads_256"] == pass_a["stores_256"] == (cols >= 32)
    assert pass_a["worst_bank"] == 1


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, rows, n1, stride, r0", [
    (1 << 15, 3, None, 3, 0), (1 << 15, 1, 256, 4, 2), (1 << 15, 5, None, 16385, 4096),
    (1 << 16, 2, None, 2, 0), (1 << 17, 1, None, 3, 1), (1 << 18, 3, 2048, 5, 1)])
def test_k2b_model_is_the_transposed_dft_and_writes_each_element_once(
        n, rows, n1, stride, r0, inverse):
    """The model of K2b's two passes in their launch shapes, one chunk of
    ``rows`` rows stored to columns ``r0 ...`` of an (n, ``stride``) output:
    ``FFT_rows(x).T`` (``numpy.fft``, float64, ``1e-9·n``, over n for the
    inverse); pass A (``check_pass_a``: columns fastest, 256-byte warp
    instructions at n1 <= 512, the padded exchange at n1 = 2048); pass B
    writes each element of the chunk's columns once and no other; each
    warp's stores to one output row are one contiguous run, of
    8·min(W, 32) bytes where the chunk holds at least the W = P·C rows a
    store puts side by side (cap a multiple of W, so a run never crosses a
    k1)."""
    x = complex_signal(n + rows + inverse, rows, n)
    n1, n2 = port_large.kernel_split(n, port_large.two_pass_split(n)[0] if n1 is None else n1,
                                     "k2b")
    out, pass_a, writes_b, (nbytes, contiguous, full), plan_b, cluster = k2b_model(
        x, n1, n2, out_stride=stride, r0=r0, inverse=inverse)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128)).T
    np.testing.assert_allclose(out[:, r0:r0 + rows], exact, rtol=0,
                               atol=1e-9 * (1 if inverse else n))
    cap = pass_a["cap"]
    check_pass_a(pass_a, rows, cap, n1, n2)
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
    GiB or one row; pass B's CTAs hold all the rows they can and store W =
    16 of them side by side (a cluster where a CTA holds fewer), its buffer
    free of bank conflicts; where
    a chunk holds at least W rows (n <= 2^23) a store never crosses a k1 and
    its runs, simulated on four clusters, are all 8·min(W, 32) >= 128 bytes;
    above, a chunk of 8 ... 1 rows gives runs of its rows.  Pass A's pattern
    on one row up to 2^20 (the model's arrays are n*cap long), on its first,
    middle and last tiles above."""
    n = 1 << e
    chunk = port_large.scratch_rows(n)
    assert chunk & (chunk - 1) == 0 and port_large.scratch_capacity(chunk) == chunk
    assert chunk * n * 8 <= max(1 << 30, n * 8)
    n1, n2 = port_large.two_pass_split(n)
    plan_b, cluster = pass_b_plan(n2, chunk * n1)
    wide = plan_b[0] * cluster
    assert wide == 16 and plan_b[0] == port_large.rows_plan(n2, 1 << 30)[0]
    assert (chunk >= wide) == (e <= 23)
    if chunk >= wide:
        assert chunk % wide == 0
        _, writes, worst, (nbytes, contiguous, full) = k2_store_model(
            None, 4 * wide, plan_b, cluster=cluster)
        assert (writes[:, :4 * wide] == 1).all() and contiguous.all() and full.all()
        assert worst == 1
        assert nbytes.min() == 8 * min(wide, 32) >= 128
    if e <= 20:
        pass_a = pass_a_model(None, n1, n2, rows=1, transposed=True)
        check_pass_a(pass_a, 1, 1, n1, n2)
    else:
        groups = n2 // port_large.columns_plan(n1)[0]
        pass_a = pass_a_model(None, n1, n2, rows=chunk, transposed=True,
                              tiles=[0, groups // 2, chunk * groups - 1])
        cols = pass_a["plan"][0]
        assert pass_a["loads_whole"] == pass_a["stores_whole"] == (cols >= 4)
        assert pass_a["loads_256"] == pass_a["stores_256"] == (cols >= 32)
        assert pass_a["worst_bank"] == 1


# ------------------------------------ K2b's one-pass cluster kernel (32768)

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [3, 4, 9])
@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_k2b_cluster_model_is_the_transposed_dft(n, rows, inverse):
    """The model of K2b's cluster kernel in its launch shape
    (``transpose_cluster_plan(n)``, 4 rows a cluster of 16 CTAs) at 3 rows (one
    cluster, its last row masked), 4 (one whole cluster) and 9 (two whole
    clusters and one of a single row) is ``FFT_rows(x).T``: ``numpy.fft`` in
    float64 to ``1e-9·n``, the inverse to ``1e-9``; every input element
    loaded once, every slab slot written once (by the rank and row that the
    point's k1 gives) and loaded once, every output element stored once."""
    x = complex_signal(n + 5 * rows + inverse, rows, n)
    model = k2b_cluster_model(x, n, inverse=inverse)
    exact = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128)).T
    np.testing.assert_allclose(model["out"], exact, rtol=0,
                               atol=1e-9 * (1 if inverse else n))
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"]


@pytest.mark.parametrize("rows, stride", [(8, 8), (9, 12), (5, 5)])
@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_k2b_cluster_pattern(n, rows, stride):
    """The pattern alone (the direction changes no index), ``rows`` rows
    stored to an (n, ``stride``) output: each element loaded, sent, read back
    and stored once, each point to its owner, no store outside the call's
    columns; each warp's loads 32 consecutive elements from a 256-byte
    boundary; no bank conflict in the column exchanges, the remote stores,
    the row phase's loads or the staging, and the row DFT's own exchanges
    (regfft's, over W rows of n2) conflict-free too; where the stride is a
    multiple of 4, every output store instruction of a whole cluster writes
    whole 32-byte sectors, 4 rows a run; at an odd stride (as phase 2 of the
    fused real plan's 16385 rows at 32768) they are off sectors."""
    model = k2b_cluster_model(None, n, rows=rows, out_stride=stride)
    for key in ("reads", "slab_writes", "slab_reads"):
        assert (model[key] == 1).all(), key
    writes = model["writes"].reshape(n, stride)
    assert (writes[:, :rows] == 1).all() and (writes[:, rows:] == 0).all()
    assert model["owner_ok"] and model["loads_256"] and model["worst_bank"] == 1
    n1, n2, ctas, per, threads, smem = port_fused_large.transpose_cluster_plan(n)
    assert model["stores_whole"] == (stride % 4 == 0)
    if stride % per == 0:
        assert set(model["store_runs"].tolist()) == {8 * per}
    w = n1 // ctas
    plan = (w, threads // per, 16, port_kernel.complex_rows_plan(n2, 1)[3], smem // per)
    _, worst = kernel_pass_model(torch.zeros((w, n2), dtype=torch.complex64), plan)
    assert worst == 1


def test_transpose_cluster_plan_mirrors_the_cuda_source():
    """``transpose_cluster_plan`` is the source's shape: the lengths its
    entry dispatches, its ``kLog2Ctas`` and ``kLog2Rows``, the split with
    n2 = 32 columns a rank, ``ClusterPlan``'s rows*n/(16C) threads and
    rows*(n/C)*17/16 float2 of shared memory, as many CTAs an SM as its
    ``MIN_BLOCKS`` asks for fitting in shared memory, what the header's
    static_asserts require; the transposed store as the model runs it, and
    no scratch."""
    text = "".join(source(name) for name in (CLUSTER_SOURCE, CLUSTER_HEADER))
    body = source(CLUSTER_SOURCE)
    assert f'#include "{CLUSTER_HEADER}"' in body and "scratch" not in body
    ctas = port_fused_large.TRANSPOSE_CLUSTER_CTAS
    per = port_fused_large.TRANSPOSE_CLUSTER_ROWS
    assert f"constexpr int kLog2Ctas = {ctas.bit_length() - 1};" in body
    assert f"constexpr int kLog2Rows = {per.bit_length() - 1};" in body
    assert "constexpr int kLog2N2 = kLog2Ctas + 5;" in body
    assert ("launch_cluster<LOG2N - kLog2N2, kLog2N2, kLog2Ctas, INV, kLog2Rows, true>"
            in body)
    entry = body[body.index('extern "C" int repro_fft_rows_transpose_cluster('):]
    assert [1 << int(e) for e in re.findall(r"case 1 << (\d+):", entry)] == list(
        CLUSTER_LENGTHS)
    assert "if (out_stride < rows) return (int)cudaErrorInvalidValue;" in entry
    for n in CLUSTER_LENGTHS:
        n1, n2, got_ctas, got_per, threads, smem = port_fused_large.transpose_cluster_plan(n)
        log2n = n.bit_length() - 1
        assert (n1, n2) == (1 << (log2n - ctas.bit_length() - 4), 32 * ctas)
        assert (got_ctas, got_per) == (ctas, per)
        cols, w = n2 // ctas, n1 // ctas
        assert threads == per * cols * (n1 // 16) == per * w * (n2 // 16) <= 1024
        assert cols == 32 and w * per >= 4 and n2 >= 256 and 2 <= ctas <= 16
        assert smem == 8 * per * (w * n2 + -(-w * n2 // 16)) <= port_kernel.SMEM_BUDGET
        blocks = 65536 // (threads * 64)
        assert blocks >= 1 and blocks * (smem + 1024) <= 233472
    for expr in ("ROW_ELEMS = repro::regfft::exchange_elems(W, N2);",
                 "ELEMS = ROW_ELEMS * R;", "THREADS = ROW_THREADS * R;",
                 "float2* buf = smem + g * CP::ROW_ELEMS;",
                 "const bool live = CP::R == 1 || s < rows;",
                 "const long long s0 = ((long long)blockIdx.x >> LOG2C) << LOG2R;",
                 "const Swizzle<LOG2N2> slot(LOG2P);",
                 "smem[slot(((((t2 + k * G2) << CP::LOG2W) + rho) << LOG2R) + g)] = v[k];",
                 "const int gq = q & (CP::R - 1);",
                 "const long long bin = rank * W + (q >> LOG2R) + (long long)N1 * k2;",
                 "if (s0 + gq < rows) o[bin * out_stride + s0 + gq] = smem[slot(idx)];",
                 "((rows + CP::R - 1) >> LOG2R) << LOG2C",
                 "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);",
                 "static_assert(C >= 2 && C <= 16"):
        assert expr in text, expr
    assert "Replaces the TPU kernel `fft_rows_transpose_pallas`" in body
    assert "Bound on this card: bytes" in body


def test_transpose_cluster_binding_and_refusals():
    """K2b's one-pass entry is bound with its seven arguments (two
    pointers, a 64-bit row count, n, the direction, the 64-bit output
    stride, the stream last): no launch shape and no scratch; it is K2b's
    only cluster entry; the plan refuses every other length."""
    ptr, ll, int_ = _build._PTR, _build._LL, _build._INT
    restype, argtypes = _build._FUNCTIONS["repro_fft_rows_transpose_cluster"]
    assert restype is int_ and argtypes == [ptr, ptr, ll, int_, int_, ll, ptr]
    assert [name for name in _build._FUNCTIONS if "transpose" in name and "cluster" in name
            ] == ["repro_fft_rows_transpose_cluster"]
    body = source(CLUSTER_SOURCE)
    assert ('extern "C" int repro_fft_rows_transpose_cluster(const void* in, void* out, '
            'long long rows,') in body
    assert body.count('extern "C"') == 1
    for n in (1 << 13, 1 << 17, 3 << 14):
        with pytest.raises(ValueError, match="no cluster kernel"):
            port_fused_large.transpose_cluster_plan(n)


@pytest.mark.parametrize("inverse", [False, True])
def test_k2b_launcher_takes_one_cluster_launch_up_to_65536(monkeypatch, inverse):
    """What ``fft_rows_transpose_large_cuda`` launches, with the launch
    recorded in place of the library: at 32768 and 65536 one launch of the
    cluster entry a call, over all the rows at once with their own stride,
    counted once, with no scratch; above, the two passes a chunk (two counts
    each, also under ``fft_rows_transpose_large_two_pass``) with scratch."""
    calls = []
    monkeypatch.setattr(port_fused_large, "check_kernel_input",
                        lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_fused_large, "launch",
                        lambda fn, x, out, **args: calls.append((fn, x.shape, out.shape, args)))
    for n, rows in ((1 << 15, 2049), (1 << 15, 16385), (1 << 15, 4), (1 << 16, 1023)):
        port_kernels.reset_launch_counts()
        calls.clear()
        out = port_fused_large.fft_rows_transpose_large_cuda(
            torch.zeros((rows, n), dtype=torch.complex64), inverse=inverse)
        assert out.shape == (n, rows)
        assert calls == [("repro_fft_rows_transpose_cluster", (rows, n), (n, rows),
                          {"rows": rows, "n": n, "inverse": int(inverse),
                           "out_stride": rows})]
        counts = port_kernels.launch_counts()
        assert counts["fft_rows_transpose_large"] == 1
        assert counts["fft_rows_transpose_large_two_pass"] == 0
    for n, rows in ((1 << 17, 3), (1 << 18, 1)):
        port_kernels.reset_launch_counts()
        calls.clear()
        port_fused_large.fft_rows_transpose_large_cuda(
            torch.zeros((rows, n), dtype=torch.complex64), inverse=inverse)
        assert [c[0] for c in calls] == ["repro_fft_rows_transpose_large"]
        assert "scratch" in calls[0][3] and calls[0][3]["out_stride"] == rows
        counts = port_kernels.launch_counts()
        assert counts["fft_rows_transpose_large"] == 2
        assert counts["fft_rows_transpose_large_two_pass"] == 2
    port_kernels.reset_launch_counts()
    assert port_fused_large.two_pass_launch_count() == 0


def real_plans(n, rows, transposed):
    """K3b's or K4b's pass-B shape for one chunk of ``rows`` real rows: the
    split, ``split_rows_plan`` over the units' rows and its cluster."""
    n1, n2 = port_large.large_split(n)
    pairs = (rows + 1) // 2
    units = port_large.scratch_capacity(pairs) if transposed else pairs
    plan = port_real_large.split_rows_plan(n2, units * n1)
    return n1, n2, plan[:2], plan[2]


def check_pass_b(m, n1, n2, rows, transposed, stride, c0):
    """What every run of ``real_pass_b_model`` must show: each scratch row
    of a live unit loaded once; every store inside the output and its column
    slice, each element once, exactly the clusters' own; every partner bin
    (n - k) mod n of its pair in the cluster; rows 0 and n1/2 split against
    themselves (n2 + 1 items a pair where every cluster is simulated); each
    warp store's runs W/2 elements of one output row (K3b) or W/2 pairs side
    by side (K4b, where W/2 units share a row and the output takes 16-byte
    stores)."""
    wide, units, cap = m["shape"]
    n = n1 * n2
    nh = n // 2 + 1
    pairs = (rows + 1) // 2
    addr = m["addr"]
    assert np.unique(addr).size == addr.size
    assert np.array_equal(np.sort(addr), np.sort(m["expected"]))
    if transposed:
        assert ((addr % stride >= c0) & (addr % stride < c0 + rows)).all()
        assert addr.max() < nh * stride
    else:
        assert addr.max() < rows * stride and (addr % stride < nh).all()
    assert m["partner_ok"]
    assert set(np.unique(m["reads"])) <= {0, 1}
    _, _, _, lengths = m["runs"]
    assert lengths.min() >= 8
    if not transposed:
        # W/2 neighbouring k1 a run; slot 0's right run is n1/2 alone and
        # n1 - W/2 + 1 ... n1 - 1, which runs on into the left run 0 ...
        # W/2 - 1 of the next bin where one warp stores both.
        assert set(np.unique(lengths)) <= {4 * wide, 4 * wide - 8, 8, 8 * wide - 8}
    elif cap >= wide // 2 and stride % 2 == 0 and c0 % 2 == 0:
        # The last cluster of a slot holds rows // 2 mod W/2 whole pairs; an
        # unpaired last row stores its A alone.
        allowed = {8 * wide, 16 * (rows // 2 % (wide // 2))} | ({8} if rows % 2 else set())
        assert set(np.unique(lengths)) <= allowed - {0}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("rows, n", [(1, 1 << 15), (3, 1 << 15), (4, 1 << 15),
                                     (33, 1 << 15), (2, 1 << 16), (5, 1 << 17)])
def test_split_model_is_the_half_spectrum_and_writes_each_element_once(
        rows, n, transposed):
    """The split, now pass B's epilogue: pass B of K3b (row-major) and K4b
    (transposed, to columns 2 ... of a wider output) with the slot split
    (``real_pass_b_model``), thread by thread in its launch shape
    over K3b's ``[p][k1][j2]`` or K4b's ``[k1][p][j2]`` scratch:
    ``numpy.fft.rfft`` of the real rows (float64, ``1e-9·n``); each output
    element written once and nothing around the column slice; every scratch
    row of a live unit loaded once and no spare one; every bin read beside
    its partner (n - k) mod n in its cluster; rows 0 and n1/2 against
    themselves, n2 + 1 items a pair; an unpaired last row's B not stored;
    each warp's store in whole runs (``check_pass_b``)."""
    x = np.random.default_rng(rows + n).standard_normal((rows, n))
    n1, n2, plan, cluster = real_plans(n, rows, transposed)
    c0, stride = (2, rows + 5) if transposed else (0, n // 2 + 1)
    m = real_pass_b_model(x, n1, n2, plan, cluster, transposed=transposed,
                          out_stride=stride, c0=c0)
    check_pass_b(m, n1, n2, rows, transposed, stride, c0)
    pairs = (rows + 1) // 2
    exact = np.fft.rfft(x, axis=-1)
    out = m["out"]
    if transposed:
        np.testing.assert_allclose(out[:, c0:c0 + rows], exact.T, rtol=0, atol=1e-9 * n)
        assert not out[:, :c0].any() and not out[:, c0 + rows:].any()
    else:
        np.testing.assert_allclose(out, exact, rtol=0, atol=1e-9 * n)
    written = np.zeros(out.size, np.int64)
    np.add.at(written, m["addr"], 1)
    assert written.sum() == exact.size
    assert m["self_items"] == pairs * (n2 + 1)
    reads = m["reads"].reshape(n1, -1)[:, :pairs] if transposed else m["reads"]
    assert (reads == 1).all() and m["reads"].sum() == pairs * n1


@pytest.mark.parametrize("e", range(15, 29))
def test_real_pass_b_pattern_at_every_length(e):
    """K3b's and K4b's pass B at every length they take, on 3 rows (an
    unpaired last one) and on a whole chunk of pairs: ``split_rows_plan``
    gives at least one slot (2 rows) a cluster, whole clusters of units and,
    on a full grid, ``SplitPlan``'s rows a CTA; the one-row CTAs of n2 >=
    4096 pair in clusters of 4.  The model runs on
    the first two, a middle and the last two clusters of the 3-row call (all
    of them to 2^20): each of their elements written once, exactly their
    own, partners in the cluster, runs whole (``check_pass_b``)."""
    n = 1 << e
    for transposed in (False, True):
        n1, n2, plan, cluster = real_plans(n, 3, transposed)
        wide = plan[0] * cluster
        assert wide >= 2 and cluster == (4 if n2 >= 4096 else 2 if n2 == 2048 else 1)
        chunk = port_large.scratch_rows(n)
        cn1, cn2, cplan, ccluster = real_plans(n, 2 * chunk, transposed)
        cunits = (cn1 // 2) * (port_large.scratch_capacity(chunk) if transposed else chunk)
        assert cunits % (cplan[0] * ccluster // 2) == 0
        if cunits * 2 >= 264 * 32:
            # A full grid: SplitPlan's rows, twice regfft's up to 32 where a
            # CTA holds 4 or more (a warp's store spans 16 k1 or pairs).
            regfft_rows = max(1, 256 * 16 // cn2)
            assert cplan[0] == (min(32, 2 * regfft_rows) if regfft_rows >= 4
                                else regfft_rows)
        units = n1          # n1/2 slots of 2 pairs (K3b) or of a cap of 2 (K4b)
        total = units // (wide // 2)
        picks = None if e <= 20 else sorted({0, 1, total // 2, total - 2, total - 1})
        stride = 3 if transposed else n // 2 + 1
        m = real_pass_b_model(None, n1, n2, plan, cluster, transposed=transposed, rows=3,
                              out_stride=stride, clusters=picks)
        check_pass_b(m, n1, n2, 3, transposed, stride, 0)
        if picks is None:
            assert m["addr"].size == 3 * (n // 2 + 1)
            assert m["self_items"] == 2 * (n2 + 1)


@pytest.mark.parametrize("transposed", [False, True])
def test_real_pass_b_store_sectors_on_the_main_path(transposed):
    """The 32768 chunks of the real plans (n1 = 128, n2 = 256, 32 rows a CTA:
    ``split_rows_plan`` of a full chunk), 64 rows: K4b's warps write 2 runs of
    256 bytes, whole sectors (an even row stride); K3b's write 2 or 3 runs of
    up to 128 bytes on rows n/2 + 1 float2 apart, so rows 2p and 2p + 1 start
    one float2 apart within a sector: 313344 sectors for 8 MiB, 0.837 of
    them full (at 16 rows a CTA, 64-byte runs: 359424, 0.729)."""
    n1, n2 = 128, 256
    plan = port_real_large.split_rows_plan(n2, port_large.scratch_rows(n1 * n2) * n1)
    assert plan == (32, 512, 1)
    for per_cta, want in ((32, 313344), (16, 359424)):
        m = real_pass_b_model(None, n1, n2, (per_cta, per_cta * 16), 1,
                              transposed=transposed, rows=64,
                              out_stride=64 if transposed else None)
        nbytes, sectors, count, lengths = m["runs"]
        assert nbytes.sum() == 64 * (n1 * n2 // 2) * 8
        if transposed:
            assert sectors.sum() * 32 == nbytes.sum() and set(count) == {32 // per_cta * 2}
            assert set(lengths) == {8 * per_cta}
        else:
            assert sectors.sum() == want
            assert set(lengths) <= {8 * per_cta // 2, 8 * per_cta // 2 - 8, 8,
                                    8 * per_cta - 8}


# -------------------------------------------------- plans against the sources

def test_pass_c_and_the_store_orders_mirror_the_cuda_source():
    """Pass C is gone, and the index arithmetic the models above follow is
    the shared header's: K2b's pass-A store at (k1*cap + s)*n2 + j2 and
    pass-B store at (k1 + n1*k2)*out_stride + s; the real kernels' pass B
    with the slot split:
    units p*(n1/2) + sigma (K3b) or sigma*cap + p (K4b), the right row n1 -
    sigma (n1/2 in slot 0), the partner row q ^ W/2 at bin n2 - 1 - k2 (row
    0: (n2 - k2) mod n2), the stores to rows 2p, 2p + 1 or columns 2p, 2p +
    1, bin n/2 from row 0; two launches, no pass C and no second scratch
    buffer; K1b's orders unchanged."""
    text = source("fourstep.cuh")
    assert "? scratch + (s << log2n2) + ((long long)t << log2k) + j2" in text
    assert "const int log2k = TS ? log2cap + log2n2 : log2n2;" in text
    assert "return mode == kTransposedStore || mode == kPackedTransposed;" in text
    assert ("out[((r >> log2cap) + (k << log2n1)) * out_stride + (r & capmask)] = z[c];"
            in text)
    assert "if (r < rows && (r & capmask) < valid)" in text
    assert "row < rows && (!T || (row & capmask) < valid)" in text
    assert ("out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)]"
            in text)
    assert ("P::MAX_ROWS >= 4 ? (2 * P::MAX_ROWS < 32 ? 2 * P::MAX_ROWS : 32) : P::MAX_ROWS;"
            in text)
    assert "rows_per_cta > SplitPlan<LOG2N2>::MAX_ROWS" in text
    for expr in ("r.sigma = (int)(u >> log2cap);", "r.p = u & ((1LL << log2cap) - 1);",
                 "r.sigma = (int)(u & ((1LL << (log2n1 - 1)) - 1));",
                 "r.p = u >> (log2n1 - 1);",
                 "r.k1 = !right ? r.sigma : r.sigma == 0 ? 1 << (log2n1 - 1) : "
                 "(1 << log2n1) - r.sigma;",
                 "const int pq = s.sigma == 0 ? qq : qq ^ half;",
                 "const int pk = s.sigma == 0 && !right ? (N - k2) & (N - 1) : N - 1 - k2;",
                 "const int k2 = rank * HB + (idx >> log2w);",
                 "const int qq = idx & qmask;",
                 "constexpr int HB = N / 2 / C;",
                 "const long long u0 = ((long long)blockIdx.x >> LOG2C) << (log2w - 1);",
                 "const int q = (rank << log2_rows) + local;",
                 "? ((long long)mine.k1 << log2cap) + mine.p",
                 ": (mine.p << log2n1) + mine.k1;",
                 "float2* o = out + k * out_stride + 2 * p;",
                 "out[2 * p * out_stride + k] = a;",
                 "if (has_b) out[(2 * p + 1) * out_stride + k] = b;",
                 "const bool has_b = 2 * p + 1 < rows;",
                 "const float2 z = z_at(threadIdx.x, N / 2);",
                 "const bool vec = T && (out_stride & 1) == 0 &&",
                 "rows_per_cta * C < 2 || units % (rows_per_cta * C / 2) != 0",
                 "const long long units = T ? 1LL << (log2n1 - 1 + log2cap) : "
                 "pairs << (log2n1 - 1);",
                 "columns_for<false, kPacked>(log2n1, in, scratch, pairs, log2n2, 0, rows, s)",
                 "columns_for<false, kPackedTransposed>(log2n1, in, scratch, pairs, log2n2, "
                 "log2cap,",
                 "const bool has_b = 2 * s + 1 < real_rows;"):
        assert expr in text, expr
    assert not re.search(r"\bsplit_kernel\b|\blaunch_split\b|zbuf|kSplitThreads", text)
    for name, file in SOURCES.items():
        body = source(file)
        assert '#include "fourstep.cuh"' in body
        assert f'extern "C" int repro_{name}(' in body
        assert "Replaces the TPU kernel" in body and "Bound on this card: bytes" in body
        assert "zbuf" not in body
    assert "while ((1LL << log2cap) < rows) ++log2cap;" in source(SOURCES[
        "fft_rows_transpose_large"])
    assert "real_rows_large<false>" in source(SOURCES["rfft_rows_large"])
    assert "real_rows_large<true>" in source(SOURCES["rfft_rows_transpose_large"])
    for module in (port_real_large, port_fused_real_large):
        text = open(module.__file__).read()
        assert "zbuf" not in text and "launches += 3" not in text
    assert "launches += 2" in open(port_real_large.__file__).read()


@pytest.mark.parametrize("rows", [1, 2, 3, 4095, 4096, 4097, 16385])
def test_scratch_capacity_and_chunks(rows):
    """The two passes' capacity a chunk is the least power of two >= its
    rows, never above the chunk (a power of two) nor its 1 GiB; at 32768 a
    call of 16385 rows (phase 2 of the fused real plan) would be 4 chunks of
    4096 and one of 1 row (capacity 1), 10 launches of the two passes, where
    the cluster kernel takes one."""
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
        assert _build._FUNCTIONS[name][1] == [ptr, ptr, ptr, ll, int_, int_, ll, int_,
                                              int_, ptr]
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
