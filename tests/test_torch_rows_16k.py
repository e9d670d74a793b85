"""K2, K3 and K4 at n = 16384, their longest row, on the CPU: K2's one-pass
cluster kernel (K2b's ``csrc/fft_rows_transpose_cluster.cu`` at 16384, the
cluster kernel of ``csrc/fourstep_cluster.cuh`` with the transposed store;
its model at 3, 4 and 9 rows and at small strides runs with K2b's in
``tests/test_torch_fused_large.py``), K3's persistent
kernel ``csrc/rfft_rows_16k.cu`` (one CTA an SM over the pairs, the next
pair staged by bulk copies), the design of K3 that lost
(``packed_cluster_kernel`` of ``csrc/rfft_rows_cluster.cuh``: the packed
pair through the same four-step, the conjugate split in its epilogue on
mirror slots; built only as a variant) and K4's cluster kernel
(``csrc/rfft_rows_transpose_16k.cu``: the same pair and phases,
``packed_transpose_kernel``, the split stored transposed with the cluster's
pairs side by side).  Float64 models of all four in their launch shapes
(``_torch_parity.k2b_cluster_model``, ``k3_16k_model``, ``k3_cluster_model``,
``k4_16k_model``) against ``numpy.fft`` and the reference's ops (Pallas,
interpret mode), their index patterns at even, odd and ragged row counts,
their plans and bindings against the sources, and the launchers' choice of
kernel with the launch recorded.

The kernels run only on the card (``chip_smoke.py``,
``examples/kernel_check_torch.py --fft-rows-transpose-only``,
``--rfft-rows-only`` and ``--rfft-rows-transpose-only``).  Run these alone with ``PYTHONPATH=src
JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_rows_16k.py``.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (complex_signal, k2b_cluster_model, k3_16k_model,
                           k3_cluster_model, k4_16k_model, kernel_pass_model, to_numpy,
                           to_torch)

from repro.kernels.fft.real import rfft_rows_op as ref_rfft_rows_op
from repro.kernels.fused.ops import fft_rows_transpose_op as ref_fused_op
from repro.kernels.fused.real import rfft_rows_transpose_op as ref_rfused_op

from repro_torch import kernels as port_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fft import real as port_real
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused import large as port_fused_large
from repro_torch.kernels.fused import real as port_fused_real

N = 1 << 14
K2_SOURCE = "fft_rows_transpose_cluster.cu"
K3_SOURCE = "rfft_rows_16k.cu"
K3_CLUSTER_HEADER = "rfft_rows_cluster.cuh"
K4_SOURCE = "rfft_rows_transpose_16k.cu"
HEADER = "fourstep_cluster.cuh"
# What an SM holds (``tests/test_torch_regfft.py``): 228 KiB of shared
# memory, 1 KiB of it reserved a CTA; 65536 registers.
SM_SMEM, CTA_RESERVED_SMEM = 233472, 1024


def source(name):
    return (_build.csrc_dir() / name).read_text()


def real_signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def row_dft_conflicts(w, n2, threads_a_row, smem_a_row):
    """The worst bank count of regfft's length-n2 DFT over the W rows of B a
    rank runs, in the plan the cluster kernels give it."""
    plan = (w, threads_a_row, 16, port_kernel.complex_rows_plan(n2, 1)[3], smem_a_row)
    return kernel_pass_model(torch.zeros((w, n2), dtype=torch.complex64), plan)[1]


# ---------------------------------------------------------- K2 at 16384

@pytest.mark.parametrize("inverse", [False, True])
def test_k2_16k_model_matches_reference_fft_rows_transpose_op(inverse):
    """The model of K2's cluster kernel against the reference's fused op
    (Pallas, interpret mode) on 3 rows, ``1e-3·sqrt(n)``, over n for the
    inverse."""
    x = complex_signal(41 + inverse, 3, N)
    want = np.asarray(ref_fused_op(jnp.asarray(x), inverse=inverse))
    got = k2b_cluster_model(x, N, inverse=inverse)["out"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.sqrt(N) / (N if inverse else 1))


@pytest.mark.parametrize("rows, stride", [(257, 260), (263, 263)])
def test_k2_16k_pattern(rows, stride):
    """The pattern alone (the direction changes no index), ``rows`` rows
    stored to an (n, ``stride``) output at the ragged counts that
    ``chip_smoke.py`` checks on the card (257, 263): each element loaded,
    sent, read back and stored once, each point to its owner, no store
    outside the call's columns; each warp's loads 32 consecutive elements
    from a 256-byte boundary; no bank conflict in the column exchanges, the
    remote stores, the row phase's loads, the staging or the row DFT's own
    exchanges; where the stride is a multiple of 4 every output store
    instruction of a whole cluster writes whole 32-byte sectors, 4 rows a
    run; at an odd stride (phase 2 of the fused real plan's 8193 rows) they
    are off sectors."""
    model = k2b_cluster_model(None, N, rows=rows, out_stride=stride)
    for key in ("reads", "slab_writes", "slab_reads"):
        assert (model[key] == 1).all(), key
    writes = model["writes"].reshape(N, stride)
    assert (writes[:, :rows] == 1).all() and (writes[:, rows:] == 0).all()
    assert model["owner_ok"] and model["loads_256"] and model["worst_bank"] == 1
    n1, n2, ctas, per, threads, smem = port_fused_large.transpose_cluster_plan(N)
    assert model["stores_whole"] == (stride % 4 == 0)
    if stride % per == 0:
        assert set(model["store_runs"].tolist()) == {8 * per}
    assert row_dft_conflicts(n1 // ctas, n2, threads // per, smem // per) == 1


def test_transpose_cluster_plan_at_16384_mirrors_the_cuda_source():
    """At 16384 ``transpose_cluster_plan`` is the shape the source's entry
    dispatches (``case 1 << 14``, the same ``kLog2Ctas``, ``kLog2Rows`` and
    n2 = 32 columns a rank as at 32768 and 65536): n1 = 32, 16 CTAs of 4
    rows, ``ClusterPlan``'s rows*n/(16C) = 256 threads and rows*(n/C)*17/16
    float2 = 34816 bytes; what the header's static_asserts require there (32
    columns a rank; W = 2 rows of B a rank, so runs of the R rows make a
    whole sector only with R*W >= 4); four CTAs an SM (64 registers), in a
    non-portable cluster of 16; no scratch.  The register-resident sources
    no longer instantiate 16384."""
    body = source(K2_SOURCE)
    n1, n2, ctas, per, threads, smem = port_fused_large.transpose_cluster_plan(N)
    assert (n1, n2, ctas, per, threads, smem) == (32, 512, 16, 4, 256, 34816)
    assert f'#include "{HEADER}"' in body and "scratch" not in body
    assert f"constexpr int kLog2Ctas = {ctas.bit_length() - 1};" in body
    assert f"constexpr int kLog2Rows = {per.bit_length() - 1};" in body
    assert "constexpr int kLog2N2 = kLog2Ctas + 5;" in body
    assert ("    case 1 << 14:\n        return inverse ? launch_length<14, true>("
            in body)
    cols, w = n2 // ctas, n1 // ctas
    assert threads == per * cols * (n1 // 16) == per * w * (n2 // 16)
    assert cols == 32 and w == 2 and w * per >= 4 and n2 // 16 >= 16
    assert smem == 8 * per * (w * n2 + -(-w * n2 // 16))
    blocks = 65536 // (threads * 64)
    assert blocks == 4 and blocks * (smem + CTA_RESERVED_SMEM) <= SM_SMEM
    header = source(HEADER)
    assert "static_assert(COLS >= 32 && W >= 4 / R," in header
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);" in header
    assert "Replaces the TPU kernel `fft_rows_transpose_pallas`" in body
    assert "Bound on this card: bytes" in body
    for name in ("fft_rows_transpose.cu", "rfft_rows.cu"):
        assert "case 1 << 13:" in source(name) and "case 1 << 14" not in source(name)


def test_k2_launcher_takes_the_cluster_kernel_at_16384(monkeypatch):
    """What ``fft_rows_transpose_cuda`` launches, with the launch recorded in
    place of the library: at 16384 one launch of
    ``repro_fft_rows_transpose_cluster`` a call (K2b's 7-argument binding;
    no entry of its own), over all the rows with their own stride, counted
    once under ``fft_rows_transpose`` and under ``fft_rows_transpose_16k``
    and not under K2b's ``fft_rows_transpose_large``; below it the
    register-resident kernel in ``fft_rows_transpose_plan``'s shape."""
    ptr, ll, int_ = _build._PTR, _build._LL, _build._INT
    assert _build._FUNCTIONS["repro_fft_rows_transpose_cluster"] == (
        int_, [ptr, ptr, ll, int_, int_, ll, ptr])
    assert not any("16k" in name and name.startswith("repro_fft_rows_transpose")
                   for name in _build._FUNCTIONS)
    body = source(K2_SOURCE)
    assert ('extern "C" int repro_fft_rows_transpose_cluster(const void* in, void* out, '
            'long long rows,') in body and body.count('extern "C"') == 1
    calls = []
    monkeypatch.setattr(port_fused_kernel, "check_kernel_input",
                        lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_fused_kernel, "launch",
                        lambda fn, x, out, **args: calls.append((fn, out.shape, args)))
    for inverse in (False, True):
        for rows in (8193, 4096, 3):
            port_kernels.reset_launch_counts()
            calls.clear()
            out = port_fused_kernel.fft_rows_transpose_cuda(
                torch.zeros((rows, N), dtype=torch.complex64), inverse=inverse)
            assert out.shape == (N, rows)
            assert calls == [("repro_fft_rows_transpose_cluster", (N, rows),
                              {"rows": rows, "n": N, "inverse": int(inverse),
                               "out_stride": rows})]
            counts = port_kernels.launch_counts()
            assert counts["fft_rows_transpose"] == counts["fft_rows_transpose_16k"] == 1
            assert counts["fft_rows_transpose_large"] == 0
    for n in (8192, 4096):
        port_kernels.reset_launch_counts()
        calls.clear()
        port_fused_kernel.fft_rows_transpose_cuda(torch.zeros((37, n), dtype=torch.complex64),
                                                  radix=2)
        per_cta, threads, *_ = port_fused_kernel.fft_rows_transpose_plan(n, 37)
        assert calls == [("repro_fft_rows_transpose", (n, 37),
                          {"rows": 37, "n": n, "radix": 2, "inverse": 0,
                           "rows_per_cta": per_cta, "threads": threads})]
        counts = port_kernels.launch_counts()
        assert counts["fft_rows_transpose"] == 1 and counts["fft_rows_transpose_16k"] == 0
    port_kernels.reset_launch_counts()


# ---------------------------------------------------------- K3 at 16384

@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 2, 3, 9])
def test_k3_16k_model_is_the_half_spectrum(rows, sms):
    """The model of K3's persistent kernel (``rfft_16k_plan``: min(pairs,
    SMs) CTAs of 1024 threads, each over every C-th pair) at 1 row (an
    unpaired one), 2, 3 (an unpaired last row) and 9 rows, on the card's 132
    SMs and on 3 (several pairs a CTA): ``numpy.fft.rfft`` in float64 to
    ``1e-9·n``; each CTA's pairs in rising order; every input float staged
    or prefetched once, nothing past the input (an unpaired last row's
    staging stops at its row a), and loaded once, from its pair's staging
    area or its prefetched range; every output element stored once; no bank
    conflict in the staging reads or the passes' exchanges."""
    x = real_signal(N + rows + sms, rows, N)
    model = k3_16k_model(x, sms=sms)
    np.testing.assert_allclose(model["out"], np.fft.rfft(x.astype(np.float64)), rtol=0,
                               atol=1e-9 * N)
    assert model["order_ok"] and model["in_range"] and not model["overrun"]
    for key in ("copied", "reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["worst_bank"] == 1


def test_k3_16k_model_matches_reference_rfft_rows_op():
    """The model of K3's persistent kernel against the reference's real row
    op (Pallas, interpret mode) on 3 rows (an unpaired last one),
    ``1e-3·sqrt(n)``, and the port's op on the CPU (the plain version)
    against both."""
    x = real_signal(43, 3, N)
    want = np.asarray(ref_rfft_rows_op(jnp.asarray(x)))
    got = k3_16k_model(x)["out"]
    tol = 1e-3 * np.sqrt(N)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    plain = to_numpy(port_real.rfft_rows_op(to_torch(x)))
    np.testing.assert_allclose(plain, got, rtol=0, atol=tol)


@pytest.mark.parametrize("rows", [258, 259, 64])
def test_k3_16k_pattern(rows):
    """The persistent kernel's pattern alone at the row counts
    ``chip_smoke.py`` checks on the card (258, 259: 129 and 130 pairs on 132
    CTAs, the latter's last row unpaired; 64, the 2^20-element shape): every
    input float staged or prefetched once and loaded once, from its own
    pair's range; every output element stored once; each warp's store one
    run of 256 bytes of one output row (8 for bin n/2, its own item), off
    32-byte boundaries where the row starts off one, as rows of n/2 + 1
    bins do; shared memory the exchange buffer, then the staging area
    (``RFFT_16K_STAGED`` slices of b beside row a), then the mbarrier, 8-byte
    aligned, within one CTA's opt-in 227 KiB; the bulk copies 16 KiB each
    but the last, multiples of 16 bytes."""
    model = k3_16k_model(None, rows=rows)
    assert model["order_ok"] and model["in_range"] and not model["overrun"]
    for key in ("copied", "reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["worst_bank"] == 1
    assert set(model["runs"].tolist()) == {256, 8} and not model["sectors_whole"]
    exchange, stage, bar, total = model["layout"]
    staged = 4 * (N + port_real.RFFT_16K_STAGED * 1024)
    assert (exchange, stage) == (0, 8 * (N + N // 16)) and bar == stage + staged
    assert bar % 8 == 0 and total == bar + 16 <= port_kernel.SMEM_BUDGET
    assert port_kernel.SMEM_BUDGET - stage < staged + 1024 * 4   # the most slices that fit
    assert sum(model["chunks"]) == staged and all(c % 16 == 0 for c in model["chunks"])
    assert max(model["chunks"]) == 16384


def test_rfft_16k_plan_mirrors_the_cuda_source():
    """``rfft_16k_plan`` is the source's launch: ``kStaged`` =
    ``RFFT_16K_STAGED`` (one kernel, no other mode), min(pairs, SMs) CTAs of
    1024 threads with one CTA an SM (``__launch_bounds__(1024, 1)``), the
    shared memory of ``PersistentPlan``; the loop, the staging, its mbarrier
    and the prefetch as the model runs them; the passes and split
    ``rfft_rows.cu``'s at LOG2N = 14; the entry refuses another n and an
    input off a 16-byte boundary (the bulk copies' alignment)."""
    body = source(K3_SOURCE)
    assert '#include "regfft.cuh"' in body and "scratch" not in body
    assert "MODE" not in body and "template <int" not in body
    assert f"constexpr int kStaged = {port_real.RFFT_16K_STAGED};" in body
    assert "return launch_persistent(in, out, rows, (cudaStream_t)stream);" in body
    assert ("if (n != 1 << 14 || reinterpret_cast<uintptr_t>(in) % 16 != 0)\n"
            "        return (int)cudaErrorInvalidValue;") in body
    for rows, sms in ((4096, 132), (3, 132), (259, 132), (1, 7)):
        ctas, threads, staged, smem = port_real.rfft_16k_plan(rows, sms)
        assert ctas == min((rows + 1) // 2, sms) and threads == 1024
        assert staged == 4 * (N + port_real.RFFT_16K_STAGED * 1024) == 90112
        assert smem == 8 * (N + N // 16) + staged + 16 == 229392
    for expr in ("__launch_bounds__(1024, 1)",
                 "static constexpr int STAGE_FLOATS = N + kStaged * G;",
                 "EXCHANGE_BYTES + 4LL * STAGE_FLOATS + 16;",
                 "static constexpr unsigned CHUNK = 16384;",
                 "for (; p < pairs; p += gridDim.x) {",
                 "bulk_copy<PP::CHUNK>(stage, src, 4u * (b ? N + kStaged * G : N), bar);",
                 "prefetch_l2<PP::CHUNK>(src + N + kStaged * G, 4u * (16 - kStaged) * G);",
                 "for (int k = 0; k < R; ++k) re[k] = stage[t + k * G];",
                 "im[k] = !has_b ? 0.0f : k < kStaged ? stage[N + t + k * G] : xb[k * G];",
                 "mbarrier_wait(bar, parity);",
                 "fence.proxy.async.shared::cta;",
                 "fence.mbarrier_init.release.cluster;",
                 "repro::regfft::fft_row<14, false>(v, smem, 0, t);",
                 "const float2 zr = smem[pad((N - k) & (N - 1))];",
                 "const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);"):
        assert expr in body, expr
    assert "Replaces the TPU kernel `rfft_rows_pallas`" in body
    assert "Bound on this card: bytes" in body


# ---------------- K3 at 16384 split over a cluster: the design that lost

@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 9])
def test_k3_cluster_model_is_the_half_spectrum(rows):
    """The model of the cluster design of K3 at 16384
    (``csrc/rfft_rows_cluster.cuh``, built only as a variant) in its best
    shape (1 pair a cluster of 2 CTAs) at 1 row (an unpaired one), 2 (one
    cluster), 3, 5 and 9 (an unpaired last row) and 4: ``numpy.fft.rfft``
    in float64 to ``1e-9·n``; every input element loaded once, every slab
    slot written and loaded once, every row of B with its partner (n1 - k1)
    on one rank, every item's partner bin (n - k) mod n of its pair, every
    output element stored once."""
    x = real_signal(N + rows, rows, N)
    model = k3_cluster_model(x)
    np.testing.assert_allclose(model["out"], np.fft.rfft(x.astype(np.float64)), rtol=0,
                               atol=1e-9 * N)
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"] and model["partner_ok"]


@pytest.mark.parametrize("shape", [(64, 2, 1), (64, 4, 2), (32, 2, 1)])
@pytest.mark.parametrize("rows", [258, 259, 64])
def test_k3_cluster_pattern(rows, shape):
    """The cluster design's pattern alone, in its best shape and two it was
    timed against, at 258, 259 (an unpaired last row) and 64 rows: each
    element loaded, sent, read back and stored once; each warp's loads 32
    consecutive floats of a row from a 128-byte boundary, its remote stores
    whole sectors; no bank conflict in the column exchanges, the remote
    stores, the row phase's loads, the staging or the row DFT's exchanges,
    and at most two lanes on a bank in the split's reads (slot 0 on rank 0
    reads its own row); every store run H = W/2 neighbouring bins of one
    output row, except slot 0's on rank 0: row n1/2 alone (8 bytes), n1 - H
    + 1 ... n1 - 1 (8H - 8 bytes), which runs on into the next bin's left
    run where one warp holds both (16H - 8); each of the 8-byte runs comes
    with one of the last two."""
    model = k3_cluster_model(None, rows=rows, shape=shape)
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"] and model["partner_ok"]
    assert model["loads_128"] and model["remote_whole"] and model["worst_bank"] <= 2
    n1, ctas, pairs = shape
    h = n1 // ctas // 2
    runs = model["runs"].tolist()
    assert set(runs) <= {8 * h, 8, 8 * h - 8, 16 * h - 8}
    assert runs.count(8) == runs.count(8 * h - 8) + runs.count(16 * h - 8) > 0
    elements = N // ctas
    assert row_dft_conflicts(n1 // ctas, N // n1, elements // 16,
                             8 * (elements + elements // 16)) == 1


def test_rfft_cluster_header_is_a_variant_of_the_model_shape():
    """``csrc/rfft_rows_cluster.cuh`` holds the cluster design as templates;
    of the library's sources only K4's at 16384 includes it (for
    ``packed_transpose_kernel``: K3's ``packed_cluster_kernel`` is built
    only as a variant); its best shape for K3 (``kClusterLog2Ctas``,
    ``kClusterLog2Pairs``, ``kClusterLog2N2``) is the model's default; the
    mirror slots, the staging and the split as the model runs them; two
    CTAs an SM at that shape."""
    text = source(K3_CLUSTER_HEADER)
    assert f'#include "{HEADER}"' in text and 'extern "C"' not in text
    including = [path.name for path in _build.source_files()
                 if f'#include "{K3_CLUSTER_HEADER}"' in path.read_text()]
    assert including == [K4_SOURCE]
    assert "packed_cluster_kernel" not in source(K4_SOURCE)
    n1, ctas, pairs = 64, 2, 1
    assert f"constexpr int kClusterLog2Ctas = {ctas.bit_length() - 1};" in text
    assert f"constexpr int kClusterLog2Pairs = {pairs.bit_length() - 1};" in text
    assert f"constexpr int kClusterLog2N2 = {(N // n1).bit_length() - 1};" in text
    elements = N // ctas
    threads, smem = pairs * elements // 16, 8 * pairs * (elements + elements // 16)
    assert (threads, smem) == (512, 69632)
    assert 65536 // (threads * 64) * (smem + CTA_RESERVED_SMEM) <= SM_SMEM
    for expr in ("return k1 < N1 / 2 ? k1 : k1 == N1 / 2 ? 0 : N1 - k1;",
                 "return (slot(k1) & (H - 1)) + (k1 >= N1 / 2 ? H : 0);",
                 "slab[M::local(k1) * N2 + j2] = v[k];",
                 "buf[slot(((t2 + k * G2) << LOG2W) + rho)] = v[k];",
                 "const int pq = self ? q : q ^ H;",
                 "const int pk = self && q == 0 ? (N2 - k2) & (N2 - 1) : N2 - 1 - k2;",
                 "const int k = M::row(rank, q) + (k2 << LOG2N1);",
                 "const float2 z = buf[slot((N2 / 2) << LOG2W)];"):
        assert expr in text, expr
    assert text.count("cluster.sync()") == 2


def test_k3_launcher_takes_the_persistent_kernel_at_16384(monkeypatch):
    """What ``rfft_rows_cuda`` launches, with the launch recorded: at 16384
    one launch of ``repro_rfft_rows_16k`` a call (its 5-argument binding),
    counted once under ``rfft_rows`` and ``rfft_rows_16k``; below it the
    register-resident kernel in ``complex_rows_plan``'s shape for the
    pairs."""
    ptr, ll, int_ = _build._PTR, _build._LL, _build._INT
    assert _build._FUNCTIONS["repro_rfft_rows_16k"] == (int_, [ptr, ptr, ll, int_, ptr])
    body = source(K3_SOURCE)
    assert ('extern "C" int repro_rfft_rows_16k(const void* in, void* out, long long rows, '
            'int n,') in body and body.count('extern "C"') == 1
    calls = []
    monkeypatch.setattr(port_real, "check_kernel_input", lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_real, "launch",
                        lambda fn, x, out, **args: calls.append((fn, out.shape, args)))
    for rows in (4096, 259, 1):
        port_kernels.reset_launch_counts()
        calls.clear()
        out = port_real.rfft_rows_cuda(torch.zeros((rows, N)))
        assert out.shape == (rows, N // 2 + 1)
        assert calls == [("repro_rfft_rows_16k", (rows, N // 2 + 1), {"rows": rows, "n": N})]
        counts = port_kernels.launch_counts()
        assert counts["rfft_rows"] == counts["rfft_rows_16k"] == 1
    for n in (8192, 4096):
        port_kernels.reset_launch_counts()
        calls.clear()
        port_real.rfft_rows_cuda(torch.zeros((37, n)))
        per_cta, threads, *_ = port_kernel.complex_rows_plan(n, 19)
        assert calls == [("repro_rfft_rows", (37, n // 2 + 1),
                          {"rows": 37, "n": n, "radix": 4, "rows_per_cta": per_cta,
                           "threads": threads})]
        counts = port_kernels.launch_counts()
        assert counts["rfft_rows"] == 1 and counts["rfft_rows_16k"] == 0
    port_kernels.reset_launch_counts()


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k3_launcher_refuses_an_input_off_16_bytes_at_16384(monkeypatch, offset):
    """A contiguous (rows, 16384) float32 view that starts 4, 8 or 12 bytes
    past a 16-byte boundary is refused by ``rfft_rows_cuda`` before any
    launch (the persistent kernel moves rows by bulk copies, which need
    16-byte aligned addresses) and counted nowhere; the same rows from an
    aligned start take their one launch; below 16384 (the register-resident
    kernel, scalar loads) the unaligned view is launched."""
    calls = []
    monkeypatch.setattr(port_real, "check_kernel_input", lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_real, "launch",
                        lambda fn, x, out, **args: calls.append((fn, x.data_ptr())))
    rows = 3
    buf = torch.zeros(rows * N + 4)
    assert buf.data_ptr() % 16 == 0
    port_kernels.reset_launch_counts()
    view = buf[offset:offset + rows * N].view(rows, N)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    with pytest.raises(ValueError, match="16-byte boundary"):
        port_real.rfft_rows_cuda(view)
    assert calls == [] and port_kernels.launch_counts()["rfft_rows"] == 0
    port_real.rfft_rows_cuda(buf[4:4 + rows * N].view(rows, N))
    assert calls == [("repro_rfft_rows_16k", buf.data_ptr() + 16)]
    assert port_kernels.launch_counts()["rfft_rows_16k"] == 1
    port_real.rfft_rows_cuda(buf[offset:offset + rows * 8192].view(rows, 8192))
    assert calls[-1] == ("repro_rfft_rows", buf.data_ptr() + 4 * offset)
    port_kernels.reset_launch_counts()


# ------------------- K4 at 16384: the pair split over a cluster, transposed

def test_k4_16k_plan_mirrors_the_cuda_source():
    """``rfft_transpose_16k_plan`` is the launch of the source's entry: n1 =
    32 (``kLog2N1``) and n2 = 512, 8 CTAs of 2 pairs where the row count is a
    multiple of 4 (``kLog2Ctas``, ``kLog2Pairs``: the 2 pairs' 4 real rows
    are whole 32-byte sectors of an output row), 16 CTAs of 4 pairs elsewhere
    (``kWideLog2Ctas``, ``kWideLog2Pairs``: 64-byte runs), each
    ``ClusterPlan``'s R*n/(16C) = 256 threads and R*(n/C)*17/16 float2 =
    34816 bytes, four CTAs an SM (64 registers); what the header's
    static_asserts require (32 columns a rank or more, runs of W rows of B or
    R*W >= 4 rows); one cluster a group of pairs, no scratch, no alignment
    demand (plain loads); the register source stops at 8192."""
    body = source(K4_SOURCE)
    assert f'#include "{K3_CLUSTER_HEADER}"' in body and "scratch" not in body
    assert "constexpr int kLog2N1 = 5;" in body
    for rows in (4096, 16384, 4, 8, 4100):
        n1, n2, ctas, per, threads, smem, blocks = port_fused_real.rfft_transpose_16k_plan(rows)
        assert (n1, n2, ctas, per) == (32, 512, 8, 2)
        assert (ctas, per) == port_fused_real.RFFT_TRANSPOSE_16K_SHAPE
        assert blocks == -(-((rows + 1) // 2) // per) * ctas
    for rows in (16385, 16386, 1, 2, 3, 257, 258, 259, 263):
        n1, n2, ctas, per, threads, smem, blocks = port_fused_real.rfft_transpose_16k_plan(rows)
        assert (ctas, per) == port_fused_real.RFFT_TRANSPOSE_16K_WIDE_SHAPE == (16, 4)
        assert blocks == -(-((rows + 1) // 2) // 4) * 16
    for (ctas, per), prefix in ((port_fused_real.RFFT_TRANSPOSE_16K_SHAPE, "k"),
                                (port_fused_real.RFFT_TRANSPOSE_16K_WIDE_SHAPE, "kWide")):
        assert f"constexpr int {prefix}Log2Ctas = {ctas.bit_length() - 1};" in body
        assert f"constexpr int {prefix}Log2Pairs = {per.bit_length() - 1};" in body
        rows = 4096 if prefix == "k" else 4098
        n1, n2, _, _, threads, smem, _ = port_fused_real.rfft_transpose_16k_plan(rows)
        cols, w = n2 // ctas, n1 // ctas
        assert threads == per * cols * (n1 // 16) == per * w * (n2 // 16) == 256
        assert cols >= 32 and (w >= 4 or w * per >= 4) and n2 // 16 >= 16
        assert smem == 8 * per * (w * n2 + -(-w * n2 // 16)) == 34816
        blocks = 65536 // (threads * 64)
        assert blocks == 4 and blocks * (smem + CTA_RESERVED_SMEM) <= SM_SMEM
        assert ctas <= 8 or "cudaFuncAttributeNonPortableClusterSizeAllowed" in source(HEADER)
    assert ("    if (rows % 4 == 0)\n        return launch_packed<kLog2N1, 14 - kLog2N1, "
            "kLog2Ctas, kLog2Pairs, true>(") in body
    assert ("return launch_packed<kLog2N1, 14 - kLog2N1, kWideLog2Ctas, kWideLog2Pairs, "
            "true>(") in body
    assert "if (n != 1 << 14) return (int)cudaErrorInvalidValue;" in body
    assert "% 16" not in body
    assert "Replaces the TPU kernel `rfft_rows_transpose_pallas`" in body
    assert "Bound on this card: bytes" in body
    assert "case 1 << 13: return launch<13>(" in source("rfft_rows_transpose.cu")
    assert "case 1 << 14" not in source("rfft_rows_transpose.cu")
    with pytest.raises(ValueError, match="rfft_transpose_16k_plan"):
        port_fused_real.rfft_rows_transpose_plan(N, 4096)


def test_k4_16k_kernel_is_the_model():
    """The header's ``packed_transpose_kernel`` as ``k4_16k_model`` runs it:
    the shared phases (``packed_cluster_rows``: the packed loads, the mirror
    exchange, the row phase), the pairs staged side by side in the whole
    buffer, the items of the split with the pair fastest and the partners
    of ``packed_cluster_kernel``, the 16-byte store at an even row count
    and the lane pairs at an odd one, bin n/2 on rank 0."""
    text = source(K3_CLUSTER_HEADER)
    start = text.index("packed_transpose_kernel(const float* __restrict__ in")
    kernel = text[start:text.index("int& packed_occupancy()")]
    for expr in ("packed_cluster_rows<LOG2N1, LOG2N2, LOG2C, LOG2R>(in, rows, p0 + g,",
                 "smem + g * CP::ROW_ELEMS, rt, rank, v);",
                 "const Swizzle<LOG2N2> slot(LOG2P);",
                 "smem[slot(((((t2 + k * G2) << LOG2W) + rho) << LOG2R) + g)] = v[k];",
                 "const int gq = f & (R - 1), q = (f >> LOG2R) & (W - 1), k2 = f >> LOG2P;",
                 "const int f = threadIdx.x + (first + i) * THREADS;",
                 "const int f = (threadIdx.x >> 1) + (first + i) * (THREADS / 2);",
                 "const bool self = rank == 0 && (q & (H - 1)) == 0;",
                 "const int pk = self && q == 0 ? (N2 - k2) & (N2 - 1) : N2 - 1 - k2;",
                 "zk = smem[slot(f)];",
                 "zr = smem[slot((((pk << LOG2W) + pq) << LOG2R) + gq)];",
                 "return M::row(rank, (f >> LOG2R) & (W - 1)) + ((long long)(f >> LOG2P) "
                 "<< LOG2N1);",
                 "const long long p = p0 + (f & (R - 1));",
                 "const long long col = 2 * (p0 + (f & (R - 1))) + half;",
                 "out[bin(f) * rows + col] = half ? split_b(zk[i], zr[i])",
                 "store_split<true>(out, p, bin(f), split_a(zk[i], zr[i]),",
                 "const float2 z = smem[slot(((N2 / 2) << LOG2P) + threadIdx.x)];",
                 "const bool vec = (rows & 1) == 0"):
        assert expr in kernel, expr
    assert "cluster.sync()" not in kernel and text.count("cluster.sync()") == 2


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8, 9])
def test_k4_16k_model_is_the_transposed_half_spectrum(rows):
    """The model of K4's cluster kernel in its launch shape
    (``rfft_transpose_16k_plan``: 8 CTAs of 2 pairs at 4 and 8 rows, 16 of
    4 elsewhere) at 1 row (an unpaired one), 2, 3, 5, 9 (an unpaired last
    row), 4 and 8: ``numpy.fft.rfft(x).T`` in float64 to ``1e-9·n``; every
    input element loaded once, every slab slot written and loaded once,
    every row of B with its partner on one rank, every item of the split
    once and with its partner bin (n - k) mod n, every output element
    stored once; no bank conflict but rank 0's partner reads (slot 0's rows
    are their own partners), at most 2-way."""
    x = real_signal(2 * N + rows, rows, N)
    model = k4_16k_model(x)
    np.testing.assert_allclose(model["out"], np.fft.rfft(x.astype(np.float64)).T, rtol=0,
                               atol=1e-9 * N)
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"] and model["partner_ok"] and model["items_once"]
    assert model["worst_bank"] == 1 and model["self_bank"] <= 2


@pytest.mark.parametrize("rows", [257, 263, 258, 259])
def test_k4_16k_model_matches_reference_rfft_rows_transpose_op(rows):
    """The model of K4's cluster kernel against the reference's fused real
    op (Pallas, interpret mode) at the ragged row counts ``chip_smoke.py``
    checks on the card (257, 263: an unpaired last row, the lane pairs'
    store; 258, 259: 129 and 130 pairs, a ragged last cluster),
    ``1e-3·sqrt(n)``, and the port's op on the CPU (the plain version)
    against both; the model also against ``numpy.fft`` in float64."""
    x = real_signal(3 * N + rows, rows, N)
    want = np.asarray(ref_rfused_op(jnp.asarray(x)))
    got = k4_16k_model(x)["out"]
    tol = 1e-3 * np.sqrt(N)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, np.fft.rfft(x.astype(np.float64)).T, rtol=0,
                               atol=1e-9 * N)
    plain = to_numpy(port_fused_real.rfft_rows_transpose_op(to_torch(x)))
    np.testing.assert_allclose(plain, got, rtol=0, atol=tol)


@pytest.mark.parametrize("rows", [257, 263, 258, 259, 4096, 4100])
def test_k4_16k_pattern(rows):
    """K4's cluster kernel's pattern alone at the row counts ``chip_smoke.py``
    checks on the card (257 … 259, 263; 4096, the records' shape) and at 4100
    (a multiple of 4 with a ragged last cluster): each element loaded, sent,
    read back, split and stored once; each warp's loads 32 consecutive
    floats of a row from a 128-byte boundary, its remote stores whole
    sectors; no bank conflict but rank 0's partner reads (at most 2-way);
    where rows % 4 == 0 (8 CTAs of 2 pairs) every store instruction of a
    whole cluster writes whole 32-byte sectors, 32 bytes an output row;
    elsewhere (16 CTAs of 4 pairs) runs of 64 bytes, the last cluster's
    shorter, off sectors."""
    model = k4_16k_model(None, rows=rows)
    for key in ("reads", "slab_writes", "slab_reads", "writes"):
        assert (model[key] == 1).all(), key
    assert model["owner_ok"] and model["partner_ok"] and model["items_once"]
    assert model["loads_128"] and model["remote_whole"]
    assert model["worst_bank"] == 1 and model["self_bank"] <= 2
    runs = set(model["runs"].tolist())
    tail = 8 * (rows - 8 * (rows // 8))
    if rows % 4 == 0:
        assert model["shape"] == (32, 8, 2) and model["stores_whole"]
        assert runs == {32} | ({tail} if tail % 32 else set())
    else:
        assert model["shape"] == (32, 16, 4) and not model["stores_whole"]
        assert runs == {64, tail}


def test_k4_launcher_takes_the_cluster_kernel_at_16384(monkeypatch):
    """What ``rfft_rows_transpose_cuda`` launches, with the launch recorded
    in place of the library: at 16384 one launch of
    ``repro_rfft_rows_transpose_16k`` a call (its 5-argument binding, no
    launch shape: the C side takes it from n and rows), counted once under
    ``rfft_rows_transpose`` and ``rfft_rows_transpose_16k`` and not under
    K4b's ``rfft_rows_transpose_large``; below it the register kernel in
    ``rfft_rows_transpose_plan``'s shape."""
    ptr, ll, int_ = _build._PTR, _build._LL, _build._INT
    assert _build._FUNCTIONS["repro_rfft_rows_transpose_16k"] == (
        int_, [ptr, ptr, ll, int_, ptr])
    body = source(K4_SOURCE)
    assert ('extern "C" int repro_rfft_rows_transpose_16k(const void* in, void* out, '
            'long long rows, int n,') in body and body.count('extern "C"') == 1
    calls = []
    monkeypatch.setattr(port_fused_real, "check_kernel_input",
                        lambda x, name, *a: tuple(x.shape))
    monkeypatch.setattr(port_fused_real, "launch",
                        lambda fn, x, out, **args: calls.append((fn, out.shape, args)))
    for rows in (16384, 4096, 259, 1):
        port_kernels.reset_launch_counts()
        calls.clear()
        out = port_fused_real.rfft_rows_transpose_cuda(torch.zeros((rows, N)))
        assert out.shape == (N // 2 + 1, rows)
        assert calls == [("repro_rfft_rows_transpose_16k", (N // 2 + 1, rows),
                          {"rows": rows, "n": N})]
        counts = port_kernels.launch_counts()
        assert counts["rfft_rows_transpose"] == counts["rfft_rows_transpose_16k"] == 1
        assert counts["rfft_rows_transpose_large"] == 0
    for n in (8192, 4096):
        port_kernels.reset_launch_counts()
        calls.clear()
        port_fused_real.rfft_rows_transpose_cuda(torch.zeros((37, n)))
        per_cta, threads, *_ = port_fused_real.rfft_rows_transpose_plan(n, 37)
        assert calls == [("repro_rfft_rows_transpose", (n // 2 + 1, 37),
                          {"rows": 37, "n": n, "radix": 4, "rows_per_cta": per_cta,
                           "threads": threads})]
        counts = port_kernels.launch_counts()
        assert counts["rfft_rows_transpose"] == 1 and counts["rfft_rows_transpose_16k"] == 0
    port_kernels.reset_launch_counts()


def test_sources_of_the_16k_kernels_are_built_into_the_library():
    """The three sources are compiled into the library
    (``_build.source_files``) and dispatch n = 16384 in their entries; the
    register-resident K2, K3 and K4 (``fft_rows_transpose.cu``,
    ``rfft_rows.cu``, ``rfft_rows_transpose.cu``) stop at 8192."""
    names = [p.name for p in _build.source_files()]
    assert K2_SOURCE in names and K3_SOURCE in names and K4_SOURCE in names
    assert "fft_rows_transpose_16k.cu" not in names
    for name, entry in ((K2_SOURCE, "repro_fft_rows_transpose_cluster"),
                        (K3_SOURCE, "repro_rfft_rows_16k"),
                        (K4_SOURCE, "repro_rfft_rows_transpose_16k")):
        assert re.search(rf'extern "C" int {entry}\(', source(name))
    assert "case 1 << 14:" in source(K2_SOURCE) and "n != 1 << 14" in source(K3_SOURCE)
    assert "n != 1 << 14" in source(K4_SOURCE)
    assert "case 1 << 13: return launch_dir<13>(" in source("fft_rows_transpose.cu")
    assert "case 1 << 13: return launch<13>(" in source("rfft_rows.cu")
    assert "case 1 << 13: return launch<13>(" in source("rfft_rows_transpose.cu")
    for name in ("fft_rows_transpose.cu", "rfft_rows.cu", "rfft_rows_transpose.cu"):
        assert "case 1 << 14" not in source(name)
