"""K2, the fused complex row FFT -> transposed store
(``csrc/fft_rows_transpose.cu``), on the CPU: its source against its launch
plan, and a float64 model of its store fed the model of its passes, against
``np.fft`` and the reference's fused op.

The kernel itself runs only on the card (``chip_smoke.py``); here the index
arithmetic of its buffer and its (cluster) store is checked thread by thread
by ``_torch_parity.k2_store_model``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (complex_signal, k2_store_model, kernel_pass_model,
                           to_numpy, to_torch)

from repro.kernels.fused.ops import fft_rows_transpose_op as ref_fused_op

from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused.ops import fft_rows_transpose_op

LENGTHS = [1 << e for e in range(1, 15)]
# Row counts of the model: even with whole clusters of 4 (or 2) rows, and
# 8k + 1 and 8k + 7, which leave a ragged last CTA or cluster.
ROWS = [40, 41, 47]


def test_k2_source_runs_the_register_passes_in_k1s_plan():
    """K2 runs K1's passes on ``regfft.cuh`` in the launch shape of
    ``fft_rows_transpose_plan`` (checked by its launcher, any other shape
    refused), in both directions at every length; its buffer, store and
    cluster are the ones ``k2_store_model`` checks, the swizzle and the
    cluster launch K4's (``tstore.cuh``)."""
    source = (_build.csrc_dir() / "fft_rows_transpose.cu").read_text()
    header = (_build.csrc_dir() / "tstore.cuh").read_text()
    assert '#include "tstore.cuh"' in source and '#include "regfft.cuh"' in header
    assert "stockham" not in source
    assert "fft_row<LOG2N, INV>" in source and "cudaErrorInvalidValue" in source
    assert "__launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)" in source
    assert "threads != rows_per_cta * P::GROUP" in source
    assert "rows_per_cta > P::MAX_ROWS" in source
    assert "exchange_elems(rows_per_cta, P::N)" in source
    # No second 1/n: fft_row<LOG2N, true> scales.
    assert "cscale" not in source and "1.0f / " not in source
    # The buffer, written once from registers and read with the row fastest.
    assert "using repro::tstore::Swizzle;" in source
    assert "smem[slot(((t + c * G) << log2_rows) + local)] = v[c];" in source
    assert "const int k = rank * S + (idx >> log2w);" in source
    assert "z[c] = buf[slot((k << log2_rows) + (q & pmask))];" in source
    assert "out[(long long)k * rows + r] = z[c];" in source
    # The cluster: the plan's size, reads of the other CTAs, two barriers.
    assert f"kStoreCluster = {port_fused_kernel.STORE_CLUSTER};" in source
    assert "return repro::tstore::store_cluster<LOG2N, 8>(kStoreCluster);" in source
    assert "return regfft::Plan<LOG2N>::MAX_ROWS * UNIT < 32" in header
    assert "? ctas_at_one_row / regfft::Plan<LOG2N>::MAX_ROWS : 1;" in header
    assert "constexpr int S = N / C;" in source
    assert "cg::this_cluster().map_shared_rank(smem, q >> log2_rows)" in source
    assert source.count("cg::this_cluster().sync();") == 2
    assert "repro::tstore::launch<store_cluster<LOG2N>()>(" in source


def k2_inputs(n, rows, inverse):
    """Seeded complex64 rows and the float64 Z of the model of K2's passes
    (K1's), in K2's launch shape."""
    x = complex_signal(29 * n + rows + inverse, rows, n)
    plan = port_kernel.complex_rows_plan(n, rows)
    z, worst = kernel_pass_model(to_torch(x).to(torch.complex128), plan, inverse=inverse)
    assert worst == 1
    return x, z, plan


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_k2_store_model_is_the_transposed_dft(n, inverse, rows):
    """The model of K2's store, fed the model of its passes:
    ``np.fft.fft(x).T`` (``ifft``) at ``1e-9·n``, every output element
    written once and no column past the last, no bank conflict in the
    buffer's writes or the store's reads (of each CTA's buffer, in a
    cluster), and each warp's writes to one output row one contiguous run of
    8·min(P·C, 32) bytes wherever the CTA (cluster) holds its P (P·C) rows."""
    x, z, plan = k2_inputs(n, rows, inverse)
    per_cta, _, cluster, _ = port_fused_kernel.fft_rows_transpose_plan(n, rows)
    out, writes, worst, (nbytes, contiguous, full) = k2_store_model(
        z, rows, plan, cluster=cluster)
    oracle = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose(out, oracle(x.astype(np.complex128)).T,
                               rtol=0, atol=1e-9 * n)
    assert (writes[:, :rows] == 1).all() and not writes[:, rows].any()
    assert worst == 1
    assert contiguous.all()
    assert full.any() and nbytes[full].min() >= 8 * min(per_cta * cluster, 32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_k2_store_model_matches_reference_fft_rows_transpose_op(n, inverse):
    """The model of K2 against the reference's fused op (Pallas, interpret
    mode) at ``1e-3·sqrt(n)``, ``1e-3·sqrt(n) / n`` for the inverse (its
    1/n shrinks the values by n), and the port's op on the CPU (the plain
    version) against both."""
    rows = 41
    x, z, plan = k2_inputs(n, rows, inverse)
    cluster = port_fused_kernel.fft_rows_transpose_plan(n, rows)[2]
    got, *_ = k2_store_model(z, rows, plan, cluster=cluster)
    tol = 1e-3 * np.sqrt(n) / (n if inverse else 1)
    want = np.asarray(ref_fused_op(jnp.asarray(x), inverse=inverse))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    plain = to_numpy(fft_rows_transpose_op(to_torch(x), inverse=inverse))
    np.testing.assert_allclose(plain, got, rtol=0, atol=tol)
    np.testing.assert_allclose(plain, want, rtol=0, atol=tol)


@pytest.mark.parametrize("n", LENGTHS)
def test_k2_store_is_conflict_free_and_wide_at_every_plan(n):
    """Every launch shape K2 takes at length n (the row counts of K1's plan
    tests, 1 … 100000 rows: 1 … 256 rows a CTA): the buffer's writes and the
    store's reads are conflict-free, each element is written once, and each
    warp writes one run of 8·min(P·C, 32) bytes per output row (P rows a
    CTA, C CTAs a cluster), at least a 32-byte sector where a CTA holds all
    the rows it can.  The pattern does not depend on the data: two full
    clusters of rows stand for the grid."""
    max_rows = max(1, 256 * min(16, n) // n)
    per_ctas = set()
    for grid_rows in (100000, 4096, 2048, 128, 19, 2, 1):
        plan = port_kernel.complex_rows_plan(n, grid_rows)
        per_cta, _, cluster, _ = port_fused_kernel.fft_rows_transpose_plan(n, grid_rows)
        if per_cta in per_ctas:
            continue
        per_ctas.add(per_cta)
        rows = min(grid_rows, 2 * per_cta * cluster)
        _, writes, worst, (nbytes, contiguous, full) = k2_store_model(
            None, rows, plan, cluster=cluster)
        assert worst == 1, (per_cta, cluster)
        assert (writes[:, :rows] == 1).all() and not writes[:, rows].any()
        assert contiguous.all()
        width = 8 * min(per_cta * cluster, 32)
        assert (nbytes[full] >= width).all()
        if per_cta == max_rows:
            assert full.any() and width >= 32
    assert max(per_ctas) == max_rows


@pytest.mark.parametrize("rows", [4097, 8 * 64 + 1, 8 * 64 + 7])
@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
def test_k2_store_writes_each_element_once_at_ragged_clusters(n, rows):
    """Where K2 runs in clusters (n >= 2048), at the row counts that leave
    the last cluster ragged — phase 2 of a fused ``rfft-*`` plan at N = 8192
    (4097 rows: one row in the last cluster of 4), 8k + 1 and 8k + 7 — every
    output element is written once and no column past the last."""
    plan = port_kernel.complex_rows_plan(n, rows)
    per_cta, _, cluster, blocks = port_fused_kernel.fft_rows_transpose_plan(n, rows)
    assert cluster > 1 and blocks * per_cta > rows
    _, writes, worst, (_, contiguous, _) = k2_store_model(None, rows, plan, cluster=cluster)
    assert (writes[:, :rows] == 1).all() and not writes[:, rows].any()
    assert worst == 1 and contiguous.all()
