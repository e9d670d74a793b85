"""The real-input slice of the PyTorch port against the JAX package: the
packed-real kernels' modules (K3 ``rfft_rows``, K4 ``rfft_rows_transpose``),
the blocked transpose (K5), the real half of ``fft2d``, the real limbs and
entry points, and the ``rfft-*`` plans.

The same numpy inputs, made from a seed, go to the reference (on the CPU, its
Pallas kernels in interpret mode) and to the port on ``device="cpu"``, where
the ops run the kernels' plain versions.  Tolerances: ``1e-3·sqrt(n)`` for a
row transform of unit-variance float32 rows (the reference suite's kernel
tolerance), ``2e-4·N`` for a 2-D transform (outputs of magnitude ~N, float32,
another summation order), exact equality for host-side integer results and
for the transpose, which moves bits.
"""

import ast
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from _torch_parity import (both_fpms, both_padding_fpms, complex_signal,
                           k4_store_model, kernel_pass_model, to_numpy, to_torch)

import repro.core as ref_core
import repro.core.pfft as ref_pfft
import repro.fft as ref_fft
import repro.plan as ref_plan
from repro.kernels.fft.real import rfft_rows_op as ref_rfft_rows_op
from repro.kernels.fft.real import unpack_packed_fft as ref_unpack
from repro.kernels.fused.real import rfft_rows_transpose_op as ref_rfused_op
from repro.kernels.transpose.ops import transpose_op as ref_transpose_op

import repro_torch
import repro_torch.core as port_core
import repro_torch.core.pfft as port_pfft
import repro_torch.fft as port_fft
import repro_torch.plan as port_plan
from repro_torch import kernels as port_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_fft_kernel
from repro_torch.kernels.fft import real as port_real
from repro_torch.kernels.fft.kernel import (MAX_KERNEL_N, SMEM_BUDGET,
                                            KernelLengthError)
from repro_torch.kernels.fft.ops import resolve_radix
from repro_torch.kernels.fused import real as port_fused_real
from repro_torch.kernels.transpose import kernel as port_transpose
from repro_torch.kernels.transpose.ops import transpose_op
from repro_torch.kernels.transpose.ref import transpose_ref

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIGS = {"default": None, "library": {}, "stockham": {"radix": 2},
           "kernel": {"radix": 4}, "fused": {"fused": True}}
# The port's backend names beside the reference's.
BACKENDS = [(None, None), ("torch", "xla"), ("stockham", "stockham"),
            ("cuda", "pallas")]


def real_signal(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def configs(name):
    kw = CONFIGS[name]
    if kw is None:
        return None, None
    return ref_plan.PlanConfig(**kw), port_plan.PlanConfig(**kw)


# ------------------------------------------------------------ K3 and K4

@pytest.mark.parametrize("rows", [1, 7, 8, 13])
@pytest.mark.parametrize("n", [1, 2, 32, 64, 128])
@pytest.mark.parametrize("radix", [None, 2, 4])
def test_rfft_rows_op_matches_reference(rows, n, radix):
    x = real_signal(rows * 1000 + n, rows, n)
    want = np.asarray(ref_rfft_rows_op(jnp.asarray(x), radix=radix))
    got = port_real.rfft_rows_op(to_torch(x), radix=radix)
    assert got.dtype == torch.complex64 and got.shape == (rows, n // 2 + 1)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(n))
    np.testing.assert_allclose(to_numpy(got), np.fft.rfft(x), atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("rows", [1, 7, 8, 13])
@pytest.mark.parametrize("n", [1, 2, 32, 64, 128])
@pytest.mark.parametrize("radix", [None, 2, 4])
def test_rfft_rows_transpose_op_matches_reference(rows, n, radix):
    x = real_signal(rows * 1000 + n + 1, rows, n)
    want = np.asarray(ref_rfused_op(jnp.asarray(x), radix=radix))
    got = port_fused_real.rfft_rows_transpose_op(to_torch(x), radix=radix)
    assert got.shape == (n // 2 + 1, rows) and got.is_contiguous()
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(n))
    np.testing.assert_allclose(to_numpy(got), np.fft.rfft(x).T, atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("n", [2, 16, 64])
def test_unpack_packed_fft_matches_reference(n):
    """The split alone, on the planes of one complex FFT of two packed rows:
    equal to the reference's split and to the library's spectra of a, b."""
    a, b = real_signal(n, 3, n), real_signal(n + 1, 3, n)
    z = np.fft.fft(a + 1j * b).astype(np.complex64)
    zr, zi = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    got = port_real.unpack_packed_fft(to_torch(zr), to_torch(zi))
    want = ref_unpack(jnp.asarray(zr), jnp.asarray(zi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(to_numpy(got[0]) + 1j * to_numpy(got[1]),
                               np.fft.fft(a), atol=1e-3 * np.sqrt(n))
    np.testing.assert_allclose(to_numpy(got[2]) + 1j * to_numpy(got[3]),
                               np.fft.fft(b), atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("dtype,want", [(torch.float32, torch.complex64),
                                        (torch.float64, torch.complex128),
                                        (torch.float16, torch.complex64),
                                        (torch.int32, torch.complex64)])
def test_real_ops_compute_in_f32_and_return_result_type(dtype, want):
    x = (to_torch(real_signal(5, 2, 3, 6, 32)) * 4).to(dtype)
    oracle = np.fft.rfft(to_numpy(x.to(torch.float64)), axis=-1)
    got = port_real.rfft_rows_op(x)
    assert got.dtype == want and got.shape == (2, 3, 6, 17)
    np.testing.assert_allclose(to_numpy(got), oracle, atol=4e-3 * np.sqrt(32))
    fused = port_fused_real.rfft_rows_transpose_op(x[0, 0].contiguous())
    assert fused.dtype == want
    np.testing.assert_allclose(to_numpy(fused), oracle[0, 0].T, atol=4e-3 * np.sqrt(32))


def test_real_ops_leading_dims_match_reference():
    x = real_signal(2, 2, 3, 6, 32)
    want = np.asarray(ref_rfft_rows_op(jnp.asarray(x)))
    np.testing.assert_allclose(to_numpy(port_real.rfft_rows_op(to_torch(x))),
                               want, atol=1e-3 * np.sqrt(32))


def test_real_ops_reject_non_pow2_like_reference():
    x = np.ones((4, 12), np.float32)
    with pytest.raises(ValueError, match="power-of-two length, got 12"):
        ref_rfft_rows_op(jnp.asarray(x))
    for op in (port_real.rfft_rows_op, port_fused_real.rfft_rows_transpose_op):
        with pytest.raises(ValueError, match="power-of-two length, got 12"):
            op(to_torch(x))


@pytest.mark.parametrize("shape", [(16,), (2, 4, 16)])
def test_real_fused_op_rejects_non_2d_like_reference(shape):
    with pytest.raises(ValueError, match="fused op takes a 2-D matrix"):
        ref_rfused_op(jnp.ones(shape, jnp.float32))
    with pytest.raises(ValueError, match="fused op takes a 2-D matrix"):
        port_fused_real.rfft_rows_transpose_op(torch.ones(shape))


@pytest.mark.parametrize("op", [port_real.rfft_rows_op,
                                port_fused_real.rfft_rows_transpose_op])
def test_real_ops_raise_named_error_above_length_limit(op):
    with pytest.raises(KernelLengthError, match=op.__name__):
        op(torch.ones((2, 2 * MAX_KERNEL_N)))


@pytest.mark.parametrize("op", [port_real.rfft_rows_op,
                                port_fused_real.rfft_rows_transpose_op])
def test_real_ops_refuse_complex_non_contiguous_and_bad_radix(op):
    with pytest.raises(ValueError, match="real input"):
        op(torch.ones((2, 8), dtype=torch.complex64))
    with pytest.raises(ValueError, match="contiguous"):
        op(torch.ones((8, 4)).T)
    with pytest.raises(ValueError, match="unsupported radix"):
        op(torch.ones((2, 8)), radix=8)


@pytest.mark.parametrize("n", [2, 64, 256, 1024, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 37, 8192])
def test_real_launch_shape_fits_the_card(n, rows):
    """K3 and K4 launch K1's plan with a packed pair in the place of a row
    (tested at these pair counts in ``test_torch_regfft.py``).  K4 keeps
    the CTA's Z, P pairs of n float2, in the exchange buffer; where a CTA
    holds one pair (n >= 4096, two CTAs an SM) it runs in clusters of four,
    over a grid padded to a multiple of four."""
    pairs = (rows + 1) // 2
    per_cta, threads, points, _, smem = port_fft_kernel.complex_rows_plan(n, pairs)
    assert 1 <= per_cta <= max(1, 256 * points // n) and per_cta & (per_cta - 1) == 0
    assert 32 <= threads == per_cta * (n // points) <= 1024
    assert 8 * per_cta * n < smem <= SMEM_BUDGET
    assert resolve_radix(n, None, "rfft_rows_transpose_op") == (4 if n >= 4 else 2)
    k4_per_cta, k4_threads, cluster, blocks = port_fused_real.rfft_rows_transpose_plan(n, rows)
    assert (k4_per_cta, k4_threads) == (per_cta, threads)
    assert blocks % cluster == 0 and 0 <= blocks * per_cta - pairs < cluster * per_cta
    if n >= 4096:   # one pair a CTA: a cluster of 4 (at most 8 is portable)
        assert per_cta == 1 and smem <= SMEM_BUDGET // 2
        assert cluster == port_fused_real.STORE_CLUSTER == 4
    else:
        assert cluster == 1


# ---------------------------------------- K3's CUDA pass plan, on the CPU

LENGTHS = [1 << e for e in range(1, 14)]


def test_real_rows_plan_mirrors_the_cuda_header():
    """K3 runs the header's plan with a packed pair in the place of a row,
    at every length, and its launcher refuses any other shape."""
    text = (_build.csrc_dir() / "regfft.cuh").read_text()
    assert f"kMaxPoints = {port_fft_kernel._POINTS};" in text
    assert f"kCtaThreads = {port_fft_kernel._CTA_THREADS};" in text
    source = (_build.csrc_dir() / "rfft_rows.cu").read_text()
    assert "fft_row<LOG2N, false>" in source and "cudaErrorInvalidValue" in source
    for e in range(1, 14):
        assert f"case 1 << {e}: return launch<{e}>(" in source


def test_k4_source_runs_the_register_passes_in_k1s_plan():
    """K4 (``rfft_rows_transpose.cu``) runs K3's passes on ``regfft.cuh`` in
    the launch shape of ``rfft_rows_transpose_plan`` (checked by its
    launcher, any other shape refused), at every length; its buffer swizzle
    and cluster store are the ones ``k4_store_model`` checks (the swizzle,
    the cluster rule and the launch in clusters in ``tstore.cuh``, which K2
    shares)."""
    source = (_build.csrc_dir() / "rfft_rows_transpose.cu").read_text()
    header = (_build.csrc_dir() / "tstore.cuh").read_text()
    assert '#include "tstore.cuh"' in source and "stockham_rows" not in source
    assert '#include "regfft.cuh"' in header
    assert "fft_row<LOG2N, false>" in source and "cudaErrorInvalidValue" in source
    assert "__launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)" in source
    assert "threads != pairs_per_cta * P::GROUP" in source
    assert "pairs_per_cta > P::MAX_ROWS" in source
    assert "exchange_elems(pairs_per_cta, P::N)" in source
    for e in range(1, 14):
        assert f"case 1 << {e}: return launch<{e}>(" in source
    assert "case 1 << 14" not in source
    # The swizzle: the model's k4_swizzle, written as the kernel writes it.
    assert "using repro::tstore::Swizzle;" in source
    for line in ("LG = LOG2N < 4 ? 0 : LOG2N - 4;", "LANES_K = LG < 4 ? LG : 4;",
                 "bits = log2_rows >= 4 ? LANES_K : LANES_K + log2_rows - 4;",
                 "s = log2_rows >= 4 ? log2_rows - 4 : 0;",
                 "return f ^ (((f >> 4 >> s) & mask) << (4 - LANES_K));"):
        assert line in header, line
    assert "smem[slot(((t + c * G) << log2_pairs) + local)] = v[c];" in source
    assert "smem[slot(idx)]" in source
    assert "smem[slot((((N - k) & (N - 1)) << log2_pairs) + p)]" in source
    # The cluster: its size, where it is used, the padded grid, the
    # occupancy check, two barriers and the reads of the other CTAs.
    # (16 bytes of a pair per output row: a cluster where a CTA holds one.)
    assert f"kStoreCluster = {port_fused_real.STORE_CLUSTER};" in source
    assert "return repro::tstore::store_cluster<LOG2N, 16>(kStoreCluster);" in source
    assert "return regfft::Plan<LOG2N>::MAX_ROWS * UNIT < 32" in header
    assert "repro::tstore::launch<store_cluster<LOG2N>()>(" in source
    assert "blocks = (ctas + C - 1) / C * C;" in header
    assert "cudaLaunchAttributeClusterDimension" in header
    assert "cudaOccupancyMaxActiveClusters" in header
    assert source.count("cluster.sync();") == 2
    assert "constexpr int S = (NH + C - 1) / C;" in source
    assert "const int k = rank * S + (idx >> LOG2C);" in source
    assert "cluster.map_shared_rank(smem, q)" in source


# Row counts of K4's store model, odd and even: at every length a CTA (or a
# cluster of four) that holds all its pairs and a ragged last one (P <= 32
# pairs a CTA at these counts; 37 and 38 pairs leave 1 and 2 in the last
# cluster).
K4_ROWS = [74, 75]


def k4_inputs(n, rows):
    """Seeded float32 rows, and the float64 Z of their packed pairs from the
    model of the passes (an odd count pairs its last row with zeros)."""
    x = real_signal(31 * n + rows, rows, n)
    xp = np.concatenate([x, np.zeros((rows % 2, n), np.float32)]).astype(np.float64)
    z = torch.complex(torch.from_numpy(xp[0::2]), torch.from_numpy(xp[1::2]))
    plan = port_fft_kernel.complex_rows_plan(n, z.shape[0])
    got, worst = kernel_pass_model(z, plan)
    assert worst == 1
    return x, got, plan


@pytest.mark.parametrize("rows", K4_ROWS)
@pytest.mark.parametrize("n", LENGTHS)
def test_k4_store_model_is_the_transposed_half_spectrum(n, rows):
    """The model of K4's split and store, fed the model of its passes:
    ``np.fft.rfft(x).T`` at ``1e-9·n``, every output element written once and
    the unpaired column never, no bank conflict in the buffer's writes or
    the store's reads (of each CTA's buffer, in a cluster), and each warp's
    writes to one output row one contiguous run of 16·P bytes (a warp's 32
    lanes: 16·min(P, 32)) wherever the CTA (the cluster of four, at
    n >= 4096) holds its P pairs."""
    x, z, plan = k4_inputs(n, rows)
    cluster = port_fused_real.rfft_rows_transpose_plan(n, rows)[2]
    out, writes, worst, runs = k4_store_model(z, rows, plan, cluster=cluster)
    np.testing.assert_allclose(out, np.fft.rfft(x.astype(np.float64)).T,
                               rtol=0, atol=1e-9 * n)
    assert (writes[:, :rows] == 1).all() and not writes[:, rows].any()
    assert worst == 1
    assert all(contiguous for _, contiguous, _ in runs)
    full = [nbytes for nbytes, _, whole in runs if whole]
    assert full and min(full) >= 16 * min(plan[0] * cluster, 32)


@pytest.mark.parametrize("n", LENGTHS)
def test_k4_store_is_conflict_free_and_wide_at_every_plan(n):
    """Every launch shape K4 takes at length n (the pair counts of K1's plan
    tests, 1 … 100000 pairs: 1 … 256 pairs a CTA): the buffer's writes and
    the store's reads are conflict-free, and each warp writes one run of
    16·min(P·C, 32) bytes per output row (P pairs a CTA, C CTAs a cluster).
    The bank pattern and the runs do not depend on the data: zeros, and
    the pairs of two full groups, stand for the grid."""
    widths, per_ctas = [], set()
    for grid_pairs in (100000, 4096, 2048, 128, 19, 2, 1):
        plan = port_fft_kernel.complex_rows_plan(n, grid_pairs)
        per_cta, _, cluster, _ = port_fused_real.rfft_rows_transpose_plan(n, 2 * grid_pairs)
        if per_cta in per_ctas:
            continue
        per_ctas.add(per_cta)
        pairs = min(grid_pairs, 2 * per_cta * cluster)
        z = torch.zeros((pairs, n), dtype=torch.complex128)
        _, writes, worst, runs = k4_store_model(z, 2 * pairs, plan, cluster=cluster)
        assert worst == 1, (per_cta, cluster)
        assert (writes[:, :2 * pairs] == 1).all()
        assert all(contiguous for _, contiguous, _ in runs)
        widths += [nbytes / (16 * min(per_cta * cluster, 32))
                   for nbytes, _, full in runs if full]
    assert widths and min(widths) >= 1
    assert max(per_ctas) == max(1, 256 * min(16, n) // n)


@pytest.mark.parametrize("rows", K4_ROWS)
@pytest.mark.parametrize("n", LENGTHS)
def test_k4_store_model_matches_reference_rfft_rows_transpose_op(n, rows):
    """The model of K4 against the reference's fused real op (Pallas,
    interpret mode) at ``1e-3·sqrt(n)``, and the port's op on the CPU (the
    plain version) against both."""
    x, z, plan = k4_inputs(n, rows)
    cluster = port_fused_real.rfft_rows_transpose_plan(n, rows)[2]
    got, *_ = k4_store_model(z, rows, plan, cluster=cluster)
    want = np.asarray(ref_rfused_op(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.sqrt(n))
    plain = to_numpy(port_fused_real.rfft_rows_transpose_op(to_torch(x)))
    np.testing.assert_allclose(plain, got, rtol=0, atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("n", LENGTHS)
def test_kernel_pass_model_is_the_dft_and_its_exchange_is_conflict_free(n):
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((2, 3, n))
    z = torch.complex(torch.from_numpy(a), torch.from_numpy(b))
    got, worst = kernel_pass_model(z, port_fft_kernel.complex_rows_plan(n, 3))
    torch.testing.assert_close(got, torch.fft.fft(z), rtol=0, atol=1e-9 * n)
    assert worst == 1
    # ... and after the kernel's split, the plain version's half spectra.
    zf = got.to(torch.complex64)
    zr = torch.cat([zf[:, :1], zf[:, 1:].flip(-1)], dim=-1)
    nh = n // 2 + 1
    spec = torch.stack([0.5 * (zf + zr.conj()), -0.5j * (zf - zr.conj())], dim=1)
    x = to_torch(np.stack([a, b], axis=1).reshape(6, n).astype(np.float32))
    torch.testing.assert_close(spec.reshape(6, n)[:, :nh], port_real.rfft_rows_plain(x),
                               rtol=0, atol=1e-3 * np.sqrt(n))


# ------------------------------------------------------------ K5 transpose

@given(r=st.integers(1, 300), c=st.integers(1, 300), seed=st.integers(0, 20))
@settings(max_examples=30, deadline=None)
def test_transpose_op_any_shape_matches_reference(r, c, seed):
    x = real_signal(seed, r, c)
    want = np.asarray(ref_transpose_op(jnp.asarray(x), block=128))
    got = transpose_op(to_torch(x))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(port_transpose.transpose_plain(
        to_torch(x), block=32)), x.T)


def test_transpose_op_complex_matches_reference():
    x = complex_signal(0, 130, 70)
    want = np.asarray(ref_transpose_op(jnp.asarray(x)))
    got = transpose_op(to_torch(x))
    assert got.dtype == torch.complex64 and got.is_contiguous()
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(got), x.T)


def test_transpose_involution():
    x = to_torch(real_signal(1, 200, 150))
    assert torch.equal(transpose_op(transpose_op(x)), x)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int16,
                                   torch.float16, torch.bfloat16, torch.int32,
                                   torch.float32, torch.int64, torch.float64,
                                   torch.complex64, torch.complex128])
def test_transpose_is_bit_exact_for_each_element_size(dtype):
    assert torch.empty((), dtype=dtype).element_size() in port_transpose.ELEMENT_BYTES
    x = to_torch(real_signal(2, 37, 129)) * 100
    x = torch.complex(x, -x).to(dtype) if dtype.is_complex else x.to(dtype)
    for block in (1, 16, 128):
        got = transpose_op(x, block=block)
        assert got.dtype == dtype and torch.equal(got, transpose_ref(x))


def test_transpose_op_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="2-D"):
        transpose_op(torch.ones(4))
    with pytest.raises(ValueError, match="contiguous"):
        transpose_op(torch.ones((8, 4)).T)
    with pytest.raises(ValueError, match="block"):
        transpose_op(torch.ones((8, 4)), block=0)


# -------------------------------------------------------- launchers, build

@pytest.mark.parametrize("launcher,x", [
    (port_real.rfft_rows_cuda, torch.ones((2, 8))),
    (port_fused_real.rfft_rows_transpose_cuda, torch.ones((2, 8))),
    (port_transpose.transpose_cuda, torch.ones((2, 8)))])
def test_new_launchers_refuse_a_cpu_tensor(launcher, x):
    """The launchers never run a plain version: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        launcher(x)


def test_cpu_real_ops_launch_nothing_and_build_nothing():
    port_kernels.reset_launch_counts()
    x = to_torch(real_signal(0, 6, 32))
    port_real.rfft_rows_op(x)
    port_fused_real.rfft_rows_transpose_op(x)
    transpose_op(x)
    assert set(port_kernels.launch_counts().values()) == {0}
    assert _build._library is None


def test_new_kernels_are_bound_with_their_own_signatures():
    fns = _build._FUNCTIONS
    assert len(fns["repro_rfft_rows"][1]) == 8             # no `inverse`
    assert fns["repro_rfft_rows_transpose"] == fns["repro_rfft_rows"]
    assert len(fns["repro_fft_rows"][1]) == 9
    assert len(fns["repro_transpose"][1]) == 6             # in, out, r, c, elem, stream


@pytest.mark.parametrize("name,replaces", [
    ("rfft_rows.cu", "src/repro/kernels/fft/real.py"),
    ("rfft_rows_transpose.cu", "src/repro/kernels/fused/real.py"),
    ("transpose.cu", "src/repro/kernels/transpose/kernel.py")])
def test_new_sources_name_sm_90a_and_the_kernel_they_replace(name, replaces):
    text = (_build.csrc_dir() / name).read_text()
    assert "sm_90a" in text and replaces in text
    assert os.path.isfile(os.path.join(ROOT, replaces))
    assert "jax" not in text.lower() and "torch/extension.h" not in text


@pytest.mark.parametrize("module", [port_real, port_fused_real, port_transpose])
def test_new_modules_import_no_jax_and_nothing_of_the_reference(module):
    tree = ast.parse(open(module.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in ("jax", "repro")
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("jax", "repro")
                       for a in node.names)
    assert module.__name__.startswith(repro_torch.__name__ + ".")


# --------------------------------------------------------- fft2d real half

@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("shape", [(5, 32), (6, 24), (2, 3, 6, 16), (16,)])
def test_rfft_rows_each_backend_matches_reference(backend, ref_backend, shape):
    """Power-of-two rows go to the backend; a non-pow2 length and 1-D input
    go to the library under every backend, by the reference's rule."""
    x = real_signal(len(shape), *shape)
    want = np.asarray(ref_fft.rfft_rows(jnp.asarray(x), backend=ref_backend))
    got = port_fft.rfft_rows(to_torch(x), backend=backend)
    assert got.shape == want.shape
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(shape[-1]))


def test_rfft_rows_rejects_an_unknown_backend():
    with pytest.raises(ValueError, match="unknown row-FFT backend"):
        port_fft.rfft_rows(torch.ones((2, 8)), backend="pallas")


@pytest.mark.parametrize("case,shape,dtype,backend,kernel", [
    ("default", (24, 64), np.float32, None, True),
    ("cuda", (24, 64), np.float32, "cuda", True),
    ("fused", (24, 64), np.float32, "fused", True),
    ("stockham", (24, 64), np.float32, "stockham", False),
    ("float64", (24, 64), np.float64, None, False),
    ("3-D", (2, 12, 64), np.float32, None, False),
    ("non-pow2", (24, 48), np.float32, None, False),
    ("n=1", (24, 1), np.float32, None, False)])
def test_rfft_rows_then_transpose_eligibility(case, shape, dtype, backend,
                                              kernel, monkeypatch):
    """The fused real op runs exactly where the reference's does; elsewhere
    the unfused value comes back as a contiguous copy."""
    calls = []
    real_op = port_fused_real.rfft_rows_transpose_op
    monkeypatch.setattr(port_fused_real, "rfft_rows_transpose_op",
                        lambda *a, **k: calls.append(1) or real_op(*a, **k))
    x = real_signal(7, *shape).astype(dtype)
    ref_backend = {"cuda": "pallas"}.get(backend, backend)
    want = np.asarray(ref_fft.rfft_rows_then_transpose(jnp.asarray(x),
                                                       backend=ref_backend))
    got = port_fft.rfft_rows_then_transpose(to_torch(x), backend=backend)
    assert bool(calls) == kernel
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(shape[-1]))


@pytest.mark.parametrize("n", [7, 16, 33, 48])
@pytest.mark.parametrize("backend,ref_backend", [(None, None),
                                                 ("stockham", "stockham"),
                                                 ("cuda", "pallas")])
def test_fft2d_rfft2_matches_reference(n, backend, ref_backend):
    x = real_signal(n, n, n)
    want = np.asarray(ref_fft.rfft2(jnp.asarray(x), backend=ref_backend))
    got = port_fft.rfft2(to_torch(x), backend=backend)
    assert got.shape == (n, n // 2 + 1)
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    np.testing.assert_allclose(to_numpy(got), np.fft.rfft2(x), atol=2e-4 * n)


@pytest.mark.parametrize("n", [7, 8, 15, 16])
def test_fft2d_irfft2_round_trips_like_reference(n):
    x = real_signal(n + 2, n, n)
    h = np.fft.rfft2(x).astype(np.complex64)
    want = np.asarray(ref_fft.irfft2(jnp.asarray(h), n=n))
    got = port_fft.irfft2(to_torch(h), n=n)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-5)
    np.testing.assert_allclose(to_numpy(port_fft.irfft2(port_fft.rfft2(
        to_torch(x)), n=n)), x, atol=1e-4)
    if n % 2 == 0:  # the default length assumes an even signal
        np.testing.assert_allclose(to_numpy(port_fft.irfft2(to_torch(h))), x, atol=1e-4)


# ------------------------------------------------- host-side code, exact

@pytest.mark.parametrize("d,nh", [([4, 4, 4, 4], 9), ([2048, 2048, 2048, 2048], 4097),
                                  ([10, 0, 3, 19], 17), ([5, 5], 6), ([1], 1),
                                  ([0, 7, 0, 9], 9)])
def test_halfspec_distribution_equals_reference(d, nh):
    want = ref_pfft.halfspec_distribution(np.array(d), nh)
    got = port_pfft.halfspec_distribution(np.array(d), nh)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == min(nh, sum(d))


@pytest.mark.parametrize("n,case", [(32, "lb"), (48, "fpm"), (64, "fpm-pad"),
                                    (96, "hetero-configs")])
def test_clip_schedule_equals_reference(n, case):
    ref_fpms, port_fpms = both_padding_fpms(n) if case == "fpm-pad" else both_fpms(n)
    if case == "lb":
        d, pads = ref_core.lb_partition(n, 4).d, None
    else:
        d = ref_core.partition_rows(n, ref_fpms, 0.05).d
        pads = ref_plan.rfft_pad_lengths(ref_fpms, d, n) if case == "fpm-pad" else None
    kinds = [{"real": True}, {"radix": 4, "real": True}, {"radix": 2, "real": True}]
    per_seg = [kinds[i % 3] if case == "hetero-configs" else kinds[0]
               for i in range(len(d))]
    ref_s = ref_plan.SegmentSchedule.from_parts(
        n, d, pads, [ref_plan.PlanConfig(**k) for k in per_seg])
    port_s = port_plan.SegmentSchedule.from_parts(
        n, d, pads, [port_plan.PlanConfig(**k) for k in per_seg])
    d2_ref, s_ref = ref_pfft._clip_schedule(ref_s, d, n // 2 + 1)
    d2_port, s_port = port_pfft._clip_schedule(port_s, d, n // 2 + 1)
    np.testing.assert_array_equal(d2_port, d2_ref)
    assert s_port.to_dict() == s_ref.to_dict()
    assert s_port.describe() == s_ref.describe()


# ------------------------------------------------ limbs and entry points

def _schedule_pair(n, d, pads, make):
    return (ref_plan.SegmentSchedule.from_parts(n, d, pads, make(ref_plan)),
            port_plan.SegmentSchedule.from_parts(n, d, pads, make(port_plan)))


@pytest.mark.parametrize("kernel_radix", [None, 2, 4])
def test_segment_row_rffts_heterogeneous_lengths(kernel_radix):
    """Three processors at three lengths (N, a pow2 pad, a non-pow2 pad)
    under mixed configs: the groups, the crop and the scatter agree."""
    n = 48
    d = np.array([10, 20, 18])
    pads = np.array([48, 64, 80])
    x = real_signal(11, n, n)
    ref_s, port_s = _schedule_pair(n, d, pads, lambda pk: [
        pk.PlanConfig(real=True, pad="fpm"),
        pk.PlanConfig(radix=kernel_radix, real=True, pad="fpm"),
        pk.PlanConfig(radix=kernel_radix, real=True, pad="fpm")])
    want = np.asarray(ref_pfft.segment_row_rffts(jnp.asarray(x), d, schedule=ref_s))
    got = port_pfft.segment_row_rffts(to_torch(x), d, schedule=port_s)
    assert got.shape == (n, n // 2 + 1)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(80))


def test_segment_row_rffts_errors_like_reference():
    x = real_signal(0, 8, 8)
    for pfft, plan, conv in ((ref_pfft, ref_plan, jnp.asarray),
                             (port_pfft, port_plan, to_torch)):
        sched = plan.SegmentSchedule.homogeneous(plan.PlanConfig(real=True), 8, [4, 4])
        with pytest.raises(ValueError, match="not both"):
            pfft.segment_row_rffts(conv(x), [4, 4], schedule=sched,
                                   config=plan.PlanConfig(real=True))
        with pytest.raises(ValueError, match="distribution sums to 7"):
            pfft.segment_row_rffts(conv(x), [4, 3])


LIMB_CONFIGS = {"real": {}, "radix2": {"radix": 2}, "radix4": {"radix": 4},
                "fused": {"fused": True}}


def _limb_inputs(n, seed):
    ref_fpms, port_fpms = both_fpms(n, p=3, seed=seed)
    return real_signal(seed + n, n, n), ref_fpms, port_fpms


@pytest.mark.parametrize("n", [32, 64, 96])
@pytest.mark.parametrize("cfg", sorted(LIMB_CONFIGS))
@pytest.mark.parametrize("entry", ["limb", "lb", "fpm", "fpm_pad"])
def test_real_limbs_and_entry_points_match_reference(n, cfg, entry):
    x, ref_fpms, port_fpms = _limb_inputs(n, 3)
    kw = dict(LIMB_CONFIGS[cfg], real=True)
    ref_cfg, port_cfg = ref_plan.PlanConfig(**kw), port_plan.PlanConfig(**kw)
    jx, tx = jnp.asarray(x), to_torch(x)
    if entry == "limb":
        d = ref_core.partition_rows(n, ref_fpms, 0.05).d
        want = ref_pfft._rpfft_limb(jx, d, config=ref_cfg)
        got = port_pfft._rpfft_limb(tx, d, config=port_cfg)
    elif entry == "lb":
        want = ref_core.rpfft_lb(jx, 3, config=ref_cfg)
        got = port_core.rpfft_lb(tx, 3, config=port_cfg)
    elif entry == "fpm":
        want, pa = ref_core.rpfft_fpm(jx, ref_fpms, config=ref_cfg, return_partition=True)
        got, pb = port_core.rpfft_fpm(tx, port_fpms, config=port_cfg, return_partition=True)
        np.testing.assert_array_equal(pb.d, pa.d)
    else:
        ref_fpms, port_fpms = both_padding_fpms(n)
        want, pa, pads_a = ref_core.rpfft_fpm_pad(jx, ref_fpms, config=ref_cfg,
                                                  return_partition=True)
        got, pb, pads_b = port_core.rpfft_fpm_pad(tx, port_fpms, config=port_cfg,
                                                  return_partition=True)
        np.testing.assert_array_equal(pb.d, pa.d)
        np.testing.assert_array_equal(pads_b, pads_a)
        assert (pads_b > n).any() and not (pads_b % 2).any()
    assert got.shape == (n, n // 2 + 1) and got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4 * n)
    if entry in ("limb", "lb", "fpm"):
        np.testing.assert_allclose(to_numpy(got), np.fft.rfft2(x), atol=2e-4 * n)


def test_rpfft_fpm_pad_equals_the_complex_half_spectrum():
    """Padded real == padded complex, bin for bin: the even pads and the
    prefix clip put every spectral row on the processor (and length) that
    owns it in the complex path."""
    n = 64
    x = real_signal(8, n, n)
    _, port_fpms = both_padding_fpms(n)
    real = port_core.rpfft_fpm_pad(to_torch(x), port_fpms)
    cplx = port_core.pfft_fpm_pad(to_torch(x.astype(np.complex64)), port_fpms)
    np.testing.assert_allclose(to_numpy(real), to_numpy(cplx)[:, :n // 2 + 1],
                               atol=2e-4 * n)


@pytest.mark.parametrize("case", ["czt", "complex", "non-square", "both"])
def test_real_limb_errors_like_reference(case):
    x = real_signal(0, 8, 8)
    for pfft, plan, conv in ((ref_pfft, ref_plan, jnp.asarray),
                             (port_pfft, port_plan, to_torch)):
        with pytest.raises(ValueError):
            if case == "czt":
                plan.PlanConfig(real=True, pad="czt")
            elif case == "complex":
                pfft._rpfft_limb(conv(x.astype(np.complex64)), [4, 4])
            elif case == "non-square":
                pfft._rpfft_limb(conv(x[:4]), [2, 2])
            else:
                sched = plan.SegmentSchedule.homogeneous(
                    plan.PlanConfig(real=True), 8, [4, 4])
                pfft._rpfft_limb(conv(x), [4, 4], schedule=sched,
                                 config=plan.PlanConfig(real=True))


# ----------------------------------------------------------------- plans

def real_plans(n, method, config, *, p=3, dtype="float32"):
    ref_fpms, port_fpms = (both_padding_fpms(n) if method == "rfft-fpm-pad"
                           else both_fpms(n, p=p))
    ref_cfg, port_cfg = configs(config)
    a = ref_core.plan_pfft(n, p=p, fpms=ref_fpms, method=method, dtype=dtype,
                           config=ref_cfg)
    b = port_core.plan_pfft(n, p=p, fpms=port_fpms, method=method, dtype=dtype,
                            config=port_cfg, device="cpu")
    return a, b


def same_plan(a, b):
    np.testing.assert_array_equal(a.d, b.d)
    if a.pad_lengths is None:
        assert b.pad_lengths is None
    else:
        np.testing.assert_array_equal(a.pad_lengths, b.pad_lengths)
    assert a.schedule.to_dict() == b.schedule.to_dict()
    assert a.config.to_dict() == b.config.to_dict()
    assert a.tuning["source"] == b.tuning["source"]
    assert (a.n, a.method, a.dtype) == (b.n, b.method, b.dtype)


@pytest.mark.parametrize("n", [32, 64, 96])
@pytest.mark.parametrize("method", ["rfft-lb", "rfft-fpm", "rfft-fpm-pad"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_real_plan_execute_matches_reference(n, method, config):
    a, b = real_plans(n, method, config)
    same_plan(a, b)
    assert b.config.real and all(e.config.real for e in b.schedule)
    x = real_signal(n + 5, n, n)
    want = np.asarray(a.execute(jnp.asarray(x)))
    got = b.execute(to_torch(x))
    assert got.shape == (n, n // 2 + 1) and got.device.type == "cpu"
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    if method != "rfft-fpm-pad":
        np.testing.assert_allclose(to_numpy(got), np.fft.rfft2(x), atol=2e-4 * n)


def test_real_plan_padded_model_pads_and_matches_the_complex_plan():
    n = 64
    a, b = real_plans(n, "rfft-fpm-pad", "kernel")
    assert (b.pad_lengths > n).any()
    _, port_fpms = both_padding_fpms(n)
    cplx = port_core.plan_pfft(n, p=3, fpms=port_fpms, method="fpm-pad",
                               config=port_plan.PlanConfig(radix=4), device="cpu")
    x = real_signal(1, n, n)
    np.testing.assert_allclose(
        to_numpy(b.execute(to_torch(x))),
        to_numpy(cplx.execute(to_torch(x.astype(np.complex64))))[:, :n // 2 + 1],
        atol=2e-4 * n)


@pytest.mark.parametrize("method,dtype", [("rfft-lb", "complex64"),
                                          ("rfft-fpm", "complex128"),
                                          ("lb", "float32"), ("fpm", "float64")])
def test_real_plan_dtype_validation_both_ways(method, dtype):
    ref_fpms, port_fpms = both_fpms(8, p=2)
    with pytest.raises(ValueError) as want:
        ref_core.plan_pfft(8, p=2, fpms=ref_fpms, method=method, dtype=dtype)
    with pytest.raises(ValueError) as got:
        port_core.plan_pfft(8, p=2, fpms=port_fpms, method=method, dtype=dtype,
                            device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", ["rfft-lb", "rfft-fpm-pad"])
def test_real_plan_explicit_config_is_real_flagged(method):
    a, b = real_plans(32, method, "kernel")
    same_plan(a, b)
    assert b.config.real and b.config.radix == 4
    assert b.tuning["source"] == "explicit"
    assert b.config.pad == ("fpm" if method == "rfft-fpm-pad" else "none")


def test_real_plan_with_complex_schedule_upcasts_and_crops():
    """A complex-family schedule handed to a real plan runs the complex limb
    on the upcast signal and crops to the same half spectrum."""
    n = 32
    a, b = real_plans(n, "rfft-fpm", "library")
    ref_s = ref_plan.SegmentSchedule.homogeneous(ref_plan.PlanConfig(radix=4), n, a.d)
    port_s = port_plan.SegmentSchedule.homogeneous(port_plan.PlanConfig(radix=4), n, b.d)
    a2, b2 = a.with_schedule(ref_s), b.with_schedule(port_s)
    assert not b2.config.real and b2.schedule.to_dict() == a2.schedule.to_dict()
    x = real_signal(4, n, n)
    got = b2.execute(to_torch(x))
    assert got.shape == (n, n // 2 + 1) and got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), np.asarray(a2.execute(jnp.asarray(x))),
                               atol=2e-4 * n)
    np.testing.assert_allclose(to_numpy(got), np.fft.rfft2(x), atol=2e-4 * n)
    # ... and back to a real-family schedule: the real limb again.
    b3 = b2.with_schedule(b.schedule)
    assert isinstance(b3._groups, tuple)
    np.testing.assert_allclose(to_numpy(b3.execute(to_torch(x))), to_numpy(got),
                               atol=2e-4 * n)


def test_real_plan_builds_both_phases_groups_once():
    """lb over 4 processors at N = 8192: phase 2 covers d2 = [2048, 2048, 1,
    0], one group (one launch) per phase; the index tensors are made at
    planning and reused by every execute."""
    plan = port_core.plan_pfft(8192, p=4, method="rfft-lb", dtype="float32",
                               config=port_plan.PlanConfig(radix=4), device="cpu")
    g1, g2 = plan._groups
    assert len(g1) == 1 and len(g2) == 1 and len(g2[0][2]) == 4097
    np.testing.assert_array_equal(port_pfft.halfspec_distribution(plan.d, 4097),
                                  [2048, 2048, 1, 0])
    small = port_core.plan_pfft(32, p=3, method="rfft-lb", dtype="float32",
                                device="cpu")
    before = [g[3] for phase in small._groups for g in phase]
    small.execute(to_torch(real_signal(0, 32, 32)))
    assert all(x is y for x, y in zip(before, (g[3] for phase in small._groups
                                               for g in phase)))


@pytest.mark.parametrize("config", ["library", "kernel", "fused"])
def test_real_plan_batch_matches_reference(config):
    n = 32
    a, b = real_plans(n, "rfft-lb", config)
    x = real_signal(9, 2, n, n)
    got = b.execute(to_torch(x))
    assert got.shape == (2, n, n // 2 + 1)
    np.testing.assert_allclose(to_numpy(got), np.asarray(a.execute(jnp.asarray(x))),
                               atol=2e-4 * n)


def test_real_plan_execute_many():
    n = 32
    a, b = real_plans(n, "rfft-fpm", "kernel")
    xs = [real_signal(s, n, n) for s in range(3)]
    got = b.execute_many(xs, pad_to=4)
    want = a.execute_many([jnp.asarray(x) for x in xs], pad_to=4)
    assert len(got) == 3
    for g, w, x in zip(got, want, xs):
        assert isinstance(g, np.ndarray) and g.shape == (n, n // 2 + 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4 * n)
        np.testing.assert_allclose(g, np.fft.rfft2(x), atol=2e-4 * n)


@pytest.mark.parametrize("kwargs,names", [({"mesh": object()}, "distributed")])
def test_real_methods_keep_later_slices_not_implemented(kwargs, names):
    with pytest.raises(NotImplementedError, match=names):
        port_core.plan_pfft(8, p=2, method="rfft-lb", dtype="float32",
                            device="cpu", **kwargs)


# ----------------------------------------------------- one-shot rfft2/irfft2

@pytest.mark.parametrize("n", [8, 15, 16, 33])
@pytest.mark.parametrize("p", [1, 3])
def test_core_rfft2_and_irfft2_match_reference(n, p):
    x = real_signal(n * p, n, n)
    want = np.asarray(ref_core.rfft2(jnp.asarray(x), p=p))
    got = port_core.rfft2(to_torch(x), p=p)
    assert got.shape == (n, n // 2 + 1) and got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    back = port_core.irfft2(got, n=n)
    np.testing.assert_allclose(to_numpy(back),
                               np.asarray(ref_core.irfft2(jnp.asarray(want), n=n)),
                               atol=1e-4)
    np.testing.assert_allclose(to_numpy(back), x, atol=1e-4)


def test_core_rfft2_float64_plans_float64_and_refuses_non_square():
    x = to_torch(real_signal(0, 16, 16)).double()
    got = port_core.rfft2(x)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(to_numpy(got), np.fft.rfft2(to_numpy(x)), atol=1e-9)
    with pytest.raises(ValueError, match="square"):
        port_core.rfft2(torch.ones((4, 8)))


def test_core_rfft2_of_a_host_array_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_core.rfft2(real_signal(0, 8, 8))
