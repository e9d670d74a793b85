"""Kernel modules of the PyTorch port against the JAX package.

On the CPU the port's ops run the kernels' plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode.  Same numpy inputs to
both.  The CUDA kernels themselves are checked on the card by
``chip_smoke.py``; here the arithmetic they share with the plain versions,
the wrappers' contracts and the launch-shape choices are.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import complex_signal, to_numpy, to_torch

from repro.kernels.fft import kernel as ref_kernel
from repro.kernels.fft.ops import fft_rows_op as ref_fft_rows_op
from repro.kernels.fused.ops import fft_rows_transpose_op as ref_fused_op

from repro_torch import kernels as port_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as port_kernel
from repro_torch.kernels.fft.ops import fft_rows_op, pick_radix
from repro_torch.kernels.fft.ref import fft_rows_ref
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused.ops import fft_rows_transpose_op

PLANE_FNS = {2: ("stockham_planes", "stockham_planes"),
             4: ("stockham_planes_radix4", "stockham_planes_radix4")}


def planes(seed, rows, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, n)).astype(np.float32),
            rng.standard_normal((rows, n)).astype(np.float32))


# ------------------------------------------------------- plain stage loops

@pytest.mark.parametrize("n", [2, 8, 32, 128, 512, 2048])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
def test_stockham_planes_match_reference(n, inverse, radix):
    """Same arithmetic, another library's cos/sin: 1e-4 * sqrt(n)."""
    re, im = planes(n, 4, n)
    ref_name, port_name = PLANE_FNS[radix]
    rre, rim = getattr(ref_kernel, ref_name)(jnp.asarray(re), jnp.asarray(im),
                                             inverse=inverse)
    pre, pim = getattr(port_kernel, port_name)(to_torch(re), to_torch(im),
                                               inverse=inverse)
    tol = 1e-4 * n ** 0.5
    np.testing.assert_allclose(to_numpy(pre), np.asarray(rre), atol=tol)
    np.testing.assert_allclose(to_numpy(pim), np.asarray(rim), atol=tol)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_apply_stockham_matches_reference(radix, inverse):
    re, im = planes(7, 3, 64)
    rre, rim = ref_kernel.apply_stockham(jnp.asarray(re), jnp.asarray(im),
                                         radix=radix, inverse=inverse)
    pre, pim = port_kernel.apply_stockham(to_torch(re), to_torch(im),
                                          radix=radix, inverse=inverse)
    np.testing.assert_allclose(to_numpy(pre), np.asarray(rre), atol=1e-4 * 8)
    np.testing.assert_allclose(to_numpy(pim), np.asarray(rim), atol=1e-4 * 8)


def test_apply_stockham_rejects_radix():
    re, im = planes(0, 2, 8)
    with pytest.raises(ValueError, match="unsupported radix"):
        port_kernel.apply_stockham(to_torch(re), to_torch(im), radix=3)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 32, 128, 2048, 8192])
@pytest.mark.parametrize("radix", [2, 4])
def test_stockham_stage_count_equal(n, radix):
    assert (port_kernel.stockham_stage_count(n, radix)
            == ref_kernel.stockham_stage_count(n, radix))


@pytest.mark.parametrize("args", [(12, 2), (0, 2), (8, 3)])
def test_stockham_stage_count_errors(args):
    with pytest.raises(ValueError):
        ref_kernel.stockham_stage_count(*args)
    with pytest.raises(ValueError):
        port_kernel.stockham_stage_count(*args)


@pytest.mark.parametrize("n", [2, 4, 16, 256])
def test_pick_radix_equal(n):
    from repro.kernels.fft.ops import pick_radix as ref_pick_radix
    assert pick_radix(n) == ref_pick_radix(n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
def test_plain_versions_match_library_oracle(inverse, radix):
    x = to_torch(complex_signal(3, 5, 128))
    want = fft_rows_ref(x, inverse=inverse)
    tol = 1e-3 * 128 ** 0.5
    got = port_kernel.fft_rows_plain(x, inverse=inverse, radix=radix)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), atol=tol)
    got_t = port_fused_kernel.fft_rows_transpose_plain(x, inverse=inverse,
                                                       radix=radix)
    assert got_t.is_contiguous() and got_t.shape == (128, 5)
    np.testing.assert_allclose(to_numpy(got_t), to_numpy(want).T, atol=tol)


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("rows", [1, 3, 8, 13])
@pytest.mark.parametrize("n", [16, 256])
@pytest.mark.parametrize("radix", [None, 2, 4])
def test_fft_rows_op_matches_reference(rows, n, radix):
    x = complex_signal(rows * n, rows, n)
    want = np.asarray(ref_fft_rows_op(jnp.asarray(x), radix=radix))
    got = fft_rows_op(to_torch(x), radix=radix)
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * n ** 0.5)


@pytest.mark.parametrize("rows", [1, 3, 8, 13])
@pytest.mark.parametrize("n", [16, 256])
@pytest.mark.parametrize("radix", [None, 2, 4])
def test_fft_rows_transpose_op_matches_reference(rows, n, radix):
    x = complex_signal(rows * n + 1, rows, n)
    want = np.asarray(ref_fused_op(jnp.asarray(x), radix=radix))
    got = fft_rows_transpose_op(to_torch(x), radix=radix)
    assert got.dtype == torch.complex64 and got.shape == (n, rows)
    assert got.is_contiguous()
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * n ** 0.5)


@pytest.mark.parametrize("op_pair", ["plain", "fused"])
@pytest.mark.parametrize("radix", [2, 4])
def test_ops_inverse_match_reference(op_pair, radix):
    x = complex_signal(11, 6, 64)
    ref_op, port_op = ((ref_fft_rows_op, fft_rows_op) if op_pair == "plain"
                       else (ref_fused_op, fft_rows_transpose_op))
    want = np.asarray(ref_op(jnp.asarray(x), inverse=True, radix=radix))
    got = port_op(to_torch(x), inverse=True, radix=radix)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * 8)


def test_fft_rows_op_roundtrip():
    x = to_torch(complex_signal(5, 7, 32))
    back = fft_rows_op(fft_rows_op(x), inverse=True)
    np.testing.assert_allclose(to_numpy(back), to_numpy(x), atol=2e-3)


def test_fft_rows_op_batched_leading_dims():
    x = complex_signal(2, 2, 3, 32)
    want = np.asarray(ref_fft_rows_op(jnp.asarray(x)))
    got = fft_rows_op(to_torch(x))
    assert got.shape == (2, 3, 32)
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-3)


@pytest.mark.parametrize("dtype,want", [(np.complex64, torch.complex64),
                                        (np.complex128, torch.complex128),
                                        (np.float32, torch.complex64),
                                        (np.float64, torch.complex128)])
def test_ops_compute_in_f32_and_return_result_type(dtype, want):
    """Whatever comes in is transformed in float32 and returned as
    ``result_type(x, complex64)`` — x64 on or off, the reference's rule."""
    x = complex_signal(4, 4, 16)
    x = (x if np.dtype(dtype).kind == "c" else x.real).astype(dtype)
    got = fft_rows_op(to_torch(x))
    got_t = fft_rows_transpose_op(to_torch(x))
    assert got.dtype == want and got_t.dtype == want
    oracle = np.fft.fft(x.astype(np.complex64), axis=-1)
    np.testing.assert_allclose(to_numpy(got), oracle, atol=4e-3)
    np.testing.assert_allclose(to_numpy(got_t), oracle.T, atol=4e-3)


def test_ops_length_one_is_identity():
    x = to_torch(complex_signal(0, 5, 1))
    np.testing.assert_array_equal(to_numpy(fft_rows_op(x)), to_numpy(x))
    np.testing.assert_array_equal(to_numpy(fft_rows_transpose_op(x)),
                                  to_numpy(x).T)


# ----------------------------------------------------------------- errors

def test_ops_reject_non_pow2_like_reference():
    with pytest.raises(ValueError, match="power-of-two length, got 12"):
        ref_fft_rows_op(jnp.ones((4, 12), jnp.complex64))
    with pytest.raises(ValueError, match="power-of-two length, got 12"):
        fft_rows_op(torch.ones((4, 12), dtype=torch.complex64))
    with pytest.raises(ValueError, match="power-of-two length, got 12"):
        fft_rows_transpose_op(torch.ones((4, 12), dtype=torch.complex64))


@pytest.mark.parametrize("shape", [(16,), (2, 4, 16)])
def test_fused_op_rejects_non_2d_like_reference(shape):
    with pytest.raises(ValueError, match="fused op takes a 2-D matrix"):
        ref_fused_op(jnp.ones(shape, jnp.complex64))
    with pytest.raises(ValueError, match="fused op takes a 2-D matrix"):
        fft_rows_transpose_op(torch.ones(shape, dtype=torch.complex64))


@pytest.mark.parametrize("op", [fft_rows_op, fft_rows_transpose_op])
def test_ops_raise_named_error_above_length_limit(op):
    """A power-of-two length above an op's kernels raises, naming the
    length and the top; nothing switches to the library in their place.
    Both ops' top is ``MAX_LARGE_N`` (K1b, K2b), tried on a ``meta``
    tensor, which holds no data: the length is refused before anything is
    computed."""
    top = port_kernel.MAX_LARGE_N
    x = torch.empty((1, 2 * top), dtype=torch.complex64, device="meta")
    with pytest.raises(port_kernel.KernelLengthError,
                       match=f"{2 * top} exceeds the kernel limit {top}"):
        op(x)
    assert issubclass(port_kernel.KernelLengthError, ValueError)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("op", ["fft_rows_op", "fft_rows_transpose_op"])
def test_plain_versions_at_the_longest_row_match_reference(op, inverse):
    """K1 and K2 at n = ``MAX_KERNEL_N`` (``Plan<14>``): the port's ops on
    the CPU (the plain versions) against the reference's (Pallas, interpret
    mode), a few odd rows, ``1e-3·sqrt(n)`` forward, over n inverse."""
    n = port_kernel.MAX_KERNEL_N
    x = complex_signal(5 + inverse, 3, n)
    ref, port = {"fft_rows_op": (ref_fft_rows_op, fft_rows_op),
                 "fft_rows_transpose_op": (ref_fused_op, fft_rows_transpose_op)}[op]
    want = np.asarray(ref(jnp.asarray(x), inverse=inverse))
    got = to_numpy(port(to_torch(x), inverse=inverse))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.sqrt(n) / (n if inverse else 1))


def test_fft_rows_op_takes_rows_longer_than_k1():
    """Above ``MAX_KERNEL_N`` the complex row op goes to K1b and the fused
    op to K2b: on the CPU their plain versions, against the reference's ops
    (Pallas, interpret mode) at ``1e-3·sqrt(n)``."""
    n = 2 * port_kernel.MAX_KERNEL_N
    x = complex_signal(3, 2, n)
    got = to_numpy(fft_rows_op(to_torch(x)))
    want = np.asarray(ref_fft_rows_op(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.sqrt(n))
    got = to_numpy(fft_rows_transpose_op(to_torch(x)))
    want = np.asarray(ref_fused_op(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.sqrt(n))


@pytest.mark.parametrize("op", [fft_rows_op, fft_rows_transpose_op])
def test_ops_refuse_non_contiguous_input(op):
    x = to_torch(complex_signal(1, 16, 16)).T
    with pytest.raises(ValueError, match="contiguous"):
        op(x)
    np.testing.assert_allclose(to_numpy(op(x.contiguous())),
                               to_numpy(op(x.clone(memory_format=torch.contiguous_format))))


@pytest.mark.parametrize("op", [fft_rows_op, fft_rows_transpose_op])
def test_ops_reject_bad_radix(op):
    with pytest.raises(ValueError, match="unsupported radix"):
        op(torch.ones((2, 8), dtype=torch.complex64), radix=8)


@pytest.mark.parametrize("launcher", [port_kernel.fft_rows_cuda,
                                      port_fused_kernel.fft_rows_transpose_cuda])
def test_cuda_launchers_refuse_what_the_kernel_does_not_take(launcher):
    """The launchers never run a plain version: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        launcher(torch.ones((2, 8), dtype=torch.complex64))


@pytest.mark.parametrize("op", [fft_rows_op, fft_rows_transpose_op])
def test_host_arrays_default_to_the_card_and_raise_without_one(op, monkeypatch):
    """Input that is not a tensor goes to the default device, which is the
    CUDA device: without one the call raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        op(complex_signal(0, 4, 8))


# ------------------------------------------------ launch shape, build, counts

@pytest.mark.parametrize("n", [2, 8, 64, 256, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 37, 256, 8192, 100000])
def test_launch_shape_fits_the_card(n, rows):
    """K2's launch shape (``fft_rows_transpose_plan``): K1's rows per CTA
    and threads (K1's plan is tested in ``test_torch_regfft.py``), a grid of
    whole clusters padded by less than one, a cluster where the rows of a
    whole CTA give less than a 32-byte sector per output row (n >= 2048)
    and of as many CTAs as ``STORE_CLUSTER`` rows' worth there, and at
    n >= 4096 one row a CTA in half an SM's shared memory (at 16384 in
    the whole of it)."""
    per_cta, threads, cluster, blocks = port_fused_kernel.fft_rows_transpose_plan(n, rows)
    k1_per_cta, k1_threads, points, _, smem = port_kernel.complex_rows_plan(n, rows)
    assert (per_cta, threads) == (k1_per_cta, k1_threads)
    assert blocks % cluster == 0 and 0 <= blocks * per_cta - rows < cluster * per_cta
    max_rows = max(1, 256 // (n // points))
    assert 1 <= per_cta <= max_rows
    if n >= 2048:
        assert 8 * max_rows < 32 and cluster > 1
        assert cluster * max_rows == port_fused_kernel.STORE_CLUSTER
    else:
        assert 8 * max_rows >= 32 and cluster == 1
    if n >= 4096:
        assert per_cta == 1
        assert smem <= port_kernel.SMEM_BUDGET // (2 if n <= 8192 else 1)


def test_whole_row_limit_is_what_shared_memory_holds():
    """``MAX_KERNEL_N`` is the top of K2's table, ``1 << 14``: every power
    of two up to it in both directions, the register-resident source up to
    half of it and the cluster source (``fft_rows_transpose_cluster.cu``,
    K2b's) at it, nothing above in the register-resident source; and a row
    of that length (one a CTA of 1024 threads) fits an SM's shared memory
    once, not twice, which is why K2 leaves that source there."""
    n = port_kernel.MAX_KERNEL_N
    assert n == 1 << 14
    source = (_build.csrc_dir() / "fft_rows_transpose.cu").read_text()
    top = n.bit_length() - 1
    for e in range(1, top):
        assert f"case 1 << {e}: return launch_dir<{e}>(" in source
    assert f"case 1 << {top}" not in source and f"case 1 << {top + 1}" not in source
    cluster = (_build.csrc_dir() / "fft_rows_transpose_cluster.cu").read_text()
    assert (f"    case 1 << {top}:\n        return inverse ? launch_length<{top}, true>("
            in cluster)
    assert "launch<LOG2N, true>" in source and "launch<LOG2N, false>" in source
    per_cta, threads, _, _, smem = port_kernel.complex_rows_plan(n, 1 << 20)
    assert per_cta == 1 and threads == 1024
    assert smem <= port_kernel.SMEM_BUDGET < 2 * smem


def test_cpu_ops_launch_nothing_and_build_nothing():
    port_kernels.reset_launch_counts()
    x = to_torch(complex_signal(0, 4, 32))
    fft_rows_op(x)
    fft_rows_transpose_op(x)
    assert port_kernels.launch_counts() == {
        "fft_rows": 0, "fft_rows_large": 0, "fft_rows_large_long": 0,
        "fft_rows_large_two_pass": 0,
        "fft_rows_transpose": 0, "fft_rows_transpose_16k": 0,
        "fft_rows_transpose_padded": 0,
        "fft_rows_transpose_large": 0, "fft_rows_transpose_large_two_pass": 0,
        "rfft_rows": 0, "rfft_rows_16k": 0, "rfft_rows_large": 0,
        "rfft_rows_transpose": 0, "rfft_rows_transpose_16k": 0,
        "rfft_rows_transpose_large": 0, "transpose": 0}
    assert _build._library is None  # nothing compiled or loaded by CPU work


def test_kernel_sources_are_plain_cuda_built_for_sm_90a():
    names = [p.name for p in _build.source_files()]
    assert names == ["fft_rows.cu", "fft_rows_cluster.cu", "fft_rows_large.cu",
                     "fft_rows_transpose.cu", "fft_rows_transpose_cluster.cu",
                     "fft_rows_transpose_large.cu", "fourstep.cuh",
                     "fourstep_cluster.cuh", "regfft.cuh",
                     "rfft_rows.cu", "rfft_rows_16k.cu", "rfft_rows_cluster.cuh",
                     "rfft_rows_large.cu", "rfft_rows_transpose.cu",
                     "rfft_rows_transpose_16k.cu", "rfft_rows_transpose_large.cu",
                     "transpose.cu", "tstore.cuh"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    for path in _build.source_files():
        text = path.read_text()
        assert "torch/extension.h" not in text and "__sincosf(" not in text
        assert "stockham_rows" not in text and "stockham.cuh" not in text
        if path.suffix == ".cu":
            # Every row FFT runs regfft.cuh's passes (the fused ones through
            # tstore.cuh, which includes it, the four-step ones through
            # fourstep.cuh, which includes tstore.cuh, or fourstep_cluster.cuh,
            # which includes fourstep.cuh, or rfft_rows_cluster.cuh, which
            # includes fourstep_cluster.cuh); the transpose has none.
            shared = any(f'#include "{h}"' in text
                         for h in ("regfft.cuh", "tstore.cuh", "fourstep.cuh",
                                   "fourstep_cluster.cuh", "rfft_rows_cluster.cuh"))
            assert shared == ("fft" in path.stem)
            assert "Replaces the TPU kernel" in text and "Bound on this card" in text
    assert "sincospif" in (_build.csrc_dir() / "regfft.cuh").read_text()
    assert '#include "regfft.cuh"' in (_build.csrc_dir() / "tstore.cuh").read_text()
    for name in ("fft_rows.cu", "rfft_rows.cu", "rfft_rows_16k.cu"):
        assert '#include "regfft.cuh"' in (_build.csrc_dir() / name).read_text()
    for name in ("fft_rows_transpose.cu", "rfft_rows_transpose.cu", "fourstep.cuh"):
        assert '#include "tstore.cuh"' in (_build.csrc_dir() / name).read_text()
    for name in ("fft_rows_large.cu", "fft_rows_transpose_large.cu", "rfft_rows_large.cu",
                 "rfft_rows_transpose_large.cu"):
        assert '#include "fourstep.cuh"' in (_build.csrc_dir() / name).read_text()
    for name in ("fft_rows_cluster.cu", "fft_rows_transpose_cluster.cu",
                 "rfft_rows_cluster.cuh"):
        assert '#include "fourstep_cluster.cuh"' in (_build.csrc_dir() / name).read_text()
    assert '#include "rfft_rows_cluster.cuh"' in (
        _build.csrc_dir() / "rfft_rows_transpose_16k.cu").read_text()


def test_build_directory_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """A changed source gives another directory, so a stale library is
    never loaded."""
    before = _build._source_hash()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for path in _build.source_files():
        (copy / path.name).write_text(path.read_text())
    monkeypatch.setattr(_build, "csrc_dir", lambda: copy)
    assert _build._source_hash() == before
    (copy / "regfft.cuh").write_text(
        (copy / "regfft.cuh").read_text() + "\n// changed\n")
    assert _build._source_hash() != before
    assert _build.build_root().name == "build"
