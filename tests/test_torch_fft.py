"""The ``fft/`` layer of the PyTorch port against the JAX package: the O(N^2)
oracle, the radix-2 Stockham, ``fft_rows`` per backend (with the rule that a
non-power-of-two length goes to the library), the fused phase's eligibility
and ``fft2d_rowcol``.  Same numpy inputs to both, the port on CPU tensors."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import complex_signal, to_numpy, to_torch

import repro.fft as ref_fft
from repro.fft.fft2d import fft_rows as ref_fft_rows

import repro_torch.fft as port_fft
from repro_torch.kernels.fft import ops as port_fft_ops
from repro_torch.kernels.fused import ops as port_fused_ops

# port backend -> the reference's name for the same backend
BACKENDS = {None: None, "torch": "xla", "stockham": "stockham", "cuda": "pallas"}


@pytest.mark.parametrize("n", [1, 5, 8, 12])
def test_dft1d_naive_matches_reference(n):
    x = complex_signal(n, 3, n)
    want = np.asarray(ref_fft.dft1d_naive(jnp.asarray(x)))
    got = port_fft.dft1d_naive(to_torch(x))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-4 * n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x, axis=-1), atol=1e-4 * n)


@pytest.mark.parametrize("axis", [0, -2, -1])
def test_dft1d_naive_axis(axis):
    x = complex_signal(1, 4, 6, 5)
    want = np.asarray(ref_fft.dft1d_naive(jnp.asarray(x), axis=axis))
    got = port_fft.dft1d_naive(to_torch(x), axis=axis)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3)


@pytest.mark.parametrize("shape", [(6, 6), (4, 9)])
def test_dft2d_naive_matches_reference(shape):
    x = complex_signal(2, *shape)
    want = np.asarray(ref_fft.dft2d_naive(jnp.asarray(x)))
    got = port_fft.dft2d_naive(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(x), atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256])
def test_bit_reverse_indices_equal(n):
    np.testing.assert_array_equal(port_fft.bit_reverse_indices(n),
                                  ref_fft.bit_reverse_indices(n))


def test_bit_reverse_indices_rejects_non_pow2():
    with pytest.raises(ValueError, match="power of two"):
        port_fft.bit_reverse_indices(12)


@pytest.mark.parametrize("n", [1, 2, 16, 128])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft1d_stockham_matches_reference(n, inverse):
    x = complex_signal(n + 1, 3, n)
    want = np.asarray(ref_fft.fft1d_stockham(jnp.asarray(x), inverse=inverse))
    got = port_fft.fft1d_stockham(to_torch(x), inverse=inverse)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-4 * n ** 0.5 + 1e-6)


def test_fft1d_stockham_complex128_keeps_precision():
    x = complex_signal(9, 2, 64).astype(np.complex128)
    got = port_fft.fft1d_stockham(to_torch(x))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x, axis=-1), atol=1e-10)


def test_fft1d_stockham_rejects_non_pow2():
    with pytest.raises(ValueError, match="not a power of two"):
        port_fft.fft1d_stockham(torch.ones(12, dtype=torch.complex64))


@pytest.mark.parametrize("backend", [None, "torch", "stockham", "cuda"])
@pytest.mark.parametrize("n", [64, 48])
def test_fft_rows_backends_match_reference(backend, n):
    """n = 48 is not a power of two: every backend hands it to the library,
    in both packages."""
    x = complex_signal(n, 5, n)
    want = np.asarray(ref_fft_rows(jnp.asarray(x), backend=BACKENDS[backend]))
    got = port_fft.fft_rows(to_torch(x), backend=backend)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * n ** 0.5)


@pytest.mark.parametrize("radix", [None, 2, 4])
def test_fft_rows_radix_reaches_the_kernel_op(radix, monkeypatch):
    seen = []
    real_op = port_fft_ops.fft_rows_op
    monkeypatch.setattr(port_fft_ops, "fft_rows_op",
                        lambda m, **kw: seen.append(kw) or real_op(m, **kw))
    x = complex_signal(3, 4, 32)
    want = np.asarray(ref_fft_rows(jnp.asarray(x), backend="pallas", radix=radix))
    got = port_fft.fft_rows(to_torch(x), backend="cuda", radix=radix)
    assert seen == [{"radix": radix}]
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * 32 ** 0.5)


def test_fft_rows_non_pow2_never_reaches_the_kernel_op(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("kernel op called for a non-power-of-two length")
    monkeypatch.setattr(port_fft_ops, "fft_rows_op", boom)
    x = complex_signal(3, 4, 48)
    got = port_fft.fft_rows(to_torch(x), backend="cuda", radix=4)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x, axis=-1), atol=1e-3 * 7)


def test_fft_rows_use_stockham_flag():
    x = complex_signal(4, 3, 16)
    want = np.asarray(ref_fft_rows(jnp.asarray(x), use_stockham=True))
    got = port_fft.fft_rows(to_torch(x), use_stockham=True)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3)


def test_fft_rows_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown row-FFT backend"):
        port_fft.fft_rows(torch.ones((2, 8), dtype=torch.complex64),
                          backend="pallas")


CASES = {
    "eligible": (complex_signal(0, 6, 32), True),
    "batched-3d": (complex_signal(1, 2, 6, 32), False),
    "non-pow2": (complex_signal(2, 6, 24), False),
    "length-1": (complex_signal(3, 6, 1), False),
    "complex128": (complex_signal(4, 6, 32).astype(np.complex128), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fft_rows_then_transpose_eligibility(case, monkeypatch):
    """2-D, power-of-two n > 1, single precision -> the fused op; anything
    else -> the unfused value.  Equal to the reference either way."""
    x, eligible = CASES[case]
    calls = []
    real_op = port_fused_ops.fft_rows_transpose_op
    monkeypatch.setattr(port_fused_ops, "fft_rows_transpose_op",
                        lambda m, **kw: calls.append(kw) or real_op(m, **kw))
    # Without JAX_ENABLE_X64 jnp holds no complex128: compare
    # the wide case with numpy instead of the reference.
    if x.dtype == np.complex128:
        want = np.swapaxes(np.fft.fft(x, axis=-1), -1, -2)
    else:
        want = np.asarray(ref_fft.fft_rows_then_transpose(jnp.asarray(x)))
    got = port_fft.fft_rows_then_transpose(to_torch(x))
    assert bool(calls) == eligible
    assert got.shape == want.shape and got.is_contiguous()
    assert got.dtype == (torch.complex128 if x.dtype == np.complex128
                         else torch.complex64)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * 6)


@pytest.mark.parametrize("backend", ["torch", "stockham"])
def test_fft_rows_then_transpose_other_backends_stay_unfused(backend, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("fused op called for a non-kernel backend")
    monkeypatch.setattr(port_fused_ops, "fft_rows_transpose_op", boom)
    x = complex_signal(5, 6, 32)
    got = port_fft.fft_rows_then_transpose(to_torch(x), backend=backend)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x, axis=-1).T, atol=1e-2)


@pytest.mark.parametrize("n", [16, 64, 24])
@pytest.mark.parametrize("variant", ["plain", "stockham", "fused"])
def test_fft2d_rowcol_matches_reference(n, variant):
    kwargs = {"plain": {}, "stockham": {"use_stockham": True},
              "fused": {"fused": True}}[variant]
    x = complex_signal(n, n, n)
    want = np.asarray(ref_fft.fft2d_rowcol(jnp.asarray(x), **kwargs))
    got = port_fft.fft2d_rowcol(to_torch(x), **kwargs)
    assert got.is_contiguous()
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(x), atol=2e-4 * n)


def test_fft2d_rowcol_batched_leading_dims():
    x = complex_signal(8, 2, 16, 16)
    got = port_fft.fft2d_rowcol(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(x), atol=1e-2)


def test_fft_layer_exports_only_what_exists():
    # fft_rows is public in the port (chip_smoke.py and the examples time it).
    assert set(port_fft.__all__) - {"fft_rows"} <= set(ref_fft.__all__)
    assert set(ref_fft.__all__) <= set(port_fft.__all__)
    for name in port_fft.__all__:
        assert callable(getattr(port_fft, name))
