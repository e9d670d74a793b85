"""The plain reference against ``numpy.fft`` at small n, the comparison's
numbers, and the control: the reference in bfloat16 in the program's place
fails every cell's limits."""

import math

import numpy as np
import pytest
import torch

from bench import registry
from bench.checks import dft2

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def _full(x, dtype=torch.float64):
    """The reference's whole 2-D answer to one signal, as complex128."""
    n = x.shape[-1]
    width = n if x.is_complex() else n // 2 + 1
    out = torch.empty((n, width), dtype=torch.complex128)
    for c0, c1, zr, zi in dft2.Dft(dtype, "cpu").columns(x):
        out[:, c0:c1] = torch.complex(zr.double(), zi.double()).T
    return out.numpy()


@pytest.mark.parametrize("n", [2, 8, 96, 256, 512, 1024])
def test_reference_complex_against_numpy(n):
    x = torch.randn((n, n), dtype=torch.complex64, generator=torch.Generator().manual_seed(n))
    want = np.fft.fft2(x.numpy().astype(np.complex128))
    assert np.abs(_full(x) - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", [2, 8, 64, 512, 1024])
def test_reference_real_against_numpy(n):
    x = torch.randn((n, n), generator=torch.Generator().manual_seed(n))
    want = np.fft.rfft2(x.numpy().astype(np.float64))
    assert np.abs(_full(x) - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", [4, 64, 1024])
def test_rows_against_numpy(n):
    d = dft2.Dft(torch.float64, "cpu")
    x = np.random.default_rng(n).standard_normal((3, n)) + 0j
    re, im = d.rows(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    assert np.abs((re + 1j * im).numpy() - np.fft.fft(x)).max() <= 1e-12 * n


@pytest.mark.parametrize("real", [False, True])
def test_compare_reads_rounding_as_rounding(real):
    b, n = 3, 32
    x = torch.randn((b, n, n), dtype=torch.float32 if real else torch.complex64)
    want = (np.fft.rfft2 if real else np.fft.fft2)(x.numpy().astype(np.float64 if real else np.complex128))
    got = dft2.compare(x, torch.from_numpy(want.astype(np.complex64)))
    assert 0 < got["rel_l2"] < 1e-7 and 0 < got["max_rel"] < 1e-6


def test_compare_reads_a_permuted_view():
    """A batch answer may be a strided view, as the fused plan returns it."""
    b, n = 4, 16
    x = torch.randn((b, n, n), dtype=torch.complex64)
    want = torch.from_numpy(np.fft.fft2(x.numpy()).astype(np.complex64))
    view = want.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    assert not view.is_contiguous()
    assert dft2.compare(x, view)["rel_l2"] < 1e-7


@pytest.mark.parametrize("fault", ["none", "shape", "dtype", "nan", "one_point",
                                   "one_signal", "conjugate"])
def test_compare_catches(fault):
    b, n = 2, 16
    x = torch.randn((b, n, n), dtype=torch.complex64)
    ans = torch.from_numpy(np.fft.fft2(x.numpy()).astype(np.complex64))
    if fault == "shape":
        ans = ans[0]
    elif fault == "dtype":
        ans = ans.real
    elif fault == "nan":
        ans[1, 3, 4] = float("nan")
    elif fault == "one_point":
        ans[0, 5, 5] += 0.01 * ans.abs().mean()
    elif fault == "one_signal":
        ans[1] = 0
    elif fault == "conjugate":
        ans = ans.conj()
    got = dft2.compare(x, ans)
    if fault == "none":
        assert got["rel_l2"] < 1e-6
    else:
        assert not (got["rel_l2"] <= 1e-5 and got["max_rel"] <= 1e-4)
    if fault in ("shape", "dtype", "nan"):
        assert got == {"rel_l2": math.inf, "max_rel": math.inf}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_control_fails_every_cell(cell, seed):
    """bfloat16 in the program's place, at a size a test run holds: at
    least one number over the cell's limit."""
    limits = registry.data("limits", cell)
    config = registry.config(registry.benchmark(), registry.workload(
        registry.benchmark(), cell)["config"])
    dtype = {"complex64": torch.complex64, "float32": torch.float32}[config["dtype"]]
    x = torch.randn((2, 128, 128), dtype=dtype,
                    generator=torch.Generator().manual_seed(seed))
    got = dft2.compare(x, dft2.control(x))
    assert any(got[k] > limits[k] for k in dft2.NUMBERS)
    assert got["rel_l2"] > 1e-3
