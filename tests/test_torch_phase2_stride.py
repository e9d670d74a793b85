"""The row stride of phase 2's output in the fused limb, on the CPU.

Phase 2 of a fused plan (``core/pfft.py::_fused_phases``) lets K2 and K2b
write their ``(n, rows)`` output at a row stride rounded up to a multiple of
4 elements (``pad_stride=True``), so that at the odd row count of a real
limb (n/2 + 1 a signal) every 32-byte run of the transposed store is a whole
sector.  Here: the stride rule as a function of ``(n, rows)``; the launchers
with the launch recorded in place of the library, with and without the
keyword; and the limb's reshape and permute on a padded phase-2 output,
through a stand-in for the fused phase that returns the plain result inside
a padded buffer, checked against ``torch.fft`` and for sharing that buffer's
storage (no copy).  The kernels themselves run only on the card
(``chip_smoke.py``).  Run alone with ``PYTHONPATH=src JAX_PLATFORMS=cpu
python -m pytest -q tests/test_torch_phase2_stride.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as port_kernels
from repro_torch.core import pfft as port_pfft
from repro_torch.core.api import plan_pfft
from repro_torch.fft import fft2d
from repro_torch.kernels.fused import kernel as port_fused_kernel
from repro_torch.kernels.fused import large as port_fused_large
from repro_torch.kernels.fused.ops import fft_rows_transpose_op
from repro_torch.plan.config import PlanConfig

ROWS = (1, 3, 4, 8193, 16385, 16384)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n", [8192, 1 << 14, 1 << 15, 1 << 17])
def test_padded_out_stride_rounds_rows_up_to_a_sector_from_16384(n, rows):
    """Rows rounded up to a multiple of 4 complex64 (32 bytes) where the
    kernel that serves n takes an output stride (n >= 16384), else rows."""
    stride = port_fused_large.padded_out_stride(n, rows)
    if n < 1 << 14:
        assert stride == rows
    else:
        assert stride % 4 == 0 and rows <= stride < rows + 4
        assert (stride == rows) == (rows % 4 == 0)


def _recorded(monkeypatch):
    """Record the launches of K2 and K2b in place of the library."""
    calls = []
    for module in (port_fused_kernel, port_fused_large):
        monkeypatch.setattr(module, "check_kernel_input", lambda x, name, *a: tuple(x.shape))
        monkeypatch.setattr(module, "launch",
                            lambda fn, x, out, **args: calls.append((fn, out, args)))
    return calls


# (launcher, n, rows, launches a call that write the output)
LAUNCHERS = [
    (port_fused_kernel.fft_rows_transpose_cuda, 1 << 14, 8193, 1),
    (port_fused_kernel.fft_rows_transpose_cuda, 1 << 14, 16384, 1),
    (port_fused_kernel.fft_rows_transpose_cuda, 1 << 14, 3, 1),
    (port_fused_kernel.fft_rows_transpose_cuda, 8192, 4097, 1),
    (port_fused_kernel.fft_rows_transpose_cuda, 1 << 15, 16385, 1),
    (port_fused_large.fft_rows_transpose_cluster_cuda, 1 << 16, 7, 1),
    (port_fused_large.fft_rows_transpose_large_cuda, 1 << 15, 16385, 1),
    (port_fused_large.fft_rows_transpose_large_cuda, 1 << 17, 5, 1),
]


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("launcher,n,rows,writes", LAUNCHERS,
                         ids=[f"{f.__name__}-{n}x{r}" for f, n, r, _ in LAUNCHERS])
def test_launchers_pad_the_stride_only_when_asked(monkeypatch, launcher, n, rows, writes,
                                                 pad):
    """Without the keyword a launcher returns a contiguous ``(n, rows)``
    tensor written at stride ``rows``, as it always did; with it, the first
    ``rows`` columns of an ``(n, padded_out_stride(n, rows))`` buffer the
    kernel wrote at that stride, counted under ``fft_rows_transpose_padded``
    where the stride grew."""
    calls = _recorded(monkeypatch)
    port_kernels.reset_launch_counts()
    x = torch.zeros((rows, n), dtype=torch.complex64)
    out = launcher(x, pad_stride=True) if pad else launcher(x)
    stride = port_fused_large.padded_out_stride(n, rows) if pad else rows
    assert out.shape == (n, rows) and out.stride() == (stride, 1)
    assert out.is_contiguous() == (stride == rows)
    written = [(fn, buf, args) for fn, buf, args in calls if "out_stride" in args]
    assert all(args["out_stride"] == stride for _, _, args in written)
    assert all(buf.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
               for _, buf, _ in written)
    if n >= 1 << 14:
        assert len(written) == writes
    padded = port_kernels.launch_counts()["fft_rows_transpose_padded"]
    assert padded == (writes if stride > rows else 0)
    port_kernels.reset_launch_counts()


def test_cpu_op_ignores_pad_stride():
    """On the CPU the op's plain versions return the dense result whatever
    ``pad_stride`` says, and launch nothing."""
    port_kernels.reset_launch_counts()
    x = torch.randn((9, 64), dtype=torch.complex64)
    out = fft_rows_transpose_op(x, pad_stride=True)
    assert out.shape == (64, 9) and out.is_contiguous()
    torch.testing.assert_close(out, torch.fft.fft(x).T, rtol=1e-5, atol=1e-4)
    assert set(port_kernels.launch_counts().values()) == {0}


def _padding_phase(monkeypatch):
    """Put a stand-in for ``fft_rows_then_transpose`` into the limb: the
    plain result, inside a NaN-filled buffer of padded rows where the call
    asks for ``pad_stride`` (as K2 and K2b at n >= 16384 give it).  Returns
    the record of calls: (pad_stride, buffer)."""
    record = []

    def fused(m, *, radix=None, pad_stride=False, backend=None):
        dense = fft2d.fft_rows_then_transpose(m, radix=radix, backend=backend)
        rows = dense.shape[1]
        stride = port_fused_large.padded_out_stride(1 << 14, rows) if pad_stride else rows
        buf = torch.full((dense.shape[0], stride), complex("nan"), dtype=dense.dtype)
        buf[:, :rows] = dense
        record.append((pad_stride, buf))
        return buf[:, :rows]

    monkeypatch.setattr(port_pfft, "fft_rows_then_transpose", fused)
    return record


@pytest.mark.parametrize("real", [True, False], ids=["rfft-lb", "lb"])
@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_fused_phases_answer_is_a_view_of_the_padded_phase2_buffer(monkeypatch, real,
                                                                   batch):
    """``_fused_phases`` asks phase 2 (only) for a padded stride, and its
    reshape and permute keep the answer a view of phase 2's buffer at every
    batch: the values are the 2-D DFT's, the storage is the buffer's, so no
    copy was made.  A real limb's w·B rows (w = n/2 + 1 odd) are padded
    where B is not a multiple of 4; a complex limb's n·B never are."""
    n = 16
    record = _padding_phase(monkeypatch)
    plan = plan_pfft(n, p=4, method="rfft-lb" if real else "lb", tune="off",
                     config=PlanConfig(radix=4, fused=True),
                     dtype="float32" if real else "complex64", device="cpu")
    gen = np.random.default_rng(batch)
    x = gen.standard_normal((batch, n, n)).astype(np.float32)
    if not real:
        x = (x + 1j * gen.standard_normal((batch, n, n))).astype(np.complex64)
    z = plan.execute(torch.from_numpy(x))
    w = n // 2 + 1 if real else n
    assert [pad for pad, _ in record] == ([True] if real else [False, True])
    buf = record[-1][1]
    assert buf.shape[1] == port_fused_large.padded_out_stride(1 << 14, w * batch)
    assert (buf.shape[1] > w * batch) == (real and batch % 4 != 0)
    assert z.shape == (batch, n, w)
    assert z.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    want = (np.fft.rfft2 if real else np.fft.fft2)(x.astype(np.float64 if real
                                                            else np.complex128))
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-4, atol=1e-3)
    assert torch.equal(z.contiguous(), z) and z.contiguous().is_contiguous()
