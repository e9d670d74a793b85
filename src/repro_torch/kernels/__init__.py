"""CUDA kernels for the paper's compute hot spots (the row FFT, the fused
row FFT -> transposed write, their packed-real siblings, the four-step
versions of all four for rows too long for one CTA, and the blocked
transpose), each with an op wrapper, a plain PyTorch version and a launch
count.  The kernels are
compiled at their first launch on a CUDA tensor (``_build``); importing this
package builds and probes nothing."""

from repro_torch.kernels.fft import kernel as _fft_kernel
from repro_torch.kernels.fft import large as _large_kernel
from repro_torch.kernels.fft import real as _real_kernel
from repro_torch.kernels.fft import real_large as _real_large_kernel
from repro_torch.kernels.fft.ops import fft_rows_op
from repro_torch.kernels.fft.real import rfft_rows_op
from repro_torch.kernels.fused import kernel as _fused_kernel
from repro_torch.kernels.fused import large as _fused_large_kernel
from repro_torch.kernels.fused import real as _fused_real_kernel
from repro_torch.kernels.fused import real_large as _fused_real_large_kernel
from repro_torch.kernels.fused.ops import fft_rows_transpose_op
from repro_torch.kernels.fused.real import rfft_rows_transpose_op
from repro_torch.kernels.transpose import kernel as _transpose_kernel
from repro_torch.kernels.transpose.ops import transpose_op

__all__ = ["fft_rows_op", "fft_rows_transpose_op", "launch_counts",
           "reset_launch_counts", "rfft_rows_op", "rfft_rows_transpose_op",
           "transpose_op"]

_COUNTED = {"fft_rows": _fft_kernel, "fft_rows_large": _large_kernel,
            "fft_rows_transpose": _fused_kernel,
            "fft_rows_transpose_large": _fused_large_kernel,
            "rfft_rows": _real_kernel, "rfft_rows_large": _real_large_kernel,
            "rfft_rows_transpose": _fused_real_kernel,
            "rfft_rows_transpose_large": _fused_real_large_kernel,
            "transpose": _transpose_kernel}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name;
    ``fft_rows_large_two_pass`` is the share of ``fft_rows_large`` that ran
    the two passes (n > 2^18) instead of the cluster kernel,
    ``fft_rows_large_long`` the share that ran the cluster kernel at n =
    2^17 or 2^18 (rows of 1 and 2 MiB), and
    ``fft_rows_transpose_large_two_pass`` that of
    ``fft_rows_transpose_large`` (n > 65536); ``fft_rows_transpose_16k``,
    ``rfft_rows_16k`` and ``rfft_rows_transpose_16k`` the shares of
    ``fft_rows_transpose``, ``rfft_rows`` and ``rfft_rows_transpose`` that
    ran their kernels of n = 16384 (K2's and K4's cluster kernels, K3's
    persistent one); ``fft_rows_transpose_padded`` the launches of K2 at
    16384 and the calls of K2b's cluster kernel and chunks of its two passes
    that wrote their output at a row stride padded above its rows
    (``pad_stride=True``, rows not a multiple of 4)."""
    counts = {name: module.launch_count() for name, module in _COUNTED.items()}
    counts["fft_rows_large_two_pass"] = _large_kernel.two_pass_launch_count()
    counts["fft_rows_large_long"] = _large_kernel.long_cluster_launch_count()
    counts["fft_rows_transpose_large_two_pass"] = (
        _fused_large_kernel.two_pass_launch_count())
    counts["fft_rows_transpose_16k"] = _fused_kernel.launch_count_16k()
    counts["fft_rows_transpose_padded"] = (_fused_kernel.padded_launch_count()
                                           + _fused_large_kernel.padded_launch_count())
    counts["rfft_rows_16k"] = _real_kernel.launch_count_16k()
    counts["rfft_rows_transpose_16k"] = _fused_real_kernel.launch_count_16k()
    return counts


def reset_launch_counts() -> None:
    for module in _COUNTED.values():
        module.reset_launch_count()
