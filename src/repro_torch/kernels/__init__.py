"""CUDA kernels for the paper's compute hot spots (the row FFT and the fused
row FFT -> transposed write), each with an op wrapper, a plain PyTorch version
and a launch count.  The kernels are compiled at their first launch on a CUDA
tensor (``_build``); importing this package builds and probes nothing."""

from repro_torch.kernels.fft import kernel as _fft_kernel
from repro_torch.kernels.fft.ops import fft_rows_op
from repro_torch.kernels.fused import kernel as _fused_kernel
from repro_torch.kernels.fused.ops import fft_rows_transpose_op

__all__ = ["fft_rows_op", "fft_rows_transpose_op", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"fft_rows": _fft_kernel.launch_count(),
            "fft_rows_transpose": _fused_kernel.launch_count()}


def reset_launch_counts() -> None:
    _fft_kernel.reset_launch_count()
    _fused_kernel.reset_launch_count()
