from repro_torch.kernels.fused.kernel import (fft_rows_transpose_cuda,
                                              fft_rows_transpose_plain)
from repro_torch.kernels.fused.ops import fft_rows_transpose_op

__all__ = ["fft_rows_transpose_cuda", "fft_rows_transpose_plain",
           "fft_rows_transpose_op"]
