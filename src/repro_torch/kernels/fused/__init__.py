from repro_torch.kernels.fused.kernel import (fft_rows_transpose_cuda,
                                              fft_rows_transpose_plain)
from repro_torch.kernels.fused.large import (fft_rows_transpose_large_cuda,
                                             fft_rows_transpose_large_plain)
from repro_torch.kernels.fused.ops import fft_rows_transpose_op
from repro_torch.kernels.fused.real import (rfft_rows_transpose_cuda,
                                            rfft_rows_transpose_op,
                                            rfft_rows_transpose_plain)
from repro_torch.kernels.fused.real_large import (rfft_rows_transpose_large_cuda,
                                                  rfft_rows_transpose_large_plain)

__all__ = ["fft_rows_transpose_cuda", "fft_rows_transpose_large_cuda",
           "fft_rows_transpose_large_plain", "fft_rows_transpose_plain",
           "fft_rows_transpose_op", "rfft_rows_transpose_cuda",
           "rfft_rows_transpose_large_cuda", "rfft_rows_transpose_large_plain",
           "rfft_rows_transpose_op", "rfft_rows_transpose_plain"]
