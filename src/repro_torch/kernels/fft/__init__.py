from repro_torch.kernels.fft.kernel import (MAX_KERNEL_N, MAX_LARGE_N,
                                            KernelLaunchError,
                                            KernelLengthError, apply_stockham,
                                            fft_rows_cuda, fft_rows_plain,
                                            stockham_planes,
                                            stockham_planes_radix4,
                                            stockham_stage_count)
from repro_torch.kernels.fft.large import (fft_rows_large_cuda,
                                           fft_rows_large_plain)
from repro_torch.kernels.fft.ops import fft_rows_op, pick_radix
from repro_torch.kernels.fft.real import (rfft_rows_cuda, rfft_rows_op,
                                          rfft_rows_plain, unpack_packed_fft)
from repro_torch.kernels.fft.real_large import (rfft_rows_large_cuda,
                                                rfft_rows_large_plain)
from repro_torch.kernels.fft.ref import fft_rows_ref

__all__ = ["MAX_KERNEL_N", "MAX_LARGE_N", "KernelLaunchError", "KernelLengthError",
           "apply_stockham", "fft_rows_cuda", "fft_rows_large_cuda",
           "fft_rows_large_plain", "fft_rows_plain", "fft_rows_op",
           "fft_rows_ref", "pick_radix", "rfft_rows_cuda", "rfft_rows_large_cuda",
           "rfft_rows_large_plain", "rfft_rows_op", "rfft_rows_plain", "stockham_planes", "stockham_planes_radix4",
           "stockham_stage_count", "unpack_packed_fft"]
