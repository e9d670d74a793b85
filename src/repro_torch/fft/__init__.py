from repro_torch.fft.fft1d import fft1d_stockham, bit_reverse_indices
from repro_torch.fft.fft2d import (fft2d_rowcol, fft_rows,
                                   fft_rows_then_transpose, irfft2, rfft2,
                                   rfft_rows, rfft_rows_then_transpose)
from repro_torch.fft.dft_ref import dft1d_naive, dft2d_naive

__all__ = [
    "fft1d_stockham",
    "bit_reverse_indices",
    "fft2d_rowcol",
    "fft_rows",
    "fft_rows_then_transpose",
    "irfft2",
    "rfft2",
    "rfft_rows",
    "rfft_rows_then_transpose",
    "dft1d_naive",
    "dft2d_naive",
]
