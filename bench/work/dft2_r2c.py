"""Work of a 2-D DFT of a stack of real float32 N x N signals into their
N x (N/2+1) complex64 half spectra, from the shapes alone: each input byte
read once, each output byte written once, and half the complex transform's
5·N²·log2(N²) operations a signal."""

import math


def work(n: int, batch: int) -> tuple[float, float]:
    """(bytes, operations) of one request."""
    points = n * n
    nbytes = points * 4 + n * (n // 2 + 1) * 8
    return batch * nbytes, batch * 2.5 * points * math.log2(points)
