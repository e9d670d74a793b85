"""Work of a 2-D DFT of a stack of complex64 N x N signals, from its shapes
alone, so it reads the same whatever kernels compute it: each input byte
read once, each output byte written once, and 5·N²·log2(N²) operations a
signal (the radix-2 count)."""

import math


def work(n: int, batch: int) -> tuple[float, float]:
    """(bytes, operations) of one request."""
    points = n * n
    return batch * points * (8 + 8), batch * 5.0 * points * math.log2(points)
