"""Padding-length selection (paper §III-D, PFFT-FPM-PAD Step 2).

    N_padded = argmin_{y in (N, y_m]}  d_i * y / s_i(d_i, y)
               subject to  t(d_i, y) < t(d_i, N)

i.e. pick the row length > N with the minimal predicted execution time for
this processor's assigned row count d_i, provided it beats the unpadded time;
otherwise pad length is 0 (N_padded = N).  The decision is *local to each
abstract processor* — different processors may pad differently.

Without a measured FPM the fast sizes are taken to be (a) FFT lengths that
avoid the library's Bluestein path (smooth sizes, ideally powers of two) and
(b) minor dimensions aligned to ``lane`` elements.  ``smooth_candidates``
generates that candidate set, and ``pad_to_smooth`` pads by it.  ``lane=128``
is kept as the default argument so that both packages pick the same lengths;
it is the reference accelerator's lane width, not a property of a GPU, and is
to be revisited by measurement (128 complex64 elements are 1 KiB, a multiple
of every alignment a GPU cares about, so the default is harmless meanwhile).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fpm import SpeedFunction, fft_flops

__all__ = ["determine_pad_length", "smooth_candidates", "pad_to_smooth", "is_smooth"]


def determine_pad_length(fpm: SpeedFunction, d_i: int, n: int) -> int:
    """Return N_padded (== n when no beneficial padding exists)."""
    if d_i <= 0:
        return n
    t_base = fpm.time_at(d_i, n)
    ys = fpm.ys[fpm.ys > n]
    best_y, best_t = n, t_base
    for y in ys:
        t = fpm.time_at(d_i, int(y))
        if t < best_t:
            best_t, best_y = t, int(y)
    return best_y


def is_smooth(n: int, primes=(2, 3, 5)) -> bool:
    """True if n factors entirely over ``primes`` (library-fast FFT length)."""
    if n < 1:
        return False
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def smooth_candidates(n: int, *, lane: int = 128, limit_ratio: float = 2.0) -> np.ndarray:
    """Ascending candidate padded sizes >= n: lane-aligned *and* smooth,
    capped at ``limit_ratio * n``.  Always contains the next power of two."""
    cap = int(limit_ratio * n) + 1
    out = set()
    npow2 = 1 << int(np.ceil(np.log2(max(n, 1))))
    out.add(max(npow2, lane))
    k = ((n + lane - 1) // lane) * lane
    while k <= cap:
        if is_smooth(k // np.gcd(k, lane) * (lane // np.gcd(k, lane))) or is_smooth(k):
            out.add(k)
        k += lane
    return np.array(sorted(v for v in out if v >= n), dtype=np.int64)


def pad_to_smooth(n: int, *, lane: int = 128) -> int:
    """Model-free fallback: smallest lane-aligned smooth size >= n."""
    cands = smooth_candidates(n, lane=lane)
    return int(cands[0]) if len(cands) else n


def predicted_time(fpm: SpeedFunction, d_i: int, y: int) -> float:
    """Predicted execution time of d_i rows of length y under this FPM."""
    if d_i <= 0:
        return 0.0
    s = fpm.speed_at(d_i, y)
    return float(fft_flops(d_i, y) / s) if np.isfinite(s) and s > 0 else float("inf")
