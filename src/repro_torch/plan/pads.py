"""Pad-length selection shared by the plan API and the algorithm layer.

Before this module, ``core/api.py::plan_pfft`` and
``core/pfft.py::pfft_fpm_czt`` each re-implemented the same
``smooth_candidates`` + ``time_at`` argmin loop (and the FPM-PAD pad
vector was built inline in both).  These helpers are the single home for
both decisions:

* ``fpm_pad_lengths`` — paper Alg. 7 Step 2 per processor: the FPM-chosen
  ``N_padded_i`` (pad-and-crop semantics).
* ``czt_fft_lengths`` — beyond-paper: the FPM-chosen smooth FFT length
  ``m_i >= 2N-1`` for the exact Bluestein transform of each segment.
* ``rfft_pad_lengths`` — the real-pipeline variant of ``fpm_pad_lengths``
  restricted to *even* padded lengths (the pack-two-rows rfft needs an
  even transform length to keep its half-spectrum crop well defined).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fpm import FPMSet
from repro_torch.core.padding import determine_pad_length, smooth_candidates

__all__ = ["fpm_pad_lengths", "czt_fft_lengths", "rfft_pad_lengths"]


def fpm_pad_lengths(fpms: FPMSet, d: np.ndarray, n: int) -> np.ndarray:
    """Per-processor padded row lengths for PFFT-FPM-PAD (paper §III-D).

    ``result[i] == n`` means no beneficial padding exists for processor i.
    """
    return np.array(
        [determine_pad_length(fpms[i], int(d[i]), n) for i in range(fpms.p)],
        dtype=np.int64,
    )


def czt_fft_lengths(fpms: FPMSet, d: np.ndarray, n: int, *,
                    limit_ratio: float = 2.0) -> np.ndarray:
    """Per-processor Bluestein FFT lengths for PFFT-FPM-CZT.

    Each processor picks the smooth, lane-aligned length ``m >= 2N-1``
    minimising its FPM-predicted time for its ``d[i]`` rows; idle
    processors (``d[i] == 0``) take the smallest candidate.
    """
    cands = smooth_candidates(2 * n - 1, limit_ratio=limit_ratio)

    def best_len(i: int) -> int:
        d_i = int(d[i])
        if d_i == 0:
            return int(cands[0])
        times = [fpms[i].time_at(d_i, int(c)) for c in cands]
        return int(cands[int(np.argmin(times))])

    return np.array([best_len(i) for i in range(fpms.p)], dtype=np.int64)


def rfft_pad_lengths(fpms: FPMSet, d: np.ndarray, n: int) -> np.ndarray:
    """Per-processor padded row lengths for the real FPM-PAD variant.

    Same argmin as ``determine_pad_length`` but only over *even*
    candidate lengths: the rfft half spectrum of an odd-length row has a
    different bin layout, and cropping it back to the first ``n//2+1``
    bins of the length-``n`` transform only matches for even pads.  In
    practice the FPM grid columns are lane-aligned smooth sizes (all
    even), so the restriction rarely binds; ``n`` (no pad) is the
    fallback exactly as in the complex path.
    """
    d = np.asarray(d)

    def best_len(i: int) -> int:
        fpm = fpms[i]
        d_i = int(d[i])
        best_y, best_t = n, fpm.time_at(d_i, n)
        for y in np.asarray(fpm.ys):
            y = int(y)
            if y <= n or y % 2:
                continue
            t = fpm.time_at(d_i, y)
            if t < best_t:
                best_y, best_t = y, t
        return best_y

    return np.array([best_len(i) for i in range(fpms.p)], dtype=np.int64)
