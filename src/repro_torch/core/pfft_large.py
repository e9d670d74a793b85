"""Four-step huge-1-D FFT — the EFFT decomposition of one length-N line.

Counterpart of ``repro.core.pfft_large``.  A 1-D transform too long for
one row-FFT dispatch (or one cache) is computed as a tiny 2-D problem: with
N = n1 * n2,

    X[k2 + n2*k1] = sum_{j1, j2} x[j1 + n1*j2]
                    * W_N^{j1*k2} * W_{n1}^{j1*k1} * W_{n2}^{j2*k2}

which is exactly (1) n1 row FFTs of length n2 over the reshaped input,
(2) a pointwise twiddle by W_N^{j1*k2}, (3) n2 row FFTs of length n1,
(4) a transpose-reshape back to one line.  Both row-FFT phases run
through the planner's standard ``_group_row_ffts`` machinery, so the
whole thing is tunable/persistable like every other method in the repo
(wisdom method string ``"pfft1-large"``); under ``radix=4`` each phase
is one launch of the row kernel, whatever the batch.

The twiddle table is built host-side in ``int64`` modular arithmetic
(``(j1*k2) mod N`` before the complex exponential): at N in the tens of
millions the raw product overflows float32's integer range and the
phase error would swamp the transform.  A plan makes the table once, on
its device (``twiddle_table``), and hands it to every call: at N = 2^26
it is 512 MiB of complex64, and copying it per call would cost more than
the transform.  The transposes are explicit contiguous copies, since the
row kernels refuse strided input.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.plan.config import PlanConfig

__all__ = ["four_step_factors", "pfft1_large_apply", "twiddle_table"]

# Elements of the twiddle table one host thread computes at a time.
_TWIDDLE_BLOCK = 1 << 20


def four_step_factors(n: int, *, n1: int | None = None,
                      n2: int | None = None) -> tuple[int, int]:
    """The (n1, n2) factorization the four-step pipeline runs at.

    Defaults to the most-square split (n1 = largest divisor <= sqrt(N)),
    which balances the two row-FFT phases; callers may pin either factor
    (the other is derived) — e.g. to land one phase on a power of two the
    radix kernels accept.  A prime N degenerates to n1 = 1: phase 1 is one
    length-N library FFT and phase 3 is N length-1 FFTs (identity) —
    still correct, just not faster.
    """
    n = int(n)
    if n <= 0:
        raise ValueError(f"pfft1_large needs a positive length, got N={n}")
    if n1 is not None and n2 is not None:
        n1, n2 = int(n1), int(n2)
        if n1 * n2 != n:
            raise ValueError(
                f"four-step factors must multiply to N: {n1}*{n2} != {n}")
        return n1, n2
    if n1 is not None:
        n1 = int(n1)
        if n1 <= 0 or n % n1:
            raise ValueError(f"n1={n1} must divide N={n}")
        return n1, n // n1
    if n2 is not None:
        n2 = int(n2)
        if n2 <= 0 or n % n2:
            raise ValueError(f"n2={n2} must divide N={n}")
        return n // n2, n2
    best = 1
    for f in range(int(n ** 0.5), 0, -1):
        if n % f == 0:
            best = f
            break
    return best, n // best


def _twiddle(n1: int, n2: int) -> np.ndarray:
    """W_N^{j1*k2} table, shape (n1, n2), complex64.

    Host-side numpy with the exponent reduced mod N in int64 *before*
    the complex exponential — see module docstring.  Blocks of rows are
    computed on a thread pool (numpy's ufuncs release the GIL): each
    element is the same expression as in one call over the whole table, so
    the table is the reference's bit for bit, in a fraction of the time
    (2^28 entries, a 16384 x 16384 plan, took 16.7 s in one call on the
    card's host).
    """
    n = n1 * n2
    k2 = np.arange(n2, dtype=np.int64)[None, :]
    out = np.empty((n1, n2), dtype=np.complex64)
    rows = max(1, _TWIDDLE_BLOCK // max(n2, 1))

    def block(lo: int) -> None:
        j1 = np.arange(lo, min(lo + rows, n1), dtype=np.int64)[:, None]
        out[lo:lo + rows] = np.exp(-2j * np.pi * ((j1 * k2) % n) / n)

    starts = range(0, n1, rows)
    if len(starts) == 1:
        block(0)
    else:
        with ThreadPoolExecutor(max_workers=min(len(starts), os.cpu_count() or 1)) as pool:
            list(pool.map(block, starts))
    return out


def twiddle_table(n1: int, n2: int, device: torch.device) -> torch.Tensor:
    """``_twiddle(n1, n2)`` on ``device``: what a plan makes once."""
    return torch.from_numpy(_twiddle(n1, n2)).to(device)


def pfft1_large_apply(x, *, config: PlanConfig | None = None,
                      n1: int | None = None, n2: int | None = None,
                      backend: str | None = None,
                      twiddle: torch.Tensor | None = None) -> torch.Tensor:
    """Length-N lines through the four-step pipeline; returns X[k].

    ``x`` is one line ``(N,)`` or a stack ``(..., N)``: the rows of every
    line go through each phase together, one dispatch per phase.  Complex
    input is transformed as-is, real input is upcast to complex64.  The
    two row-FFT phases honor ``config``'s row-FFT knobs (the kernel
    backends send a phase whose length is not a power of two to the
    library — the standard ``fft_rows`` rule).  ``twiddle`` is
    ``twiddle_table(n1, n2, x.device)`` made ahead (a plan does, once);
    without it the table is made in this call.
    """
    from repro_torch.core.pfft import _group_row_ffts  # lazy: sibling module

    x = as_tensor(x)
    if x.ndim < 1:
        raise ValueError(
            f"pfft1_large transforms 1-D lines, got shape {tuple(x.shape)}")
    n = int(x.shape[-1])
    n1, n2 = four_step_factors(n, n1=n1, n2=n2)
    cfg = config if config is not None else PlanConfig()
    if not x.is_complex():
        x = x.to(torch.complex64)
    if twiddle is None:
        twiddle = twiddle_table(n1, n2, x.device)
    lead = x.shape[:-1]

    # Step 1: n1 rows of length n2.  x[j1 + n1*j2] reshapes to (n2, n1)
    # with j2 as the row index, so the length-n2 lines are the *columns*
    # — transpose first.
    a = x.reshape(lead + (n2, n1)).transpose(-1, -2).contiguous()
    b = _group_row_ffts(a.reshape(-1, n2), n2, n2, cfg, backend)
    # Step 2: pointwise twiddle W_N^{j1*k2}.
    cmat = b.reshape(lead + (n1, n2)) * twiddle.to(b.dtype)
    # Step 3: n2 rows of length n1 (transpose brings k2 to the row index).
    c = cmat.transpose(-1, -2).contiguous()
    e = _group_row_ffts(c.reshape(-1, n1), n1, n1, cfg, backend)
    # Step 4: E[k2, k1] -> X[k2 + n2*k1] is a transpose-reshape.
    return e.reshape(lead + (n2, n1)).transpose(-1, -2).reshape(lead + (n,))
