"""The plain reference of the 2-D DFT, and the comparison that decides
``correct``.

Plain PyTorch, independent of the program and of ``torch.fft``: the DFT
along a row is a four-step product with DFT matrices (n = n1·n2, rows of
n1 points, a twiddle, rows of n2 points, recursively down to 256 points),
on (real, imaginary) pairs.  In float64 it is the reference; in bfloat16
(bfloat16 operands and results, float32 accumulation inside each product)
it is the control, the step below the float32 that the configurations
state.

The 2-D transform is laid out as the program lays it out: ``(n, n)`` for a
complex signal, the ``(n, n//2+1)`` half spectrum for a real one.  It runs
in blocks of rows, then of columns, so that it fits beside the answers
being judged.
"""

from __future__ import annotations

import math
from typing import Iterator

import torch

__all__ = ["Dft", "NUMBERS", "compare", "control"]

# The numbers compared, each against a limit of its own: the relative L2
# error over a whole answer, and the largest error of one point over the
# reference's root mean square.
NUMBERS = ("rel_l2", "max_rel")
_DIRECT = 256          # rows up to this length: one product with F_n
_BLOCK = 1 << 24       # points a block of rows or columns


class Dft:
    """Row DFTs in one precision, on one device; keeps its matrices."""

    def __init__(self, dtype: torch.dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        self._tables: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def _table(self, rows: int, cols: int, n: int):
        """exp(-2πi·j·k/n) for j < rows, k < cols, from exact integer
        products, rounded once to the working precision."""
        key = (rows, cols, n)
        if key not in self._tables:
            j = torch.arange(rows, dtype=torch.int64, device=self.device)
            k = torch.arange(cols, dtype=torch.int64, device=self.device)
            angle = (torch.outer(j, k) % n).to(torch.float64) * (2 * math.pi / n)
            self._tables[key] = (torch.cos(angle).to(self.dtype),
                                 (-torch.sin(angle)).to(self.dtype))
        return self._tables[key]

    @staticmethod
    def _product(ar, ai, br, bi):
        """(ar + i·ai) @ (br + i·bi); ``ai`` may be None (a real operand)."""
        if ai is None:
            return ar @ br, ar @ bi
        return ar @ br - ai @ bi, ar @ bi + ai @ br

    def rows(self, re: torch.Tensor, im: torch.Tensor | None):
        """The DFT along the last axis of ``re + i·im`` (``im`` None for
        real rows), as (real, imaginary)."""
        n = re.shape[-1]
        n1 = max((d for d in range(1, math.isqrt(n) + 1) if n % d == 0))
        if n <= _DIRECT or n1 == 1:
            fr, fi = self._table(n, n, n)
            return self._product(re, im, fr, fi)
        n2 = n // n1
        lead = re.shape[:-1]

        def split(x):               # x[n2·j1 + j2] -> rows (j2) of n1 points
            return (None if x is None else
                    x.reshape(-1, n1, n2).transpose(1, 2).contiguous())
        ar, ai = self.rows(split(re), split(im))            # (R, j2, k1)
        wr, wi = self._table(n2, n1, n)
        ar, ai = ar * wr - ai * wi, ar * wi + ai * wr
        br, bi = self.rows(ar.transpose(1, 2).contiguous(),
                           ai.transpose(1, 2).contiguous())  # (R, k1, k2)
        # X[k1 + n1·k2]: k2 outer
        return (br.transpose(1, 2).reshape(lead + (n,)),
                bi.transpose(1, 2).reshape(lead + (n,)))

    def columns(self, x: torch.Tensor) -> Iterator[tuple[int, int, torch.Tensor,
                                                         torch.Tensor]]:
        """The 2-D DFT of one ``(n, n)`` signal, column block by column
        block: ``(c0, c1, re, im)`` with ``re + i·im`` the transpose of the
        answer's columns ``c0:c1``."""
        n = x.shape[-1]
        width = n // 2 + 1 if not x.is_complex() else n
        yr = torch.empty((n, width), dtype=self.dtype, device=self.device)
        yi = torch.empty_like(yr)
        step = max(1, _BLOCK // n)
        for r0 in range(0, n, step):
            block = x[r0:r0 + step].to(self.device)
            re = (block.real if block.is_complex() else block).to(self.dtype)
            im = block.imag.to(self.dtype) if block.is_complex() else None
            ar, ai = self.rows(re, im)
            yr[r0:r0 + step] = ar[:, :width]
            yi[r0:r0 + step] = ai[:, :width]
            del ar, ai
        for c0 in range(0, width, step):
            c1 = min(width, c0 + step)
            zr, zi = self.rows(yr[:, c0:c1].T.contiguous(),
                               yi[:, c0:c1].T.contiguous())
            yield c0, c1, zr, zi


def _signals(x: torch.Tensor):
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def compare(x: torch.Tensor, answer: torch.Tensor) -> dict[str, float]:
    """The numbers of ``NUMBERS`` for the program's ``answer`` to the
    request ``x`` (a stack of signals), each the worst over the stack, set
    to infinity where the answer is missing, misshapen or not finite."""
    n = x.shape[-1]
    width = n if x.is_complex() else n // 2 + 1
    bad = {name: math.inf for name in NUMBERS}
    if (not isinstance(answer, torch.Tensor) or not answer.is_complex()
            or tuple(answer.shape) != tuple(x.shape[:-1]) + (width,)):
        return bad
    ref = Dft(torch.float64, x.device)
    worst = {name: 0.0 for name in NUMBERS}
    for sig, ans in zip(_signals(x), answer.reshape((-1, n, width))):
        diff2 = ref2 = peak = torch.zeros((), dtype=torch.float64, device=x.device)
        for c0, c1, zr, zi in ref.columns(sig):
            got = ans[:, c0:c1].T
            dr = got.real.to(torch.float64) - zr
            di = got.imag.to(torch.float64) - zi
            err2 = dr * dr + di * di
            diff2 = diff2 + err2.sum()
            ref2 = ref2 + (zr * zr + zi * zi).sum()
            peak = torch.maximum(peak, err2.max())
        diff2, ref2, peak = float(diff2), float(ref2), float(peak)
        rms = math.sqrt(ref2 / (n * width))
        got = {"rel_l2": math.sqrt(diff2 / ref2) if ref2 > 0 else math.inf,
               "max_rel": math.sqrt(peak) / rms if rms > 0 else math.inf}
        for name, value in got.items():
            worst[name] = max(worst[name], value if math.isfinite(value) else math.inf)
    return worst


def control(x: torch.Tensor) -> torch.Tensor:
    """The reference in bfloat16, in the program's place: the answer to
    ``x`` as complex64, laid out as the program lays it out."""
    n = x.shape[-1]
    width = n if x.is_complex() else n // 2 + 1
    low = Dft(torch.bfloat16, x.device)
    out = torch.empty(tuple(x.shape[:-1]) + (width,), dtype=torch.complex64,
                      device=x.device)
    for sig, o in zip(_signals(x), out.reshape((-1, n, width))):
        for c0, c1, zr, zi in low.columns(sig):
            o[:, c0:c1] = torch.complex(zr.float(), zi.float()).T
    return out
