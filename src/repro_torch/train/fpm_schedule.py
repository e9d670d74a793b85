"""FPM-guided training-schedule selection — the paper's technique applied
to LM training knobs (counterpart of ``repro.train.fpm_schedule``; numpy
over the port's ``core.fpm`` and ``core.partition``).

The paper's insight: measured speed is a non-monotonic function of problem
size, so the fastest configuration is found from a functional performance
model, not by assuming "bigger/balanced is better".  Applied here to:

* ``choose_schedule``: pick (microbatch size, padded seq len) minimising
  predicted time-per-token from a measured speed function over
  (mb, seq) — the LM analogue of PFFT-FPM-PAD's N -> N_padded;
* ``fpm_batch_partition``: HPOPTA over per-group speed functions to assign
  global-batch rows unevenly across heterogeneous groups (the straggler /
  mixed-fleet case; see runtime.straggler).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core.fpm import FPMSet, SpeedFunction, build_fpm
from repro_torch.core.partition import PartitionResult, partition_rows

__all__ = ["build_step_fpm", "choose_schedule", "fpm_batch_partition"]


def build_step_fpm(timer: Callable[[int, int], float],
                   mb_sizes: Sequence[int], seq_lens: Sequence[int],
                   name: str = "trainer") -> SpeedFunction:
    """timer(mb, seq) -> seconds per step; speed normalised to tokens/s via
    the FPM flop convention (x rows of length y <-> mb sequences of len seq)."""
    return build_fpm(mb_sizes, seq_lens, timer, name=name)


def choose_schedule(fpm: SpeedFunction, tokens_per_device: int,
                    seq_len: int, pad_candidates: Sequence[int]) -> tuple[int, int]:
    """Pick (microbatch, padded_seq) minimising predicted time per *useful*
    token.  Padded positions are waste, hence the seq/pad ratio weighting."""
    best = (int(fpm.xs[0]), seq_len)
    best_tpt = float("inf")
    for mb in fpm.xs:
        mb = int(mb)
        if mb * seq_len > tokens_per_device * max(int(fpm.xs[-1]), 1):
            continue
        for pad in [seq_len, *pad_candidates]:
            if pad < seq_len:
                continue
            t = fpm.time_at(mb, pad)
            if not np.isfinite(t):
                continue
            tpt = t / (mb * seq_len)  # useful tokens only
            if tpt < best_tpt:
                best_tpt, best = tpt, (mb, int(pad))
    return best


def fpm_batch_partition(fpms: FPMSet, global_batch: int, seq_len: int,
                        eps: float = 0.05) -> PartitionResult:
    """Distribute global-batch rows across device groups from their FPMs
    (paper Alg. 2 verbatim, with batch rows in place of matrix rows)."""
    return partition_rows(global_batch, fpms, eps, y=seq_len)
