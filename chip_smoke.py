#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the ``src/repro_torch`` package beside
this file; it imports nothing of JAX and nothing of the JAX package.  Phases,
each of which ends the run with a non-zero exit code when it fails:

1. ``env``       versions, ``nvcc``, the card's name and power limit, SM count.
2. ``build``     compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. ``kernel_checks`` every kernel against its plain PyTorch version and the
                 library on the card (ragged and odd row counts, every length
                 the row kernels K1-K4 are built for, n = 2 ... 16384, both
                 directions of K1 and K2, ragged clusters of K2 and K4, K2,
                 K3 and K4 at 16384 one launch of their kernels there, the
                 full width, the row blocks of the batched paths 8-10 and of
                 the fused batch; the four-step K1b at 2048 x 32768, 512 x
                 2^17, 256 x 2^18 (its cluster kernel), 128 x 2^19 and 1 x
                 2^24 (its two passes) both ways, and K2b (both ways), K3b
                 and K4b at 2048 x 32768, 512 x 2^17, 1 x 2^24 and 2049 x
                 32768; K2 and K2b at a row stride padded to a multiple of
                 4 at 8193 x 16384, 16385 x 32768 and 513 x 2^17, the
                 padding left as it was, the view equal to the dense call,
                 counted under ``fft_rows_transpose_padded``; the
                 transpose bit for bit); untimed, beside the
                 dry-run worker.
   ``kernels``   each kernel's time beside the plain version's, the library's
                 and the card's bound at the main path's shape (K1-K4 also at
                 4096 x 16384, each ``at_16384`` record with its own source,
                 K2's, K3's and K4's with their launches; K1b-K4b at 2048 x 32768,
                 K1b also at 512 x 2^17 (16-CTA clusters) and 128 x 2^19
                 (two passes), K2b's two passes at 512 x 2^17).
4. ``main_path`` FPMs timed on the card, then ``plan_pfft(...).execute`` for
                 PFFT-LB / PFFT-FPM at N = 8192 and PFFT-FPM-PAD / PFFT-FPM-CZT
                 at N = 8192 (the pow2 pad of 16384 runs K1 at Plan<14>)
                 under the library, kernel and fused configs, PFFT-LB /
                 PFFT-FPM at N = 16384 under the kernel and fused configs, and
                 PFFT-LB at N = 32768 under the kernel config (K1b, an 8 GiB
                 signal) and fused (K2b), each checked against its oracle,
                 with the kernels' launch counts showing which path ran.
5. ``main_path_real`` the same for the real-input methods: ``rfft-lb`` /
                 ``rfft-fpm`` at N = 8192 and ``rfft-fpm-pad`` at N = 8192
                 (K3 at 16384 under ``radix=4``; float32 signals,
                 half-spectrum output), a batch, ``execute_many`` and
                 ``irfft2(rfft2(x))``; ``rfft-lb`` at N = 32768 under
                 ``radix=4`` (K3b, then K1b over 16385 rows) and fused (K4b,
                 K2b), a 4 GiB signal; ``rfft-fpm-pad`` at N = 16384 with a
                 segment padded to 32768 under ``radix=4`` (K3 and K3b, then
                 K1 and K1b), and fused ``rfft-lb`` on the same signal (K4,
                 then K2 over 8193 rows at a padded stride, both their
                 sources at 16384; its answer a view of phase 2's buffer,
                 two kernels on the card), its two phases also timed alone.
6. ``planner``   the single-device planner: ``plan_pfft(tune="estimate")``
                 for ``fpm`` / ``rfft-fpm`` / ``fpm-pad`` at N = 8192,
                 ``tune="measure"`` into a fresh wisdom file for ``lb`` and
                 ``rfft-lb`` at N = 1024 ... 8192 and the padded ``fpm-pad``
                 at N = 8192 (pads up to 16384), each plan executed and
                 checked; the whole candidate pot raced at N = 8192 (complex
                 and real; lb at 1024 ... 4096 too) beside its estimates under the
                 committed and the freshly fitted cost constants; the same
                 plans again from the warm store (no launch while planning)
                 and from a ``PlanCache``; ``fit_cost_params`` of the store.
7. ``microbench_fused`` the reference microbenchmark's fused-vs-unfused pair:
                 ``transpose_op(fft_rows_op(m))`` against
                 ``fft_rows_transpose_op(m)``, the path the blocked transpose
                 kernel lies on.
8. ``pfft3``     ``plan_pfft3(512, p=4)`` on a 512^3 cube under the library and
                 ``radix=4`` (one K1 launch per pass) against
                 ``torch.fft.fftn``; ``pfft3_fpm`` / ``pfft3_fpm_pad`` at 256^3
                 over synthetic FPMs (pads of 2N and 5N/4); a ``tune=
                 "estimate"`` and a ``tune="measure"`` plan; the axis
                 rotations timed.
9. ``pfft1_large`` ``plan_pfft1_large(2**26)`` (8192 x 8192 four-step) under the
                 library and ``radix=4`` (2 K1 launches), and pinned to
                 ``n2=2**17`` under ``radix=4`` (512 rows of 2^17 through
                 K1b's cluster kernel, then K1) and to ``n2=2**19`` (128
                 rows of 2^19 through K1b's two passes, then K1), against
                 ``torch.fft.fft``; ``plan_pfft1_large(2**28)`` (16384 x
                 16384, K1 at Plan<14>) under ``radix=4``; a composite and a
                 prime N (0 launches); the ``tune="measure"`` lifecycle at
                 2^24.
10. ``serve``    one ``FFTService`` answers a mixed stream of 24 requests
                 (``rfft-lb``, ``lb``, ``fpm``, ``pfft3-lb``, ``pfft1-large``),
                 every result against its ``torch.fft`` oracle, with the
                 service's record of each dispatch (cohort, launches, the
                 seconds of each step), requests/s, p50 and p99; a priced
                 ``AdmissionError`` and a ``DeadlineExceeded``; a second
                 service on the same wisdom file with ``retunes == 0``; cohorts
                 of 1, 3 and 8 under ``radix=4`` with the same launches.
11. ``dist``     the distributed path (``plan_pfft(mesh=)``,
                 ``core.pfft_dist``) on a world of one rank over NCCL, the
                 exchange sending to itself: ``lb`` at N = 8192 under the
                 library, ``radix=4``, fused and ``radix=4`` with 2, 4 and 8
                 pipelined panels against ``torch.fft.fft2``; ``fpm-pad`` at
                 4096 (padded to 8192) against the padded oracle;
                 ``rfft-lb`` under ``radix=4`` and ``irpfft2_distributed``;
                 ``tune="estimate"`` / ``"measure"`` plans (one rank:
                 measure falls back to the estimate).  Each run timed
                 beside the single-device plan of its config, with the
                 ``aten::copy_`` calls of one execute counted by the host
                 profiler; the self exchange and the phase's two copies
                 timed alone.
12. ``dist_gloo4`` 4 processes (this script with ``--gloo-rank``, started
                 once after 15 for 12, 14 and 16, each world in turn) sharing
                 the card over gloo with CUDA tensors, the exchange through
                 the host: ``radix=4``, fused, the hierarchical exchange on 2
                 emulated hosts x 2, 2 panels and ``rfft-lb`` at N = 4096,
                 each rank on its (1024, 4096) block, rank 0 gathering the
                 blocks against the library; every rank's launches checked.
13. ``dist3``    the 3-D mesh pipelines on a world of one NCCL rank:
                 ``plan_pfft3(512, mesh=make_pfft3_mesh(1, 1))`` under the
                 library, ``radix=4`` and ``radix=4`` with 2 and 4 panels,
                 ``pfft3_slab`` on a 1-D mesh of one, ``tune="estimate"`` /
                 ``"measure"`` plans, each against ``torch.fft.fftn`` and
                 timed beside the single-device ``plan_pfft3`` with its
                 copies counted; the pieces of a pencil transform timed.
14. ``dist3_gloo4`` the same 4 processes, a new world, sharing the card
                 over gloo: pencils of 2x2 (and 2 panels), 1x4, 4x1 and 4x1
                 over 2 emulated hosts with ``exchange="hier"``, slabs flat
                 and 2 hosts x 2 with ``hier``, 128^3, rank 0 gathering the
                 blocks by mesh coordinates against ``torch.fft.fftn``.
15. ``runtime``  the self-healing runtime (``repro_torch.runtime``) on a world
                 of one NCCL rank, N = 8192: ``repeated(K1, 3)`` bit for bit
                 one K1 launch, in exactly 3 launches; a ``ResilientPlan``
                 under ``radix=4`` over 5 calls against ``torch.fft.fft2``,
                 with the K1 launches of each call with and without its probe
                 (one group: no drift can fire); a ``CheckpointManager``
                 round trip of a 512 MiB state on the card.
16. ``runtime_gloo4`` the same 4 processes, a new world, sharing the
                 card over gloo, N = 4096: position 0 slowed 3x until a
                 re-plan naming it is hot-swapped (the probes' K1 launches
                 per rank, the events, detect -> swap on the host clock);
                 then position 3 lost at a call: the world rebuilt to 2 ranks
                 (one survivor dropped), the call retried and gathered
                 against ``torch.fft.fft2``, and a second plan on the reduced
                 world served from wisdom with no launch while planning.
17. ``lm_serve`` the LM serving path (``repro_torch.launch.serve``; plain
                 PyTorch, none of the FFT kernels): ``serve_batch`` of
                 qwen2.5-3b FULL in bf16 (weights from a seeded CUDA
                 generator) at batch 8 x (64 + 32); the prefill and each
                 decode step timed, one decode step's launches counted by
                 the profiler, beside their bounds; a float32 copy of the
                 weights: forward vs prefill vs prefill(S-1) + decode_step,
                 the bf16 logits against it, greedy tokens compared; one
                 full-width layer against the host; the SMOKE config of
                 every other dense, vlm and audio arch against the host.
18. ``lm_serve_moe`` the MoE + MLA serving path: ``serve_batch`` of
                 deepseek-v2-lite-16b FULL (27 layers, bf16) at batch 8 x
                 (64 + 32); the prefill and each decode step timed, one
                 decode step's launches counted, peak memory, beside bounds
                 that count the routed experts the step's routing selects;
                 its first 4 layers in float32 (forward vs prefill,
                 prefill(S-1) + decode vs prefill(S) at capacity factor 8;
                 bf16 vs float32 logits printed beside the share of routing
                 decisions that differ); one full-width layer against the
                 host, routing first; dbrx-132b at full width with 2 layers
                 timed; the SMOKE configs of both against the host.
19. ``lm_serve_ssm`` the recurrent serving path: ``serve_batch`` of
                 zamba2-7b FULL (81 Mamba2 blocks and a shared attention
                 block, bf16) and of xlstm-125m FULL at batch 8 x (64 + 32);
                 the prefill and each decode step timed, one decode step's
                 launches counted, peak memory, beside bounds that count the
                 shared block per application and the recurrent state; a
                 float32 copy of each at full depth (forward vs prefill vs
                 prefill(S-1) + decode_step; bf16 logits and greedy tokens
                 against it, printed); one full-width Mamba2, mLSTM and sLSTM
                 block against the host in prefill and decode from a carried
                 state; the SMOKE configs of both against the host.
20. ``lm_train`` training on one device (``repro_torch.train``,
                 ``repro_torch.launch.train``; plain PyTorch, none of the FFT
                 kernels): internlm2-1.8b FULL in bf16 (24 layers, 1.89 B
                 parameters, float32 moments), batch 8 x 512 in 2
                 microbatches with remat, TRAIN_STEPS steps timed by CUDA
                 events beside ``train_bounds``, one step's launches counted,
                 tokens/s, peak memory, every loss, the first against a
                 float32 copy's; the step FPM of the paper's technique over
                 microbatch x sequence and ``choose_schedule``'s pick; the
                 SMOKE config in float32: 60 steps of ``run_training`` that
                 must drop the loss by 0.5, 3 steps card against host, and a
                 kill and restart from ``run_training``'s checkpoint.
21. ``lm_train_mesh`` the trainer on a mesh (``models.sharding``,
                 ``launch.mesh.make_local_mesh``, ``launch.train``; no FFT
                 kernel): a world of one NCCL rank, internlm2-1.8b FULL in
                 bf16 from ``lm_train``'s seed and batches, its state laid
                 out on the 1 x 1 ``("data", "model")`` mesh as DTensors by
                 the reference's sharding rules; the first loss within 1e-3
                 of ``lm_train``'s, TRAIN_MESH_STEPS steps timed beside
                 ``train_bounds``, one step's launches and idle share, peak
                 memory; the SMOKE kill and restart through ``run_training``
                 on that mesh.
22. ``dryrun``   the dry-run (``repro_torch.launch.dryrun``, ``roofline``;
                 no FFT kernel, nothing allocated) in a process of its own,
                 so its fake world never meets an NCCL one, started before
                 ``build`` and awaited before ``kernels`` (it needs the
                 host, not the card, and overlaps only the compile and the
                 kernel checks, neither timed), its launch counts set to 0
                 and read around
                 each of its two traces there, and read here:
                 (a) the ``lm_train`` step (internlm2-1.8b FULL, the same
                 batch, microbatches and remat) counted on fake CUDA
                 tensors over a fake 1 x 1 mesh, its operations within
                 [0.85, 1.15] of ``train_bounds``' and its roofline bound beside
                 ``lm_train``'s measured median step; (b) one production
                 cell at full width, internlm2-1.8b x decode_32k on the
                 fake 16x16 mesh through ``run_cell``, its roofline and
                 memory printed.

Then, outside the counted drives: every checked 2-D execute timed beside the
library, and a fused batch's two layouts (batched, and the per-signal
loop) checked against the library and timed at N = 1024 ... 8192 and
batches of 2 and 8.  Tolerances of the paths 8-10, 13 and 14:
``2e-4·sqrt(elements of one signal)`` (the 2-D ``2e-4·N``).

Each path (4-22) is driven once with the launch counts set to 0 just before
and read just after; each of its kernels must have launched (the counts of
``dist_gloo4``, ``dist3_gloo4`` and ``runtime_gloo4`` are their four ranks'
sums; ``lm_serve``, ``lm_serve_moe``, ``lm_serve_ssm``, ``lm_train``,
``lm_train_mesh`` and ``dryrun`` must launch none of them).  Every line but
the last is a log or a JSON record; the last line is ``{"ok": true,
"device": {...}}`` and is printed only when every phase passed.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: no CUDA device available; this script "
                     "measures on the card and does not run on the CPU\n")
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.core import (FPMSet, PlanConfig, SpeedFunction, build_fpm,  # noqa: E402
                              fft_flops, four_step_factors, irfft2,
                              lb_partition, partition_rows,
                              pfft3_fpm, pfft3_fpm_pad, pfft3_slab, plan_pfft,
                              plan_pfft1_large, plan_pfft3, rfft2)
from repro_torch.core.pfft3d import _ROTATE, _SWAP  # noqa: E402
from repro_torch.core.pfft_dist import (_pack, _send_recv,  # noqa: E402
                                        irpfft2_distributed)
from repro_torch.fft import fft_rows  # noqa: E402
from repro_torch.kernels import (_build, fft_rows_op, fft_rows_transpose_op,  # noqa: E402
                                 launch_counts, reset_launch_counts,
                                 rfft_rows_op, rfft_rows_transpose_op,
                                 transpose_op)
from repro_torch.kernels.fft.kernel import fft_rows_plain  # noqa: E402
from repro_torch.kernels.fft.kernel import MAX_KERNEL_N  # noqa: E402
from repro_torch.kernels.fft.large import (CLUSTER_MAX_N, cluster_plan,  # noqa: E402
                                           fft_rows_large_plain, large_split,
                                           scratch_rows, two_pass_split)
from repro_torch.kernels.fft.real import rfft_rows_plain  # noqa: E402
from repro_torch.kernels.fft.real_large import rfft_rows_large_plain  # noqa: E402
from repro_torch.kernels.fused.kernel import fft_rows_transpose_plain  # noqa: E402
from repro_torch.kernels.fused import kernel as fused_kernel_mod  # noqa: E402
from repro_torch.kernels.fused import large as fused_large_mod  # noqa: E402
from repro_torch.kernels.fused.large import (  # noqa: E402
    TRANSPOSE_CLUSTER_LENGTHS, fft_rows_transpose_large_plain, padded_out_stride,
    transpose_cluster_plan)
from repro_torch.kernels.fused.real import rfft_rows_transpose_plain  # noqa: E402
from repro_torch.kernels.fused.real_large import (  # noqa: E402
    rfft_rows_transpose_large_plain)
from repro_torch.kernels.transpose.kernel import transpose_plain  # noqa: E402
from repro_torch.launch.mesh import (init_multihost, make_fft_mesh, make_local_mesh,  # noqa: E402
                                     make_pfft3_mesh)
from repro_torch.launch.serve_fft import (AdmissionError, DeadlineExceeded,  # noqa: E402
                                          FFTService, _bucket)
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline, make_batch  # noqa: E402
from repro_torch.configs.base import ShapeCfg, TrainCfg  # noqa: E402
from repro_torch.launch.train import state_pspecs  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models.sharding import batch_pspecs, sanitize_pspecs  # noqa: E402
from repro_torch.runtime.elastic import reshard  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.train import TrainState, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.fpm_schedule import build_step_fpm, choose_schedule  # noqa: E402
from repro_torch.runtime import (CheckpointManager, DeviceLostError,  # noqa: E402
                                 inject, repeated)
from repro_torch.runtime.resilient import ResilientPlan  # noqa: E402
from repro_torch.plan import (CostParams, PlanCache, candidate_configs,  # noqa: E402
                              estimate_cost, fit_cost_params, halfspec_cols,
                              measure_configs,
                              measure_rfft_configs, record_wisdom, wisdom_key)

SEED = 0
P = 4
N_UNPADDED = 8192     # lb, fpm
N_PADDED = 8192       # fpm-pad, fpm-czt: the pow2 pad of 16384 runs K1 at Plan<14>
N_WIDE = 16384        # lb, fpm at K1's and K2's longest row (a 2 GiB signal)
N_K1B = 32768         # lb through the four-step K1b and K2b (an 8 GiB signal),
                      # rfft-lb through K3b, K4b, K1b, K2b (a 4 GiB real one)
N_BATCH = 1024        # batched execute, execute_many
# Published peaks of one H100 SXM: HBM3 bandwidth and float32 rate outside
# the tensor cores.  The bound of a kernel is the larger of its bytes over the
# first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
KERNEL_SHAPES = [(64, 8), (37, 1024), (100, 2048), (256, 4096), (1024, 1024),
                 (4096, 4096), (8192, 8192)]
MAIN_SHAPE = (8192, 8192)
# Every length the complex row kernels K1 and K2 are instantiated for (n = 2
# ... 16384), at two odd row counts: 37 (few rows, a ragged last CTA wherever
# a CTA holds several rows) and 2^20 elements plus 5 rows (a full grid with a
# ragged last CTA up to n = 1024, a ragged last cluster of K2 from 2048 on);
# and WIDE_SHAPE, where K1-K4 are timed at their longest row.
WIDE_SHAPE = (4096, 16384)
# K2, K3 and K4 at n = 16384 run other sources than below it, one launch a
# call (K2 K2b's cluster kernel, K3 persistent CTAs, K4 the packed pair split
# over a cluster; counted apart as ``<name>_16k``).
WIDE_SOURCES = {"fft_rows_transpose": "fft_rows_transpose_cluster.cu",
                "rfft_rows": "rfft_rows_16k.cu",
                "rfft_rows_transpose": "rfft_rows_transpose_16k.cu"}
COMPLEX_KERNEL_SHAPES = [(rows, 1 << e) for e in range(1, 15)
                         for rows in (37, ((1 << 20) >> e) + 5)] + [WIDE_SHAPE]
# Where K2 runs in clusters of 4 one-row CTAs: 8k + 1, 8k + 7, 4097 rows
# (phase 2 of a fused rfft-* plan at N = 8192) and 8193 (at N = 16384) leave
# the last one ragged.
K2_RAGGED_SHAPES = ([(rows, n) for n in (4096, 8192, 16384) for rows in (257, 263, 4097)]
                    + [(8193, 16384)])
# Every length the packed real kernels are instantiated for (n = 2 ... 16384),
# at an odd row count (an unpaired last row, few pairs per CTA) and an even
# one (2^20 elements), the main path's shape, and at n = 4096 ... 16384, where
# a CTA holds one pair, 2*(4k+1) and 2*(4k+1)+1 rows: 1 and 2 pairs in the
# last cluster of 4 CTAs, with even and odd rows.
REAL_KERNEL_SHAPES = ([(rows, 1 << e) for e in range(1, 15)
                       for rows in (37, max(2, (1 << 20) >> e))] + [MAIN_SHAPE, WIDE_SHAPE]
                      + [(rows, n) for n in (4096, 8192, 16384) for rows in (258, 259)])
# K1b: 2048 rows of 32768 (the one-pass record's shape), 512 rows of 2^17
# (the record of the cluster kernel at 16-CTA clusters), 128 rows of 2^19
# (the two passes' record, also 512 MiB) and one line of 2^24 (two passes),
# and in the cluster kernel 1023 rows of 65536, 256 and 129 rows of 2^18 and
# 3 of 2^17.
K1B_SHAPES = [(2048, 1 << 15), (512, 1 << 17), (128, 1 << 19), (1, 1 << 24),
              (1023, 1 << 16), (256, 1 << 18), (129, 1 << 18), (3, 1 << 17)]
K1B_LONG_SHAPE = K1B_SHAPES[1]
K1B_TWO_PASS_SHAPE = K1B_SHAPES[2]
# K2b's two passes (above 65536) keep their record at 512 x 2^17.
K2B_TWO_PASS_SHAPE = (512, 1 << 17)
# The two passes' design, named in their records: pass A with the columns
# fastest in a warp (256-byte loads and stores where a CTA holds 32
# columns, n1 <= 512), pass B storing 16 or more rows side by side (runs of
# 128 bytes or more, through a cluster where a CTA holds fewer).
TWO_PASS_DESIGN = "columns_fastest+store_runs_16_rows"
# K2b, K3b and K4b (the four-step fused and real kernels): K1b's records'
# shape, K2b's two passes' and one line of 2^24,
# and odd row counts: 2049 (K2b's cluster kernel masks the last 3 rows of its
# last cluster; its output rows start off 32-byte boundaries; K3b and K4b get
# an unpaired last row), 16385, the main path's own (phase 2 of the fused
# real plan at 32768; K3b and K4b over 8193 pairs in 3 chunks), 3 (one
# cluster of K2b) and 1023 x 65536 (K2b's cluster kernel at its other
# length).
SIBLING_SHAPES = [K1B_SHAPES[0], K2B_TWO_PASS_SHAPE, (1, 1 << 24),
                  (2049, 1 << 15), (16385, 1 << 15), (3, 1 << 15), (1023, 1 << 16)]
# K2 and K2b writing at a row stride padded to a multiple of 4 (pad_stride):
# phase 2 of the fused real plan at 16384 and 32768, and K2b's two passes.
PADDED_SHAPES = [(8193, 1 << 14), (16385, 1 << 15), (513, 1 << 17)]
TRANSPOSE_SHAPES = [(1, 1), (37, 129), (1000, 3), (4096, 8192), (8192, 8192)]
# Every other element size the transpose kernel is built for, at small shapes.
TRANSPOSE_OTHER_DTYPES = [torch.uint8, torch.float16, torch.float64, torch.complex128]
MICROBENCH_N = (1024, 8192)
# The planner's measured problems: lb and rfft-lb over these N (>= 8 wisdom
# entries with fpm-pad, so that fit_cost_params fits); the lb pots raced at
# each N are calibration samples (four sizes, so that the fit can tell the
# compute terms from the traffic term).
PLANNER_N = (1024, 2048, 4096, 8192)
# The 3-D path: a 512^3 complex64 cube (1 GiB) for plan_pfft3 and the
# estimate plan; 256^3 for the FPM methods (pads up to 512) and the measure
# plan.  The huge-1-D path: 2^26 (an 8192 x 8192 four-step, 512 MiB; and
# pinned to 512 x 2^17, N_LARGE_LONG_N2, so that its first phase runs K1b's
# cluster kernel at 2^17, and to 128 x 2^19, N_LARGE_TWO_PASS_N2, its two
# passes at the record's shape) and 2^28 (16384 x 16384, 2 GiB); a composite
# length whose factors are not
# powers of two (1000 x 1000) and a prime (one library FFT); the measure
# lifecycle at 2^24.
N_PFFT3 = 512
N_PFFT3_PAD = 256
N_LARGE = 1 << 26
N_LARGE_LONG_N2 = 1 << 17
N_LARGE_TWO_PASS_N2 = 1 << 19
N_LARGE_TOP = 1 << 28     # 16384 x 16384: K1 at its longest row, a 2 GiB line
N_LARGE_LIBRARY = (1_000_000, 1_000_003)
N_LARGE_MEASURE = 1 << 24
# The served stream: (method, count, shape, real input, library oracle).
SERVE_STREAM = [("rfft-lb", 8, (2048, 2048), True, torch.fft.rfft2),
                ("lb", 6, (4096, 4096), False, torch.fft.fft2),
                ("fpm", 4, (8192, 8192), False, torch.fft.fft2),
                ("pfft3-lb", 3, (256, 256, 256), False, torch.fft.fftn),
                ("pfft1-large", 3, (1 << 24,), False, torch.fft.fft)]
# Cohorts of 1, 3 and 8 under radix=4: N_BATCH^2 signals, these cubes and
# lines.
COHORT_SIZES = (1, 3, 8)
N_COHORT_CUBE = 128
N_COHORT_LINE = 1 << 22
# Predicted-makespan budget of one serving tick (the stream's cohorts,
# priced by the "cuda" constants, take ~0.13 s in all).
SERVE_TICK_BUDGET_S = 0.1
# The fused batch's two layouts are timed at these (N, batch).
FUSED_BATCH_SHAPES = [(1024, 2), (1024, 8), (4096, 2), (4096, 8), (8192, 2),
                      (8192, 8)]
# The distributed path: complex64 at N = 8192 on a world of one rank over
# NCCL (the exchange sends to itself), its fpm-pad run at 4096 (padded to
# 2N = 8192), the panel counts raced; then a world of GLOO_RANKS processes
# sharing the card over gloo (the exchange through the host), 2 emulated
# hosts x 2 for the hierarchical exchange, at N = 4096 (34.6 s at 8192).
N_DIST = 8192
N_DIST_GLOO = 4096
N_DIST_PAD = 4096
DIST_PANELS = (2, 4, 8)
GLOO_RANKS = 4
GLOO_TIMEOUT_S = 600
# The gloo worlds (phase, worker mode), run in turn by the same GLOO_RANKS
# processes; the runtime's lost ranks leave their world, so it comes last.
GLOO_WORLDS = (("dist_gloo4", "2d"), ("dist3_gloo4", "3d"), ("runtime_gloo4", "runtime"))
# The 3-D mesh pipelines: the 512^3 cube of the pfft3 path on a 1 x 1 pencil
# mesh of one NCCL rank (and a slab of one), the panel counts raced; then
# GLOO_RANKS processes sharing the card over gloo on pencil meshes of 2x2,
# 1x4, 4x1 and 4x1 over 2 emulated hosts, and slabs flat and 2 hosts x 2,
# on a 128^3 cube: the exchange goes through the host (49 s at 512^3 on the
# H100, 27.2 s at 256^3).
N_DIST3 = 512
DIST3_PANELS = (2, 4)
N_DIST3_GLOO = 128
# The self-healing runtime: one NCCL rank, then GLOO_RANKS processes sharing
# the card; position 0 slowed RUNTIME_SLOW times until a re-plan is swapped
# in within RUNTIME_STRAGGLER_CALLS calls, then RUNTIME_LOST lost (4096 is
# not divisible by 3, so the rebuilt axis has 2 ranks and drops one).
N_RUNTIME = 8192
N_RUNTIME_GLOO = 4096     # runtime_gloo4's N: its host exchange dominated the phase
RUNTIME_CALLS = 5
RUNTIME_SLOW = 3
RUNTIME_STRAGGLER_CALLS = 12
RUNTIME_LOST = (3,)
CHECKPOINT_SHAPE = (8192, 8192)     # complex64: 512 MiB
RUNTIME_EVENT_FIELDS = ("kind", "call", "slow_groups", "relative_speeds",
                        "source", "chosen", "schedule", "swap_call", "lost",
                        "survivors", "devices", "dropped", "topology",
                        "plan_source")
# The LM serving path: qwen2.5-3b FULL (36 layers, d 2048, bf16) served at
# the reference's defaults, batch 8, a prompt of 64 and 32 generated tokens;
# its float32 copy checked against itself and the bf16 run; the SMOKE
# configs of the other dense, vlm and audio archs held against the host.
LM_ARCH = "qwen2_5_3b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 64, 32
LM_SMOKE_ARCHS = ("internlm2_1_8b", "chatglm3_6b", "stablelm_3b",
                  "llava_next_mistral_7b", "hubert_xlarge")
LM_SMOKE_DECODE = 4
# The MoE + MLA serving path: deepseek-v2-lite-16b FULL (27 layers, d 2048,
# MLA, 64 routed experts top-6 + 2 shared, ~16 B parameters, 32 GB in bf16)
# served at LM_BATCH x (LM_PROMPT + LM_GEN); its float32 checks on its first
# MOE_F32_LAYERS layers (a float32 copy of all 27 is ~65 GB and does not fit
# beside the bf16 model); dbrx-132b at its full width with MOE_DBRX_LAYERS
# layers (its 40 are ~264 GB); the SMOKE configs of both against the host.
MOE_ARCH = "deepseek_v2_lite_16b"
MOE_F32_LAYERS = 4
MOE_DBRX_ARCH = "dbrx_132b"
MOE_DBRX_LAYERS = 2
MOE_DBRX_DECODE = 4
MOE_SMOKE_ARCHS = ("dbrx_132b", "deepseek_v2_lite_16b")
# A routing decision of the full-width layer that flips between card and
# host must be a near-tie: its top-k boundary gap on the host below this.
MOE_NEAR_TIE = 1e-4
# The recurrent serving path: zamba2-7b FULL (81 Mamba2 blocks of d 3584 in
# 14 groups of 6, the last padded with 3 that are not run, and one shared
# attention + MLP block applied at the start of each group; ~7.2 B parameters
# with the padded blocks, 14.4 GB in bf16, its float32 copy ~29 GB) and
# xlstm-125m FULL (12 blocks, mLSTM and sLSTM in turn), both uncut, at
# LM_BATCH x (LM_PROMPT + LM_GEN): a prompt of 64 divides both chunks (64,
# min(256, 64)).  One full-width block of each kind is held against the host
# at SSM_BLOCK_T tokens from a state carried over SSM_BLOCK_T others.
SSM_ARCHS = ("zamba2_7b", "xlstm_125m")
SSM_BLOCK_T = 64
# The printed bf16-vs-float32 gap by depth stops at this many blocks below
# the full depth (zamba2-7b: 6, 12, 24 and its 81; xlstm-125m: 2, 4, 8, 12).
BF16_GAP_MAX_BLOCKS = 24
# Training on one device: internlm2-1.8b FULL (24 layers, d 2048, GQA 16/8,
# d_ff 8192, vocab 92544; 1.89 B parameters, 1.70 B of them matmul weights)
# in bf16 with float32 moments and accumulators (~30 GB of state), batch 8 x
# 512 in 2 microbatches, every layer and CE chunk rematerialised; then the
# step FPM over microbatch x sequence and the schedule it picks; then its
# SMOKE config in float32: TRAIN_SMOKE_STEPS steps that must drop the loss
# by 0.5 (tests/test_train.py), 3 steps card against host, and a kill and
# restart through run_training's checkpoints.
TRAIN_ARCH = "internlm2_1_8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 6
TRAIN_FPM_MB = (1, 2, 4)
TRAIN_FPM_SEQ = (256, 512, 1024)
TRAIN_PICK = dict(tokens_per_device=4096, seq_len=480, pad_candidates=[512, 1024])
TRAIN_SMOKE_STEPS = 60
TRAIN_MESH_STEPS = 3      # timed steps on the 1 x 1 mesh after the first
DRYRUN_CELL = ("internlm2_1_8b", "decode_32k")
DRYRUN_OPS_RATIO = (0.85, 1.15)   # counted / train_bounds' operations
DRYRUN_TIMEOUT_S = 300
PEAK_BF16_FLOPS = 989e12       # dense bf16 on the tensor cores
SOURCES = "src/repro_torch/kernels/csrc/"


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - _T0, 2), **fields}),
          flush=True)


def run(cmd: list[str]) -> str:
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed: {done.stderr.strip()}")
    return done.stdout.strip()


def time_ms(fn, *, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def random_signal(gen: torch.Generator, *shape: int) -> torch.Tensor:
    """Unit-variance complex64 noise on the card, from the seeded generator."""
    re = torch.randn(*shape, generator=gen, device="cuda")
    im = torch.randn(*shape, generator=gen, device="cuda")
    return torch.complex(re, im) * math.sqrt(0.5)


def random_real(gen: torch.Generator, *shape: int) -> torch.Tensor:
    """Unit-variance float32 noise on the card, from the seeded generator."""
    return torch.randn(*shape, generator=gen, device="cuda")


def row_fft_tol(n: int, inverse: bool) -> float:
    """``1e-3·sqrt(n)`` on the unscaled transform of unit-variance rows.  The
    inverse's 1/n scale shrinks its values, and so its tolerance, by n: at
    the forward's tolerance an inverse that wrote zeros would pass."""
    return 1e-3 * math.sqrt(n) / (n if inverse else 1)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(a) if a.is_complex() else a).all()):
        raise AssertionError("non-finite values in the result")
    return float((a - b).abs().max())


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    once over the memory rate and the operations over the float32 rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def kernel_record(name: str, replaces: str, shape, err: float, limits: dict,
                  kernel, plain, library, source: str | None = None, **extra) -> dict:
    """One record of the ``kernels`` line, timed here (launch counts are
    filled in after the paths have run); ``source`` defaults to the
    ``.cu`` named after the kernel; ``extra`` (a design, a split) is added
    to the record."""
    ms = time_ms(kernel, reps=20)
    return {"name": name, "route": "cuda", "source": SOURCES + (source or name + ".cu"),
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(plain, reps=3, warmup=1), **limits,
            "library_ms": time_ms(library, reps=20), "shape": list(shape),
            "max_err": err, "kernel_ms": ms, **extra}


# ------------------------------------------------------------------ phases

def phase_env() -> str:
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=run([_build._find_nvcc(), "--version"]).splitlines()[-2:],
        card=card, kind=torch.cuda.get_device_name(0),
        sm_count=props.multi_processor_count,
        smem_per_block_optin=getattr(props, "shared_memory_per_block_optin", None),
        memory_gib=round(props.total_memory / 2 ** 30, 1))
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    log("build", seconds=round(time.perf_counter() - t0, 2),
        sources=[p.name for p in _build.source_files()],
        flags=" ".join(_build.NVCC_FLAGS))


def check_kernels(gen: torch.Generator) -> dict[str, float]:
    """Each kernel against its plain version (and the library) at every
    shape; nothing is timed, so this runs beside the dry-run worker.  Returns
    each record's error against its plain version at the record's shape."""
    worst = {"fft_rows": 0.0, "fft_rows_transpose": 0.0}
    for rows, n in KERNEL_SHAPES:
        x = random_signal(gen, rows, n)
        for radix in (2, 4):
            for inverse in (False, True):
                tol = row_fft_tol(n, inverse)
                plain = fft_rows_plain(x, inverse=inverse, radix=radix)
                got = fft_rows_op(x, inverse=inverse, radix=radix)
                torch.cuda.synchronize()
                e1 = max_abs_err(got, plain)
                got_t = fft_rows_transpose_op(x, inverse=inverse, radix=radix)
                torch.cuda.synchronize()
                e2 = max_abs_err(got_t, fft_rows_transpose_plain(
                    x, inverse=inverse, radix=radix))
                # The plain version shares the kernel's arithmetic; the
                # library is the independent oracle.
                lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
                e3 = max_abs_err(got, lib)
                log("kernels", rows=rows, n=n, radix=radix, inverse=inverse,
                    fft_rows_err=e1, fft_rows_transpose_err=e2,
                    fft_rows_vs_library_err=e3, atol=tol)
                if max(e1, e2, e3) > tol:
                    raise AssertionError(
                        f"kernel disagrees at rows={rows} n={n} radix={radix} "
                        f"inverse={inverse}: {e1} {e2} {e3} > {tol}")
                if (rows, n) == MAIN_SHAPE and radix == 4:
                    worst["fft_rows"] = max(worst["fft_rows"], e1)
                    worst["fft_rows_transpose"] = max(
                        worst["fft_rows_transpose"], e2)
                del plain, got, got_t, lib
        del x

    check_complex_kernel(gen)
    check_real_kernels(gen, worst)
    check_batched_shapes(gen)
    check_transpose(gen, worst)
    check_large_kernel(gen, worst)
    check_large_siblings(gen, worst)
    check_padded_stride(gen)
    return worst


def phase_kernels(gen: torch.Generator, worst: dict[str, float]) -> list[dict]:
    """Each kernel timed at the main path's shape (and K1-K4 at n = 16384)
    beside its plain version, the library and its bound, with ``worst``
    from ``check_kernels``.  Returns the records of the ``kernels`` line
    (launch counts are filled in after the main path has run)."""
    wide = wide_records(gen)

    rows, n = MAIN_SHAPE
    nh = n // 2 + 1
    x = random_signal(gen, rows, n)
    xr = random_real(gen, rows, n)
    # Complex row FFT: rows*n*8 bytes read once and written once.
    complex_limits = bound(2 * rows * n * 8, 5.0 * rows * n * math.log2(n))
    # Packed real row FFT: rows*n*4 read, rows*nh*8 written; one complex FFT
    # per row pair plus the split (8 operations per bin of a pair).
    real_limits = bound(rows * n * 4 + rows * nh * 8,
                        5.0 * (rows / 2) * n * math.log2(n) + 8.0 * (rows / 2) * nh)
    # Transpose of complex64: rows*n*8 read and written, no arithmetic.
    transpose_limits = bound(2 * rows * n * 8, 0.0)
    # K1b: the function's bytes once each way (the cluster kernel moves just
    # that, the two passes twice that) and the complex FFT's operations.
    def complex_limits_at(rows_: int, n_: int) -> dict:
        return bound(2 * rows_ * n_ * 8, 5.0 * rows_ * n_ * math.log2(n_))

    lrows, ln = K1B_SHAPES[0]
    xl = random_signal(gen, lrows, ln)
    xrl = random_real(gen, lrows, ln)
    large_limits = complex_limits_at(lrows, ln)
    xlong = random_signal(gen, *K1B_LONG_SHAPE)
    xt = random_signal(gen, *K1B_TWO_PASS_SHAPE)
    xt2 = random_signal(gen, *K2B_TWO_PASS_SHAPE)
    # K3b, K4b: K3's and K4's function at K1b's shape.
    lnh = ln // 2 + 1
    real_large_limits = bound(lrows * ln * 4 + lrows * lnh * 8,
                              5.0 * (lrows / 2) * ln * math.log2(ln)
                              + 8.0 * (lrows / 2) * lnh)
    records = [
        kernel_record("fft_rows", "src/repro/kernels/fft/kernel.py:209", MAIN_SHAPE,
                      worst["fft_rows"], complex_limits,
                      lambda: fft_rows_op(x, radix=4),
                      lambda: fft_rows_plain(x, radix=4),
                      lambda: torch.fft.fft(x)),
        kernel_record("fft_rows_transpose", "src/repro/kernels/fused/kernel.py:64",
                      MAIN_SHAPE, worst["fft_rows_transpose"], complex_limits,
                      lambda: fft_rows_transpose_op(x, radix=4),
                      lambda: fft_rows_transpose_plain(x, radix=4),
                      lambda: torch.fft.fft(x).T.contiguous()),
        kernel_record("rfft_rows", "src/repro/kernels/fft/real.py:91", MAIN_SHAPE,
                      worst["rfft_rows"], real_limits,
                      lambda: rfft_rows_op(xr),
                      lambda: rfft_rows_plain(xr, radix=4),
                      lambda: torch.fft.rfft(xr)),
        kernel_record("rfft_rows_transpose", "src/repro/kernels/fused/real.py:58",
                      MAIN_SHAPE, worst["rfft_rows_transpose"], real_limits,
                      lambda: rfft_rows_transpose_op(xr),
                      lambda: rfft_rows_transpose_plain(xr, radix=4),
                      lambda: torch.fft.rfft(xr).T.contiguous()),
        kernel_record("transpose", "src/repro/kernels/transpose/kernel.py:31",
                      MAIN_SHAPE, worst["transpose"], transpose_limits,
                      lambda: transpose_op(x),
                      lambda: transpose_plain(x),
                      lambda: x.T.contiguous()),
        kernel_record("fft_rows_large", "src/repro/kernels/fft/kernel.py:209",
                      K1B_SHAPES[0], worst["fft_rows_large"], large_limits,
                      lambda: fft_rows_op(xl),
                      lambda: fft_rows_large_plain(xl),
                      lambda: torch.fft.fft(xl), source="fft_rows_cluster.cu"),
        kernel_record("fft_rows_large_long", "src/repro/kernels/fft/kernel.py:209",
                      K1B_LONG_SHAPE, worst["fft_rows_large_long"],
                      complex_limits_at(*K1B_LONG_SHAPE),
                      lambda: fft_rows_op(xlong),
                      lambda: fft_rows_large_plain(xlong),
                      lambda: torch.fft.fft(xlong), source="fft_rows_cluster.cu"),
        kernel_record("fft_rows_large_two_pass", "src/repro/kernels/fft/kernel.py:209",
                      K1B_TWO_PASS_SHAPE, worst["fft_rows_large_two_pass"],
                      complex_limits_at(*K1B_TWO_PASS_SHAPE),
                      lambda: fft_rows_op(xt),
                      lambda: fft_rows_large_plain(xt),
                      lambda: torch.fft.fft(xt), source="fft_rows_large.cu",
                      design=TWO_PASS_DESIGN,
                      split=list(two_pass_split(K1B_TWO_PASS_SHAPE[1]))),
        kernel_record("fft_rows_transpose_large", "src/repro/kernels/fused/kernel.py:64",
                      K1B_SHAPES[0], worst["fft_rows_transpose_large"], large_limits,
                      lambda: fft_rows_transpose_op(xl),
                      lambda: fft_rows_transpose_large_plain(xl),
                      lambda: torch.fft.fft(xl).T.contiguous(),
                      source="fft_rows_transpose_cluster.cu"),
        kernel_record("fft_rows_transpose_large_two_pass",
                      "src/repro/kernels/fused/kernel.py:64", K2B_TWO_PASS_SHAPE,
                      worst["fft_rows_transpose_large_two_pass"],
                      complex_limits_at(*K2B_TWO_PASS_SHAPE),
                      lambda: fft_rows_transpose_op(xt2),
                      lambda: fft_rows_transpose_large_plain(xt2),
                      lambda: torch.fft.fft(xt2).T.contiguous(),
                      source="fft_rows_transpose_large.cu", design=TWO_PASS_DESIGN,
                      split=list(two_pass_split(K2B_TWO_PASS_SHAPE[1]))),
        kernel_record("rfft_rows_large", "src/repro/kernels/fft/real.py:91",
                      K1B_SHAPES[0], worst["rfft_rows_large"], real_large_limits,
                      lambda: rfft_rows_op(xrl),
                      lambda: rfft_rows_large_plain(xrl),
                      lambda: torch.fft.rfft(xrl)),
        kernel_record("rfft_rows_transpose_large", "src/repro/kernels/fused/real.py:58",
                      K1B_SHAPES[0], worst["rfft_rows_transpose_large"], real_large_limits,
                      lambda: rfft_rows_transpose_op(xrl),
                      lambda: rfft_rows_transpose_large_plain(xrl),
                      lambda: torch.fft.rfft(xrl).T.contiguous()),
    ]
    for record in records:
        if record["name"] in wide:
            record["at_16384"] = wide[record["name"]]
    return records


def check_large_kernel(gen: torch.Generator, worst: dict) -> None:
    """K1b (``fft_rows_op`` above 16384: the cluster kernel up to 2^18, the
    two passes above) at ``K1B_SHAPES`` in both directions against
    ``fft_rows_large_plain`` and ``torch.fft.fft`` / ``ifft``, ``atol =
    row_fft_tol(n, inverse)``; a call of the cluster kernel exactly one
    launch and none of the two passes (at 2^17 and 2^18 also one of
    ``fft_rows_large_long``), a call of the two passes none of the cluster
    kernel; ``worst`` gets the forward errors against the plain version at
    the records' shapes."""
    for rows, n in K1B_SHAPES:
        x = random_signal(gen, rows, n)
        design = ({"design": "cluster", "plan": list(cluster_plan(n))} if n <= CLUSTER_MAX_N
                  else {"design": "two_pass", "split": list(two_pass_split(n))})
        for inverse in (False, True):
            tol = row_fft_tol(n, inverse)
            before = launch_counts()
            got = fft_rows_op(x, inverse=inverse)
            torch.cuda.synchronize()
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in (
                "fft_rows_large", "fft_rows_large_two_pass", "fft_rows_large_long")}
            want = ({"fft_rows_large": 1, "fft_rows_large_two_pass": 0,
                     "fft_rows_large_long": int(n > 1 << 16)} if n <= CLUSTER_MAX_N
                    else {"fft_rows_large": delta["fft_rows_large_two_pass"],
                          "fft_rows_large_two_pass": delta["fft_rows_large_two_pass"],
                          "fft_rows_large_long": 0})
            if delta != want or delta["fft_rows_large"] < 1:
                raise AssertionError(f"K1b at n={n} launched {delta}, expected {want}")
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            errs = {"fft_rows_large_err": max_abs_err(
                        got, fft_rows_large_plain(x, inverse=inverse)),
                    "fft_rows_large_vs_library_err": max_abs_err(got, lib)}
            log("kernels", rows=rows, n=n, **design, inverse=inverse, atol=tol, **errs)
            if max(errs.values()) > tol:
                raise AssertionError(f"K1b disagrees at rows={rows} n={n} "
                                     f"inverse={inverse}: {errs} > {tol}")
            if (rows, n) == K1B_SHAPES[0] and not inverse:
                worst["fft_rows_large"] = errs["fft_rows_large_err"]
            if (rows, n) == K1B_LONG_SHAPE and not inverse:
                worst["fft_rows_large_long"] = errs["fft_rows_large_err"]
            if (rows, n) == K1B_TWO_PASS_SHAPE and not inverse:
                worst["fft_rows_large_two_pass"] = errs["fft_rows_large_err"]
            del got, lib
        del x


def check_large_siblings(gen: torch.Generator, worst: dict) -> None:
    """K2b, K3b and K4b (``fft_rows_transpose_op``, ``rfft_rows_op`` and
    ``rfft_rows_transpose_op`` above 16384) at ``SIBLING_SHAPES`` against
    their plain versions and ``torch.fft`` (K2b in both directions, the
    library transposed, one launch a call of its cluster kernel), ``atol =
    row_fft_tol(n, inverse)``; ``worst`` gets the forward errors against
    the plain versions at the records' shapes."""
    for rows, n in SIBLING_SHAPES:
        x = random_signal(gen, rows, n)
        cluster = n in TRANSPOSE_CLUSTER_LENGTHS
        design = ({"design": "cluster", "plan": list(transpose_cluster_plan(n))} if cluster
                  else {"design": "two_pass", "split": list(two_pass_split(n))})
        for inverse in (False, True):
            tol = row_fft_tol(n, inverse)
            before = launch_counts()
            got = fft_rows_transpose_op(x, inverse=inverse)
            torch.cuda.synchronize()
            after = launch_counts()
            if cluster and (after["fft_rows_transpose_large"]
                            - before["fft_rows_transpose_large"] != 1
                            or after["fft_rows_transpose_large_two_pass"]
                            != before["fft_rows_transpose_large_two_pass"]):
                raise AssertionError(f"K2b at n={n} did not take one cluster launch: "
                                     f"{before} -> {after}")
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            errs = {"fft_rows_transpose_large_err": max_abs_err(
                        got, fft_rows_transpose_large_plain(x, inverse=inverse)),
                    "fft_rows_transpose_large_vs_library_err": max_abs_err(got, lib.T)}
            log("kernels", rows=rows, n=n, **design, inverse=inverse, atol=tol, **errs)
            if max(errs.values()) > tol:
                raise AssertionError(f"K2b disagrees at rows={rows} n={n} "
                                     f"inverse={inverse}: {errs} > {tol}")
            if (rows, n) == SIBLING_SHAPES[0] and not inverse:
                worst["fft_rows_transpose_large"] = errs["fft_rows_transpose_large_err"]
            if (rows, n) == K2B_TWO_PASS_SHAPE and not inverse:
                worst["fft_rows_transpose_large_two_pass"] = errs[
                    "fft_rows_transpose_large_err"]
            del got, lib
        del x
        xr = random_real(gen, rows, n)
        tol = row_fft_tol(n, False)
        lib = torch.fft.rfft(xr)
        got, got_t = rfft_rows_op(xr), rfft_rows_transpose_op(xr)
        torch.cuda.synchronize()
        errs = {"rfft_rows_large_err": max_abs_err(got, rfft_rows_large_plain(xr)),
                "rfft_rows_transpose_large_err": max_abs_err(
                    got_t, rfft_rows_transpose_large_plain(xr)),
                "rfft_rows_large_vs_library_err": max_abs_err(got, lib),
                "rfft_rows_transpose_large_vs_library_err": max_abs_err(got_t, lib.T)}
        log("kernels", rows=rows, n=n, split=list(large_split(n)), atol=tol, **errs)
        if max(errs.values()) > tol:
            raise AssertionError(f"K3b/K4b disagree at rows={rows} n={n}: {errs} > {tol}")
        if (rows, n) == SIBLING_SHAPES[0]:
            worst["rfft_rows_large"] = errs["rfft_rows_large_err"]
            worst["rfft_rows_transpose_large"] = errs["rfft_rows_transpose_large_err"]
        del xr, lib, got, got_t


@contextlib.contextmanager
def recorded_outputs(fill: bool = False):
    """The output buffers K2 and K2b allocate while the block runs (their
    launchers' ``transposed_out``), each filled with NaN before its launch
    where ``fill``."""
    buffers: list[torch.Tensor] = []
    made = fused_large_mod.transposed_out

    def recorded(x, n, rows, pad_stride):
        out, stride = made(x, n, rows, pad_stride)
        buffers.append(out.fill_(float("nan")) if fill else out)
        return out, stride

    fused_kernel_mod.transposed_out = fused_large_mod.transposed_out = recorded
    try:
        yield buffers
    finally:
        fused_kernel_mod.transposed_out = fused_large_mod.transposed_out = made


def check_padded_stride(gen: torch.Generator) -> None:
    """K2 and K2b with ``pad_stride=True`` at ``PADDED_SHAPES``, both ways:
    the output buffer filled with NaN before the launch keeps NaN in its
    padding columns (nothing written past ``rows``), its ``(n, rows)`` view
    is the answer and equals the dense call's bit for bit, and
    ``fft_rows_transpose_padded`` counts one a call of the cluster kernel
    (one a chunk of the two passes)."""
    for rows, n in PADDED_SHAPES:
        x = random_signal(gen, rows, n)
        stride = padded_out_stride(n, rows)
        for inverse in (False, True):
            dense = fft_rows_transpose_op(x, inverse=inverse)
            before = launch_counts()["fft_rows_transpose_padded"]
            with recorded_outputs(fill=True) as buffers:
                got = fft_rows_transpose_op(x, inverse=inverse, pad_stride=True)
            torch.cuda.synchronize()
            padded = launch_counts()["fft_rows_transpose_padded"] - before
            chunks = 1 if n in TRANSPOSE_CLUSTER_LENGTHS else -(-rows // scratch_rows(n))
            (buf,) = buffers
            checks = {
                "strided_view": (got.stride() == (stride, 1) and got.shape == (n, rows)
                                 and buf.shape == (n, stride)),
                "shares_buffer": (got.untyped_storage().data_ptr()
                                  == buf.untyped_storage().data_ptr()),
                "padding_untouched": bool(torch.isnan(buf[:, rows:]).all()),
                "equal_to_dense": torch.equal(got, dense),
                "padded_launches": padded == chunks}
            log("kernels", rows=rows, n=n, inverse=inverse, padded_stride=stride, **checks)
            if not all(checks.values()):
                raise AssertionError(f"K2/K2b at a padded stride, rows={rows} n={n} "
                                     f"inverse={inverse}: {checks}")
            del dense, got, buf, buffers
        del x


def wide_records(gen: torch.Generator) -> dict[str, dict]:
    """K1-K4 at ``WIDE_SHAPE`` (n = 16384: K1 at Plan<14>, K2-K4 their own
    sources there), forward under
    ``radix=4``: each against its plain version (``row_fft_tol``), then
    timed beside it, the library and the card's bound, as the records'
    ``at_16384``."""
    rows, n = WIDE_SHAPE
    nh = n // 2 + 1
    x = random_signal(gen, rows, n)
    xr = random_real(gen, rows, n)
    complex_limits = bound(2 * rows * n * 8, 5.0 * rows * n * math.log2(n))
    real_limits = bound(rows * n * 4 + rows * nh * 8,
                        5.0 * (rows / 2) * n * math.log2(n) + 8.0 * (rows / 2) * nh)
    cases = {
        "fft_rows": (complex_limits, lambda: fft_rows_op(x, radix=4),
                     lambda: fft_rows_plain(x, radix=4), lambda: torch.fft.fft(x)),
        "fft_rows_transpose": (complex_limits, lambda: fft_rows_transpose_op(x, radix=4),
                               lambda: fft_rows_transpose_plain(x, radix=4),
                               lambda: torch.fft.fft(x).T.contiguous()),
        "rfft_rows": (real_limits, lambda: rfft_rows_op(xr),
                      lambda: rfft_rows_plain(xr, radix=4), lambda: torch.fft.rfft(xr)),
        "rfft_rows_transpose": (real_limits, lambda: rfft_rows_transpose_op(xr),
                                lambda: rfft_rows_transpose_plain(xr, radix=4),
                                lambda: torch.fft.rfft(xr).T.contiguous())}
    out = {}
    tol = row_fft_tol(n, False)
    replaces = {"fft_rows": "src/repro/kernels/fft/kernel.py:209",
                "fft_rows_transpose": "src/repro/kernels/fused/kernel.py:64",
                "rfft_rows": "src/repro/kernels/fft/real.py:91",
                "rfft_rows_transpose": "src/repro/kernels/fused/real.py:58"}
    for name, (limits, kernel, plain, library) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        err = max_abs_err(got, plain())
        del got
        if err > tol:
            raise AssertionError(f"{name} disagrees at {WIDE_SHAPE}: {err} > {tol}")
        record = kernel_record(name, replaces[name], WIDE_SHAPE, err, limits, kernel, plain,
                               library, source=WIDE_SOURCES.get(name))
        out[name] = {key: record[key] for key in (
            "name", "route", "source", "replaces", "launches", "shape", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        log("kernels", at_16384=name, **out[name])
    return out


def counted_call(name: str, n: int, call):
    """``call()`` of kernel ``name`` (K2, K3 or K4), synchronised: one launch
    of it, and of its own source at n = 16384 (``<name>_16k``) exactly there."""
    before = launch_counts()
    got = call()
    torch.cuda.synchronize()
    after = launch_counts()
    wide = int(n == MAX_KERNEL_N)
    if (after[name] - before[name], after[name + "_16k"] - before[name + "_16k"]) != (1, wide):
        raise AssertionError(f"{name} at n={n} did not take one launch of "
                             f"{WIDE_SOURCES[name] if wide else name + '.cu'}: "
                             f"{before} -> {after}")
    return got


def check_complex_kernel(gen: torch.Generator) -> None:
    """K1 and K2 at every length they are instantiated for, K2 also at its
    ragged clusters, both directions, both radices (the plain version's
    stage loop), against ``fft_rows_plain`` (transposed for K2) and
    ``torch.fft.fft`` / ``ifft``, ``atol = row_fft_tol(n, inverse)``; K2 one
    launch a call, of its cluster kernel at n = 16384."""
    for rows, n in COMPLEX_KERNEL_SHAPES + K2_RAGGED_SHAPES:
        x = random_signal(gen, rows, n)
        for inverse in (False, True):
            tol = row_fft_tol(n, inverse)
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            for radix in (2, 4):
                plain = fft_rows_plain(x, inverse=inverse, radix=radix)
                got_t = counted_call("fft_rows_transpose", n, lambda: fft_rows_transpose_op(
                    x, inverse=inverse, radix=radix))
                errs = {"fft_rows_transpose_err": max_abs_err(got_t, plain.T),
                        "fft_rows_transpose_vs_library_err": max_abs_err(got_t, lib.T)}
                if (rows, n) in COMPLEX_KERNEL_SHAPES:
                    got = fft_rows_op(x, inverse=inverse, radix=radix)
                    torch.cuda.synchronize()
                    errs |= {"fft_rows_err": max_abs_err(got, plain),
                             "fft_rows_vs_library_err": max_abs_err(got, lib)}
                    del got
                log("kernels", rows=rows, n=n, radix=radix, inverse=inverse,
                    atol=tol, **errs)
                if max(errs.values()) > tol:
                    raise AssertionError(
                        f"complex row kernel disagrees at rows={rows} n={n} "
                        f"radix={radix} inverse={inverse}: {errs} > {tol}")
                del plain, got_t
            del lib
        del x


def check_real_kernels(gen: torch.Generator, worst: dict) -> None:
    """K3 and K4 against their plain versions and ``torch.fft.rfft`` (and its
    transposed copy) on unit-variance float32 rows, ``atol = 1e-3·sqrt(n)``,
    each one launch a call, at n = 16384 of its own source there (K3's
    persistent kernel, K4's cluster kernel: 258 and 259 rows of 16 CTAs of
    4 pairs, 4096 of 8 of 2); ``worst`` gets the errors against the plain
    versions at the main shape."""
    for rows, n in REAL_KERNEL_SHAPES:
        x = random_real(gen, rows, n)
        tol = 1e-3 * math.sqrt(n)
        lib = torch.fft.rfft(x)
        for radix in (2, 4):
            plain = rfft_rows_plain(x, radix=radix)
            got = counted_call("rfft_rows", n, lambda: rfft_rows_op(x, radix=radix))
            got_t = counted_call("rfft_rows_transpose", n,
                                 lambda: rfft_rows_transpose_op(x, radix=radix))
            errs = {"rfft_rows_err": max_abs_err(got, plain),
                    "rfft_rows_transpose_err": max_abs_err(got_t, plain.T),
                    "rfft_rows_vs_library_err": max_abs_err(got, lib),
                    "rfft_rows_transpose_vs_library_err": max_abs_err(got_t, lib.T)}
            log("kernels", rows=rows, n=n, radix=radix, atol=tol, **errs)
            if max(errs.values()) > tol:
                raise AssertionError(
                    f"real kernel disagrees at rows={rows} n={n} radix={radix}: "
                    f"{errs} > {tol}")
            if (rows, n) == MAIN_SHAPE and radix == 4:
                worst["rfft_rows"] = errs["rfft_rows_err"]
                worst["rfft_rows_transpose"] = errs["rfft_rows_transpose_err"]
            del plain, got, got_t
        del x, lib


def batched_row_shapes() -> dict[str, set[tuple[int, int]]]:
    """The (rows, n) blocks the batched paths give the row kernels K1-K4: a
    stack of B signals runs each phase once over the rows of all of them.
    A 2-D stack of B gives B·n rows (B·(n/2+1) in phase 2 of a real plan);
    a cube's pass B·n^2 rows; a four-step line n1 x n2 B·n2 rows of n1,
    then B·n1 of n2.  B is the bucket of each served cohort, whole or
    split by a tick's budget, and of the cohorts of ``COHORT_SIZES``, and
    each batch of ``FUSED_BATCH_SHAPES``
    (fused kernels only); the 512^3 and 256^3 cubes and the 2^26 and 2^24
    lines of the ``pfft3`` and ``pfft1_large`` paths run as one; and the
    blocks of the distributed paths at 1 and GLOO_RANKS ranks."""
    shapes = {name: set() for name in ("fft_rows", "fft_rows_transpose",
                                       "rfft_rows", "rfft_rows_transpose")}

    def square(n: int, b: int, real: bool, kernels: tuple[str, ...]) -> None:
        # ``kernels``: the complex ones that may run (K1, K2); a real
        # plan's phase 1 runs their real siblings (K3, K4) on B·n rows.
        for name in kernels:
            if real:
                shapes["r" + name].add((b * n, n))
            shapes[name].add((b * (n // 2 + 1) if real else b * n, n))

    def cube(n: int, b: int) -> None:
        shapes["fft_rows"].add((b * n * n, n))

    def line(n: int, b: int) -> None:
        n1, n2 = four_step_factors(n)
        shapes["fft_rows"].update({(b * n2, n1), (b * n1, n2)})

    both = ("fft_rows", "fft_rows_transpose")
    for _, count, shape, real, _ in SERVE_STREAM:
        for b in {_bucket(k) for k in range(1, count + 1)}:
            if len(shape) == 2:
                square(shape[0], b, real, both)
            elif len(shape) == 3:
                cube(shape[0], b)
            else:
                line(shape[0], b)
    for b in {_bucket(size) for size in COHORT_SIZES}:
        square(N_BATCH, b, False, both)
        square(N_BATCH, b, True, both)
        cube(N_COHORT_CUBE, b)
        line(N_COHORT_LINE, b)
    for n, b in FUSED_BATCH_SHAPES:
        square(n, b, False, ("fft_rows_transpose",))
        square(n, b, True, ("fft_rows_transpose",))
    for n in (N_PFFT3, N_PFFT3_PAD):
        cube(n, 1)
    for n in (N_LARGE, N_LARGE_MEASURE):
        line(n, 1)
    # The distributed paths: each rank's (N/p, N) block, its panels, the
    # (hc/p, N) spectral rows of the real path's phase 2, and the fpm-pad
    # run's rows at their padded length.
    for n, p in ((N_DIST, 1), (N_DIST_GLOO, GLOO_RANKS)):
        rows = n // p
        shapes["fft_rows"].update((rows // k, n) for k in (1, *DIST_PANELS))
        shapes["fft_rows"].add((halfspec_cols(n, p) // p, n))
        shapes["fft_rows_transpose"].add((rows, n))
        shapes["rfft_rows"].add((rows, n))
    shapes["fft_rows"].add((N_DIST_PAD, 2 * N_DIST_PAD))
    # The 3-D mesh pipelines: a pass over each rank's pencil (or slab) rows,
    # N^2/q of them on q ranks, and its panels.
    for n, q in ((N_DIST3, 1), (N_DIST3_GLOO, GLOO_RANKS)):
        shapes["fft_rows"].update((n * n // q // k, n)
                                  for k in (1, *DIST3_PANELS))
    # The runtime's paths: each rank's block and panels at 1 and GLOO_RANKS
    # ranks and at the 2 left after the loss (a re-plan or a measured plan
    # may take any of them, fused or not); a probe's block is the same.
    for p in (1, 2, GLOO_RANKS):
        rows = N_RUNTIME // p
        for name in ("fft_rows", "fft_rows_transpose"):
            shapes[name].update((rows // k, N_RUNTIME) for k in (1, *DIST_PANELS))
    return shapes


def check_batched_shapes(gen: torch.Generator) -> None:
    """K1-K4 forward at the row blocks of ``batched_row_shapes`` (up to
    65536 rows of 8192, 2^29 elements) against their plain versions and the
    library, ``atol = row_fft_tol(n, False)``."""
    shapes = batched_row_shapes()
    for rows, n in sorted(shapes["fft_rows"] | shapes["fft_rows_transpose"]):
        x = random_signal(gen, rows, n)
        tol = row_fft_tol(n, False)
        plain = fft_rows_plain(x, radix=4)
        lib = torch.fft.fft(x)
        errs = {}
        if (rows, n) in shapes["fft_rows"]:
            got = fft_rows_op(x, radix=4)
            torch.cuda.synchronize()
            errs |= {"fft_rows_err": max_abs_err(got, plain),
                     "fft_rows_vs_library_err": max_abs_err(got, lib)}
            del got
        if (rows, n) in shapes["fft_rows_transpose"]:
            got = fft_rows_transpose_op(x, radix=4)
            torch.cuda.synchronize()
            errs |= {"fft_rows_transpose_err": max_abs_err(got, plain.T),
                     "fft_rows_transpose_vs_library_err": max_abs_err(got, lib.T)}
            del got
        log("kernels", batched=True, rows=rows, n=n, atol=tol, **errs)
        if max(errs.values()) > tol:
            raise AssertionError(f"complex row kernel disagrees at the batched "
                                 f"shape rows={rows} n={n}: {errs} > {tol}")
        del x, plain, lib
    for rows, n in sorted(shapes["rfft_rows"] | shapes["rfft_rows_transpose"]):
        x = random_real(gen, rows, n)
        tol = row_fft_tol(n, False)
        plain = rfft_rows_plain(x, radix=4)
        lib = torch.fft.rfft(x)
        errs = {}
        if (rows, n) in shapes["rfft_rows"]:
            got = rfft_rows_op(x, radix=4)
            torch.cuda.synchronize()
            errs |= {"rfft_rows_err": max_abs_err(got, plain),
                     "rfft_rows_vs_library_err": max_abs_err(got, lib)}
            del got
        if (rows, n) in shapes["rfft_rows_transpose"]:
            got = rfft_rows_transpose_op(x, radix=4)
            torch.cuda.synchronize()
            errs |= {"rfft_rows_transpose_err": max_abs_err(got, plain.T),
                     "rfft_rows_transpose_vs_library_err": max_abs_err(got, lib.T)}
            del got
        log("kernels", batched=True, rows=rows, n=n, atol=tol, **errs)
        if max(errs.values()) > tol:
            raise AssertionError(f"real row kernel disagrees at the batched "
                                 f"shape rows={rows} n={n}: {errs} > {tol}")
        del x, plain, lib


def check_transpose(gen: torch.Generator, worst: dict) -> None:
    """K5 bit for bit against its plain version and ``x.T.contiguous()``:
    float32 and complex64 at every shape, the other element sizes at the
    small ones."""
    worst["transpose"] = 0.0
    for r, c in TRANSPOSE_SHAPES:
        dtypes = [torch.float32, torch.complex64]
        if r * c < 1 << 20:
            dtypes += TRANSPOSE_OTHER_DTYPES
        for dtype in dtypes:
            x = random_real(gen, r, c)
            if dtype.is_complex:
                x = torch.complex(x, random_real(gen, r, c))
            x = (x * 100).to(dtype)
            got = transpose_op(x)
            torch.cuda.synchronize()
            exact = (torch.equal(got, transpose_plain(x))
                     and torch.equal(got, x.T.contiguous()))
            log("kernels", transpose=[r, c], dtype=str(dtype).removeprefix("torch."),
                bit_exact=exact)
            if not exact:
                raise AssertionError(f"transpose differs at {(r, c)} {dtype}")
            del x, got


def measured_fpms(n: int) -> tuple[FPMSet, FPMSet]:
    """Speed functions timed on the card over the port's ``fft_rows``.

    One function is measured and shared by the P abstract processors (the
    card is one device: identical functions -> POPTA).  The second set scales
    two processors' speeds down (-> HPOPTA, an imbalanced distribution) and
    marks them faster at one padded length each — a power of two (2N) and a
    non-power of two (5N/4) — so that the padded method of this smoke run
    pads whatever the card's own profile says.  That second set is synthetic
    on purpose; only the first is a model of the card.
    """
    xs = sorted({n // 8, n // 4, n // 2, n})
    ys = sorted({n // 2, n, 9 * n // 8, 5 * n // 4, 3 * n // 2, 2 * n})
    buf = torch.zeros(max(xs) * max(ys), dtype=torch.complex64, device="cuda")

    def timer(x: int, y: int) -> float:
        m = buf[: x * y].view(x, y)
        return time_ms(lambda: fft_rows(m), reps=5, warmup=1) * 1e-3

    base = build_fpm(xs, ys, timer, name="P0")
    homo = FPMSet([SpeedFunction(base.xs, base.ys, base.speed, name=f"P{i}")
                   for i in range(P)])
    slow_pow2 = base.speed * 0.5
    slow_pow2[:, ys.index(2 * n)] *= 8.0
    slow_odd = base.speed * 0.5
    slow_odd[:, ys.index(5 * n // 4)] *= 8.0
    hetero = FPMSet([SpeedFunction(base.xs, base.ys, sp, name=f"P{i}")
                     for i, sp in enumerate(
                         [base.speed, base.speed, slow_pow2, slow_odd])])
    return homo, hetero


def synthetic_pad_fpms(n: int) -> FPMSet:
    """Four processors with flat speed functions but for one length each:
    P2 eight times faster at 2N (a power-of-two pad) and P3 at 5N/4 (a
    non-power-of-two pad), so that the partition is balanced and both pads
    engage whatever the card's timings say.  A model of no device."""
    xs = np.array(sorted({1, n // 8, n // 4, n // 2, n}))
    ys = np.array([n, 5 * n // 4, 2 * n])
    flat = np.full((len(xs), len(ys)), 1e9)
    fast_pow2, fast_odd = flat.copy(), flat.copy()
    fast_pow2[:, 2] *= 8.0
    fast_odd[:, 1] *= 8.0
    return FPMSet([SpeedFunction(xs, ys, sp, name=f"P{i}")
                   for i, sp in enumerate([flat, flat, fast_pow2, fast_odd])])


def padded_oracle(signal: torch.Tensor, d, pads) -> torch.Tensor:
    """PFFT-FPM-PAD's semantics written out with the library alone: each
    processor's rows zero-padded to its length, transformed, cropped back to
    N bins; rows -> T -> rows -> T."""
    n = signal.shape[-1]

    def phase(mat: torch.Tensor) -> torch.Tensor:
        parts, off = [], 0
        for rows, length in zip(d.tolist(), pads.tolist()):
            if rows == 0:  # an idle processor: no rows, no transform
                continue
            seg = mat[off:off + rows]
            if length > n:
                seg = torch.nn.functional.pad(seg, (0, length - n))
            parts.append(torch.fft.fft(seg, dim=-1)[:, :n])
            off += rows
        return torch.cat(parts, 0)

    return phase(phase(signal).T).T


def check_execute(plan, signal, oracle, label: str, expect: dict[str, int],
                  runs: list[tuple], phase: str = "main_path") -> None:
    """One execute of ``plan``: right against ``oracle``, and through the
    kernels exactly as often as ``expect`` says (launch-count deltas; a
    kernel ``expect`` does not name must not launch)."""
    before = launch_counts()
    out = plan.execute(signal)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    expect = {k: expect.get(k, 0) for k in delta}
    tol = 2e-4 * plan.n
    err = max_abs_err(out, oracle)
    log(phase, run=label, method=plan.method, n=plan.n,
        config=plan.config.describe(), d=plan.d.tolist(),
        pad_lengths=None if plan.pad_lengths is None else plan.pad_lengths.tolist(),
        schedule=plan.schedule.describe(), max_abs_err=err, atol=tol,
        launches=delta)
    if err > tol:
        raise AssertionError(f"{label}: max error {err} > {tol}")
    if delta != expect:
        raise AssertionError(f"{label}: launches {delta}, expected {expect}")
    runs.append((label, plan, signal, delta))


def phase_fpms() -> dict[int, tuple[FPMSet, FPMSet]]:
    """The FPMs of both paths, timed on the card before any counted drive."""
    fpms = {}
    for n in sorted({N_UNPADDED, N_PADDED, N_WIDE}):
        t0 = time.perf_counter()
        fpms[n] = measured_fpms(n)
        homo = fpms[n][0]
        log("main_path", step="fpm", n=n, seconds=round(time.perf_counter() - t0, 2),
            xs=homo[0].xs.tolist(), ys=homo[0].ys.tolist(),
            gflops=np.round(homo[0].speed / 1e9, 1).tolist())
    return fpms


def record_launches(name: str, counts: dict[str, int]) -> int:
    """The launches of the kernel of record ``name`` among ``counts``: the
    cluster kernels' records (``fft_rows_large``, K1b at n <= 65536;
    ``fft_rows_transpose_large``, K2b there) take the kernel's launches less
    its two passes' (``<name>_two_pass``) and, for K1b, less its cluster
    kernel's at 2^17 and 2^18 (``fft_rows_large_long``, that record's own),
    and K2's, K3's and K4's (``fft_rows_transpose``, ``rfft_rows``,
    ``rfft_rows_transpose``) less their own sources' at n = 16384
    (``<name>_16k``, their ``at_16384`` records' own), so that each record
    counts its own source's."""
    if name == "fft_rows_large":
        return counts[name] - counts[name + "_two_pass"] - counts[name + "_long"]
    if name == "fft_rows_transpose_large":
        return counts[name] - counts[name + "_two_pass"]
    if name in WIDE_SOURCES:
        return counts[name] - counts.get(name + "_16k", 0)
    return counts[name]


def call_launches(calls) -> dict[str, int]:
    """The launches of row-kernel calls ``(kernel, rows, n)``: one a call of a
    row kernel up to n = 16384 (K2's, K3's and K4's at 16384 also under
    ``<kernel>_16k``, their own sources), and above it the four-step's own
    (``<kernel>_large``): K1b's cluster kernel once a call up to
    ``CLUSTER_MAX_N`` (above 65536 also under ``fft_rows_large_long``), K2b's
    at ``TRANSPOSE_CLUSTER_LENGTHS``; else two
    (passes A, B) per chunk of ``scratch_rows(n)`` rows (row pairs for the
    real kernels, whose pass B splits), K1b's and K2b's also under
    ``<kernel>_large_two_pass``.  Calls with no rows launch nothing.  The
    ``fft_rows_transpose`` calls are fused plans' phases, which pad the
    output's stride from n = 16384 on where rows % 4 != 0: one
    ``fft_rows_transpose_padded`` a call of the cluster kernel, or a chunk
    of the two passes."""
    out: dict[str, int] = {}
    for name, rows, n in calls:
        if rows == 0:
            continue
        if name == "fft_rows_transpose" and padded_out_stride(n, rows) > rows:
            chunks = 1 if n <= max(TRANSPOSE_CLUSTER_LENGTHS) else -(-rows // scratch_rows(n))
            out["fft_rows_transpose_padded"] = out.get("fft_rows_transpose_padded", 0) + chunks
        if n <= MAX_KERNEL_N:
            out[name] = out.get(name, 0) + 1
            if n == MAX_KERNEL_N and name in WIDE_SOURCES:
                out[name + "_16k"] = out.get(name + "_16k", 0) + 1
            continue
        if ((name == "fft_rows" and n <= CLUSTER_MAX_N)
                or (name == "fft_rows_transpose" and n in TRANSPOSE_CLUSTER_LENGTHS)):
            out[name + "_large"] = out.get(name + "_large", 0) + 1
            if name == "fft_rows" and n > 1 << 16:
                out["fft_rows_large_long"] = out.get("fft_rows_large_long", 0) + 1
            continue
        units = (rows + 1) // 2 if name.startswith("rfft") else rows
        launches = 2 * -(-units // scratch_rows(n))
        out[name + "_large"] = out.get(name + "_large", 0) + launches
        if name in ("fft_rows", "fft_rows_transpose"):
            key = name + "_large_two_pass"
            out[key] = out.get(key, 0) + launches
    return out


def end_drive(path: str, kernels: tuple[str, ...]) -> dict[str, int]:
    """Read the counts just after a path's drive; each of its kernels must
    have launched."""
    counts = launch_counts()
    log(path, launches=counts)
    for name in kernels:
        if counts[name] < 1:
            raise AssertionError(f"the {path} path never launched {name}")
    return counts


def phase_main_path(gen: torch.Generator, fpms,
                    card: str) -> tuple[dict[str, int], list[tuple]]:
    """Drive the complex main path once, with the launch counts set to 0 just
    before and read just after.  Returns the counts and the checked runs (for
    the timing pass, which is not part of the counted drive); the N = 32768
    runs, too large to keep, are timed here after the drive."""
    library = PlanConfig()
    kernel = PlanConfig(radix=4)
    fused = PlanConfig(fused=True)
    none: dict[str, int] = {}
    runs: list[tuple] = []

    reset_launch_counts()          # ---- the main path's single drive starts

    # PFFT-LB and PFFT-FPM at the full width, exact against torch.fft.fft2.
    n = N_UNPADDED
    signal = random_signal(gen, n, n)
    oracle = torch.fft.fft2(signal)
    homo, hetero = fpms[n]
    for method, kwargs in (("lb", {"p": P}), ("fpm", {"fpms": homo}),
                           ("fpm", {"fpms": hetero})):
        tag = method + ("-hetero" if kwargs.get("fpms") is hetero else "")
        for cfg, expect in ((library, none),
                            (kernel, {"fft_rows": 2, "fft_rows_transpose": 0}),
                            (fused, {"fft_rows": 0, "fft_rows_transpose": 2})):
            plan = plan_pfft(n, method=method, config=cfg, **kwargs)
            check_execute(plan, signal, oracle, f"{tag}/{cfg.describe()}",
                          expect, runs)
    if len(set(plan_pfft(n, method="fpm", fpms=hetero).d.tolist())) < 2:
        raise AssertionError("the heterogeneous FPMs gave a balanced distribution")
    del oracle

    # PFFT-FPM-CZT (exact) and PFFT-FPM-PAD (padded-signal semantics: the
    # kernel config against the same plan under the library config).
    n = N_PADDED
    signal = random_signal(gen, n, n)
    oracle = torch.fft.fft2(signal)
    homo, hetero = fpms[n]
    for tag, model in (("fpm-czt", homo), ("fpm-czt-hetero", hetero)):
        for cfg in (library, kernel):
            # Bluestein's inner FFTs are the library's under every config.
            plan = plan_pfft(n, method="fpm-czt", fpms=model, config=cfg)
            check_execute(plan, signal, oracle, f"{tag}/{cfg.describe()}",
                          none, runs)
    for tag, model in (("fpm-pad", homo), ("fpm-pad-hetero", hetero)):
        plan = plan_pfft(n, method="fpm-pad", fpms=model, config=library)
        ref = padded_oracle(signal, plan.d, plan.pad_lengths)
        check_execute(plan, signal, ref, f"{tag}/{library.describe()}", none, runs)
        # Under the kernel config every power-of-two group of both phases
        # goes through the kernel; groups of any other length go to the
        # library by fft_rows' own rule, in the same phase.
        plan = plan_pfft(n, method="fpm-pad", fpms=model, config=kernel)
        pow2_groups = sum(1 for length, _, _ in plan.schedule.batch_groups()
                          if not length & (length - 1))
        check_execute(plan, signal, ref, f"{tag}/{kernel.describe()}",
                      {"fft_rows": 2 * pow2_groups, "fft_rows_transpose": 0}, runs)
    hetero_pads = plan_pfft(n, method="fpm-pad", fpms=hetero).pad_lengths.tolist()
    if not any(length > n for length in hetero_pads):
        raise AssertionError(f"the padded run did not pad: {hetero_pads}")
    del oracle, ref

    # Batches: (2, N, N) through execute, three host signals through
    # execute_many, and radix=2 + fused, which still runs the fused kernel.
    # Each phase runs once over the rows of both signals: the launches of
    # one signal.
    n = N_BATCH
    batch = random_signal(gen, 2, n, n)
    oracle = torch.fft.fft2(batch)
    for cfg, expect in ((kernel, {"fft_rows": 2, "fft_rows_transpose": 0}),
                        (fused, {"fft_rows": 0, "fft_rows_transpose": 2}),
                        (PlanConfig(radix=2, fused=True),
                         {"fft_rows": 0, "fft_rows_transpose": 2})):
        plan = plan_pfft(n, p=P, method="lb", config=cfg)
        check_execute(plan, batch, oracle, f"batch2-lb/{cfg.describe()}",
                      expect, runs)
    rng = np.random.default_rng(SEED)
    hosts = [(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
              ).astype(np.complex64) for _ in range(3)]
    plan = plan_pfft(n, p=P, method="lb", config=fused)
    outs = plan.execute_many(hosts, pad_to=4)
    err = max(float(np.abs(o - np.fft.fft2(h)).max()) for o, h in zip(outs, hosts))
    log("main_path", run="execute_many/3 of 4", n=n, max_abs_err=err,
        atol=2e-4 * n)
    if len(outs) != 3 or err > 2e-4 * n:
        raise AssertionError(f"execute_many: {len(outs)} results, error {err}")
    del batch, oracle, hosts, outs

    # PFFT-LB and PFFT-FPM at K1's and K2's longest row, N = 16384 (a 2 GiB
    # signal), under the kernel and fused configs, against torch.fft.fft2.
    n = N_WIDE
    signal = random_signal(gen, n, n)
    oracle = torch.fft.fft2(signal)
    for method, kwargs in (("lb", {"p": P}), ("fpm", {"fpms": fpms[n][0]})):
        for cfg, expect in ((kernel, call_launches([("fft_rows", n, n)] * 2)),
                            (fused, call_launches([("fft_rows_transpose", n, n)] * 2))):
            plan = plan_pfft(n, method=method, config=cfg, **kwargs)
            check_execute(plan, signal, oracle, f"{method}-{n}/{cfg.describe()}",
                          expect, runs)
    del oracle
    torch.cuda.empty_cache()

    # PFFT-LB at N = 32768 (an 8 GiB signal) through K1b, each dispatch group
    # of each phase one call, and fused through K2b, each phase one call.
    n = N_K1B
    big = random_signal(gen, n, n)
    oracle = torch.fft.fft2(big)
    big_runs: list[tuple] = []
    big_plan = plan_pfft(n, p=P, method="lb", config=kernel)
    expect = call_launches([("fft_rows", len(rows), length)
                            for length, _, rows in big_plan.schedule.batch_groups()] * 2)
    check_execute(big_plan, big, oracle, f"lb-{n}/{kernel.describe()}", expect, big_runs)
    big_plan = plan_pfft(n, p=P, method="lb", config=fused)
    check_execute(big_plan, big, oracle, f"lb-{n}/{fused.describe()}",
                  call_launches([("fft_rows_transpose", n, n)] * 2), big_runs)
    del oracle, big_plan

    # ---- the main path's single drive ends
    counts = end_drive("main_path", ("fft_rows", "fft_rows_transpose", "fft_rows_large",
                                     "fft_rows_transpose_large"))
    time_runs(big_runs, card, reps=3)
    del big, big_runs
    torch.cuda.empty_cache()
    return counts, runs


def phase_main_path_real(gen: torch.Generator, fpms,
                         card: str) -> tuple[dict[str, int], list[tuple]]:
    """Drive the real-input path once (``rfft-*`` plans, ``rfft2`` /
    ``irfft2``), with the launch counts set to 0 just before and read just
    after.  Returns the counts and the checked runs; the runs above 16384,
    too large to keep, are timed here after the drive."""
    library = PlanConfig()
    kernel = PlanConfig(radix=4)
    fused = PlanConfig(fused=True)
    unfused_kernels = {"rfft_rows": 1, "fft_rows": 1}
    fused_kernels = {"rfft_rows_transpose": 1, "fft_rows_transpose": 1}
    runs: list[tuple] = []

    reset_launch_counts()          # ---- the real path's single drive starts

    # rfft-lb and rfft-fpm at the full width, against torch.fft.rfft2.  Both
    # phases are one dispatch group each (phase 2 covers N//2+1 rows).
    n = N_UNPADDED
    signal = random_real(gen, n, n)
    oracle = torch.fft.rfft2(signal)
    homo, hetero = fpms[n]
    for method, kwargs in (("rfft-lb", {"p": P}), ("rfft-fpm", {"fpms": homo}),
                           ("rfft-fpm", {"fpms": hetero})):
        tag = method + ("-hetero" if kwargs.get("fpms") is hetero else "")
        for cfg, expect in ((library, {}), (kernel, unfused_kernels),
                            (fused, fused_kernels)):
            plan = plan_pfft(n, method=method, config=cfg, dtype="float32", **kwargs)
            check_execute(plan, signal, oracle, f"{tag}/{cfg.describe()}",
                          expect, runs, "main_path_real")
    del oracle

    # rfft-fpm-pad at N = 4096 (padded-signal semantics): against the complex
    # fpm-pad plan's half spectrum on the upcast signal and against the
    # library-only padded oracle.  Under the kernel config every power-of-two
    # group of phase 1 goes to K3 and of the clipped phase 2 to K1.
    n = N_PADDED
    nh = n // 2 + 1
    signal = random_real(gen, n, n)
    homo, hetero = fpms[n]
    for tag, model in (("rfft-fpm-pad", homo), ("rfft-fpm-pad-hetero", hetero)):
        ref_plan = plan_pfft(n, method="fpm-pad", fpms=model, config=library)
        plan = plan_pfft(n, method="rfft-fpm-pad", fpms=model, config=library,
                         dtype="float32")
        busy = plan.d > 0
        if not np.array_equal(plan.pad_lengths[busy], ref_plan.pad_lengths[busy]):
            raise AssertionError(f"{tag}: real pads {plan.pad_lengths} differ "
                                 f"from complex pads {ref_plan.pad_lengths}")
        upcast = signal.to(torch.complex64)
        ref = ref_plan.execute(upcast)[:, :nh]
        err = max_abs_err(ref, padded_oracle(upcast, plan.d, plan.pad_lengths)[:, :nh])
        if err > 2e-4 * n:
            raise AssertionError(f"{tag}: complex plan vs padded oracle {err}")
        check_execute(plan, signal, ref, f"{tag}/{library.describe()}", {}, runs,
                      "main_path_real")
        plan = plan_pfft(n, method="rfft-fpm-pad", fpms=model, config=kernel,
                         dtype="float32")
        groups1, groups2 = plan._groups
        calls = [(name, len(idx), length) for name, groups in (("rfft_rows", groups1),
                                                               ("fft_rows", groups2))
                 for length, _, idx, _ in groups if not length & (length - 1)]
        check_execute(plan, signal, ref, f"{tag}/{kernel.describe()}",
                      call_launches(calls), runs, "main_path_real")
    hetero_pads = plan_pfft(n, method="rfft-fpm-pad", fpms=hetero,
                            dtype="float32").pad_lengths.tolist()
    if not any(length > n for length in hetero_pads):
        raise AssertionError(f"the padded real run did not pad: {hetero_pads}")
    del ref, upcast

    # A (2, N, N) real batch (the launches of one signal), execute_many of
    # three host signals, and irfft2(rfft2(x)) at the full width.
    n = N_BATCH
    batch = random_real(gen, 2, n, n)
    oracle = torch.fft.rfft2(batch)
    for cfg, expect in ((kernel, unfused_kernels), (fused, fused_kernels)):
        plan = plan_pfft(n, p=P, method="rfft-lb", config=cfg, dtype="float32")
        check_execute(plan, batch, oracle, f"batch2-rfft-lb/{cfg.describe()}",
                      expect, runs, "main_path_real")
    rng = np.random.default_rng(SEED)
    hosts = [rng.standard_normal((n, n)).astype(np.float32) for _ in range(3)]
    plan = plan_pfft(n, p=P, method="rfft-lb", config=fused, dtype="float32")
    outs = plan.execute_many(hosts, pad_to=4)
    err = max(float(np.abs(o - np.fft.rfft2(h)).max()) for o, h in zip(outs, hosts))
    log("main_path_real", run="execute_many/3 of 4", n=n, max_abs_err=err,
        atol=2e-4 * n)
    if len(outs) != 3 or err > 2e-4 * n or outs[0].shape != (n, n // 2 + 1):
        raise AssertionError(f"execute_many: {len(outs)} results, error {err}")

    n = N_UNPADDED
    x = random_real(gen, n, n)
    back = irfft2(rfft2(x))
    torch.cuda.synchronize()
    err = max_abs_err(back, x)
    log("main_path_real", run="irfft2(rfft2(x))", n=n, max_abs_err=err, atol=1e-4)
    if err > 1e-4 or back.dtype != torch.float32:
        raise AssertionError(f"irfft2(rfft2(x)): error {err}, dtype {back.dtype}")
    del x, back

    # rfft-lb at N = 32768 (a 4 GiB real signal) against torch.fft.rfft2:
    # under radix=4 phase 1 is one call of K3b over the N rows and phase 2
    # one of K1b over the N//2+1 spectral rows; fused, K4b then K2b.
    n = N_K1B
    nh = n // 2 + 1
    big_runs: list[tuple] = []
    big = random_real(gen, n, n)
    oracle = torch.fft.rfft2(big)
    for cfg, names in ((kernel, ("rfft_rows", "fft_rows")),
                       (fused, ("rfft_rows_transpose", "fft_rows_transpose"))):
        plan = plan_pfft(n, p=P, method="rfft-lb", config=cfg, dtype="float32")
        check_execute(plan, big, oracle, f"rfft-lb-{n}/{cfg.describe()}",
                      call_launches([(names[0], n, n), (names[1], nh, n)]), big_runs,
                      "main_path_real")
    del oracle, plan

    # rfft-fpm-pad at N = 16384 with the heterogeneous FPMs, the processor
    # that pads to 2N = 32768 (their P2) first: phase 2 runs on the first
    # N//2+1 rows, so its segment keeps rows there too.  Under radix=4
    # phase 1 runs K3 on the group of 16384 and K3b on the group of 32768,
    # phase 2 K1 and K1b; against the complex fpm-pad plan's half spectrum
    # on the upcast signal.
    n = N_WIDE
    nh = n // 2 + 1
    hetero = FPMSet([fpms[n][1][i] for i in (2, 0, 1, 3)])
    wide = random_real(gen, n, n)
    ref_plan = plan_pfft(n, method="fpm-pad", fpms=hetero, config=library)
    ref = ref_plan.execute(wide.to(torch.complex64))[:, :nh]
    plan = plan_pfft(n, method="rfft-fpm-pad", fpms=hetero, config=kernel, dtype="float32")
    busy = plan.d > 0
    if (not np.array_equal(plan.pad_lengths[busy], ref_plan.pad_lengths[busy])
            or 2 * n not in plan.pad_lengths[busy].tolist()):
        raise AssertionError(f"rfft-fpm-pad at {n}: pads {plan.pad_lengths.tolist()}, "
                             f"complex {ref_plan.pad_lengths.tolist()}, none of {2 * n}")
    groups1, groups2 = plan._groups
    calls = [(name, len(idx), length) for name, groups in (("rfft_rows", groups1),
                                                           ("fft_rows", groups2))
             for length, _, idx, _ in groups if not length & (length - 1)]
    expect = call_launches(calls)
    if not {"rfft_rows", "rfft_rows_large", "fft_rows", "fft_rows_large"} <= set(expect):
        raise AssertionError(f"rfft-fpm-pad at {n}: groups {calls} miss a kernel")
    check_execute(plan, wide, ref, f"rfft-fpm-pad-hetero-{n}/{kernel.describe()}",
                  expect, big_runs, "main_path_real")
    del ref, ref_plan, plan

    # Fused rfft-lb at N = 16384 on the same 1 GiB real signal, against
    # torch.fft.rfft2: phase 1 one call of K4 over the N rows, phase 2 one of
    # K2 over the N//2+1 spectral rows, each its own source at 16384
    # (rfft_rows_transpose_16k.cu, fft_rows_transpose_cluster.cu), K2 at a
    # padded stride.
    oracle = torch.fft.rfft2(wide)
    wide_plan = plan_pfft(n, p=P, method="rfft-lb", config=fused, dtype="float32")
    check_execute(wide_plan, wide, oracle, f"rfft-lb-{n}/{fused.describe()}",
                  call_launches([("rfft_rows_transpose", n, n), ("fft_rows_transpose", nh, n)]),
                  big_runs, "main_path_real")
    del oracle

    # ---- the real path's single drive ends
    counts = end_drive("main_path_real", (
        "rfft_rows", "rfft_rows_transpose", "fft_rows", "fft_rows_transpose",
        "rfft_rows_large", "rfft_rows_transpose_large", "fft_rows_large",
        "fft_rows_transpose_large", "rfft_rows_transpose_16k", "fft_rows_transpose_16k"))
    time_runs(big_runs, card, reps=3)
    # Its answer is phase 2's padded buffer itself: two kernels on the card
    # and no copy.
    answer: list[torch.Tensor] = []
    with recorded_outputs() as buffers:
        seen = launches_of(lambda: answer.append(wide_plan.execute(wide)))
    checks = {"padded_stride": answer[0].stride() == (padded_out_stride(n, nh), 1),
              "shares_phase2_buffer": (answer[0].untyped_storage().data_ptr()
                                       == buffers[-1].untyped_storage().data_ptr()),
              "two_kernels": seen["device_kernels"] == 2}
    log("main_path_real", run=f"rfft-lb-{n}/fused answer", stride=list(answer[0].stride()),
        device_kernels=seen["device_kernels"], **checks)
    if not all(checks.values()):
        raise AssertionError(f"fused rfft-lb at {n}: the answer is not phase 2's "
                             f"padded buffer: {checks}, {seen}")
    del answer, buffers, wide_plan
    # The fused rfft-lb plan's two phases at N = 16384 alone: K4 on the N
    # real rows, K2 on its (N//2+1, N) output, dense and at the padded stride.
    spec = rfft_rows_transpose_op(wide)
    log("main_path_time", card=card, run=f"rfft-lb-{N_WIDE}/fused phases", n=N_WIDE,
        phase1_rfft_rows_transpose_ms=time_ms(lambda: rfft_rows_transpose_op(wide), reps=5),
        phase2_fft_rows_transpose_ms=time_ms(lambda: fft_rows_transpose_op(spec), reps=5),
        phase2_padded_ms=time_ms(lambda: fft_rows_transpose_op(spec, pad_stride=True),
                                 reps=5))
    del big, wide, big_runs, spec
    torch.cuda.empty_cache()
    return counts, runs


def planned_oracle(plan, signal: torch.Tensor) -> torch.Tensor:
    """What ``plan.execute(signal)`` must give: the library's 2-D FFT (half
    spectrum for a real method), or the padded-signal oracle."""
    if plan.method.endswith("fpm-pad"):
        return padded_oracle(signal, plan.d, plan.pad_lengths)
    return torch.fft.rfft2(signal) if plan.method.startswith("rfft-") \
        else torch.fft.fft2(signal)


def timed_plan(**kwargs):
    """``plan_pfft(**kwargs)`` with its host time and the kernel launches
    made while planning (a measured plan races the kernels)."""
    before = launch_counts()
    t0 = time.perf_counter()
    plan = plan_pfft(**kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    return plan, seconds, delta


def check_planned(plan, signal: torch.Tensor, label: str, runs: list[tuple],
                  **fields) -> None:
    """Execute a tuned plan once against its oracle (``2e-4·N``) and log its
    pick beside the top three of its ranking."""
    oracle = planned_oracle(plan, signal)
    before = launch_counts()
    out = plan.execute(signal)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    err = max_abs_err(out, oracle)
    tol = 2e-4 * plan.n
    top3 = [(PlanConfig.from_dict(c).describe(), t)
            for c, t in plan.tuning.get("ranked", [])[:3]]
    log("planner", run=label, method=plan.method, n=plan.n,
        source=plan.tuning["source"], pick=plan.schedule.describe(),
        chosen_path=plan.tuning.get("chosen_path"),
        calibrated=plan.tuning.get("calibrated"), top3=top3,
        pad_lengths=None if plan.pad_lengths is None else plan.pad_lengths.tolist(),
        max_abs_err=err, atol=tol, execute_launches=delta, **fields)
    if err > tol:
        raise AssertionError(f"{label}: max error {err} > {tol}")
    runs.append((label, plan, signal, delta))


def race_pot(store: str | None, n: int, d, real: bool,
             committed: CostParams) -> dict:
    """Race the whole candidate pot of an (n, d) problem on the card, as
    the reference's planner microbenchmark does; with a ``store``, record
    each candidate's time there as a calibration sample (keys
    ``...|race=<config>``, which no plan looks up; ``d`` is then the lb
    partition the fit assumes for a bare config)."""
    cands = candidate_configs(n, d=d)
    events: dict = {}
    if real:
        pot = [dataclasses.replace(c, real=True) for c in cands] + cands
        times = measure_rfft_configs(pot, n, d=d, events=events)
    else:
        times = measure_configs(cands, n, d=d, events=events)
    if store is not None:
        key = wisdom_key(n=n, dtype="complex64", p=len(d), method="lb",
                         backend="cuda")
        for cfg, t in times.items():
            record_wisdom(store, f"{key}|race={cfg.describe()}", cfg,
                          mode="measure", time_s=t)
    return {"n": n, "d": [int(r) for r in d], "real": real, "times": times,
            "events": events,
            "committed": {c: estimate_cost(c, n=n, d=d, params=committed)
                          for c in times}}


def phase_planner(gen: torch.Generator, fpms, records: list[dict],
                  card: str) -> tuple[dict[str, int], list[tuple]]:
    """Drive the planner once, with the launch counts set to 0 just before
    and read just after: (a) estimate at full width, (b) measure into a
    fresh wisdom file and race the candidate pots, (c) the same plans from
    the warm store and a ``PlanCache``, (d) calibrate.  K1-K4 must each
    launch (the races run every candidate)."""
    n = N_UNPADDED
    homo, hetero = fpms[n]
    committed = CostParams.for_backend("cuda")
    lib_ms = next(r["library_ms"] for r in records if r["name"] == "fft_rows")
    log("planner", card=card, committed=dataclasses.asdict(committed),
        library_rate_flops=float(fft_flops(*MAIN_SHAPE)) / (lib_ms * 1e-3))
    signals = {}
    for m in PLANNER_N:
        signals[m] = (random_signal(gen, m, m), random_real(gen, m, m))
    runs: list[tuple] = []

    reset_launch_counts()          # ---- the planner's single drive starts

    # (a) estimate at full width over the card-timed FPMs, and over the
    # synthetic hetero ones for the padded method (pads up to 2N).
    complex_sig, real_sig = signals[n]
    est = {}
    for method, model, sig, dtype in (("fpm", homo, complex_sig, "complex64"),
                                      ("rfft-fpm", homo, real_sig, "float32"),
                                      ("fpm-pad", hetero, complex_sig, "complex64")):
        plan, seconds, delta = timed_plan(n=n, method=method, fpms=model,
                                          tune="estimate", dtype=dtype)
        if any(delta.values()):
            raise AssertionError(f"estimate {method} launched {delta}")
        est[method] = plan
        check_planned(plan, sig, f"estimate/{method}", runs, plan_s=seconds)

    # (b) measure into a fresh wisdom file: >= 8 problems, then the pots.
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "wisdom.json")
        problems = []
        for m in PLANNER_N:
            problems += [(dict(n=m, p=P, method="lb"), signals[m][0]),
                         (dict(n=m, p=P, method="rfft-lb", dtype="float32"),
                          signals[m][1])]
        problems.append((dict(n=n, fpms=hetero, method="fpm-pad"), complex_sig))
        cold = {}
        for kwargs, sig in problems:
            plan, seconds, delta = timed_plan(tune="measure", wisdom=store, **kwargs)
            label = f"measure/{kwargs['method']}/{kwargs['n']}"
            cold[label] = seconds
            if plan.tuning["source"] != "measure":
                raise AssertionError(f"{label}: source {plan.tuning['source']}")
            check_planned(plan, sig, label, runs, plan_s=seconds,
                          plan_launches=delta,
                          measured=plan.tuning.get("measured"),
                          measured_event_s=plan.tuning.get("measured_event_s"),
                          group_measured=plan.tuning.get("group_measured"))
        padded = plan
        if 2 * n not in padded.pad_lengths.tolist():
            raise AssertionError(f"fpm-pad did not pad to 2N: {padded.pad_lengths}")

        # The lb pots are calibration samples; at N = 8192 the pots of the
        # estimated fpm / rfft-fpm plans (their d) say whether the
        # estimate's pick is the measured winner.
        races = {("lb", m): race_pot(store, m, lb_partition(m, P).d, False,
                                     committed) for m in PLANNER_N}
        fpm_d = est["fpm"].d
        races["fpm"] = (races[("lb", n)] if np.array_equal(fpm_d, lb_partition(n, P).d)
                        else race_pot(None, n, fpm_d, False, committed))
        races["rfft-fpm"] = race_pot(None, n, est["rfft-fpm"].d, True, committed)
        fitted = fit_cost_params(store)
        with open(store) as fh:
            entries = len(json.load(fh)["entries"])
        log("planner", step="fit", card=card, entries=entries,
            fitted=dataclasses.asdict(fitted))
        for name, race in races.items():
            winner = min(race["times"], key=race["times"].get)
            for cfg, t in sorted(race["times"].items(), key=lambda kv: kv[1]):
                log("planner", race=str(name), n=race["n"], d=race["d"],
                    config=cfg.describe(), measured_s=t,
                    event_s=race["events"].get(cfg),
                    est_committed_s=race["committed"][cfg],
                    est_fitted_s=estimate_cost(cfg, n=race["n"], d=np.asarray(race["d"]),
                                               params=fitted),
                    winner=cfg == winner)
            if name in est:
                pick = est[name].config
                log("planner", race=name, estimate_pick=pick.describe(),
                    measured_winner=winner.describe(),
                    pick_is_winner=pick == winner,
                    pick_over_winner=race["times"][pick] / race["times"][winner])

        # (c) warm: the same plan calls served from the store, no launch
        # while planning; then a PlanCache hit.
        warm = {}
        for kwargs, _ in problems:
            plan, seconds, delta = timed_plan(tune="measure", wisdom=store, **kwargs)
            label = f"measure/{kwargs['method']}/{kwargs['n']}"
            warm[label] = seconds
            if plan.tuning["source"] != "wisdom" or any(delta.values()):
                raise AssertionError(f"warm {label}: source "
                                     f"{plan.tuning['source']}, launches {delta}")
        cache = PlanCache()
        kwargs = problems[-1][0]
        cache.get("fpm-pad", lambda: plan_pfft(tune="measure", wisdom=store, **kwargs))
        t0 = time.perf_counter()
        _, hit = cache.get("fpm-pad", lambda: plan_pfft(tune="measure", wisdom=store,
                                                        **kwargs))
        cache_s = time.perf_counter() - t0
        if not hit:
            raise AssertionError("PlanCache missed a key it holds")
        log("planner", step="plan_host_s", card=card, cold_measure=cold,
            warm_wisdom=warm, plan_cache_hit=cache_s, cache=cache.stats_dict())

        # (d) calibrate: the store's fit, and a tuned plan that uses it.
        plan, seconds, delta = timed_plan(n=n, p=2, method="lb", tune="estimate",
                                          wisdom=store)
        log("planner", step="calibrate", fit=dataclasses.asdict(fit_cost_params(store)),
            calibrated=plan.tuning["calibrated"], pick=plan.schedule.describe(),
            plan_s=seconds)
        if not plan.tuning["calibrated"]:
            raise AssertionError("a store of measured entries left the model uncalibrated")

    # ---- the planner's single drive ends
    return end_drive("planner", ("fft_rows", "fft_rows_transpose", "rfft_rows",
                                 "rfft_rows_transpose")), runs


def phase_microbench_fused(gen: torch.Generator, card: str) -> dict[str, int]:
    """The reference microbenchmark's ``fused`` sweep: the unfused phase
    ``transpose_op(fft_rows_op(m))`` (two launches) against the fused
    ``fft_rows_transpose_op(m)`` (one), checked equal, then timed.  The
    counted drive is the check; the timing follows it."""
    reset_launch_counts()          # ---- the microbenchmark's drive starts
    signals = {}
    for n in MICROBENCH_N:
        m = random_signal(gen, n, n)
        unfused = transpose_op(fft_rows_op(m))
        fused = fft_rows_transpose_op(m)
        torch.cuda.synchronize()
        tol = 1e-3 * math.sqrt(n)
        errs = {"unfused_vs_fused_err": max_abs_err(unfused, fused),
                "fused_vs_library_err": max_abs_err(fused, torch.fft.fft(m).T)}
        log("microbench_fused", n=n, atol=tol, **errs)
        if max(errs.values()) > tol:
            raise AssertionError(f"microbench_fused at n={n}: {errs} > {tol}")
        signals[n] = m
        del unfused, fused
    counts = end_drive("microbench_fused", ("fft_rows", "fft_rows_transpose",
                                            "transpose"))
    for n, m in signals.items():
        log("microbench_fused", card=card, n=n,
            unfused_ms=time_ms(lambda: transpose_op(fft_rows_op(m)), reps=20),
            fused_ms=time_ms(lambda: fft_rows_transpose_op(m), reps=20),
            torch_fft_T_contiguous_ms=time_ms(lambda: torch.fft.fft(m).T.contiguous(),
                                              reps=20))
    return counts


def signal_tol(elements: int) -> float:
    """``2e-4·sqrt(elements of one signal)``: the 2-D rule ``2e-4·N`` carried
    to a cube (``2e-4·N^1.5``) and a line (``2e-4·sqrt(N)``)."""
    return 2e-4 * math.sqrt(elements)


def check_run(phase: str, label: str, fn, oracle: torch.Tensor,
              expect: dict[str, int], tol: float, **fields) -> torch.Tensor:
    """``fn()`` once: within ``tol`` of ``oracle`` and through the kernels
    exactly as often as ``expect`` says (a kernel it does not name must not
    launch).  Returns the result."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    expect = {k: expect.get(k, 0) for k in delta}
    err = max_abs_err(out, oracle)
    log(phase, run=label, max_abs_err=err, atol=tol, launches=delta, **fields)
    if err > tol:
        raise AssertionError(f"{label}: max error {err} > {tol}")
    if delta != expect:
        raise AssertionError(f"{label}: launches {delta}, expected {expect}")
    return out


def planned(make):
    """``make()`` (a plan factory) with its host seconds and the kernel
    launches made while planning."""
    before = launch_counts()
    t0 = time.perf_counter()
    plan = make()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return plan, seconds, {k: v - before[k] for k, v in launch_counts().items()}


def padded_oracle3(cube: torch.Tensor, d, pads) -> torch.Tensor:
    """PFFT3-FPM-PAD's semantics written out with the library alone: three
    passes, each padding every processor's planes' rows to its length,
    transforming, cropping back to N bins, then rotating the axes."""
    n = cube.shape[-1]
    for _ in range(3):
        parts, off = [], 0
        for rows, length in zip(d.tolist(), pads.tolist()):
            if rows == 0:
                continue
            seg = cube[off:off + rows]
            if length > n:
                seg = torch.nn.functional.pad(seg, (0, length - n))
            parts.append(torch.fft.fft(seg, dim=-1)[..., :n])
            off += rows
        cube = torch.cat(parts, 0).movedim(-1, 0).contiguous()
    return cube


def phase_pfft3(gen: torch.Generator, card: str) -> dict[str, int]:
    """Drive the 3-D path once, with the launch counts set to 0 just before
    and read just after: ``plan_pfft3(512, p=4)`` under the library and
    ``radix=4`` (one K1 launch per pass) against ``torch.fft.fftn``;
    ``pfft3_fpm`` / ``pfft3_fpm_pad`` at N = 256 over synthetic FPMs
    (``synthetic_pad_fpms``: pads of 2N and 5N/4 that engage; the padded
    one against the library-only padded oracle); a ``tune="estimate"`` plan at 512 and a ``tune="measure"`` one
    at 256 into a temporary wisdom file, served warm from it after."""
    library, kernel = PlanConfig(), PlanConfig(radix=4)
    hetero = synthetic_pad_fpms(N_PFFT3_PAD)
    big = random_signal(gen, N_PFFT3, N_PFFT3, N_PFFT3)
    oracle = torch.fft.fftn(big)
    small = random_signal(gen, N_PFFT3_PAD, N_PFFT3_PAD, N_PFFT3_PAD)
    small_oracle = torch.fft.fftn(small)
    tol, small_tol = signal_tol(big.numel()), signal_tol(small.numel())
    plans = {}

    reset_launch_counts()          # ---- the 3-D path's single drive starts

    for cfg, expect in ((library, {}), (kernel, {"fft_rows": 3})):
        plan = plan_pfft3(N_PFFT3, p=P, config=cfg)
        plans[cfg.describe()] = plan
        check_run("pfft3", f"plan_pfft3/{cfg.describe()}",
                  lambda: plan.execute(big), oracle, expect, tol, n=N_PFFT3,
                  p=P, d=plan.d.tolist())
    # Unpadded segments share one dispatch group: one launch per pass.
    for cfg, expect in ((library, {}), (kernel, {"fft_rows": 3})):
        check_run("pfft3", f"pfft3_fpm/{cfg.describe()}",
                  lambda: pfft3_fpm(small, hetero, config=cfg), small_oracle,
                  expect, small_tol, n=N_PFFT3_PAD,
                  d=partition_rows(N_PFFT3_PAD, hetero, 0.05).d.tolist())
    _, part, pads = pfft3_fpm_pad(small, hetero, return_partition=True)
    if not any(length > N_PFFT3_PAD for length in pads.tolist()):
        raise AssertionError(f"the padded 3-D run did not pad: {pads}")
    ref = padded_oracle3(small, part.d, pads)
    busy = {length for rows, length in zip(part.d.tolist(), pads.tolist())
            if rows > 0}
    pow2 = sum(1 for length in busy if not length & (length - 1))
    for cfg, expect in ((library, {}), (kernel, {"fft_rows": 3 * pow2})):
        check_run("pfft3", f"pfft3_fpm_pad/{cfg.describe()}",
                  lambda: pfft3_fpm_pad(small, hetero, config=cfg), ref, expect,
                  small_tol, n=N_PFFT3_PAD, d=part.d.tolist(),
                  pad_lengths=pads.tolist())

    plan, seconds, delta = planned(lambda: plan_pfft3(N_PFFT3, p=P,
                                                      tune="estimate"))
    if any(delta.values()):
        raise AssertionError(f"estimate plan_pfft3 launched {delta}")
    check_run("pfft3", "estimate/512", lambda: plan.execute(big), oracle,
              {"fft_rows": 3} if plan.config.radix == 4 else {}, tol,
              pick=plan.config.describe(), plan_s=seconds,
              top3=[(PlanConfig.from_dict(c).describe(), t)
                    for c, _, t in plan.tuning["ranked"][:3]])
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "wisdom.json")
        plan, seconds, delta = planned(lambda: plan_pfft3(
            N_PFFT3_PAD, tune="measure", wisdom=store))
        check_run("pfft3", "measure/256", lambda: plan.execute(small),
                  small_oracle, {"fft_rows": 3} if plan.config.radix == 4 else {},
                  small_tol, pick=plan.config.describe(), plan_s=seconds,
                  plan_launches=delta, measured=plan.tuning["measured"],
                  measured_event_s=plan.tuning.get("measured_event_s"),
                  local_pass_s=plan.tuning["pfft3"]["local_pass_s"])
        warm, seconds, delta = planned(lambda: plan_pfft3(
            N_PFFT3_PAD, tune="measure", wisdom=store))
        log("pfft3", run="warm/256", source=warm.tuning["source"],
            plan_s=seconds, plan_launches=delta)
        if warm.tuning["source"] != "wisdom" or any(delta.values()):
            raise AssertionError(f"warm plan_pfft3: {warm.tuning['source']}, {delta}")

    # ---- the 3-D path's single drive ends
    counts = end_drive("pfft3", ("fft_rows",))
    log("pfft3_time", card=card, n=N_PFFT3, p=P,
        torch_fftn_ms=time_ms(lambda: torch.fft.fftn(big), reps=5, warmup=1),
        **{f"execute_ms/{k}": time_ms(lambda: v.execute(big), reps=5, warmup=1)
           for k, v in plans.items()},
        rotations_per_transform=3, rotation_bytes=2 * big.numel() * 8,
        rotation_ms=time_ms(lambda: big.movedim(-1, -3).contiguous(), reps=5,
                            warmup=1),
        clone_ms=time_ms(lambda: big.clone(), reps=5, warmup=1))
    return counts


def phase_pfft1_large(gen: torch.Generator, card: str) -> dict[str, int]:
    """Drive the huge-1-D path once, with the launch counts set to 0 just
    before and read just after: ``plan_pfft1_large(2**26)`` (8192 x 8192
    four-step) under the library and ``radix=4`` (2 K1 launches), and pinned
    to ``n2=2**17`` under ``radix=4`` (512 rows of 2^17: one launch of K1b's
    cluster kernel, then one of K1 over 2^17 rows of 512) and to ``n2=2**19``
    (128 rows of 2^19: K1b's two passes, one chunk, then one launch of K1
    over 2^19 rows of 128), against
    ``torch.fft.fft``; ``plan_pfft1_large(2**28)`` (16384 x 16384) under
    ``radix=4`` (2 K1 launches at Plan<14>); a composite non-power-of-two and a prime N under
    ``radix=4`` (their phase lengths fall to the library: 0 launches); the
    ``tune="measure"`` lifecycle at 2^24 into a temporary wisdom file, and
    a warm second plan that launches nothing while planning."""
    library, kernel = PlanConfig(), PlanConfig(radix=4)
    x = random_signal(gen, N_LARGE)
    oracle = torch.fft.fft(x)
    plans = {}

    reset_launch_counts()          # ---- the huge-1-D path's single drive starts

    long_row = {"fft_rows": 1, "fft_rows_large": 1, "fft_rows_large_long": 1}
    two_pass = {"fft_rows": 1, "fft_rows_large": 2, "fft_rows_large_two_pass": 2}
    for cfg, n2, expect in ((library, None, {}), (kernel, None, {"fft_rows": 2}),
                            (kernel, N_LARGE_LONG_N2, long_row),
                            (kernel, N_LARGE_TWO_PASS_N2, two_pass)):
        plan, seconds, _ = planned(lambda: plan_pfft1_large(N_LARGE, config=cfg, n2=n2))
        label = cfg.describe() + ("" if n2 is None else f"/n2={n2}")
        plans[label] = plan
        check_run("pfft1_large", f"plan_pfft1_large/{label}",
                  lambda: plan.execute(x), oracle, expect, signal_tol(N_LARGE),
                  n=N_LARGE, n1=plan.n1, n2=plan.n2, plan_s=seconds)
    # 2^28 (16384 x 16384): both phases run K1 at its longest row.
    top = random_signal(gen, N_LARGE_TOP)
    top_plan, seconds, _ = planned(lambda: plan_pfft1_large(N_LARGE_TOP, config=kernel))
    check_run("pfft1_large", f"plan_pfft1_large/{N_LARGE_TOP}/{kernel.describe()}",
              lambda: top_plan.execute(top), torch.fft.fft(top), {"fft_rows": 2},
              signal_tol(N_LARGE_TOP), n=N_LARGE_TOP, n1=top_plan.n1,
              n2=top_plan.n2, plan_s=seconds)
    for n in N_LARGE_LIBRARY:
        v = random_signal(gen, n)
        plan = plan_pfft1_large(n, config=kernel)
        check_run("pfft1_large", f"plan_pfft1_large/{n}/{kernel.describe()}",
                  lambda: plan.execute(v), torch.fft.fft(v), {}, signal_tol(n),
                  n=n, n1=plan.n1, n2=plan.n2)
    n = N_LARGE_MEASURE
    v = random_signal(gen, n)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "wisdom.json")
        plan, seconds, delta = planned(lambda: plan_pfft1_large(
            n, tune="measure", wisdom=store))
        check_run("pfft1_large", f"measure/{n}", lambda: plan.execute(v),
                  torch.fft.fft(v), {"fft_rows": 2} if plan.config.radix == 4 else {},
                  signal_tol(n), pick=plan.config.describe(), plan_s=seconds,
                  plan_launches=delta, ranked=plan.tuning["ranked"],
                  measured=plan.tuning["measured"],
                  measured_event_s=plan.tuning.get("measured_event_s"))
        warm, seconds, delta = planned(lambda: plan_pfft1_large(
            n, tune="measure", wisdom=store))
        log("pfft1_large", run=f"warm/{n}", source=warm.tuning["source"],
            plan_s=seconds, plan_launches=delta)
        if warm.tuning["source"] != "wisdom" or any(delta.values()):
            raise AssertionError(f"warm plan_pfft1_large: {warm.tuning['source']}, "
                                 f"{delta}")

    # ---- the huge-1-D path's single drive ends
    counts = end_drive("pfft1_large", ("fft_rows", "fft_rows_large",
                                       "fft_rows_large_long", "fft_rows_large_two_pass"))
    square = x.view(plans[library.describe()].n1, -1)
    log("pfft1_large_time", card=card, n=N_LARGE,
        torch_fft_ms=time_ms(lambda: torch.fft.fft(x), reps=5, warmup=1),
        **{f"execute_ms/{k}": time_ms(lambda: v.execute(x), reps=5, warmup=1)
           for k, v in plans.items()},
        transposed_copies_per_transform=3,
        transpose_ms=time_ms(lambda: square.T.contiguous(), reps=5, warmup=1),
        twiddle_ms=time_ms(lambda: square * plans[library.describe()]._twiddle,
                           reps=5, warmup=1))
    log("pfft1_large_time", card=card, n=N_LARGE_TOP, n1=top_plan.n1, n2=top_plan.n2,
        torch_fft_ms=time_ms(lambda: torch.fft.fft(top), reps=5, warmup=1),
        **{f"execute_ms/{kernel.describe()}": time_ms(lambda: top_plan.execute(top),
                                                      reps=5, warmup=1)})
    del top, top_plan
    torch.cuda.empty_cache()
    return counts


def host_signals(gen: torch.Generator, count: int, shape: tuple, real: bool):
    """``count`` host numpy signals, drawn on the card from the seeded
    generator (much faster than numpy at these sizes)."""
    make = random_real if real else random_signal
    return [make(gen, *shape).cpu().numpy() for _ in range(count)]


def serve_stream(gen: torch.Generator) -> list[tuple]:
    """The mixed request stream: (method, host signal, oracle on the card)."""
    stream = []
    for method, count, shape, real, lib in SERVE_STREAM:
        for m in host_signals(gen, count, shape, real):
            stream.append((method, m, lib(torch.from_numpy(m).cuda())))
    return stream


def drive_service(svc, stream, label: str, card: str) -> dict:
    """Enqueue the whole stream, drain it, check every result against its
    oracle, and log requests/s, p50 / p99 and the service's record of each
    dispatch (``stats()["cohorts"]``: cohort, config, kernel launches, and
    the seconds of stacking, the copy in, the execute and the copy out)."""
    svc.reset_stats()
    t0 = time.perf_counter()
    tickets = [svc.enqueue(m, method=method) for method, m, _ in stream]
    svc.drain()
    seconds = time.perf_counter() - t0
    errs = []
    for (method, m, oracle), ticket in zip(stream, tickets):
        got = torch.from_numpy(ticket.result()).cuda()
        err = max_abs_err(got, oracle)
        errs.append(err)
        if err > signal_tol(m.size):
            raise AssertionError(f"{label}: {method} {m.shape} error {err}")
    stats = svc.stats()
    lat = np.asarray(stats["latencies_s"]) * 1e3
    record = {"requests": len(tickets), "served": stats["served"],
              "seconds": seconds, "requests_per_s": len(tickets) / seconds,
              "p50_ms": float(np.percentile(lat, 50)),
              "p99_ms": float(np.percentile(lat, 99)),
              "ticks": stats["ticks"], "dispatches": stats["dispatches"],
              "cohorts": stats["cohorts"], "max_abs_err": max(errs),
              "sources": stats["sources"], "plan_cache": stats["plan_cache"]}
    log("serve", card=card, run=label, **record)
    if stats["served"] != len(stream):
        raise AssertionError(f"{label}: served {stats['served']} of {len(stream)}")
    return record


def phase_serve(gen: torch.Generator, fpms, card: str) -> dict[str, int]:
    """Drive the serving layer once, with the launch counts set to 0 just
    before and read just after: one ``FFTService`` answers the mixed stream
    of 24 requests (cold, then again warm from its ``PlanCache``), a priced
    ``AdmissionError`` and a ``DeadlineExceeded``, a second service on the
    same wisdom file (``retunes == 0``), and ``execute_many`` under
    ``radix=4`` at cohort sizes 1, 3 and 8 for each request family (the
    same launches whatever the size)."""
    stream = serve_stream(gen)
    homo = fpms[N_UNPADDED][0]
    methods = tuple(dict.fromkeys(method for method, *_ in SERVE_STREAM))
    kernel = PlanConfig(radix=4)

    reset_launch_counts()          # ---- the serving path's single drive starts

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "wisdom.json")
        svc = FFTService(p=P, fpms=homo, tune="estimate", wisdom=store,
                         methods=methods, tick_budget_s=SERVE_TICK_BUDGET_S)
        drive_service(svc, stream, "cold", card)
        drive_service(svc, stream, "warm_plan_cache", card)
        if svc.stats()["plan_cache"]["retunes"]:
            raise AssertionError("the warm pass re-tuned")

        tight = FFTService(tune="estimate", max_request_s=1e-4)
        try:
            tight.enqueue(stream[0][1], method=stream[0][0])
        except AdmissionError as err:
            log("serve", run="admission", error=str(err),
                predicted_s=err.predicted_s, budget_s=err.budget_s)
        else:
            raise AssertionError("max_request_s admitted an oversized request")
        doomed = svc.enqueue(stream[0][1], method=stream[0][0], deadline_s=1e-4)
        time.sleep(0.002)
        svc.drain()
        try:
            doomed.result()
        except DeadlineExceeded as err:
            log("serve", run="deadline", error=str(err),
                predicted_s=err.predicted_s, budget_s=err.budget_s)
        else:
            raise AssertionError("a lapsed deadline was served")

        second = FFTService(p=P, fpms=homo, tune="estimate", wisdom=store,
                            methods=methods, tick_budget_s=SERVE_TICK_BUDGET_S)
        record = drive_service(second, stream, "second_service_warm_wisdom", card)
        if record["plan_cache"]["retunes"] != 0:
            raise AssertionError(f"second service retuned: {record['plan_cache']}")

    # Unfused cohorts: the same launches whatever the cohort size.
    families = [("lb", lambda: plan_pfft(N_BATCH, p=P, method="lb", config=kernel),
                 (N_BATCH, N_BATCH), False, torch.fft.fft2),
                ("rfft-lb", lambda: plan_pfft(N_BATCH, p=P, method="rfft-lb",
                                              config=kernel, dtype="float32"),
                 (N_BATCH, N_BATCH), True, torch.fft.rfft2),
                ("pfft3-lb", lambda: plan_pfft3(N_COHORT_CUBE, p=P, config=kernel),
                 (N_COHORT_CUBE,) * 3, False, torch.fft.fftn),
                ("pfft1-large", lambda: plan_pfft1_large(N_COHORT_LINE, config=kernel),
                 (N_COHORT_LINE,), False, torch.fft.fft)]
    for method, make, shape, real, lib in families:
        plan = make()
        per_size = {}
        for size in COHORT_SIZES:
            hosts = host_signals(gen, size, shape, real)
            before = launch_counts()
            outs = plan.execute_many(hosts, pad_to=_bucket(size))
            per_size[size] = {k: v - before[k] for k, v in launch_counts().items()}
            err = max(max_abs_err(torch.from_numpy(o).cuda(),
                                  lib(torch.from_numpy(h).cuda()))
                      for o, h in zip(outs, hosts))
            if err > signal_tol(hosts[0].size):
                raise AssertionError(f"{method} cohort of {size}: error {err}")
        log("serve", run="cohort_launches", method=method, config=kernel.describe(),
            launches_by_size=per_size)
        if per_size[1] != per_size[3] or per_size[1] != per_size[8] \
                or not any(per_size[1].values()):
            raise AssertionError(f"{method}: launches depend on the cohort size "
                                 f"{per_size}")

    # ---- the serving path's single drive ends
    return end_drive("serve", ("fft_rows", "rfft_rows"))


def one_rank_pad_fpms(n: int) -> FPMSet:
    """One processor, flat but eight times faster at 2N, so that FPM-PAD
    pads it to 2N (a power of two).  A model of no device."""
    xs = np.array(sorted({1, n // 8, n // 4, n // 2, n}))
    ys = np.array([n, 5 * n // 4, 2 * n])
    speed = np.full((len(xs), len(ys)), 1e9)
    speed[:, 2] *= 8.0
    return FPMSet([SpeedFunction(xs, ys, speed, name="P0")])


def dist_expect(cfg: PlanConfig, real: bool = False) -> dict[str, int]:
    """Launches of one distributed transform under ``cfg`` on each rank:
    K2 once per phase when fused, K1 once per panel of each phase under
    radix=4 (the real path: K3 for its first phase, K1 for its second)."""
    if real:
        return {"rfft_rows": 1, "fft_rows": 1} if cfg.radix == 4 else {}
    if cfg.fused:
        return {"fft_rows_transpose": 2}
    return {"fft_rows": 2 * cfg.pipeline_panels} if cfg.radix == 4 else {}


def phase_dist(gen: torch.Generator, card: str) -> dict[str, int]:
    """Drive the distributed path once at world size 1 over NCCL, with the
    launch counts set to 0 just before and read just after:
    ``plan_pfft(N_DIST, mesh=)`` under the library, ``radix=4``, fused and
    ``radix=4`` with 2, 4 and 8 pipelined panels against
    ``torch.fft.fft2``; ``fpm-pad`` at N_DIST_PAD (padded to 2N) against
    the padded-signal oracle; ``rfft-lb`` under ``radix=4`` against
    ``torch.fft.rfft2`` and ``irpfft2_distributed`` back to the signal;
    ``tune="estimate"`` and ``tune="measure"`` plans (one rank: measure
    falls back to estimate, ``info["measure_fallback"]``).  Then, outside
    the drive, each run timed beside the single-device plan of the same
    config, with the copies of one execute counted (``count_copies``), and
    the exchange sending to itself and the phase's two copies timed alone.
    The group is destroyed at the end."""
    mesh = make_fft_mesh()
    n = N_DIST
    signal = random_signal(gen, n, n)
    oracle = torch.fft.fft2(signal)
    real = random_real(gen, n, n)
    real_oracle = torch.fft.rfft2(real)
    small = random_signal(gen, N_DIST_PAD, N_DIST_PAD)
    tol = 2e-4 * n
    configs = [PlanConfig(), PlanConfig(radix=4), PlanConfig(radix=4, fused=True),
               *(PlanConfig(radix=4, pipeline_panels=k) for k in DIST_PANELS)]
    plans = {}

    reset_launch_counts()          # ---- the distributed path's single drive starts

    for cfg in configs:
        plan = plan_pfft(n, mesh=mesh, method="lb", config=cfg)
        plans[f"lb/{cfg.describe()}"] = (plan, signal)
        check_run("dist", f"lb/{cfg.describe()}", lambda: plan.execute(signal),
                  oracle, dist_expect(cfg), tol, n=n, p=1,
                  device=str(plan.device))
    fpms = one_rank_pad_fpms(N_DIST_PAD)
    for cfg in (PlanConfig(), PlanConfig(radix=4)):
        plan = plan_pfft(N_DIST_PAD, mesh=mesh, method="fpm-pad", fpms=fpms,
                         config=cfg)
        if plan.pad_lengths.tolist() != [2 * N_DIST_PAD]:
            raise AssertionError(f"fpm-pad did not pad to 2N: {plan.pad_lengths}")
        plans[f"fpm-pad/{cfg.describe()}"] = (plan, small)
        check_run("dist", f"fpm-pad/{cfg.describe()}", lambda: plan.execute(small),
                  padded_oracle(small, plan.d, plan.pad_lengths),
                  dist_expect(cfg), 2e-4 * N_DIST_PAD, n=N_DIST_PAD,
                  pad_lengths=plan.pad_lengths.tolist())
    kernel = PlanConfig(radix=4)
    plan = plan_pfft(n, mesh=mesh, method="rfft-lb", dtype="float32",
                     config=kernel)
    plans["rfft-lb/radix=4"] = (plan, real)
    half = check_run("dist", "rfft-lb/radix=4", lambda: plan.execute(real),
                     real_oracle, dist_expect(kernel, real=True), tol, n=n)
    # The inverse runs the library's FFTs, as the reference's does; 1e-3 on
    # the unit-variance signal.
    check_run("dist", "irpfft2_distributed", lambda: irpfft2_distributed(
        half, mesh), real, {}, 1e-3, n=n)
    # Planned from a fresh wisdom file: the first rank's lookup (a miss) is
    # broadcast over the NCCL group, and each measure plan records its
    # fallback pick (under its own key), as the reference's does.
    store = os.path.join(tempfile.mkdtemp(), "wisdom.json")
    for method, signal_in, ref in (("lb", signal, oracle),
                                   ("rfft-lb", real, real_oracle)):
        for tune in ("estimate", "measure"):
            dtype = "float32" if method == "rfft-lb" else "complex64"
            plan, seconds, delta = planned(lambda: plan_pfft(
                n, mesh=mesh, method=method, tune=tune, dtype=dtype,
                wisdom=store))
            if any(delta.values()):
                raise AssertionError(f"{method} {tune} plan launched {delta}")
            if plan.tuning["source"] != tune:
                raise AssertionError(f"{method}: planned from "
                                     f"{plan.tuning['source']}, not {tune}")
            if tune == "measure" and "measure_fallback" not in plan.tuning:
                raise AssertionError(f"{method}: measure on one rank did not "
                                     "fall back to the estimate")
            cfg = plan.schedule.anchor_config
            check_run("dist", f"{method}/tune={tune}", lambda: plan.execute(signal_in),
                      ref, dist_expect(cfg, real=cfg.real), tol,
                      pick=plan.schedule.describe(), plan_s=seconds,
                      topology=plan.tuning["topology"],
                      fallback=plan.tuning.get("measure_fallback"))

    # ---- the distributed path's single drive ends
    counts = end_drive("dist", ("fft_rows", "fft_rows_transpose", "rfft_rows"))
    shutil.rmtree(os.path.dirname(store))

    for label, (plan, x) in plans.items():
        single = plan_pfft(plan.n, p=1, method=plan.method, fpms=plan_fpms(plan),
                           config=plan.config, dtype=plan.dtype)
        lib = torch.fft.rfft2 if plan.method.startswith("rfft") else torch.fft.fft2
        log("dist_time", card=card, run=label, n=plan.n, p=1,
            execute_ms=time_ms(lambda: plan.execute(x), reps=5, warmup=1),
            single_device_ms=time_ms(lambda: single.execute(x), reps=5, warmup=1),
            library_ms=time_ms(lambda: lib(x), reps=5, warmup=1),
            copies=count_copies(lambda: plan.execute(x)),
            single_device_copies=count_copies(lambda: single.execute(x)))
    group = mesh.get_group("fft")
    stack = _pack(signal, 1)
    recv = _send_recv(stack, group).wait()
    log("dist_time", card=card, run="exchange/self", n=n, p=1,
        bytes=stack.numel() * 8,
        exchange_ms=time_ms(lambda: _send_recv(stack, group).wait(), reps=5,
                            warmup=1),
        pack_ms=time_ms(lambda: _pack(signal, 1), reps=5, warmup=1),
        place_ms=time_ms(lambda: recv.permute(2, 0, 1).contiguous(), reps=5,
                         warmup=1),
        clone_ms=time_ms(lambda: signal.clone(), reps=5, warmup=1))
    dist.destroy_process_group()
    return counts


def count_copies(fn) -> int:
    """The ``aten::copy_`` calls (``.contiguous()``, ``clone``, ``copy_``)
    that one call of ``fn`` makes, counted by the host-side profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::copy_")


def plan_fpms(plan):
    """The FPMs a distributed fpm-pad plan was made from, for its
    single-device twin (the same pads: one processor, N rows)."""
    return one_rank_pad_fpms(plan.n) if plan.method == "fpm-pad" else None


def gloo_runs(flat, hier) -> list[tuple]:
    """(label, mesh, method, config) of the shared-card world's drive."""
    kernel = PlanConfig(radix=4)
    return [("lb/radix=4", flat, "lb", kernel),
            ("lb/fused", flat, "lb", PlanConfig(radix=4, fused=True)),
            ("lb/hier", hier, "lb", PlanConfig(radix=4, exchange="hier")),
            ("lb/panels=2", flat, "lb", PlanConfig(radix=4, pipeline_panels=2)),
            ("rfft-lb/radix=4", flat, "rfft-lb", kernel)]


def dist_worker(rank: int, port: int, out: str) -> None:
    """One rank of phase ``dist_gloo4``: every rank makes the same seeded
    signal on the card, transforms its (N/4, N) row block under each of
    ``gloo_runs`` (counted), and rank 0 gathers the blocks through the host
    and holds them against the library's transform of the whole signal.
    Then each run is timed (host clock between barriers).  Rank 0 writes the
    JSON record to ``out``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=GLOO_RANKS, rank=rank)
    flat = make_fft_mesh(device_type="cuda", backend="gloo")
    hier = make_fft_mesh(hosts=2, local=2, device_type="cuda", backend="gloo")
    n, w = N_DIST_GLOO, N_DIST_GLOO // GLOO_RANKS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    signal = random_signal(gen, n, n)
    real = random_real(gen, n, n)
    rows = slice(rank * w, (rank + 1) * w)
    blocks = {"lb": signal[rows].contiguous(), "rfft-lb": real[rows].contiguous()}
    plans, records = [], []

    reset_launch_counts()          # ---- this rank's part of the drive starts

    for label, mesh, method, cfg in gloo_runs(flat, hier):
        real_in = method == "rfft-lb"
        plan = plan_pfft(n, mesh=mesh, axis_name=mesh.mesh_dim_names[0],
                         method=method, config=cfg,
                         dtype="float32" if real_in else "complex64")
        plans.append((label, plan, blocks[method]))
        before = launch_counts()
        out_block = plan.execute(blocks[method])
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        parts = [torch.empty_like(torch.view_as_real(out_block.cpu()))
                 for _ in range(GLOO_RANKS)] if rank == 0 else None
        dist.gather(torch.view_as_real(out_block.cpu()), parts, dst=0)
        record = {"run": label, "config": cfg.describe(), "launches": delta,
                  "expect": dist_expect(cfg, real=real_in)}
        if rank == 0:
            full = torch.view_as_complex(torch.cat(parts)).cuda()
            oracle = torch.fft.rfft2(real) if real_in else torch.fft.fft2(signal)
            record.update(max_abs_err=max_abs_err(full, oracle), atol=2e-4 * n)
        records.append(record)

    counts = launch_counts()       # ---- this rank's part of the drive ends
    for label, plan, block in plans:
        times = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            plan.execute(block)
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        for record in records:
            if record["run"] == label:
                record["wall_ms"] = statistics.median(times)
    seen = [None] * GLOO_RANKS
    dist.all_gather_object(seen, {"counts": counts, "records": records})
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(seen, fh)
    dist.destroy_process_group()


def check_dist_gloo4(card: str, seen: list, mode: str = "2d") -> dict[str, int]:
    """Check what the ranks of a distributed path on GLOO_RANKS processes
    sharing the card over gloo with CUDA tensors saw (``seen``, from
    ``run_gloo_workers``): ``mode="2d"`` (phase ``dist_gloo4``,
    ``dist_worker``) ran ``radix=4``, fused, the hierarchical exchange on 2
    emulated hosts x 2, 2 pipelined panels and ``rfft-lb`` at N =
    N_DIST_GLOO; ``mode="3d"`` (phase ``dist3_gloo4``, ``dist3_worker``) the
    pencil and slab runs of ``gloo3_runs`` at N_DIST3_GLOO^3; each gathered
    on rank 0 against the library.  Every rank must have launched exactly
    what the mode's expectation says per run; the path's counts are the
    sums over the ranks."""
    phase = "dist_gloo4" if mode == "2d" else "dist3_gloo4"
    n = N_DIST_GLOO if mode == "2d" else N_DIST3_GLOO
    for rank, part in enumerate(seen):
        for record in part["records"]:
            expect = {k: record["expect"].get(k, 0) for k in record["launches"]}
            if record["launches"] != expect:
                raise AssertionError(f"{phase} rank {rank} {record['run']}: "
                                     f"launches {record['launches']}, expected {expect}")
    for record in seen[0]["records"]:
        log(phase, card=card, ranks=GLOO_RANKS, n=n, **record)
        if record["max_abs_err"] > record["atol"]:
            raise AssertionError(f"{phase} {record['run']}: max error "
                                 f"{record['max_abs_err']} > {record['atol']}")
    counts = {k: sum(part["counts"][k] for part in seen) for k in seen[0]["counts"]}
    log(phase, launches=counts, launches_by_rank=[p["counts"] for p in seen])
    kernels = (("fft_rows", "fft_rows_transpose", "rfft_rows") if mode == "2d"
               else ("fft_rows",))
    for name in kernels:
        if counts[name] < 1:
            raise AssertionError(f"the {phase} path never launched {name}")
    return counts


def dist3_expect(cfg: PlanConfig, slab: bool = False) -> dict[str, int]:
    """K1 launches of one 3-D mesh transform under ``cfg`` on each rank,
    radix=4 only: a slab's three passes, or a pencil's two rounds of one
    launch per panel and its last pass."""
    if cfg.radix != 4:
        return {}
    return {"fft_rows": 3 if slab else 2 * cfg.pipeline_panels + 1}


def phase_dist3(gen: torch.Generator, card: str) -> dict[str, int]:
    """Drive the 3-D mesh pipelines once at world size 1 over NCCL, with the
    launch counts set to 0 just before and read just after:
    ``plan_pfft3(N_DIST3, mesh=make_pfft3_mesh(1, 1))`` under the library,
    ``radix=4`` and ``radix=4`` with DIST3_PANELS pipelined panels;
    ``pfft3_slab`` under ``radix=4`` on a 1-D mesh of one; ``tune=
    "estimate"`` and ``tune="measure"`` plans (one rank: measure falls
    back to the estimate); each against ``torch.fft.fftn`` within
    ``2e-4·sqrt(N^3)`` and K1 exactly as ``dist3_expect`` says.  Then,
    outside the drive, each run timed beside the single-device
    ``plan_pfft3`` of its config, with the copies of one execute counted.
    The group is destroyed at the end."""
    mesh = make_pfft3_mesh(1, 1)
    slab = make_fft_mesh()
    n = N_DIST3
    cube = random_signal(gen, n, n, n)
    oracle = torch.fft.fftn(cube)
    tol = signal_tol(cube.numel())
    configs = [PlanConfig(), PlanConfig(radix=4),
               *(PlanConfig(radix=4, pipeline_panels=k) for k in DIST3_PANELS)]
    runs = {}

    reset_launch_counts()          # ---- the 3-D mesh path's single drive starts

    for cfg in configs:
        plan = plan_pfft3(n, mesh=mesh, config=cfg)
        runs[f"pencil/{cfg.describe()}"] = (plan.execute, cfg)
        check_run("dist3", f"pencil/{cfg.describe()}", lambda: plan.execute(cube),
                  oracle, dist3_expect(cfg), tol, n=n, mesh="1x1",
                  orientation=list(plan.axis_names), device=str(plan.device))
    kernel = PlanConfig(radix=4)
    runs["slab/radix=4"] = (lambda m: pfft3_slab(m, slab, config=kernel), kernel)
    check_run("dist3", "slab/radix=4", lambda: pfft3_slab(cube, slab, config=kernel),
              oracle, dist3_expect(kernel, slab=True), tol, n=n, p=1)
    store = os.path.join(tempfile.mkdtemp(), "wisdom.json")
    for tune in ("estimate", "measure"):
        plan, seconds, delta = planned(lambda: plan_pfft3(
            n, mesh=mesh, tune=tune, wisdom=store))
        if any(delta.values()):
            raise AssertionError(f"plan_pfft3(mesh=, tune={tune}) launched {delta}")
        if plan.tuning["source"] != tune:
            raise AssertionError(f"planned from {plan.tuning['source']}, not {tune}")
        if tune == "measure" and "measure_fallback" not in plan.tuning:
            raise AssertionError("measure on one rank did not fall back to "
                                 "the estimate")
        check_run("dist3", f"pencil/tune={tune}", lambda: plan.execute(cube),
                  oracle, dist3_expect(plan.config), tol,
                  pick=plan.config.describe(), orientation=list(plan.axis_names),
                  plan_s=seconds, topology=plan.tuning["topology"],
                  fallback=plan.tuning.get("measure_fallback"))

    # ---- the 3-D mesh path's single drive ends
    counts = end_drive("dist3", ("fft_rows",))
    shutil.rmtree(os.path.dirname(store))

    for label, (fn, cfg) in runs.items():
        single = plan_pfft3(n, config=cfg)
        log("dist3_time", card=card, run=label, n=n, ranks=1,
            execute_ms=time_ms(lambda: fn(cube), reps=5, warmup=1),
            single_device_ms=time_ms(lambda: single.execute(cube), reps=5,
                                     warmup=1),
            copies=count_copies(lambda: fn(cube)),
            single_device_copies=count_copies(lambda: single.execute(cube)))
    log("dist3_time", card=card, run="library", n=n,
        torch_fftn_ms=time_ms(lambda: torch.fft.fftn(cube), reps=5, warmup=1))
    # The pieces of a 1 x 1 pencil transform: a pass of K1 over the N^2
    # rows, the exchange sending the whole cube to itself (the pack is a
    # view at one rank), the two placements and the final permute.
    stack = cube.view(1, n, n, n)
    group = mesh.get_group("fft_c")
    recv = _send_recv(stack, group).wait()
    out = torch.empty_like(cube)
    log("dist3_time", card=card, run="pieces", n=n, bytes=cube.numel() * 8,
        fft_pass_ms=time_ms(lambda: fft_rows_op(cube.view(-1, n), radix=4),
                            reps=5, warmup=1),
        exchange_ms=time_ms(lambda: _send_recv(stack, group).wait(), reps=5,
                            warmup=1),
        swap_place_ms=time_ms(lambda: out.view(n, n, 1, n).copy_(
            recv.permute(_SWAP)), reps=5, warmup=1),
        rotate_place_ms=time_ms(lambda: out.view(n, n, 1, n).copy_(
            recv.permute(_ROTATE)), reps=5, warmup=1),
        permute_ms=time_ms(lambda: cube.permute(2, 1, 0).contiguous(), reps=5,
                           warmup=1),
        clone_ms=time_ms(lambda: cube.clone(), reps=5, warmup=1))
    del mesh, slab, stack, recv, out
    dist.destroy_process_group()
    return counts


def gloo3_runs(meshes: dict) -> list[tuple]:
    """(label, mesh, config, slab) of the shared-card 3-D world's drive."""
    kernel = PlanConfig(radix=4)
    return [("pencil/2x2/radix=4", meshes["2x2"], kernel, False),
            ("pencil/2x2/radix=4,panels=2", meshes["2x2"],
             PlanConfig(radix=4, pipeline_panels=2), False),
            ("pencil/1x4/radix=4", meshes["1x4"], kernel, False),
            ("pencil/4x1/radix=4", meshes["4x1"], kernel, False),
            ("pencil/4x1h2/hier", meshes["4x1h2"],
             PlanConfig(radix=4, exchange="hier"), False),
            ("slab/radix=4", meshes["slab"], kernel, True),
            ("slab/hier", meshes["slab_h2"],
             PlanConfig(radix=4, exchange="hier"), True)]


def dist3_worker(rank: int, port: int, out: str) -> None:
    """One rank of phase ``dist3_gloo4``: every rank makes the same seeded
    cube on the card and transforms its block (a pencil through
    ``plan_pfft3(mesh=)``, a slab through ``pfft3_slab``) under each of
    ``gloo3_runs`` (counted); rank 0 gathers the blocks through the host,
    places each by its rank's mesh coordinates and holds the cube against
    ``torch.fft.fftn``.  Then each run is timed (host clock between
    barriers).  Rank 0 writes the JSON record to ``out``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=GLOO_RANKS, rank=rank)
    gloo = {"device_type": "cuda", "backend": "gloo"}
    meshes = {"2x2": make_pfft3_mesh(2, 2, **gloo),
              "1x4": make_pfft3_mesh(1, 4, **gloo),
              "4x1": make_pfft3_mesh(4, 1, **gloo),
              "4x1h2": make_pfft3_mesh(4, 1, hosts=2, **gloo),
              "slab": make_fft_mesh(**gloo),
              "slab_h2": make_fft_mesh(hosts=2, local=2, **gloo)}
    n = N_DIST3_GLOO
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cube = random_signal(gen, n, n, n)
    oracle = torch.fft.fftn(cube) if rank == 0 else None
    runs, records = [], []

    reset_launch_counts()          # ---- this rank's part of the drive starts

    for label, mesh, cfg, is_slab in gloo3_runs(meshes):
        grid = mesh.mesh.reshape(mesh.mesh.shape[0], -1)   # rank of (i, j)
        r, c = grid.shape
        i, j = [int(v) for v in (grid == rank).nonzero()[0]]
        block = cube[i * n // r:(i + 1) * n // r,
                     j * n // c:(j + 1) * n // c].contiguous()
        if is_slab:
            fn = (lambda m, mesh=mesh, cfg=cfg: pfft3_slab(m, mesh, config=cfg))
        else:
            fn = plan_pfft3(n, mesh=mesh, config=cfg).execute
        runs.append((label, fn, block))
        before = launch_counts()
        out_block = fn(block)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        parts = [torch.empty_like(torch.view_as_real(out_block.cpu()))
                 for _ in range(GLOO_RANKS)] if rank == 0 else None
        dist.gather(torch.view_as_real(out_block.cpu()), parts, dst=0)
        record = {"run": label, "config": cfg.describe(), "mesh": [r, c],
                  "launches": delta, "expect": dist3_expect(cfg, slab=is_slab)}
        if rank == 0:
            full = torch.empty_like(cube)
            for q, part in enumerate(parts):
                qi, qj = [int(v) for v in (grid == q).nonzero()[0]]
                rows = slice(qi * n // r, (qi + 1) * n // r)
                cols = slice(qj * n // c, (qj + 1) * n // c)
                part = torch.view_as_complex(part).cuda()
                if is_slab:
                    full[rows] = part
                else:
                    full[:, rows, cols] = part
            record.update(max_abs_err=max_abs_err(full, oracle),
                          atol=signal_tol(cube.numel()))
            del full
        records.append(record)

    counts = launch_counts()       # ---- this rank's part of the drive ends
    for label, fn, block in runs:
        times = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            fn(block)
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        for record in records:
            if record["run"] == label:
                record["wall_ms"] = statistics.median(times)
    seen = [None] * GLOO_RANKS
    dist.all_gather_object(seen, {"counts": counts, "records": records})
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(seen, fh)
    dist.destroy_process_group()


def phase_runtime(gen: torch.Generator, card: str) -> dict[str, int]:
    """Drive the self-healing runtime once on a world of one NCCL rank, with
    the launch counts set to 0 just before and read just after:
    ``repeated(K1, 3)`` bit for bit one K1 launch and exactly 3 launches;
    ``ResilientPlan(N_RUNTIME, method="lb", config=PlanConfig(radix=4))``
    over RUNTIME_CALLS calls within ``2e-4·N`` of ``torch.fft.fft2``, with
    the K1 launches of each call (its transform and its probe: one group at
    p = 1, so no drift can fire) and of the plan's own execute; a
    ``CheckpointManager`` round trip of a 512 MiB state on the card.  Then,
    outside the drive, ``repeated(K1, 3)`` and one K1 launch timed.  The
    group is destroyed at the end."""
    mesh = make_fft_mesh()
    n = N_RUNTIME
    signal = random_signal(gen, n, n)
    oracle = torch.fft.fft2(signal)
    tol = 2e-4 * n

    def k1(x):
        return fft_rows_op(x, radix=4)

    slowed = repeated(k1, RUNTIME_SLOW)

    def k1_delta(fn) -> int:
        before = launch_counts()["fft_rows"]
        fn()
        torch.cuda.synchronize()
        return launch_counts()["fft_rows"] - before

    reset_launch_counts()          # ---- the runtime path's single drive starts

    one = k1(signal)
    box = {}
    launches = k1_delta(lambda: box.update(three=slowed(signal)))
    identical = bool(torch.equal(box["three"], one))
    log("runtime", run="repeated", rows=n, n=n, repeats=RUNTIME_SLOW,
        bit_identical=identical, launches=launches)
    if not identical or launches != RUNTIME_SLOW:
        raise AssertionError(f"repeated(K1, {RUNTIME_SLOW}): bit identical "
                             f"{identical}, {launches} launches")
    del one, box

    rp = ResilientPlan(n, mesh=mesh, method="lb", config=PlanConfig(radix=4))
    per_call, outs = [], []
    for _ in range(RUNTIME_CALLS):
        per_call.append(k1_delta(lambda: outs.append(rp.execute(signal))))
    errs = [max_abs_err(out, oracle) for out in outs]
    without_probe = k1_delta(lambda: rp.plan.execute(signal))
    log("runtime", run="resilient", n=n, p=1, calls=RUNTIME_CALLS,
        max_abs_err=max(errs), atol=tol, k1_per_call=per_call,
        k1_per_execute_without_probe=without_probe,
        step_ms=[t * 1e3 for t in rp.step_times], events=rp.events,
        drift="p = 1: one group, so no drift can fire")
    if max(errs) > tol:
        raise AssertionError(f"ResilientPlan: max error {max(errs)} > {tol}")
    # A probe is 3 timed K1 launches (one more the first time, to warm up).
    if per_call[1:] != [without_probe + 3] * (RUNTIME_CALLS - 1) \
            or per_call[0] != without_probe + 4 or rp.events:
        raise AssertionError(f"ResilientPlan at p = 1: K1 per call {per_call}, "
                             f"{without_probe} without the probe, events {rp.events}")
    del outs

    state = {"field": random_signal(gen, *CHECKPOINT_SHAPE),
             "step": torch.tensor(RUNTIME_CALLS, device="cuda")}
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        t0 = time.perf_counter()
        mgr.save(1, state, blocking=False)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        restored, _ = mgr.restore(1, state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    equal = (torch.equal(restored["field"], state["field"])
             and int(restored["step"]) == RUNTIME_CALLS
             and restored["field"].device == state["field"].device)
    log("runtime", run="checkpoint", card=card,
        bytes=state["field"].numel() * state["field"].element_size(),
        equal=equal, to_host_s=t1 - t0, write_s=t2 - t1, restore_s=t3 - t2)
    if not equal:
        raise AssertionError("checkpoint round trip changed the state")
    del state, restored

    # ---- the runtime path's single drive ends
    counts = end_drive("runtime", ("fft_rows",))
    k1_ms = time_ms(lambda: k1(signal), reps=10)
    slowed_ms = time_ms(lambda: slowed(signal), reps=10)
    log("runtime_time", card=card, rows=n, n=n, k1_ms=k1_ms,
        repeated3_ms=slowed_ms, ratio=slowed_ms / k1_ms,
        execute_ms=time_ms(lambda: rp.plan.execute(signal), reps=5, warmup=1),
        resilient_execute_ms=time_ms(lambda: rp.execute(signal), reps=5, warmup=1))
    dist.destroy_process_group()
    return counts


def runtime_events(rp) -> list[dict]:
    return [{k: e[k] for k in RUNTIME_EVENT_FIELDS if k in e} for e in rp.events]


def runtime_worker(rank: int, port: int, out: str) -> None:
    """One rank of phase ``runtime_gloo4``: every rank makes the same seeded
    signal on the card.  Straggler: a ``ResilientPlan`` under ``radix=4``
    with position 0 slowed RUNTIME_SLOW times (one probe's K1 launches
    counted), driven until a re-plan naming position 0 is hot-swapped, then
    one call gathered on rank 0 against the library.  Loss: a measured plan
    with a wisdom file, position RUNTIME_LOST lost at a call; the ranks
    that leave the world write what they saw, the survivors retry, rank 0
    gathers the retried call against the library, and a second plan on the
    reduced world is made (served from wisdom: no launch while planning).
    Each rank writes its record to ``out.<rank>``."""
    init_multihost(f"127.0.0.1:{port}", GLOO_RANKS, rank, device_type="cuda",
                   backend="gloo")
    mesh = make_fft_mesh(device_type="cuda", backend="gloo")
    n = N_RUNTIME_GLOO
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    signal = random_signal(gen, n, n)
    store = os.path.join(os.path.dirname(out), "wisdom.json")
    record: dict = {"rank": rank}

    def gathered(block: torch.Tensor) -> float | None:
        """Rank 0 of the current world: the max error of the gathered
        blocks against ``fft2``; None elsewhere."""
        world, me = dist.get_world_size(), dist.get_rank()
        host = torch.view_as_real(block.cpu())
        parts = [torch.empty_like(host) for _ in range(world)] if me == 0 else None
        dist.gather(host, parts, dst=0)
        if me != 0:
            return None
        full = torch.view_as_complex(torch.cat(parts)).cuda()
        return max_abs_err(full, torch.fft.fft2(signal))

    def write() -> None:
        record["counts"] = launch_counts()
        with open(f"{out}.{rank}", "w") as fh:
            json.dump(record, fh)

    reset_launch_counts()          # ---- this rank's part of the drive starts

    with inject() as inj:
        rp = ResilientPlan(n, mesh=mesh, method="lb", config=PlanConfig(radix=4),
                           alpha=0.6, cooldown=2)
        rp.execute(signal)
        inj.slow_group(0, RUNTIME_SLOW)
        rp._probe_group_times()        # the slowed branch's first probe warms it
        before = launch_counts()["fft_rows"]
        rp._probe_group_times()
        probe_k1 = launch_counts()["fft_rows"] - before
        swap = None
        for calls in range(1, RUNTIME_STRAGGLER_CALLS + 1):
            rp.execute(signal)
            swap = next((e for e in rp.events if e["kind"] == "replan"
                         and e["swap_call"] is not None
                         and 0 in e["slow_groups"]), None)
            if swap is not None:
                break
        record["straggler"] = {
            "calls": calls, "probe_k1": probe_k1, "events": runtime_events(rp),
            "detect_to_swap_s": (swap["swap_wall"] - swap["detect_wall"]
                                 if swap is not None else None),
            "replan_s": swap["replan_s"] if swap is not None else None,
            "schedule": rp.schedule.describe(),
            "step_ms": [t * 1e3 for t in rp.step_times]}
        record["straggler"]["max_abs_err"] = gathered(rp.execute(signal))

    with inject() as inj:
        rp, plan_s, _ = planned(lambda: ResilientPlan(
            n, mesh=mesh, method="lb", tune="measure", wisdom=store))
        topology = rp.plan.tuning.get("topology")
        rp.execute(signal)
        inj.fail_execute(rp.calls, lost=RUNTIME_LOST)
        try:
            block = rp.execute(signal)
        except DeviceLostError as err:
            record["loss"] = {"departed": True, "lost": list(err.lost),
                              "left_mesh": rp.mesh is None}
            write()
            return
        record["loss"] = {
            "departed": False, "plan_s": plan_s, "topology_before": topology,
            "events": runtime_events(rp),
            "recover_s": [e["recover_s"] for e in rp.events
                          if e["kind"] == "device_loss"],
            "schedule": rp.schedule.describe(), "world": dist.get_world_size(),
            "max_abs_err": gathered(block)}
    reduced = make_fft_mesh(device_type="cuda", backend="gloo")
    rp2, seconds, delta = planned(lambda: ResilientPlan(
        n, mesh=reduced, method="lb", tune="measure", wisdom=store))
    record["loss"]["second"] = {"source": rp2.plan.tuning.get("source"),
                                "plan_s": seconds, "launches": delta,
                                "topology": rp2.plan.tuning.get("topology")}
    write()
    dist.barrier()
    dist.destroy_process_group()


def check_runtime_gloo4(card: str, seen: list) -> dict[str, int]:
    """Check what each of the GLOO_RANKS processes sharing the card over
    gloo saw of the runtime (``runtime_worker``; ``seen``, one record a
    rank, from ``run_gloo_workers``): the same events on every rank; a
    hot-swapped re-plan naming position 0 within RUNTIME_STRAGGLER_CALLS
    calls; a probe of the slowed rank costing RUNTIME_SLOW times a healthy
    rank's K1 launches; the retried call and the call after the swap within
    ``2e-4·N`` of ``fft2``; positions 2 and 3 gone (3 lost, 2 dropped: 4096
    is not divisible by 3), the device-loss event's fields, a new topology
    digest, and the second plan served from wisdom with no launch.  The
    path's counts are the ranks' sums."""
    phase = "runtime_gloo4"
    tol = 2e-4 * N_RUNTIME_GLOO
    straggler = [part["straggler"] for part in seen]
    lead = straggler[0]
    log(phase, card=card, ranks=GLOO_RANKS, n=N_RUNTIME_GLOO, run="straggler",
        calls=lead["calls"], events=lead["events"],
        detect_to_swap_s=lead["detect_to_swap_s"], replan_s=lead["replan_s"],
        schedule=lead["schedule"], probe_k1_by_rank=[s["probe_k1"] for s in straggler],
        step_ms=lead["step_ms"], max_abs_err=lead["max_abs_err"], atol=tol)
    if any(s["events"] != lead["events"] for s in straggler):
        raise AssertionError(f"{phase}: the ranks saw different events")
    if lead["detect_to_swap_s"] is None:
        raise AssertionError(f"{phase}: no re-plan naming position 0 was "
                             f"swapped in within {RUNTIME_STRAGGLER_CALLS} calls")
    healthy = straggler[1]["probe_k1"]
    if [s["probe_k1"] for s in straggler] != [RUNTIME_SLOW * healthy] + [healthy] * 3 \
            or healthy < 1:
        raise AssertionError(f"{phase}: probe K1 launches by rank "
                             f"{[s['probe_k1'] for s in straggler]}")
    if lead["max_abs_err"] > tol:
        raise AssertionError(f"{phase}: after the swap, max error "
                             f"{lead['max_abs_err']} > {tol}")
    loss = [part["loss"] for part in seen]
    departed = [r for r, part in enumerate(loss) if part["departed"]]
    log(phase, card=card, ranks=GLOO_RANKS, n=N_RUNTIME_GLOO, run="loss",
        departed=departed, **{k: v for k, v in loss[0].items() if k != "departed"})
    if departed != [2, 3] or any(not loss[r]["left_mesh"] for r in departed):
        raise AssertionError(f"{phase}: ranks {departed} left the world, "
                             "expected [2, 3]")
    event = [e for e in loss[0]["events"] if e["kind"] == "device_loss"]
    want = {"lost": list(RUNTIME_LOST), "survivors": 3, "devices": 2, "dropped": 1}
    if len(event) != 1 or {k: event[0][k] for k in want} != want \
            or loss[1]["events"] != loss[0]["events"]:
        raise AssertionError(f"{phase}: device-loss events {loss[0]['events']} "
                             f"and {loss[1]['events']}, expected one with {want}")
    if event[0]["topology"] == loss[0]["topology_before"] or loss[0]["world"] != 2:
        raise AssertionError(f"{phase}: topology {event[0]['topology']} after "
                             f"the loss, {loss[0]['topology_before']} before")
    if loss[0]["max_abs_err"] > tol:
        raise AssertionError(f"{phase}: retried call's max error "
                             f"{loss[0]['max_abs_err']} > {tol}")
    for r in (0, 1):
        second = loss[r]["second"]
        if second["source"] != "wisdom" or any(second["launches"].values()):
            raise AssertionError(f"{phase}: rank {r}'s second plan came from "
                                 f"{second['source']} with launches "
                                 f"{second['launches']}")
    counts = {k: sum(part["counts"][k] for part in seen) for k in seen[0]["counts"]}
    log(phase, launches=counts, launches_by_rank=[p["counts"] for p in seen])
    for name in ("fft_rows", "fft_rows_transpose"):
        if counts[name] < 1:
            raise AssertionError(f"the {phase} path never launched {name}")
    return counts


def gloo_worker(rank: int, tmp: str, ports: list[int]) -> None:
    """One of the GLOO_RANKS processes of ``run_gloo_workers``: the ranks of
    ``GLOO_WORLDS`` in turn, each world on its own port, each writing its
    records under ``tmp``; then the seconds each took to
    ``tmp/seconds.<rank>``."""
    workers = {"2d": dist_worker, "3d": dist3_worker, "runtime": runtime_worker}
    seconds = {}
    for (phase, mode), port in zip(GLOO_WORLDS, ports):
        start = time.perf_counter()
        workers[mode](rank, port, os.path.join(tmp, f"{phase}.json"))
        seconds[phase] = round(time.perf_counter() - start, 2)
    with open(os.path.join(tmp, f"seconds.{rank}"), "w") as fh:
        json.dump(seconds, fh)


def run_gloo_workers() -> dict[str, list]:
    """Start GLOO_RANKS processes sharing the card (this script with
    ``--gloo-rank``), each the ranks of the three gloo worlds in turn
    (``gloo_worker``), so the processes reach the card once for the three;
    wait for them and return what each world's ranks wrote, by phase.  Each
    world's drive sets its rank's launch counts to 0 just before and reads
    them just after, as a process of its own would."""
    # The ranks share the card with this process: hand its cached blocks
    # back to the device first.
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in GLOO_WORLDS]
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        ports = [str(sock.getsockname()[1]) for sock in socks]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--gloo-rank", str(r), tmp, *ports],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for r in range(GLOO_RANKS)]
        failed = []
        try:
            for r, proc in enumerate(procs):
                _, err = proc.communicate(timeout=GLOO_TIMEOUT_S)
                if proc.returncode:
                    failed.append(f"rank {r} exited {proc.returncode}: {err[-2000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        if failed:
            raise AssertionError("gloo workers: " + "\n".join(failed))
        seen = {}
        for phase, mode in GLOO_WORLDS:
            out = os.path.join(tmp, f"{phase}.json")
            if mode == "runtime":      # one record a rank
                seen[phase] = []
                for r in range(GLOO_RANKS):
                    with open(f"{out}.{r}") as fh:
                        seen[phase].append(json.load(fh))
            else:                      # rank 0 wrote every rank's part
                with open(out) as fh:
                    seen[phase] = json.load(fh)
        by_rank = []
        for r in range(GLOO_RANKS):
            with open(os.path.join(tmp, f"seconds.{r}")) as fh:
                by_rank.append(json.load(fh))
    log("gloo4", ranks=GLOO_RANKS, seconds=time.perf_counter() - t0,
        world_seconds_by_rank=by_rank)
    return seen


def lm_copy(model: torch.nn.Module, dtype: str = "float32",
            n_layers: int | None = None) -> torch.nn.Module:
    """A copy of ``model``'s weights in ``dtype`` (a float32 copy holds its
    bf16 values exactly), of its first ``n_layers`` layers when given."""
    cfg = dataclasses.replace(model.cfg, dtype=dtype,
                              n_layers=n_layers or model.cfg.n_layers)
    twin = lm.TransformerLM(cfg, next(model.parameters()).device)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, dst in twin.named_parameters():
            dst.copy_(src[name])
    return twin


@contextlib.contextmanager
def moe_routing():
    """Records the routing of every MoE block run inside, in call order (one
    entry a layer): float32 ``probs``, ``gate_idx`` and ``keep`` on the
    host.  Adds a copy to the host a layer: for untimed runs only."""
    records = []
    apply = moe_mod.moe_apply

    def recorded(p, x, cfg, **kw):
        probs, _, gate_idx, _, keep = moe_mod._route(p, x, cfg)
        records.append({"probs": probs.cpu(), "gate_idx": gate_idx.cpu(),
                        "keep": keep.cpu()})
        return apply(p, x, cfg, **kw)

    moe_mod.moe_apply = recorded
    try:
        yield records
    finally:
        moe_mod.moe_apply = apply


def lm_bounds(model: torch.nn.Module, batch: int, prompt: int,
              routing: dict | None = None) -> dict:
    """The least time of a decode step and of the prefill on the card: the
    bytes each must move over HBM's rate, its operations over dense bf16's.
    Bytes: every weight read once, but of the embedding table only the rows
    looked up and of the routed experts only those the routing selects; the
    cache rows read and written (a layer and token: GQA's k and v, 2·KV·hd;
    MLA's latent and rope key, kv_lora + rope).  Operations: 2 per weight
    and token, a routed expert's only for the (token, choice) pairs kept;
    the prefill's lm_head on the last position alone; causal attention (QK
    and PV).  ``routing`` maps "decode" and "prefill" to an MoE model's
    ``moe_routing`` records of one decode step and of the prefill; without
    them a layer is taken to touch min(E, tokens·k) experts and keep every
    choice.  The recurrent families are counted by ``recurrent_bounds``."""
    cfg = model.cfg
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_bounds(model, batch, prompt)
    elem = model.embed.table.element_size()
    d = cfg.d_model
    head = model.lm_head.w.numel()
    all_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    layer_params = sum(p.numel() for p in model.layers.parameters())
    E = k = expert = 0
    if cfg.moe is not None:
        E, k = cfg.moe.n_experts, cfg.moe.top_k
        expert = 3 * d * cfg.moe.d_expert                 # wg, wu, wd of one
    routed = cfg.n_layers * E * expert
    base_bytes = all_bytes - model.embed.table.numel() * elem - routed * elem
    dense_params = layer_params - routed
    if cfg.mla is not None:
        m = cfg.mla
        row = (m.kv_lora_rank + m.qk_rope_dim) * elem
        per_pair = 2 * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim)
    else:
        row = 2 * cfg.n_kv_heads * cfg.hd * elem
        per_pair = 4 * cfg.n_heads * cfg.hd
    out = {}
    for name, tokens, cache_rows, pairs in (
            ("decode", batch, batch * (prompt + 1), batch * (prompt + 1)),
            ("prefill", batch * prompt, batch * prompt,
             batch * prompt * (prompt + 1) // 2)):
        work = {}
        if E and routing is not None:
            records = routing[name]
            per_layer = [len(set(r["gate_idx"][r["keep"]].tolist()))
                         for r in records]
            touched = sum(per_layer)
            kept = sum(int(r["keep"].sum()) for r in records)
            work["experts_counted"] = "from the routing of this run"
            work["experts_per_layer"] = per_layer
        else:
            touched = cfg.n_layers * min(E, tokens * k)
            kept = cfg.n_layers * tokens * k
            if E:
                work["experts_counted"] = "min(E, tokens * k) a layer"
        work["bytes"] = (base_bytes + tokens * d * elem + touched * expert * elem
                         + cache_rows * cfg.n_layers * row)
        work["flops"] = (2 * tokens * dense_params + 2 * kept * expert
                         + 2 * batch * head + cfg.n_layers * per_pair * pairs)
        by_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
        by_ops = work["flops"] / PEAK_BF16_FLOPS * 1e3
        out[name] = {"bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     **work}
    return out


def param_bytes(modules) -> tuple[int, int]:
    """(parameters, bytes) of ``modules``."""
    params = [p for m in modules for p in m.parameters()]
    return (sum(p.numel() for p in params),
            sum(p.numel() * p.element_size() for p in params))


def recurrent_bounds(model: torch.nn.Module, batch: int, prompt: int) -> dict:
    """``lm_bounds`` of an xLSTM or a Zamba2 model.  Bytes: every weight the
    step runs read once — the Mamba2 blocks a hybrid pads its last group
    with are not run and not counted — but the hybrid's shared block once
    per application (its 14 applications are far apart and it is far larger
    than the 50 MB L2; ``bound_ms_shared_once`` beside it), the embedding
    rows looked up, the float32 recurrent state read and written each
    decode step (written once by the prefill; Mamba2: B·H·P·N + B·(d_conv -
    1)·ch a block, mLSTM: C, n, m, sLSTM: c, n, h, m) and each shared
    application's KV rows.  Operations: 2 per weight and token (the shared
    block's per application), the lm_head on the last position, causal
    attention, and the recurrences: the decode's state update and read-out,
    the prefill's chunk products (SSD: C·B, the intra-chunk product, the
    inter-chunk read and the state update; mLSTM: q·k, the weighted v and k
    sums, the state read and update; sLSTM: h·r each step)."""
    cfg = model.cfg
    d, f32 = cfg.d_model, 4
    elem = model.embed.table.element_size()
    head_params, head_bytes = param_bytes([model.lm_head, model.final_norm])
    shared, applications, per_pair, row = [], 0, 0, 0
    if cfg.family == "hybrid":
        valid = lm._hybrid_valid(cfg)
        blocks = [blk for gi, group in enumerate(model.mamba)
                  for j, blk in enumerate(group) if valid[gi][j]]
        shared, applications = [model.shared], len(model.mamba)
        per_pair = 4 * cfg.n_heads * cfg.hd
        row = 2 * cfg.n_kv_heads * cfg.hd * elem
        ssm = cfg.ssm
        d_inner, H = ssm_mod._dims(d, ssm)
        N, P, L = ssm.d_state, ssm.head_dim, min(ssm.chunk, prompt)
        state = len(blocks) * batch * (H * P * N + (ssm.d_conv - 1) * (d_inner + 2 * N))
        step_ops = len(blocks) * batch * 6 * H * P * N
        chunk_ops = len(blocks) * batch * prompt * (2 * L * N + 2 * L * H * P
                                                     + 4 * H * P * N)
    else:
        blocks = list(model.blocks)
        H, hd = cfg.n_heads, cfg.hd
        n_m = sum(blk.kind == "mlstm" for blk in blocks)
        n_s = len(blocks) - n_m
        L = min(cfg.xlstm.chunk, prompt)
        state = batch * H * (n_m * (hd * hd + hd + 1) + n_s * 4 * hd)
        recurrent = n_s * batch * 8 * H * hd * hd          # h · r, a token
        step_ops = recurrent + n_m * batch * (6 * H * hd + 4 * H * hd * hd)
        chunk_ops = prompt * recurrent + n_m * batch * prompt * (
            6 * L * H * hd + 4 * H * hd * hd)
    block_params, block_bytes = param_bytes(blocks)
    shared_params, shared_bytes = param_bytes(shared)
    out = {}
    for name, tokens, state_moves, kv_rows, pairs, ops in (
            ("decode", batch, 2, batch * (prompt + 1), batch * (prompt + 1), step_ops),
            ("prefill", batch * prompt, 1, batch * prompt,
             batch * prompt * (prompt + 1) // 2, chunk_ops)):
        work = {"blocks_run": len(blocks), "shared_applications": applications,
                "weight_bytes": block_bytes + head_bytes + applications * shared_bytes,
                "state_bytes": state_moves * state * f32,
                "kv_bytes": applications * kv_rows * row}
        work["bytes"] = (work["weight_bytes"] + tokens * d * elem
                         + work["state_bytes"] + work["kv_bytes"])
        work["recurrence_flops"] = ops
        work["flops"] = (2 * tokens * (block_params + applications * shared_params)
                         + 2 * batch * head_params + applications * per_pair * pairs
                         + ops)
        by_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
        by_ops = work["flops"] / PEAK_BF16_FLOPS * 1e3
        out[name] = {"bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     **work}
        if applications:
            once = (work["bytes"] - (applications - 1) * shared_bytes) / PEAK_BYTES_PER_S
            out[name]["bound_ms_shared_once"] = max(once * 1e3, by_ops)
    return out


def launches_of(fn) -> dict[str, float]:
    """The kernel launches of one call of ``fn``: the runtime's launch calls
    on the host and the kernels on the card, as ``torch.profiler`` (CUPTI)
    records them, less the card-side copies of host annotations (the port's
    spans); beside them the kernels' summed time on the card and the
    call's time on the host clock (its end synchronised), whose difference
    is the card's idle time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.events()
    host = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel",
                                                       "cuLaunchKernel")))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Memcpy") and not e.name.startswith("Memset")
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"host_launch_calls": host, "device_kernels": len(kernels),
            "device_kernel_ms": busy_ms, "wall_ms": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms}


def close_ratio(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|got - want|, max|want|), both finite."""
    return (max_abs_err(got.float(), want.float()),
            float(want.float().abs().max()))


def check_close(phase: str, label: str, pairs, rel: float) -> None:
    """``max|got - want| <= rel·max|want|`` for every (got, want) pair; logs
    the worst ratio."""
    ratios = [err / scale for err, scale in (close_ratio(g, w) for g, w in pairs)]
    log(phase, check=label, pairs=len(ratios), worst_ratio=max(ratios), limit=rel)
    if not max(ratios) <= rel:
        raise AssertionError(f"{phase} {label}: error {max(ratios)} x max|want| "
                             f"> {rel}")


def lm_greedy(model, cfg, prompts: dict, gen: int) -> torch.Tensor:
    """The greedy continuation of ``prompts`` (B, gen), as ``serve_batch``
    makes it."""
    cache = lm.init_cache(cfg, LM_BATCH, LM_PROMPT + gen)
    logits, cache = lm.prefill(model, prompts, cfg, cache)
    toks = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(gen):
        toks.append(tok)
        logits, cache = lm.decode_step(model, cache, tok, LM_PROMPT + i, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(toks, dim=1)


def phase_lm_serve(card: str) -> dict[str, int]:
    """The LM serving path (``repro_torch.launch.serve``), with the launch
    counts set to 0 just before and read just after (it runs none of the
    FFT kernels):

    (a) ``serve_batch`` of qwen2.5-3b FULL in bf16, weights from a seeded
        CUDA generator, batch 8 x (64 + 32); then the same weights
        rebuilt from the same seed and the prefill and each decode step
        timed by CUDA events, one decode step's launches counted by the
        profiler, beside the bounds (``lm_bounds``);
    (b) a float32 copy of those weights: forward, prefill and prefill(S-1)
        + decode_step agree within ``1e-3·max|logits|``; the bf16 prefill
        logits within ``5e-2·max|logits|`` of the float32 ones; the bf16
        greedy tokens beside the float32 ones (printed, not gated);
    (c) one full-width layer (``_apply_tf_layer`` on (8, 64, 2048), float32)
        on the card against the host within ``1e-4·max|out|``;
    (d) the SMOKE config of each other dense, vlm and audio arch in float32,
        card against host: forward, and for the decoders prefill and
        LM_SMOKE_DECODE decode steps, within ``1e-4·max|out|``.
    """
    phase = "lm_serve"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out, stats = serve_batch(LM_ARCH, smoke=False, batch=LM_BATCH,
                                 prompt_len=LM_PROMPT, gen=LM_GEN, seed=SEED)
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"the LM path launched FFT kernels: {counts}")
        serve_s = time.perf_counter() - t0
        if out.shape != (LM_BATCH, LM_GEN) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"serve_batch gave {out.shape}, tokens "
                                 f"{out.min()} ... {out.max()}")
        serve_peak = torch.cuda.max_memory_allocated()

        weights = torch.Generator(device="cuda")
        weights.manual_seed(SEED)
        model = lm.init_params(weights, cfg, device="cuda")
        prompts = make_batch(cfg, LM_BATCH, LM_PROMPT, seed=SEED, step=0,
                             device="cuda")
        prompts.pop("targets")
        n_params = sum(p.numel() for p in model.parameters())
        bounds = lm_bounds(model, LM_BATCH, LM_PROMPT)
        prefill_ms, step_ms, logits16, tok = time_serving(model, cfg, prompts,
                                                          LM_GEN)
        decode_ms = statistics.median(step_ms)
        cache = prefilled(model, cfg, prompts)
        launches = launches_of(lambda: lm.decode_step(model, cache, tok,
                                                      LM_PROMPT, cfg))
        log(phase, step="serve", card=card, kind=torch.cuda.get_device_name(0),
            arch=cfg.name, params=n_params, dtype=cfg.dtype, batch=LM_BATCH,
            prompt_len=LM_PROMPT, gen=LM_GEN, serve_batch_s=serve_s,
            serve_batch_stats=stats, prefill_ms=prefill_ms,
            prefill_bound_ms=bounds["prefill"]["bound_ms"],
            prefill_bound_by=bounds["prefill"]["bound_by"],
            decode_ms_per_step=decode_ms, decode_ms_min=min(step_ms),
            decode_ms_max=max(step_ms),
            decode_bound_ms=bounds["decode"]["bound_ms"],
            decode_bound_by=bounds["decode"]["bound_by"],
            decode_tok_s=LM_BATCH / decode_ms * 1e3,
            prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
            launches_per_decode_step=launches, bounds=bounds,
            serve_peak_memory_gib=serve_peak / 2 ** 30)
        del cache

        # (b) the float32 copy at full width
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = lm_copy(model)
        hidden, _ = lm.forward(model32, prompts, cfg32)
        full = lm.logits_fn(model32, hidden[:, -1:], cfg32)[:, 0]
        del hidden
        logits32, _ = lm.prefill(model32, prompts, cfg32,
                                 lm.init_cache(cfg32, LM_BATCH, LM_PROMPT))
        short = {"tokens": prompts["tokens"][:, :-1]}
        cache32 = lm.init_cache(cfg32, LM_BATCH, LM_PROMPT)
        _, cache32 = lm.prefill(model32, short, cfg32, cache32)
        stepped, _ = lm.decode_step(model32, cache32, prompts["tokens"][:, -1],
                                    LM_PROMPT - 1, cfg32)
        del cache32
        check_close(phase, "float32 prefill vs forward", [(logits32, full)], 1e-3)
        check_close(phase, "float32 prefill(S-1) + decode_step vs forward",
                    [(stepped, full)], 1e-3)
        check_close(phase, "bf16 prefill vs float32 prefill",
                    [(logits16, logits32)], 5e-2)
        greedy32 = lm_greedy(model32, cfg32, prompts, LM_GEN).cpu().numpy()
        agree = out == greedy32
        first_miss = [int(np.argmin(row)) if not row.all() else LM_GEN
                      for row in agree]
        log(phase, step="greedy bf16 vs float32", equal_tokens=int(agree.sum()),
            tokens=int(agree.size), equal_prefix_per_row=first_miss)

        # (c) one full-width layer, card against host
        layer = model32.layers[0]
        x = torch.randn(LM_BATCH, LM_PROMPT, cfg.d_model, device="cuda",
                        generator=weights)
        on_card, _, _ = lm._apply_tf_layer(layer, x, cfg32)
        layer_host = copy_module(layer, "cpu")
        on_host, _, _ = lm._apply_tf_layer(layer_host, x.cpu(), cfg32)
        check_close(phase, "full-width layer card vs host",
                    [(on_card.cpu(), on_host)], 1e-4)
        del model, model32, layer_host, x, on_card, on_host, logits16, logits32
        peak = torch.cuda.max_memory_allocated()

        # (d) the other transformer-layer configs at SMOKE size
        check_smoke_archs(phase, LM_SMOKE_ARCHS)
    counts = launch_counts()
    log(phase, launches=counts, seconds=time.perf_counter() - t0,
        peak_memory_gib=peak / 2 ** 30)
    if any(counts.values()):
        raise AssertionError(f"the LM path launched FFT kernels: {counts}")
    torch.cuda.empty_cache()
    return counts


def routing_diff(a: list[dict], b: list[dict]) -> tuple[float, list]:
    """(the share of (token, choice) routing decisions that differ between
    two ``moe_routing`` records of the same run, and the (layer, group,
    token) of each row that differs)."""
    differ = total = 0
    rows = []
    for layer, (ra, rb) in enumerate(zip(a, b, strict=True)):
        d = (ra["gate_idx"] != rb["gate_idx"]) | (ra["keep"] != rb["keep"])
        differ += int(d.sum())
        total += d.numel()
        rows += [(layer, int(g), int(t)) for g, t in d.any(-1).nonzero().tolist()]
    return differ / total, rows


def top_k_gap(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The gap between the k-th and the (k+1)-th largest probability of each
    row: how near a row's top-k set is to a tie."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def check_moe_layer(phase: str, layer, x: torch.Tensor, cfg) -> None:
    """One full-width layer (float32) on the card against the host.  The
    routing is compared first: a (token, choice) whose expert differs must
    be a near-tie on the host (top-k gap below MOE_NEAR_TIE) and is reported
    by position; a token whose kept slots alone differ must share its group
    with such a flip (its slot shifted behind it).  The tokens whose routing
    agreed are then held within ``1e-4·max|out|``."""
    with moe_routing() as on_card_routing:
        on_card, _, _ = lm._apply_tf_layer(layer, x, cfg)
    layer_host = copy_module(layer, "cpu")
    with moe_routing() as host_routing:
        on_host, _, _ = lm._apply_tf_layer(layer_host, x.cpu(), cfg)
    (rc,), (rh,) = on_card_routing, host_routing
    flips = (rc["gate_idx"] != rh["gate_idx"]).any(-1)
    shifted = (rc["keep"] != rh["keep"]).any(-1) & ~flips
    gap = top_k_gap(rh["probs"], cfg.moe.top_k)
    flipped = [{"group": g, "token": t, "card": rc["gate_idx"][g, t].tolist(),
                "host": rh["gate_idx"][g, t].tolist(), "gap": float(gap[g, t])}
               for g, t in flips.nonzero().tolist()]
    agree = ~(flips | shifted)
    log(phase, check="full-width layer routing card vs host",
        decisions=int(rc["gate_idx"].numel()),
        equal_experts=int((rc["gate_idx"] == rh["gate_idx"]).sum()),
        equal_kept=int((rc["keep"] == rh["keep"]).sum()),
        dropped=int((~rh["keep"]).sum()), flipped=flipped,
        slot_shifted=shifted.nonzero().tolist(),
        smallest_gap=float(gap.min()))
    if any(f["gap"] >= MOE_NEAR_TIE for f in flipped):
        raise AssertionError(f"{phase}: routing differs beyond a near-tie: {flipped}")
    if bool((shifted & ~flips.any(-1, keepdim=True)).any()):
        raise AssertionError(f"{phase}: kept slots differ in a group without a flip")
    check_close(phase, "full-width layer card vs host",
                [(on_card.cpu()[agree], on_host[agree])], 1e-4)


def phase_lm_serve_moe(card: str) -> dict[str, int]:
    """The MoE + MLA serving path, with the launch counts set to 0 just
    before and read just after (it runs none of the FFT kernels):

    (a) ``serve_batch`` of deepseek-v2-lite-16b FULL (27 layers) in bf16,
        weights from a seeded CUDA generator, batch 8 x (64 + 32); then the
        same weights rebuilt and the prefill and each decode step timed by
        CUDA events, one decode step's launches counted, the peak memory,
        beside ``lm_bounds`` (the experts counted from the routing of one
        decode step and of the prefill);
    (b) its first MOE_F32_LAYERS layers copied in float32: forward vs
        prefill within ``1e-3·max|logits|``; prefill(S-1) + decode_step vs
        prefill(S) at capacity_factor 8 (drops depend on T) within the same;
        the bf16 copy's prefill logits against them, printed beside the
        share of routing decisions that differ (not gated: top-k routing is
        discontinuous);
    (c) one full-width layer (float32, (8, 64, 2048)) on the card against
        the host, routing first (``check_moe_layer``);
    (d) dbrx-132b at full width with MOE_DBRX_LAYERS layers in bf16: the
        prefill and MOE_DBRX_DECODE decode steps timed beside their bounds;
    (e) the SMOKE configs of both archs in float32, card against host.
    """
    phase = "lm_serve_moe"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        # (a) deepseek-v2-lite-16b FULL in bf16
        out, stats = serve_batch(MOE_ARCH, smoke=False, batch=LM_BATCH,
                                 prompt_len=LM_PROMPT, gen=LM_GEN, seed=SEED)
        serve_s = time.perf_counter() - t0
        if out.shape != (LM_BATCH, LM_GEN) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"serve_batch gave {out.shape}, tokens "
                                 f"{out.min()} ... {out.max()}")
        serve_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        weights = torch.Generator(device="cuda")
        weights.manual_seed(SEED)
        model = lm.init_params(weights, cfg, device="cuda")
        prompts = make_batch(cfg, LM_BATCH, LM_PROMPT, seed=SEED, step=0,
                             device="cuda")
        prompts.pop("targets")
        prefill_ms, step_ms, logits16, tok = time_serving(model, cfg, prompts,
                                                          LM_GEN)
        decode_ms = statistics.median(step_ms)
        cache = prefilled(model, cfg, prompts)
        launches = launches_of(lambda: lm.decode_step(model, cache, tok,
                                                      LM_PROMPT, cfg))
        with moe_routing() as decode_routing:
            lm.decode_step(model, cache, tok, LM_PROMPT, cfg)
        with moe_routing() as prefill_routing:
            prefilled(model, cfg, prompts)
        del cache
        bounds = lm_bounds(model, LM_BATCH, LM_PROMPT,
                           {"decode": decode_routing, "prefill": prefill_routing})
        log(phase, step="serve", card=card, kind=torch.cuda.get_device_name(0),
            arch=cfg.name, layers=cfg.n_layers,
            params=sum(p.numel() for p in model.parameters()), dtype=cfg.dtype,
            batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
            serve_batch_s=serve_s, serve_batch_stats=stats,
            prefill_ms=prefill_ms,
            prefill_bound_ms=bounds["prefill"]["bound_ms"],
            prefill_bound_by=bounds["prefill"]["bound_by"],
            decode_ms_per_step=decode_ms, decode_ms_min=min(step_ms),
            decode_ms_max=max(step_ms),
            decode_bound_ms=bounds["decode"]["bound_ms"],
            decode_bound_by=bounds["decode"]["bound_by"],
            decode_tok_s=LM_BATCH / decode_ms * 1e3,
            prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
            launches_per_decode_step=launches, bounds=bounds,
            bounds_at_min_e_tokens_k=lm_bounds(model, LM_BATCH, LM_PROMPT),
            prefill_dropped_choices=sum(int((~r["keep"]).sum())
                                        for r in prefill_routing),
            serve_peak_memory_gib=serve_peak / 2 ** 30,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

        # (b) the first MOE_F32_LAYERS layers in float32 (and in bf16)
        model32 = lm_copy(model, "float32", MOE_F32_LAYERS)
        model16 = lm_copy(model, "bfloat16", MOE_F32_LAYERS)
        cfg32, cfg16 = model32.cfg, model16.cfg
        hidden, aux = lm.forward(model32, prompts, cfg32)
        full = lm.logits_fn(model32, hidden[:, -1:], cfg32)[:, 0]
        del hidden
        with moe_routing() as routing32:
            logits32, _ = lm.prefill(model32, prompts, cfg32,
                                     lm.init_cache(cfg32, LM_BATCH, LM_PROMPT))
        ample = dataclasses.replace(
            cfg32, moe=dataclasses.replace(cfg32.moe, capacity_factor=8.0))
        whole, _ = lm.prefill(model32, prompts, ample,
                              lm.init_cache(ample, LM_BATCH, LM_PROMPT))
        short = {"tokens": prompts["tokens"][:, :-1]}
        cache32 = lm.init_cache(ample, LM_BATCH, LM_PROMPT)
        _, cache32 = lm.prefill(model32, short, ample, cache32)
        stepped, _ = lm.decode_step(model32, cache32, prompts["tokens"][:, -1],
                                    LM_PROMPT - 1, ample)
        del cache32
        check_close(phase, f"float32 {MOE_F32_LAYERS} layers prefill vs forward",
                    [(logits32, full)], 1e-3)
        check_close(phase, f"float32 {MOE_F32_LAYERS} layers prefill(S-1) + "
                    "decode_step vs prefill(S), capacity_factor 8",
                    [(stepped, whole)], 1e-3)
        with moe_routing() as routing16:
            logits16_cut, _ = lm.prefill(model16, prompts, cfg16,
                                         lm.init_cache(cfg16, LM_BATCH, LM_PROMPT))
        share, rows = routing_diff(routing16, routing32)
        err, scale = close_ratio(logits16_cut, logits32)
        log(phase, check=f"bf16 vs float32 prefill logits, {MOE_F32_LAYERS} "
            "layers (printed, not gated)", ratio=err / scale, max_abs_err=err,
            max_logit=scale, routing_decisions_differing=share,
            rows_differing=len(rows), aux_float32=float(aux))
        del model16, logits16_cut

        # (c) one full-width layer, card against host
        x = torch.randn(LM_BATCH, LM_PROMPT, cfg.d_model, device="cuda",
                        generator=weights)
        check_moe_layer(phase, model32.layers[0], x, cfg32)
        del model, model32, x, logits16, logits32, full, whole, stepped
        torch.cuda.empty_cache()

        # (d) dbrx-132b at full width, MOE_DBRX_LAYERS layers, bf16
        dbrx = dataclasses.replace(get_config(MOE_DBRX_ARCH), n_layers=MOE_DBRX_LAYERS)
        weights.manual_seed(SEED)
        model = lm.init_params(weights, dbrx, device="cuda")
        prompts = make_batch(dbrx, LM_BATCH, LM_PROMPT, seed=SEED, step=0,
                             device="cuda")
        prompts.pop("targets")
        prefill_ms, step_ms, first, tok = time_serving(model, dbrx, prompts,
                                                       MOE_DBRX_DECODE)
        if not bool(torch.isfinite(first.float()).all()):
            raise AssertionError(f"{phase}: dbrx prefill logits not finite")
        cache = prefilled(model, dbrx, prompts)
        with moe_routing() as decode_routing:
            lm.decode_step(model, cache, tok, LM_PROMPT, dbrx)
        with moe_routing() as prefill_routing:
            prefilled(model, dbrx, prompts)
        del cache
        bounds = lm_bounds(model, LM_BATCH, LM_PROMPT,
                           {"decode": decode_routing, "prefill": prefill_routing})
        decode_ms = statistics.median(step_ms)
        log(phase, step="dbrx", card=card, arch=dbrx.name, layers=dbrx.n_layers,
            reduced=f"depth {get_config(MOE_DBRX_ARCH).n_layers} -> "
                    f"{MOE_DBRX_LAYERS} layers (one card)",
            params=sum(p.numel() for p in model.parameters()), dtype=dbrx.dtype,
            batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=MOE_DBRX_DECODE,
            prefill_ms=prefill_ms,
            prefill_bound_ms=bounds["prefill"]["bound_ms"],
            prefill_bound_by=bounds["prefill"]["bound_by"],
            decode_ms_per_step=decode_ms, decode_ms_all=step_ms,
            decode_bound_ms=bounds["decode"]["bound_ms"],
            decode_bound_by=bounds["decode"]["bound_by"],
            decode_tok_s=LM_BATCH / decode_ms * 1e3, bounds=bounds,
            prefill_dropped_choices=sum(int((~r["keep"]).sum())
                                        for r in prefill_routing))
        del model, first
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()

        # (e) the SMOKE configs of both archs
        check_smoke_archs(phase, MOE_SMOKE_ARCHS)
    counts = launch_counts()
    log(phase, launches=counts, seconds=time.perf_counter() - t0,
        peak_memory_gib=peak / 2 ** 30)
    if any(counts.values()):
        raise AssertionError(f"the MoE LM path launched FFT kernels: {counts}")
    torch.cuda.empty_cache()
    return counts


def phase_lm_serve_ssm(card: str) -> tuple[dict[str, int], int]:
    """The recurrent serving path (xLSTM and Zamba2), with the launch counts
    set to 0 just before and read just after (it runs none of the FFT
    kernels):

    (a) ``serve_batch`` of zamba2-7b FULL (all 81 blocks) in bf16, weights
        from a seeded CUDA generator, batch 8 x (64 + 32); then the same
        weights rebuilt and the prefill and each decode step timed by CUDA
        events, one decode step's launches counted, the peak memory, beside
        ``lm_bounds`` (``recurrent_bounds``);
    (b) xlstm-125m FULL (12 blocks) the same way;
    (c) a float32 copy of each at full depth: forward, prefill and
        prefill(S-1) + decode_step agree within ``1e-3·max|logits|``; the
        bf16 prefill logits against them (at full depth and cut to 2^k
        groups or block pairs) and the greedy tokens compared, and the
        float32 logits after its embedding is nudged at bf16's rounding
        step, printed (not gated: no bound is given for bf16 through 81
        recurrent blocks);
    (d) one full-width block of each kind (Mamba2 of zamba2-7b, mLSTM and
        sLSTM of xlstm-125m) in float32 on the card against the host within
        ``1e-4·max|out|``: the chunked prefill of SSM_BLOCK_T tokens and a
        T = 1 decode step, both from the state after SSM_BLOCK_T others, the
        new states compared too;
    (e) the SMOKE configs of both archs in float32, card against host.

    Returns the counts and the phase's peak memory (each arch resets the
    peak counter).
    """
    phase = "lm_serve_ssm"
    reset_launch_counts()
    t0 = time.perf_counter()
    peak = 0
    with torch.no_grad():
        for arch in SSM_ARCHS:
            peak = max(peak, serve_recurrent(phase, arch, card))
        check_recurrent_blocks(phase)
        check_smoke_archs(phase, SSM_ARCHS)
    counts = launch_counts()
    log(phase, launches=counts, seconds=time.perf_counter() - t0,
        peak_memory_gib=peak / 2 ** 30)
    if any(counts.values()):
        raise AssertionError(f"the recurrent LM path launched FFT kernels: {counts}")
    torch.cuda.empty_cache()
    return counts, peak


def serve_recurrent(phase: str, arch: str, card: str) -> int:
    """(a)-(c) of ``phase_lm_serve_ssm`` for ``arch``; returns the peak
    memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    out, stats = serve_batch(arch, smoke=False, batch=LM_BATCH,
                             prompt_len=LM_PROMPT, gen=LM_GEN, seed=SEED)
    serve_s = time.perf_counter() - t0
    if out.shape != (LM_BATCH, LM_GEN) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"{arch} serve_batch gave {out.shape}, tokens "
                             f"{out.min()} ... {out.max()}")
    serve_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    weights = torch.Generator(device="cuda")
    weights.manual_seed(SEED)
    model = lm.init_params(weights, cfg, device="cuda")
    prompts = make_batch(cfg, LM_BATCH, LM_PROMPT, seed=SEED, step=0,
                         device="cuda")
    prompts.pop("targets")
    prefill_ms, step_ms, logits16, tok = time_serving(model, cfg, prompts, LM_GEN)
    decode_ms = statistics.median(step_ms)
    cache = prefilled(model, cfg, prompts)
    launches = launches_of(lambda: lm.decode_step(model, cache, tok, LM_PROMPT, cfg))
    del cache
    bounds = lm_bounds(model, LM_BATCH, LM_PROMPT)
    log(phase, step="serve", card=card, kind=torch.cuda.get_device_name(0),
        arch=cfg.name, blocks=cfg.n_layers,
        params=sum(p.numel() for p in model.parameters()), dtype=cfg.dtype,
        batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
        serve_batch_s=serve_s, serve_batch_stats=stats, prefill_ms=prefill_ms,
        prefill_bound_ms=bounds["prefill"]["bound_ms"],
        prefill_bound_by=bounds["prefill"]["bound_by"],
        decode_ms_per_step=decode_ms, decode_ms_min=min(step_ms),
        decode_ms_max=max(step_ms),
        decode_bound_ms=bounds["decode"]["bound_ms"],
        decode_bound_by=bounds["decode"]["bound_by"],
        decode_tok_s=LM_BATCH / decode_ms * 1e3,
        prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
        launches_per_decode_step=launches, bounds=bounds,
        serve_peak_memory_gib=serve_peak / 2 ** 30,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # (c) the float32 copy at full depth
    model32 = lm_copy(model)
    cfg32 = model32.cfg
    hidden, _ = lm.forward(model32, prompts, cfg32)
    full = lm.logits_fn(model32, hidden[:, -1:], cfg32)[:, 0]
    del hidden
    logits32, _ = lm.prefill(model32, prompts, cfg32,
                             lm.init_cache(cfg32, LM_BATCH, LM_PROMPT))
    cache32 = lm.init_cache(cfg32, LM_BATCH, LM_PROMPT)
    _, cache32 = lm.prefill(model32, {"tokens": prompts["tokens"][:, :-1]}, cfg32,
                            cache32)
    stepped, _ = lm.decode_step(model32, cache32, prompts["tokens"][:, -1],
                                LM_PROMPT - 1, cfg32)
    del cache32
    check_close(phase, f"{arch} float32 prefill vs forward", [(logits32, full)], 1e-3)
    check_close(phase, f"{arch} float32 prefill(S-1) + decode_step vs forward",
                [(stepped, full)], 1e-3)
    err, scale = close_ratio(logits16, logits32)
    greedy32 = lm_greedy(model32, cfg32, prompts, LM_GEN).cpu().numpy()
    agree = out == greedy32
    # the float32 model's own sensitivity: its embedding table scaled by 1 +
    # uniform(-2^-9, 2^-9), bf16's relative rounding step
    table = model32.embed.table
    table.mul_(1 + torch.empty_like(table).uniform_(-2 ** -9, 2 ** -9,
                                                    generator=weights))
    nudged, _ = lm.prefill(model32, prompts, cfg32,
                           lm.init_cache(cfg32, LM_BATCH, LM_PROMPT))
    nudge_err, _ = close_ratio(nudged, logits32)
    del model32, full, stepped, nudged
    torch.cuda.empty_cache()
    log(phase, check=f"{arch} bf16 vs float32 (printed, not gated)",
        prefill_logits_ratio=err / scale, max_abs_err=err, max_logit=scale,
        equal_tokens=int(agree.sum()), tokens=int(agree.size),
        equal_prefix_per_row=[int(np.argmin(row)) if not row.all() else LM_GEN
                              for row in agree],
        ratio_by_depth={**bf16_gap_by_depth(model, prompts),
                        cfg.n_layers: err / scale},
        float32_ratio_after_embedding_nudge=nudge_err / scale)
    peak = torch.cuda.max_memory_allocated()
    del model, logits16, logits32
    torch.cuda.empty_cache()
    return peak


def bf16_gap_by_depth(model, prompts: dict) -> dict[int, float]:
    """max|bf16 - float32| / max|float32| of the prefill logits of ``model``
    cut to its first 2^k units of blocks (a hybrid's group, an xLSTM's
    mLSTM + sLSTM pair) below its full depth, up to BF16_GAP_MAX_BLOCKS
    blocks: how the gap grows with depth."""
    cfg = model.cfg
    unit = (cfg.hybrid.shared_attn_every if cfg.family == "hybrid"
            else cfg.xlstm.slstm_every)
    gaps = {}
    depth = unit
    while depth < cfg.n_layers and depth <= BF16_GAP_MAX_BLOCKS:
        logits = []
        for dtype in ("bfloat16", "float32"):
            cut = lm_copy(model, dtype, depth)
            logits.append(lm.prefill(cut, prompts, cut.cfg,
                                     lm.init_cache(cut.cfg, LM_BATCH, LM_PROMPT))[0])
            del cut
        err, scale = close_ratio(*logits)
        gaps[depth] = err / scale
        depth *= 2
    return gaps


def recurrent_blocks(gen: torch.Generator):
    """One full-width float32 block of each kind on the host, drawn from
    ``gen``: (name, block, apply(block, x, cache), its empty cache on a
    device, d_model)."""
    xcfg, zcfg = get_config("xlstm_125m"), get_config("zamba2_7b")
    H, hd = xcfg.n_heads, xcfg.hd
    return [
        ("mamba2", ssm_mod.mamba2_init(gen, zcfg.d_model, zcfg.ssm, torch.float32,
                                       "cpu"),
         lambda p, x, cache: ssm_mod.mamba2_apply(p, x, zcfg.ssm, cache=cache),
         lambda device: ssm_mod.mamba2_init_cache(LM_BATCH, zcfg.d_model, zcfg.ssm,
                                                  device=device), zcfg.d_model),
        ("mlstm", xlstm_mod.mlstm_init(gen, xcfg.d_model, H, hd, torch.float32, "cpu"),
         lambda p, x, cache: xlstm_mod.mlstm_apply(p, x, n_heads=H, hd=hd,
                                                   chunk=xcfg.xlstm.chunk, cache=cache),
         lambda device: xlstm_mod.mlstm_init_cache(LM_BATCH, H, hd, device),
         xcfg.d_model),
        ("slstm", xlstm_mod.slstm_init(gen, xcfg.d_model, H, hd, torch.float32, "cpu"),
         lambda p, x, cache: xlstm_mod.slstm_apply(p, x, n_heads=H, hd=hd, cache=cache),
         lambda device: xlstm_mod.slstm_init_cache(LM_BATCH, H, hd, device),
         xcfg.d_model),
    ]


def check_recurrent_blocks(phase: str) -> None:
    """(d) of ``phase_lm_serve_ssm``: each block's chunked prefill and T = 1
    decode step, card against host, from the state its host copy reaches
    after SSM_BLOCK_T tokens (not zero); outputs and new states within
    ``1e-4·max|out|`` (each state leaf against its own scale)."""
    gen = torch.Generator().manual_seed(SEED)
    for name, host, apply, empty, d in recurrent_blocks(gen):
        card_block = copy_module(host, "cuda")
        state = empty("cpu")
        apply(host, torch.randn(LM_BATCH, SSM_BLOCK_T, d, generator=gen), state)
        for mode, T in (("prefill", SSM_BLOCK_T), ("decode", 1)):
            x = torch.randn(LM_BATCH, T, d, generator=gen)
            on_host = {k: v.clone() for k, v in state.items()}
            on_card = {k: v.cuda() for k, v in state.items()}
            want, on_host = apply(host, x, on_host)
            got, on_card = apply(card_block, x.cuda(), on_card)
            check_close(phase, f"full-width {name} {mode} card vs host",
                        [(got.cpu(), want)] + [(on_card[k].cpu(), on_host[k])
                                               for k in sorted(on_host)], 1e-4)
        del card_block


def time_serving(model, cfg, prompts: dict, gen: int):
    """The prefill's median time (5 runs, each making its cache) and the time
    of each of ``gen`` greedy decode steps after it, by CUDA events.
    Returns (prefill_ms, step_ms, the prefill's logits, the last token)."""
    batch, prompt = prompts["tokens"].shape

    def prefill():
        return lm.prefill(model, prompts, cfg,
                          lm.init_cache(cfg, batch, prompt + gen))

    prefill_ms = time_ms(prefill, reps=5, warmup=1)
    logits, cache = prefill()
    first = logits
    tok = torch.argmax(logits, -1).to(torch.int32)
    step_ms = []
    for i in range(gen):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = lm.decode_step(model, cache, tok, prompt + i, cfg)
        stop.record()
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
    return prefill_ms, step_ms, first, tok


def prefilled(model, cfg, prompts: dict):
    """A cache holding the prompt's prefill, with one free row."""
    batch, prompt = prompts["tokens"].shape
    cache = lm.init_cache(cfg, batch, prompt + 1)
    return lm.prefill(model, prompts, cfg, cache)[1]


def check_smoke_archs(phase: str, archs) -> None:
    """The SMOKE config of each of ``archs`` in float32, card against host:
    forward, and for a decoder prefill, LM_SMOKE_DECODE decode steps and the
    cache, within ``1e-4·max|out|``."""
    for arch in archs:
        smoke = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        host_gen = torch.Generator().manual_seed(SEED)
        host = lm.init_params(host_gen, smoke, device="cpu")
        card_model = copy_module(host, "cuda")
        seq = 16 + smoke.n_prefix_embeds
        batch = make_batch(smoke, 2, seq, seed=SEED, step=1, device="cpu")
        batch.pop("targets")
        on_batch = {k: v.cuda() for k, v in batch.items()}
        want, _ = lm.forward(host, batch, smoke)
        got, _ = lm.forward(card_model, on_batch, smoke)
        pairs = [(got.cpu(), want)]
        if smoke.supports_decode():
            caches = [lm.init_cache(smoke, 2, seq + LM_SMOKE_DECODE, device=d)
                      for d in ("cpu", "cuda")]
            want, caches[0] = lm.prefill(host, batch, smoke, caches[0])
            got, caches[1] = lm.prefill(card_model, on_batch, smoke, caches[1])
            for i in range(LM_SMOKE_DECODE):
                pairs.append((got.cpu(), want))
                tok = torch.argmax(want, -1).to(torch.int32)
                want, caches[0] = lm.decode_step(host, caches[0], tok,
                                                 seq + i, smoke)
                got, caches[1] = lm.decode_step(card_model, caches[1],
                                                tok.cuda(), seq + i, smoke)
            pairs += [(got.cpu(), want)] + [
                (on_card.cpu(), on_host) for on_card, on_host
                in zip(cache_leaves(caches[1]), cache_leaves(caches[0]), strict=True)]
        drive = (f"forward, prefill and {LM_SMOKE_DECODE} decode steps"
                 if smoke.supports_decode() else "forward")
        check_close(phase, f"{arch} smoke {drive} card vs host", pairs, 1e-4)


def cache_leaves(cache) -> list[torch.Tensor]:
    """The tensors of a cache of any family (a dict of stacked tensors, the
    hybrid's nested dicts, the xLSTM's list of dicts), in a fixed order."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in cache_leaves(cache[k])]
    if isinstance(cache, list):
        return [t for c in cache for t in cache_leaves(c)]
    return [cache]


def copy_module(module: torch.nn.Module, device: str) -> torch.nn.Module:
    """A copy of ``module`` with its parameters on ``device``."""
    return copy.deepcopy(module).to(device)


# ------------------------------------------------------------------ training

def train_bounds(model: torch.nn.Module, batch: int, seq: int,
                 microbatches: int, remat: bool = True) -> dict:
    """The least time of one train step on the card: its operations over
    dense bf16's rate, its bytes over HBM's, the larger of the two.
    Operations: 2 per matmul weight and token in each pass that runs the
    weight — the forward, the rematerialised forward and the backward's two
    products (8; 6 without remat; the lm_head's CE chunks are always
    recomputed) — and causal attention (QK and PV over the causal pairs) in
    the same passes.  Bytes: the weights read by each pass of each
    microbatch, the gradients written and read by the float32 accumulation
    (the first microbatch writes the buffer, each later one reads and writes
    it), and the optimizer pass (the parameter read and written, the
    accumulated gradient read, m and v read and written)."""
    cfg = model.cfg
    elem = model.embed.table.element_size()
    n_params = sum(p.numel() for p in model.parameters())
    head = model.embed.table if cfg.tie_embeddings else model.lm_head.w
    matmul = sum(p.numel() for p in model.layers.parameters() if p.dim() >= 2)
    tokens = batch * seq
    passes = 4 if remat else 3
    layer_ops = 2 * passes * matmul * tokens
    head_ops = 8 * head.numel() * tokens
    pairs = batch * seq * (seq + 1) // 2
    attn_ops = passes * cfg.n_layers * 4 * cfg.n_heads * cfg.hd * pairs
    flops = layer_ops + head_ops + attn_ops
    weight_bytes = microbatches * 3 * n_params * elem
    accumulate_bytes = (microbatches * 2 * n_params * elem
                        + (2 * microbatches - 1) * n_params * 4)
    optimizer_bytes = n_params * (2 * elem + 4 + 16)
    nbytes = weight_bytes + accumulate_bytes + optimizer_bytes
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "ops_ms": by_ops, "bytes_ms": by_bytes, "flops": flops,
            "matmul_weights": matmul + head.numel(), "params": n_params,
            "attention_flops": attn_ops, "bytes": nbytes,
            "state_bytes": accumulate_bytes + optimizer_bytes,
            "weight_bytes": weight_bytes}


def timed_step(step, state, batch):
    """One train step timed by CUDA events; returns (state, metrics, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = step(state, batch)
    stop.record()
    torch.cuda.synchronize()
    return state, metrics, start.elapsed_time(stop)


def train_breakdown(state, batch: dict, cfg, tcfg) -> dict[str, float]:
    """The parts of one train step, each timed alone by CUDA events (median
    of 2): one microbatch's loss and gradients (forward, remat forward,
    backward), adding one microbatch's bf16 gradients into the float32
    buffers, and the AdamW update at lr 0 (the parameters stay; the moments
    move)."""
    names, params = zip(*state.params.named_parameters())
    half = {k: v[: len(v) // TRAIN_MICRO] for k, v in batch.items()}

    def grads():
        loss, _ = lm.loss_fn(state.params, half, cfg, remat=tcfg.remat)
        return torch.autograd.grad(loss, params, allow_unused=True)

    out = {"loss_and_grads_ms": time_ms(grads, reps=2, warmup=0)}
    g16 = grads()
    acc = [g.float() for g in g16]

    def accumulate():
        for a, g in zip(acc, g16):
            a.add_(g)
    out["accumulate_ms"] = time_ms(accumulate, reps=2, warmup=0)
    del g16
    g32 = dict(zip(names, acc))
    out["adamw_update_ms"] = time_ms(
        lambda: adamw_update(g32, state.opt, state.params, tcfg, 0.0),
        reps=2, warmup=0)
    return out


def phase_lm_train(card: str) -> tuple[dict[str, int], int, float, float]:
    """Training on one device, with the launch counts set to 0 just before
    and read just after (it runs none of the FFT kernels):

    (a) internlm2-1.8b FULL in bf16 from a seeded CUDA generator,
        ``TrainCfg(microbatches=TRAIN_MICRO, remat=True)``, batch
        TRAIN_BATCH x TRAIN_SEQ from ``SyntheticTokenPipeline``: first a
        float32 copy's loss on the first batch, which the first step's
        loss must be within 5e-2 of (relative); then TRAIN_STEPS steps,
        each timed by CUDA events, every loss finite; the median step beside
        ``train_bounds``, tokens/s, one more step's launches counted by the
        profiler, the step's parts timed alone (``train_breakdown``), the
        peak memory;
    (b) the step FPM (``build_step_fpm``) of the same model over
        microbatch TRAIN_FPM_MB x sequence TRAIN_FPM_SEQ, one warm and one
        timed step each, and ``choose_schedule``'s pick for TRAIN_PICK: a
        microbatch of the grid at a length >= the sequence;
    (c) the SMOKE config in float32: TRAIN_SMOKE_STEPS steps of
        ``run_training`` whose last loss is below the first by 0.5; 3 steps
        on the card against the same on the host from the same weights
        (``check_train_card_vs_host``); a kill and restart through
        ``run_training(ckpt_dir=)`` (``check_train_restart``).

    Returns the counts, the phase's peak memory, the first step's loss and
    the median step's ms."""
    phase = "lm_train"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainCfg(lr=3e-4, warmup=2, total_steps=TRAIN_STEPS,
                    microbatches=TRAIN_MICRO, remat=True)
    weights = torch.Generator(device="cuda")
    weights.manual_seed(SEED)
    state = init_train_state(weights, cfg, tcfg, device="cuda")
    pipe = SyntheticTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                                  device="cuda")
    first = pipe.next()
    model32 = lm_copy(state.params)
    with torch.no_grad():
        loss32 = float(lm.loss_fn(model32, first, model32.cfg)[0])
    del model32
    torch.cuda.empty_cache()

    step = make_train_step(cfg, tcfg)
    losses, step_ms = [], []
    batch = first
    for i in range(TRAIN_STEPS):
        state, metrics, ms = timed_step(step, state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append(ms)
        batch = pipe.next()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: losses {losses}")
    gap = abs(losses[0] - loss32) / abs(loss32)
    log(phase, check="bf16 first loss vs float32 copy", bf16_loss=losses[0],
        float32_loss=loss32, relative_gap=gap, limit=5e-2)
    if not gap <= 5e-2:
        raise AssertionError(f"{phase}: bf16 first loss {losses[0]} vs float32 "
                             f"{loss32}")
    stepped = {}
    launches = launches_of(lambda: stepped.update(state=step(state, batch)[0]))
    state = stepped.pop("state")
    bounds = train_bounds(state.params, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    breakdown = train_breakdown(state, batch, cfg, tcfg)
    median = statistics.median(step_ms[1:])
    log(phase, step="train", card=card, kind=torch.cuda.get_device_name(0),
        arch=cfg.name, layers=cfg.n_layers, params=bounds["params"],
        dtype=cfg.dtype, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MICRO, remat=True, losses=losses, step_ms=step_ms,
        step_ms_median=median, bound_ms=bounds["bound_ms"],
        bound_by=bounds["bound_by"], bound_share=bounds["bound_ms"] / median,
        tok_s=TRAIN_BATCH * TRAIN_SEQ / median * 1e3,
        launches_per_step=launches, breakdown_ms=breakdown, bounds=bounds,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # (b) the step FPM and the schedule it picks
    fpm_step = make_train_step(cfg, dataclasses.replace(tcfg, microbatches=1))
    grid = {}

    def timer(mb: int, seq: int) -> float:
        nonlocal state
        b = make_batch(cfg, mb, seq, seed=SEED, step=mb * seq, device="cuda")
        state, _ = fpm_step(state, b)
        state, _, ms = timed_step(fpm_step, state, b)
        grid[f"{mb}x{seq}"] = ms
        return ms / 1e3
    fpm = build_step_fpm(timer, TRAIN_FPM_MB, TRAIN_FPM_SEQ)
    pick = choose_schedule(fpm, **TRAIN_PICK)
    log(phase, step="fpm", card=card, step_ms=grid,
        speed=fpm.speed.tolist(), pick={"microbatch": pick[0], "padded_seq": pick[1]},
        **TRAIN_PICK)
    if pick[0] not in TRAIN_FPM_MB or pick[1] < TRAIN_PICK["seq_len"] or \
            pick[1] not in [TRAIN_PICK["seq_len"], *TRAIN_PICK["pad_candidates"]]:
        raise AssertionError(f"{phase}: choose_schedule picked {pick}")
    peak = torch.cuda.max_memory_allocated()
    del state, batch, first, fpm_step, step
    torch.cuda.empty_cache()

    # (c) the SMOKE config in float32
    smoke = run_training(TRAIN_ARCH, smoke=True, steps=TRAIN_SMOKE_STEPS,
                         lr=1e-2, batch=16, seq=32, device="cuda",
                         log_every=TRAIN_SMOKE_STEPS)
    log(phase, check="smoke run_training", steps=len(smoke),
        first_loss=smoke[0], last_loss=smoke[-1], need_drop=0.5)
    if not (all(math.isfinite(x) for x in smoke) and smoke[-1] < smoke[0] - 0.5):
        raise AssertionError(f"{phase}: smoke losses {smoke}")
    check_train_card_vs_host(phase)
    check_train_restart(phase)
    counts = launch_counts()
    log(phase, launches=counts, seconds=time.perf_counter() - t0,
        peak_memory_gib=peak / 2 ** 30)
    if any(counts.values()):
        raise AssertionError(f"the training path launched FFT kernels: {counts}")
    torch.cuda.empty_cache()
    return counts, peak, losses[0], median


def check_train_card_vs_host(phase: str) -> None:
    """3 train steps of the float32 SMOKE model from the same weights on the
    card and on the host at lr 1e-4: every parameter within
    ``1e-4·max|p|``, except where Adam's normalised step magnified a
    near-zero gradient (its second moment below 1e-6 of the parameter's
    largest: the gradient stayed ~1000x below its leaf's largest in every
    step), at most 1e-4 of the entries; the losses printed.  Adam moves an
    entry by ~lr whatever its gradient's size, so a gradient's relative
    difference shows as lr x that difference: at lr 1e-2 the card's ~1e-5
    relative differences from the host (the forward's, ``lm_serve``) put
    every entry whose gradient is below ~1e-2 of its leaf's largest past
    the limit; at 1e-4 only near-zero ones."""
    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), dtype="float32")
    tcfg = TrainCfg(lr=1e-4, warmup=0, total_steps=10, microbatches=2)
    host = init_train_state(torch.Generator().manual_seed(SEED), cfg, tcfg,
                            device="cpu")
    on_card = copy_module(host.params, "cuda")
    card = TrainState(on_card, adamw_init(on_card), {})
    step = make_train_step(cfg, tcfg)
    losses = []
    for i in range(3):
        batch = make_batch(cfg, 16, 32, seed=SEED, step=i, device="cpu")
        host, mh = step(host, batch)
        card, mc = step(card, {k: v.cuda() for k, v in batch.items()})
        losses.append((float(mh["loss"]), float(mc["loss"])))
    worst, outside, total, ties = 0.0, 0, 0, []
    for name, p in host.params.named_parameters():
        p = p.detach()
        q = card.params.get_parameter(name).detach().cpu()
        err = (q - p).abs()
        scale = float(p.abs().max())
        bad = err > 1e-4 * scale
        worst = max(worst, float(err.max()) / scale)
        total += p.numel()
        if bad.any():
            v = host.opt.v[name]
            tiny = v <= 1e-6 * float(v.max())
            if not bool(tiny[bad].all()):
                raise AssertionError(f"{phase}: {name} card vs host beyond "
                                     f"1e-4 x {scale} at a gradient that is not "
                                     f"near zero")
            outside += int(bad.sum())
            ties += [(name, idx) for idx in bad.nonzero().tolist()[:4]]
    log(phase, check="smoke 3 steps card vs host", losses_host_card=losses,
        worst_ratio=worst, limit=1e-4, near_zero_outside=outside,
        near_zero_positions=ties, entries=total)
    if outside > 1e-4 * total:
        raise AssertionError(f"{phase}: {outside} of {total} entries outside")


class TrainKilled(Exception):
    """The emulated kill of ``check_train_restart``."""


def check_train_restart(phase: str) -> None:
    """``run_training`` on the card: 10 steps unbroken, and 10 steps killed
    after the checkpoint at step 5 then resumed from it for steps 5 ... 9:
    the resumed losses within ``1e-4`` (relative) of the unbroken run's."""
    kw = dict(smoke=True, steps=10, lr=1e-3, batch=4, seq=16, ckpt_every=5,
              microbatches=1, async_ckpt=False, device="cuda", log_every=100)
    nxt = SyntheticTokenPipeline.next

    def killed_at_5(self):
        if self.step == 5:
            raise TrainKilled("killed after the checkpoint at step 5")
        return nxt(self)

    with tempfile.TemporaryDirectory() as tmp:
        unbroken = run_training(TRAIN_ARCH, ckpt_dir=os.path.join(tmp, "a"), **kw)
        SyntheticTokenPipeline.next = killed_at_5
        try:
            run_training(TRAIN_ARCH, ckpt_dir=os.path.join(tmp, "b"), **kw)
            raise AssertionError(f"{phase}: the run was not killed")
        except TrainKilled:
            pass
        finally:
            SyntheticTokenPipeline.next = nxt
        resumed = run_training(TRAIN_ARCH, ckpt_dir=os.path.join(tmp, "b"), **kw)
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, unbroken[5:], strict=True))
    log(phase, check="smoke kill and restart", unbroken=unbroken, resumed=resumed,
        worst_ratio=err, limit=1e-4)
    if not err <= 1e-4:
        raise AssertionError(f"{phase}: resumed {resumed} vs {unbroken[5:]}")


def mesh_state(state, mesh):
    """``state`` resharded onto ``mesh`` as ``run_training`` lays it out."""
    return reshard(state, mesh, state_pspecs(state, mesh), dtensor=True)


def mesh_batch(batch: dict, mesh) -> dict:
    """The batch laid out by the reference's batch specs (rows over
    "data")."""
    return reshard(batch, mesh, sanitize_pspecs(batch_pspecs(batch), batch, mesh),
                   dtensor=True)


def phase_lm_train_mesh(card: str, first_loss: float) -> tuple[dict[str, int], int]:
    """The trainer on a mesh, with the launch counts set to 0 just before and
    read just after (none of the FFT kernels):

    (a) a world of one NCCL rank, ``make_local_mesh(1, 1)``: internlm2-1.8b
        FULL in bf16 from ``lm_train``'s seed and first batch, its state
        resharded as ``run_training`` does (every parameter, moment and
        accumulator a DTensor of its sanitized reference placements, the
        batch's rows over "data"), ``lm_train``'s ``TrainCfg``: the first
        step's loss within 1e-3 (relative) of ``lm_train``'s first loss on
        the same weights, then TRAIN_MESH_STEPS steps timed by CUDA events
        beside ``train_bounds``, one step profiled (launches, the card's idle
        share), the peak memory;
    (b) on the same world, the SMOKE config through ``run_training``, which
        now runs on the 1 x 1 mesh: the kill after the checkpoint at step 5
        and the resumed run within 1e-4 of an unbroken one
        (``check_train_restart``).

    Returns the counts and the phase's peak memory."""
    phase = "lm_train_mesh"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1)
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainCfg(lr=3e-4, warmup=2, total_steps=TRAIN_STEPS,
                    microbatches=TRAIN_MICRO, remat=True)
    weights = torch.Generator(device="cuda")
    weights.manual_seed(SEED)
    state = mesh_state(init_train_state(weights, cfg, tcfg, device="cuda"), mesh)
    pipe = SyntheticTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                                  device="cuda")
    placed = all(isinstance(t, DTensor) for t in
                 [*state.params.parameters(), *state.opt.m.values(),
                  *state.opt.v.values()])
    step = make_train_step(cfg, tcfg)
    losses, step_ms = [], []
    batch = mesh_batch(pipe.next(), mesh)
    for i in range(1 + TRAIN_MESH_STEPS):
        state, metrics, ms = timed_step(step, state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append(ms)
        batch = mesh_batch(pipe.next(), mesh)
    gap = abs(losses[0] - first_loss) / abs(first_loss)
    log(phase, check="first loss vs lm_train's", mesh_loss=losses[0],
        lm_train_loss=first_loss, relative_gap=gap, limit=1e-3,
        dtensor_state=placed)
    if not (placed and gap <= 1e-3 and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"{phase}: losses {losses} vs lm_train's first "
                             f"{first_loss}; state on the mesh: {placed}")
    stepped = {}
    launches = launches_of(lambda: stepped.update(state=step(state, batch)[0]))
    state = stepped.pop("state")
    bounds = train_bounds(state.params, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    median = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated()
    log(phase, step="train", card=card, kind=torch.cuda.get_device_name(0),
        arch=cfg.name, layers=cfg.n_layers, params=bounds["params"],
        dtype=cfg.dtype, mesh=[1, 1], batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MICRO, remat=True, losses=losses, step_ms=step_ms,
        step_ms_median=median, bound_ms=bounds["bound_ms"],
        bound_by=bounds["bound_by"], bound_share=bounds["bound_ms"] / median,
        tok_s=TRAIN_BATCH * TRAIN_SEQ / median * 1e3,
        launches_per_step=launches, peak_memory_gib=peak / 2 ** 30)
    del state, batch, step, stepped
    torch.cuda.empty_cache()
    check_train_restart(phase)
    dist.destroy_process_group()
    counts = launch_counts()
    log(phase, launches=counts, seconds=time.perf_counter() - t0,
        peak_memory_gib=peak / 2 ** 30)
    if any(counts.values()):
        raise AssertionError(f"the mesh training path launched FFT kernels: {counts}")
    return counts, peak


def dryrun_worker(out: str) -> None:
    """Phase ``dryrun``'s counting, in a process of its own (``--dryrun
    out``): (a) ``lm_train``'s step on a fake 1 x 1 mesh, (b) the
    DRYRUN_CELL on the fake 16x16 production mesh; both on fake CUDA
    tensors, written to ``out`` as JSON."""
    started = time.perf_counter()
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import roofline_terms

    t0 = time.perf_counter()
    shape = ShapeCfg("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainCfg(microbatches=TRAIN_MICRO, remat=True)
    launches = {}
    reset_launch_counts()          # ---- (a)'s single drive starts
    with dryrun.fake_world((1, 1)) as mesh:
        parts, meta = dryrun.lower_cell(TRAIN_ARCH, shape.name, mesh=mesh,
                                        shape=shape, tcfg=tcfg)
        cost, coll, mems = dryrun.trace_parts(parts, meta)
        bounds = train_bounds(parts[0][1].args[0].params, TRAIN_BATCH, TRAIN_SEQ,
                              TRAIN_MICRO)
        del parts
    launches["lm_train"] = launch_counts()   # ---- and ends
    terms = roofline_terms(cost, "", 1, meta["model_flops"], coll_bytes=coll)
    train = {"flops": cost["flops"], "bytes_accessed": cost["bytes accessed"],
             "coll_bytes": coll, "memory": mems[0][1], "bound_s": terms.bound_s,
             "dominant": terms.dominant, "roofline": terms.to_dict(),
             "train_bounds_flops": bounds["flops"],
             "train_bounds_ms": bounds["bound_ms"],
             "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()      # ---- (b)'s single drive starts
        cell = dryrun.run_cell(*DRYRUN_CELL, out_dir=tmp)
        launches["cell"] = launch_counts()   # ---- and ends
    cell["seconds"] = time.perf_counter() - t0
    with open(out, "w") as fh:
        json.dump({"train": train, "cell": cell, "launches": launches,
                   "seconds": time.perf_counter() - started}, fh)


def start_dryrun() -> tuple[subprocess.Popen, str, float]:
    """Start ``dryrun_worker`` in the background, before ``build``: its fake
    trace runs on the host beside the kernels' compile and their correctness
    checks (``check_kernels``), neither of which is timed, and
    ``wait_dryrun`` awaits it before the first timed phase; it is ended at
    exit if it still runs.  Returns (the process, its output directory,
    its start)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    with open(os.path.join(tmp, "worker.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--dryrun", os.path.join(tmp, "dryrun.json")],
                                stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)
    return proc, tmp, time.perf_counter()


def wait_dryrun(worker) -> dict:
    """Await ``start_dryrun``'s worker and read what it wrote, with its wall
    seconds from start to exit (``wall_s``) and those this process waited
    for it (``waited_s``); raises when it failed or ran past
    DRYRUN_TIMEOUT_S."""
    proc, tmp, started = worker
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (t0 - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"dryrun: the worker ran past {DRYRUN_TIMEOUT_S} s")
    if proc.returncode:
        with open(os.path.join(tmp, "worker.log")) as fh:
            raise AssertionError(f"dryrun: the worker exited {proc.returncode}: "
                                 f"{fh.read()[-3000:]}")
    with open(os.path.join(tmp, "dryrun.json")) as fh:
        got = json.load(fh)
    got["wall_s"] = time.perf_counter() - started
    got["waited_s"] = time.perf_counter() - t0
    return got


def phase_dryrun(card: str, lm_train_ms: float, got: dict) -> dict[str, int]:
    """The dry-run's results, read from its worker (``wait_dryrun``), which
    set the launch counts to 0 just before each of its two traces and read
    them just after (a fake trace launches nothing): (a)'s counted
    operations must lie within DRYRUN_OPS_RATIO of ``train_bounds``' for the
    same step, printed beside its roofline bound and ``lm_train``'s measured
    median step; (b)'s record printed on a ``step: dryrun`` line.  Returns
    the worker's counts, summed over its two traces."""
    phase = "dryrun"
    train, cell = got["train"], got["cell"]
    ratio = train["flops"] / train["train_bounds_flops"]
    log(phase, step="lm_train", card=card, arch=TRAIN_ARCH, mesh=[1, 1],
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO, remat=True,
        counted_flops=train["flops"], train_bounds_flops=train["train_bounds_flops"],
        ratio=ratio, limits=list(DRYRUN_OPS_RATIO),
        bytes_accessed=train["bytes_accessed"], coll_bytes=train["coll_bytes"],
        memory=train["memory"], roofline_bound_ms=train["bound_s"] * 1e3,
        dominant=train["dominant"], train_bounds_ms=train["train_bounds_ms"],
        lm_train_step_ms=lm_train_ms, seconds=train["seconds"])
    if not DRYRUN_OPS_RATIO[0] <= ratio <= DRYRUN_OPS_RATIO[1]:
        raise AssertionError(f"{phase}: counted {train['flops']:.4e} operations, "
                             f"train_bounds {train['train_bounds_flops']:.4e}")
    log(phase, step="dryrun", card=card, arch=cell["arch"], shape=cell["shape"],
        mesh="16x16", chips=cell["chips"], parts=cell["parts"],
        n_params=cell["n_params"], roofline=cell["roofline"],
        memory=cell["memory"],
        argument_and_temp_gib=(cell["memory"]["argument_bytes"]
                               + cell["memory"]["temp_bytes"]) / 2 ** 30,
        trace_s=cell["compile_s"], seconds=cell["seconds"])
    if cell["chips"] != 256 or not cell["roofline"]["flops"] > 0:
        raise AssertionError(f"{phase}: record {cell}")
    counts = {k: sum(c[k] for c in got["launches"].values())
              for k in got["launches"]["lm_train"]}
    log(phase, launches=counts, launches_by_step=got["launches"],
        worker_s=got["seconds"], wall_s=got["wall_s"], waited_s=got["waited_s"])
    if any(counts.values()):
        raise AssertionError(f"the dry-run launched FFT kernels: {counts}")
    return counts


def time_fused_batch(gen: torch.Generator, card: str) -> None:
    """A fused batch's two layouts, on the same stack, in turns (batched,
    loop, loop, batched): ``plan.execute`` of the stack (K2 — K4 then K2
    for the real plan — over B·n rows, and one permuting copy) against the
    per-signal loop (each matrix alone, stacked), complex and real, beside
    the library.  Each layout is first held against the library within
    ``2e-4·n``."""
    fused = PlanConfig(fused=True)
    for n, b in FUSED_BATCH_SHAPES:
        x = random_signal(gen, b, n, n)
        xr = random_real(gen, b, n, n)
        plans = {"complex": (plan_pfft(n, p=P, method="lb", config=fused), x,
                             torch.fft.fft2),
                 "real": (plan_pfft(n, p=P, method="rfft-lb", config=fused,
                                    dtype="float32"), xr, torch.fft.rfft2)}
        record = {}
        for kind, (plan, sig, lib) in plans.items():
            layouts = {"batched": lambda: plan.execute(sig),
                       "loop": lambda: torch.stack([plan.execute(s) for s in sig])}
            want = lib(sig)
            for layout, fn in layouts.items():
                err = max_abs_err(fn(), want)
                record[f"{kind}_{layout}_err"] = err
                if err > signal_tol(n * n):
                    raise AssertionError(f"fused batch {kind} {layout} at "
                                         f"{n} x {b}: error {err}")
            del want
            for layout in ("batched", "loop", "loop", "batched"):
                record.setdefault(f"{kind}_{layout}_ms", []).append(
                    time_ms(layouts[layout], reps=5, warmup=1))
            record[f"{kind}_library_ms"] = time_ms(lambda: lib(sig), reps=5, warmup=1)
        log("fused_batch_time", card=card, n=n, batch=b, **record)
        del x, xr, plans


def time_runs(runs: list[tuple], card: str, reps: int = 5) -> None:
    """Median time of each checked execute beside the library's 2-D FFT on
    the same signal (``torch.fft.fft2``, or ``torch.fft.rfft2`` for a real
    signal).  Runs after the launch counts were read."""
    library_ms: dict[int, float] = {}
    for label, plan, signal, delta in runs:
        real = not signal.is_complex()
        library = torch.fft.rfft2 if real else torch.fft.fft2
        if id(signal) not in library_ms:
            library_ms[id(signal)] = time_ms(lambda: library(signal), reps=reps, warmup=1)
        key = "torch_rfft2_ms" if real else "torch_fft2_ms"
        log("main_path_time", card=card, run=label, method=plan.method,
            n=plan.n, batch=list(signal.shape[:-2]),
            config=plan.config.describe(), launches=delta,
            execute_ms=time_ms(lambda: plan.execute(signal), reps=reps, warmup=1),
            **{key: library_ms[id(signal)]})


def main() -> None:
    torch.manual_seed(SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name: str, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - start, 1)
        return out

    card = timed("env", phase_env)
    dryrun_job = start_dryrun()
    timed("build", phase_build)
    worst = timed("kernel_checks", check_kernels, gen)
    dryrun_got = wait_dryrun(dryrun_job)
    # the worker's own wall time (beside build and the kernel checks), then
    # what of it came after
    seconds["dryrun"] = round(dryrun_got["wall_s"], 1)
    seconds["dryrun_wait"] = round(dryrun_got["waited_s"], 1)
    records = timed("kernels", phase_kernels, gen, worst)
    fpms = timed("fpms", phase_fpms)
    complex_counts, runs = timed("main_path", phase_main_path, gen, fpms, card)
    real_counts, real_runs = timed("main_path_real", phase_main_path_real, gen, fpms,
                                   card)
    planner_counts, planner_runs = timed("planner", phase_planner, gen, fpms,
                                         records, card)
    bench_counts = timed("microbench_fused", phase_microbench_fused, gen, card)
    paths = {"main_path": complex_counts, "main_path_real": real_counts,
             "planner": planner_counts, "microbench_fused": bench_counts,
             "pfft3": timed("pfft3", phase_pfft3, gen, card),
             "pfft1_large": timed("pfft1_large", phase_pfft1_large, gen, card),
             "serve": timed("serve", phase_serve, gen, fpms, card),
             "dist": timed("dist", phase_dist, gen, card),
             "dist3": timed("dist3", phase_dist3, gen, card),
             "runtime": timed("runtime", phase_runtime, gen, card)}
    gloo = timed("gloo4", run_gloo_workers)
    paths["dist_gloo4"] = check_dist_gloo4(card, gloo["dist_gloo4"])
    paths["dist3_gloo4"] = check_dist_gloo4(card, gloo["dist3_gloo4"], mode="3d")
    paths["runtime_gloo4"] = check_runtime_gloo4(card, gloo["runtime_gloo4"])
    peak = torch.cuda.max_memory_allocated()     # each LM phase resets the peak
    paths["lm_serve"] = timed("lm_serve", phase_lm_serve, card)
    peak = max(peak, torch.cuda.max_memory_allocated())
    paths["lm_serve_moe"] = timed("lm_serve_moe", phase_lm_serve_moe, card)
    peak = max(peak, torch.cuda.max_memory_allocated())
    paths["lm_serve_ssm"], ssm_peak = timed("lm_serve_ssm", phase_lm_serve_ssm, card)
    peak = max(peak, ssm_peak)
    paths["lm_train"], train_peak, first_loss, train_ms = timed(
        "lm_train", phase_lm_train, card)
    peak = max(peak, train_peak)
    paths["lm_train_mesh"], mesh_peak = timed("lm_train_mesh", phase_lm_train_mesh,
                                              card, first_loss)
    peak = max(peak, mesh_peak)
    paths["dryrun"] = phase_dryrun(card, train_ms, dryrun_got)
    for record in records:
        by_path = {path: record_launches(record["name"], counts)
                   for path, counts in paths.items()}
        record["launches"] = sum(by_path.values())
        record["launches_by_path"] = by_path
        if record["name"] in WIDE_SOURCES:
            # K2's, K3's and K4's own sources at 16384 count apart (K1's
            # launches there are its record's).
            by_path = {path: counts.get(record["name"] + "_16k", 0)
                       for path, counts in paths.items()}
            record["at_16384"]["launches"] = sum(by_path.values())
            record["at_16384"]["launches_by_path"] = by_path
    timed("time_runs", time_runs, runs + real_runs + planner_runs, card)
    timed("fused_batch_time", time_fused_batch, gen, card)
    peak = max(peak, torch.cuda.max_memory_allocated())
    log("done", seconds=round(time.perf_counter() - t0, 1), phase_seconds=seconds,
        peak_memory_gib=round(peak / 2 ** 30, 2))
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        dryrun_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--gloo-rank"]:
        gloo_worker(int(sys.argv[2]), sys.argv[3], [int(p) for p in sys.argv[4:]])
    else:
        main()
