#!/usr/bin/env python3
"""Short first check of the port's CUDA kernels on a GPU.

    python3 examples/kernel_check_torch.py

Compiles each ``.cu`` with ``-Xptxas -v`` (registers, shared memory, spills),
builds and loads the library, compares every kernel with its plain PyTorch
version and with ``torch.fft`` (the transpose: bit for bit with
``x.T.contiguous()``) at a few shapes, then times them beside the library and
the plain copies over a sweep of row lengths at a fixed 2^26 elements (512 MiB
of complex64, 256 MiB of float32 for the real kernels).  The run to make after touching a CUDA
source and before the full ``chip_smoke.py``.  Needs one CUDA device and
``nvcc``; exits non-zero without them or when a kernel disagrees.

    python3 examples/kernel_check_torch.py --rfft-rows-only
    python3 examples/kernel_check_torch.py --fft-rows-only
    python3 examples/kernel_check_torch.py --rfft-rows-transpose-only
    python3 examples/kernel_check_torch.py --fft-rows-transpose-only
    python3 examples/kernel_check_torch.py --fft-rows-large-only
    python3 examples/kernel_check_torch.py --large-fused-and-real-only
    python3 examples/kernel_check_torch.py --four-step-two-pass-only

check and time the packed real row kernel alone (every shape of
``REAL_SHAPES``, its column of the sweep), the complex row kernel alone
(every shape of ``COMPLEX_SHAPES`` in both directions, its columns of the
sweep, forward and inverse), the fused real row kernel alone (every shape
of ``REAL_SHAPES``, its sweep beside ``rfft(x).T.contiguous()`` and
``x.clone()``, then at n = 16384 over ``WIDE_ROW_COUNTS`` (``time_16k``)
beside ``RFFT_TRANSPOSE_16K_VARIANTS`` and
``RFFT_TRANSPOSE_PERSISTENT_VARIANTS``), or the fused complex row kernel alone (every shape of
``COMPLEX_SHAPES`` and ``K2_RAGGED_SHAPES`` in both directions, its sweep
forward and inverse beside ``fft(x).T.contiguous()``, the complex row kernel
and ``x.clone()``, then its time at n = 8192 over ``K2_ROW_COUNTS``, where
the output rows are and are not whole 32-byte sectors apart, then at n =
16384 over ``WIDE_ROW_COUNTS`` (``time_16k``): the op (the kernel the
tree's K2 launches there), ``TRANSPOSE_16K_VARIANTS``, the library call and
``x.clone()``, one call alone and back to back; the packed real row
kernel's mode likewise at 16384 with ``RFFT_16K_VARIANTS`` and
``RFFT_PERSISTENT_VARIANTS``; ``--no-variants`` leaves the variants out,
for a tree without their sources: copied into an unpacked earlier tree,
this file times that tree's kernels in the turns of parent against
change), or the
four-step row kernel of long rows alone (every shape of ``LARGE_SHAPES`` in
both directions against its plain version and ``torch.fft``, then its time
over ``K1B_SWEEP``, one call alone and back to back, the one-pass cluster
kernel beside ``CLUSTER_VARIANTS`` at each of its lengths, each with
``cudaOccupancyMaxActiveClusters``, and the two passes at the splits of
``LARGE_SPLITS``; ``--no-variants`` leaves the variants out), or its fused
and real siblings alone (K2b, K3b and K4b: every shape of
``SIBLING_SHAPES`` against their plain versions and ``torch.fft``, K2b in
both directions, then their times over ``LARGE_SWEEP`` beside the library
and ``x.clone()``, K2b's over ``K2B_ROW_COUNTS``, and K2b's cluster kernel
beside ``TRANSPOSE_CLUSTER_VARIANTS`` and the two passes), or the two
passes of K1b and K2b pass by pass (``TWO_PASS_SHAPES``: pass A alone,
pass B alone and both, back to back, in the tree's build and in the builds
of ``TWO_PASS_VARIANTS``, each alone from a copy of the headers; the
``pfft1_large`` plans of ``TWO_PASS_PFFT1_N2`` and the ops of
``TWO_PASS_NEIGHBOURS``; the splits of ``TWO_PASS_SPLITS``; ``--no-variants``
builds the tree's passes alone): the run to repeat, in turns, on copies of
the tree that differ in one change to that kernel.  Every run prints the registers and
spills per length (and direction, and variant: pass A's packed loads,
pass B's transposed store, the real pass B's transposed split) of the
complex row kernels, of the fused real row kernel, of the four-step
kernels' passes and of the cluster kernel, where it compiles them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("kernel_check_torch.py: no CUDA device available\n")
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import PlanConfig, plan_pfft1_large  # noqa: E402
from repro_torch.kernels import (_build, fft_rows_op,  # noqa: E402
                                 fft_rows_transpose_op, rfft_rows_op,
                                 rfft_rows_transpose_op, transpose_op)
from repro_torch.kernels.fft.kernel import (complex_rows_plan,  # noqa: E402
                                            fft_rows_plain)
import repro_torch.kernels.fft.large as large_kernel  # noqa: E402
from repro_torch.kernels.fft.large import (CLUSTER_LENGTHS,  # noqa: E402
                                           cluster_plan, fft_rows_large_cuda,
                                           fft_rows_large_plain, large_split)
from repro_torch.kernels.fft.real import rfft_rows_plain  # noqa: E402
from repro_torch.kernels.fft.real_large import rfft_rows_large_plain  # noqa: E402
from repro_torch.kernels.fused.large import (  # noqa: E402
    TRANSPOSE_CLUSTER_LENGTHS, fft_rows_transpose_large_plain, transpose_cluster_plan)
from repro_torch.kernels.fused.real_large import (  # noqa: E402
    rfft_rows_transpose_large_plain)
from repro_torch.kernels.transpose.kernel import transpose_plain  # noqa: E402

# The split K1b's and K2b's two passes run at by default (``large_split``'s
# in a tree before ``two_pass_split``), and the split each op runs at.
two_pass_split = getattr(large_kernel, "two_pass_split", large_split)


def run_split(n: int, transposed: bool = False) -> list[int]:
    """(n1, n2) of K1b (K2b where ``transposed``) at length n: its cluster
    kernel's plan or its two passes' split."""
    if transposed:
        return list(transpose_cluster_plan(n)[:2] if n in TRANSPOSE_CLUSTER_LENGTHS
                    else two_pass_split(n))
    return list(cluster_plan(n)[:2] if n in CLUSTER_LENGTHS else two_pass_split(n))


# Every length the complex row kernels are instantiated for, at an odd row
# count and at 2^20 elements plus 5 rows (a ragged last CTA where a CTA holds
# several rows).
COMPLEX_SHAPES = [(rows, 1 << e) for e in range(1, 15)
                  for rows in (37, ((1 << 20) >> e) + 5)]
# Where the fused complex row kernel runs in clusters of one-row CTAs,
# 8k + 1, 8k + 7 and 4097 rows: a ragged last cluster.
K2_RAGGED_SHAPES = [(rows, n) for n in (4096, 8192, 16384)
                    for rows in (257, 263, 4097)] + [(8193, 16384)]
# Row counts of the fused complex row kernel at n = 8192: a multiple of 4
# puts each output row a whole number of 32-byte sectors after the last;
# 4097 is phase 2 of a fused rfft-* plan at N = 8192.
K2_ROW_COUNTS = [4096, 4097, 4098, 4100, 8192, 8193, 8194, 8196]
# Every length the packed real kernels are instantiated for, at an odd and an
# even row count; at n = 4096 and 8192 also 2*(4k+1) rows: one pair in the
# last cluster of 4 CTAs.
REAL_SHAPES = ([(rows, 1 << e) for e in range(1, 15)
                for rows in (37, max(2, (1 << 20) >> e))]
               + [(1, 2), (1023, 8192), (258, 4096), (258, 8192), (258, 16384),
                  (259, 16384)])
# K1b: every length from 2^15 to its top 2^28; the cluster kernel's two
# lengths at odd and even row counts, the two passes' at row counts that give
# one and several chunks of scratch (2^27 elements).
LARGE_SHAPES = [(3, 1 << 15), (2048, 1 << 15), (5000, 1 << 15), (3, 1 << 16),
                (1023, 1 << 16), (512, 1 << 17),
                (7, 1 << 18), (3, 1 << 19), (2, 1 << 20), (129, 1 << 20),
                (2, 1 << 21), (1, 1 << 22), (1, 1 << 23), (1, 1 << 24), (3, 1 << 25),
                (1, 1 << 26), (1, 1 << 27), (1, 1 << 28)]
LARGE_SWEEP = [1 << 15, 1 << 16, 1 << 17, 1 << 20, 1 << 24]
K1B_SWEEP = [1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 20, 1 << 24]
# K2b, K3b and K4b: every length from 2^15 to 2^28; at 2^15 (K2b's cluster
# kernel) 3 rows, 4 (one whole cluster), 2049 and 8193 (a ragged last
# cluster, odd output rows); at 2^16 (K2b's two passes) 1023 rows.
SIBLING_SHAPES = [(3, 1 << 15), (4, 1 << 15), (2049, 1 << 15), (8193, 1 << 15),
                  (1023, 1 << 16), (512, 1 << 17),
                  (7, 1 << 18), (3, 1 << 19), (129, 1 << 20), (2, 1 << 21),
                  (1, 1 << 22), (1, 1 << 23), (1, 1 << 24), (3, 1 << 25),
                  (1, 1 << 26), (1, 1 << 27), (1, 1 << 28)]
SIBLING_SOURCES = ("fft_rows_transpose_cluster.cu", "fft_rows_transpose_large.cu",
                   "rfft_rows_large.cu", "rfft_rows_transpose_large.cu")
# Row counts of K2b at n = 32768: a multiple of 4 puts each output row a
# whole number of 32-byte sectors after the last; 16385 is phase 2 of a
# fused rfft-* plan at N = 32768.
K2B_ROW_COUNTS = [16384, 16385, 16386, 16388]
# (n, n1) pairs of the two passes timed against the default split of n.
LARGE_SPLITS = [(1 << 19, 1024), (1 << 20, 512), (1 << 20, 2048),
                (1 << 24, 2048), (1 << 24, 8192), (1 << 24, 16384)]
# The two-pass four-step (``csrc/fourstep.cuh``) pass by pass: (kernel, rows,
# n) for K1b (``fft_rows_large.cu``, batch-major) and K2b
# (``fft_rows_transpose_large.cu``, transposed), at the records' shapes
# and at 64 x 2^20; and the splits (kernel, rows, n, n1s) timed pass by pass.
TWO_PASS_SHAPES = [("k1b", 128, 1 << 19), ("k2b", 512, 1 << 17), ("k1b", 64, 1 << 20)]
# The kernels that share fourstep.cuh with the two passes, timed beside
# them (op, rows, n): K1b's and K2b's cluster kernels, K2 at 16384 (K2b's
# cluster kernel), K3b and K4b, at their records' shapes.
TWO_PASS_NEIGHBOURS = [("fft_rows", 2048, 1 << 15), ("fft_rows", 512, 1 << 17),
                       ("fft_rows_transpose", 2048, 1 << 15),
                       ("fft_rows_transpose", 4096, 1 << 14),
                       ("rfft_rows", 2048, 1 << 15), ("rfft_rows_transpose", 2048, 1 << 15)]
# The huge-1-D plans timed beside them: 2^26 under radix=4 at its default
# split and pinned to n2 = 2^17 (K1b's cluster kernel) and 2^19 (K1b's two
# passes, 128 x 2^19, as chip_smoke.py's pfft1_large phase drives it).
TWO_PASS_PFFT1_N2 = (None, 1 << 17, 1 << 19)
TWO_PASS_SPLITS = [("k1b", 128, 1 << 19, (128, 256, 512, 1024)),
                   ("k2b", 512, 1 << 17, (128, 256, 512)),
                   ("k1b", 64, 1 << 20, (256, 512, 1024, 2048, 4096)),
                   ("k1b", 32, 1 << 21, (512, 1024, 2048)),
                   ("k1b", 16, 1 << 22, (512, 1024, 2048, 4096, 8192)),
                   ("k1b", 8, 1 << 23, (1024, 2048, 4096)),
                   ("k1b", 4, 1 << 24, (1024, 2048, 4096, 8192, 16384)),
                   ("k1b", 2, 1 << 25, (2048, 4096, 8192)),
                   ("k1b", 1, 1 << 26, (4096, 8192)),
                   ("k1b", 1, 1 << 27, (8192, 16384))]
# Each pass alone, from a copy of the headers with an entry for each
# (``columns_for`` and ``rows_for`` of ``fourstep.cuh``); ``rule`` is the
# tree's own code, the others edited copies of the header: name -> (edits,
# pass B's (kStoreRows, kRowsThreads) where the build changes them).  Pass
# A with 16 columns a CTA at n1 <= 512 (512 threads), or in persistent CTAs
# that prefetch their next tile into L2; pass B with K1's CTA and clusters
# of up to 16 CTAs for its 16 rows (``cluster_store``), K1's CTA and K2's
# 32-byte runs (``store_rows4``, the parent's pass B), 32 rows a CTA
# where 1024 threads hold them (``store_rows32``), or 16 rows within 512
# threads (``rows_threads512``: 8 rows a CTA at n2 = 1024, two CTAs of a
# cluster).
_PASS_ENTRIES = """#include "fourstep.cuh"
extern "C" int pass_a(const void* in, void* scratch, long long rows, int n1, int n2,
                      int log2cap, int transposed, int inverse, void* stream) {
    const int l1 = log2_of(n1), l2 = log2_of(n2);
    cudaStream_t s = (cudaStream_t)stream;
    if (transposed)
        return inverse ? columns_for<true, kTransposedStore>(l1, in, scratch, rows, l2, log2cap, 0, s)
                       : columns_for<false, kTransposedStore>(l1, in, scratch, rows, l2, log2cap, 0, s);
    return inverse ? columns_for<true, kBatchMajor>(l1, in, scratch, rows, l2, 0, 0, s)
                   : columns_for<false, kBatchMajor>(l1, in, scratch, rows, l2, 0, 0, s);
}
extern "C" int pass_b(const void* scratch, void* out, long long brows, int n1, int n2,
                      int log2cap, long long valid, long long out_stride, int transposed,
                      int inverse, int rows_per_cta, int threads, void* stream) {
    const int l1 = log2_of(n1), l2 = log2_of(n2);
    cudaStream_t s = (cudaStream_t)stream;
    if (transposed)
        return inverse ? rows_for<true, true>(l2, scratch, out, brows, l1, log2cap, valid,
                                              out_stride, rows_per_cta, threads, s)
                       : rows_for<false, true>(l2, scratch, out, brows, l1, log2cap, valid,
                                               out_stride, rows_per_cta, threads, s);
    return inverse ? rows_for<true, false>(l2, scratch, out, brows, l1, 0, 0, 0, rows_per_cta,
                                           threads, s)
                   : rows_for<false, false>(l2, scratch, out, brows, l1, 0, 0, 0, rows_per_cta,
                                            threads, s);
}
"""
_COLUMNS_16 = ("constexpr int kColumns = 32;", "constexpr int kColumns = 16;")
_PERSISTENT = ("constexpr bool kPersistentColumns = false;",
               "constexpr bool kPersistentColumns = true;")


def _pass_b(store_rows: int, rows_threads: int) -> list:
    """The edits that give pass B ``store_rows`` rows side by side within
    ``rows_threads`` threads a CTA (``kStoreRows``, ``kRowsThreads``)."""
    return [("constexpr int kStoreRows = 16;", f"constexpr int kStoreRows = {store_rows};"),
            ("constexpr int kRowsThreads = 1024;",
             f"constexpr int kRowsThreads = {rows_threads};")]


TWO_PASS_VARIANTS = {
    "rule": ([], None),
    "columns16": ([_COLUMNS_16], None),
    "persistent": ([_PERSISTENT], None),
    "cluster_store": (_pass_b(16, 256), (16, 256)),
    "store_rows4": (_pass_b(4, 256), (4, 256)),
    "store_rows32": (_pass_b(32, 1024), (32, 1024)),
    "rows_threads512": (_pass_b(16, 512), (16, 512)),
}


def variant_rows_plan(n2: int, brows: int, store_rows: int, rows_threads: int):
    """Pass B's CTA in a build with ``kStoreRows = store_rows`` and
    ``kRowsThreads = rows_threads`` (``rows_plan`` of
    ``kernels/fft/large.py`` at other constants): ``(rows_per_cta,
    threads)``."""
    group = n2 // 16
    most = max(max(1, 256 // group), min(store_rows, max(1, rows_threads // group)))
    per_cta = most
    while per_cta > 1 and per_cta * group > 32 and -(-brows // per_cta) < 264:
        per_cta //= 2
    return per_cta, per_cta * group


# Variants of the cluster kernel (``csrc/fourstep_cluster.cuh``), built out
# of the library from a copy of its headers: name -> (n, n1, CTAs a cluster,
# edits of the header).  ``rule`` is the library's shape, unedited, called
# as the others are (``fft_rows_op`` adds its host-side checks); the other
# cluster sizes and splits are the sweep that chose
# ``csrc/fft_rows_cluster.cu``'s shape (at 2^17 the portable 8 CTAs against
# the rule's 16, at 2^18 n1 = 256 against the near-square split); at 2^17
# and 2^18 the rule with its remote stores made local, its twiddles left out
# or taken two sincospif a point (``fourstep.cuh``'s ``twiddle``) says where
# its time goes (those three compute a wrong result on purpose; at 32768 and
# 65536 they were timed when those lengths were designed).
_TWIDDLES = "column_twiddles<INV>(v, t, G1, j2, LOG2N);"
_VARIANT_EDITS = {
    "rule": [],
    "local_stores": [("cluster.map_shared_rank(buf, o)", "buf")],
    "no_twiddle": [(_TWIDDLES, "")],
    "twiddle_per_point": [(_TWIDDLES, "for (int k = 0; k < 16; ++k) v[k] = cmul(v[k], "
                                      "twiddle<INV>((long long)(t + k * G1) * j2, LOG2N));")],
}
CLUSTER_VARIANTS = {
    **{f"{n}:{n1}x{ctas}": (n, n1, ctas, []) for n, n1, ctas in (
        (1 << 15, 128, 4), (1 << 15, 128, 2), (1 << 15, 64, 8),
        (1 << 16, 256, 4), (1 << 16, 128, 8), (1 << 17, 256, 8), (1 << 18, 256, 16))},
    **{f"{n}:{name}": (n, cluster_plan(n)[0], cluster_plan(n)[2], edits)
       for n in CLUSTER_LENGTHS for name, edits in _VARIANT_EDITS.items()
       if name == "rule" or n > 1 << 16},
}
_VARIANT_ENTRIES = """#include "fourstep_cluster.cuh"
extern "C" int variant_launch(const void* in, void* out, long long rows, int inverse,
                              void* stream) {{
    return inverse ? launch_cluster<{0}, {1}, {2}, true>(in, out, rows, (cudaStream_t)stream)
                   : launch_cluster<{0}, {1}, {2}, false>(in, out, rows, (cudaStream_t)stream);
}}
extern "C" int variant_occupancy(int inverse) {{
    return inverse ? cluster_occupancy<{0}, {1}, {2}, true>()
                   : cluster_occupancy<{0}, {1}, {2}, false>();
}}
"""
# Shapes of K2b's cluster kernel (the transposed store, ``csrc/
# fourstep_cluster.cuh``), built out of the library as ``CLUSTER_VARIANTS``
# are: name -> (n, n1, CTAs a cluster, signal rows a cluster, edits of the
# header).  ``rule`` is the library's shape (``csrc/
# fft_rows_transpose_cluster.cu``: 16 CTAs, 4 rows, n2 = 512), called as the
# others are; beside it the near-square split over 8 CTAs of 4 and 2 rows
# (the latter 16-byte runs), 16 CTAs of 8 rows (64-byte runs, one CTA an SM),
# and the rule with its output stores made contiguous, as K1b's are (a wrong
# result on purpose: what the transposed store's pattern costs).
_CONTIGUOUS_STORE = [("o[bin * out_stride + s0 + gq]",
                      "o[(s0 << LOG2N) + ((long long)rank << (LOG2N - LOG2C + LOG2R)) + idx]")]
TRANSPOSE_CLUSTER_VARIANTS = {
    **{f"{n}:{name}": (n, *transpose_cluster_plan(n)[:1], *transpose_cluster_plan(n)[2:4],
                       edits)
       for n in TRANSPOSE_CLUSTER_LENGTHS
       for name, edits in (("rule", []), ("contiguous_store", _CONTIGUOUS_STORE))},
    **{f"{n}:{n1}x{ctas}x{rows}": (n, n1, ctas, rows, []) for n, n1, ctas, rows in (
        (1 << 15, 128, 8, 4), (1 << 15, 128, 8, 2), (1 << 15, 64, 16, 8),
        (1 << 16, 256, 8, 2))},
}
_TRANSPOSE_VARIANT_ENTRIES = """#include "fourstep_cluster.cuh"
extern "C" int variant_launch(const void* in, void* out, long long rows, int inverse,
                              long long out_stride, void* stream) {{
    return inverse ? launch_cluster<{0}, {1}, {2}, true, {3}, true>(
                         in, out, rows, (cudaStream_t)stream, out_stride)
                   : launch_cluster<{0}, {1}, {2}, false, {3}, true>(
                         in, out, rows, (cudaStream_t)stream, out_stride);
}}
extern "C" int variant_occupancy(int inverse) {{
    return inverse ? cluster_occupancy<{0}, {1}, {2}, true, {3}, true>()
                   : cluster_occupancy<{0}, {1}, {2}, false, {3}, true>();
}}
"""
# K2 and K3 at n = 16384 (``csrc/fft_rows_transpose_cluster.cu``,
# ``csrc/rfft_rows_16k.cu``): the row counts timed, a call of the fused
# plans at N = 16384 among them (16384; 8193, phase 2 of the fused real
# plan, has odd output rows).
WIDE_ROW_COUNTS = {"fft_rows_transpose": [4096, 16384, 8193], "rfft_rows": [4096, 16384],
                   "rfft_rows_transpose": [4096, 16384, 16385, 16386]}
# Shapes of K2 at 16384 (the cluster kernel with the transposed store), built
# out of the library as ``TRANSPOSE_CLUSTER_VARIANTS`` are: name -> (n1, CTAs
# a cluster, rows a cluster, edits of the header).  The rule (16 CTAs of 4
# rows, n2 = 512, 256 threads a CTA), 8 CTAs of 4 rows at n2 = 256 and 512
# (512 threads), 8 rows a cluster of 8 CTAs (1024 threads, one CTA an SM)
# and of 16 (512 threads, 64-byte runs).
TRANSPOSE_16K_VARIANTS = {
    "32x16x4": (32, 16, 4, []),
    "64x8x4": (64, 8, 4, []),
    "32x8x4": (32, 8, 4, []),
    "64x8x8": (64, 8, 8, []),
    "32x16x8": (32, 16, 8, []),
}
# Shapes of K3 split over a cluster at 16384 (``packed_cluster_kernel`` of
# ``csrc/rfft_rows_cluster.cuh``, which the library does not build): name ->
# (n1, CTAs a cluster, pairs a cluster).  Its best (2 CTAs of 1 pair, 32 rows
# of B a rank: runs of 16 bins), 4 CTAs of 2 pairs (runs of 8), 8 of 4 (runs
# of 4), the split n2 = 512 over 2 CTAs and 2 pairs a cluster (1024 threads,
# one CTA an SM).
RFFT_16K_VARIANTS = {
    "64x2x1": (64, 2, 1),
    "64x4x2": (64, 4, 2),
    "64x8x4": (64, 8, 4),
    "32x2x1": (32, 2, 1),
    "64x2x2": (64, 2, 2),
}
# K3 at 16384 as one persistent 1024-thread CTA an SM over the pairs
# (``csrc/rfft_rows_16k.cu``), built from copies of the source with its
# ``kStaged`` edited: name -> slices of 1024 floats of the next pair's row b
# staged in shared memory with its row a by bulk copies (the rest of b
# prefetched into L2).  The library's 6, the most that fits, 4, and none.
RFFT_PERSISTENT_VARIANTS = {
    "persistent_stage6": 6,
    "persistent_stage4": 4,
    "persistent_stage0": 0,
}
_RFFT_PERSISTENT_ENTRIES = """#include "rfft_rows_16k.cu"
extern "C" int variant_launch(const void* in, void* out, long long rows, void* stream) {
    return launch_persistent(in, out, rows, (cudaStream_t)stream);
}
extern "C" int variant_occupancy(int) { return 0; }
"""
# Shapes of K4 at 16384 (``packed_transpose_kernel`` of
# ``csrc/rfft_rows_cluster.cuh``) built out of the library, each at every row
# count: name -> (n1, CTAs a cluster, pairs a cluster).  The library's two
# (8 CTAs of 2 pairs where rows % 4 == 0, 32-byte runs; 16 of 4 elsewhere,
# 64-byte runs; both 256 threads and 34816 bytes a CTA) and 8 CTAs of 4
# pairs at n1 = 64 (512 threads and 69632 bytes, two CTAs an SM).
RFFT_TRANSPOSE_16K_VARIANTS = {
    "32x8x2": (32, 8, 2),
    "32x16x4": (32, 16, 4),
    "64x8x4": (64, 8, 4),
}
# The design of K4 at 16384 that lost (``examples/rfft_rows_transpose_persistent.cuh``:
# persistent 1024-thread CTAs in clusters of 4, the next pair staged by bulk
# copies while the current one runs, the register kernel's cluster store),
# built beside a copy of the library's sources with ``kStaged`` of
# ``rfft_rows_16k.cu`` edited: name -> slices of row b staged with row a.
RFFT_TRANSPOSE_PERSISTENT_VARIANTS = {
    "persistent_stage6": 6,
    "persistent_stage0": 0,
}
_PERSISTENT_TRANSPOSE_HEADER = "rfft_rows_transpose_persistent.cuh"
_RFFT_TRANSPOSE_PERSISTENT_ENTRIES = """#include "rfft_rows_transpose_persistent.cuh"
extern "C" int variant_launch(const void* in, void* out, long long rows, void* stream) {
    return launch_persistent_transpose(in, out, rows, (cudaStream_t)stream);
}
extern "C" int variant_occupancy(int) { return persistent_transpose_occupancy(); }
"""
_RFFT_TRANSPOSE_16K_VARIANT_ENTRIES = """#include "rfft_rows_cluster.cuh"
extern "C" int variant_launch(const void* in, void* out, long long rows, void* stream) {{
    return launch_packed<{0}, {1}, {2}, {3}, true>(in, out, rows, (cudaStream_t)stream);
}}
extern "C" int variant_occupancy(int) {{ return packed_occupancy<{0}, {1}, {2}, {3}, true>(); }}
"""
_RFFT_16K_VARIANT_ENTRIES = """#include "rfft_rows_cluster.cuh"
extern "C" int variant_launch(const void* in, void* out, long long rows, void* stream) {{
    return launch_packed<{0}, {1}, {2}, {3}>(in, out, rows, (cudaStream_t)stream);
}}
extern "C" int variant_occupancy(int) {{ return packed_occupancy<{0}, {1}, {2}, {3}>(); }}
"""
TRANSPOSE_SHAPES = [(1, 1), (37, 129), (1000, 3), (257, 4099)]
TRANSPOSE_DTYPES = [torch.uint8, torch.float16, torch.float32, torch.complex64,
                    torch.complex128]
SWEEP_ELEMENTS = 1 << 26
SWEEP_LENGTHS = [64, 256, 1024, 2048, 4096, 8192, 16384]


def time_ms(fn, reps: int = 10) -> float:
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


# Kernels templated on log2 n and flags but not on a direction (forward only).
FORWARD_ONLY = ("rows_split",)


def kernel_registers(ptxas: str, kernel: str) -> list[dict]:
    """Registers and spill bytes of each instantiation of ``kernel`` (a
    kernel templated on log2 n, then on the direction when it has one, then
    on further flags or modes, ``flags``; or on flags alone), from ``nvcc
    -Xptxas -v`` output."""
    directed = kernel not in FORWARD_ONLY
    out, current = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d%s_kernelI(?:Li(\d+)E)?((?:L[bi]\d+E)*)"
                      % kernel, line)
        if kernel in ("rfft_persistent", "rfft_transpose_persistent") and re.search(
                r"Compiling entry function '\S*?\d%s_kernel" % kernel, line):
            current = {"n": 1 << 14}   # not a template
            out.append(current)
            continue
        if m and kernel in ("packed_cluster", "packed_transpose"):
            # <log2 n1, log2 n2, log2 C, log2 pairs a cluster>
            e1, e2, ec, er = [int(m.group(1))] + [
                int(f) for f in re.findall(r"L[bi](\d+)E", m.group(2))]
            current = {"n": 1 << (e1 + e2), "n1": 1 << e1, "ctas": 1 << ec,
                       "pairs": 1 << er}
            out.append(current)
            continue
        if m and kernel == "cluster":
            # <log2 n1, log2 n2, log2 C, inverse, log2 rows a cluster, transposed>
            e1, e2, ec, inv, er, tr = [int(m.group(1))] + [
                int(f) for f in re.findall(r"L[bi](\d+)E", m.group(2))]
            current = {"n": 1 << (e1 + e2), "n1": 1 << e1, "ctas": 1 << ec,
                       "rows": 1 << er, "transposed": bool(tr),
                       "direction": "inverse" if inv else "forward"}
            out.append(current)
            continue
        if m:
            flags = [int(f) for f in re.findall(r"L[bi](\d+)E", m.group(2))]
            current = {}
            if m.group(1):
                current["n"] = 1 << int(m.group(1))
                if flags and directed:
                    current["direction"] = "inverse" if flags.pop(0) else "forward"
            if flags:
                current["flags"] = flags
            out.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    return sorted(out, key=lambda r: (r.get("direction", ""), r.get("flags", []),
                                      r.get("n", 0), r.get("n1", 0), r.get("ctas", 0)))


# The kernels whose registers and spills a run prints, by source.
REGISTERS = {"fft_rows.cu": ("fft_rows",),
             "rfft_rows.cu": ("rfft_rows",),
             "rfft_rows_16k.cu": ("rfft_persistent",),
             "rfft_rows_transpose.cu": ("rfft_rows_transpose",),
             "rfft_rows_transpose_16k.cu": ("packed_transpose",),
             "fft_rows_transpose.cu": ("fft_rows_transpose",),
             "fft_rows_cluster.cu": ("cluster",),
             "fft_rows_transpose_cluster.cu": ("cluster",),
             "fft_rows_large.cu": ("columns", "complex_columns", "rows_transpose"),
             "fft_rows_transpose_large.cu": ("columns", "complex_columns", "rows_transpose"),
             "rfft_rows_large.cu": ("columns", "rows_split"),
             "rfft_rows_transpose_large.cu": ("columns", "rows_split")}


def start_variant_build(root, name: str, edits, entries: str,
                        edited: str = "fourstep_cluster.cuh", extra=()):
    """Start one ``nvcc`` of a variant: a copy of the sources (and of the
    files ``extra``) under ``root/<name>`` with ``edits`` made to ``edited``
    and ``entries`` as its source (which includes a header, or a source for
    its kernel); returns (library path, process)."""
    src = root / name.replace(":", "_")
    src.mkdir(parents=True)
    for path in [*_build.source_files(), *extra]:
        shutil.copy(path, src / os.path.basename(path))
    text = (src / edited).read_text()
    for old, new in edits:
        if old not in text:
            sys.exit(f"cluster variant {name}: {old!r} not in {edited}")
        text = text.replace(old, new)
    (src / edited).write_text(text)
    (src / "variant.cu").write_text(entries)
    lib = src / "variant.so"
    return lib, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         str(src / "variant.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_cluster_variants() -> dict:
    """Start one ``nvcc`` a ``CLUSTER_VARIANTS`` entry, each on a copy of the
    headers under ``build/cluster_variants/<name>`` with its edits and a
    source of two entries (``variant_launch``, ``variant_occupancy``) at its
    shape; returns name -> (library path, process)."""
    root = _build.build_root() / "cluster_variants"
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    for name, (n, n1, ctas, edits) in CLUSTER_VARIANTS.items():
        log2n1 = n1.bit_length() - 1
        started[name] = start_variant_build(root, name, edits, _VARIANT_ENTRIES.format(
            log2n1, n.bit_length() - 1 - log2n1, ctas.bit_length() - 1))
    return started


def start_transpose_variants() -> dict:
    """As ``start_cluster_variants``, for ``TRANSPOSE_CLUSTER_VARIANTS``
    (entries that take the output's row stride) under
    ``build/transpose_cluster_variants/``."""
    root = _build.build_root() / "transpose_cluster_variants"
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    for name, (n, n1, ctas, rows, edits) in TRANSPOSE_CLUSTER_VARIANTS.items():
        log2n1 = n1.bit_length() - 1
        started[name] = start_variant_build(root, name, edits, _TRANSPOSE_VARIANT_ENTRIES.format(
            log2n1, n.bit_length() - 1 - log2n1, ctas.bit_length() - 1,
            rows.bit_length() - 1))
    return started


def start_16k_variants(kernel: str) -> dict:
    """Start one ``nvcc`` a ``TRANSPOSE_16K_VARIANTS`` (``kernel`` is
    ``"fft_rows_transpose"``), ``RFFT_16K_VARIANTS`` and
    ``RFFT_PERSISTENT_VARIANTS`` (``"rfft_rows"``) or
    ``RFFT_TRANSPOSE_16K_VARIANTS`` and ``RFFT_TRANSPOSE_PERSISTENT_VARIANTS``
    entry (``"rfft_rows_transpose"``) under ``build/variants_16k/``: name ->
    (library path, process)."""
    root = _build.build_root() / "variants_16k" / kernel
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    if kernel == "rfft_rows_transpose":
        for name, (n1, ctas, pairs) in RFFT_TRANSPOSE_16K_VARIANTS.items():
            log2n1 = n1.bit_length() - 1
            started[name] = start_variant_build(root, name, [],
                                                _RFFT_TRANSPOSE_16K_VARIANT_ENTRIES.format(
                log2n1, 14 - log2n1, ctas.bit_length() - 1, pairs.bit_length() - 1))
        from repro_torch.kernels.fft.real import RFFT_16K_STAGED

        rule = f"constexpr int kStaged = {RFFT_16K_STAGED};"
        header = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              _PERSISTENT_TRANSPOSE_HEADER)
        for name, staged in RFFT_TRANSPOSE_PERSISTENT_VARIANTS.items():
            started[name] = start_variant_build(
                root, name, [(rule, f"constexpr int kStaged = {staged};")],
                _RFFT_TRANSPOSE_PERSISTENT_ENTRIES, edited="rfft_rows_16k.cu",
                extra=(header,))
    elif kernel == "fft_rows_transpose":
        for name, (n1, ctas, rows, edits) in TRANSPOSE_16K_VARIANTS.items():
            log2n1 = n1.bit_length() - 1
            started[name] = start_variant_build(root, name, edits,
                                                _TRANSPOSE_VARIANT_ENTRIES.format(
                log2n1, 14 - log2n1, ctas.bit_length() - 1, rows.bit_length() - 1))
    else:
        for name, (n1, ctas, pairs) in RFFT_16K_VARIANTS.items():
            log2n1 = n1.bit_length() - 1
            started[name] = start_variant_build(root, name, [],
                                                _RFFT_16K_VARIANT_ENTRIES.format(
                log2n1, 14 - log2n1, ctas.bit_length() - 1, pairs.bit_length() - 1))
        from repro_torch.kernels.fft.real import RFFT_16K_STAGED

        rule = f"constexpr int kStaged = {RFFT_16K_STAGED};"
        for name, staged in RFFT_PERSISTENT_VARIANTS.items():
            started[name] = start_variant_build(
                root, name, [(rule, f"constexpr int kStaged = {staged};")],
                _RFFT_PERSISTENT_ENTRIES, edited="rfft_rows_16k.cu")
    return started


def start_pass_builds(no_variants: bool) -> dict:
    """Start one ``nvcc`` a ``TWO_PASS_VARIANTS`` entry (``rule`` alone with
    ``no_variants``) under ``build/two_pass/``: name -> (library path,
    process)."""
    root = _build.build_root() / "two_pass"
    shutil.rmtree(root, ignore_errors=True)
    return {name: start_variant_build(root, name, edits, _PASS_ENTRIES, edited="fourstep.cuh")
            for name, (edits, _) in TWO_PASS_VARIANTS.items()
            if name == "rule" or not no_variants}


def load_pass_builds(started: dict) -> dict:
    """Wait for ``start_pass_builds``' builds, print each one's registers and
    spills of the two passes, and bind them: name -> (pass_a, pass_b)."""
    bound = {}
    for name, (lib, proc) in started.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"two-pass build {name}: nvcc failed\n{output}")
        for kernel in ("columns", "complex_columns", "rows_transpose"):
            for record in kernel_registers(output, kernel):
                print(json.dumps({"ptxas": kernel + "_kernel", "variant": name, **record}),
                      flush=True)
        dll = ctypes.CDLL(str(lib))
        dll.pass_a.restype = dll.pass_b.restype = ctypes.c_int
        ptr, ll, int_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        dll.pass_a.argtypes = [ptr, ptr, ll, int_, int_, int_, int_, int_, ptr]
        dll.pass_b.argtypes = [ptr, ptr, ll, int_, int_, int_, ll, ll, int_, int_, int_,
                               int_, ptr]
        bound[name] = (dll.pass_a, dll.pass_b)
    return bound


def check_two_pass(card: str, builds: dict) -> None:
    """The two-pass four-step pass by pass (``TWO_PASS_SHAPES``), forward:
    for each build of ``builds`` pass A alone, pass B alone and both, each
    back to back (``time_queued_ms``) in turns, twice (the second round in
    reverse order), the result of both checked against ``torch.fft`` in
    both directions (the edited builds' forward only); beside them the op
    one call alone and back to back, the library call, ``x.clone()`` and
    a pass's bound (its bytes once each way at 3.35 TB/s).  Then the plans
    of ``TWO_PASS_PFFT1_N2`` (checked against ``torch.fft.fft`` at
    ``2e-4·√N``) and the ops of ``TWO_PASS_NEIGHBOURS``, each one call alone
    and back to back, and the
    splits of ``TWO_PASS_SPLITS``: both passes of ``rule`` and each alone
    at each n1, checked against ``torch.fft``."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def passes(name, x, scratch, out, n1, n2, transposed, inverse=False):
        rows = x.shape[0]
        cap = 1 << max(0, rows - 1).bit_length() if transposed else 1
        log2cap = cap.bit_length() - 1
        brows = (cap if transposed else rows) * n1
        # Pass B's CTA: the build's, the tree's rows_plan, or K1's in a tree
        # before it.
        rows_plan = getattr(large_kernel, "rows_plan", None)
        pass_b_shape = TWO_PASS_VARIANTS[name][1]
        rows_per_cta, threads = (variant_rows_plan(n2, brows, *pass_b_shape) if pass_b_shape
                                 else rows_plan(n2, brows)[:2] if rows_plan
                                 else complex_rows_plan(n2, brows)[:2])
        pass_a, pass_b = builds[name]

        def a():
            err = pass_a(x.data_ptr(), scratch.data_ptr(), rows, n1, n2, log2cap,
                         int(transposed), int(inverse), stream)
            if err:
                sys.exit(f"two-pass {name} pass A: CUDA error {err}")

        def b():
            err = pass_b(scratch.data_ptr(), out.data_ptr(), brows, n1, n2, log2cap, rows,
                         rows, int(transposed), int(inverse), rows_per_cta, threads, stream)
            if err:
                sys.exit(f"two-pass {name} pass B: CUDA error {err}")
        return a, b

    for kernel, rows, n in TWO_PASS_SHAPES:
        transposed = kernel == "k2b"
        n1, n2 = two_pass_split(n)
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        cap = 1 << max(0, rows - 1).bit_length() if transposed else rows
        scratch = torch.empty((cap, n), dtype=x.dtype, device="cuda")
        out = torch.empty((n, rows) if transposed else (rows, n), dtype=x.dtype, device="cuda")
        op = fft_rows_transpose_op if transposed else fft_rows_op
        ways = {}
        for name in builds:
            a, b = passes(name, x, scratch, out, n1, n2, transposed)
            ways[name] = {"pass_a": a, "pass_b": b, "both": lambda a=a, b=b: (a(), b())}
        ms = {(name, part): [] for name in builds for part in ("pass_a", "pass_b", "both")}
        for order in (list(builds), list(builds)[::-1]):
            for name in order:
                for part, fn in ways[name].items():
                    ms[name, part].append(time_queued_ms(fn))
        library = ((lambda: torch.fft.fft(x).T.contiguous()) if transposed
                   else (lambda: torch.fft.fft(x)))
        for name in builds:
            edited = bool(TWO_PASS_VARIANTS[name][0])
            errs = {}
            for inverse in ((False,) if edited else (False, True)):
                a, b = passes(name, x, scratch, out, n1, n2, transposed, inverse)
                a()
                b()
                lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
                torch.cuda.synchronize()
                key = ("inverse" if inverse else "forward") + "_vs_library"
                errs[key] = float((out - (lib.T if transposed else lib)).abs().max())
                del lib
                if errs[key] > 1e-3 * n ** 0.5 / (n if inverse else 1):
                    sys.exit(f"two-pass {name} disagrees at {kernel} {rows} x {n}: {errs}")
            print(json.dumps({
                "card": card, "kernel": kernel, "rows": rows, "n": n, "split": [n1, n2],
                "variant": name, "edited": edited,
                **{f"{part}_queued_ms": ms[name, part] for part in ("pass_a", "pass_b",
                                                                     "both")},
                **errs}), flush=True)
        print(json.dumps({
            "card": card, "kernel": kernel, "rows": rows, "n": n, "split": [n1, n2],
            "op_ms": time_ms(lambda: op(x)), "op_queued_ms": time_queued_ms(lambda: op(x)),
            "library_ms": time_ms(library), "library_queued_ms": time_queued_ms(library),
            "clone_queued_ms": time_queued_ms(lambda: x.clone()),
            "pass_bound_ms": 2 * rows * n * 8 / 3.35e12 * 1e3}), flush=True)
        del x, scratch, out
    x = torch.complex(torch.randn(1 << 26, generator=gen, device="cuda"),
                      torch.randn(1 << 26, generator=gen, device="cuda"))
    want = torch.fft.fft(x)
    for n2 in TWO_PASS_PFFT1_N2:
        plan = plan_pfft1_large(1 << 26, config=PlanConfig(radix=4), n2=n2)
        err = float((plan.execute(x) - want).abs().max())
        if err > 2e-4 * (1 << 13):
            sys.exit(f"plan_pfft1_large(2**26, n2={n2}) disagrees: {err}")
        print(json.dumps({"card": card, "pfft1_large": 1 << 26, "n1": plan.n1, "n2": plan.n2,
                          "execute_ms": time_ms(lambda: plan.execute(x)),
                          "execute_queued_ms": time_queued_ms(lambda: plan.execute(x)),
                          "max_abs_err": err}), flush=True)
        del plan
    del x, want
    ops = {"fft_rows": fft_rows_op, "fft_rows_transpose": fft_rows_transpose_op,
           "rfft_rows": rfft_rows_op, "rfft_rows_transpose": rfft_rows_transpose_op}
    for name, rows, n in TWO_PASS_NEIGHBOURS:
        real = name.startswith("rfft")
        x = (torch.randn(rows, n, generator=gen, device="cuda") if real else
             torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                           torch.randn(rows, n, generator=gen, device="cuda")))
        op = ops[name]
        print(json.dumps({"card": card, "neighbour": name, "rows": rows, "n": n,
                          "op_ms": time_ms(lambda: op(x)),
                          "op_queued_ms": time_queued_ms(lambda: op(x))}), flush=True)
        del x
    for kernel, rows, n, n1s in TWO_PASS_SPLITS:
        transposed = kernel == "k2b"
        x = torch.randn(rows, n, dtype=torch.complex64, device="cuda")
        scratch = torch.empty_like(x)
        out = torch.empty((n, rows) if transposed else (rows, n), dtype=x.dtype, device="cuda")
        want = torch.fft.fft(x)
        for n1 in n1s:
            a, b = passes("rule", x, scratch, out, n1, n // n1, transposed)
            a()
            b()
            torch.cuda.synchronize()
            err = float((out - (want.T if transposed else want)).abs().max())
            if err > 1e-3 * n ** 0.5:
                sys.exit(f"two-pass {kernel} disagrees at n1={n1}: {err}")
            both = time_queued_ms(lambda: (a(), b()))
            print(json.dumps({
                "card": card, "kernel": kernel, "rows": rows, "n": n, "split": [n1, n // n1],
                "default": list(two_pass_split(n)), "both_queued_ms": both,
                "pass_a_queued_ms": time_queued_ms(a), "pass_b_queued_ms": time_queued_ms(b),
                "max_abs_err": err}), flush=True)
        del x, scratch, out, want
    print("OK")


def time_queued_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the device time of ``calls`` back-to-back
    calls of ``fn`` between two CUDA events, a call: the kernel's own time
    where the host enqueues faster than the card runs (``time_ms`` times one
    call alone, the host's work before its launch included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def time_16k(card: str, kernel: str, variants: dict, gen: torch.Generator) -> None:
    """K2 (``kernel`` ``"fft_rows_transpose"``), K3 (``"rfft_rows"``) or K4
    (``"rfft_rows_transpose"``) at n = 16384 over ``WIDE_ROW_COUNTS[kernel]``,
    forward, each way timed in turns, twice (the second round in reverse
    order): one call alone (``ms``, median of 10) and back to back
    (``queued_ms``, ``time_queued_ms``).  The ways: the op (one launch of the
    kernel that the tree launches at 16384: the register-resident one in a
    tree before the redesign), and the ``variants``, each called directly on
    one output buffer allocated beforehand.  Beside them the library call
    (``fft(x).T.contiguous()``, ``rfft(x)``, ``rfft(x).T.contiguous()``),
    ``x.clone()``, K1 (for K2) and the bound (bytes once each way at 3.35
    TB/s); each way with its active clusters and its error against the
    library (K2 both directions, the inverse's tolerance over n)."""
    n = 1 << 14
    k2, k4 = kernel == "fft_rows_transpose", kernel == "rfft_rows_transpose"
    shapes = ({**RFFT_TRANSPOSE_16K_VARIANTS, **RFFT_TRANSPOSE_PERSISTENT_VARIANTS} if k4
              else TRANSPOSE_16K_VARIANTS if k2
              else {**RFFT_16K_VARIANTS, **RFFT_PERSISTENT_VARIANTS})
    staged = {**RFFT_PERSISTENT_VARIANTS, **RFFT_TRANSPOSE_PERSISTENT_VARIANTS}
    stream = torch.cuda.current_stream().cuda_stream
    for rows in WIDE_ROW_COUNTS[kernel]:
        if k2:
            x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                              torch.randn(rows, n, generator=gen, device="cuda"))
            out = torch.empty((n, rows), dtype=torch.complex64, device="cuda")
        else:
            x = torch.randn(rows, n, generator=gen, device="cuda")
            out = torch.empty((n // 2 + 1, rows) if k4 else (rows, n // 2 + 1),
                              dtype=torch.complex64, device="cuda")

        def op(inverse=False):
            if k2:
                return fft_rows_transpose_op(x, inverse=inverse)
            return rfft_rows_transpose_op(x) if k4 else rfft_rows_op(x)

        def library(inverse=False):
            if k2:
                return (torch.fft.ifft(x) if inverse else torch.fft.fft(x)).T.contiguous()
            return torch.fft.rfft(x).T.contiguous() if k4 else torch.fft.rfft(x)

        def call(way, inverse=False):
            if way == "op":
                return op(inverse)
            args = (rows, int(inverse), rows) if k2 else (rows,)
            err = variants[way][0](x.data_ptr(), out.data_ptr(), *args, stream)
            if err != 0:
                sys.exit(f"{kernel} {way}: CUDA error {err}")
            return out

        ways = ["op"] + list(variants)
        ms = {way: [] for way in ways}
        queued = {way: [] for way in ways}
        for order in (ways, ways[::-1]):
            for way in order:
                ms[way].append(time_ms(lambda: call(way), reps=10))
                queued[way].append(time_queued_ms(lambda: call(way)))
        nbytes = 2 * rows * n * 8 if k2 else rows * n * 4 + rows * (n // 2 + 1) * 8
        extra = {"library_ms": time_ms(library, reps=10),
                 "library_queued_ms": time_queued_ms(library),
                 "clone_ms": time_ms(lambda: x.clone(), reps=10),
                 "clone_queued_ms": time_queued_ms(lambda: x.clone()),
                 "bound_ms": nbytes / 3.35e12 * 1e3}
        if k2:
            extra["fft_rows_ms"] = time_ms(lambda: fft_rows_op(x), reps=10)
        for way in ways:
            errs = {}
            for inverse in (False, True) if k2 else (False,):
                lib_out = library(inverse)
                got = call(way, inverse)
                torch.cuda.synchronize()
                key = ("inverse" if inverse else "forward") + "_vs_library"
                errs[key] = float((got - lib_out).abs().max())
                del lib_out, got
                if errs[key] > 1e-3 * n ** 0.5 / (n if inverse else 1):
                    sys.exit(f"{kernel} {way} disagrees at {rows} x {n}: {errs}")
            shape = ({} if way not in shapes or way in staged else dict(zip(
                ("n1", "ctas", "rows_a_cluster" if k2 else "pairs_a_cluster"),
                shapes[way][:3])))
            if way in staged:
                shape = {"staged": staged[way]}
            active = variants[way][1](0) if way in shapes else None
            print(json.dumps({"card": card, "kernel": kernel, "rows": rows, "n": n,
                              "variant": way, **shape, "active_clusters": active,
                              "ms": ms[way], "queued_ms": queued[way], **extra, **errs}),
                  flush=True)
        del x, out


def load_cluster_variants(started: dict, *, strided: bool = False,
                          real: bool = False) -> dict:
    """Wait for ``start_cluster_variants``' (``strided``:
    ``start_transpose_variants``'; ``real``: the packed real kernel's, no
    direction) builds and bind each library: name -> (launch, occupancy)."""
    bound = {}
    for name, (lib, proc) in started.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"cluster variant {name}: nvcc failed\n{output}")
        for kernel in ("cluster", "packed_cluster", "packed_transpose", "rfft_persistent",
                       "rfft_transpose_persistent"):
            for record in kernel_registers(output, kernel):
                print(json.dumps({"ptxas": kernel + "_kernel", "variant": name, **record}),
                      flush=True)
        dll = ctypes.CDLL(str(lib))
        dll.variant_launch.restype = dll.variant_occupancy.restype = ctypes.c_int
        dll.variant_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
            + ([] if real else [ctypes.c_int])
            + ([ctypes.c_longlong] if strided else []) + [ctypes.c_void_p])
        dll.variant_occupancy.argtypes = [ctypes.c_int]
        bound[name] = (dll.variant_launch, dll.variant_occupancy)
    return bound


def time_cluster_variants(card: str, variants: dict, gen: torch.Generator) -> None:
    """At each length of the cluster kernel, 2^26 elements: the kernel
    (``fft_rows_op``) and every variant of that length timed forward in
    turns, twice (the second round in reverse order), median of 20 each,
    beside ``torch.fft.fft``; each with its active clusters and its error
    against the library, the sweep's shapes checked both ways."""
    stream = torch.cuda.current_stream().cuda_stream
    for n in CLUSTER_LENGTHS:
        rows = SWEEP_ELEMENTS // n
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        lib = {inv: torch.fft.ifft(x) if inv else torch.fft.fft(x) for inv in (False, True)}
        out = torch.empty_like(x)
        names = ["kernel"] + [name for name in variants if CLUSTER_VARIANTS[name][0] == n]

        def call(name, inverse=False):
            if name == "kernel":
                return fft_rows_op(x, inverse=inverse)
            err = variants[name][0](x.data_ptr(), out.data_ptr(), rows, int(inverse), stream)
            if err != 0:
                sys.exit(f"cluster variant {name}: CUDA error {err}")
            return out

        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(time_ms(lambda: call(name), reps=20))
        n1, n2, ctas, threads, smem = cluster_plan(n)
        for name in names:
            shape = (n1, ctas) if name == "kernel" else CLUSTER_VARIANTS[name][1:3]
            edited = name != "kernel" and bool(CLUSTER_VARIANTS[name][3])
            errs = {}
            for inverse in ((False,) if edited else (False, True)):
                got = call(name, inverse)
                torch.cuda.synchronize()
                key = ("inverse" if inverse else "forward") + "_vs_library"
                errs[key] = float((got - lib[inverse]).abs().max())
                if not edited and errs[key] > 1e-3 * n ** 0.5 / (n if inverse else 1):
                    sys.exit(f"cluster kernel {name} disagrees at n={n}: {errs}")
            # ``kernel`` runs the rule's shape: its clusters are the rule's.
            rule = variants.get(f"{n}:rule" if name == "kernel" else name)
            active = rule[1](0) if rule else None
            print(json.dumps({
                "card": card, "rows": rows, "n": n, "variant": name, "n1": shape[0],
                "n2": n // shape[0], "ctas": shape[1], "edited": edited,
                "active_clusters": active, "ms": ms[name],
                "torch_fft_ms": time_ms(lambda: torch.fft.fft(x), reps=20), **errs}),
                flush=True)
        del x, lib, out


def time_transpose_variants(card: str, variants: dict, gen: torch.Generator) -> None:
    """At each length of ``TRANSPOSE_CLUSTER_VARIANTS``, 2^26 elements, and
    at 16384 and 16385 rows of 32768 (a call of the fused plans at N =
    32768; 16385 has odd output rows, phase 2 of the fused real plan): K2b
    as the library runs it (``fft_rows_transpose_op``: the cluster kernel at
    ``TRANSPOSE_CLUSTER_LENGTHS``, the two passes elsewhere) and every
    variant of that length timed forward in turns, twice (the second round
    in reverse order), median of 20 each, beside ``fft(x).T.contiguous()``;
    each variant with its active clusters and its errors against the
    library in both directions (the edited ones' forward error only)."""
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [(SWEEP_ELEMENTS // n, n)
              for n in sorted({v[0] for v in TRANSPOSE_CLUSTER_VARIANTS.values()})]
    for rows, n in shapes + [(16384, 1 << 15), (16385, 1 << 15)]:
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        out = torch.empty((n, rows), dtype=x.dtype, device="cuda")
        names = ["op"] + [name for name in variants if TRANSPOSE_CLUSTER_VARIANTS[name][0] == n]

        def call(name, inverse=False):
            if name == "op":
                return fft_rows_transpose_op(x, inverse=inverse)
            err = variants[name][0](x.data_ptr(), out.data_ptr(), rows, int(inverse), rows,
                                    stream)
            if err != 0:
                sys.exit(f"transpose cluster variant {name}: CUDA error {err}")
            return out

        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(time_ms(lambda: call(name), reps=20))
        library_ms = time_ms(lambda: torch.fft.fft(x).T.contiguous(), reps=20)
        for name in names:
            edited = name != "op" and bool(TRANSPOSE_CLUSTER_VARIANTS[name][4])
            errs = {}
            for inverse in ((False,) if edited else (False, True)):
                lib = (torch.fft.ifft(x) if inverse else torch.fft.fft(x)).T
                got = call(name, inverse)
                torch.cuda.synchronize()
                key = ("inverse" if inverse else "forward") + "_vs_library"
                errs[key] = float((got - lib).abs().max())
                del lib
                if not edited and errs[key] > 1e-3 * n ** 0.5 / (n if inverse else 1):
                    sys.exit(f"K2b {name} disagrees at n={n}: {errs}")
            shape = ({"design": "cluster" if n in TRANSPOSE_CLUSTER_LENGTHS else "two_pass"}
                     if name == "op" else dict(zip(("n1", "ctas", "rows_a_cluster"),
                                                   TRANSPOSE_CLUSTER_VARIANTS[name][1:4])))
            active = None if name == "op" else variants[name][1](0)
            print(json.dumps({
                "card": card, "rows": rows, "n": n, "variant": name, **shape,
                "edited": edited,
                "active_clusters": active, "ms": ms[name],
                "torch_fft_T_contiguous_ms": library_ms, **errs}), flush=True)
        del x, out


def compile_sources(needed: tuple[str, ...] | None) -> str:
    """Print the card, compile each ``.cu`` of ``needed`` (None: every one,
    printing ptxas' whole output) with ``-Xptxas -v`` and print the
    registers and spills of its kernels, then build and load the library.
    Returns the card's name and power limit."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, "| torch", torch.__version__, "| cuda", torch.version.cuda, flush=True)
    nvcc = _build._find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for src in _build.source_files():
            if src.suffix != ".cu" or (needed is not None and src.name not in needed):
                continue
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", os.path.join(tmp, src.stem + ".o")],
                capture_output=True, text=True)
            if done.returncode != 0 or needed is None:
                print(f"--- {src.name} (exit {done.returncode})\n{done.stderr.strip()}",
                      flush=True)
            if done.returncode != 0:
                sys.exit(1)
            for name in REGISTERS.get(src.name, ()):
                for record in kernel_registers(done.stderr, name):
                    print(json.dumps({"ptxas": name + "_kernel", "source": src.name,
                                      **record}), flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build + load: {time.perf_counter() - t0:.2f} s", flush=True)
    return card


def check_siblings(card: str, variants: dict) -> None:
    """K2b, K3b and K4b (``fft_rows_transpose_op``, ``rfft_rows_op`` and
    ``rfft_rows_transpose_op`` above 16384) at ``SIBLING_SHAPES`` against
    their plain versions and the library, ``1e-3·sqrt(n)`` (K2b's inverse
    over n), then timed over ``LARGE_SWEEP`` at 2^26 elements, K2b beside
    K1b and the library at n = 32768 over ``K2B_ROW_COUNTS``, and K2b
    beside the ``variants`` of its cluster kernel
    (``time_transpose_variants``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for rows, n in SIBLING_SHAPES:
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        for inverse in (False, True):
            tol = 1e-3 * n ** 0.5 / (n if inverse else 1)
            got = fft_rows_transpose_op(x, inverse=inverse)
            torch.cuda.synchronize()
            errs = {"k2b_vs_plain": float((got - fft_rows_transpose_large_plain(
                        x, inverse=inverse)).abs().max())}
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            errs["k2b_vs_library"] = float((got - lib.T).abs().max())
            del got, lib
            print(json.dumps({"rows": rows, "n": n, "split": run_split(n, True),
                              "inverse": inverse, "atol": tol, **errs}), flush=True)
            if max(errs.values()) > tol:
                sys.exit(f"K2b disagrees: {errs} > {tol}")
        del x
        xr = torch.randn(rows, n, generator=gen, device="cuda")
        tol = 1e-3 * n ** 0.5
        lib = torch.fft.rfft(xr)
        got3 = rfft_rows_op(xr)
        got4 = rfft_rows_transpose_op(xr)
        torch.cuda.synchronize()
        errs = {"k3b_vs_plain": float((got3 - rfft_rows_large_plain(xr)).abs().max()),
                "k3b_vs_library": float((got3 - lib).abs().max()),
                "k4b_vs_plain": float((got4 - rfft_rows_transpose_large_plain(xr))
                                      .abs().max()),
                "k4b_vs_library": float((got4 - lib.T).abs().max())}
        print(json.dumps({"rows": rows, "n": n, "atol": tol, **errs}), flush=True)
        if max(errs.values()) > tol:
            sys.exit(f"K3b/K4b disagree: {errs} > {tol}")
        del xr, lib, got3, got4
    for n in LARGE_SWEEP:
        x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
        xr = torch.randn(SWEEP_ELEMENTS // n, n, device="cuda")
        print(json.dumps({
            "card": card, "rows": x.shape[0], "n": n, "split": run_split(n, True),
            "real_split": large_split(n),
            "fft_rows_transpose_large_ms": time_ms(lambda: fft_rows_transpose_op(x)),
            "fft_rows_transpose_large_inverse_ms": time_ms(
                lambda: fft_rows_transpose_op(x, inverse=True)),
            "fft_rows_large_ms": time_ms(lambda: fft_rows_op(x)),
            "torch_fft_T_contiguous_ms": time_ms(lambda: torch.fft.fft(x).T.contiguous()),
            "clone_ms": time_ms(lambda: x.clone()),
            "rfft_rows_large_ms": time_ms(lambda: rfft_rows_op(xr)),
            "rfft_rows_transpose_large_ms": time_ms(lambda: rfft_rows_transpose_op(xr)),
            "torch_rfft_ms": time_ms(lambda: torch.fft.rfft(xr)),
            "torch_rfft_T_contiguous_ms": time_ms(
                lambda: torch.fft.rfft(xr).T.contiguous()),
            "real_clone_ms": time_ms(lambda: xr.clone())}), flush=True)
        del x, xr
    for rows in K2B_ROW_COUNTS:
        x = torch.randn(rows, 1 << 15, dtype=torch.complex64, device="cuda")
        print(json.dumps({
            "card": card, "rows": rows, "n": 1 << 15,
            "fft_rows_transpose_large_ms": time_ms(lambda: fft_rows_transpose_op(x)),
            "fft_rows_large_ms": time_ms(lambda: fft_rows_op(x)),
            "torch_fft_T_contiguous_ms": time_ms(lambda: torch.fft.fft(x).T.contiguous())}),
            flush=True)
        del x
    time_transpose_variants(card, variants, gen)
    print("OK")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--rfft-rows-only", action="store_true",
                      help="check and time the packed real row kernel alone")
    only.add_argument("--fft-rows-only", action="store_true",
                      help="check and time the complex row kernel alone")
    only.add_argument("--rfft-rows-transpose-only", action="store_true",
                      help="check and time the fused real row kernel alone")
    only.add_argument("--fft-rows-transpose-only", action="store_true",
                      help="check and time the fused complex row kernel alone")
    only.add_argument("--fft-rows-large-only", action="store_true",
                      help="check and time the four-step row kernel of long rows alone")
    only.add_argument("--large-fused-and-real-only", action="store_true",
                      help="check and time the four-step fused and real kernels alone")
    only.add_argument("--four-step-two-pass-only", action="store_true",
                      help="time the two passes of K1b and K2b pass by pass, and their splits")
    parser.add_argument("--no-variants", action="store_true",
                        help="build and time no variant of the kernels at n = 16384 or "
                             "of the cluster kernel of long rows")
    args = parser.parse_args()
    only_k3, only_k1 = args.rfft_rows_only, args.fft_rows_only
    only_k4, only_k2 = args.rfft_rows_transpose_only, args.fft_rows_transpose_only
    only_k1b, only_siblings = args.fft_rows_large_only, args.large_fused_and_real_only
    if args.four_step_two_pass_only:
        started = start_pass_builds(args.no_variants)
        card = compile_sources(("fft_rows_large.cu", "fft_rows_transpose_large.cu"))
        check_two_pass(card, load_pass_builds(started))
        return
    if only_siblings:
        started = start_transpose_variants()
        card = compile_sources(SIBLING_SOURCES)
        check_siblings(card, load_cluster_variants(started, strided=True))
        return
    run_k1 = not (only_k3 or only_k4 or only_k2 or only_k1b)
    run_k2 = not (only_k3 or only_k4 or only_k1 or only_k1b)
    run_k1b = not (only_k3 or only_k4 or only_k1 or only_k2)
    # The sources a kernel-alone mode compiles (the others: every source).
    needed = (("fft_rows.cu",) if only_k1
              else ("rfft_rows_transpose.cu", "rfft_rows_transpose_16k.cu") if only_k4
              else ("fft_rows_transpose.cu", "fft_rows_transpose_cluster.cu") if only_k2
              else ("rfft_rows.cu", "rfft_rows_16k.cu") if only_k3
              else ("fft_rows_cluster.cu", "fft_rows_large.cu") if only_k1b else None)
    variant_builds = start_cluster_variants() if only_k1b and not args.no_variants else {}
    wide = ("fft_rows_transpose" if only_k2 else "rfft_rows" if only_k3
            else "rfft_rows_transpose" if only_k4 else None)
    wide_builds = start_16k_variants(wide) if wide and not args.no_variants else {}
    card = compile_sources(needed)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = ((COMPLEX_SHAPES if run_k1 or run_k2 else [])
              + (K2_RAGGED_SHAPES if run_k2 else []))
    for rows, n in shapes:
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        for inverse in (False, True):
            # 1e-3*sqrt(n) on the unscaled transform: the inverse's 1/n
            # scale shrinks its values, and so its tolerance, by n.
            tol = 1e-3 * n ** 0.5 / (n if inverse else 1)
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            for radix in (2, 4):
                plain = fft_rows_plain(x, inverse=inverse, radix=radix)
                errs = {}
                if run_k1 and (rows, n) in COMPLEX_SHAPES:
                    k1 = fft_rows_op(x, inverse=inverse, radix=radix)
                    torch.cuda.synchronize()
                    errs |= {"k1_vs_plain": float((k1 - plain).abs().max()),
                             "k1_vs_library": float((k1 - lib).abs().max())}
                if run_k2:
                    k2 = fft_rows_transpose_op(x, inverse=inverse, radix=radix)
                    torch.cuda.synchronize()
                    errs |= {"k2_vs_plain": float((k2 - plain.T).abs().max()),
                             "k2_vs_library": float((k2 - lib.T).abs().max())}
                print(json.dumps({"rows": rows, "n": n, "radix": radix,
                                  "inverse": inverse, "atol": tol, **errs}),
                      flush=True)
                if max(errs.values()) > tol:
                    sys.exit(f"complex row kernel disagrees: {errs} > {tol}")

    for rows, n in LARGE_SHAPES if run_k1b else []:
        x = torch.complex(torch.randn(rows, n, generator=gen, device="cuda"),
                          torch.randn(rows, n, generator=gen, device="cuda"))
        for inverse in (False, True):
            tol = 1e-3 * n ** 0.5 / (n if inverse else 1)
            got = fft_rows_op(x, inverse=inverse)
            torch.cuda.synchronize()
            errs = {"k1b_vs_plain": float((got - fft_rows_large_plain(
                        x, inverse=inverse)).abs().max())}
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            errs["k1b_vs_library"] = float((got - lib).abs().max())
            del got, lib
            print(json.dumps({"rows": rows, "n": n, "split": run_split(n),
                              "inverse": inverse, "atol": tol, **errs}), flush=True)
            if max(errs.values()) > tol:
                sys.exit(f"four-step row kernel disagrees: {errs} > {tol}")
        del x
    if only_k1b:
        for n in K1B_SWEEP:
            x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
            print(json.dumps({
                "card": card, "rows": x.shape[0], "n": n, "split": run_split(n),
                "design": "cluster" if n in CLUSTER_LENGTHS else "two_pass",
                "fft_rows_large_ms": time_ms(lambda: fft_rows_op(x)),
                "fft_rows_large_queued_ms": time_queued_ms(lambda: fft_rows_op(x)),
                "fft_rows_large_inverse_ms": time_ms(lambda: fft_rows_op(x, inverse=True)),
                "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
                "clone_ms": time_ms(lambda: x.clone()),
                "bound_ms": 2 * SWEEP_ELEMENTS * 8 / 3.35e12 * 1e3}), flush=True)
            del x
        time_cluster_variants(card, load_cluster_variants(variant_builds), gen)
        for n, n1 in LARGE_SPLITS:
            x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
            want = torch.fft.fft(x)
            err = float((fft_rows_large_cuda(x, n1=n1) - want).abs().max())
            if err > 1e-3 * n ** 0.5:
                sys.exit(f"four-step row kernel disagrees at n1={n1}: {err}")
            del want
            print(json.dumps({
                "card": card, "rows": x.shape[0], "n": n, "split": large_split(n, n1=n1),
                "split_ms": time_ms(lambda: fft_rows_large_cuda(x, n1=n1)),
                "default": run_split(n), "default_ms": time_ms(lambda: fft_rows_op(x)),
                "max_abs_err": err}), flush=True)
            del x
        print("OK")
        return

    for rows, n in [] if only_k1 or only_k2 else REAL_SHAPES:
        x = torch.randn(rows, n, generator=gen, device="cuda")
        tol = 1e-3 * n ** 0.5
        lib = torch.fft.rfft(x)
        for radix in (2, 4):
            plain = rfft_rows_plain(x, radix=radix)
            errs = {}
            if not only_k4:
                k3 = rfft_rows_op(x, radix=radix)
                torch.cuda.synchronize()
                errs |= {"k3_vs_plain": float((k3 - plain).abs().max()),
                         "k3_vs_library": float((k3 - lib).abs().max())}
            if not only_k3:
                k4 = rfft_rows_transpose_op(x, radix=radix)
                torch.cuda.synchronize()
                errs |= {"k4_vs_plain": float((k4 - plain.T).abs().max()),
                         "k4_vs_library": float((k4 - lib.T).abs().max())}
            print(json.dumps({"rows": rows, "n": n, "radix": radix, "atol": tol,
                              **errs}), flush=True)
            if max(errs.values()) > tol:
                sys.exit(f"real kernel disagrees: {errs} > {tol}")

    for r, c in [] if not (run_k1 and run_k2) else TRANSPOSE_SHAPES:
        for dtype in TRANSPOSE_DTYPES:
            x = torch.randn(r, c, generator=gen, device="cuda",
                            dtype=torch.float64 if dtype == torch.complex128
                            else torch.float32)
            x = (torch.complex(x, -x) if dtype.is_complex else x * 50).to(dtype)
            got = transpose_op(x)
            torch.cuda.synchronize()
            exact = (torch.equal(got, x.T.contiguous())
                     and torch.equal(got, transpose_plain(x)))
            print(json.dumps({"transpose": [r, c], "dtype": str(dtype),
                              "bit_exact": exact}), flush=True)
            if not exact:
                sys.exit(f"transpose differs at {(r, c)} {dtype}")

    for n in SWEEP_LENGTHS:
        if only_k1:
            x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
            print(json.dumps({
                "card": card, "rows": x.shape[0], "n": n,
                "fft_rows_ms": time_ms(lambda: fft_rows_op(x)),
                "fft_rows_inverse_ms": time_ms(lambda: fft_rows_op(x, inverse=True)),
                "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
                "torch_ifft_ms": time_ms(lambda: torch.fft.ifft(x)),
                "clone_ms": time_ms(lambda: x.clone())}), flush=True)
            del x
            continue
        if only_k2:
            x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
            print(json.dumps({
                "card": card, "rows": x.shape[0], "n": n,
                "fft_rows_transpose_ms": time_ms(lambda: fft_rows_transpose_op(x)),
                "fft_rows_transpose_inverse_ms": time_ms(
                    lambda: fft_rows_transpose_op(x, inverse=True)),
                "fft_rows_ms": time_ms(lambda: fft_rows_op(x)),
                "torch_fft_T_contiguous_ms": time_ms(
                    lambda: torch.fft.fft(x).T.contiguous()),
                "torch_ifft_T_contiguous_ms": time_ms(
                    lambda: torch.fft.ifft(x).T.contiguous()),
                "clone_ms": time_ms(lambda: x.clone())}), flush=True)
            del x
            continue
        xr = torch.randn(SWEEP_ELEMENTS // n, n, device="cuda")
        if only_k4:
            print(json.dumps({
                "card": card, "rows": xr.shape[0], "n": n, "dtype": "float32",
                "rfft_rows_transpose_ms": time_ms(lambda: rfft_rows_transpose_op(xr)),
                "rfft_rows_transpose_queued_ms": time_queued_ms(
                    lambda: rfft_rows_transpose_op(xr)),
                "torch_rfft_T_contiguous_ms": time_ms(
                    lambda: torch.fft.rfft(xr).T.contiguous()),
                "clone_ms": time_ms(lambda: xr.clone())}), flush=True)
            continue
        if only_k3:
            print(json.dumps({
                "card": card, "rows": xr.shape[0], "n": n, "dtype": "float32",
                "rfft_rows_ms": time_ms(lambda: rfft_rows_op(xr)),
                "torch_rfft_ms": time_ms(lambda: torch.fft.rfft(xr))}), flush=True)
            continue
        x = torch.randn(SWEEP_ELEMENTS // n, n, dtype=torch.complex64, device="cuda")
        print(json.dumps({
            "card": card, "rows": x.shape[0], "n": n,
            "fft_rows_ms": time_ms(lambda: fft_rows_op(x)),
            "fft_rows_radix2_ms": time_ms(lambda: fft_rows_op(x, radix=2)),
            "fft_rows_transpose_ms": time_ms(lambda: fft_rows_transpose_op(x)),
            "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
            "torch_fft_T_contiguous_ms": time_ms(
                lambda: torch.fft.fft(x).T.contiguous()),
            "T_contiguous_ms": time_ms(lambda: x.T.contiguous()),
            "transpose_op_ms": time_ms(lambda: transpose_op(x)),
            "clone_ms": time_ms(lambda: x.clone())}), flush=True)
        print(json.dumps({
            "card": card, "rows": xr.shape[0], "n": n, "dtype": "float32",
            "rfft_rows_ms": time_ms(lambda: rfft_rows_op(xr)),
            "rfft_rows_transpose_ms": time_ms(lambda: rfft_rows_transpose_op(xr)),
            "torch_rfft_ms": time_ms(lambda: torch.fft.rfft(xr)),
            "torch_rfft_T_contiguous_ms": time_ms(
                lambda: torch.fft.rfft(xr).T.contiguous())}), flush=True)
        del x, xr
    for rows in K2_ROW_COUNTS if only_k2 else []:
        x = torch.randn(rows, 8192, dtype=torch.complex64, device="cuda")
        print(json.dumps({
            "card": card, "rows": rows, "n": 8192,
            "fft_rows_transpose_ms": time_ms(lambda: fft_rows_transpose_op(x)),
            "fft_rows_ms": time_ms(lambda: fft_rows_op(x)),
            "torch_fft_T_contiguous_ms": time_ms(
                lambda: torch.fft.fft(x).T.contiguous())}), flush=True)
        del x
    if wide:
        time_16k(card, wide, load_cluster_variants(wide_builds, strided=only_k2,
                                                   real=only_k3 or only_k4), gen)
    print("OK")


if __name__ == "__main__":
    main()
