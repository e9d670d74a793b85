#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the ``src/repro_torch`` package beside
this file; it imports nothing of JAX and nothing of the JAX package.  Phases,
each of which ends the run with a non-zero exit code when it fails:

1. ``env``       versions, ``nvcc``, the card's name and power limit, SM count.
2. ``build``     compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. ``kernels``   every kernel against its plain PyTorch version and the
                 library on the card (ragged and odd row counts, every length
                 the row kernels K1-K4 are built for, both directions of K1
                 and K2, ragged clusters of K2 and K4, the full width; the
                 transpose bit for bit), then its
                 time beside the plain version's, the library's and the card's
                 bound at the main path's shape.
4. ``main_path`` FPMs timed on the card, then ``plan_pfft(...).execute`` for
                 PFFT-LB / PFFT-FPM at N = 8192 and PFFT-FPM-PAD / PFFT-FPM-CZT
                 at N = 4096 under the library, kernel and fused configs, each
                 checked against its oracle, with the kernels' launch counts
                 showing which path ran.
5. ``main_path_real`` the same for the real-input methods: ``rfft-lb`` /
                 ``rfft-fpm`` at N = 8192 and ``rfft-fpm-pad`` at N = 4096
                 (float32 signals, half-spectrum output), a batch,
                 ``execute_many`` and ``irfft2(rfft2(x))``.
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

Each path (4, 5, 6, 7) is driven once with the launch counts set to 0 just
before and read just after; each of its kernels must have launched.  Every
line but the last is a log or a JSON record; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase passed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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

from repro_torch.core import (FPMSet, PlanConfig, SpeedFunction, build_fpm,  # noqa: E402
                              fft_flops, irfft2, lb_partition, plan_pfft, rfft2)
from repro_torch.fft import fft_rows  # noqa: E402
from repro_torch.kernels import (_build, fft_rows_op, fft_rows_transpose_op,  # noqa: E402
                                 launch_counts, reset_launch_counts,
                                 rfft_rows_op, rfft_rows_transpose_op,
                                 transpose_op)
from repro_torch.kernels.fft.kernel import fft_rows_plain  # noqa: E402
from repro_torch.kernels.fft.real import rfft_rows_plain  # noqa: E402
from repro_torch.kernels.fused.kernel import fft_rows_transpose_plain  # noqa: E402
from repro_torch.kernels.fused.real import rfft_rows_transpose_plain  # noqa: E402
from repro_torch.kernels.transpose.kernel import transpose_plain  # noqa: E402
from repro_torch.plan import (CostParams, PlanCache, candidate_configs,  # noqa: E402
                              estimate_cost, fit_cost_params, measure_configs,
                              measure_rfft_configs, record_wisdom, wisdom_key)

SEED = 0
P = 4
N_UNPADDED = 8192     # lb, fpm
N_PADDED = 4096       # fpm-pad, fpm-czt: a pow2 pad of 8192 still fits the kernel
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
# ... 8192), at two odd row counts: 37 (few rows, a ragged last CTA wherever
# a CTA holds several rows) and 2^20 elements plus 5 rows (a full grid with a
# ragged last CTA up to n = 1024, a ragged last cluster of K2 from 2048 on).
COMPLEX_KERNEL_SHAPES = [(rows, 1 << e) for e in range(1, 14)
                         for rows in (37, ((1 << 20) >> e) + 5)]
# Where K2 runs in clusters of 4 one-row CTAs: 8k + 1, 8k + 7 and 4097 rows
# (phase 2 of a fused rfft-* plan at N = 8192) leave the last one ragged.
K2_RAGGED_SHAPES = [(rows, n) for n in (4096, 8192) for rows in (257, 263, 4097)]
# Every length the packed real kernels are instantiated for (n = 2 ... 8192),
# at an odd row count (an unpaired last row, few pairs per CTA) and an even
# one (2^20 elements), the main path's shape, and at n = 4096 and 8192, where
# a CTA holds one pair, 2*(4k+1) and 2*(4k+1)+1 rows: 1 and 2 pairs in the
# last cluster of 4 CTAs, with even and odd rows.
REAL_KERNEL_SHAPES = ([(rows, 1 << e) for e in range(1, 14)
                       for rows in (37, max(2, (1 << 20) >> e))] + [MAIN_SHAPE]
                      + [(rows, n) for n in (4096, 8192) for rows in (258, 259)])
TRANSPOSE_SHAPES = [(1, 1), (37, 129), (1000, 3), (4096, 8192), (8192, 8192)]
# Every other element size the transpose kernel is built for, at small shapes.
TRANSPOSE_OTHER_DTYPES = [torch.uint8, torch.float16, torch.float64, torch.complex128]
MICROBENCH_N = (1024, 8192)
# The planner's measured problems: lb and rfft-lb over these N (>= 8 wisdom
# entries with fpm-pad, so that fit_cost_params fits); the lb pots raced at
# each N are calibration samples (four sizes, so that the fit can tell the
# compute terms from the traffic term).
PLANNER_N = (1024, 2048, 4096, 8192)
SOURCES = "src/repro_torch/kernels/csrc/"


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
                  kernel, plain, library) -> dict:
    """One record of the ``kernels`` line, timed here (launch counts are
    filled in after the paths have run)."""
    ms = time_ms(kernel, reps=20)
    return {"name": name, "route": "cuda", "source": SOURCES + name + ".cu",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(plain, reps=3, warmup=1), **limits,
            "library_ms": time_ms(library, reps=20), "shape": list(shape),
            "max_err": err, "kernel_ms": ms}


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


def phase_kernels(gen: torch.Generator) -> list[dict]:
    """Each kernel against its plain version at every shape, then timed at
    the main path's shape.  Returns the records of the ``kernels`` line
    (launch counts are filled in after the main path has run)."""
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
    check_transpose(gen, worst)

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
    return [
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
    ]


def check_complex_kernel(gen: torch.Generator) -> None:
    """K1 and K2 at every length they are instantiated for, K2 also at its
    ragged clusters, both directions, both radices (the plain version's
    stage loop), against ``fft_rows_plain`` (transposed for K2) and
    ``torch.fft.fft`` / ``ifft``, ``atol = row_fft_tol(n, inverse)``."""
    for rows, n in COMPLEX_KERNEL_SHAPES + K2_RAGGED_SHAPES:
        x = random_signal(gen, rows, n)
        for inverse in (False, True):
            tol = row_fft_tol(n, inverse)
            lib = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            for radix in (2, 4):
                plain = fft_rows_plain(x, inverse=inverse, radix=radix)
                got_t = fft_rows_transpose_op(x, inverse=inverse, radix=radix)
                torch.cuda.synchronize()
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
    transposed copy) on unit-variance float32 rows, ``atol = 1e-3·sqrt(n)``;
    ``worst`` gets the errors against the plain versions at the main shape."""
    for rows, n in REAL_KERNEL_SHAPES:
        x = random_real(gen, rows, n)
        tol = 1e-3 * math.sqrt(n)
        lib = torch.fft.rfft(x)
        for radix in (2, 4):
            plain = rfft_rows_plain(x, radix=radix)
            got = rfft_rows_op(x, radix=radix)
            got_t = rfft_rows_transpose_op(x, radix=radix)
            torch.cuda.synchronize()
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
    for n in (N_UNPADDED, N_PADDED):
        t0 = time.perf_counter()
        fpms[n] = measured_fpms(n)
        homo = fpms[n][0]
        log("main_path", step="fpm", n=n, seconds=round(time.perf_counter() - t0, 2),
            xs=homo[0].xs.tolist(), ys=homo[0].ys.tolist(),
            gflops=np.round(homo[0].speed / 1e9, 1).tolist())
    return fpms


def end_drive(path: str, kernels: tuple[str, ...]) -> dict[str, int]:
    """Read the counts just after a path's drive; each of its kernels must
    have launched."""
    counts = launch_counts()
    log(path, launches=counts)
    for name in kernels:
        if counts[name] < 1:
            raise AssertionError(f"the {path} path never launched {name}")
    return counts


def phase_main_path(gen: torch.Generator, fpms) -> tuple[dict[str, int], list[tuple]]:
    """Drive the complex main path once, with the launch counts set to 0 just
    before and read just after.  Returns the counts and the checked runs (for
    the timing pass, which is not part of the counted drive)."""
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
    n = N_BATCH
    batch = random_signal(gen, 2, n, n)
    oracle = torch.fft.fft2(batch)
    for cfg, expect in ((kernel, {"fft_rows": 4, "fft_rows_transpose": 0}),
                        (fused, {"fft_rows": 0, "fft_rows_transpose": 4}),
                        (PlanConfig(radix=2, fused=True),
                         {"fft_rows": 0, "fft_rows_transpose": 4})):
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

    # ---- the main path's single drive ends
    return end_drive("main_path", ("fft_rows", "fft_rows_transpose")), runs


def phase_main_path_real(gen: torch.Generator, fpms) -> tuple[dict[str, int], list[tuple]]:
    """Drive the real-input path once (``rfft-*`` plans, ``rfft2`` /
    ``irfft2``), with the launch counts set to 0 just before and read just
    after.  Returns the counts and the checked runs."""
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
        pow2 = [sum(1 for length, *_ in g if not length & (length - 1))
                for g in (groups1, groups2)]
        check_execute(plan, signal, ref, f"{tag}/{kernel.describe()}",
                      {"rfft_rows": pow2[0], "fft_rows": pow2[1]}, runs,
                      "main_path_real")
    hetero_pads = plan_pfft(n, method="rfft-fpm-pad", fpms=hetero,
                            dtype="float32").pad_lengths.tolist()
    if not any(length > n for length in hetero_pads):
        raise AssertionError(f"the padded real run did not pad: {hetero_pads}")
    del ref, upcast

    # A (2, N, N) real batch (launches double), execute_many of three host
    # signals, and irfft2(rfft2(x)) at the full width.
    n = N_BATCH
    batch = random_real(gen, 2, n, n)
    oracle = torch.fft.rfft2(batch)
    for cfg, expect in ((kernel, {"rfft_rows": 2, "fft_rows": 2}),
                        (fused, {"rfft_rows_transpose": 2, "fft_rows_transpose": 2})):
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

    # ---- the real path's single drive ends
    return end_drive("main_path_real", ("rfft_rows", "rfft_rows_transpose",
                                        "fft_rows", "fft_rows_transpose")), runs


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


def time_runs(runs: list[tuple], card: str) -> None:
    """Median time of each checked execute beside the library's 2-D FFT on
    the same signal (``torch.fft.fft2``, or ``torch.fft.rfft2`` for a real
    signal).  Runs after the launch counts were read."""
    library_ms: dict[int, float] = {}
    for label, plan, signal, delta in runs:
        real = not signal.is_complex()
        library = torch.fft.rfft2 if real else torch.fft.fft2
        if id(signal) not in library_ms:
            library_ms[id(signal)] = time_ms(lambda: library(signal), reps=5, warmup=1)
        key = "torch_rfft2_ms" if real else "torch_fft2_ms"
        log("main_path_time", card=card, run=label, method=plan.method,
            n=plan.n, batch=list(signal.shape[:-2]),
            config=plan.config.describe(), launches=delta,
            execute_ms=time_ms(lambda: plan.execute(signal), reps=5, warmup=1),
            **{key: library_ms[id(signal)]})


def main() -> None:
    torch.manual_seed(SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    card = phase_env()
    phase_build()
    records = phase_kernels(gen)
    fpms = phase_fpms()
    complex_counts, runs = phase_main_path(gen, fpms)
    real_counts, real_runs = phase_main_path_real(gen, fpms)
    planner_counts, planner_runs = phase_planner(gen, fpms, records, card)
    bench_counts = phase_microbench_fused(gen, card)
    for record in records:
        by_path = {"main_path": complex_counts[record["name"]],
                   "main_path_real": real_counts[record["name"]],
                   "planner": planner_counts[record["name"]],
                   "microbench_fused": bench_counts[record["name"]]}
        record["launches"] = sum(by_path.values())
        record["launches_by_path"] = by_path
    time_runs(runs + real_runs + planner_runs, card)
    log("done", seconds=round(time.perf_counter() - t0, 1),
        peak_memory_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
