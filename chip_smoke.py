#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the ``src/repro_torch`` package beside
this file; it imports nothing of JAX and nothing of the JAX package.  Phases,
each of which ends the run with a non-zero exit code when it fails:

1. ``env``       versions, ``nvcc``, the card's name and power limit, SM count.
2. ``build``     compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. ``kernels``   every kernel against its plain PyTorch version on the card
                 (ragged row counts, odd and even log2 n, the full width), then
                 its time beside the plain version's, the library's and the
                 card's bound at the main path's shape.
4. ``main_path`` FPMs timed on the card, then ``plan_pfft(...).execute`` for
                 PFFT-LB / PFFT-FPM at N = 8192 and PFFT-FPM-PAD / PFFT-FPM-CZT
                 at N = 4096 under the library, kernel and fused configs, each
                 checked against its oracle, with the kernels' launch counts
                 showing which path ran.

Every line but the last is a log or a JSON record; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase passed.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: no CUDA device available; this script "
                     "measures on the card and does not run on the CPU\n")
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.core import (FPMSet, PlanConfig, SpeedFunction, build_fpm,  # noqa: E402
                              plan_pfft)
from repro_torch.fft import fft_rows  # noqa: E402
from repro_torch.kernels import (_build, fft_rows_op, fft_rows_transpose_op,  # noqa: E402
                                 launch_counts, reset_launch_counts)
from repro_torch.kernels.fft.kernel import fft_rows_plain  # noqa: E402
from repro_torch.kernels.fused.kernel import fft_rows_transpose_plain  # noqa: E402

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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(a)).all()):
        raise AssertionError("non-finite values in the result")
    return float((a - b).abs().max())


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
        tol = 1e-3 * math.sqrt(n)
        for radix in (2, 4):
            for inverse in (False, True):
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

    rows, n = MAIN_SHAPE
    x = random_signal(gen, rows, n)
    nbytes = 2 * rows * n * 8                     # read once, written once
    flops = 5.0 * rows * n * math.log2(n)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    bound = {"bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    records = []
    for name, source, replaces, kernel, plain, library in (
        ("fft_rows", "src/repro_torch/kernels/csrc/fft_rows.cu",
         "src/repro/kernels/fft/kernel.py:209",
         lambda: fft_rows_op(x, radix=4),
         lambda: fft_rows_plain(x, radix=4),
         lambda: torch.fft.fft(x)),
        ("fft_rows_transpose", "src/repro_torch/kernels/csrc/fft_rows_transpose.cu",
         "src/repro/kernels/fused/kernel.py:64",
         lambda: fft_rows_transpose_op(x, radix=4),
         lambda: fft_rows_transpose_plain(x, radix=4),
         lambda: torch.fft.fft(x).T.contiguous()),
    ):
        ms = time_ms(kernel, reps=20)
        record = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "launches": None,
                  "max_abs_err": worst[name], "ms": ms,
                  "plain_ms": time_ms(plain, reps=3, warmup=1),
                  **bound, "library_ms": time_ms(library, reps=20),
                  "shape": [rows, n], "bytes": nbytes, "flops": flops}
        record["max_err"] = record["max_abs_err"]
        record["kernel_ms"] = record["ms"]
        records.append(record)
    return records


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
            seg = mat[off:off + rows]
            if length > n:
                seg = torch.nn.functional.pad(seg, (0, length - n))
            parts.append(torch.fft.fft(seg, dim=-1)[:, :n])
            off += rows
        return torch.cat(parts, 0)

    return phase(phase(signal).T).T


def check_execute(plan, signal, oracle, label: str, expect: dict[str, int],
                  runs: list[tuple]) -> None:
    """One execute of ``plan``: right against ``oracle``, and through the
    kernels exactly as often as ``expect`` says (launch-count deltas)."""
    before = launch_counts()
    out = plan.execute(signal)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    tol = 2e-4 * plan.n
    err = max_abs_err(out, oracle)
    log("main_path", run=label, method=plan.method, n=plan.n,
        config=plan.config.describe(), d=plan.d.tolist(),
        pad_lengths=None if plan.pad_lengths is None else plan.pad_lengths.tolist(),
        schedule=plan.schedule.describe(), max_abs_err=err, atol=tol,
        launches=delta)
    if err > tol:
        raise AssertionError(f"{label}: max error {err} > {tol}")
    if delta != expect:
        raise AssertionError(f"{label}: launches {delta}, expected {expect}")
    runs.append((label, plan, signal, delta))


def phase_main_path(gen: torch.Generator) -> tuple[dict[str, int], list[tuple]]:
    """Drive the main path once, with the launch counts set to 0 just before
    and read just after.  Returns the counts and the checked runs (for the
    timing pass, which is not part of the counted drive)."""
    library = PlanConfig()
    kernel = PlanConfig(radix=4)
    fused = PlanConfig(fused=True)
    none = {"fft_rows": 0, "fft_rows_transpose": 0}
    runs: list[tuple] = []

    fpms = {}
    for n in (N_UNPADDED, N_PADDED):
        t0 = time.perf_counter()
        fpms[n] = measured_fpms(n)
        homo = fpms[n][0]
        log("main_path", step="fpm", n=n, seconds=round(time.perf_counter() - t0, 2),
            xs=homo[0].xs.tolist(), ys=homo[0].ys.tolist(),
            gflops=np.round(homo[0].speed / 1e9, 1).tolist())

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

    counts = launch_counts()       # ---- the main path's single drive ends
    for name, count in counts.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")
    return counts, runs


def time_runs(runs: list[tuple], card: str) -> None:
    """Median time of each checked execute beside ``torch.fft.fft2``'s on the
    same signal.  Runs after the launch counts were read."""
    fft2_ms: dict[int, float] = {}
    for label, plan, signal, delta in runs:
        if id(signal) not in fft2_ms:
            fft2_ms[id(signal)] = time_ms(lambda: torch.fft.fft2(signal),
                                          reps=5, warmup=1)
        log("main_path_time", card=card, run=label, method=plan.method,
            n=plan.n, batch=list(signal.shape[:-2]),
            config=plan.config.describe(), launches=delta,
            execute_ms=time_ms(lambda: plan.execute(signal), reps=5, warmup=1),
            torch_fft2_ms=fft2_ms[id(signal)])


def main() -> None:
    torch.manual_seed(SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    card = phase_env()
    phase_build()
    records = phase_kernels(gen)
    counts, runs = phase_main_path(gen)
    for record in records:
        record["launches"] = counts[record["name"]]
    time_runs(runs, card)
    log("done", seconds=round(time.perf_counter() - t0, 1),
        peak_memory_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
