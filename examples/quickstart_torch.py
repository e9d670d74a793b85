"""Quickstart on the PyTorch/CUDA port: the paper's method in a page.

1. Build functional performance models (FPMs) for p abstract processors by
   timing row-FFT batches on the device at a grid of problem sizes.
2. PARTITION the rows (POPTA/HPOPTA choose automatically per the epsilon
   tolerance test).
3. Plan PFFT-LB / PFFT-FPM / PFFT-FPM-CZT / PFFT-FPM-PAD with the
   model-driven tuner (``tune="estimate"``: the cost model ranks the library
   FFT, the hand-written CUDA row-FFT kernel ``radix=4`` and the fused
   FFT->transpose kernel ``fused=True``) and execute them against
   ``torch.fft.fft2``.

Run on the GPU (builds the kernels with nvcc at first use):

    PYTHONPATH=src python examples/quickstart_torch.py

or on the host, where the kernels' plain PyTorch versions run instead:

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 256
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.convert import signal_to_tensor
from repro_torch.core import FPMSet, PlanConfig, build_fpm, plan_pfft
from repro_torch.fft import fft_rows
from repro_torch.kernels import launch_counts

P = 4


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=2048, help="signal size N (N x N)")
    parser.add_argument("--device", default=None,
                        help="torch device; default: the CUDA device")
    args = parser.parse_args()
    n = args.n

    rng = np.random.default_rng(0)
    host = (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    signal = signal_to_tensor(host, args.device)   # raises without a GPU
    device = signal.device

    def wait() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # -- 1. measure speed functions -----------------------------------------
    def timer(x: int, y: int) -> float:
        m = torch.ones((x, y), dtype=torch.complex64, device=device)
        fft_rows(m)                                  # warm-up
        wait()
        t0 = time.perf_counter()
        for _ in range(3):
            fft_rows(m)
        wait()
        return (time.perf_counter() - t0) / 3

    xs = sorted({n // 8, n // 4, n // 2, n})
    ys = sorted({n // 2, n, 9 * n // 8, 5 * n // 4, 3 * n // 2, 2 * n})
    fpms = FPMSet([build_fpm(xs, ys, timer, name=f"P{i}") for i in range(P)])

    # -- 2+3. plan & execute -------------------------------------------------
    oracle = torch.fft.fft2(signal)
    for method in ("lb", "fpm", "fpm-czt"):
        plan = plan_pfft(n, p=P, fpms=fpms, method=method, tune="estimate",
                         device=device)
        err = float((plan.execute(signal) - oracle).abs().max())
        print(f"method={method:8s} d={plan.d} config=[{plan.config.describe()}] "
              f"(chosen: {plan.tuning['source']}) max_err={err:.2e}")

    plan = plan_pfft(n, fpms=fpms, method="fpm-pad", tune="estimate",
                     device=device)
    plan.execute(signal)
    print(f"method=fpm-pad  d={plan.d} pad_lengths={plan.pad_lengths} "
          f"config=[{plan.config.describe()}] (padded-signal DFT semantics)")
    print("plan.tuning['source']:", plan.tuning["source"])

    # An explicit config skips the tuner: the fused FFT->transpose kernel.
    plan = plan_pfft(n, p=P, method="lb", config=PlanConfig(fused=True),
                     device=device)
    err = float((plan.execute(signal) - oracle).abs().max())
    print(f"method=lb       config=[{plan.config.describe()}] "
          f"(chosen: {plan.tuning['source']}) max_err={err:.2e}")

    # Batched execute: leading batch dims are transformed one by one.
    batch = torch.stack([signal, signal.flip(0)])
    print("batched execute:", tuple(plan.execute(batch).shape))
    print("kernel launches:", launch_counts(), "on", device)


if __name__ == "__main__":
    main()
