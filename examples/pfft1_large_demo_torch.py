"""One enormous 1-D FFT via 2-D decomposition — the EFFT four-step, on the
PyTorch/CUDA port.

A length-N transform that dwarfs any single kernel's sweet spot factors
as N = n1 * n2 and becomes a 2-D problem the rest of this package already
solves: n1 row FFTs of length n2, a twiddle multiply, n2 row FFTs of
length n1, plus transposes.  Both row-FFT phases run through the same
dispatch-group machinery as ``pfft2``, so every backend the planner can
pick is available at each factor's own length — and ``plan_pfft1_large``
gives the whole thing the fftw lifecycle: tune once, persist the winner in
wisdom, serve every later plan from disk with zero re-measurement.

Run on the GPU:  PYTHONPATH=src python examples/pfft1_large_demo_torch.py
or on the host:  PYTHONPATH=src python examples/pfft1_large_demo_torch.py --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.convert import signal_to_tensor
from repro_torch.core import four_step_factors, pfft1_large, plan_pfft1_large


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device; default: the CUDA device")
    args = parser.parse_args()

    N = 4096 * 9        # 36864 = 192 * 192: far past one kernel's sweet spot

    n1, n2 = four_step_factors(N)
    print(f"four-step factorization: N={N} -> {n1} x {n2} "
          f"(row FFTs at lengths {n2} and {n1} instead of one at {N})")

    rng = np.random.default_rng(0)
    x = signal_to_tensor((rng.standard_normal(N)
                          + 1j * rng.standard_normal(N)).astype(np.complex64),
                         args.device)
    device = x.device

    # One-shot convenience entry point (plan built and executed inline).
    out = pfft1_large(x)
    ref = torch.fft.fft(x)
    err = float((out - ref).abs().max() / ref.abs().max())
    print(f"pfft1_large vs torch.fft.fft: rel_err={err:.2e}")
    assert err < 1e-4

    # The planner lifecycle: measure once, then every later plan is served
    # from the wisdom store without re-measuring.
    wis = os.path.join(tempfile.mkdtemp(), "wisdom.json")
    p1 = plan_pfft1_large(N, tune="measure", wisdom=wis, device=device)
    print(f"measured plan: {p1.config.describe()} "
          f"(source={p1.tuning['source']}, n1={p1.n1}, n2={p1.n2})")
    p2 = plan_pfft1_large(N, tune="measure", wisdom=wis, device=device)
    assert p2.tuning["source"] == "wisdom" and "measured" not in p2.tuning
    print(f"second plan served from wisdom, zero re-measurement "
          f"(key {p2.tuning['wisdom_key']})")

    out2 = p2.execute(x)
    err2 = float((out2 - ref).abs().max() / ref.abs().max())
    print(f"wisdom-served plan executes identically: rel_err={err2:.2e}")
    assert err2 < 1e-4

    # Pinning one factor re-plans the decomposition (a pow2 n1 lets a radix
    # kernel take that phase); prime N degenerates to n1=1, still correct.
    p3 = plan_pfft1_large(N, n1=256, device=device)
    print(f"pinned factors: n1={p3.n1}, n2={p3.n2} "
          f"({p3.tuning['wisdom_key']})")
    print("four-step pattern: reshape -> row FFTs(n2) -> twiddle "
          "-> row FFTs(n1) -> transpose read-out")


if __name__ == "__main__":
    main()
