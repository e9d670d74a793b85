"""2-D FFT convolution on the real-input half-spectrum pipeline, on the
PyTorch/CUDA port.

Convolution is the workload the real path was built for: images and
filters are real, so the circular convolution theorem needs only the
(N, N//2+1) half spectrum — half the row FFTs (two real rows packed per
complex transform) and half the spectral multiply, with ``irfft2``
folding the Hermitian half back to a real image.

``plan_pfft(method="rfft-lb", tune="estimate")`` is the planner doing
the choosing: the cost model prices the real pipeline against the
upcast-and-crop complex fallback and the plan routes on the winner
(``plan.tuning["chosen_path"]``).  The plan is built once and executed
for every image/kernel pair — fftw's plan/execute lifecycle.

Run on the GPU:  PYTHONPATH=src python examples/fft_convolution_torch.py
or on the host:  PYTHONPATH=src python examples/fft_convolution_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.convert import signal_to_tensor
from repro_torch.core import irfft2, plan_pfft


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=128, help="image size N (N x N)")
    parser.add_argument("--device", default=None,
                        help="torch device; default: the CUDA device")
    args = parser.parse_args()
    N = args.n

    rng = np.random.default_rng(0)
    image = signal_to_tensor(rng.standard_normal((N, N)).astype(np.float32),
                             args.device)
    device = image.device

    # A small blur kernel, zero-padded to N x N (circular convolution).
    kernel = np.zeros((N, N), np.float32)
    kernel[:3, :3] = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
    kernel /= kernel.sum()
    kernel = signal_to_tensor(kernel, device)

    plan = plan_pfft(N, p=1, method="rfft-lb", tune="estimate",
                     dtype="float32", device=device)
    print(f"planned config: {plan.config.describe()} "
          f"(chosen_path={plan.tuning['chosen_path']})")

    half_img = plan.execute(image)      # (N, N//2+1) — the Hermitian half
    half_ker = plan.execute(kernel)
    print(f"half spectrum: {tuple(half_img.shape)} vs full ({N}, {N}) — "
          f"{half_img.shape[-1] / N:.0%} of the columns")

    blurred = irfft2(half_img * half_ker, n=N)

    ref = torch.real(torch.fft.ifft2(torch.fft.fft2(image) * torch.fft.fft2(kernel)))
    err = float((blurred - ref).abs().max())
    print(f"fft-convolution vs full-complex reference: max_err={err:.2e}")
    assert err < 1e-4, "half-spectrum convolution must match the complex path"

    # The plan is reusable: a batch of images rides the same plan.
    batch = torch.stack([image, 2.0 * image])
    half_batch = plan.execute(batch)
    print(f"batched execute: {tuple(batch.shape)} -> {tuple(half_batch.shape)}")
    print("convolution theorem on the half spectrum: "
          "rfft2(a) * rfft2(b) -> irfft2 == a (*) b")


if __name__ == "__main__":
    main()
