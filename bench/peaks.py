"""The yardstick's table of peaks: one NVIDIA H100 SXM's published rates
(data sheet, dense, at its 700 W limit), and the least time they allow."""

from __future__ import annotations

import shutil
import subprocess

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FP32_FLOPS", "least_s", "power_limit"]

# HBM3 bandwidth, and the float32 rate outside the tensor cores (the port's
# FFT kernels compute in float32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def least_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take and what bounds it: the larger
    of the bytes moved once over the memory rate and the operations over
    the float32 rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = flops / PEAK_FP32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def power_limit() -> str:
    """``name, power.limit`` of the cards as ``nvidia-smi`` reads them, or
    what kept it from reading them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    done = subprocess.run([smi, "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30)
    return done.stdout.strip().replace("\n", "; ") or done.stderr.strip()
