"""PyTorch + CUDA port of ``repro``: the paper's model-based parallel 2-D DFT
(PFFT-LB / PFFT-FPM / PFFT-FPM-PAD) on an NVIDIA GPU.

Same sub-package layout as the JAX package, which stays the reference:
``kernels/`` (hand-written CUDA kernels and their plain versions), ``fft/``,
``core/`` (FPMs, partitioning, padding, the PFFT methods, the plan API),
``plan/`` (configs, schedules, pad lengths).  Entry points run on the CUDA
device unless the caller passes ``device="cpu"`` or CPU tensors.
"""
