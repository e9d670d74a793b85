"""Device resolution: the port runs on the card unless the caller asks
otherwise.

``resolve_device(None)`` is ``cuda`` and raises when there is no CUDA device;
nothing in the package carries on on the CPU by itself.  Functions that take
tensors take their device from the tensor; ``as_tensor`` applies the default
only to input that is not yet a tensor (numpy arrays, lists).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "complex_result_type"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raising without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (or CPU tensors) to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_tensor(x, device: str | torch.device | None = None) -> torch.Tensor:
    """A tensor stays where it is (or moves to an explicit ``device``); any
    other input is copied to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def complex_result_type(x: torch.Tensor) -> torch.dtype:
    """The complex type a transform of ``x`` returns: at least complex64."""
    return torch.promote_types(x.dtype, torch.complex64)
