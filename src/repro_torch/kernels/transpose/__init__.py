from repro_torch.kernels.transpose.kernel import transpose_cuda, transpose_plain
from repro_torch.kernels.transpose.ops import transpose_op
from repro_torch.kernels.transpose.ref import transpose_ref

__all__ = ["transpose_cuda", "transpose_op", "transpose_plain", "transpose_ref"]
