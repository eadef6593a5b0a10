from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_ref"]
