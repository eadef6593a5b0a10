"""Plain PyTorch versions of the Gram kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import matmul_3xtf32


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """``x (..., n, d)`` -> ``x^T x (..., d, d)`` in fp32."""
    xf = x.to(torch.float32)
    return xf.transpose(-1, -2) @ xf


def gram_3xtf32(x: torch.Tensor) -> torch.Tensor:
    """``x^T x`` in the kernel's arithmetic: the 3xTF32 product
    (``kernels/tf32.py``), its upper triangle mirrored below the diagonal,
    so the result is symmetric bit for bit (summation order aside)."""
    xf = x.to(torch.float32)
    g = matmul_3xtf32(xf.transpose(-1, -2), xf)
    return torch.triu(g) + torch.triu(g, 1).transpose(-1, -2)
