"""Plain PyTorch version of the Gram kernel."""
from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """``x (..., n, d)`` -> ``x^T x (..., d, d)`` in fp32."""
    xf = x.to(torch.float32)
    return xf.transpose(-1, -2) @ xf
