"""Plain PyTorch version of the fused featurize -> Gram kernel."""
from __future__ import annotations

import torch


def featurize_gram_ref(x: torch.Tensor, w: torch.Tensor | None = None,
                       compute_dtype: str = "fp32") -> torch.Tensor:
    """``x (..., n, m)``, ``w (m, d)`` -> ``(x w)^T (x w)  (..., d, d)``
    fp32, unnormalised; ``w=None`` gives the plain Gram ``x^T x``.

    ``compute_dtype="bf16"`` rounds ``x`` and ``w`` to bf16, sums the
    projection in fp32, rounds ``F = x w`` to bf16, and sums the Gram in
    fp32: the reference kernel's mixed precision.  Products of bf16
    values are exact in fp32, so fp32 matmuls of the rounded values
    compute the same function.
    """
    bf16 = compute_dtype == "bf16"

    def cast(a):
        a = a.to(torch.float32)
        return a.to(torch.bfloat16).to(torch.float32) if bf16 else a

    f = cast(x)
    if w is not None:
        f = f @ cast(w)
        if bf16:
            f = f.to(torch.bfloat16).to(torch.float32)
    return f.transpose(-1, -2) @ f
