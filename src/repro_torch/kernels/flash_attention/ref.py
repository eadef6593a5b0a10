"""Plain PyTorch version of the flash attention kernel.

The reference's oracle (``src/repro/kernels/flash_attention/ref.py``) on
the port's ``(B, S, H, hd)`` layout: fp32 logits scaled by ``hd^-0.5``,
masked to -1e30, softmax in fp32, ``p @ v`` in fp32, cast back to the
input dtype.  A row that sees no key at all (impossible in causal self-
attention with ``S <= Skv``) averages V here and is zero in the kernel,
as in the reference's pair of functions.
"""
from __future__ import annotations

import torch


def structural_mask(s: int, skv: int, causal: bool, window: int,
                    device=None) -> torch.Tensor:
    """``(S, Skv)`` bool: key ``j`` visible from query ``i``."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    return mask


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` -> ``(B, S, H, hd)``."""
    s, skv = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    mask = structural_mask(s, skv, causal, window, q.device)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v.float()).to(q.dtype)
