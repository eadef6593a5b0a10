"""Plain PyTorch version of the flash attention kernels.

The reference's oracle (``src/repro/kernels/flash_attention/ref.py``) on
the port's ``(B, S, H, hd)`` layout: fp32 logits scaled by ``hd^-0.5``,
masked to -1e30, softmax in fp32, ``p @ v`` in fp32, cast back to the
input dtype.  A row that sees no key at all (impossible in causal self-
attention with ``S <= Skv``) averages V here and is zero in the kernels,
as in the reference's pair of functions.

``p_rounding`` names how p enters ``p @ v``: ``"fp32"`` (the function);
``"hi_lo"``, p split into ``bf16(p)`` and ``bf16(p - bf16(p))`` and both
parts multiplied, as the tensor-core kernel does (``split_bf16``); or
``"bf16"``, p rounded to bf16 once, another function, which the card's
checks must be able to tell from the first two.
"""
from __future__ import annotations

import torch

P_ROUNDINGS = ("fp32", "hi_lo", "bf16")


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


def split_bf16(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``p`` -> ``(hi, lo)`` in fp32, each a bf16 value: ``hi =
    bf16(p)``, ``lo = bf16(p - hi)``; ``hi + lo`` is within about 2^-17
    of ``p``, relative."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi, lo


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, *,
              p_rounding: str = "fp32") -> torch.Tensor:
    """``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` -> ``(B, S, H, hd)``."""
    if p_rounding not in P_ROUNDINGS:
        raise ValueError(f"p_rounding must be one of {P_ROUNDINGS}, got "
                         f"{p_rounding!r}")
    s, skv = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    mask = structural_mask(s, skv, causal, window, q.device)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    vf = v.float()
    if p_rounding == "hi_lo":
        hi, lo = split_bf16(probs)
        out = (torch.einsum("bhst,bthd->bshd", hi, vf)
               + torch.einsum("bhst,bthd->bshd", lo, vf))
    else:
        if p_rounding == "bf16":
            probs = probs.to(torch.bfloat16).float()
        out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)
