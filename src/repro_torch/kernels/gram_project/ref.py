"""Plain PyTorch version of the fused Gram-projection kernel.

``||G v_k||`` with ``G = (1/n) X^T X``, computed without forming ``G``:
``G v = (1/n) X^T (X v)``, two skinny products.
"""
from __future__ import annotations

import torch

#: Bytes of ``X V`` and ``X^T (X V)`` products the batched version holds
#: at once (the whole pair is 26 GiB at B=1024, n=256, d=512, K=8192).
CHUNK_BYTES = 256 * 2**20


def gram_project_ref(x: torch.Tensor, v: torch.Tensor,
                     n_valid=None) -> torch.Tensor:
    """``x (..., n, d)``, ``v (d, K)`` -> ``||(x^T x / n) v_k||_2``,
    ``(..., K)``.  ``n_valid`` (scalar or one count per leading index)
    replaces the padded row count; rows at or past it must be zero."""
    x = x.to(torch.float32)
    v = v.to(torch.float32)
    n = x.shape[-2] if n_valid is None else n_valid
    n = torch.clamp_min(torch.as_tensor(n, dtype=torch.float32,
                                        device=x.device), 1.0)
    lead = x.shape[:-2]
    xb = x.reshape(lead.numel(), *x.shape[-2:])
    n_rows, d = xb.shape[1:]
    per_user = 4 * v.shape[1] * (n_rows + d)
    step = max(1, CHUNK_BYTES // max(1, per_user))
    out = torch.empty((xb.shape[0], v.shape[1]), device=x.device,
                      dtype=torch.float32)
    for s in range(0, xb.shape[0], step):
        xs = xb[s:s + step]
        q = xs.transpose(-1, -2) @ (xs @ v)            # (c, d, K)
        out[s:s + step] = torch.sqrt(torch.sum(q * q, dim=-2))
    return out.reshape(*lead, v.shape[1]) / n[..., None]
