"""Plain PyTorch version of the eigen-projection kernel."""
from __future__ import annotations

import torch

#: Bytes of ``G_i V`` products the all-pairs version holds at once.  The
#: whole ``(N, N, d, k)`` product is 16 GiB at N=1024, d=512, k=8.
CHUNK_BYTES = 256 * 2**20


def project_norms_ref(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g (d, d)``, ``v (d, k)`` -> ``||g @ v||_2`` per column, ``(k,)``."""
    proj = g.to(torch.float32) @ v.to(torch.float32)
    return torch.sqrt(torch.sum(proj * proj, dim=0))


def project_norms_all_ref(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g (NG, d, d)``, ``v (NV, d, k)`` -> ``(NG, NV, k)`` with
    ``out[i, j, c] = ||g[i] @ v[j][:, c]||_2``, chunked over ``i``."""
    g = g.to(torch.float32)
    v = v.to(torch.float32)
    n_g, d, _ = g.shape
    n_v, _, k = v.shape
    step = max(1, CHUNK_BYTES // max(1, 4 * n_v * d * k))
    out = torch.empty((n_g, n_v, k), device=g.device, dtype=torch.float32)
    for s in range(0, n_g, step):
        proj = g[s:s + step, None] @ v[None]          # (c, NV, d, k)
        out[s:s + step] = torch.sqrt(torch.sum(proj * proj, dim=-2))
    return out
