"""Plain PyTorch versions of the eigen-projection kernel.

``project_norms_all_ref`` is the function in fp32, and
``project_norms_grouped_ref`` the same on each group of a group axis.  ``split_w_ref`` is
the kernel's first step, the stacked signature matrix ``W = [V_0 | V_1 |
...]`` split once into TF32 hi and lo and laid out as the products read
it; ``project_norms_all_tf32`` is the kernel's arithmetic (3xTF32, or
``products=1``, ``hi hi`` alone, the negative control), which no main
path calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import matmul_1xtf32, matmul_3xtf32, split_tf32

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


def project_norms_grouped_ref(g: torch.Tensor, v: torch.Tensor
                              ) -> torch.Tensor:
    """The group axis: ``g (B, Ng, d, d)``, ``v (B, Ng, d, k)`` ->
    ``(B, Ng, Ng, k)``, ``project_norms_all_ref`` on each group."""
    b, ng = g.shape[:2]
    out = torch.empty((b, ng, v.shape[1], v.shape[-1]), device=g.device,
                      dtype=torch.float32)
    for i in range(b):
        out[i] = project_norms_all_ref(g[i], v[i])
    return out


def stacked_w(v: torch.Tensor) -> torch.Tensor:
    """``v (NV, d, k)`` -> ``W (d, NV k)``, column ``j k + c`` = ``v[j][:, c]``."""
    n_v, d, k = v.shape
    return v.to(torch.float32).permute(1, 0, 2).reshape(d, n_v * k)


def split_pitch(d: int) -> int:
    """Row pitch of the split ``W^T``: ``d`` rounded up to 4 floats."""
    return -(-d // 4) * 4


def split_w_ref(v: torch.Tensor) -> torch.Tensor:
    """The kernel's split ``W^T``: ``(2, NV k, dp)`` fp32, ``[0]`` the TF32
    hi and ``[1]`` the lo of ``W^T``, rows ``dp = split_pitch(d)`` apart
    (d contiguous, K-major); columns past ``d`` are 0 here and never read
    by the kernel."""
    n_v, d, k = v.shape
    hi, lo = split_tf32(stacked_w(v).t())
    out = torch.zeros((2, n_v * k, split_pitch(d)), device=v.device,
                      dtype=torch.float32)
    out[0, :, :d] = hi
    out[1, :, :d] = lo
    return out


def project_norms_all_tf32(g: torch.Tensor, v: torch.Tensor,
                           products: int = 3) -> torch.Tensor:
    """``project_norms_all`` with ``G_i W`` as the kernel computes it:
    3xTF32 (``products=3``, lo hi + hi lo + hi hi) or one TF32 product
    (``products=1``, the negative control); on a card TF32 matmul must be
    off (``kernels/tf32.py``)."""
    if products not in (1, 3):
        raise ValueError(f"products must be 1 or 3, got {products}")
    g = g.to(torch.float32)
    n_g, d, _ = g.shape
    n_v, _, k = v.shape
    matmul = matmul_3xtf32 if products == 3 else matmul_1xtf32
    w = stacked_w(v)
    step = max(1, CHUNK_BYTES // max(1, 4 * n_v * k * d))
    out = torch.empty((n_g, n_v * k), device=g.device, dtype=torch.float32)
    for s in range(0, n_g, step):
        proj = matmul(g[s:s + step], w)                 # (c, d, NV k)
        out[s:s + step] = torch.sqrt(torch.sum(proj * proj, dim=-2))
    return out.view(n_g, n_v, k)
