"""Public wrapper for the fused Gram-projection kernel
(``csrc/gram_project.cu``).

Keeps the reference's contract (``src/repro/kernels/gram_project/
ops.py``): ``||(x^T x / n) v_k||_2`` per column without the ``(d, d)``
Gram, with ``n = max(n_valid, 1)`` and rows at or past ``n_valid``
already zero.  The kernel returns the unnormalised norms and the
division happens here.  Where the reference called its kernel once per
user of a tile, one launch covers the whole tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.gram_project.ref import gram_project_ref


def batched_gram_project(x: torch.Tensor, v: torch.Tensor,
                         n_valid=None) -> torch.Tensor:
    """``x (B, n, d)``, ``v (d, K)`` -> ``(B, K)`` fp32 with
    ``out[u, q] = ||x[u]^T (x[u] v[:, q])|| / max(n_valid[u], 1)``;
    ``n_valid=None`` divides by ``n``."""
    if x.ndim != 3 or v.ndim != 2 or v.shape[0] != x.shape[2]:
        raise ValueError(f"bad shapes x={tuple(x.shape)} v={tuple(v.shape)}")
    if not dispatch.on_cuda(x, v):
        return gram_project_ref(x, v, n_valid)
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the gram_project kernel takes float32, got "
                        f"{x.dtype} and {v.dtype}")
    n_users, n, d = x.shape
    k_cols = v.shape[1]
    x = x.contiguous()
    v = v.contiguous()
    out = torch.empty((n_users, k_cols), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = build.library()
    if lib.repro_gram_project_slab(d) == 0:
        raise ValueError(f"the gram_project kernel supports d <= 2048, "
                         f"got d={d}")
    with torch.cuda.device(x.device):
        rc = lib.repro_gram_project(x.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), n_users, n, d, k_cols,
                                    dispatch.stream_of(x))
    build.check(rc, "gram_project")
    dispatch.count_launch("gram_project")
    nv = n if n_valid is None else n_valid
    nv = torch.clamp_min(torch.as_tensor(nv, dtype=torch.float32,
                                         device=x.device), 1.0)
    return out / nv[..., None]


def gram_project(x: torch.Tensor, v: torch.Tensor, n_valid=None
                 ) -> torch.Tensor:
    """``x (n, d)``, ``v (d, K)`` -> ``||(x^T x / n) v_k||_2``, ``(K,)``."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    nv = None if n_valid is None else torch.as_tensor(
        n_valid, dtype=torch.float32).reshape(1)
    return batched_gram_project(x[None], v, nv)[0]
