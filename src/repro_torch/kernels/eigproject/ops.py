"""Public wrapper for the eigen-projection kernel (``csrc/eigproject.cu``).

``project_norms`` keeps the reference's single-pair contract
(``src/repro/kernels/eigproject/ops.py``); ``project_norms_all`` covers
every ``(i, j)`` pair in one launch, where the reference called its
kernel once per pair.  ``G_i V`` never goes to device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.eigproject.ref import project_norms_all_ref

_INT_MAX = 2**31 - 1


def project_norms_all(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g (NG, d, d)``, ``v (NV, d, k)`` -> ``(NG, NV, k)`` fp32 with
    ``out[i, j, c] = ||g[i] @ v[j][:, c]||_2``."""
    if g.ndim != 3 or v.ndim != 3 or g.shape[1] != g.shape[2] \
            or v.shape[1] != g.shape[1]:
        raise ValueError(f"bad shapes g={tuple(g.shape)} v={tuple(v.shape)}")
    if not dispatch.on_cuda(g, v):
        return project_norms_all_ref(g, v)
    if g.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the eigproject kernel takes float32, got "
                        f"{g.dtype} and {v.dtype}")
    n_g, d, _ = g.shape
    n_v, _, k = v.shape
    if n_v * k > _INT_MAX:
        raise ValueError(f"too many signature columns: {n_v} x {k}")
    g = g.contiguous()
    v = v.contiguous()
    out = torch.empty((n_g, n_v, k), device=g.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(g.device):
        rc = lib.repro_project_norms(g.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), n_g, n_v, d, k,
                                     dispatch.stream_of(g))
    build.check(rc, "eigproject")
    dispatch.count_launch("eigproject")
    return out


def project_norms(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``lamhat = ||G v_k||`` per column: ``g (d, d)``, ``v (d, k)`` ->
    ``(k,)``.  The all-pairs kernel with one user on each side."""
    if g.ndim != 2 or v.ndim != 2:
        raise ValueError(f"bad shapes g={tuple(g.shape)} v={tuple(v.shape)}")
    return project_norms_all(g[None], v[None])[0, 0]
