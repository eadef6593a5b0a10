"""Public wrapper for the Gram kernel (``csrc/gram.cu``).

Keeps the reference's contract (``src/repro/kernels/gram/ops.py``):
``x^T x`` in fp32, unnormalised; the caller divides by ``n_valid``.
The user batch is a grid axis of the kernel, so a whole ``(N, n, d)``
stack is one launch.  Ragged edges are masked inside the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.gram.ref import gram_ref


def batched_gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``x (N, n, d)`` -> ``x[u]^T x[u]`` stacked, ``(N, d, d)`` fp32."""
    if x.ndim != 3:
        raise ValueError(f"x must be (N, n, d), got shape {tuple(x.shape)}")
    if not dispatch.on_cuda(x):
        return gram_ref(x)
    if x.dtype != torch.float32:
        raise TypeError(f"the gram kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    n_users, n, d = x.shape
    out = torch.empty((n_users, d, d), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_gram(x.data_ptr(), out.data_ptr(), n_users, n, d,
                            dispatch.stream_of(x))
    build.check(rc, "gram")
    dispatch.count_launch("gram")
    return out


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``x (n, d)`` -> ``x^T x (d, d)`` fp32 (one user)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    return batched_gram_matrix(x[None])[0]
