"""Public wrapper for the fused Gram-projection kernel
(``csrc/gram_project.cu``).

Keeps the reference's contract (``src/repro/kernels/gram_project/
ops.py``): ``||(x^T x / n) v_k||_2`` per column without the ``(d, d)``
Gram, with ``n = max(n_valid, 1)`` and rows at or past ``n_valid``
already zero.  The kernel returns the unnormalised norms and the
division happens here.  Where the reference called its kernel once per
user of a tile, one launch covers the whole tile.

The kernel runs both products on the TF32 tensor cores through the
3xTF32 split (``kernels/tf32.py`` is its plain version); ``project_plan``
picks its column-slab width and ring depth from ``d``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.gram_project.ref import gram_project_ref

#: Rows of X a tile, warps a block, and the padding of the depth d.
ROWS, WARPS, DEPTH_TILE = 16, 8, 128
#: Slab width -> the widest padded depth whose Q accumulators fit a
#: thread's registers: 4, 8, 12 or 16 m-tiles of 16 rows a warp, 8 warps.
MAX_DEPTH = {64: 4 * 128, 32: 8 * 128, 16: 12 * 128, 8: 16 * 128}
#: Shared memory one block may opt into on an H100.
MAX_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class ProjectPlan:
    """Column slab of one block and its ring at depth ``d``: ``bk``
    columns of V a block, ``stages`` X tiles in flight, ``d_pad`` the
    padded depth, ``smem`` its bytes."""
    bk: int
    stages: int
    d_pad: int
    smem: int


def smem_bytes(d: int, bk: int, stages: int) -> int:
    """Shared memory of a launch: V_slab ``[d_pad][bk]``, ``stages`` x X
    ``[ROWS][d_pad]`` and the partial P ``[WARPS][ROWS][bk]``, fp32; the
    kernel's ``smem_bytes`` computes the same."""
    d_pad = -(-d // DEPTH_TILE) * DEPTH_TILE
    return 4 * (d_pad * bk + stages * ROWS * d_pad + WARPS * ROWS * bk)


@functools.lru_cache(maxsize=256)
def project_plan(d: int) -> ProjectPlan:
    """The widest slab (64, 32, 16, 8) whose Q accumulators hold the
    padded depth and whose V_slab fits the shared memory, with two X tiles
    in flight where they fit and one where not.  Raises past d = 2048."""
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    d_pad = -(-d // DEPTH_TILE) * DEPTH_TILE
    for bk, max_depth in MAX_DEPTH.items():
        if d_pad > max_depth:
            continue
        for stages in (2, 1):
            smem = smem_bytes(d, bk, stages)
            if smem <= MAX_SMEM:
                return ProjectPlan(bk, stages, d_pad, smem)
    raise ValueError(f"the gram_project kernel supports d <= 2048, got d={d}")


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
    plan = project_plan(d)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_gram_project(x.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), n_users, n, d, k_cols,
                                    plan.bk, plan.stages,
                                    dispatch.stream_of(x))
    build.check(rc, "gram_project")
    dispatch.count_launch("gram_project", plan)
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
