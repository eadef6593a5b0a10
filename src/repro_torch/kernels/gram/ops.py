"""Public wrapper for the Gram kernel (``csrc/gram.cu``).

Keeps the reference's contract (``src/repro/kernels/gram/ops.py``):
``x^T x`` in fp32, unnormalised.  ``n_valid`` asks for the per-user
divisor ``max(n_valid, 1)`` in the kernel's epilogue, which gives the bits
of the division after it.  The user batch and the upper triangle of
128 x 128 output tiles (``gram_plan``) are the kernel's grid, so a whole
``(N, n, d)`` stack is one launch; ragged edges are zero-filled inside
the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.gram.ref import gram_ref

#: Output tile edge, and rows of X a stage.
TILE, STAGE_ROWS = 128, 32
#: A block's shared memory: two split stages (A and B hi and lo, 64 KB
#: each), two raw stages (two 16 KB slabs each), the barriers, and slack
#: to align the base to 1024 bytes.
SMEM = 2 * 4 * STAGE_ROWS * TILE * 4 + 2 * 2 * STAGE_ROWS * TILE * 4 \
    + 64 + 1024


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """The kernel's grid for width ``d``: ``tiles`` output tiles of
    ``tile`` a side; ``pairs``, the upper triangle's ``(I, J)``, ``I <= J``,
    in block order; the load ``route`` ("tma" where a row of X is a
    multiple of 16 bytes, else "cp.async4"); and the block's ``smem``."""
    tile: int
    tiles: int
    pairs: tuple[tuple[int, int], ...]
    route: str
    smem: int


@functools.lru_cache(maxsize=64)
def gram_plan(d: int) -> GramPlan:
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    tiles = -(-d // TILE)
    pairs = tuple((i, j) for i in range(tiles) for j in range(i, tiles))
    route = "tma" if 4 * d % 16 == 0 else "cp.async4"
    return GramPlan(TILE, tiles, pairs, route, SMEM)


def kernel_plan(d: int) -> tuple[int, int, str]:
    """The C side's ``(smem, pairs, route)`` for width ``d``, to hold
    ``gram_plan`` against (builds the kernel library)."""
    pairs, tma = ctypes.c_int(), ctypes.c_int()
    smem = build.library().repro_gram_plan(d, ctypes.byref(pairs),
                                           ctypes.byref(tma))
    return smem, pairs.value, "tma" if tma.value else "cp.async4"


def batched_gram_matrix(x: torch.Tensor, n_valid: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """``x (N, n, d)`` -> ``x[u]^T x[u]`` stacked, ``(N, d, d)`` fp32,
    divided by ``max(n_valid[u], 1)`` where ``n_valid (N,)`` is given."""
    if x.ndim != 3:
        raise ValueError(f"x must be (N, n, d), got shape {tuple(x.shape)}")
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid).to(device=x.device,
                                              dtype=torch.float32)
        if n_valid.shape != (x.shape[0],):
            raise ValueError(f"n_valid must be ({x.shape[0]},), got "
                             f"{tuple(n_valid.shape)}")
    if not dispatch.on_cuda(x):
        g = gram_ref(x)
        if n_valid is None:
            return g
        return g / torch.clamp_min(n_valid, 1.0)[:, None, None]
    if x.dtype != torch.float32:
        raise TypeError(f"the gram kernel takes float32, got {x.dtype}")
    x = dispatch.aligned16(x)  # TMA reads from a 16-byte aligned base
    n_users, n, d = x.shape
    out = torch.empty((n_users, d, d), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    nv = None if n_valid is None else n_valid.contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_gram(x.data_ptr(), out.data_ptr(),
                            None if nv is None else nv.data_ptr(), n_users,
                            n, d, dispatch.stream_of(x))
    build.check(rc, "gram")
    dispatch.count_launch("gram")
    return out


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``x (n, d)`` -> ``x^T x (d, d)`` fp32 (one user)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    return batched_gram_matrix(x[None])[0]
