"""Public wrapper for the eigen-projection kernel (``csrc/eigproject.cu``).

``project_norms`` keeps the reference's single-pair contract
(``src/repro/kernels/eigproject/ops.py``); ``project_norms_all`` covers
every ``(i, j)`` pair in one call, where the reference called its kernel
once per pair; ``project_norms_grouped`` covers the pairs inside each
group of a group axis in one call (the hierarchical protocol).  ``G_i V`` never goes to device memory.  The kernel runs
its products as 3xTF32 on the tensor cores; the wrapper gives it a
scratch buffer for the stacked signature matrix split once into TF32 hi
and lo (``ref.split_w_ref`` is its plain version), which the same call
fills first.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.eigproject.ref import (project_norms_all_ref,
                                                project_norms_grouped_ref,
                                                split_pitch)

_INT_MAX = 2**31 - 1
#: Rows of G_i a pass, stacked columns a block, depth a stage, stages.
ROWS, COLS, DEPTH, STAGES = 128, 128, 32, 3
#: A block's shared memory: STAGES stages of four 16 KB slabs (G, G lo,
#: W^T hi, W^T lo), the barriers, 32 sums of squares for each of the 256
#: consumer threads, and slack to align the base to 1024.
SMEM = STAGES * 4 * ROWS * DEPTH * 4 + 64 + 32 * 256 * 4 + 1024


@dataclasses.dataclass(frozen=True)
class EigPlan:
    """The kernel's layout for width ``d``: G's load ``route`` ("tma"
    where a row of G is a multiple of 16 bytes, else "cp.async4"), the
    row ``pitch`` of the split W^T (d rounded up to 4), and the block's
    ``smem``."""
    route: str
    pitch: int
    smem: int


@functools.lru_cache(maxsize=64)
def eig_plan(d: int) -> EigPlan:
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    return EigPlan("tma" if 4 * d % 16 == 0 else "cp.async4",
                   split_pitch(d), SMEM)


def kernel_plan(d: int) -> EigPlan:
    """The C side's plan for width ``d``, to hold ``eig_plan`` against
    (builds the kernel library)."""
    pitch, tma = ctypes.c_int(), ctypes.c_int()
    smem = build.library().repro_eigproject_plan(d, ctypes.byref(pitch),
                                                 ctypes.byref(tma))
    return EigPlan("tma" if tma.value else "cp.async4", pitch.value, smem)


def split_w(v: torch.Tensor) -> torch.Tensor:
    """The kernel's split ``W^T`` alone, ``(2, NV k, dp)`` fp32, on the
    card (columns past d unwritten); for tests against
    ``ref.split_w_ref``.  Not counted as a launch of the main path."""
    if v.ndim != 3 or not v.is_cuda or v.dtype != torch.float32:
        raise ValueError("split_w takes a float32 (NV, d, k) CUDA tensor")
    n_v, d, k = v.shape
    v = v.contiguous()
    wt = torch.zeros((2, n_v * k, split_pitch(d)), device=v.device,
                     dtype=torch.float32)
    with torch.cuda.device(v.device):
        rc = build.library().repro_eigproject_split(
            v.data_ptr(), wt.data_ptr(), n_v, d, k, dispatch.stream_of(v))
    build.check(rc, "eigproject split")
    return wt


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
    g = dispatch.aligned16(g)  # TMA reads from a 16-byte aligned base
    v = v.contiguous()
    out = torch.empty((n_g, n_v, k), device=g.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    wt = torch.empty((2, n_v * k, split_pitch(d)), device=g.device,
                     dtype=torch.float32)
    lib = build.library()
    with torch.cuda.device(g.device):
        rc = lib.repro_project_norms(g.data_ptr(), v.data_ptr(),
                                     wt.data_ptr(), out.data_ptr(), n_g,
                                     n_v, d, k, dispatch.stream_of(g))
    build.check(rc, "eigproject")
    dispatch.count_launch("eigproject")
    return out


def project_norms_grouped(g: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """The group axis: ``g (B, Ng, d, d)``, ``v (B, Ng, d, k)`` ->
    ``(B, Ng, Ng, k)`` fp32 with ``out[b, i, j, c] = ||g[b, i] @ v[b,
    j][:, c]||_2``.  One split of all ``B Ng k`` signature columns and one
    norms launch whose blocks each score one user against a column tile
    of its own group."""
    if g.ndim != 4 or v.ndim != 4 or g.shape[2] != g.shape[3] \
            or v.shape[:3] != g.shape[:3]:
        raise ValueError(f"bad shapes g={tuple(g.shape)} v={tuple(v.shape)}")
    if not dispatch.on_cuda(g, v):
        return project_norms_grouped_ref(g, v)
    if g.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the eigproject kernel takes float32, got "
                        f"{g.dtype} and {v.dtype}")
    b, ng, d, _ = g.shape
    k = v.shape[-1]
    if b * ng > _INT_MAX or b * ng * k > _INT_MAX:
        raise ValueError(f"too many signature columns: {b} x {ng} x {k}")
    g = dispatch.aligned16(g)
    v = v.contiguous()
    out = torch.empty((b, ng, ng, k), device=g.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    wt = torch.empty((2, b * ng * k, split_pitch(d)), device=g.device,
                     dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = build.library().repro_project_norms_grouped(
            g.data_ptr(), v.data_ptr(), wt.data_ptr(), out.data_ptr(), b,
            ng, d, k, dispatch.stream_of(g))
    build.check(rc, "eigproject (grouped)")
    dispatch.count_launch("eigproject")
    return out


def project_norms(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``lamhat = ||G v_k||`` per column: ``g (d, d)``, ``v (d, k)`` ->
    ``(k,)``.  The all-pairs kernel with one user on each side."""
    if g.ndim != 2 or v.ndim != 2:
        raise ValueError(f"bad shapes g={tuple(g.shape)} v={tuple(v.shape)}")
    return project_norms_all(g[None], v[None])[0, 0]
