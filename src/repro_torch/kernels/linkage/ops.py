"""Public wrappers for the linkage kernels (``csrc/linkage.cu``).

``linkage_step`` keeps the reference's one-step contract
(``src/repro/kernels/linkage/ops.py``).  ``nn_chain`` runs the whole
NN-chain loop of ``core/cluster_engine.py`` in one call: a first pass
that caches every row's nearest neighbour, then one persistent block for
the chain (``ref.nn_chain_cached_ref`` is the plain model of its cache).
The reference ran its step kernel inside a jitted ``while_loop``; a host
loop here would pay a launch and a round trip for each of about 3n steps.
``nn_chain_grouped`` runs B independent chains in one call, one block a
group (the hierarchical protocol's group stage, which the reference
vmaps).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.linkage.ref import (LINKAGES, linkage_step_ref,
                                             max_iterations,
                                             nn_chain_grouped_ref,
                                             nn_chain_ref)

#: Shared memory a block may use on the H100 (opt-in maximum), less the
#: chain kernel's reserve for its static arrays.
SMEM_LIMIT = 232448 - 1024


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Where the chain kernel keeps its per-leaf state for ``n`` leaves
    (the nearest-neighbour cache, sizes, chain, rescan list and alive
    flags, ``scratch`` bytes of device scratch, which the first pass
    fills): ``route`` "smem" (copied into ``smem`` bytes of shared
    memory) where it fits, else "scratch" (read in place, ``smem`` 0)."""
    route: str
    smem: int
    scratch: int


def chain_plan(n: int) -> ChainPlan:
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    scratch = 4 * (5 * n + 1) + -(-n // 16) * 16
    if scratch <= SMEM_LIMIT:
        return ChainPlan("smem", scratch, scratch)
    return ChainPlan("scratch", 0, scratch)


def kernel_chain_plan(n: int) -> ChainPlan:
    """The C side's plan for ``n`` leaves, to hold ``chain_plan`` against
    (builds the kernel library)."""
    route, scratch = ctypes.c_int(), ctypes.c_int64()
    smem = build.library().repro_nn_chain_plan(n, ctypes.byref(route),
                                               ctypes.byref(scratch))
    return ChainPlan("smem" if route.value else "scratch", smem,
                     scratch.value)


def _linkage_code(linkage: str) -> int:
    if linkage not in LINKAGES:
        raise ValueError(f"linkage must be one of {LINKAGES}, "
                         f"got {linkage!r}")
    return LINKAGES.index(linkage)


def linkage_step(row_a: torch.Tensor, row_b: torch.Tensor, size_a, size_b,
                 mask: torch.Tensor, linkage: str = "average"
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Lance-Williams update + masked argmax of one linkage row.

    ``row_a``/``row_b`` ``(n,)`` f32, ``mask (n,)`` bool or float (kept
    where > 0.5), sizes as scalars.  Returns ``(new_row (n,), argmax
    i32, max f32)``, the contract of ``linkage_step_ref``.
    """
    code = _linkage_code(linkage)
    if row_a.ndim != 1 or row_a.shape != row_b.shape \
            or row_a.shape != mask.shape:
        raise ValueError(f"rows and mask must be (n,)-shaped alike, got "
                         f"{tuple(row_a.shape)}, {tuple(row_b.shape)}, "
                         f"{tuple(mask.shape)}")
    if not dispatch.on_cuda(row_a, row_b, mask):
        return linkage_step_ref(row_a, row_b, size_a, size_b, mask, linkage)
    if row_a.dtype != torch.float32 or row_b.dtype != torch.float32:
        raise TypeError("the linkage kernel takes float32 rows")
    n = row_a.shape[0]
    row_a = row_a.contiguous()
    row_b = row_b.contiguous()
    keep = mask.to(torch.float32).contiguous()
    row = torch.empty_like(row_a)
    idx = torch.empty((1,), dtype=torch.int32, device=row_a.device)
    val = torch.empty((1,), dtype=torch.float32, device=row_a.device)
    lib = build.library()
    with torch.cuda.device(row_a.device):
        rc = lib.repro_linkage_step(
            row_a.data_ptr(), row_b.data_ptr(), float(size_a), float(size_b),
            keep.data_ptr(), row.data_ptr(), idx.data_ptr(), val.data_ptr(),
            n, code, dispatch.stream_of(row_a))
    build.check(rc, "linkage_step")
    dispatch.count_launch("linkage_step")
    return row, idx[0], val[0]


def _chain_input(s: torch.Tensor, linkage: str, ndim: int = 2) -> int:
    """The linkage's code; raises unless ``s`` is a square matrix
    (``ndim`` 2) or a stack of them (``ndim`` 3)."""
    code = _linkage_code(linkage)
    if s.ndim != ndim or s.shape[-1] != s.shape[-2]:
        raise ValueError(f"linkage matrix must be square, got "
                         f"{tuple(s.shape)}")
    return code


def _run_chains(s: torch.Tensor, code: int, batch: int, n: int):
    """The chain kernel on ``batch`` prepared ``(n, n)`` matrices laid out
    one after another in the CUDA tensor ``s``, one block a matrix ->
    ``(merges (batch, n-1, 2), heights (batch, n-1), counters (batch,
    3))``."""
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise TypeError("the nn_chain kernel updates a contiguous float32 "
                        "matrix in place")
    dev = s.device
    merges = torch.zeros((batch, max(n - 1, 0), 2), dtype=torch.int32,
                         device=dev)
    heights = torch.zeros((batch, max(n - 1, 0)), dtype=torch.float32,
                          device=dev)
    counters = torch.zeros((batch, 3), dtype=torch.int32, device=dev)
    if n < 2 or batch == 0:
        return merges, heights, counters
    plan = chain_plan(n)
    scratch = torch.empty((batch * plan.scratch,), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        rc = build.library().repro_nn_chain(
            s.data_ptr(), batch, n, code, max_iterations(n),
            merges.data_ptr(), heights.data_ptr(), counters.data_ptr(),
            scratch.data_ptr(), dispatch.stream_of(s))
    build.check(rc, "nn_chain")
    dispatch.count_launch("linkage", plan)
    return merges, heights, counters


def nn_chain(s: torch.Tensor, linkage: str = "average"
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NN-chain HAC over a prepared linkage matrix ``s (n, n)`` f32 with
    the diagonal at ``-inf``.  ``s`` is overwritten: pass a copy.  On the
    card the kernel writes merged rows and columns at live entries only,
    so ``s`` afterwards is not the plain loop's (which sets dead rows and
    columns to ``-inf``); nothing reads it after the call.

    Returns ``(merge_rows (n-1, 2) i32, heights (n-1,) f32, steps)`` in
    chain order; ``steps`` (0-dim int32, on ``s``'s device) counts the
    merges done and falls short of ``n - 1`` only on NaN input.
    """
    _chain_input(s, linkage)
    if not dispatch.on_cuda(s):
        return nn_chain_ref(s, linkage)
    merges, heights, counters = _nn_chain_counted(s, linkage)
    return merges, heights, counters[0]


def _nn_chain_counted(s: torch.Tensor, linkage: str = "average"
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``nn_chain``'s kernel with all of its counters, on a CUDA ``s``:
    ``(merge_rows, heights, counters)``, ``counters (3,)`` int32 = merges
    done, loop iterations, rows rescanned (``ref.nn_chain_cached_ref``'s
    ``steps`` and ``stats`` on the CPU)."""
    code = _chain_input(s, linkage)
    if not dispatch.on_cuda(s):
        raise ValueError("the nn_chain kernel's counters need a CUDA tensor")
    merges, heights, counters = _run_chains(s, code, 1, s.shape[0])
    return merges[0], heights[0], counters[0]


def nn_chain_grouped(s: torch.Tensor, linkage: str = "average"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``nn_chain`` on each matrix of ``s (B, n, n)`` f32 (each prepared,
    diagonal at ``-inf``; overwritten), in one call: one block a group on
    the card, each with its own state, outputs and counters.

    Returns ``(merge_rows (B, n-1, 2) i32, heights (B, n-1) f32, steps
    (B,) int32)``; a group whose matrix holds NaN stops short alone.
    """
    code = _chain_input(s, linkage, ndim=3)
    if not dispatch.on_cuda(s):
        return nn_chain_grouped_ref(s, linkage)
    merges, heights, counters = _run_chains(s, code, *s.shape[:2])
    return merges, heights, counters[:, 0]
