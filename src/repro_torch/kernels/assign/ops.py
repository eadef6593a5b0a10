"""Public wrappers for the assign kernels (``csrc/assign.cu``).

Keep the reference's contract (``src/repro/kernels/assign/ops.py``):
``v (B, d, k)`` against a directory ``protos (T, d, d)`` in f32, bf16 or
int8 -> ``(affinity (B, T), labels (B,) int32, margin (B,))``, with the
affinity and margin divided by k, dead prototypes at ``-inf`` and the
first index winning ties.

``assign`` scores the whole wave in one ``assign_wave``, which forms
each ``V_b V_b^T`` entry on chip; the reference's tile lookup, its
128-lane padding and its chunking of long waves (which exists because
its wrapper writes ``S (B, d^2)`` to memory) are gone.  The compute
dtype alone chooses the kernel (``wave_entry``): bf16 runs on the tensor
cores (``csrc/assign_wave_tc.cu``: the d^2 axis split over blocks by
``wave_plan``, partial sums in a workspace this wrapper allocates, then a
second kernel that adds them in a fixed order and keeps the verdict),
fp32 on the CUDA cores (``csrc/assign.cu``).  ``assign_looped`` is the
per-arrival formulation, one ``assign_one`` launch for the whole wave,
kept as the baseline.  CUDA tensors launch the kernels or raise; CPU
tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.assign.ref import (assign_looped_plain,
                                            assign_wave_plain)

COMPUTE_DTYPES = ("fp32", "bf16")
#: Stored table dtype -> the kernels' table_type code.
_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: Compute dtype -> the C entry point of the wave kernel that runs it.
_WAVE_ENTRIES = {"bf16": "repro_assign_wave_tc", "fp32": "repro_assign_wave"}

#: The tensor-core wave kernel's tiles: arrivals per block, and a K-step
#: of the flattened d^2 axis, a STEP_ROWS x STEP_COLS rectangle of S.
BLOCK_M, STEP_ROWS, STEP_COLS = 64, 4, 16
#: A block's fixed cost (its prologue and its partial sums), in K-steps.
_BLOCK_OVERHEAD = 4


def wave_entry(compute_dtype: str) -> str:
    """The C entry point of the wave kernel for ``compute_dtype``: bf16 ->
    the tensor-core kernel, fp32 -> the CUDA-core kernel."""
    if compute_dtype not in _WAVE_ENTRIES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    return _WAVE_ENTRIES[compute_dtype]


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """How the tensor-core wave kernel splits a wave over blocks: tiles of
    ``BLOCK_M`` arrivals x ``block_n`` prototypes, and the ``ksteps``
    K-steps of the d^2 axis cut into ``n_slices`` runs of
    ``ksteps_per_slice`` (the last may be shorter)."""
    block_n: int
    m_tiles: int
    n_tiles: int
    ksteps: int
    ksteps_per_slice: int
    n_slices: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def wave_plan(b: int, t: int, d: int, sms: int) -> WavePlan:
    """The split for ``b`` arrivals, ``t`` prototypes and width ``d`` on a
    card of ``sms`` multiprocessors, with one block resident on each at
    ``block_n`` 128 and two below (the kernel's launch bounds): the slice
    count that minimises waves of blocks x (K-steps a block + its fixed
    cost), the fewest slices on a tie.  Counts past 8 waves of blocks only
    add waves, so the search stops there."""
    block_n = 8 if t <= 8 else 32 if t <= 32 else 128
    m_tiles, n_tiles = _cdiv(b, BLOCK_M), _cdiv(t, block_n)
    ksteps = _cdiv(d, STEP_ROWS) * _cdiv(d, STEP_COLS)
    slots = sms * (1 if block_n == 128 else 2)
    best = None
    for n in range(1, min(ksteps, 8 * _cdiv(slots, m_tiles * n_tiles)) + 1):
        per = _cdiv(ksteps, n)
        n_slices = _cdiv(ksteps, per)
        cost = _cdiv(m_tiles * n_tiles * n_slices, slots) * (
            per + _BLOCK_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, per, n_slices)
    _, per, n_slices = best
    return WavePlan(block_n, m_tiles, n_tiles, ksteps, per, n_slices)


def slice_entries(plan: WavePlan, d: int, s: int) -> torch.Tensor:
    """Flattened indices ``i d + j`` of the S entries that slice ``s``
    covers, in the kernel's order: K-step q is rows ``STEP_ROWS (q %
    ceil(d / STEP_ROWS))`` .. and columns ``STEP_COLS (q // ceil(d /
    STEP_ROWS))`` .. (column chunk by column chunk), row by row; entries
    past ``d`` are dropped."""
    q = torch.arange(s * plan.ksteps_per_slice,
                     min((s + 1) * plan.ksteps_per_slice, plan.ksteps))
    rows = _cdiv(d, STEP_ROWS)
    i = (q % rows * STEP_ROWS)[:, None, None] \
        + torch.arange(STEP_ROWS)[None, :, None]
    j = (q // rows * STEP_COLS)[:, None, None] \
        + torch.arange(STEP_COLS)[None, None, :]
    i, j = torch.broadcast_tensors(i, j)
    inside = (i < d) & (j < d)
    return (i * d + j)[inside]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(v: torch.Tensor, protos: torch.Tensor, compute_dtype: str
           ) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if (v.ndim != 3 or protos.ndim != 3 or protos.shape[1] != v.shape[1]
            or protos.shape[2] != v.shape[1]):
        raise ValueError(f"bad shapes v={tuple(v.shape)} "
                         f"protos={tuple(protos.shape)}")
    if protos.shape[0] == 0:
        raise ValueError("the directory holds no prototype")


def _table(protos: torch.Tensor) -> torch.Tensor:
    if protos.dtype not in _TABLE_TYPES:
        protos = protos.to(torch.float32)
    return protos.contiguous()


def _row(x, t: int, device) -> torch.Tensor | None:
    if x is None:
        return None
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    if x.shape != (t,):
        raise ValueError(f"expected a ({t},) row, got {tuple(x.shape)}")
    return x.contiguous()


def _outputs(b: int, t: int, device):
    return (torch.empty((b, t), device=device, dtype=torch.float32),
            torch.empty((b,), device=device, dtype=torch.int32),
            torch.empty((b,), device=device, dtype=torch.float32))


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def assign(v: torch.Tensor, protos: torch.Tensor, mask=None,
           compute_dtype: str = "bf16", *, scales=None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched assignment of a wave: ``v (B, d, k)``, ``protos (T, d, d)``
    -> ``(affinity (B, T), labels (B,) int32, margin (B,))``.

    ``protos`` may be f32, bf16 or int8; int8 needs the per-prototype
    ``scales (T,)`` from ``quant.quantize_directory``, applied in the
    kernel's epilogue.  ``mask (T,)`` marks live prototypes.
    ``compute_dtype`` is the type of the product's inputs ("bf16" or
    "fp32"); sums are fp32 either way.
    """
    _check(v, protos, compute_dtype)
    if protos.dtype == torch.int8 and scales is None:
        raise ValueError("an int8 directory needs its per-prototype scales")
    b, d, k = v.shape
    t = protos.shape[0]
    device = v.device
    scales = _row(scales, t, device)
    mask = _row(mask, t, device)
    if not dispatch.on_cuda(v, protos):
        aff, labels, margin = assign_wave_plain(v, protos, scales, mask,
                                                compute_dtype)
        return aff / k, labels, margin / k
    v = v.to(torch.float32).contiguous()
    table = _table(protos)
    aff, labels, margin = _outputs(b, t, device)
    if b:
        lib = build.library()
        head = (v.data_ptr(), table.data_ptr(), _TABLE_TYPES[table.dtype],
                _ptr(scales), _ptr(mask))
        outs = (aff.data_ptr(), labels.data_ptr(), margin.data_ptr())
        with torch.cuda.device(device):
            if wave_entry(compute_dtype) == "repro_assign_wave_tc":
                plan = wave_plan(b, t, d, _sm_count(device))
                work = torch.empty((plan.n_slices, b, t), device=device,
                                   dtype=torch.float32)
                rc = lib.repro_assign_wave_tc(
                    *head, work.data_ptr(), *outs, b, t, d, k, plan.block_n,
                    plan.n_slices, plan.ksteps_per_slice,
                    dispatch.stream_of(v))
            else:
                rc = lib.repro_assign_wave(*head, *outs, b, t, d, k,
                                           dispatch.stream_of(v))
        build.check(rc, "assign_wave")
        dispatch.count_launch("assign_wave")
    return aff / k, labels, margin / k


def assign_looped(v: torch.Tensor, protos: torch.Tensor, mask=None,
                  compute_dtype: str = "bf16"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-arrival assignment, ``tr(V^T P_t V)`` prototype by prototype
    with a running best: the baseline beside ``assign``, same contract.
    The table is scored as stored (no scales), as in the reference."""
    _check(v, protos, compute_dtype)
    b, d, k = v.shape
    t = protos.shape[0]
    device = v.device
    mask = _row(mask, t, device)
    if not dispatch.on_cuda(v, protos):
        aff, labels, margin = assign_looped_plain(v, protos, mask,
                                                  compute_dtype)
        return aff / k, labels, margin / k
    v = v.to(torch.float32).contiguous()
    table = _table(protos)
    aff, labels, margin = _outputs(b, t, device)
    if b:
        lib = build.library()
        if lib.repro_assign_one_smem(d, k) == 0:
            raise ValueError(f"the assign_one kernel's V tile does not fit "
                             f"the shared memory at d={d}, k={k}")
        with torch.cuda.device(device):
            rc = lib.repro_assign_one(
                v.data_ptr(), table.data_ptr(), _TABLE_TYPES[table.dtype],
                _ptr(mask), aff.data_ptr(), labels.data_ptr(),
                margin.data_ptr(), b, t, d, k, int(compute_dtype == "bf16"),
                dispatch.stream_of(v))
        build.check(rc, "assign_one")
        dispatch.count_launch("assign_one")
    return aff / k, labels, margin / k
