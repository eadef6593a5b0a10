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
kept as the baseline: each prototype's ``P_t [V_1 .. V_B]`` as one
product, split over blocks of arrival groups x slices of P's rows by
``one_plan``, per-slice partial sums in a workspace this wrapper
allocates, then a second kernel that adds them in slice order, keeps the
verdict and divides by k.  CUDA tensors launch the kernels or raise; CPU
tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.assign.ref import (_cast, _masked,
                                            assign_looped_plain,
                                            assign_wave_plain, verdict)

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


#: assign_one: columns of ``[V_1 .. V_B]`` a block, columns of d a step,
#: the P ring's depths (deepest first) and its bytes a row, the slice
#: heights it takes, and the rows of d a V chunk holds by compute dtype.
ONE_COLS, ONE_STEP, ONE_ROW_BYTES = 128, 64, 288
ONE_STAGES = (5, 4, 3)
SLICE_ROWS = (32, 16)
V_ROWS = {"bf16": 512, "fp32": 256}
MAX_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class OnePlan:
    """How the assign_one kernel splits a wave: groups of ``group``
    arrivals (``group k <= 128`` columns; for ``k > 128`` one arrival in
    ``col_tiles`` tiles of 128 columns) x slices of ``slice_rows`` rows of
    P, with V in chunks of ``v_rows`` rows of d and a ring of ``stages``
    steps of P; ``smem`` a block."""
    group: int
    col_tiles: int
    n_groups: int
    slice_rows: int
    n_slices: int
    v_rows: int
    stages: int
    smem: int

    @property
    def n_parts(self) -> int:
        """Partial sums an (arrival, prototype) pair has."""
        return self.n_slices * self.col_tiles

    @property
    def blocks(self) -> int:
        return self.n_groups * self.n_parts


def one_smem_bytes(slice_rows: int, v_rows: int, stages: int,
                   compute_dtype: str) -> int:
    """V (128 columns x v_rows, padded), the P ring, under bf16 two
    buffers of a step converted to bf16, the epilogue's products:
    ``csrc/assign.cu::one_smem_bytes``."""
    bf16 = compute_dtype == "bf16"
    v = ONE_COLS * (v_rows + 8) * 2 if bf16 else ONE_COLS * (v_rows + 1) * 4
    converted = 2 * slice_rows * (ONE_STEP + 8) * 2 if bf16 else 0
    return (v + stages * slice_rows * ONE_ROW_BYTES + converted
            + slice_rows * (ONE_COLS + 8) * 4)


@functools.lru_cache(maxsize=256)
def one_plan(b: int, t: int, d: int, k: int, sms: int,
             compute_dtype: str = "bf16") -> OnePlan:
    """The split for ``b`` arrivals, ``t`` prototypes, width ``d`` and
    ``k`` columns on a card of ``sms`` multiprocessors, one block
    resident on each: as many arrivals a block as 128 columns hold, then
    the slice height that minimises waves of blocks x (a block's rows of
    P, ``t h / 16``, + its V staging, 2), the tallest on a tie, and the
    deepest P ring that fits the shared memory."""
    if min(b, t, d, k, sms) < 1:
        raise ValueError(f"bad wave (b, t, d, k, sms)={(b, t, d, k, sms)}")
    if compute_dtype not in V_ROWS:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if k <= ONE_COLS:
        col_tiles, group = 1, min(b, ONE_COLS // k)
    else:
        col_tiles, group = _cdiv(k, ONE_COLS), 1
    n_groups = _cdiv(b, group)
    best = None
    for h in SLICE_ROWS:
        blocks = n_groups * col_tiles * _cdiv(d, h)
        cost = _cdiv(blocks, sms) * (t * h // 16 + 2)
        if best is None or cost < best[0]:
            best = (cost, h)
    h = best[1]
    v_rows = min(V_ROWS[compute_dtype], _cdiv(d, ONE_STEP) * ONE_STEP)
    stages = next(s for s in ONE_STAGES
                  if one_smem_bytes(h, v_rows, s, compute_dtype) <= MAX_SMEM)
    return OnePlan(group, col_tiles, n_groups, h, _cdiv(d, h), v_rows,
                   stages, one_smem_bytes(h, v_rows, stages, compute_dtype))


def one_block(plan: OnePlan, b: int, k: int, block: int
              ) -> tuple[list[int], range, range]:
    """Block ``block``'s share of the wave, as the kernel indexes it:
    its arrivals, its rows of P (before the cut at d) and the channels of
    V it reads (``range(k)`` unless ``k > 128``)."""
    grp, part = block % plan.n_groups, block // plan.n_groups
    ctile, slice_ = part % plan.col_tiles, part // plan.col_tiles
    arrivals = list(range(grp * plan.group, min(b, (grp + 1) * plan.group)))
    rows = range(slice_ * plan.slice_rows, (slice_ + 1) * plan.slice_rows)
    chans = (range(k) if plan.col_tiles == 1 else
             range(ctile * ONE_COLS, min(k, (ctile + 1) * ONE_COLS)))
    return arrivals, rows, chans


def assign_one_sliced_plain(v: torch.Tensor, table: torch.Tensor, mask,
                            compute_dtype: str, plan: OnePlan
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The assign_one kernels' outputs ``(aff / k, labels, margin / k)``
    from the plain per-block partial sums: ``W = cast(P_t) cast(V)`` in
    fp32, each block's ``sum(W o V)`` over its rows and channels, the
    partials of a pair added in slice order (``x = p_0 + p_1 + ...``),
    then the mask, the verdict on the raw sums, and the division by k."""
    b, d, k = v.shape
    v32 = v.to(torch.float32)
    w = torch.einsum("tde,bek->btdk", _cast(table, compute_dtype),
                     _cast(v32, compute_dtype))
    prod = w * v32[:, None]
    parts = torch.zeros((plan.n_parts, b, table.shape[0]), dtype=torch.float32,
                        device=v.device)
    for block in range(plan.blocks):
        arrivals, rows, chans = one_block(plan, b, k, block)
        part = block // plan.n_groups
        rows = range(rows.start, min(rows.stop, d))
        parts[part, arrivals] = prod[arrivals][:, :, rows.start:rows.stop,
                                               chans.start:chans.stop
                                               ].sum(dim=(-2, -1))
    aff = parts[0]
    for p in range(1, plan.n_parts):
        aff = aff + parts[p]
    aff = _masked(aff, mask)
    labels, margin = verdict(aff)
    return aff / k, labels, margin / k


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
                plan = None
                rc = lib.repro_assign_wave(*head, *outs, b, t, d, k,
                                           dispatch.stream_of(v))
        build.check(rc, "assign_wave")
        dispatch.count_launch("assign_wave", plan)
    return aff / k, labels, margin / k


def assign_looped(v: torch.Tensor, protos: torch.Tensor, mask=None,
                  compute_dtype: str = "bf16"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-arrival assignment, ``tr(V^T P_t V)`` prototype by prototype
    with a running best: the baseline beside ``assign``, same contract.
    The table is scored as stored (no scales), as in the reference; any
    ``(d, k)`` (V is staged in chunks of d where it does not fit)."""
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
        plan = one_plan(b, t, d, k, _sm_count(device), compute_dtype)
        work = torch.empty((plan.n_parts, b, t), device=device,
                           dtype=torch.float32)
        with torch.cuda.device(device):
            rc = lib.repro_assign_one(
                v.data_ptr(), table.data_ptr(), _TABLE_TYPES[table.dtype],
                _ptr(mask), work.data_ptr(), aff.data_ptr(),
                labels.data_ptr(), margin.data_ptr(), b, t, d, k, plan.group,
                plan.col_tiles, plan.slice_rows, plan.v_rows, plan.stages,
                int(compute_dtype == "bf16"), dispatch.stream_of(v))
        build.check(rc, "assign_one")
        dispatch.count_launch("assign_one", plan)
    return aff, labels, margin
