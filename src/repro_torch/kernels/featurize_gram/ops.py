"""Public wrapper for the fused featurize -> Gram kernel
(``csrc/featurize_gram.cu``).

Keeps the reference's contract (``src/repro/kernels/featurize_gram/
ops.py``): ``(x w)^T (x w)`` in fp32, unnormalised (the caller divides
by ``n_valid``), rows past a user's count already zero, and
``compute_dtype`` ``"fp32"`` or ``"bf16"`` (bf16 inputs and bf16 ``F``,
fp32 sums).  Where the reference called its kernel once per user, one
launch covers every user of a row chunk, and it accumulates into the
Gram stack in place.

The kernel runs both products on the tensor cores: fp32 through the
3xTF32 split (``kernels/tf32.py`` is its plain version), bf16 on bf16
``mma``.  It reads ``x`` in fp32 in both modes and rounds it to bf16 on
chip under bf16, so no cast pass over ``x`` runs here; only ``w``, which
is small, is cast (and padded to a multiple of 8 columns).
``featurize_plan`` picks its row tile and ring depth from ``d``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.featurize_gram.ref import featurize_gram_ref

COMPUTE_DTYPES = ("fp32", "bf16")

#: The Gram tile edge, and the F columns a pass of the projection covers
#: (a W stage row holds them plus 8 elements of padding).
TILE = 128
SLAB = {"fp32": 256, "bf16": 512}
#: X stage row padding in floats past the k-stage depth: fp32 (TF32 A
#: reads), bf16 (float2 reads).
LDX_PAD = {"fp32": 4, "bf16": 8}
#: Shared memory one block may opt into on an H100.
MAX_SMEM = 232448
ROWS, STAGES = (64, 32, 16), (4, 3, 2)


@dataclasses.dataclass(frozen=True)
class FeaturizePlan:
    """Row tile and ring depth of one launch at width ``d``: ``rows`` rows
    of F a tile, ``stages`` k-stages in flight, ``d_pad`` the padded
    width of F (a multiple of the Gram tile), ``smem`` its bytes."""
    rows: int
    stages: int
    d_pad: int
    smem: int


def depth(rows: int) -> int:
    """The k-stage depth (columns of ``x``) of a row tile: 32, or 16 at 16
    rows, where a deeper W stage would not fit beside F."""
    return 16 if rows == 16 else 32


def smem_bytes(d: int, rows: int, stages: int, compute_dtype: str) -> int:
    """Shared memory of a launch: F ``[rows][d_pad + 8]`` in the compute
    type, then ``stages`` x (X ``[rows][depth + pad]`` fp32 | W
    ``[depth][slab + 8]`` in the compute type); the kernel's
    ``smem_bytes`` computes the same."""
    elt = 2 if compute_dtype == "bf16" else 4
    d_pad = -(-d // TILE) * TILE
    kd = depth(rows)
    stage = (rows * (kd + LDX_PAD[compute_dtype]) * 4
             + kd * (SLAB[compute_dtype] + 8) * elt)
    return rows * (d_pad + 8) * elt + stages * stage


@functools.lru_cache(maxsize=256)
def featurize_plan(d: int, compute_dtype: str = "fp32") -> FeaturizePlan:
    """The tallest row tile (64, 32, 16) that fits the shared memory with
    a ring of at least 2 stages (the deepest that fits, up to 4); where
    none does, the tallest with one stage (copies then do not overlap the
    products).  Raises where not even 16 rows and one stage fit."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    d_pad = -(-d // TILE) * TILE
    for stage_choices in (STAGES, (1,)):
        for rows in ROWS:
            for stages in stage_choices:
                smem = smem_bytes(d, rows, stages, compute_dtype)
                if smem <= MAX_SMEM:
                    return FeaturizePlan(rows, stages, d_pad, smem)
    raise ValueError(f"the featurize_gram kernel's tile does not fit the "
                     f"shared memory at d={d}")


def _kernel_w(w: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``w`` in the compute type, contiguous, with its columns padded by
    zeros to a multiple of 8 (16-byte rows for the kernel's copies)."""
    dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    m, d = w.shape
    ld = -(-d // 8) * 8
    if ld == d:
        out = w.to(dtype).contiguous()
        if out.data_ptr() % 16 == 0:
            return out
    out = torch.zeros((m, ld), device=w.device, dtype=dtype)
    out[:, :d] = w
    return out


def batched_featurize_gram(x: torch.Tensor, w: torch.Tensor,
                           compute_dtype: str = "fp32",
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """``x (N, c, m)``, ``w (m, d)`` -> ``(N, d, d)`` fp32 with
    ``out[u] += (x[u] w)^T (x[u] w)``.  ``out=None`` starts from zero;
    a given ``out`` (fp32, contiguous, on ``x``'s device) is updated in
    place and returned."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if x.ndim != 3 or w.ndim != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    n_users, c, m = x.shape
    d = w.shape[1]
    if out is not None and (out.shape != (n_users, d, d)
                            or out.dtype != torch.float32
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({n_users}, "
                         f"{d}, {d}) tensor on {x.device}")
    if not dispatch.on_cuda(x, w):
        g = featurize_gram_ref(x, w, compute_dtype)
        return g if out is None else out.add_(g)
    if out is None:
        out = torch.zeros((n_users, d, d), device=x.device,
                          dtype=torch.float32)
    if out.numel() == 0 or x.numel() == 0:
        return out
    plan = featurize_plan(d, compute_dtype)
    # The kernel reads rows of m floats, users any whole stride apart, so
    # a row-chunk view of a larger stack needs no copy.
    x = x.to(torch.float32)
    if x.stride(2) != 1 or x.stride(1) != m:
        x = x.contiguous()
    wk = _kernel_w(w, compute_dtype)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_featurize_gram(
            x.data_ptr(), x.stride(0), wk.data_ptr(), wk.shape[1],
            out.data_ptr(), n_users, c, m, d, int(compute_dtype == "bf16"),
            plan.rows, plan.stages, dispatch.stream_of(x))
    build.check(rc, "featurize_gram")
    dispatch.count_launch("featurize_gram", plan)
    return out


def featurize_gram(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: str = "fp32") -> torch.Tensor:
    """``x (n, m)``, ``w (m, d)`` -> ``(x w)^T (x w)  (d, d)`` fp32 (one
    user)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, m), got shape {tuple(x.shape)}")
    return batched_featurize_gram(x[None], w, compute_dtype)[0]
