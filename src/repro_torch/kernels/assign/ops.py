"""Public wrappers for the assign kernels (``csrc/assign.cu``).

Keep the reference's contract (``src/repro/kernels/assign/ops.py``):
``v (B, d, k)`` against a directory ``protos (T, d, d)`` in f32, bf16 or
int8 -> ``(affinity (B, T), labels (B,) int32, margin (B,))``, with the
affinity and margin divided by k, dead prototypes at ``-inf`` and the
first index winning ties.

``assign`` scores the whole wave in one launch of ``assign_wave``, which
forms each ``V_b V_b^T`` entry on chip; the reference's tile lookup, its
128-lane padding and its chunking of long waves (which exists because
its wrapper writes ``S (B, d^2)`` to memory) are gone.  ``assign_looped``
is the per-arrival formulation, one ``assign_one`` launch for the whole
wave, kept as the baseline.  CUDA tensors launch the kernels or raise;
CPU tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.assign.ref import (assign_looped_plain,
                                            assign_wave_plain)

COMPUTE_DTYPES = ("fp32", "bf16")
#: Stored table dtype -> the kernels' table_type code.
_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
        with torch.cuda.device(device):
            rc = lib.repro_assign_wave(
                v.data_ptr(), table.data_ptr(), _TABLE_TYPES[table.dtype],
                _ptr(scales), _ptr(mask), aff.data_ptr(), labels.data_ptr(),
                margin.data_ptr(), b, t, d, k, int(compute_dtype == "bf16"),
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
