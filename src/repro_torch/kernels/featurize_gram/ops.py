"""Public wrapper for the fused featurize -> Gram kernel
(``csrc/featurize_gram.cu``).

Keeps the reference's contract (``src/repro/kernels/featurize_gram/
ops.py``): ``(x w)^T (x w)`` in fp32, unnormalised (the caller divides
by ``n_valid``), rows past a user's count already zero, and
``compute_dtype`` ``"fp32"`` or ``"bf16"`` (bf16 inputs and bf16 ``F``,
fp32 sums).  Where the reference called its kernel once per user, one
launch covers every user of a row chunk, and it accumulates into the
Gram stack in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.featurize_gram.ref import featurize_gram_ref

COMPUTE_DTYPES = ("fp32", "bf16")


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
    dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    x = x.to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    if out is None:
        out = torch.zeros((n_users, d, d), device=x.device,
                          dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = build.library()
    if lib.repro_featurize_gram_rows(d) == 0:
        raise ValueError(f"the featurize_gram kernel's tile does not fit "
                         f"the shared memory at d={d}")
    with torch.cuda.device(x.device):
        rc = lib.repro_featurize_gram(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), n_users, c, m, d,
                                      int(compute_dtype == "bf16"),
                                      dispatch.stream_of(x))
    build.check(rc, "featurize_gram")
    dispatch.count_launch("featurize_gram")
    return out


def featurize_gram(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: str = "fp32") -> torch.Tensor:
    """``x (n, m)``, ``w (m, d)`` -> ``(x w)^T (x w)  (d, d)`` fp32 (one
    user)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, m), got shape {tuple(x.shape)}")
    return batched_featurize_gram(x[None], w, compute_dtype)[0]
