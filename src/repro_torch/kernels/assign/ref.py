"""Plain PyTorch versions of the assign kernels.

``assign_ref`` is the fp32 oracle of ``src/repro/kernels/assign/ref.py``:
``a(b, t) = trace(V_b^T P_t V_b) / k``, dead prototypes at ``-inf``,
first-index argmax, margin ``best - second`` (the affinity itself when
T = 1).

``assign_wave_plain`` and ``assign_looped_plain`` follow the two kernels'
arithmetic, compute dtype included, and return their RAW outputs (the
wrappers divide by k):

  * wave: ``S = V V^T`` in fp32, each entry summed over the k columns in
    order with every product and sum rounded on its own, as the kernel
    forms it (so both round the same S to bf16); then S and the stored
    table each cast to the compute dtype (int8 to bf16 is exact), one
    float32 product ``S P^T``, ``x scale``, the mask, the verdict;
  * looped: ``W = cast(P_t) @ cast(V)`` summed in fp32, then
    ``sum(W o V)`` with V in fp32, the mask, the verdict.

Products of bf16 values are exact in fp32, so fp32 matmuls of the
rounded values compute what the kernels compute, up to summation order.
"""
from __future__ import annotations

import torch

_NEG = float("-inf")


def _cast(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if compute_dtype == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def verdict(aff: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, T)`` affinities -> ``(labels (B,) int32, margin (B,))``: the
    first index of the maximum, and best minus the best of the others
    (the best itself when T = 1)."""
    labels = torch.argmax(aff, dim=1).to(torch.int32)
    best = aff.max(dim=1).values
    if aff.shape[1] == 1:
        return labels, best
    cols = torch.arange(aff.shape[1], device=aff.device)
    others = torch.where(cols[None, :] == labels[:, None].long(), _NEG, aff)
    return labels, best - others.max(dim=1).values


def _masked(aff: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return aff
    live = mask.to(device=aff.device, dtype=torch.float32) > 0.5
    return torch.where(live[None, :], aff, _NEG)


def assign_ref(v: torch.Tensor, protos: torch.Tensor,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``v (B, d, k)``, ``protos (T, d, d)`` -> ``(affinity (B, T), labels
    (B,) int32, margin (B,))``, all fp32, normalised by k."""
    v = v.to(torch.float32)
    k = v.shape[-1]
    aff = torch.einsum("bdk,tde,bek->bt", v, protos.to(torch.float32), v) / k
    aff = _masked(aff, mask)
    labels, margin = verdict(aff)
    return aff, labels, margin


def assign_wave_plain(v: torch.Tensor, table: torch.Tensor,
                      scales: torch.Tensor | None, mask: torch.Tensor | None,
                      compute_dtype: str
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wave kernel's function: RAW ``(aff (B, T), labels, margin)``."""
    b, d, _ = v.shape
    t = table.shape[0]
    v = v.to(torch.float32)
    s = torch.zeros((b, d, d), dtype=torch.float32, device=v.device)
    for c in range(v.shape[2]):
        s += v[:, :, c, None] * v[:, None, :, c]
    s = s.reshape(b, d * d)
    p = table.reshape(t, d * d)
    aff = _cast(s, compute_dtype) @ _cast(p, compute_dtype).T
    if scales is not None:
        aff = aff * scales.to(device=aff.device, dtype=torch.float32)[None, :]
    aff = _masked(aff, mask)
    labels, margin = verdict(aff)
    return aff, labels, margin


def assign_looped_plain(v: torch.Tensor, table: torch.Tensor,
                        mask: torch.Tensor | None, compute_dtype: str
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-arrival kernel's function: RAW ``(aff (B, T), labels,
    margin)``."""
    v = v.to(torch.float32)
    w = torch.einsum("tde,bek->btdk", _cast(table, compute_dtype),
                     _cast(v, compute_dtype))
    aff = (w * v[:, None]).sum(dim=(-2, -1))
    aff = _masked(aff, mask)
    labels, margin = verdict(aff)
    return aff, labels, margin
