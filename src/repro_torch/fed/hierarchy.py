"""LPS/GPS hierarchical aggregation (paper §II-D, Algorithm 1), PyTorch
port of ``src/repro/fed/hierarchy.py``.

``lps_round`` aggregates one cluster's clients with FedAvg;
``gps_aggregate`` averages the common parameters across LPSs, weighted by
the clusters' sample counts, and grafts the average back into every LPS
model.  ``gps_aggregate_stacked`` does the same on cluster-stacked
tensors (a leading ``T`` axis), as the fused trainer holds them, and
``masked_cluster_mean`` computes every cluster's mean from a one-hot
membership in one contraction.  Their ``axis`` is the process group of a
sharded cluster or user axis (the reference's ``psum`` over a mesh axis
becomes ``all_reduce`` on that group), or ``None`` on one device.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.fed import partition as part
from repro_torch.fed.fedavg import fedavg as _fedavg
from repro_torch.fed.fedavg import weighted_mean as _wmean

Params = dict[str, torch.Tensor]

__all__ = ["lps_round", "gps_aggregate", "gps_aggregate_stacked",
           "masked_cluster_mean"]


def lps_round(cluster_client_params: Sequence[Params],
              n_samples: Sequence[int]) -> Params:
    """One LPS aggregation: FedAvg over the cluster's clients."""
    return _fedavg(cluster_client_params, n_samples)


def gps_aggregate(lps_params: Sequence[Params],
                  cluster_weights: Sequence[float],
                  is_common: part.PathPred) -> list[Params]:
    """GPS round: average the common parameters across LPSs and broadcast
    them back; the task-specific parameters stay as they are."""
    splits = [part.split_params(p, is_common) for p in lps_params]
    avg_common = _wmean([c for c, _ in splits], list(cluster_weights))
    return [part.merge_params(avg_common, s) for _, s in splits]


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the ranks of the group ``axis``, or ``x`` itself
    when ``axis`` is ``None``."""
    if axis is not None:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis)
    return x


def gps_aggregate_stacked(stack: Params, cluster_weights,
                          is_common: part.PathPred, axis=None) -> Params:
    """GPS round over cluster-stacked parameters (each tensor ``(T, ...)``).

    Common tensors become their ``cluster_weights``-weighted mean over the
    cluster axis, broadcast back to every cluster; the others pass
    through.  Empty clusters carry weight 0, so they take no part in the
    average but still receive it.  If every weight is zero the stack comes
    back unchanged.  ``axis``: the process group the cluster axis is
    sharded over (each rank holds its clusters' slice), or ``None``.
    """
    first = next(iter(stack.values()))
    w = torch.as_tensor(cluster_weights, dtype=torch.float32,
                        device=first.device)
    total = _psum(torch.sum(w), axis)
    wn = w / torch.clamp(total, min=1e-8)

    def leaf(name, v):
        if not is_common(name):
            return v
        num = _psum(torch.tensordot(wn, v.float(), dims=1), axis)
        avg = num[None].expand(v.shape)
        return torch.where(total > 0, avg, v.float()).to(v.dtype)

    return part.tree_path_map(leaf, stack)


def masked_cluster_mean(values: Params, onehot: torch.Tensor,
                        weights: torch.Tensor, axis=None) -> Params:
    """Every cluster's weighted mean in one contraction.

    ``values``: tensors with a leading user axis ``(U, ...)`` (this rank's
    users when ``axis``, a process group, shards them); ``onehot (U, T)``
    the membership; ``weights (U,)`` the sample counts.  Returns tensors
    with a leading cluster axis ``(T, ...)``; an empty cluster's mean is 0.
    """
    w = onehot.float() * weights.float()[:, None]              # (U, T)
    denom = torch.clamp(_psum(torch.sum(w, dim=0), axis), min=1e-8)

    def reduce_leaf(v):
        num = _psum(torch.einsum("u...,ut->t...", v.float(), w), axis)
        out = num / denom.reshape((-1,) + (1,) * (num.ndim - 1))
        return out.to(v.dtype)

    return {name: reduce_leaf(v) for name, v in values.items()}
