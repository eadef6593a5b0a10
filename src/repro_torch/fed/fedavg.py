"""FedAvg aggregation (McMahan et al., AISTATS'17), PyTorch port of
``src/repro/fed/fedavg.py``, on flat ``name -> tensor`` dicts."""
from __future__ import annotations

from typing import Sequence

import torch

Params = dict[str, torch.Tensor]

__all__ = ["weighted_mean", "fedavg"]


def weighted_mean(trees: Sequence[Params], weights: Sequence[float]
                  ) -> Params:
    """Weighted average of parameter dicts: the sums run in fp32 and are
    cast back to each tensor's dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    out = {}
    for name, first in trees[0].items():
        acc = sum(wi * tree[name].float() for wi, tree in zip(w, trees))
        out[name] = acc.to(first.dtype)
    return out


def fedavg(client_params: Sequence[Params], n_samples: Sequence[int]
           ) -> Params:
    """Standard FedAvg: average client models weighted by local sample
    count."""
    return weighted_mean(client_params, [float(n) for n in n_samples])
