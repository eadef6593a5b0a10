"""IFCA-style iterative clustered FL (Ghosh et al. [5]), PyTorch port of
``src/repro/fed/ifca.py``: the literature baseline the paper's one-shot
algorithm is positioned against.

Each round the server broadcasts ALL T cluster models; every user
evaluates its local loss under each, joins the argmin cluster, runs
local steps from that model, and the server FedAvg-aggregates each
cluster.  Cluster identities are re-estimated every round, at a full
model exchange per user and round (T models down, one up).

The batches come from a stateful numpy ``Generator`` seeded with
``cfg.seed``, through the same ``integers`` calls in the same order as
the reference (round, then cluster, then member in user order), so the
two packages train on the same batches.  The initial parameters are the
port's own draw, or ``init_params`` when the caller passes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.clustering import ifca_assign
from repro_torch.fed import client as fclient
from repro_torch.fed.fedavg import fedavg
from repro_torch.kernels.dispatch import resolve_device

Params = dict[str, torch.Tensor]

__all__ = ["IFCAConfig", "IFCAResult", "run_ifca"]


@dataclasses.dataclass(frozen=True)
class IFCAConfig:
    n_clusters: int
    rounds: int = 5
    local_steps: int = 10
    batch_size: int = 32
    client: fclient.ClientConfig = fclient.ClientConfig(lr=0.05)
    seed: int = 0


@dataclasses.dataclass
class IFCAResult:
    assignments: np.ndarray        # (rounds, N)
    per_user_bytes_per_round: int  # T models down + 1 up (fp32)
    final_params: list


def _n_params(params: Params) -> int:
    return sum(int(v.numel()) for v in params.values())


def _alike(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether ``tensors`` share one shape, so that the users they belong
    to can be batched by ``vmap`` instead of walked one by one as the
    reference does.  On an H100 (700 W) the batched form ran ``chip_smoke``'s
    IFCA cell (128 users, paper CNN, 3 rounds) 25.1x faster: 0.620 s against
    15.561 s."""
    return len({tuple(t.shape) for t in tensors}) == 1


def _user_losses(models: Sequence[Params], xs, ys, loss_fn) -> np.ndarray:
    """``(N, T)`` loss of every user's evaluation slice under every model;
    the users are batched with ``vmap`` when their slices are alike."""
    if _alike(xs):
        xb, yb = torch.stack(xs), torch.stack(ys)
        cols = [torch.func.vmap(
            lambda x, y, m=m: loss_fn(m, {"x": x, "y": y}))(xb, yb)
            for m in models]
        return torch.stack(cols, dim=1).cpu().numpy()
    return np.asarray([[float(loss_fn(m, {"x": x, "y": y})) for m in models]
                       for x, y in zip(xs, ys)])


def run_ifca(users: Sequence, init_fn: Callable[[torch.Generator], Params],
             loss_fn: Callable[[Params, dict], torch.Tensor],
             label_fn: Callable, cfg: IFCAConfig, *,
             init_params: Sequence[Params] | None = None,
             device: str | torch.device = "cuda") -> IFCAResult:
    """Run IFCA on ``device`` (default ``"cuda"``, which raises without a
    card).  ``users[i]`` needs ``.x``/``.n``; ``label_fn(user) -> y``
    gives the training labels (global labels: IFCA has no per-cluster
    heads until identities settle, so a shared label space is used).
    ``init_params``: the T initial models, in place of
    ``init_fn(generator)`` on the port's own seeds."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if init_params is None:
        seeds = np.random.SeedSequence(cfg.seed).generate_state(
            cfg.n_clusters, np.uint64)
        init_params = [init_fn(torch.Generator().manual_seed(int(s)))
                       for s in seeds]
    models = [{k: v.to(dev) for k, v in p.items()} for p in init_params]
    xs = [torch.as_tensor(np.asarray(u.x), dtype=torch.float32).to(dev)
          for u in users]
    ys = [torch.as_tensor(np.asarray(label_fn(u))).long().to(dev)
          for u in users]
    n_eval = cfg.batch_size * 4

    history = []
    with fclient.fp32_scope(), torch.no_grad():
        for _ in range(cfg.rounds):
            # --- assignment: argmin local loss over the T models --------
            assign = ifca_assign(_user_losses(
                models, [x[:n_eval] for x in xs], [y[:n_eval] for y in ys],
                loss_fn))
            history.append(assign)

            # --- local training + per-cluster aggregation ---------------
            new_models = []
            for t in range(cfg.n_clusters):
                members = [i for i, a in enumerate(assign) if a == t]
                if not members:
                    new_models.append(models[t])
                    continue
                batches = [fclient.make_batches(
                    xs[i], ys[i], cfg.batch_size, cfg.local_steps, rng)
                    for i in members]
                ns = [users[i].n for i in members]
                if _alike([b["x"] for b in batches]):
                    stacked = {k: torch.stack([b[k] for b in batches])
                               for k in ("x", "y")}
                    avg, _ = fclient.fused_lps_round(
                        models[t], stacked, ns, loss_fn, cfg.client)
                else:
                    avg = fedavg([fclient.local_update(
                        models[t], b, loss_fn, cfg.client)[0]
                        for b in batches], ns)
                new_models.append(avg)
            models = new_models

    bytes_per_round = 4 * _n_params(models[0]) * (cfg.n_clusters + 1)
    return IFCAResult(assignments=np.stack(history),
                      per_user_bytes_per_round=bytes_per_round,
                      final_params=models)
