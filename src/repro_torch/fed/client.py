"""Client-side local update (the inner loop of FedAvg), PyTorch port of
``src/repro/fed/client.py``.

``local_update`` runs one client's ``steps`` optimizer steps.
``fused_lps_round`` runs every client of a cluster at once: the clients'
parameters carry a leading client axis, the gradients come from
``torch.func.vmap`` over ``grad_and_value`` of the model's loss, and the
FedAvg is folded in.  ``masked_lps_round`` is the form the fused trainer
runs: the clients of every cluster padded into a ``(T, C_max)`` stack,
each step gathering every client's batch from its device-resident data
through an index tensor, and a FedAvg weighted by a membership mask, so
ragged and empty clusters need no Python branches.  Where the reference
``vmap``s one cluster's round over the cluster axis, the port flattens
``(T, C_max)`` into one client axis: each client's arithmetic is the
same.

Every client starts from its LPS parameters with a fresh optimizer state
each local round (the reference calls ``optimizer.init`` inside its scan,
so momentum resets each local round), and the loss it reports for a step
is the loss before that step.  With ``clip_norm`` set, each client's
gradient is clipped by its own global norm.

Batch indices and participation are drawn on the host from numpy streams
keyed by ``(stream words, user id)`` (``keyed_stream``): the draw a user
gets does not depend on the order clusters are visited in, nor on the
device the training runs on.  IFCA's batches come from a stateful numpy
``Generator`` instead (``make_batches``), as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import optim

Params = dict[str, torch.Tensor]
LossFn = Callable[[Params, dict], torch.Tensor]

__all__ = ["ClientConfig", "make_optimizer", "fp32_scope", "local_update",
           "fused_lps_round", "masked_lps_round", "keyed_stream",
           "sample_batch_indices", "participation_mask", "batch_stack",
           "make_batches", "make_batch_stack"]

# Stream tag separating the participation draws from the batch draws
# (both derive from the same per-cluster stream), as in the reference.
_PARTICIPATION_FOLD = 7451


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    lr: float = 0.05
    optimizer: str = "sgd"          # sgd | momentum | adamw
    clip_norm: float = 0.0          # 0 disables
    weight_decay: float = 0.0


def make_optimizer(cfg: ClientConfig) -> optim.Optimizer:
    if cfg.optimizer == "sgd":
        return optim.sgd(cfg.lr)
    if cfg.optimizer == "momentum":
        return optim.momentum(cfg.lr)
    if cfg.optimizer == "adamw":
        return optim.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@contextlib.contextmanager
def fp32_scope():
    """Convolutions and products in IEEE fp32 for the scope's duration,
    as the reference computes: cuDNN's TF32 off, its algorithms
    deterministic and not benchmarked, cuBLAS's TF32 off.  The previous
    settings come back on exit."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=False,
                deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _client_grads(loss_fn: LossFn, clip_norm: float):
    """``(params, x, y) -> (grads, loss)`` for one client: the gradient at
    ``params`` and the loss before the step, clipped by its own norm."""
    def one(params, x, y):
        grads, loss = torch.func.grad_and_value(
            lambda p: loss_fn(p, {"x": x, "y": y}))(params)
        if clip_norm:
            grads = optim.clip_by_global_norm(grads, clip_norm)
        return grads, loss
    return one


def _run_steps(params: Params, batch_at, steps: int, loss_fn: LossFn,
               optimizer: optim.Optimizer, clip_norm: float,
               batched: bool) -> tuple[Params, torch.Tensor]:
    """``steps`` optimizer steps from ``params`` with a fresh optimizer
    state; ``batch_at(s) -> (x, y)``.  With ``batched`` the parameters and
    batches carry a leading client axis and the gradients are vmapped over
    it.  Returns the parameters and the losses ``(..., steps)``."""
    grads_fn = _client_grads(loss_fn, clip_norm)
    if batched:
        grads_fn = torch.func.vmap(grads_fn)
    state = optimizer.init(params)
    losses = []
    with torch.no_grad():
        for s in range(steps):
            x, y = batch_at(s)
            grads, loss = grads_fn(params, x, y)
            updates, state = optimizer.update(grads, state, params)
            params = optim.apply_updates(params, updates)
            losses.append(loss)
    return params, torch.stack(losses, dim=-1)


def local_update(params: Params, batches: dict, loss_fn: LossFn,
                 cfg: ClientConfig) -> tuple[Params, torch.Tensor]:
    """One client's local round.  ``batches``: ``x`` and ``y`` with a
    leading ``steps`` axis.  Returns (new params, per-step losses)."""
    return _run_steps(params, lambda s: (batches["x"][s], batches["y"][s]),
                      batches["y"].shape[0], loss_fn, make_optimizer(cfg),
                      cfg.clip_norm, batched=False)


def _expand(params: Params, n: int) -> Params:
    return {k: v[None].expand(n, *v.shape) for k, v in params.items()}


def fused_lps_round(params: Params, batches: dict, weights,
                    loss_fn: LossFn, cfg: ClientConfig
                    ) -> tuple[Params, torch.Tensor]:
    """One LPS round: every client's local steps and the FedAvg.

    ``batches``: ``x`` and ``y`` with leading ``(clients, steps, batch)``
    axes.  Every client starts from ``params`` (the LPS broadcast); the
    ``weights``-weighted average comes back with the per-client per-step
    ``losses (clients, steps)``.
    """
    n_clients, steps = batches["y"].shape[:2]
    new, losses = _run_steps(
        _expand(params, n_clients),
        lambda s: (batches["x"][:, s], batches["y"][:, s]), steps, loss_fn,
        make_optimizer(cfg), cfg.clip_norm, batched=True)
    dev = next(iter(params.values())).device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.sum(w)
    avg = {k: torch.tensordot(w, v.float(), dims=1).to(params[k].dtype)
           for k, v in new.items()}
    return avg, losses


def masked_lps_round(params: Params, x: torch.Tensor, y: torch.Tensor,
                     n_per: torch.Tensor, mask: torch.Tensor,
                     idx: torch.Tensor, loss_fn: LossFn,
                     optimizer: optim.Optimizer, clip_norm: float
                     ) -> tuple[Params, torch.Tensor]:
    """Every cluster's LPS round over padded client slots, at once.

    ``params``: each tensor ``(T, ...)``, one LPS model a cluster.
    ``x (T, C_max, n_max, ...)`` / ``y (T, C_max, n_max)``: zero-padded
    client data; ``n_per (T, C_max)`` true sample counts (>= 1 on padding
    slots, which are weighted out); ``mask (T, C_max)`` 1.0 on
    participating clients; ``idx (T, C_max, steps, B)`` each client's
    batch indices into its own rows.  Every slot trains, and the FedAvg
    weights are ``n_per * mask``, so padding slots contribute exactly
    zero.  A cluster with no participating client keeps its parameters
    and reports a NaN loss.  Returns the new ``(T, ...)`` parameters and
    each cluster's mean loss ``(T,)``.
    """
    t, c = mask.shape
    steps = idx.shape[2]
    n_max = x.shape[2]
    xf = x.reshape(t * c, n_max, *x.shape[3:])
    yf = y.reshape(t * c, n_max)
    idf = idx.reshape(t * c, steps, -1)
    rows = torch.arange(t * c, device=x.device)[:, None]
    clients = {k: v[:, None].expand(t, c, *v.shape[1:])
               .reshape(t * c, *v.shape[1:]) for k, v in params.items()}
    new, losses = _run_steps(
        clients, lambda s: (xf[rows, idf[:, s]], yf[rows, idf[:, s]]),
        steps, loss_fn, optimizer, clip_norm, batched=True)

    mask = mask.float()
    w = n_per.float() * mask
    total = torch.sum(w, dim=1)                                # (T,)
    nonempty = total > 0
    wn = w / torch.clamp(total, min=1e-8)[:, None]
    avg = {}
    for k, p0 in params.items():
        tail = (1,) * (p0.ndim - 1)
        v = new[k].reshape(t, c, *p0.shape[1:]).float()
        # Padding slots trained on zero data; zero them BEFORE the
        # contraction so a non-finite padded result cannot poison the
        # average (NaN * 0 == NaN).
        v = torch.where(mask.reshape(t, c, *tail) > 0, v, 0.0)
        mean = torch.einsum("tc,tc...->t...", wn, v)
        avg[k] = torch.where(nonempty.reshape(t, *tail), mean,
                             p0.float()).to(p0.dtype)
    losses = losses.reshape(t, c, steps)
    loss_sum = torch.sum(torch.where(mask[..., None] > 0, losses, 0.0),
                         dim=(1, 2))
    loss_cnt = torch.sum(mask, dim=1) * steps
    mean_loss = torch.where(nonempty,
                            loss_sum / torch.clamp(loss_cnt, min=1.0),
                            torch.nan)
    return avg, mean_loss


def keyed_stream(*words: int) -> np.random.Generator:
    """A numpy stream keyed by non-negative integer words (the port's
    ``fold_in``): the same words give the same stream anywhere."""
    return np.random.default_rng([int(w) for w in words])


def sample_batch_indices(rng: np.random.Generator, steps: int,
                         batch_size: int, n: int) -> np.ndarray:
    """``(steps, batch)`` uniform-with-replacement indices in ``[0, n)``."""
    return rng.integers(0, max(int(n), 1), size=(steps, batch_size))


def participation_mask(round_words: Sequence[int], uids, rate: float
                       ) -> np.ndarray:
    """Per-round straggler/dropout mask: client ``uid`` participates iff
    its keyed uniform draw clears ``rate``.  Keyed by ``(round_words,
    uid)`` under its own tag, so it is independent of the batch stream
    and of cluster numbering; ``rate == 0.0`` is full participation
    exactly.  Returns a float32 ``(C,)`` mask, 1.0 = participating."""
    draws = np.asarray([keyed_stream(*round_words, _PARTICIPATION_FOLD,
                                     int(u)).random() for u in uids])
    return (draws >= rate).astype(np.float32)


def batch_stack(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor
                ) -> dict:
    """A cluster's batches gathered on the data's device: ``x (C, n_max,
    ...)``, ``y (C, n_max)`` and ``idx (C, steps, B)`` -> ``x (C, steps,
    B, ...)``, ``y (C, steps, B)``."""
    rows = torch.arange(idx.shape[0], device=x.device)[:, None, None]
    return {"x": x[rows, idx], "y": y[rows, idx]}


def make_batches(x, y, batch_size: int, steps: int, rng: np.random.Generator
                 ) -> dict:
    """``steps`` random mini-batches of ``(x, y)`` (tensors on any
    device), drawn from ``rng`` with the reference's numpy call."""
    n = len(y)
    idx = rng.integers(0, n, size=(steps, min(batch_size, n)))
    idx = torch.from_numpy(idx).to(x.device)
    return {"x": x[idx], "y": y[idx]}


def make_batch_stack(datasets: Sequence[tuple], batch_size: int,
                     steps: int, rng: np.random.Generator) -> dict:
    """Batches for a whole cluster -> ``(clients, steps, batch)``, with
    replacement, so clients holding fewer than ``batch_size`` samples
    stack too."""
    xs, ys = [], []
    for x, y in datasets:
        idx = rng.integers(0, len(y), size=(steps, batch_size))
        idx = torch.from_numpy(idx).to(x.device)
        xs.append(x[idx])
        ys.append(y[idx])
    return {"x": torch.stack(xs), "y": torch.stack(ys)}
