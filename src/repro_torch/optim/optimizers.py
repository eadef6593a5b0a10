"""Plain optimizers on flat ``name -> tensor`` dicts, PyTorch port of
``src/repro/optim/optimizers.py``.

An ``Optimizer`` is a pair of functions ``(init, update)``.  The state is
an ``OptState`` holding a ``step`` tensor and fp32 buffers shaped like the
parameters.  ``update(grads, state, params)`` returns updates that
already carry the ``-lr``; ``apply_updates`` adds them.  Every operation
is elementwise or a whole-tensor sum, so the same functions act on a
stack of clients' parameters (a leading client axis) as on one client's.
The ``step`` tensor lives on the CPU: schedules read it as a 0-dim
tensor, which combines with tensors on any device without a copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["OptState", "Optimizer", "apply_updates", "global_norm",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "warmup_cosine_schedule", "sgd", "momentum", "adamw"]


class OptState(NamedTuple):
    step: torch.Tensor
    inner: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], tuple[Params, OptState]]
    """update(grads, state, params) -> (updates, new_state); updates are
    ADDED to params by ``apply_updates`` (they already contain the -lr)."""


def _zeros_step() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """The norm over every leaf.  On DTensor leaves the per-leaf sums are
    partial over their shards, and the norm comes out replicated."""
    norm = torch.sqrt(sum(torch.sum(torch.square(v.float()))
                          for v in tree.values()))
    placements = getattr(norm, "placements", None)
    if placements is not None and not all(p.is_replicate()
                                          for p in placements):
        from torch.distributed.tensor import Replicate

        norm = norm.redistribute(norm.device_mesh,
                                 [Replicate()] * len(placements))
    return norm


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {k: g * scale for k, g in tree.items()}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def f(step):
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine_schedule(lr: float, warmup: int, total_steps: int,
                           final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(1, total_steps - warmup), final_frac)

    def f(step):
        step = step.float()
        warm = lr * step / max(1, warmup)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return f


def _as_schedule(lr: float | Schedule) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def sgd(lr: float | Schedule) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return OptState(step=_zeros_step(), inner={})

    def update(grads, state, params):
        lr_t = sched(state.step)
        updates = {k: -lr_t * g.float() for k, g in grads.items()}
        return updates, OptState(step=state.step + 1, inner={})

    return Optimizer(init, update)


def momentum(lr: float | Schedule, beta: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        vel = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()}
        return OptState(step=_zeros_step(), inner=vel)

    def update(grads, state, params):
        lr_t = sched(state.step)
        vel = {k: beta * state.inner[k] + g.float() for k, g in grads.items()}
        updates = {k: -lr_t * v for k, v in vel.items()}
        return updates, OptState(step=state.step + 1, inner=vel)

    return Optimizer(init, update)


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        return OptState(step=_zeros_step(), inner={"m": zeros(),
                                                   "v": zeros()})

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(state.step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        m = {k: b1 * state.inner["m"][k] + (1 - b1) * g.float()
             for k, g in grads.items()}
        v = {k: b2 * state.inner["v"][k] + (1 - b2) * torch.square(g.float())
             for k, g in grads.items()}
        updates = {}
        for k, p in params.items():
            mhat = m[k] / bc1
            vhat = v[k] / bc2
            updates[k] = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                                  + weight_decay * p.float())
        return updates, OptState(step=step, inner={"m": m, "v": v})

    return Optimizer(init, update)
