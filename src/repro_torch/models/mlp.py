"""The paper's Fashion-MNIST MLP (§III), PyTorch port of
``src/repro/models/mlp.py``.

FC(784 -> 32) + ReLU, FC(32 -> C), cross-entropy.  The first layer is the
common representation in the 3-task experiment (Fig. 3).  Parameters are
a flat ``name -> tensor`` dict in PyTorch's ``(out, in)`` layout, called
through ``torch.func.functional_call`` (see ``models/cnn.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

Params = dict[str, torch.Tensor]

__all__ = ["PaperMLPConfig", "PaperMLP", "init", "apply", "loss_fn",
           "accuracy", "COMMON_PREFIXES"]

COMMON_PREFIXES = ("fc1",)


@dataclasses.dataclass(frozen=True)
class PaperMLPConfig:
    m: int = 784
    hidden: int = 32
    n_classes: int = 10


class _Linear(nn.Linear):
    def reset_parameters(self):
        """No initial values: ``init`` draws them, ``functional_call``
        supplies them."""


class PaperMLP(nn.Module):
    def __init__(self, cfg: PaperMLPConfig):
        super().__init__()
        self.fc1 = _Linear(cfg.m, cfg.hidden)
        self.head = _Linear(cfg.hidden, cfg.n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(F.relu(self.fc1(x)))


@functools.lru_cache(maxsize=None)
def _module(cfg: PaperMLPConfig) -> PaperMLP:
    with torch.device("meta"):
        return PaperMLP(cfg)


def init(cfg: PaperMLPConfig, generator: torch.Generator | int = 0
         ) -> Params:
    """He-normal weights and zero biases, on the CPU."""
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator().manual_seed(int(generator)))
    return {
        "fc1.weight": torch.randn((cfg.hidden, cfg.m), generator=gen)
        * (2.0 / cfg.m) ** 0.5,
        "fc1.bias": torch.zeros(cfg.hidden),
        "head.weight": torch.randn((cfg.n_classes, cfg.hidden), generator=gen)
        * (2.0 / cfg.hidden) ** 0.5,
        "head.bias": torch.zeros(cfg.n_classes),
    }


def apply(cfg: PaperMLPConfig, params: Params, x: torch.Tensor
          ) -> torch.Tensor:
    return torch.func.functional_call(_module(cfg), params, (x,))


def loss_fn(cfg: PaperMLPConfig):
    def f(params: Params, batch: dict) -> torch.Tensor:
        return F.cross_entropy(apply(cfg, params, batch["x"]),
                               batch["y"].long())
    return f


def accuracy(cfg: PaperMLPConfig, params: Params, x, y) -> float:
    dev = next(iter(params.values())).device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    with torch.no_grad():
        logits = apply(cfg, params, x)
    return float((logits.argmax(-1) == y).float().mean())
