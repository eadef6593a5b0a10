"""The paper's CIFAR-10 CNN (§III "Datasets and Models"), PyTorch port of
``src/repro/models/cnn.py``.

Two 5x5 VALID convolutions, each followed by ReLU and a 2x2 max-pool,
then FC(120), FC(84) and the head; cross-entropy loss.  The two conv
layers are the common representation the GPS shares (``COMMON_PREFIXES``).

The parameters are a flat ``name -> tensor`` dict in PyTorch's layouts
(``conv1.weight (out, in, 5, 5)``, ``fc1.weight (out, in)``) and the
module is called through ``torch.func.functional_call``, so the trainer
can stack a leading client axis onto every tensor and ``vmap`` over it.
The input keeps the reference's layout: each row of ``x (B, 3072)`` is
an image in ``(h, w, c)`` order.  The activations go back to that order
before the flatten, so ``fc1``'s 400 inputs are ordered ``(h, w, c)`` as
the reference's ``fc1.w`` rows are.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

Params = dict[str, torch.Tensor]

__all__ = ["PaperCNNConfig", "PaperCNN", "init", "apply", "loss_fn",
           "accuracy", "COMMON_PREFIXES"]

COMMON_PREFIXES = ("conv1", "conv2")


@dataclasses.dataclass(frozen=True)
class PaperCNNConfig:
    image_hw: tuple[int, int, int] = (32, 32, 3)
    c1: int = 6
    c2: int = 16
    fc1: int = 120
    fc2: int = 84
    n_classes: int = 10

    @property
    def flat(self) -> int:
        """Inputs of ``fc1``: the spatial size after two VALID 5x5
        convolutions and 2x2 pools, times ``c2``."""
        h, w, _ = self.image_hw
        s1 = ((h - 4) // 2, (w - 4) // 2)
        return ((s1[0] - 4) // 2) * ((s1[1] - 4) // 2) * self.c2


class _Linear(nn.Linear):
    def reset_parameters(self):
        """No initial values: ``init`` draws them, ``functional_call``
        supplies them."""


class _Conv2d(nn.Conv2d):
    def reset_parameters(self):
        """As ``_Linear``."""


class PaperCNN(nn.Module):
    def __init__(self, cfg: PaperCNNConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.image_hw[2]
        self.conv1 = _Conv2d(c, cfg.c1, 5)
        self.conv2 = _Conv2d(cfg.c1, cfg.c2, 5)
        self.fc1 = _Linear(cfg.flat, cfg.fc1)
        self.fc2 = _Linear(cfg.fc1, cfg.fc2)
        self.head = _Linear(cfg.fc2, cfg.n_classes)

    def forward(self, x_flat: torch.Tensor) -> torch.Tensor:
        h, w, c = self.cfg.image_hw
        x = x_flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.head(x)


@functools.lru_cache(maxsize=None)
def _module(cfg: PaperCNNConfig) -> PaperCNN:
    # A shape template on the meta device: functional_call supplies every
    # tensor, so no values are drawn (which vmap would refuse).
    with torch.device("meta"):
        return PaperCNN(cfg)


def _he(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5


def init(cfg: PaperCNNConfig, generator: torch.Generator | int = 0
         ) -> Params:
    """He-normal weights and zero biases, on the CPU, drawn from
    ``generator`` (a CPU ``torch.Generator`` or a seed)."""
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator().manual_seed(int(generator)))
    c = cfg.image_hw[2]
    shapes = {"conv1": ((cfg.c1, c, 5, 5), 25 * c),
              "conv2": ((cfg.c2, cfg.c1, 5, 5), 25 * cfg.c1),
              "fc1": ((cfg.fc1, cfg.flat), cfg.flat),
              "fc2": ((cfg.fc2, cfg.fc1), cfg.fc1),
              "head": ((cfg.n_classes, cfg.fc2), cfg.fc2)}
    params = {}
    for name, (shape, fan_in) in shapes.items():
        params[f"{name}.weight"] = _he(gen, shape, fan_in)
        params[f"{name}.bias"] = torch.zeros(shape[0])
    return params


def apply(cfg: PaperCNNConfig, params: Params, x_flat: torch.Tensor
          ) -> torch.Tensor:
    """``x_flat (B, m)`` -> logits ``(B, n_classes)``."""
    return torch.func.functional_call(_module(cfg), params, (x_flat,))


def loss_fn(cfg: PaperCNNConfig):
    def f(params: Params, batch: dict) -> torch.Tensor:
        return F.cross_entropy(apply(cfg, params, batch["x"]),
                               batch["y"].long())
    return f


def accuracy(cfg: PaperCNNConfig, params: Params, x, y) -> float:
    dev = next(iter(params.values())).device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    with torch.no_grad():
        logits = apply(cfg, params, x)
    return float((logits.argmax(-1) == y).float().mean())
