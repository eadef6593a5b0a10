"""Seeded synthetic user data (numpy only).

Copies of ``make_task_feature_mixture``, the synthetic image families
(``SyntheticImageSpec``, ``CIFAR_LIKE``, ``FMNIST_LIKE``,
``CIFAR100_LIKE``) and ``make_task_dataset`` from
``src/repro/data/synthetic.py`` (the port imports nothing from the JAX
package, whose ``repro.data`` pulls in JAX).  Their outputs are
bit-identical to the originals' for a fixed seed.  The corruption
injectors are not copied yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["SyntheticImageSpec", "make_task_dataset", "class_mean",
           "make_task_feature_mixture",
           "CIFAR_LIKE", "FMNIST_LIKE", "CIFAR100_LIKE"]


def make_task_feature_mixture(n_users: int, n_samples: int, d: int,
                              n_tasks: int, seed: int = 0,
                              noise: float = 0.05, rank: int | None = None
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded multi-task USER FEATURES at protocol scale.

    Each task owns a random rank-``rank`` subspace of R^d; every user draws
    ``n_samples`` feature rows from its task's subspace plus isotropic
    noise — the minimal structure the one-shot protocol exploits, cheap
    enough for thousand-user engine tests and the launch CLI.

    Returns ``(features (n_users, n_samples, d) float32,
    task_ids (n_users,) int32)`` with users round-robined over tasks.
    """
    rng = np.random.default_rng(seed)
    rank = rank or max(2, d // 8)
    bases = [np.linalg.qr(rng.standard_normal((d, rank)))[0]
             .astype(np.float32) for _ in range(n_tasks)]
    task_ids = (np.arange(n_users) % n_tasks).astype(np.int32)
    feats = np.empty((n_users, n_samples, d), np.float32)
    for i, t in enumerate(task_ids):
        z = rng.standard_normal((n_samples, rank)).astype(np.float32)
        eps = rng.standard_normal((n_samples, d)).astype(np.float32)
        feats[i] = z @ bases[t].T + noise * eps
    return feats, task_ids


@dataclasses.dataclass(frozen=True)
class SyntheticImageSpec:
    """Shape + structure parameters of one synthetic dataset family."""

    name: str
    m: int                     # flat feature dimension (pixels)
    n_classes: int
    subspace_rank: int = 16    # rank of the class-conditional covariance
    task_scale: float = 3.0    # strength of the task-level component
    class_scale: float = 2.0   # strength of the class-level component
    mean_scale: float = 8.0    # strength of the class mean (in-task-subspace)
    noise: float = 0.25        # isotropic pixel noise
    base_seed: int = 1234      # identifies the dataset family (mu_c, B_c)


CIFAR_LIKE = SyntheticImageSpec("cifar10-like", m=3072, n_classes=10)
FMNIST_LIKE = SyntheticImageSpec("fmnist-like", m=784, n_classes=10)
CIFAR100_LIKE = SyntheticImageSpec("cifar100-like", m=3072, n_classes=100,
                                   base_seed=4321)


def _orthonormal(rng: np.random.Generator, m: int, r: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((m, r)))
    return q[:, :r].astype(np.float32)


def class_mean(spec: SyntheticImageSpec, cls: int, task_basis: np.ndarray
               ) -> np.ndarray:
    """Per-class mean image, living INSIDE the task subspace.

    Same-task classes share their mean subspace (their means are related,
    as real same-task classes are); the mean direction within the subspace
    is dataset+class specific.  This is what lets the protocol match
    semantically-similar classes ACROSS datasets (paper Table II).
    """
    rng = np.random.default_rng((spec.base_seed, 51929, cls))
    w = rng.standard_normal(task_basis.shape[1]).astype(np.float32)
    w /= max(np.linalg.norm(w), 1e-9)
    return spec.mean_scale * task_basis @ w


def _class_basis(spec: SyntheticImageSpec, cls: int,
                 task_of_class: dict[int, int] | None,
                 shared_task_seed: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(task_basis, class_basis) for one class.

    Classes of the same task share ``task_basis``; ``shared_task_seed``
    lets two *different datasets* share a task subspace (Table II:
    "vehicles" in CIFAR-10 and CIFAR-100 look alike).
    """
    task = task_of_class.get(cls, 0) if task_of_class else 0
    tseed = shared_task_seed if shared_task_seed is not None else spec.base_seed
    t_rng = np.random.default_rng((tseed, 7919, task))
    c_rng = np.random.default_rng((spec.base_seed, 104729, cls))
    tb = _orthonormal(t_rng, spec.m, spec.subspace_rank)
    cb = _orthonormal(c_rng, spec.m, spec.subspace_rank // 2)
    return tb, cb


def make_task_dataset(spec: SyntheticImageSpec,
                      labels: Sequence[int],
                      n_per_class: Sequence[int] | int,
                      seed: int = 0,
                      task_of_class: dict[int, int] | None = None,
                      shared_task_seed: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Sample a labelled dataset ``(X (n, m), y (n,))``.

    ``labels``: which classes to draw.  ``n_per_class``: samples per class
    (scalar or per-label list).  ``task_of_class`` maps class -> task id so
    same-task classes share their dominant covariance subspace.
    """
    rng = np.random.default_rng(seed)
    if isinstance(n_per_class, int):
        n_per_class = [n_per_class] * len(labels)
    xs, ys = [], []
    for cls, n in zip(labels, n_per_class):
        if n <= 0:
            continue
        tb, cb = _class_basis(spec, cls, task_of_class, shared_task_seed)
        mu = class_mean(spec, cls, tb)
        zt = rng.standard_normal((n, tb.shape[1])).astype(np.float32)
        zc = rng.standard_normal((n, cb.shape[1])).astype(np.float32)
        eps = rng.standard_normal((n, spec.m)).astype(np.float32)
        x = (mu[None, :]
             + spec.task_scale * zt @ tb.T
             + spec.class_scale * zc @ cb.T
             + spec.noise * eps)
        xs.append(x)
        ys.append(np.full(n, cls, dtype=np.int32))
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]
