"""Seeded synthetic user features (numpy only).

A copy of ``make_task_feature_mixture`` from ``src/repro/data/synthetic.py``
(the port imports nothing from the JAX package, whose ``repro.data``
pulls in JAX).  Its output is bit-identical to the original's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_task_feature_mixture"]


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
