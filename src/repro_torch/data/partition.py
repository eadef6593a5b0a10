"""Federated task partitioning (paper §III experimental settings).

Reproduces the paper's user/task layouts:

  * ``paper_cifar_two_task``: CIFAR-10 split into task A = {plane, car,
    ship, truck} and task B = {bird, cat, deer, dog, frog, horse}; 5 users
    per task, each with 10% minority labels from the other task (Fig. 2).
  * ``paper_fmnist_three_task``: Fashion-MNIST split into clothes / shoes /
    bags; 5 + 3 + 2 users, unbalanced sample counts, minority labels from
    other tasks (Fig. 3).

and a general ``federated_split`` for arbitrary task maps.

A numpy copy of ``src/repro/data/partition.py``: the port imports
nothing from the JAX package.  For a fixed seed every user's data is
bit-identical to the original's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.data import synthetic as syn

__all__ = ["UserSpec", "UserData", "federated_split",
           "paper_cifar_two_task", "paper_fmnist_three_task",
           "CIFAR_TASKS", "FMNIST_TASKS"]

# Class-index conventions mirroring the real label sets.
# CIFAR-10: 0 plane, 1 car, 2 bird, 3 cat, 4 deer, 5 dog, 6 frog, 7 horse,
#           8 ship, 9 truck
CIFAR_TASKS: dict[int, Sequence[int]] = {
    0: (0, 1, 8, 9),              # vehicles
    1: (2, 3, 4, 5, 6, 7),        # animals
}
# Fashion-MNIST: 0 tshirt, 1 trouser, 2 pullover, 3 dress, 4 coat,
#                5 sandal, 6 shirt, 7 sneaker, 8 bag, 9 ankle-boot
FMNIST_TASKS: dict[int, Sequence[int]] = {
    0: (0, 1, 2, 3, 4, 6),        # clothes
    1: (5, 7, 9),                 # shoes
    2: (8,),                      # bags
}


@dataclasses.dataclass(frozen=True)
class UserSpec:
    """How to build one user's local dataset."""

    user_id: int
    task_id: int
    majority_labels: tuple[int, ...]
    minority_labels: tuple[int, ...]
    n_majority: int
    n_minority: int


@dataclasses.dataclass
class UserData:
    user_id: int
    task_id: int
    x: np.ndarray                 # (n_i, m) flat features
    y: np.ndarray                 # (n_i,) class labels
    task_classes: tuple[int, ...]  # label set of this user's task

    @property
    def n(self) -> int:
        return len(self.y)

    def local_label(self) -> np.ndarray:
        """Labels remapped to 0..C_task-1 for the task-specific head."""
        lut = {c: i for i, c in enumerate(self.task_classes)}
        return np.asarray([lut.get(int(c), 0) for c in self.y],
                          dtype=np.int32)


def _task_of_class(tasks: Mapping[int, Sequence[int]]) -> dict[int, int]:
    out: dict[int, int] = {}
    for t, classes in tasks.items():
        for c in classes:
            out[c] = t
    return out


def federated_split(spec: syn.SyntheticImageSpec,
                    tasks: Mapping[int, Sequence[int]],
                    users: Sequence[UserSpec],
                    seed: int = 0) -> list[UserData]:
    """Materialise per-user datasets from user specs."""
    toc = _task_of_class(tasks)
    out = []
    for u in users:
        maj = list(u.majority_labels)
        mino = list(u.minority_labels)
        n_maj = [max(1, u.n_majority // len(maj))] * len(maj)
        n_min = ([max(0, u.n_minority // max(1, len(mino)))] * len(mino)
                 if mino and u.n_minority > 0 else [0] * len(mino))
        x, y = syn.make_task_dataset(
            spec, maj + mino, n_maj + n_min,
            seed=(seed, 31, u.user_id), task_of_class=toc)
        out.append(UserData(user_id=u.user_id, task_id=u.task_id, x=x, y=y,
                            task_classes=tuple(tasks[u.task_id])))
    return out


def paper_cifar_two_task(n_per_user: int = 1000, minority_frac: float = 0.10,
                         seed: int = 0,
                         users_per_task: tuple[int, int] = (5, 5)
                         ) -> list[UserData]:
    """Fig. 2 layout: 2 tasks x 5 users, 10% minority labels."""
    specs = []
    uid = 0
    for task, n_users in enumerate(users_per_task):
        other = 1 - task
        for _ in range(n_users):
            specs.append(UserSpec(
                user_id=uid, task_id=task,
                majority_labels=tuple(CIFAR_TASKS[task]),
                minority_labels=tuple(CIFAR_TASKS[other]),
                n_majority=int(n_per_user * (1 - minority_frac)),
                n_minority=int(n_per_user * minority_frac)))
            uid += 1
    return federated_split(syn.CIFAR_LIKE, CIFAR_TASKS, specs, seed=seed)


def paper_fmnist_three_task(seed: int = 0, scale: float = 1.0
                            ) -> list[UserData]:
    """Fig. 3 layout: 3 tasks, 5/3/2 users, unbalanced sample counts.

    Task 0 (clothes) has the most samples, task 2 (bags) the fewest, and
    only two users carry it — the regime where random clustering has high
    variance (paper §III).
    """
    layout = [  # (task, n_users, n_majority, n_minority)
        (0, 5, int(1200 * scale), int(120 * scale)),
        (1, 3, int(600 * scale), int(60 * scale)),
        (2, 2, int(300 * scale), int(30 * scale)),
    ]
    specs = []
    uid = 0
    for task, n_users, n_maj, n_min in layout:
        others = [c for t, cs in FMNIST_TASKS.items() if t != task for c in cs]
        for _ in range(n_users):
            specs.append(UserSpec(
                user_id=uid, task_id=task,
                majority_labels=tuple(FMNIST_TASKS[task]),
                minority_labels=tuple(others),
                n_majority=n_maj, n_minority=n_min))
            uid += 1
    return federated_split(syn.FMNIST_LIKE, FMNIST_TASKS, specs, seed=seed)
