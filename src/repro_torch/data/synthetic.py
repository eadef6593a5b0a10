"""Seeded synthetic user data (numpy only).

Copies of ``make_task_feature_mixture``, the synthetic image families
(``SyntheticImageSpec``, ``CIFAR_LIKE``, ``FMNIST_LIKE``,
``CIFAR100_LIKE``) and ``make_task_dataset`` from
``src/repro/data/synthetic.py`` (the port imports nothing from the JAX
package, whose ``repro.data`` pulls in JAX).  Their outputs are
bit-identical to the originals' for a fixed seed, as are those of the
corruption injectors (``CorruptionSpec``, ``corrupt_labels``,
``label_noise_rows``, ``heavy_tail_noise``, ``byzantine_signatures``,
``apply_corruption``) that the membership launcher's scenarios use.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["SyntheticImageSpec", "make_task_dataset", "class_mean",
           "make_task_feature_mixture",
           "CIFAR_LIKE", "FMNIST_LIKE", "CIFAR100_LIKE",
           "BYZANTINE_MODES", "CorruptionSpec", "corrupt_labels",
           "label_noise_rows", "heavy_tail_noise", "byzantine_signatures",
           "apply_corruption"]


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


# ---------------------------------------------------------------------------
# Corruption injectors (dirty client data for the membership scenarios)
# ---------------------------------------------------------------------------

BYZANTINE_MODES = ("sign_flip", "random_subspace", "colluding_copy")


@dataclasses.dataclass(frozen=True)
class CorruptionSpec:
    """One composable, fully-seeded description of dirty client data.

    Attributes:
      flip_frac: label noise — the fraction of every user's rows drawn
        from another task's distribution (``label_noise_rows``; a user
        whose labels are wrong trains/uploads statistics mixing tasks).
      byzantine_frac: fraction of users whose signature upload is
        adversarially replaced (``byzantine_signatures``).
      byzantine_mode: "sign_flip" (coordinate reflection of the user's
        own eigenvectors), "random_subspace" (a fresh random orthonormal
        basis) or "colluding_copy" (all attackers upload the SAME scaled
        copy of an honest victim's signature — the coordinated attack
        that steers a mean prototype hardest).
      byzantine_scale: magnitude multiplier of the colluding upload; an
        adversarial client obeys no norm protocol, which is exactly why
        a mean prototype has breakdown point 0.
      heavy_tail_frac: fraction of users whose pixels get additive
        Student-t noise (``heavy_tail_noise``).
      heavy_tail_scale / heavy_tail_df: scale and degrees-of-freedom of
        that noise (df <= 2 has infinite variance).
      seed: root seed; every injector derives its own independent
        stream from it, so corruption is reproducible and composable.
    """

    flip_frac: float = 0.0
    byzantine_frac: float = 0.0
    byzantine_mode: str = "colluding_copy"
    byzantine_scale: float = 8.0
    heavy_tail_frac: float = 0.0
    heavy_tail_scale: float = 3.0
    heavy_tail_df: float = 2.0
    seed: int = 0

    def __post_init__(self):
        for name in ("flip_frac", "byzantine_frac", "heavy_tail_frac"):
            val = getattr(self, name)
            if not 0.0 <= val <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {val}")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"byzantine_mode must be one of "
                             f"{BYZANTINE_MODES}, got "
                             f"{self.byzantine_mode!r}")
        if self.byzantine_scale <= 0:
            raise ValueError(f"byzantine_scale must be positive, got "
                             f"{self.byzantine_scale}")
        if self.heavy_tail_df <= 0:
            raise ValueError(f"heavy_tail_df must be positive, got "
                             f"{self.heavy_tail_df}")
        if self.heavy_tail_scale < 0:
            raise ValueError(f"heavy_tail_scale must be >= 0, got "
                             f"{self.heavy_tail_scale}")

    def _rng(self, stream: str) -> np.random.Generator:
        """An independent generator per injector, derived from ``seed``
        (zlib.crc32, not ``hash`` — string hashing is process-salted)."""
        import zlib

        return np.random.default_rng(
            np.random.SeedSequence((self.seed, zlib.crc32(stream.encode()))))


def corrupt_labels(y: np.ndarray, flip_frac: float, n_classes: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform label noise: flip ``floor(flip_frac * len(y))`` labels to a
    uniformly-random *different* class.  The classic noisy-label model
    for per-sample training targets (``fed.trainer`` eval sets etc.)."""
    y = np.asarray(y)
    rng = np.random.default_rng(seed)
    n_flip = int(np.floor(flip_frac * len(y)))
    out = y.copy()
    if n_flip == 0:
        return out
    idx = rng.choice(len(y), n_flip, replace=False)
    # shift by a nonzero offset mod n_classes: never maps to itself
    offs = rng.integers(1, max(n_classes, 2), size=n_flip)
    out[idx] = (out[idx] + offs) % n_classes
    return out


def label_noise_rows(feats: np.ndarray, task_ids: np.ndarray,
                     flip_frac: float, seed: int = 0) -> np.ndarray:
    """Data-level label noise at the serving layer: for EVERY user,
    replace ``floor(flip_frac * n)`` of its feature rows with rows from
    a random user of a *different* task — what a client whose samples
    are mislabelled contributes to its Gram signature.  Users of tasks
    with no cross-task partner are left untouched."""
    feats = np.asarray(feats)
    task_ids = np.asarray(task_ids)
    rng = np.random.default_rng(seed)
    n_users, n_rows = feats.shape[0], feats.shape[1]
    n_bad = int(np.floor(flip_frac * n_rows))
    out = feats.copy()
    if n_bad == 0:
        return out
    for i in range(n_users):
        donors = np.flatnonzero(task_ids != task_ids[i])
        if not len(donors):
            continue
        j = int(rng.choice(donors))
        rows = rng.choice(n_rows, n_bad, replace=False)
        src = rng.choice(n_rows, n_bad, replace=True)
        out[i, rows] = feats[j, src]
    return out


def heavy_tail_noise(feats: np.ndarray, frac_users: float,
                     scale: float = 3.0, df: float = 2.0,
                     seed: int = 0) -> np.ndarray:
    """Additive Student-t pixel noise on ``floor(frac_users * N)`` users
    (df <= 2: infinite variance — the heavy-tailed regime a mean
    statistic cannot average away)."""
    feats = np.asarray(feats)
    rng = np.random.default_rng(seed)
    out = feats.copy()
    n_bad = int(np.floor(frac_users * feats.shape[0]))
    if n_bad == 0:
        return out
    bad = rng.choice(feats.shape[0], n_bad, replace=False)
    noise = rng.standard_t(df, size=(n_bad,) + feats.shape[1:])
    out[bad] = out[bad] + scale * noise.astype(feats.dtype)
    return out


def byzantine_signatures(lam: np.ndarray, v: np.ndarray, frac: float,
                         mode: str = "colluding_copy", seed: int = 0,
                         scale: float = 8.0,
                         labels: np.ndarray | None = None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace ``floor(frac * N)`` users' signature uploads adversarially.

    Modes (``BYZANTINE_MODES``):
      * ``sign_flip`` — reflect the user's own eigenvectors through a
        random ±1 coordinate pattern (a cheap subspace distortion an
        attacker can apply without knowing anything else).
      * ``random_subspace`` — upload a fresh random orthonormal basis.
      * ``colluding_copy`` — ALL attackers upload the same
        ``scale``-multiplied copy of an honest victim's signature; with
        ``labels`` given, attackers assigned to cluster ``t`` copy a
        victim from cluster ``(t+1) % T`` — the coordinated directory-
        poisoning attack that steers every mean prototype toward a
        *neighbouring* cluster's subspace (breakdown-point-0 demo).

    Returns ``(lam', v', byz_mask)`` — copies; honest rows untouched.
    """
    if mode not in BYZANTINE_MODES:
        raise ValueError(f"mode must be one of {BYZANTINE_MODES}, "
                         f"got {mode!r}")
    lam = np.asarray(lam, np.float32).copy()
    v = np.asarray(v, np.float32).copy()
    rng = np.random.default_rng(seed)
    n, d, k = v.shape
    n_byz = int(np.floor(frac * n))
    mask = np.zeros(n, bool)
    if n_byz == 0:
        return lam, v, mask
    byz = rng.choice(n, n_byz, replace=False)
    mask[byz] = True
    honest = np.flatnonzero(~mask)
    if mode == "sign_flip":
        for i in byz:
            signs = rng.choice([-1.0, 1.0], size=d).astype(np.float32)
            v[i] = signs[:, None] * v[i]
    elif mode == "random_subspace":
        for i in byz:
            q, _ = np.linalg.qr(rng.standard_normal((d, k)))
            v[i] = q.astype(np.float32)
    else:                                           # colluding_copy
        if labels is not None and len(honest):
            labels = np.asarray(labels)
            n_clusters = int(labels.max()) + 1
            # per-cluster victim from the NEXT cluster (honest member)
            victims = np.full(n_clusters, -1)
            for t in range(n_clusters):
                pool = honest[labels[honest] == (t + 1) % n_clusters]
                if len(pool):
                    victims[t] = int(rng.choice(pool))
            for i in byz:
                vic = victims[labels[i]]
                if vic < 0:
                    vic = int(rng.choice(honest))
                lam[i] = lam[vic]
                v[i] = scale * v[vic]
        else:
            vic = int(rng.choice(honest)) if len(honest) else int(byz[0])
            lam[byz] = lam[vic]
            v[byz] = scale * v[vic]
    return lam, v, mask


def apply_corruption(feats: np.ndarray, task_ids: np.ndarray,
                     spec: CorruptionSpec) -> np.ndarray:
    """Compose the FEATURE-level injectors (label-noise row mixing, then
    heavy-tailed pixel noise) on a user-feature batch; the signature-
    level Byzantine replacement applies after featurization via
    ``byzantine_signatures`` (signatures are what Byzantine clients
    actually control).  Each stage draws an independent stream from
    ``spec.seed``."""
    out = np.asarray(feats)
    if spec.flip_frac > 0:
        out = label_noise_rows(
            out, task_ids, spec.flip_frac,
            seed=spec._rng("label_noise").integers(2**31))
    if spec.heavy_tail_frac > 0:
        out = heavy_tail_noise(
            out, spec.heavy_tail_frac, spec.heavy_tail_scale,
            spec.heavy_tail_df,
            seed=spec._rng("heavy_tail").integers(2**31))
    return out
