"""Host reference HAC and clustering metrics (numpy only).

A copy of the parts of ``src/repro/core/clustering.py`` the port's
slice needs: ``Dendrogram``, ``hac``, ``cut``, ``hac_clusters``,
``oracle_clusters``, ``spectral_clusters``, ``clustering_accuracy``,
``adjusted_rand_index``, and the trainer's baselines ``random_clusters``
(the paper's) and ``ifca_assign`` (IFCA's assignment step).  The port
imports nothing from the JAX package, so it keeps its own copy; the
tests hold the two equal.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

__all__ = [
    "Dendrogram",
    "hac",
    "cut",
    "hac_clusters",
    "oracle_clusters",
    "random_clusters",
    "spectral_clusters",
    "ifca_assign",
    "clustering_accuracy",
    "adjusted_rand_index",
]


@dataclasses.dataclass(frozen=True)
class Dendrogram:
    """Merge history of HAC.

    ``merges[t] = (a, b, sim)``: at step ``t`` clusters ``a`` and ``b``
    (ids; leaves are ``0..N-1``, internal nodes ``N+t``) merged at
    similarity ``sim``.  ``sizes[c]`` is the leaf count of node ``c``.
    """

    n_leaves: int
    merges: tuple[tuple[int, int, float], ...]

    def heights(self) -> np.ndarray:
        return np.asarray([m[2] for m in self.merges])


_LINKAGES = ("average", "single", "complete")


def _validate_similarity(similarity: np.ndarray) -> np.ndarray:
    """Shared input validation -> float64 copy.

    Garbage in (NaN from an upstream 0/0, a non-square or asymmetric
    matrix) used to be silently merged into a nonsense dendrogram; now it
    raises at the door.  Tiny float asymmetry from accumulation order is
    tolerated (the protocol's ``symmetrize`` output is exactly symmetric,
    but callers may hand-build matrices in float32).
    """
    s = np.array(similarity, dtype=np.float64, copy=True)
    if s.ndim != 2 or s.shape[0] != s.shape[1]:
        raise ValueError(f"similarity must be square, got {s.shape}")
    if not np.isfinite(s).all():
        raise ValueError("similarity contains NaN/Inf entries")
    if not np.allclose(s, s.T, rtol=1e-5, atol=1e-6):
        raise ValueError("similarity must be symmetric "
                         "(max |R - R^T| = "
                         f"{np.abs(s - s.T).max():.3g})")
    return s


def hac(similarity: np.ndarray, linkage: str = "average") -> Dendrogram:
    """Agglomerative clustering over a symmetric similarity matrix.

    Similarity semantics (higher = closer): each step merges the pair of
    active clusters with *maximum* linkage similarity.

    Linkage between clusters A, B:
      average : mean_{i in A, j in B} R[i, j]   (UPGMA)
      single  : max  (closest members — "single link" in similarity space)
      complete: min  (farthest members)
    """
    if linkage not in _LINKAGES:
        raise ValueError(f"linkage must be one of {_LINKAGES}, got {linkage!r}")
    s = _validate_similarity(similarity)
    n = s.shape[0]
    # Active cluster bookkeeping. ``sim`` holds pairwise cluster linkage.
    sim = s.copy()
    np.fill_diagonal(sim, -np.inf)
    active = list(range(n))                 # index into sim rows -> node id
    node_of = {i: i for i in range(n)}      # row index -> dendrogram node id
    sizes = {i: 1 for i in range(n)}
    merges: list[tuple[int, int, float]] = []
    alive = np.ones(n, dtype=bool)

    for step in range(n - 1):
        # Find the max-similarity active pair.
        masked = np.where(np.outer(alive, alive), sim, -np.inf)
        np.fill_diagonal(masked, -np.inf)
        flat = int(np.argmax(masked))
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        h = float(masked[i, j])
        a, b = node_of[i], node_of[j]
        new_id = n + step
        merges.append((a, b, h))
        na, nb = sizes[a], sizes[b]
        # Lance-Williams update of row i (the merged cluster); kill row j.
        if linkage == "average":
            upd = (na * sim[i] + nb * sim[j]) / (na + nb)
        elif linkage == "single":
            upd = np.maximum(sim[i], sim[j])
        else:  # complete
            upd = np.minimum(sim[i], sim[j])
        sim[i] = upd
        sim[:, i] = upd
        sim[i, i] = -np.inf
        alive[j] = False
        node_of[i] = new_id
        sizes[new_id] = na + nb
    return Dendrogram(n_leaves=n, merges=tuple(merges))


def cut(dend: Dendrogram, n_clusters: int) -> np.ndarray:
    """Cut the dendrogram into ``n_clusters`` groups -> labels ``(N,)``.

    Replays merges until ``n_clusters`` components remain (the last
    ``n_clusters - 1`` merges are skipped).
    """
    n = dend.n_leaves
    if not 1 <= n_clusters <= n:
        raise ValueError(f"n_clusters must be in [1, {n}], got {n_clusters}")
    parent = list(range(n + len(dend.merges)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    keep = n - n_clusters                   # how many merges to apply
    for t, (a, b, _) in enumerate(dend.merges[:keep]):
        new_id = n + t
        parent[find(a)] = new_id
        parent[find(b)] = new_id
    roots = {}
    labels = np.empty(n, dtype=np.int32)
    for leaf in range(n):
        r = find(leaf)
        labels[leaf] = roots.setdefault(r, len(roots))
    return labels


def hac_clusters(similarity: np.ndarray, n_clusters: int,
                 linkage: str = "average") -> np.ndarray:
    """Convenience: HAC + cut -> labels."""
    return cut(hac(similarity, linkage), n_clusters)


def random_clusters(n_users: int, n_clusters: int,
                    rng: np.random.Generator | int = 0,
                    cluster_sizes: Sequence[int] | None = None) -> np.ndarray:
    """The paper's baseline: a uniformly random partition.

    If ``cluster_sizes`` is given the partition respects those sizes (the
    paper's random baseline keeps the LPS capacities fixed and shuffles
    users); otherwise each user picks a cluster uniformly, re-drawn until
    every cluster is non-empty.
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    if cluster_sizes is not None:
        if sum(cluster_sizes) != n_users:
            raise ValueError("cluster_sizes must sum to n_users")
        labels = np.repeat(np.arange(len(cluster_sizes)), cluster_sizes)
        rng.shuffle(labels)
        return labels.astype(np.int32)
    if not 1 <= n_clusters <= n_users:
        # every cluster must be non-empty, so n_clusters > n_users would
        # spin the redraw loop forever
        raise ValueError(f"n_clusters must be in [1, {n_users}], "
                         f"got {n_clusters}")
    while True:
        labels = rng.integers(0, n_clusters, size=n_users).astype(np.int32)
        if len(np.unique(labels)) == n_clusters:
            return labels


def oracle_clusters(task_ids: Sequence[int]) -> np.ndarray:
    """Ground-truth partition (relabelled to 0..T-1)."""
    _, labels = np.unique(np.asarray(task_ids), return_inverse=True)
    return labels.astype(np.int32)


def spectral_clusters(similarity: np.ndarray, n_clusters: int,
                      rng: np.random.Generator | int = 0) -> np.ndarray:
    """Beyond-paper: normalized spectral clustering on the affinity R.

    Ng-Jordan-Weiss: normalized Laplacian, bottom-T eigenvectors, row
    normalisation, k-means (Lloyd, 50 iters, best of 8 inits).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    a = _validate_similarity(similarity)
    if not 1 <= n_clusters <= a.shape[0]:
        # otherwise this crashes opaquely inside rng.choice (or silently
        # k-means-es more centers than points)
        raise ValueError(f"n_clusters must be in [1, {a.shape[0]}], "
                         f"got {n_clusters}")
    np.fill_diagonal(a, 0.0)
    deg = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(len(a)) - d_inv_sqrt[:, None] * a * d_inv_sqrt[None, :]
    w, v = np.linalg.eigh(lap)
    emb = v[:, :n_clusters]
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, 1e-12)
    best_labels, best_obj = None, np.inf
    for _ in range(8):
        centers = emb[rng.choice(len(emb), n_clusters, replace=False)]
        for _ in range(50):
            dists = ((emb[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = dists.argmin(1)
            for c in range(n_clusters):
                pts = emb[labels == c]
                if len(pts):
                    centers[c] = pts.mean(0)
        obj = float(dists.min(1).sum())
        if obj < best_obj:
            best_obj, best_labels = obj, labels
    return best_labels.astype(np.int32)


def ifca_assign(losses: np.ndarray) -> np.ndarray:
    """One IFCA assignment step: ``losses (N, T)`` per-user per-cluster
    model loss -> each user joins its argmin cluster."""
    return np.asarray(losses).argmin(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def clustering_accuracy(pred: Sequence[int], true: Sequence[int]) -> float:
    """Fraction of users correctly grouped under the best label permutation."""
    pred = np.asarray(pred)
    true = oracle_clusters(true)
    k = max(pred.max(), true.max()) + 1
    if k <= 8:  # exact over permutations
        best = 0
        for perm in itertools.permutations(range(k)):
            mapped = np.asarray(perm)[pred]
            best = max(best, int((mapped == true).sum()))
        return best / len(pred)
    # Greedy fallback for many clusters.
    conf = np.zeros((k, k), dtype=int)
    for p, t in zip(pred, true):
        conf[p, t] += 1
    total, used = 0, set()
    for p in np.argsort(-conf.max(axis=1)):
        order = np.argsort(-conf[p])
        for t in order:
            if t not in used:
                used.add(t)
                total += conf[p, t]
                break
    return total / len(pred)


def adjusted_rand_index(pred: Sequence[int], true: Sequence[int]) -> float:
    pred, true = np.asarray(pred), np.asarray(true)
    n = len(pred)
    classes, class_idx = np.unique(true, return_inverse=True)
    clusters, cluster_idx = np.unique(pred, return_inverse=True)
    table = np.zeros((len(classes), len(clusters)), dtype=np.int64)
    for c, k in zip(class_idx, cluster_idx):
        table[c, k] += 1

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_comb = comb2(table).sum()
    sum_a = comb2(table.sum(axis=1)).sum()
    sum_b = comb2(table.sum(axis=0)).sum()
    expected = sum_a * sum_b / comb2(n)
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_comb - expected) / (max_index - expected))
