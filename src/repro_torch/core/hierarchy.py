"""Two-level hierarchy helpers, PyTorch port.

Holds only ``greedy_match_labels`` (numpy), a copy of
``src/repro/core/hierarchy.py::greedy_match_labels``, which the
``MembershipEngine`` re-cluster uses to keep serving ids continuous.  The
rest of the reference module (``hierarchical_one_shot`` and its stages)
waits for ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import numpy as np

__all__ = ["greedy_match_labels"]


def greedy_match_labels(new_labels: np.ndarray, old_labels: np.ndarray,
                        n_clusters: int) -> np.ndarray:
    """Greedy-overlap relabeling of ``new_labels`` onto ``old_labels``'
    ids (both length-N, values in [0, n_clusters) or -1 = unassigned).

    HAC cut ids are arbitrary, so two runs need id alignment before
    exact-match agreement means anything.  Host-side: matching is a rare,
    tiny (T x T) event.
    """
    new_labels = np.asarray(new_labels)
    old_labels = np.asarray(old_labels)
    overlap = np.zeros((n_clusters, n_clusters), np.int64)
    for new, old in zip(new_labels, old_labels):
        if new >= 0 and old >= 0:
            overlap[new, old] += 1
    perm = np.full(n_clusters, -1, np.int64)
    used = np.zeros(n_clusters, bool)
    for new, old in zip(*np.unravel_index(np.argsort(-overlap, axis=None),
                                          overlap.shape)):
        if perm[new] < 0 and not used[old]:
            perm[new] = old
            used[old] = True
    for t in range(n_clusters):                 # clusters with no overlap
        if perm[t] < 0:
            perm[t] = int(np.flatnonzero(~used)[0])
            used[perm[t]] = True
    return np.where(new_labels >= 0, perm[np.clip(new_labels, 0, None)],
                    -1).astype(np.int32)
