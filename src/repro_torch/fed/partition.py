"""Common/task-specific parameter partition and the trainer's
cluster-stack layout, PyTorch port of ``src/repro/fed/partition.py``.

The paper's MT-HFL shares only the common representation layers (the two
conv layers of its CNN) through the GPS.  The port's parameters are flat
``name -> tensor`` dicts whose names are the module's dotted paths
(``"conv1.weight"``), so a partition is a predicate over names, and
``split_params``, ``merge_params`` and ``tree_path_map`` act on those
dicts.  ``stack_layout`` and ``admit_layout`` say where each user sits in
the trainer's ``(T, C_max)`` cluster super-stack, and how admitted
arrivals slot into an existing stack without changing its shape; the
membership launcher keeps that layout up to date.
``group_stack_layout`` is the edge-grouped ``(G, T, C_max)`` layout of
the hierarchical protocol.

Out-of-range labels (the ``-1`` unassigned convention among them) get
the reference's sentinel coordinates ``rows == T`` and ``slot == C_max``.
JAX's scatter drops such indices; torch's indexing raises on them, so
every scatter here masks those rows out first, and a caller scattering
per-user payloads through the returned coordinates must do the same.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping

import torch

PathPred = Callable[[str], bool]

__all__ = ["tree_paths", "prefix_predicate", "split_params", "merge_params",
           "tree_path_map", "stack_layout", "group_stack_layout",
           "admit_layout"]


def tree_paths(params: Mapping[str, Any]) -> list[str]:
    """Every tensor's name, in the dict's order."""
    return list(params)


def prefix_predicate(prefixes: Iterable[str | tuple[str, ...]]) -> PathPred:
    """Predicate matching every name equal to a prefix or below it.

    ``prefix_predicate(["conv1", "conv2"])`` marks the paper CNN's common
    layers: ``"conv1"`` matches ``"conv1.weight"`` and ``"conv1.bias"``,
    not ``"conv10.weight"``.  A tuple prefix is a path, joined with dots.
    """
    norm = [".".join(p) if isinstance(p, tuple) else p for p in prefixes]

    def pred(name: str) -> bool:
        return any(name == p or name.startswith(p + ".") for p in norm)

    return pred


def tree_path_map(fn: Callable[[str, Any], Any], params: Mapping[str, Any]
                  ) -> dict:
    """``{name: fn(name, tensor)}``: maps over the dict, keeping its
    names and order."""
    return {name: fn(name, v) for name, v in params.items()}


def split_params(params: Mapping[str, Any], is_common: PathPred
                 ) -> tuple[dict, dict]:
    """Split a parameter dict into ``(common, specific)``: every tensor
    goes to exactly one side."""
    common, specific = {}, {}
    for name, v in params.items():
        (common if is_common(name) else specific)[name] = v
    return common, specific


def merge_params(common: Mapping[str, Any], specific: Mapping[str, Any]
                 ) -> dict:
    """Inverse of ``split_params``; the two sides must be disjoint."""
    out = dict(common)
    for name, v in specific.items():
        if name in out:
            raise ValueError(f"overlapping leaf at key {name!r}")
        out[name] = v
    return out


def _labels(labels, device=None) -> torch.Tensor:
    return torch.as_tensor(labels).to(device=device, dtype=torch.int32)


def _ranks(labels: torch.Tensor, n_clusters: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hot ``(N, T)`` of the labels and each user's stable rank among
    the users of its label (meaningless for invalid labels)."""
    cols = torch.arange(n_clusters, device=labels.device, dtype=torch.int32)
    onehot = labels[:, None] == cols[None]
    ranks = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
    rank = ranks[torch.arange(labels.shape[0], device=labels.device),
                 torch.clamp(labels, 0, n_clusters - 1).long()]
    return onehot, rank.to(torch.int32)


def stack_layout(labels, n_clusters: int, c_max: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Membership layout of the ``(T, C_max, ...)`` super-stack.

    ``labels (N,)`` ints -> ``(rows (N,) int32, slot (N,) int32, mask
    (T, C_max) float32)``: ``slot[u]`` is user ``u``'s column inside its
    cluster's row (stable in user order) and ``mask`` marks occupied
    slots.  Invalid labels get ``rows == n_clusters``, ``slot == c_max``.
    """
    labels = _labels(labels)
    valid = (labels >= 0) & (labels < n_clusters)
    onehot, slot = _ranks(labels, n_clusters)
    largest = max(int(onehot.sum(dim=0).max()) if n_clusters else 0, 1)
    if c_max is None:
        c_max = largest
    elif c_max < largest:
        # an undersized stack would have to drop valid users
        raise ValueError(f"c_max={c_max} < largest cluster size {largest}")
    rows = torch.where(valid, labels, n_clusters).to(torch.int32)
    slot = torch.where(valid, slot, c_max).to(torch.int32)
    mask = torch.zeros((n_clusters, c_max), dtype=torch.float32,
                       device=labels.device)
    mask[rows[valid].long(), slot[valid].long()] = 1.0
    return rows, slot, mask


def group_stack_layout(labels, group_ids, n_groups: int, n_clusters: int,
                       c_max: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Edge-grouped ``(G, T, C_max)`` super-stack layout for the
    hierarchical protocol (``core.hierarchy``): each edge server holds
    only its members of each global cluster, so its trainer stack is the
    ``(T, C_max)`` slice ``mask[g]``.

    ``labels (N,)`` global cluster ids + ``group_ids (N,)`` edge groups
    -> ``(grows (N,), rows (N,), slot (N,), mask (G, T, C_max))``, the
    contract of ``stack_layout``: any invalid label or group id gets the
    out-of-range ``(G, T, C_max)`` sentinel triple.  ``c_max`` bounds the
    largest per-group cluster, and an undersized value raises.
    """
    labels = _labels(labels)
    gids = _labels(group_ids, labels.device)
    if labels.shape != gids.shape:
        raise ValueError(f"labels {tuple(labels.shape)} and group_ids "
                         f"{tuple(gids.shape)} must align")
    valid = ((labels >= 0) & (labels < n_clusters)
             & (gids >= 0) & (gids < n_groups))
    # One flat (group, cluster) index reuses stack_layout's stable rank
    # and sentinels.
    combined = torch.where(valid, gids * n_clusters + labels, -1)
    _, slot, mask = stack_layout(combined, n_groups * n_clusters,
                                 c_max=c_max)
    grows = torch.where(valid, gids, n_groups).to(torch.int32)
    rows = torch.where(valid, labels, n_clusters).to(torch.int32)
    return grows, rows, slot, mask.reshape(n_groups, n_clusters, -1)


def admit_layout(mask, new_labels, n_clusters: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place newly admitted users into an EXISTING ``(T, C_max)`` layout
    without changing its shape.

    Each new user with label ``l`` takes row ``l``'s rank-th FREE column
    (stable rank among the wave's same-label users), so holes left by
    departed users are refilled.  Invalid labels get the ``(T, C_max)``
    sentinel.  A wave that overflows a row raises: growing the stack is
    the caller's explicit choice.  Returns ``(rows (M,), slot (M,), mask
    (T, C_max))``; the input mask is not modified.
    """
    mask = torch.as_tensor(mask).to(torch.float32)
    t, c_max = mask.shape
    if n_clusters is not None and n_clusters != t:
        raise ValueError(f"n_clusters={n_clusters} != mask rows {t}")
    labels = _labels(new_labels, mask.device)
    valid = (labels >= 0) & (labels < t)
    occ = mask.sum(dim=1).to(torch.int32)
    onehot, rank = _ranks(labels, t)
    need = (int((occ + onehot.sum(dim=0)).max())
            if labels.numel() else 0)
    if need > c_max:
        raise ValueError(
            f"admitting this wave needs {need} slots in a row but "
            f"C_max={c_max}; re-run stack_layout to grow the stack")
    # A stable argsort of each 0/1 row lists its FREE columns first, in
    # ascending order: free_cols[l, r] is row l's rank-r free column.
    free_cols = torch.argsort(mask, dim=1, stable=True).to(torch.int32)
    slot = free_cols[torch.clamp(labels, 0, t - 1).long(),
                     torch.clamp(rank, 0, c_max - 1).long()]
    rows = torch.where(valid, labels, t).to(torch.int32)
    slot = torch.where(valid, slot, c_max).to(torch.int32)
    out = mask.clone()
    out[rows[valid].long(), slot[valid].long()] = 1.0
    return rows, slot, out
