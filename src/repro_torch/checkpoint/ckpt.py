"""npz checkpointing, PyTorch port of ``src/repro/checkpoint/ckpt.py``,
in the same on-disk format, so that either package restores the other's
files.

A tree (nested dicts, lists, tuples and namedtuples such as
``optim.OptState``, with tensors or numpy arrays at the leaves) is
flattened to ``path -> array`` with ``/``-joined keys, as the
reference's ``jax.tree_util`` key paths print: a dict key, a sequence
index, and ``.field`` for a namedtuple field (``"1/.inner/m/embed"``).
Dicts flatten in sorted key order and ``None`` holds no leaf, as in the
reference.  The arrays go into ``step_%08d.npz`` (compressed) beside a
json manifest ``step_%08d.json`` (``step``, the tree's structure as a
string in the reference's ``PyTreeDef`` notation, sorted ``keys``).
bf16 and other dtypes numpy lacks are stored as float32.  The newest
``keep`` checkpoints are kept.  ``restore_checkpoint`` fills the
structure of a template tree, checks every key and shape, casts each
array to the template leaf's dtype and puts it on ``device``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

Tree = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "/"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs of an inner node in the reference's
    flattening order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves(tree: Tree, prefix: str = ""):
    """``(key, leaf)`` in the reference's order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaves(child, f"{prefix}{_SEP}{key}" if prefix else key)


def to_numpy(leaf) -> np.ndarray:
    """A tensor (on any device) or array -> numpy on the host; bf16 as
    float32, which holds it exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    """The tree as ``key -> numpy array``, as the checkpoint stores it."""
    out = {}
    for key, leaf in _leaves(tree):
        arr = to_numpy(leaf)
        if arr.dtype.kind not in "biufc":   # bf16 etc: store as f32
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


def _treedef_str(tree: Tree) -> str:
    """The tree's structure in the reference's ``str(PyTreeDef)``
    notation: ``*`` a leaf, dicts by sorted key, lists, tuples and
    ``CustomNode(namedtuple[Name], [...])``."""

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(c) for c in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Tree,
                    keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    path = ckpt_dir / f"step_{step:08d}.npz"
    np.savez_compressed(path, **flat)
    manifest = {"step": step, "treedef": _treedef_str(tree),
                "keys": sorted(flat)}
    (ckpt_dir / f"step_{step:08d}.json").write_text(json.dumps(manifest))
    # retention
    ckpts = sorted(ckpt_dir.glob("step_*.npz"))
    for old in ckpts[:-keep]:
        old.unlink(missing_ok=True)
        old.with_suffix(".json").unlink(missing_ok=True)
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    ckpts = sorted(ckpt_dir.glob("step_*.npz"))
    if not ckpts:
        return None
    return int(ckpts[-1].stem.split("_")[1])


def _rebuild(like: Tree, leaves) -> Tree:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves``, in flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(c, leaves) for c in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def restore_checkpoint(ckpt_dir: str | Path, like: Tree,
                       step: int | None = None,
                       device: str | torch.device = "cuda"
                       ) -> tuple[Tree, int]:
    """Restore into the structure of ``like`` (tensors, meta tensors
    among them, or numpy arrays giving each leaf's shape and dtype).  Returns ``(tree, step)``, the
    leaves as tensors of the template's dtypes on ``device`` (default
    ``"cuda"``, which raises without a card)."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    device = resolve_device(device)
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        leaves = []
        for key, leaf in _leaves(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(np.asarray(arr, order="C")).to(
                device=device, dtype=_torch_dtype(leaf)))
    return _rebuild(like, iter(leaves)), step
