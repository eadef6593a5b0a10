"""Carry the reference's state into the port.

The protocol has no learned weights: what must match between the JAX
package and the port is its configuration, the shared Phi parameters
(the raw path's "weights", seeded through numpy), and the shared
signatures.  These functions read the reference's objects by attribute
and its arrays through ``numpy.asarray`` (no import of the JAX
package), so a test can run the port's stages on the reference's own
parameters and signatures, free of ``eigh``'s sign and
degenerate-subspace choices.

The LM model zoo does have weights; ``lm_params_from_reference`` walks
the reference's nested decoder parameter dict (MoE experts and the
fusion ``patch_proj`` included) into the port's ``LM``,
``encdec_params_from_reference`` its encoder-decoder tree into an
``EncDec``, and ``cluster_heads_from_reference`` carries the
per-cluster serving heads, so a test runs both packages on the same
random weights.  ``lm_params_to_reference`` and
``encdec_params_to_reference`` go the other way: the port's parameters
(or anything named like them, such as AdamW's ``m`` and ``v``) restacked
into the reference's tree as numpy arrays.  ``reference_tree`` is that
layout with the leaves left as they are, the one in which
``launch/train.py`` checkpoints, so that either package's launcher
continues the other's run, and ``reference_named`` maps a restored tree
back to the parameter names.

The trainer's models (the paper's CNN and MLP) carry nested ``{"w",
"b"}`` dicts in the reference and flat PyTorch-layout dicts in the port:
``paper_cnn_params_from_reference`` and ``paper_mlp_params_from_reference``
map one to the other, and ``mthfl_config_from_reference`` and
``ifca_config_from_reference`` carry the trainer's and IFCA's
configurations.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import to_numpy
from repro_torch.core.cluster_engine import ClusterConfig
from repro_torch.core.hierarchy import HierarchyConfig
from repro_torch.core.membership_engine import MembershipConfig
from repro_torch.core.signature_engine import SignatureConfig
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data.features import FeatureConfig
from repro_torch.fed.client import ClientConfig
from repro_torch.fed.ifca import IFCAConfig
from repro_torch.fed.trainer import MTHFLConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.decode_loop import ClusterHeads
from repro_torch.models import encdec, transformer

__all__ = ["similarity_config_from_reference",
           "cluster_config_from_reference", "signatures_from_reference",
           "hierarchy_config_from_reference",
           "feature_config_from_reference",
           "signature_config_from_reference", "phi_params_from_reference",
           "membership_config_from_reference", "lm_params_from_reference",
           "encdec_params_from_reference", "lm_params_to_reference",
           "encdec_params_to_reference", "reference_tree",
           "reference_named", "reference_paths",
           "cluster_heads_from_reference",
           "paper_cnn_params_from_reference",
           "paper_mlp_params_from_reference", "mthfl_config_from_reference",
           "ifca_config_from_reference"]


def similarity_config_from_reference(cfg) -> SimilarityConfig:
    """A reference ``SimilarityConfig`` -> the port's.  The ``jnp`` and
    ``pallas`` backends (and ``impl``) map to ``torch``: the port picks
    the kernel by the tensors' device."""
    return SimilarityConfig(
        top_k=cfg.top_k, eig_floor=cfg.eig_floor,
        backend="shard_map" if cfg.backend == "shard_map" else "torch",
        block_users=cfg.block_users, landmarks=cfg.landmarks,
        mesh_axis=cfg.mesh_axis)


def cluster_config_from_reference(cfg) -> ClusterConfig:
    """A reference ``ClusterConfig`` -> the port's: ``numpy`` stays,
    ``jnp`` and ``pallas`` map to ``torch``."""
    return ClusterConfig(
        backend="numpy" if cfg.backend == "numpy" else "torch",
        linkage=cfg.linkage)


def hierarchy_config_from_reference(cfg) -> HierarchyConfig:
    """A reference ``HierarchyConfig`` -> the port's (the same fields)."""
    return HierarchyConfig(n_groups=cfg.n_groups,
                           group_clusters=cfg.group_clusters,
                           group_batch=cfg.group_batch,
                           assignment=cfg.assignment)


def signatures_from_reference(lam, v, grams=None,
                              device: str | torch.device = "cuda"):
    """Reference signatures ``lam (N, k)``, ``v (N, d, k)`` and optional
    Grams ``(N, d, d)`` -> float32 tensors on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return tensor(lam), tensor(v), None if grams is None else tensor(grams)


def feature_config_from_reference(cfg) -> FeatureConfig:
    """A reference ``FeatureConfig`` -> the port's (same fields, so the
    same seeded Phi and the same pinned probe digest)."""
    return FeatureConfig(kind=cfg.kind, d=cfg.d, seed=cfg.seed,
                         image_hw=cfg.image_hw,
                         probe_digest=cfg.probe_digest)


def signature_config_from_reference(cfg) -> SignatureConfig:
    """A reference ``SignatureConfig`` -> the port's.  The ``jnp`` and
    ``pallas`` backends map to ``torch``: the port picks the kernel by
    the tensors' device."""
    return SignatureConfig(
        backend="shard_map" if cfg.backend == "shard_map" else "torch",
        chunk_rows=cfg.chunk_rows, eig=cfg.eig,
        subspace_iters=cfg.subspace_iters, oversample=cfg.oversample,
        check=cfg.check, resid_tol=cfg.resid_tol,
        compute_dtype=cfg.compute_dtype, mesh_axis=cfg.mesh_axis)


def phi_params_from_reference(params: dict,
                              device: str | torch.device = "cuda") -> dict:
    """The reference's ``phi_params`` arrays -> float32 tensors on
    ``device``, in the form ``SignatureEngine.params_for`` caches."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def membership_config_from_reference(cfg) -> MembershipConfig:
    """A reference ``MembershipConfig`` -> the port's.  ``numpy`` stays;
    ``pallas`` maps to ``torch`` with the same ``compute_dtype``; ``jnp``
    maps to ``torch`` with ``compute_dtype="fp32"``, because the
    reference's jnp path scores with the fp32 ``assign_ref``.  Seed the
    port's engine from the reference's ``lam``, ``v`` and labels through
    ``MembershipEngine.seed``, which takes numpy."""
    backend = "numpy" if cfg.backend == "numpy" else "torch"
    compute = "fp32" if cfg.backend == "jnp" else cfg.compute_dtype
    return MembershipConfig(
        backend=backend, capacity=cfg.capacity,
        affinity_floor=cfg.affinity_floor, margin_floor=cfg.margin_floor,
        recluster_unassigned_frac=cfg.recluster_unassigned_frac,
        recluster_proto_shift=cfg.recluster_proto_shift,
        eig_floor=cfg.eig_floor, aggregator=cfg.aggregator,
        trim_frac=cfg.trim_frac, mom_groups=cfg.mom_groups,
        drift_stat=cfg.drift_stat, linkage=cfg.linkage,
        compute_dtype=compute, directory_dtype=cfg.directory_dtype)


def _lm_tensor(a, device) -> torch.Tensor:
    """One reference array -> a tensor of the same dtype on ``device``
    (bf16 goes through float32, which holds it exactly)."""
    arr = np.asarray(a)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=getattr(torch, arr.dtype.name))


def _walk(tree: dict, device, pick=None) -> dict:
    """A nested dict of reference arrays -> tensors on ``device``; with
    ``pick``, each leaf indexed along its leading (stacked-layer) axis
    first, so stacked experts ``(L, E, d, f)`` become ``(E, d, f)``."""
    return {key: _walk(val, device, pick) if isinstance(val, dict)
            else _lm_tensor(val if pick is None else np.asarray(val)[pick],
                            device)
            for key, val in tree.items()}


def lm_params_from_reference(cfg, params: dict,
                             device: str | torch.device = "cuda"
                             ) -> transformer.LM:
    """The reference's decoder parameter tree -> the port's ``LM`` on
    ``device``.  Takes both of the reference's layouts: stacked
    ``groups`` (``scan_layers=True``, each leaf with a leading
    layer-group axis) and the list ``groups_unrolled``; then the
    remainder layers of ``rest``."""
    dev = resolve_device(device)
    pattern = cfg.block_pattern
    blocks = []
    if "groups" in params:
        for g in range(cfg.n_groups):
            blocks += [_walk(params["groups"][str(j)], dev, g)
                       for j in range(len(pattern))]
    else:
        for group in params.get("groups_unrolled", []):
            blocks += [_walk(group[str(j)], dev)
                       for j in range(len(pattern))]
    blocks += [_walk(params["rest"][str(j)], dev)
               for j in range(len(cfg.rest_kinds))]
    top = _walk({key: params[key] for key in ("embed", "final_norm", "head",
                                              "patch_proj") if key in params},
                dev)
    return transformer.from_trees(cfg, top, blocks)


def encdec_params_from_reference(cfg, params: dict,
                                 device: str | torch.device = "cuda"
                                 ) -> encdec.EncDec:
    """The reference's encoder-decoder tree (``enc`` and ``dec`` stacked
    along a leading layer axis) -> the port's ``EncDec`` on ``device``."""
    dev = resolve_device(device)
    top = _walk({key: params[key] for key in ("frame_proj", "embed",
                                              "enc_norm", "final_norm",
                                              "head")}, dev)
    enc = [_walk(params["enc"], dev, i) for i in range(cfg.encoder_layers)]
    dec = [_walk(params["dec"], dev, i) for i in range(cfg.n_layers)]
    return encdec.from_trees(cfg, top, enc, dec)


_LM_TOP = ("embed", "final_norm", "head", "patch_proj")
_ENCDEC_TOP = ("frame_proj", "embed", "enc_norm", "final_norm", "head")


def _named(params) -> dict:
    """An ``LM`` / ``EncDec`` (its parameters, detached) or a dict keyed
    by the same names -> ``name -> leaf``."""
    if isinstance(params, torch.nn.Module):
        return {name: p.detach() for name, p in params.named_parameters()}
    return dict(params)


def _nest(flat: dict, prefix: str) -> dict:
    """The entries of ``flat`` under ``prefix`` as a nested dict (names
    split at their dots)."""
    out: dict = {}
    for name, leaf in flat.items():
        if name.startswith(prefix):
            *path, key = name[len(prefix):].split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[key] = leaf
    return out


def _stack(trees: list[dict]) -> dict:
    """Dicts of one structure -> one dict of stacked leaves (the
    reference's stacked layer axis): tensors by ``torch.stack``, numpy
    arrays by ``np.stack``."""
    out = {}
    for key, first in trees[0].items():
        leaves = [t[key] for t in trees]
        out[key] = _stack(leaves) if isinstance(first, dict) else (
            torch.stack(leaves) if isinstance(first, torch.Tensor)
            else np.stack(leaves))
    return out


def _dotted(tree: dict, prefix: str, pick=None) -> dict:
    """A nested dict -> ``prefix + dotted path -> leaf``; with ``pick``,
    each leaf indexed along its leading (stacked-layer) axis."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_dotted(val, f"{prefix}{key}.", pick))
        else:
            out[prefix + key] = val if pick is None else val[pick]
    return out


def reference_tree(cfg, params) -> dict:
    """The port's parameters in the reference's tree: an ``LM`` or
    ``EncDec``, or a dict keyed by their parameter names (AdamW's ``m``
    and ``v``), with its leaves as they are (tensors stay on their
    device; layers are stacked where the reference stacks them).

    A decoder takes the layout the reference's ``init`` builds for
    ``cfg.scan_layers``: stacked ``groups`` (a leading layer-group axis)
    or the list ``groups_unrolled``, then the remainder layers of
    ``rest``.  An encoder-decoder (``cfg.encoder_layers``) stacks ``enc``
    and ``dec`` along a leading layer axis."""
    flat = _named(params)
    if cfg.encoder_layers:
        out = {key: flat[key] for key in _ENCDEC_TOP}
        out["enc"] = _stack([_nest(flat, f"enc.{i}.")
                             for i in range(cfg.encoder_layers)])
        out["dec"] = _stack([_nest(flat, f"dec.{i}.")
                             for i in range(cfg.n_layers)])
        return out
    width = len(cfg.block_pattern)
    blocks = [_nest(flat, f"layers.{i}.") for i in range(cfg.n_layers)]
    groups = [{str(j): blocks[g * width + j] for j in range(width)}
              for g in range(cfg.n_groups)]
    out = {key: flat[key] for key in _LM_TOP if key in flat}
    if cfg.scan_layers and cfg.n_groups > 0:
        out["groups"] = _stack(groups)
    else:
        out["groups_unrolled"] = groups
    out["rest"] = {str(j): blocks[cfg.n_groups * width + j]
                   for j in range(len(cfg.rest_kinds))}
    return out


class _Leaf:
    """A parameter's name and shape, standing in for its tensor in the
    walk of ``reference_paths`` (an opaque object: stacking makes a
    numpy object array of them)."""

    __slots__ = ("name", "shape")

    def __init__(self, name: str, shape: tuple[int, ...]):
        self.name, self.shape = name, shape


def reference_paths(cfg, params) -> dict:
    """Parameter name -> ``(path, shape)`` of its leaf in the reference's
    tree: ``path`` the tree's keys (a list index as a string, as
    ``jax.tree_util`` prints it), ``shape`` the leaf's shape there, with
    the leading stacked-layer axis where the reference stacks one.  The
    walk is ``reference_tree``'s, over shapes only (``params`` an
    ``LM``, an ``EncDec`` or a dict of tensors, real or fake)."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + (str(key),))
        elif isinstance(node, list):
            for i, val in enumerate(node):
                walk(val, path + (str(i),))
        elif isinstance(node, np.ndarray):          # a stacked leaf
            for leaf in node:
                out[leaf.name] = (path, (len(node),) + leaf.shape)
        else:
            out[node.name] = (path, node.shape)

    walk(reference_tree(cfg, {name: _Leaf(name, tuple(t.shape))
                              for name, t in _named(params).items()}), ())
    return out


def reference_named(cfg, tree: dict) -> dict:
    """The inverse of ``reference_tree``: the reference's decoder or
    encoder-decoder tree -> ``parameter name -> leaf``, a stacked leaf
    indexed by its layer (a view, for a tensor).  Leaves are not
    converted: a restored checkpoint's tensors map to the names that
    ``model.named_parameters()`` and AdamW's state use."""
    if cfg.encoder_layers:
        out = {key: tree[key] for key in _ENCDEC_TOP}
        for i in range(cfg.encoder_layers):
            out.update(_dotted(tree["enc"], f"enc.{i}.", i))
        for i in range(cfg.n_layers):
            out.update(_dotted(tree["dec"], f"dec.{i}.", i))
        return out
    width = len(cfg.block_pattern)
    out = {key: tree[key] for key in _LM_TOP if key in tree}
    for g in range(cfg.n_groups):
        for j in range(width):
            prefix = f"layers.{g * width + j}."
            out.update(_dotted(tree["groups"][str(j)], prefix, g)
                       if "groups" in tree else
                       _dotted(tree["groups_unrolled"][g][str(j)], prefix))
    for j in range(len(cfg.rest_kinds)):
        out.update(_dotted(tree["rest"][str(j)],
                           f"layers.{cfg.n_groups * width + j}."))
    return out


def lm_params_to_reference(cfg, params) -> dict:
    """The inverse of ``lm_params_from_reference`` (and, for an
    ``EncDec``, of ``encdec_params_from_reference``): the model, or a
    dict keyed by its parameter names, -> the reference's tree of numpy
    arrays (``reference_tree``'s layout).  bf16 leaves come out as
    float32, which holds them exactly (the checkpoint stores them so)."""
    return reference_tree(cfg, {name: to_numpy(t) for name, t
                                in _named(params).items()})


#: ``reference_tree`` reads the model kind off ``cfg``, so one function
#: inverts both ``*_from_reference``.
encdec_params_to_reference = lm_params_to_reference


def cluster_heads_from_reference(heads, device: str | torch.device = "cuda"
                                 ) -> ClusterHeads:
    """A reference ``ClusterHeads`` -> the port's, fp32 on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return ClusterHeads(head=tensor(heads.head),
                        adapter_a=tensor(heads.adapter_a),
                        adapter_b=tensor(heads.adapter_b))


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def paper_cnn_params_from_reference(params: dict, cfg,
                                    device: str | torch.device = "cuda"
                                    ) -> dict:
    """The reference CNN's ``{layer: {"w", "b"}}`` -> the port's flat dict
    on ``device``.  Conv kernels go from HWIO to OIHW and dense matrices
    from ``(in, out)`` to ``(out, in)``; ``fc1``'s inputs keep their
    ``(h, w, c)`` order, as the port flattens its activations in that
    order.  ``cfg`` (either package's ``PaperCNNConfig``) fixes the
    expected shapes."""
    dev = resolve_device(device)
    c = cfg.image_hw[2]
    shapes = {"conv1": (5, 5, c, cfg.c1), "conv2": (5, 5, cfg.c1, cfg.c2),
              "fc1": (None, cfg.fc1), "fc2": (cfg.fc1, cfg.fc2),
              "head": (cfg.fc2, cfg.n_classes)}
    out = {}
    for name, shape in shapes.items():
        w = np.asarray(params[name]["w"])
        if w.shape[-1] != shape[-1] or (shape[0] is not None
                                        and w.shape[0] != shape[0]):
            raise ValueError(f"{name}.w has shape {w.shape}, the config "
                             f"asks for {shape}")
        perm = (3, 2, 0, 1) if w.ndim == 4 else (1, 0)
        out[f"{name}.weight"] = _f32(np.transpose(w, perm), dev)
        out[f"{name}.bias"] = _f32(params[name]["b"], dev)
    return out


def paper_mlp_params_from_reference(params: dict, cfg,
                                    device: str | torch.device = "cuda"
                                    ) -> dict:
    """The reference MLP's ``{layer: {"w", "b"}}`` -> the port's flat dict
    on ``device`` (dense matrices from ``(in, out)`` to ``(out, in)``)."""
    dev = resolve_device(device)
    shapes = {"fc1": (cfg.m, cfg.hidden), "head": (cfg.hidden, cfg.n_classes)}
    out = {}
    for name, shape in shapes.items():
        w = np.asarray(params[name]["w"])
        if w.shape != shape:
            raise ValueError(f"{name}.w has shape {w.shape}, the config "
                             f"asks for {shape}")
        out[f"{name}.weight"] = _f32(w.T, dev)
        out[f"{name}.bias"] = _f32(params[name]["b"], dev)
    return out


def _client_config(cfg) -> ClientConfig:
    return ClientConfig(lr=cfg.lr, optimizer=cfg.optimizer,
                        clip_norm=cfg.clip_norm,
                        weight_decay=cfg.weight_decay)


def mthfl_config_from_reference(cfg) -> MTHFLConfig:
    """A reference ``MTHFLConfig`` (its ``ClientConfig`` included) -> the
    port's.  ``jnp`` maps to ``torch``; ``shard_map`` and ``mesh_axis``
    carry over (the port shards the cluster axis over a
    ``torch.distributed`` mesh axis of that name)."""
    return MTHFLConfig(
        global_rounds=cfg.global_rounds, local_rounds=cfg.local_rounds,
        local_steps=cfg.local_steps, batch_size=cfg.batch_size,
        client=_client_config(cfg.client), seed=cfg.seed,
        backend="shard_map" if cfg.backend == "shard_map" else "torch",
        mesh_axis=cfg.mesh_axis, scan_rounds=cfg.scan_rounds,
        dropout_frac=cfg.dropout_frac)


def ifca_config_from_reference(cfg) -> IFCAConfig:
    """A reference ``IFCAConfig`` (its ``ClientConfig`` included) -> the
    port's."""
    return IFCAConfig(n_clusters=cfg.n_clusters, rounds=cfg.rounds,
                      local_steps=cfg.local_steps, batch_size=cfg.batch_size,
                      client=_client_config(cfg.client), seed=cfg.seed)
