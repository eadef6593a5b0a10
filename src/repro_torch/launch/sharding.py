"""Sharding rules, PyTorch port of ``src/repro/launch/sharding.py``.

The reference's global-view arrays carry a ``PartitionSpec`` and XLA's
SPMD partitioner shards the program.  Here a sharded tensor is a
``DTensor`` over a device mesh (``launch/mesh.py``): a spec becomes one
placement per mesh axis (``placements``), ``with_sharding_constraint``
becomes ``redistribute`` (``make_shard_fn``).

Every parameter, state and input leaf gets an ordered list of candidate
specs (most parallel first); ``first_fitting`` picks the first whose
named mesh axes evenly divide each dimension, so GQA kv-heads that do not
divide the 16-way model axis fall back to head-dim sharding, then to
replication.  No uneven shard is ever made, although DTensor would
allow one.

Conventions (the reference's):
  * params: tensor-parallel on "model" (output dim of up-projections,
    input dim of down-projections), FSDP on "data" over the other big
    dim.  The reference stacks its layers (a leading layer axis, never
    sharded); the port keeps one tensor a layer, so a port parameter's
    spec is its reference leaf's spec with the stacked lead dropped.
    The reference's path of a port parameter is ``convert.
    reference_paths``'s, the walk of ``convert.reference_tree``.
  * activations (``make_shard_fn``): batch on ("pod", "data"); mode
    "seq" also shards the sequence dim on "model" between blocks, mode
    "tensor" shards d_model on "model", "megatron" shards block-boundary
    residuals on the sequence and keeps block interiors replicated over
    "model", "dp" leaves only the batch.
  * KV caches: batch -> data; kv-heads -> model (else seq, else head
    dim); batch 1 long-context falls back to seq -> ("data", "model").

A spec is the port's own ``P``: a tuple whose entries are ``None``, an
axis name, or a tuple of names.  The spec functions read only a mesh's
axis names and sizes (``mesh.axis_sizes``), so they take the reference's
``jax.sharding.AbstractMesh`` too.  One dim over two mesh axes,
``P(("data", "model"))``, puts chunk ``d * M + m`` on rank ``(d, m)``
(data-major, as JAX does): DTensor splits a dim sharded on several mesh
axes in mesh order, so the axes of an entry must come in mesh order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.convert import reference_paths
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as L

__all__ = ["P", "ShardingOptions", "first_fitting", "param_specs",
           "state_specs", "batch_specs", "activation_spec", "make_shard_fn",
           "placements", "named", "attach", "tree_map"]


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``, an axis
    name or a tuple of names.  ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    fsdp: bool = True
    activation_mode: str = "seq"      # dp | seq | tensor | megatron
    # "megatron": block-boundary residuals are sequence-sharded over
    # "model" while block interiors are kept replicated over it, so the
    # qkv / ffn products stay tensor-parallel with a gather and a
    # reduce-scatter at the two boundaries.


def _divides(spec: P, shape: tuple[int, ...], mesh) -> bool:
    sizes = mesh_lib.axis_sizes(mesh)
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim % total:
            return False
    return True


def first_fitting(shape: tuple[int, ...], candidates: Sequence[P],
                  mesh) -> P:
    for spec in candidates:
        if len(spec) > len(shape):
            continue
        if _divides(spec, shape, mesh):
            return spec
    return P()


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# 2-D weights whose OUTPUT dim is tensor-parallel ("model").
_OUT_SHARDED = {"wq", "wk", "wv", "wg", "wr", "w_up", "w_gate", "w_in_x",
                "w_in_y", "w_a", "w_i", "mix_a1", "w_a1", "router",
                "frame_proj", "patch_proj"}
# 2-D weights whose INPUT dim is tensor-parallel.
_IN_SHARDED = {"wo", "w_down", "w_out"}


def _param_candidates(path: tuple[str, ...], shape: tuple[int, ...],
                      opts: ShardingOptions) -> list[P]:
    """The reference's candidates for its leaf at ``path`` of ``shape``
    (stacked layer axes included)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    n_stack = len(shape) - _base_rank(path, shape)
    lead = (None,) * n_stack
    fsdp = "data" if opts.fsdp else None

    if name == "embed":
        return [P("model", fsdp), P("model", None), P(None, "model"), P()]
    if name == "head":
        return [P(fsdp, "model"), P(None, "model"), P("model", None), P()]

    base = len(shape) - n_stack
    if parent == "channel" and name == "wv":          # rwkv channel (f, d)
        return [P(*lead, "model", fsdp), P(*lead, "model", None), P()]
    if name in _IN_SHARDED and base == 2:
        return [P(*lead, "model", fsdp), P(*lead, "model", None), P()]
    if name in _OUT_SHARDED and base == 2:
        return [P(*lead, fsdp, "model"), P(*lead, None, "model"), P()]
    if base == 3 and name in ("w_up", "w_gate", "w_down"):
        # MoE expert stacks (E, d_in, d_out): expert-parallel on "model",
        # FSDP over the d_model dim.
        if name == "w_down":
            return [P(*lead, "model", None, fsdp),
                    P(*lead, "model", None, None), P()]
        return [P(*lead, "model", fsdp, None),
                P(*lead, "model", None, None), P()]
    # norm scales, biases, mixing vectors, conv weights, decay params
    return [P()]


def _base_rank(path: tuple[str, ...], shape: tuple[int, ...]) -> int:
    """Rank of the reference's leaf EXCLUDING stacked layer axes."""
    name = path[-1]
    stacked = any(p in ("groups", "enc", "dec") for p in path[:-1])
    if name in ("embed", "head", "frame_proj", "patch_proj", "final_norm",
                "enc_norm"):
        return len(shape)
    base = {
        "mu_x": 1, "mu": 2, "mix_a1": 2, "mix_a2": 3, "w0": 1, "w_a1": 2,
        "w_a2": 2, "u": 2, "ln_x": 1, "ln1": 1, "ln2": 1, "ln3": 1,
        "mu_k": 1, "mu_r": 1, "conv_w": 2, "conv_b": 1, "b_a": 1, "b_i": 1,
        "lam": 1, "q_norm": 1, "k_norm": 1, "router": 2,
    }.get(name)
    if base is None:
        # generic matrices: 2-D, except MoE expert stacks which are 3-D
        if name in ("w_up", "w_gate", "w_down") and len(shape) - (
                1 if stacked else 0) == 3:
            base = 3
        else:
            base = 2
    return base if stacked or base == len(shape) else len(shape)


def param_specs(cfg, params, mesh, opts: ShardingOptions | None = None
                ) -> dict[str, P]:
    """Parameter name -> spec, for an ``LM`` / ``EncDec`` (or a dict of
    its tensors, real or fake): the reference's spec of the same leaf,
    with the stacked layer axes dropped."""
    opts = opts or ShardingOptions()
    specs = {}
    for name, (path, shape) in reference_paths(cfg, params).items():
        spec = first_fitting(shape, _param_candidates(path, shape, opts),
                             mesh)
        n_stack = len(shape) - _rank_of(params, name)
        specs[name] = P(*spec[n_stack:])
    return specs


def _rank_of(params, name: str) -> int:
    if isinstance(params, torch.nn.Module):
        return params.get_parameter(name).ndim
    return len(params[name].shape)


# ---------------------------------------------------------------------------
# Decode-state specs
# ---------------------------------------------------------------------------

def _state_candidates(name: str, shape: tuple[int, ...], mesh) -> list[P]:
    if name == "length":
        return [P()]
    data = "data" if "data" in mesh_lib.axis_names(mesh) else None
    if name in ("k", "v", "mem_k", "mem_v"):
        # (..., B, S, K, hd), possibly with a leading stacked layer axis.
        # Preference: kv-head parallel, then seq parallel, then head-dim
        # parallel.
        lead = (None,) * (len(shape) - 4)
        return [
            P(*lead, data, None, "model", None),     # kv-head parallel
            P(*lead, data, "model", None, None),     # seq parallel
            P(*lead, data, None, None, "model"),     # head-dim parallel
            P(*lead, None, ("data", "model"), None, None),  # B=1: seq on all
            P(*lead, None, "model", None, None),
            P(*lead, None, None, "model", None),
            P(*lead, None, None, None, "model"),
            P(),
        ]
    if name == "wkv":
        # (..., B, H, hdk, hdv)
        lead = (None,) * (len(shape) - 4)
        return [P(*lead, data, "model", None, None),
                P(*lead, None, "model", None, None), P()]
    if name in ("shift_att", "shift_ffn", "h"):
        lead = (None,) * (len(shape) - 2)
        return [P(*lead, data, "model"), P(*lead, None, "model"), P()]
    if name == "conv":
        lead = (None,) * (len(shape) - 3)
        return [P(*lead, data, None, "model"),
                P(*lead, None, None, "model"), P()]
    return [P()]


def state_specs(state, mesh):
    """The decode state's tree with a spec at every leaf (a Python-int
    ``length`` included)."""
    def spec(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return first_fitting(shape, _state_candidates(path[-1], shape, mesh),
                             mesh)
    return _map_with_path(spec, state)


# ---------------------------------------------------------------------------
# Batch specs + activation constraints
# ---------------------------------------------------------------------------

def batch_specs(batch, mesh) -> dict:
    b_axes = mesh_lib.batch_axes(mesh)

    def spec(leaf):
        shape = tuple(leaf.shape)
        cands = [P(b_axes, *(None,) * (len(shape) - 1)), P()]
        return first_fitting(shape, cands, mesh)

    return {key: spec(leaf) for key, leaf in batch.items()}


def activation_spec(mesh, opts: ShardingOptions | None,
                    shape: tuple[int, ...], name: str) -> P | None:
    """The spec ``make_shard_fn`` constrains an activation of ``shape``
    called ``name`` to, or ``None`` where it leaves it alone."""
    opts = opts or ShardingOptions()
    ndim = len(shape)
    if ndim < 2:
        return None
    sizes = mesh_lib.axis_sizes(mesh)
    b_axes = mesh_lib.batch_axes(mesh)
    rest = (None,) * (ndim - 3)
    if name == "logits":
        cands = [P(b_axes, *rest, None, "model"), P()]
    elif name == "interior":
        if opts.activation_mode != "megatron":
            return None
        cands = [P(b_axes, *(None,) * (ndim - 1)), P()]
    elif name == "kv_cache":
        # (B, S, K, hd): the state specs' preference, so that the cache
        # keeps its input sharding across the step.
        cands = [P("data", None, "model", None),
                 P("data", "model", None, None),
                 P("data", None, None, "model"),
                 P(None, ("data", "model"), None, None),
                 P(None, "model", None, None), P()]
    elif name.startswith("attn_logits"):
        # (B, K, G, C, S).  If the kv-head count divides the model axis
        # the cache is head-sharded: shard K.  Otherwise the cache is
        # seq-sharded: shard S (a partial softmax and a small combine).
        try:
            n_kv = int(name.split(":")[1])
        except (IndexError, ValueError):
            n_kv = 0
        msize = sizes.get("model", 1)
        mid = (None,) * (ndim - 3)
        dsize = sizes.get("data", 1)
        batch_shardable = shape[0] % dsize == 0
        if n_kv and n_kv % msize == 0 and batch_shardable:
            cands = [P("data", "model", *mid, None),
                     P("data", None, *mid, "model"), P()]
        elif n_kv and n_kv % msize == 0:
            # B=1 long-context: the cache fell back to seq over all axes
            cands = [P(None, None, *mid, ("data", "model")),
                     P(None, "model", *mid, None),
                     P(None, None, *mid, "model"), P()]
        else:
            cands = [P("data", None, *mid, "model"),
                     P(None, None, *mid, ("data", "model")),
                     P(None, None, *mid, "model"), P()]
    elif opts.activation_mode in ("seq", "megatron") and ndim >= 3:
        cands = [P(b_axes, *rest, "model", None),
                 P(b_axes, *rest, None, None), P()]
    elif opts.activation_mode == "tensor":
        cands = [P(b_axes, *rest, None, "model"),
                 P(b_axes, *rest, None, None), P()]
    else:
        cands = [P(b_axes, *(None,) * (ndim - 1)), P()]
    return first_fitting(shape, cands, mesh)


def make_shard_fn(mesh, opts: ShardingOptions | None = None
                  ) -> Callable[[torch.Tensor, str], torch.Tensor]:
    """The activation-constraint callback handed to the models:
    ``redistribute`` of a DTensor to ``activation_spec``'s placements,
    the identity on a plain tensor.  ``shard.spec(shape, name)`` is the
    spec it applies.

    A block's ``interior`` where the spec leaves it alone (every mode but
    "megatron") is gathered over its sequence (``layers.gather_inner``):
    the sequence-parallel gather of the block's input, once before the
    products that read it, where XLA's partitioner would place it."""
    opts = opts or ShardingOptions()

    def shard(x: torch.Tensor, name: str) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        spec = activation_spec(mesh, opts, tuple(x.shape), name)
        if spec is None:
            return L.gather_inner(x) if name == "interior" else x
        return x.redistribute(x.device_mesh, placements(mesh, spec))

    shard.spec = lambda shape, name: activation_spec(mesh, opts,
                                                     tuple(shape), name)
    return shard


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: P) -> list:
    """One DTensor placement a mesh axis: ``Shard(d)`` on the axes that
    dim ``d``'s entry names, ``Replicate()`` elsewhere.  An entry of
    several axes must name them in mesh order (DTensor splits in mesh
    order: chunk ``d * M + m`` on rank ``(d, m)``); other orders raise.
    An axis of size 1 shards nothing and is placed ``Replicate()``
    (DTensor will not drop or reshape a dim sharded over it, the
    length-1 sequence of a decode step)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_lib.axis_sizes(mesh)
    names = tuple(sizes)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of one dim must come "
                             f"in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(dim) if sizes[names[i]] > 1 else None
    return [Replicate() if p is None else p for p in out]


def named(mesh, specs):
    """A tree of specs -> the same tree of placement lists."""
    return _map_with_path(lambda path, s: placements(mesh, s), specs,
                          is_leaf=lambda x: isinstance(x, P))


def _distribute(t: torch.Tensor, mesh, spec: P):
    from torch.distributed.tensor import distribute_tensor

    if not _divides(spec, tuple(t.shape), mesh):
        raise ValueError(f"spec {spec} does not divide shape "
                         f"{tuple(t.shape)} on mesh "
                         f"{mesh_lib.axis_sizes(mesh)}")
    return distribute_tensor(t, mesh, placements(mesh, spec))


def attach(tensors, specs, mesh):
    """Place real or fake tensors as DTensors of their specs.  An
    ``nn.Module`` (``specs`` by parameter name, as ``param_specs`` gives
    them) has its parameters replaced in place, each keeping its
    ``requires_grad``; a tree (dicts, lists) of tensors comes back as the
    same tree of DTensors, non-tensor leaves (a Python-int ``length``)
    as they are."""
    if isinstance(tensors, torch.nn.Module):
        for name, p in list(tensors.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = tensors.get_submodule(owner) if owner else tensors
            setattr(module, leaf, torch.nn.Parameter(
                _distribute(p.detach(), mesh, specs[name]),
                requires_grad=p.requires_grad))
        return tensors
    return tree_map(lambda t, s: _distribute(t, mesh, s), tensors, specs)


# ---------------------------------------------------------------------------
# Trees of dicts and lists
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=(), is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); other leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree
