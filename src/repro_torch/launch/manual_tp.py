"""Manual tensor + sequence parallelism (Megatron-SP), PyTorch port of
``src/repro/launch/manual_tp.py``.

The reference runs this inside ``shard_map``; here every rank runs it on
its own local shards (one process a device), with explicit collectives
whose backward is the transpose of their forward:

  per block, over ("data", "model"):
    h_seq (B_loc, S/TP, d)
    g  = all_gather(LN(h_seq), "model")        # seq -> full   [AG  S·d/TP]
    qkv / attention with LOCAL heads (H/TP a rank)
    a  = reduce_scatter(attn @ wo_loc, "model")  # full -> seq [RS  S·d/TP]
    h_seq += a;   the same AG / matmul / RS for the (Swi)GLU FFN

  embed: the table sharded on d; the token lookup local; an all-to-all
  swaps the d-shard for a seq-shard (S·d/TP bytes, no full-h gather).
  loss: vocab-parallel cross-entropy (head sharded on vocab; the softmax
  normaliser and the label logit combined with two small all-reduces,
  Megatron's parallel CE).

Collectives are ``torch.distributed._functional_collectives``' autograd
forms: an all-gather's backward reduce-scatters, a reduce-scatter's
all-gathers, an all-to-all's runs the other way.  A sum over ranks of
values the rest of the step treats as replicated (the CE's normaliser
and label logit, the data-parallel mean) is an all-reduce whose backward
is the identity.  The max for the softmax's stability takes no gradient
(the reference's ``stop_gradient``): a detached all-reduce MAX.  As JAX
sums an unmapped input's cotangents over the axis, each gradient is
summed over the mesh axes its parameter's spec does not name.

The parameters are the port's per-layer ``LM`` (``param_specs_manual``,
no stacked lead axis), each rank's local shard a plain tensor
(``local_shards``).  Dense decoders only; any other config raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed._functional_collectives as funcol
from torch.utils.checkpoint import checkpoint

from repro_torch import optim
from repro_torch.configs.base import ArchConfig
from repro_torch.core.distributed import sum_replicated
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as SH
from repro_torch.launch.sharding import P
from repro_torch.models import layers as L

__all__ = ["param_specs_manual", "local_shards", "manual_loss_fn",
           "make_manual_train_step", "trace_manual_step"]


def _check_dense(cfg: ArchConfig) -> None:
    if len(cfg.rest_kinds) or tuple(cfg.block_pattern) != ("attn",) \
            or cfg.n_experts or cfg.encoder_layers:
        raise ValueError("manual TP path supports dense decoders only")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def param_specs_manual(cfg: ArchConfig, fsdp: bool = True) -> dict[str, P]:
    """Specs of the dense ``LM``'s parameters, by name.

    Tensor-parallel on "model": wq / w_up / w_gate output dim, wo /
    w_down input dim; embed and head sharded on d / vocab; FSDP shards
    the other big dim on "data".  KV projections are replicated across
    the tensor-parallel ranks (Megatron's GQA rule: each rank recomputes
    the small projection and selects the kv heads its q heads group
    onto)."""
    d_ax = "data" if fsdp else None
    blk = {"ln1": P(None), "ln2": P(None),
           "attn.wq": P(d_ax, "model"), "attn.wk": P(d_ax, None),
           "attn.wv": P(d_ax, None), "attn.wo": P("model", d_ax),
           "ffn.w_up": P(d_ax, "model"), "ffn.w_gate": P(d_ax, "model"),
           "ffn.w_down": P("model", d_ax)}
    if cfg.qk_norm:
        blk["attn.q_norm"] = P(None)
        blk["attn.k_norm"] = P(None)
    specs = {"embed": P(None, "model"),     # d-sharded (lookup stays local)
             "final_norm": P(None),
             "head": P(d_ax, "model")}      # vocab-parallel head
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": s for k, s in blk.items()})
    return specs


def local_shards(tensors: dict, specs: dict, mesh) -> dict:
    """Each tensor's shard on this rank, a plain tensor (the
    ``shard_map`` view of a global array)."""
    return {k: SH.attach({k: t}, {k: specs[k]}, mesh)[k].to_local()
            for k, t in tensors.items()}


# ---------------------------------------------------------------------------
# Collectives with their transposes
# ---------------------------------------------------------------------------

def _ag(x, dim: int, group):
    return funcol.all_gather_tensor_autograd(x.contiguous(), dim, group)


def _rs(x, dim: int, group):
    return funcol.reduce_scatter_tensor_autograd(x.contiguous(), "sum", dim,
                                                 group)


def _pmax_nograd(x, group):
    return funcol.wait_tensor(funcol.all_reduce(x.detach(), "max", group))


# ---------------------------------------------------------------------------
# The manual block (each rank's shards)
# ---------------------------------------------------------------------------

def _block(h_seq, bp: dict, cfg: ArchConfig, tp_group, tp_rank: int,
           tp: int):
    """One dense block in manual TP+SP.  ``h_seq (B_loc, S/TP, d)``;
    ``bp`` the layer's local weights (FSDP dims gathered)."""
    from repro_torch.models.attention import chunked_attention

    b = h_seq.shape[0]
    # ---- attention sub-block ----
    hn = L.rms_norm(h_seq, bp["ln1"])
    g = _ag(hn, 1, tp_group)                             # (B, S, d)
    s_full = g.shape[1]
    h_loc = cfg.n_heads // tp
    q = L.mm(g, bp["attn.wq"]).reshape(b, s_full, h_loc, cfg.head_dim)
    # KV projections are replicated; select the kv head each LOCAL q
    # head groups onto (global q index = rank * h_loc + j).
    k = L.mm(g, bp["attn.wk"]).reshape(b, s_full, cfg.n_kv_heads,
                                       cfg.head_dim)
    v = L.mm(g, bp["attn.wv"]).reshape(b, s_full, cfg.n_kv_heads,
                                       cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, bp["attn.q_norm"])
        k = L.rms_norm(k, bp["attn.k_norm"])
    positions = torch.arange(s_full, device=g.device)[None, :]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    group_size = cfg.n_heads // cfg.n_kv_heads
    kv_idx = (tp_rank * h_loc + torch.arange(h_loc, device=g.device)) \
        // group_size
    k = k[:, :, kv_idx]                                  # (B, S, h_loc, hd)
    v = v[:, :, kv_idx]
    a = chunked_attention(q, k, v, causal=True, chunk=512)
    a_part = L.mm(a.reshape(b, s_full, -1), bp["attn.wo"])  # partial over TP
    h_seq = h_seq + _rs(a_part, 1, tp_group).to(h_seq.dtype)

    # ---- FFN sub-block ----
    hn2 = L.rms_norm(h_seq, bp["ln2"])
    g2 = _ag(hn2, 1, tp_group)
    up = L.mm(g2, bp["ffn.w_up"])
    gate = torch.nn.functional.silu(L.mm(g2, bp["ffn.w_gate"]))
    f_part = L.mm(gate * up, bp["ffn.w_down"])
    return h_seq + _rs(f_part, 1, tp_group).to(h_seq.dtype)


def _vocab_parallel_ce(h, head_loc, labels, tp_group, tp_rank: int):
    """Megatron parallel cross-entropy: ``h (B, S, d)`` the same rows on
    every tensor-parallel rank, ``head_loc (d, V/TP)``, ``labels (B, S)``
    global ids -> nll (B, S), replicated over the tensor-parallel
    ranks."""
    logits = L.mm(h, head_loc).float()                   # (B, S, V/TP)
    vshard = logits.shape[-1]
    vstart = tp_rank * vshard
    # the max is for stability only: constant under differentiation
    m = _pmax_nograd(logits.amax(dim=-1), tp_group)
    sumexp = sum_replicated(torch.exp(logits - m[..., None]).sum(dim=-1),
                            [tp_group])
    local_ids = labels.long() - vstart
    in_shard = (local_ids >= 0) & (local_ids < vshard)
    safe = local_ids.clamp(0, vshard - 1)
    lbl = logits.gather(-1, safe[..., None])[..., 0]
    lbl = sum_replicated(torch.where(in_shard, lbl, 0.0), [tp_group])
    return torch.log(sumexp) + m - lbl


def _embed_seq_sharded(embed_loc, tokens, tp_group, tp: int):
    """d-sharded lookup -> all-to-all -> seq-sharded full-d activations:
    ``(B, S, d/TP)`` -> ``(B, S/TP, d)``, the received d-shards in source
    rank order (the global d order)."""
    h = embed_loc[tokens.long()]                         # (B, S, d/TP)
    b, s, dl = h.shape
    chunks = h.reshape(b, tp, s // tp, dl).permute(1, 0, 2, 3).contiguous()
    got = funcol.all_to_all_single_autograd(
        chunks.reshape(tp * b, s // tp, dl), None, None, tp_group)
    return got.reshape(tp, b, s // tp, dl).permute(1, 2, 0, 3).reshape(
        b, s // tp, tp * dl)


def _fsdp_gather(bp: dict, dp_axis: str, specs: dict, dp_group) -> dict:
    """All-gather each FSDP-sharded (data-axis) dim before use."""
    out = {}
    for k, x in bp.items():
        spec = specs[k]
        dims = [d for d, e in enumerate(spec) if e == dp_axis or (
            isinstance(e, tuple) and dp_axis in e)]
        out[k] = _ag(x, dims[0], dp_group) if dims else x
    return out


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------

def manual_loss_fn(cfg: ArchConfig, mesh, dp_axes=("data",),
                   tp_axis: str = "model") -> tuple[Callable, dict]:
    """``(loss(params, batch), specs)``: ``params`` this rank's local
    shards by name (``param_specs_manual``' layouts), ``batch`` its
    shard of ``tokens`` and ``labels`` (batch over ``dp_axes``,
    replicated over ``tp_axis``); the loss is the global mean, the same
    on every rank."""
    _check_dense(cfg)
    pspecs = param_specs_manual(cfg)
    tp_group = mesh.get_group(tp_axis)
    dp_groups = [mesh.get_group(a) for a in dp_axes]
    tp = mesh.size(mesh_lib.axis_names(mesh).index(tp_axis))
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} heads do not divide over {tp} "
                         f"tensor-parallel ranks")
    tp_rank = mesh.get_local_rank(tp_axis)
    n_dp = 1
    for a in dp_axes:
        n_dp *= mesh.size(mesh_lib.axis_names(mesh).index(a))
    act = torch.bfloat16 if cfg.act_dtype == "bfloat16" else torch.float32
    remat = cfg.remat

    def loss(params: dict, batch: dict) -> torch.Tensor:
        h = _embed_seq_sharded(params["embed"], batch["tokens"], tp_group,
                               tp).to(act)
        for i in range(cfg.n_layers):
            prefix = f"layers.{i}."
            bp = {k[len(prefix):]: v for k, v in params.items()
                  if k.startswith(prefix)}
            specs = {k[len(prefix):]: s for k, s in pspecs.items()
                     if k.startswith(prefix)}

            def body(h, bp=bp, specs=specs):
                # FSDP: gather the data-sharded dim per use
                bp = _fsdp_gather(bp, dp_axes[-1], specs, dp_groups[-1])
                return _block(h, bp, cfg, tp_group, tp_rank, tp)

            if remat and torch.is_grad_enabled():
                h = checkpoint(body, h, use_reentrant=False)
            else:
                h = body(h)
        h = L.rms_norm(h, params["final_norm"])
        # the sequence-parallel region ends before the LM head: gather the
        # full sequence, so that every tensor-parallel rank holds the
        # same rows for the vocab-parallel CE
        h = _ag(h, 1, tp_group)                          # (B, S, d)
        head = _ag(params["head"], 0, dp_groups[-1])
        nll = _vocab_parallel_ce(h, head, batch["labels"], tp_group,
                                 tp_rank)
        # nll is the same on every tensor-parallel rank; average over the
        # data axes
        return sum_replicated(nll.mean(), dp_groups) / n_dp

    return loss, pspecs


def _sum_unnamed(grads: dict, specs: dict, mesh) -> dict:
    """Each gradient summed over the mesh axes its spec does not name
    (its parameter is replicated there): JAX's transpose of an unmapped
    ``shard_map`` input."""
    out = {}
    for k, g in grads.items():
        named = {a for e in specs[k] if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        for axis in mesh_lib.axis_names(mesh):
            if axis not in named and mesh.size(
                    mesh_lib.axis_names(mesh).index(axis)) > 1:
                g = funcol.wait_tensor(funcol.all_reduce(
                    g, "sum", mesh.get_group(axis)))
        out[k] = g
    return out


def make_manual_train_step(cfg: ArchConfig, mesh,
                           optimizer: optim.Optimizer):
    """``(step, specs)``: ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss": loss})`` on this rank's local shards (AdamW is
    elementwise, so it runs on shards as on the whole)."""
    dp_axes = tuple(a for a in ("pod", "data")
                    if a in mesh_lib.axis_names(mesh))
    loss_fn, pspecs = manual_loss_fn(cfg, mesh, dp_axes=dp_axes)

    def train_step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        grads = _sum_unnamed(grads, pspecs, mesh)
        with torch.no_grad():
            values = {k: p.detach() for k, p in params.items()}
            updates, opt_state2 = optimizer.update(grads, opt_state, values)
            params2 = optim.apply_updates(values, updates)
        return params2, opt_state2, {"loss": loss.detach()}

    return train_step, pspecs


def trace_manual_step(cfg: ArchConfig, mesh, batch: dict):
    """The dry run's ``--block-impl manual``: one manual step on this
    rank's fake local shards, traced (``roofline.trace_step``).
    ``batch`` holds DTensors of the batch specs."""
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import steps as ST

    _check_dense(cfg)
    cfg = dataclasses.replace(cfg, attn_impl="jnp")
    model = ST.abstract_params(cfg)
    specs = param_specs_manual(cfg)
    params = local_shards(dict(model.named_parameters()), specs, mesh)
    optimizer = optim.adamw(1e-4)
    opt_state = optimizer.init(params)
    local_batch = {k: v.to_local() for k, v in batch.items()
                   if k in ("tokens", "labels")}
    step, _ = make_manual_train_step(cfg, mesh, optimizer)
    return RL.trace_step(step, params, opt_state, local_batch)[1]

