"""Decoder-only transformer stack, PyTorch port of
``src/repro/models/transformer.py``: dense (GQA), MoE, SSM (RWKV-6),
hybrid (RG-LRU + local attention) layer patterns, and early-fusion VLM
inputs.

The parameters live in an ``LM`` module: ``embed``, ``final_norm``,
``head``, ``patch_proj`` (``fuse_patches`` configs only) and ``layers``,
a ``ModuleList`` of one ``Block`` per layer in the reference's order
(its pattern groups, then its remainder layers).
Each ``Block`` mirrors the reference's nested parameter dict key for key
(``block.attn.wq``, ``block.time.mu``, ...), so that
``convert.lm_params_from_reference`` is a walk over the reference's
keys.  The reference scans its stacked pattern groups; here the layers
run in a loop.  The functions below take the ``ArchConfig`` and the
``LM``, as the reference's take the config and the parameter tree:

  init(cfg, generator)                  -> LM
  forward(cfg, model, batch)            -> (logits, aux)
  loss_fn(cfg, model, batch)            -> scalar
  init_decode_state(cfg, batch, max_len)-> state
  decode_step(cfg, model, tokens, state)-> (logits, new state)

A decode state is ``{"length": ..., "layers": [one state per layer]}``;
``length`` is a Python int (uniform batch) or a per-row ``(B,)`` int32
tensor (slot serving).  KV caches are updated in place.

Parameters are built with ``requires_grad=False``, so that serving
records no graph; the train path (``launch/train.py``) turns gradients
on with ``model.requires_grad_(True)``.  ``forward`` and ``loss_fn`` are
differentiable on the plain paths (``attn_impl="jnp"``, ``rec_impl``
``chunked`` or ``scan``), as the reference trains; the kernels have no
backward and raise on inputs that need one.  With ``cfg.remat`` set and
a gradient to take, each layer of the pattern groups runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of a
group), which changes no value.

``batch``: {"tokens" (B, S), "labels" (B, S)}; VLM fusion adds
{"patch_embeds" (B, P, d), "patch_mask" (B, S) bool}: masked positions
take the projected patch embeddings, in order (early fusion).  An
attention block of an MoE config (``n_experts > 0``) has an MoE ``ffn``
(``models/moe.py``), whose load-balancing losses ``forward`` sums into
its ``aux``.  Encoder-decoder configs are ``models/encdec.py``'s.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R

__all__ = ["LM", "Block", "init", "from_trees", "forward", "loss_fn",
           "init_decode_state", "decode_step", "decode_hidden",
           "prefill_chunk", "block_apply", "embed", "layer_kinds",
           "attn_config", "rwkv_config", "rglru_config", "moe_config",
           "remat_active"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def layer_kinds(cfg: ArchConfig) -> tuple[str, ...]:
    """Block kinds in layer order: the pattern repeated ``n_groups`` times,
    then the reference's remainder layers (``rest_kinds``)."""
    return tuple(cfg.block_pattern) * cfg.n_groups + tuple(cfg.rest_kinds)


# ---------------------------------------------------------------------------
# Per-kind block configs
# ---------------------------------------------------------------------------

def attn_config(cfg: ArchConfig, hybrid_local: bool = False) -> A.AttnConfig:
    window = cfg.local_window if hybrid_local else cfg.attn_window
    return A.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        qk_norm=cfg.qk_norm, window=window,
                        rope_theta=cfg.rope_theta, impl=cfg.attn_impl)


def rwkv_config(cfg: ArchConfig) -> R.RWKVConfig:
    return R.RWKVConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                        head_dim=cfg.rwkv_head_dim, chunk=cfg.rwkv_chunk,
                        impl=cfg.rec_impl or "chunked")


def rglru_config(cfg: ArchConfig) -> G.RGLRUConfig:
    impl = "pallas" if cfg.rec_impl == "pallas" else "scan"
    return G.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_rnn, impl=impl)


def moe_config(cfg: ArchConfig) -> M.MoEConfig:
    return M.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor,
                       mlp_variant=cfg.mlp_variant)


def _attn_cfg(cfg: ArchConfig) -> A.AttnConfig:
    return attn_config(cfg, hybrid_local=len(cfg.block_pattern) > 1)


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A node of the parameter tree: tensors become parameters and dicts
    child nodes, under the reference's keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, Params(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))


class Block(Params):
    """One layer's parameters, with its kind (``attn``, ``rec``, ``rwkv``)."""

    def __init__(self, kind: str, tree: dict):
        super().__init__(tree)
        self.kind = kind


class LM(nn.Module):
    """The decoder's parameters: embedding, layers, final norm and head,
    and the patch projection of a fusion config."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor, blocks: list[Block],
                 patch_proj: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.head = nn.Parameter(head, requires_grad=False)
        if patch_proj is not None:
            self.patch_proj = nn.Parameter(patch_proj, requires_grad=False)
        self.layers = nn.ModuleList(blocks)


def _block_init(cfg: ArchConfig, kind: str, gen, dtype) -> dict:
    dev = gen.device
    if kind == "attn":
        ffn = M.moe_init(gen, moe_config(cfg), dtype) if cfg.n_experts \
            else L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                            dtype)
        return {"ln1": L.rms_norm_init(cfg.d_model, dtype, dev),
                "attn": A.attn_init(gen, _attn_cfg(cfg), dtype),
                "ln2": L.rms_norm_init(cfg.d_model, dtype, dev),
                "ffn": ffn}
    if kind == "rec":
        return {"ln1": L.rms_norm_init(cfg.d_model, dtype, dev),
                "rec": G.rglru_block_init(gen, rglru_config(cfg), dtype),
                "ln2": L.rms_norm_init(cfg.d_model, dtype, dev),
                "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                  cfg.mlp_variant, dtype)}
    if kind == "rwkv":
        return R.rwkv_block_init(gen, rwkv_config(cfg), dtype)
    raise ValueError(f"unknown block kind {kind!r}")


def from_trees(cfg: ArchConfig, top: dict, blocks: list[dict]) -> LM:
    """An ``LM`` from tensors: ``top`` holds ``embed``, ``final_norm``,
    ``head`` and, for a fusion config, ``patch_proj``; ``blocks`` one
    parameter dict per layer, in layer order."""
    if cfg.encoder_layers > 0:
        raise ValueError("an encoder-decoder config is models/encdec.py's")
    kinds = layer_kinds(cfg)
    if len(blocks) != len(kinds):
        raise ValueError(f"{len(blocks)} layer trees for {len(kinds)} layers")
    return LM(top["embed"], top["final_norm"], top["head"],
              [Block(kind, tree) for kind, tree in zip(kinds, blocks)],
              top["patch_proj"] if cfg.fuse_patches else None)


def init(cfg: ArchConfig, generator: torch.Generator | int = 0,
         device: str | torch.device = "cuda") -> LM:
    """Random parameters, drawn on the device from ``generator`` (a seed
    makes one there).  The draws differ from the reference's ``jax.random``
    ones; the distributions are the reference's."""
    if isinstance(generator, int):
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(generator)
    dtype = _dt(cfg.param_dtype)
    top = {"embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dtype),
           "final_norm": L.rms_norm_init(cfg.d_model, dtype,
                                         generator.device),
           "head": L.dense_init(generator, cfg.d_model, cfg.vocab, dtype)}
    if cfg.fuse_patches:
        top["patch_proj"] = L.dense_init(generator, cfg.d_model, cfg.d_model,
                                         dtype)
    blocks = [_block_init(cfg, kind, generator, dtype)
              for kind in layer_kinds(cfg)]
    return from_trees(cfg, top, blocks)


# ---------------------------------------------------------------------------
# Blocks: train / prefill, decode step, chunked prefill
# ---------------------------------------------------------------------------

def _id_shard(x, name):
    del name
    return x


def _ffn(cfg: ArchConfig, block, h, moe: bool = False, shard=_id_shard):
    """``h`` plus the block's feed-forward of ``ln2(h)``, and its aux loss
    (0 but for an MoE ``ffn``, which only attention blocks have).  The
    normed input is a block ``interior``, the output a ``residual``."""
    hn = shard(L.rms_norm(h, block.ln2), "interior")
    if moe and cfg.n_experts:
        f, aux = M.moe_apply(block.ffn, moe_config(cfg), hn)
        return h + shard(f, "residual"), aux
    return h + shard(L.mlp_apply(block.ffn, hn, cfg.mlp_variant),
                     "residual"), 0.0


def block_apply(cfg: ArchConfig, kind: str, block, h: torch.Tensor,
                positions: torch.Tensor, shard=_id_shard
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Training / prefill block (fresh recurrent state): (h, aux loss).
    ``shard(x, name)`` constrains the block's interiors and residuals."""
    if kind == "attn":
        a = A.attention(block.attn, _attn_cfg(cfg),
                        shard(L.rms_norm(h, block.ln1), "interior"),
                        positions)
        return _ffn(cfg, block, h + shard(a, "residual"), True, shard)
    if kind == "rec":
        r, _ = G.rglru_block_apply(block.rec, rglru_config(cfg),
                                   shard(L.rms_norm(h, block.ln1),
                                         "interior"))
        return _ffn(cfg, block, h + shard(r, "residual"), shard=shard)
    if kind == "rwkv":
        y, _ = R.rwkv_block_apply(block, rwkv_config(cfg), h)
        return shard(y, "residual"), 0.0
    raise ValueError(kind)


def _block_state_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      dtype, device) -> dict:
    if kind == "attn":
        return A.init_cache(_attn_cfg(cfg), batch, max_len, dtype, device)
    if kind == "rec":
        return G.init_rglru_state(rglru_config(cfg), batch, dtype, device)
    if kind == "rwkv":
        st = R.init_rwkv_state(rwkv_config(cfg), batch, device=device)
        # token-shift carries live in the activation dtype; wkv stays fp32
        st["shift_att"] = st["shift_att"].to(dtype)
        st["shift_ffn"] = st["shift_ffn"].to(dtype)
        return st
    raise ValueError(kind)


def _block_step(cfg: ArchConfig, kind: str, block, h, state, length,
                shard=_id_shard):
    """Single-token decode block."""
    if kind == "attn":
        a, cache = A.decode_step(block.attn, _attn_cfg(cfg),
                                 L.rms_norm(h, block.ln1), state, length,
                                 shard)
        return _ffn(cfg, block, h + a, True)[0], cache
    if kind == "rec":
        r, st = G.rglru_block_step(block.rec, rglru_config(cfg),
                                   L.rms_norm(h, block.ln1), state)
        return _ffn(cfg, block, h + r)[0], st
    if kind == "rwkv":
        return R.rwkv_block_step(block, rwkv_config(cfg), h, state)
    raise ValueError(kind)


def _block_chunk(cfg: ArchConfig, kind: str, block, h, state, start, valid,
                 shard=_id_shard):
    """Chunked teacher-forced prefill block: ``h (B, C, d)`` against live
    decode state.  ``start`` = absolute position of the chunk's first
    token; ``valid (B, C)`` masks each row's live positions so recurrent
    state updates stay exact under right padding (attention needs no
    mask: pad writes land past a row's true length and are overwritten
    before they become visible)."""
    if kind == "attn":
        a, cache = A.decode_chunk(block.attn, _attn_cfg(cfg),
                                  L.rms_norm(h, block.ln1), state, start,
                                  shard)
        return _ffn(cfg, block, h + a, True)[0], cache
    if kind == "rec":
        r, st = G.rglru_block_apply(block.rec, rglru_config(cfg),
                                    L.rms_norm(h, block.ln1), state, valid)
        return _ffn(cfg, block, h + r)[0], st
    if kind == "rwkv":
        return R.rwkv_block_apply(block, rwkv_config(cfg), h, state, valid)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def embed(cfg: ArchConfig, model: LM, tokens: torch.Tensor,
          patch_embeds: torch.Tensor | None = None,
          patch_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings in the activation dtype.  A fusion config given
    ``patch_embeds (B, P, d)`` and ``patch_mask (B, S)`` puts the
    projected patches at the masked positions, in order: the j-th masked
    position of a row takes patch ``min(j, P - 1)``."""
    h = L.lookup_rows(model.embed, tokens).to(_dt(cfg.act_dtype))
    if cfg.fuse_patches and patch_embeds is not None:
        pe = L.mm(patch_embeds.to(h.dtype), model.patch_proj)
        mask = patch_mask.bool()
        idx = torch.cumsum(mask.int(), dim=1) - 1
        idx = idx.clamp(0, pe.shape[1] - 1).long()
        gathered = torch.gather(pe, 1, idx[..., None].expand(
            -1, -1, pe.shape[-1]))
        h = torch.where(mask[..., None], gathered, h)
    return h


def remat_active(cfg: ArchConfig, model: nn.Module) -> bool:
    """Whether a forward of ``model`` rematerialises its layers: the
    config asks for it and a gradient is being taken."""
    return cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in model.parameters())


def forward(cfg: ArchConfig, model: LM, batch: dict, shard=_id_shard,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch["tokens"] (B, S)`` (and a fusion config's
    ``patch_embeds``, ``patch_mask``) -> (logits, aux): aux is the sum of
    the MoE layers' load-balancing losses, fp32.  ``last_only=True``
    computes logits for the final position only (the serving prefill).
    ``shard(x, name)`` constrains activations (``launch/sharding.py``);
    the identity by default."""
    tokens = batch["tokens"]
    h = shard(embed(cfg, model, tokens, batch.get("patch_embeds"),
                    batch.get("patch_mask")), "activation")
    b, s = tokens.shape
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # the reference rematerialises its pattern groups, not the remainder
    n_remat = cfg.n_groups * len(cfg.block_pattern) \
        if remat_active(cfg, model) else 0
    for i, block in enumerate(model.layers):
        if i < n_remat:
            h, aux_l = checkpoint(block_apply, cfg, block.kind, block, h,
                                  positions, shard, use_reentrant=False)
        else:
            h, aux_l = block_apply(cfg, block.kind, block, h, positions,
                                   shard)
        aux = aux + aux_l
    if last_only:
        h = h[:, -1:, :]
    h = L.gather_inner(L.rms_norm(h, model.final_norm))
    return shard(L.mm(h, model.head), "logits"), aux


def loss_fn(cfg: ArchConfig, model: LM, batch: dict, shard=_id_shard,
            aux_weight: float = 0.01) -> torch.Tensor:
    logits, aux = forward(cfg, model, batch, shard)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      per_slot: bool = False,
                      device: str | torch.device = "cuda") -> dict:
    """``per_slot=True`` keeps a per-row ``length (batch,)`` so that every
    row (serving slot) decodes at its own depth; the default Python-int
    length is the uniform-batch decode path."""
    dev = resolve_device(device)
    dtype = _dt(cfg.act_dtype)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev) \
        if per_slot else 0
    return {"length": length,
            "layers": [_block_state_init(cfg, kind, batch, max_len, dtype,
                                         dev) for kind in layer_kinds(cfg)]}


def decode_hidden(cfg: ArchConfig, model: LM, tokens: torch.Tensor,
                  state: dict, shard=_id_shard) -> tuple[torch.Tensor, dict]:
    """One decode step up to the final norm: ``tokens (B, 1)`` ->
    (normed hidden (B, 1, d), new state).  The head is left to the
    caller, so that serving can swap per-cluster heads over the shared
    trunk."""
    h = shard(embed(cfg, model, tokens), "activation")
    length = state["length"]
    new_layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, st = _block_step(cfg, block.kind, block, h, st, length, shard)
        new_layers.append(st)
    return (L.rms_norm(h, model.final_norm),
            {"length": length + 1, "layers": new_layers})


def decode_step(cfg: ArchConfig, model: LM, tokens: torch.Tensor,
                state: dict, shard=_id_shard) -> tuple[torch.Tensor, dict]:
    """One decode step: ``tokens (B, 1)`` -> (logits (B, 1, V), state)."""
    h, state = decode_hidden(cfg, model, tokens, state, shard)
    return shard(L.mm(h, model.head), "logits"), state


def prefill_chunk(cfg: ArchConfig, model: LM, tokens: torch.Tensor,
                  state: dict, start: int, valid: torch.Tensor,
                  shard=_id_shard) -> tuple[torch.Tensor, dict]:
    """Teacher-forced prefill of a C-token chunk: ``tokens (B, C)``
    right-padded, ``start`` = the chunk's absolute base position,
    ``valid (B, C)`` = per-row liveness.  Returns the pre-norm hidden
    ``(B, C, d)`` (the caller gathers each row's last valid position and
    applies the final norm and head once) and the advanced state
    (``length`` grows by each row's valid count).  Needs a per-slot
    state."""
    h = shard(embed(cfg, model, tokens), "activation")
    counts = valid.sum(dim=1, dtype=torch.int32)
    new_layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, st = _block_chunk(cfg, block.kind, block, h, st, start, valid,
                             shard)
        new_layers.append(st)
    return h, {"length": state["length"] + counts, "layers": new_layers}
