"""Encoder-decoder transformer (seamless-m4t backbone), PyTorch port of
``src/repro/models/encdec.py``.

The modality frontend (mel-spectrogram + conv feature extractor) is a
stub, as in the reference: ``batch["frames"] (B, S_src, d_model)`` are
precomputed frame embeddings.  The encoder is a bidirectional
transformer over frames; the decoder a causal transformer with
cross-attention to the encoder's output.

The parameters live in an ``EncDec`` module under the reference's
names: ``frame_proj``, ``embed``, ``enc`` (one block a layer: ``ln1``,
``attn``, ``ln2``, ``ffn``), ``enc_norm``, ``dec`` (``ln1``, ``self``,
``ln2``, ``cross``, ``ln3``, ``ffn``), ``final_norm`` and ``head``.

Decode: ``encode`` runs once; ``decode_state_from_memory`` computes every
decoder layer's cross-attention K/V from its output, and ``decode_step``
then generates one token against that memory and the decoder's own
self-attention cache.  The state is the reference's: ``mem_k``,
``mem_v`` ``(n_dec, B, S_src, K, hd)``, ``self`` ``{k, v: (n_dec, B,
self_len, K, hd)}`` (updated in place) and a Python-int ``length``.

Training is ``models/transformer.py``'s: ``model.requires_grad_(True)``
turns gradients on, ``forward`` and ``loss_fn`` are differentiable on
the plain attention path, and ``cfg.remat`` wraps each encoder and
decoder layer in ``torch.utils.checkpoint`` while a gradient is taken.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Params, _dt, _id_shard, embed,
                                            remat_active)

__all__ = ["EncDec", "init", "from_trees", "encode", "forward", "loss_fn",
           "init_decode_state", "decode_state_from_memory", "decode_step"]


def _acfg(cfg: ArchConfig, causal: bool) -> A.AttnConfig:
    return A.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        qk_norm=cfg.qk_norm, causal=causal,
                        rope_theta=cfg.rope_theta, impl=cfg.attn_impl)


class EncDec(nn.Module):
    """The encoder-decoder's parameters, under the reference's names."""

    def __init__(self, top: dict, enc: list[dict], dec: list[dict]):
        super().__init__()
        for key in ("frame_proj", "embed", "enc_norm", "final_norm", "head"):
            self.register_parameter(
                key, nn.Parameter(top[key], requires_grad=False))
        self.enc = nn.ModuleList(Params(tree) for tree in enc)
        self.dec = nn.ModuleList(Params(tree) for tree in dec)


def _enc_block_init(cfg: ArchConfig, gen, dtype) -> dict:
    dev = gen.device
    return {"ln1": L.rms_norm_init(cfg.d_model, dtype, dev),
            "attn": A.attn_init(gen, _acfg(cfg, False), dtype),
            "ln2": L.rms_norm_init(cfg.d_model, dtype, dev),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                              dtype)}


def _dec_block_init(cfg: ArchConfig, gen, dtype) -> dict:
    dev = gen.device
    return {"ln1": L.rms_norm_init(cfg.d_model, dtype, dev),
            "self": A.attn_init(gen, _acfg(cfg, True), dtype),
            "ln2": L.rms_norm_init(cfg.d_model, dtype, dev),
            "cross": A.attn_init(gen, _acfg(cfg, False), dtype),
            "ln3": L.rms_norm_init(cfg.d_model, dtype, dev),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                              dtype)}


def from_trees(cfg: ArchConfig, top: dict, enc: list[dict],
               dec: list[dict]) -> EncDec:
    """An ``EncDec`` from tensors: ``top`` the five unstacked leaves,
    ``enc`` and ``dec`` one parameter dict per layer, in layer order."""
    if (len(enc), len(dec)) != (cfg.encoder_layers, cfg.n_layers):
        raise ValueError(f"{len(enc)} + {len(dec)} layer trees for "
                         f"{cfg.encoder_layers} + {cfg.n_layers} layers")
    return EncDec(top, enc, dec)


def init(cfg: ArchConfig, generator: torch.Generator | int = 0,
         device: str | torch.device = "cuda") -> EncDec:
    """Random parameters, drawn on the device from ``generator`` (a seed
    makes one there); the reference's distributions, not its draws."""
    if isinstance(generator, int):
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(generator)
    dtype = _dt(cfg.param_dtype)
    dev = generator.device
    top = {"frame_proj": L.dense_init(generator, cfg.d_model, cfg.d_model,
                                      dtype),
           "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dtype),
           "enc_norm": L.rms_norm_init(cfg.d_model, dtype, dev),
           "final_norm": L.rms_norm_init(cfg.d_model, dtype, dev),
           "head": L.dense_init(generator, cfg.d_model, cfg.vocab, dtype)}
    enc = [_enc_block_init(cfg, generator, dtype)
           for _ in range(cfg.encoder_layers)]
    dec = [_dec_block_init(cfg, generator, dtype)
           for _ in range(cfg.n_layers)]
    return from_trees(cfg, top, enc, dec)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _norm(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A block input: ``h`` normed, and on a mesh gathered over its
    sequence once before the products that read it (the reference puts
    no ``interior`` constraint in this model)."""
    return L.gather_inner(L.rms_norm(h, scale))


def encode(cfg: ArchConfig, model: EncDec, frames: torch.Tensor,
           shard=_id_shard) -> torch.Tensor:
    """``frames (B, S_src, d)`` -> the normed encoder output (B, S_src, d).
    ``shard(x, name)`` constrains activations (the identity by
    default)."""
    h = L.mm(frames.to(_dt(cfg.act_dtype)), model.frame_proj)
    h = shard(h, "activation")
    positions = _positions(h.shape[0], h.shape[1], h.device)
    acfg = _acfg(cfg, False)

    def body(h, bp):
        a = A.attention(bp.attn, acfg, _norm(h, bp.ln1), positions)
        h = h + shard(a, "residual")
        f = L.mlp_apply(bp.ffn, _norm(h, bp.ln2), cfg.mlp_variant)
        return h + shard(f, "residual")

    remat = remat_active(cfg, model)
    for bp in model.enc:
        h = checkpoint(body, h, bp, use_reentrant=False) if remat \
            else body(h, bp)
    return L.rms_norm(h, model.enc_norm)


def forward(cfg: ArchConfig, model: EncDec, batch: dict, shard=_id_shard,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch["frames"] (B, S_src, d)``, ``batch["tokens"] (B, S)`` ->
    (logits, aux = 0).  ``last_only=True`` computes the final position's
    logits only."""
    # the keys and values of every layer's cross-attention: gathered
    # over the sequence once
    memory = L.gather_inner(encode(cfg, model, batch["frames"], shard))
    tokens = batch["tokens"]
    h = shard(embed(cfg, model, tokens), "activation")
    positions = _positions(tokens.shape[0], tokens.shape[1], h.device)
    self_cfg, cross_cfg = _acfg(cfg, True), _acfg(cfg, False)

    def body(h, bp, memory):
        a = A.attention(bp.self, self_cfg, _norm(h, bp.ln1), positions)
        h = h + shard(a, "residual")
        c = A.attention(bp.cross, cross_cfg, _norm(h, bp.ln2),
                        positions, kv_x=memory)
        h = h + shard(c, "residual")
        f = L.mlp_apply(bp.ffn, _norm(h, bp.ln3), cfg.mlp_variant)
        return h + shard(f, "residual")

    remat = remat_active(cfg, model)
    for bp in model.dec:
        h = checkpoint(body, h, bp, memory, use_reentrant=False) if remat \
            else body(h, bp, memory)
    if last_only:
        h = h[:, -1:, :]
    h = _norm(h, model.final_norm)
    return shard(L.mm(h, model.head), "logits"), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def loss_fn(cfg: ArchConfig, model: EncDec, batch: dict, shard=_id_shard
            ) -> torch.Tensor:
    logits, _ = forward(cfg, model, batch, shard)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[..., None]).mean()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, src_len: int,
                      self_len: int = 1024,
                      device: str | torch.device = "cuda") -> dict:
    """Decode state with zero cross memory (``decode_state_from_memory``
    fills ``mem_k`` / ``mem_v`` from a real encoder pass)."""
    dev = resolve_device(device)
    dtype = _dt(cfg.act_dtype)
    kv = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.head_dim)
    caches = [A.init_cache(_acfg(cfg, True), batch, self_len, dtype, dev)
              for _ in range(cfg.n_layers)]
    return {"mem_k": torch.zeros(kv, dtype=dtype, device=dev),
            "mem_v": torch.zeros(kv, dtype=dtype, device=dev),
            "self": {n: torch.stack([c[n] for c in caches])
                     for n in ("k", "v")},
            "length": 0}


def decode_state_from_memory(cfg: ArchConfig, model: EncDec,
                             memory: torch.Tensor, self_len: int = 1024
                             ) -> dict:
    """The decode state for an encoder output ``memory (B, S_src, d)``.
    As in the reference, the self cache takes ``init_decode_state``'s
    default length: ``self_len`` is not passed on."""
    del self_len
    cross_cfg = _acfg(cfg, False)
    state = init_decode_state(cfg, memory.shape[0], memory.shape[1],
                              device=memory.device)
    for i, bp in enumerate(model.dec):
        k, v = A.memory_kv(bp.cross, cross_cfg, memory)
        state["mem_k"][i] = k.to(state["mem_k"].dtype)
        state["mem_v"][i] = v.to(state["mem_v"].dtype)
    return state


def decode_step(cfg: ArchConfig, model: EncDec, tokens: torch.Tensor,
                state: dict, shard=_id_shard) -> tuple[torch.Tensor, dict]:
    """One decode step: ``tokens (B, 1)`` -> (logits (B, 1, V), state).
    As in the reference, only the embedding and the logits are
    constrained; the self-attention cache is not."""
    h = shard(embed(cfg, model, tokens), "activation")
    length = state["length"]
    self_cfg, cross_cfg = _acfg(cfg, True), _acfg(cfg, False)
    for i, bp in enumerate(model.dec):
        cache = {"k": state["self"]["k"][i], "v": state["self"]["v"][i]}
        a, _ = A.decode_step(bp.self, self_cfg, L.rms_norm(h, bp.ln1), cache,
                             length)
        h = h + a
        h = h + A.cross_decode(bp.cross, cross_cfg, L.rms_norm(h, bp.ln2),
                               state["mem_k"][i], state["mem_v"][i])
        h = h + L.mlp_apply(bp.ffn, L.rms_norm(h, bp.ln3), cfg.mlp_variant)
    new_state = dict(state)
    new_state["length"] = length + 1
    h = L.rms_norm(h, model.final_norm)
    return shard(L.mm(h, model.head), "logits"), new_state
