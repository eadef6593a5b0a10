"""Mesh-aware step factories and the abstract (shape-only) trees of every
(architecture x input shape), PyTorch port of ``src/repro/launch/steps.py``.

``input_specs(cfg, shape)`` gives the shape and dtype of every model
input; ``abstract_params``, ``abstract_opt_state`` and
``abstract_decode_state`` build their trees under ``FakeTensorMode``
(tensors with shapes and no data, the reference's ``jax.eval_shape``).
Decode shapes run ``make_serve_step`` (one token against a ``seq_len``
cache or recurrent state); train shapes ``make_train_step``; prefill
shapes ``make_prefill_step``.

For ``long_500k``, full-attention archs take their sliding-window variant
(``attn_window = long_context_window``); SSM and hybrid archs keep their
O(1)-state decode.

A step takes the model with its parameters placed as DTensors
(``sharding.attach``) and the inputs likewise, and hands the models a
``sharding.make_shard_fn`` constraint.  Plain tensors the models make on
the way (positions, masks) take part as replicated
(``implicit_replication``).  The train step is ``launch/train.py::
train_step`` under the mesh, with the port's ``optim``: the gradients
come back in their parameters' placements, AdamW's elementwise ops keep
them, and a clip's global norm comes out replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import optim
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TR
from repro_torch.models import encdec
from repro_torch.models.registry import get_model

__all__ = ["Spec", "variant_for_shape", "input_specs", "fake_mode",
           "abstract_params", "abstract_opt_state", "abstract_decode_state",
           "make_train_step", "make_prefill_step", "make_serve_step",
           "to_full"]


class Spec(NamedTuple):
    """An input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def variant_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Long-context decode on a full-attention arch -> SWA variant."""
    needs_swa = (shape.name == "long_500k" and cfg.encoder_layers == 0
                 and "attn" in cfg.block_pattern and cfg.local_window == 0
                 and cfg.attn_window == 0)
    if needs_swa:
        return dataclasses.replace(cfg, attn_window=cfg.long_context_window)
    return cfg


# ---------------------------------------------------------------------------
# Abstract (no-allocation) trees
# ---------------------------------------------------------------------------

def fake_mode():
    """The active ``FakeTensorMode``, or a new one to enter."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    active = detect_fake_mode()
    return contextlib.nullcontext(active) if active is not None \
        else FakeTensorMode()


def abstract_params(cfg: ArchConfig) -> torch.nn.Module:
    """The model with fake parameters (on the CPU device)."""
    with fake_mode():
        return get_model(cfg).init(0, device="cpu")


def abstract_opt_state(cfg: ArchConfig, optimizer: optim.Optimizer,
                       params) -> optim.OptState:
    del cfg
    with fake_mode():
        named = dict(params.named_parameters()) if isinstance(
            params, torch.nn.Module) else params
        return optimizer.init({k: p.detach() for k, p in named.items()})


def abstract_decode_state(cfg: ArchConfig, shape: InputShape) -> dict:
    m = get_model(cfg)
    b = shape.global_batch
    with fake_mode():
        if m.is_encdec:
            return encdec.init_decode_state(cfg, b, shape.seq_len,
                                            device="cpu")
        return m.init_decode_state(b, shape.seq_len, device="cpu")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, Spec]:
    """Shapes and dtypes of the step's data inputs."""
    b = shape.global_batch
    s = shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": Spec((b, s), tok), "labels": Spec((b, s), tok)}
        if cfg.encoder_layers:
            # enc-dec: frames into the encoder, tokens into the decoder.
            specs["frames"] = Spec((b, s, cfg.d_model), torch.bfloat16)
        if cfg.fuse_patches:
            p = max(1, int(s * cfg.patch_frac))
            specs["patch_embeds"] = Spec((b, p, cfg.d_model),
                                         torch.bfloat16)
            specs["patch_mask"] = Spec((b, s), torch.bool)
        return specs
    # decode: one new token
    return {"tokens": Spec((b, 1), tok)}


def to_full(t):
    """A DTensor's global value as a plain tensor (an all-gather); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, mesh, optimizer: optim.Optimizer,
                    opts: SH.ShardingOptions | None = None,
                    param_specs: dict | None = None,
                    clip_norm: float | None = None) -> Callable:
    """``step(model, opt_state, batch) -> (opt_state, {"loss": loss})``,
    the parameters updated in place.  The gradients are pinned to the
    parameters' placements (``param_specs``' where given, each
    parameter's own otherwise), so that the backward reduce-scatters into
    the FSDP layout and the update keeps it.  ``clip_norm`` clips the
    gradients to that global norm first, as ``launch/train.py`` does
    (the reference's step does not clip)."""
    m = get_model(cfg)
    shard = SH.make_shard_fn(mesh, opts)
    placements = None if param_specs is None else {
        k: SH.placements(mesh, s) for k, s in param_specs.items()}

    def train_step(model, opt_state, batch):
        with implicit_replication():
            opt_state, loss = TR.train_step(
                m, model, optimizer, opt_state, batch, shard=shard,
                grad_placements=placements, clip_norm=clip_norm)
        return opt_state, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh,
                      opts: SH.ShardingOptions | None = None) -> Callable:
    """Inference prefill: ``step(model, batch) -> logits (B, V)`` of the
    last position only (full-sequence logits at 32k x 256k vocab would
    be a 0.5 TB tensor)."""
    m = get_model(cfg)
    shard = SH.make_shard_fn(mesh, opts)

    def prefill_step(model, batch):
        with torch.no_grad(), implicit_replication():
            logits, _ = m.forward(model, batch, shard, last_only=True)
            return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ArchConfig, mesh,
                    opts: SH.ShardingOptions | None = None) -> Callable:
    """``step(model, state, batch) -> (next tokens (B,) int32, state)``:
    one greedy decode step of ``batch["tokens"] (B, 1)``."""
    m = get_model(cfg)
    shard = SH.make_shard_fn(mesh, opts)

    def serve_step(model, state, batch):
        with torch.no_grad(), implicit_replication():
            logits, state2 = m.decode_step(model, batch["tokens"], state,
                                           shard)
            next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)
        return next_tok, state2

    return serve_step
