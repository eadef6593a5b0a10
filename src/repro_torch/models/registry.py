"""Model registry, PyTorch port of ``src/repro/models/registry.py``: an
``ArchConfig`` bound to its stack (decoder-only, or encoder-decoder when
``encoder_layers > 0``) as a uniform bundle for the launchers, the
serving engine and the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer

__all__ = ["ModelBundle", "get_model"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable               # (generator=0, device="cuda") -> module
    forward: Callable            # (model, batch, shard=None,
    #                              last_only=False) -> (logits, aux)
    loss_fn: Callable            # (model, batch, shard=None) -> scalar
    init_decode_state: Callable  # (batch, max_len, per_slot=False,
    #                               device="cuda") -> state
    decode_step: Callable        # (model, tokens, state, shard=None)
    #                              -> (logits, state)
    is_encdec: bool
    # Serving fast path (decoder-only; None for encoder-decoder models):
    decode_hidden: Callable | None = None  # -> (normed hidden (B, 1, d),
    #                                           state)
    prefill_chunk: Callable | None = None  # (model, tokens (B, C), state,
    #                   start, valid, shard=None) -> (h (B, C, d), state)


def _shard(shard):
    """The activation constraint a bundle passes on: the identity when
    none is given, as in the reference."""
    return shard or transformer._id_shard


def get_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.encoder_layers > 0:
        # as the reference's bundle: max_len is the source length
        return ModelBundle(
            cfg=cfg,
            init=lambda generator=0, device="cuda": encdec.init(
                cfg, generator, device),
            forward=lambda m, batch, shard=None, last_only=False:
                encdec.forward(cfg, m, batch, _shard(shard), last_only),
            loss_fn=lambda m, batch, shard=None: encdec.loss_fn(
                cfg, m, batch, _shard(shard)),
            init_decode_state=lambda batch, max_len, per_slot=False,
            device="cuda": encdec.init_decode_state(cfg, batch, max_len,
                                                    device=device),
            decode_step=lambda m, tokens, state, shard=None:
                encdec.decode_step(cfg, m, tokens, state, _shard(shard)),
            is_encdec=True,
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda generator=0, device="cuda": transformer.init(
            cfg, generator, device),
        forward=lambda m, batch, shard=None, last_only=False:
            transformer.forward(cfg, m, batch, _shard(shard), last_only),
        loss_fn=lambda m, batch, shard=None: transformer.loss_fn(
            cfg, m, batch, _shard(shard)),
        init_decode_state=lambda batch, max_len, per_slot=False,
        device="cuda": transformer.init_decode_state(cfg, batch, max_len,
                                                     per_slot, device),
        decode_step=lambda m, tokens, state, shard=None:
            transformer.decode_step(cfg, m, tokens, state, _shard(shard)),
        is_encdec=False,
        decode_hidden=lambda m, tokens, state, shard=None:
            transformer.decode_hidden(cfg, m, tokens, state, _shard(shard)),
        prefill_chunk=lambda m, tokens, state, start, valid, shard=None:
            transformer.prefill_chunk(cfg, m, tokens, state, start, valid,
                                      _shard(shard)),
    )
