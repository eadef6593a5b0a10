"""Model registry, PyTorch port of ``src/repro/models/registry.py``: an
``ArchConfig`` bound to its stack as a uniform bundle for the launchers,
the serving engine and the tests.  Decoder-only configs; encoder-decoder
configs wait for ROADMAP Queue 1 item 14 and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

__all__ = ["ModelBundle", "get_model"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable               # (generator=0, device="cuda") -> LM
    forward: Callable            # (model, batch, last_only=False)
    #                              -> (logits, aux)
    loss_fn: Callable            # (model, batch) -> scalar
    init_decode_state: Callable  # (batch, max_len, per_slot=False,
    #                               device="cuda") -> state
    decode_step: Callable        # (model, tokens, state) -> (logits, state)
    is_encdec: bool
    decode_hidden: Callable      # -> (normed hidden (B, 1, d), state)
    prefill_chunk: Callable      # (model, tokens (B, C), state, start, valid)
    #                              -> (h (B, C, d), state)


def get_model(cfg: ArchConfig) -> ModelBundle:
    transformer.check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda generator=0, device="cuda": transformer.init(
            cfg, generator, device),
        forward=lambda m, batch, last_only=False: transformer.forward(
            cfg, m, batch, last_only),
        loss_fn=lambda m, batch: transformer.loss_fn(cfg, m, batch),
        init_decode_state=lambda batch, max_len, per_slot=False,
        device="cuda": transformer.init_decode_state(cfg, batch, max_len,
                                                     per_slot, device),
        decode_step=lambda m, tokens, state: transformer.decode_step(
            cfg, m, tokens, state),
        is_encdec=False,
        decode_hidden=lambda m, tokens, state: transformer.decode_hidden(
            cfg, m, tokens, state),
        prefill_chunk=lambda m, tokens, state, start, valid:
            transformer.prefill_chunk(cfg, m, tokens, state, start, valid),
    )
