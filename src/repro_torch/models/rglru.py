"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
PyTorch port of ``src/repro/models/rglru.py``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                 # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)                 # input gate
    log a_t = -c * r_t * softplus(Lambda)        # a_t = a^(c r_t), a=sig(-L)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``impl="scan"`` runs the reference's associative scan as a log-depth
(Hillis-Steele) scan in torch ops; ``impl="pallas"`` the ``linear_scan``
kernel (``kernels/recurrent_scan``: the CUDA kernel for CUDA tensors,
its plain version on the CPU).  Decode is the O(1) single-step update.
The block wraps the RG-LRU with a causal depthwise conv1d (width 4) and
a GeLU gating branch, as in the paper.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import on_local_shards
from repro_torch.kernels.recurrent_scan import linear_scan
from repro_torch.models import layers as L

__all__ = ["RGLRUConfig", "rglru_block_init", "rglru_block_apply",
           "rglru_block_step", "init_rglru_state"]


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int = 0             # defaults to d_model
    conv_width: int = 4
    c: float = 8.0
    impl: str = "scan"         # scan (associative) | pallas (kernel)

    @property
    def rnn_dim(self) -> int:
        return self.d_rnn or self.d_model


def rglru_block_init(gen, cfg: RGLRUConfig, dtype=torch.float32) -> dict:
    d, dr = cfg.d_model, cfg.rnn_dim
    dev = gen.device
    # Lambda so that a = sigmoid(Lambda) in (0.9, 0.999) (paper init).
    lam = torch.log(torch.exp(torch.linspace(2.2, 6.9, dr,
                                             dtype=torch.float32,
                                             device=dev)) - 1.0)
    return {
        "w_in_x": L.dense_init(gen, d, dr, dtype),
        "w_in_y": L.dense_init(gen, d, dr, dtype),
        "conv_w": L.trunc_normal(gen, (cfg.conv_width, dr),
                                 (1.0 / cfg.conv_width) ** 0.5, dtype),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_a": L.dense_init(gen, dr, dr, dtype),
        "b_a": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_i": L.dense_init(gen, dr, dr, dtype),
        "b_i": torch.zeros((dr,), dtype=dtype, device=dev),
        "lam": lam.to(dtype),
        "w_out": L.dense_init(gen, dr, d, dtype),
    }


def _gates(p, u):
    """u (B, S, dr) -> (log_a, gated input), both fp32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p.w_a.float() + p.b_a.float())
    i = torch.sigmoid(uf @ p.w_i.float() + p.b_i.float())
    log_a = -8.0 * r * F.softplus(p.lam.float())
    a2 = torch.exp(2.0 * log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * uf)
    return log_a, x_in


def _conv1d_causal(p, u, conv_state=None):
    """Depthwise causal conv of width W.  ``conv_state (B, W-1, dr)``
    carries context across calls."""
    w = p.conv_w.to(u.dtype)                       # (W, dr)
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)              # (B, S+W-1, dr)
    out = sum(full[:, i:i + u.shape[1], :] * w[i] for i in range(width))
    return out + p.conv_b.to(u.dtype), full[:, -(width - 1):, :]


def _associative_scan(log_a, x):
    """``h_t = exp(log_a_t) h_{t-1} + x_t`` along axis 1 with h_{-1} = 0,
    by log-depth doubling over the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 + a2, exp(a2) b1 + b2)``."""
    a, b = log_a, x
    shift = 1
    while shift < a.shape[1]:
        b = torch.cat([b[:, :shift],
                       torch.exp(a[:, shift:]) * b[:, :-shift] + b[:, shift:]],
                      dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] + a[:, shift:]], dim=1)
        shift *= 2
    return b


def init_rglru_state(cfg: RGLRUConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.rnn_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_dim),
                            dtype=dtype, device=device),
    }


def rglru_block_apply(p, cfg: RGLRUConfig, x: torch.Tensor,
                      state: dict | None = None,
                      valid: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """Training / prefill.  ``x (B, S, d)`` -> (y (B, S, d), new state).

    ``valid (B, S)`` bool marks live positions of ragged right-padded
    chunks (serving prefill): pad positions are identity updates
    (``log_a`` and ``x_in`` zeroed: a = 1, input 0) and the conv carry is
    gathered at each row's last valid inputs, so the final state equals
    a per-row unpadded run.  Pad-position outputs are garbage.
    """
    b, s, _ = x.shape
    if state is None:
        state = init_rglru_state(cfg, b, device=x.device)
    y_branch = L.gelu(L.mm(x, p.w_in_y))
    u_in = L.mm(x, p.w_in_x)
    u, conv_state = _conv1d_causal(p, u_in, state["conv"])
    log_a, x_in = _gates(p, u)
    if valid is not None:
        vm = valid[:, :, None]
        log_a = torch.where(vm, log_a, 0.0)
        x_in = torch.where(vm, x_in, 0.0)
        # conv carry = the last (W-1) valid conv inputs per row: token p
        # sits at index p + W - 1 of [prev_carry | u_in], so a row with
        # n valid tokens wants indices n .. n + W - 2 (n = 0 keeps the
        # incoming carry).
        width = p.conv_w.shape[0]
        full = torch.cat([state["conv"].to(u_in.dtype), u_in], dim=1)
        n_valid = valid.sum(dim=1)
        idx = n_valid[:, None] + torch.arange(width - 1,
                                              device=x.device)[None, :]
        conv_state = full.gather(1, idx[..., None].expand(-1, -1,
                                                          full.shape[2]))

    if cfg.impl == "pallas" and s > 1:
        h, h_last = on_local_shards(
            "linear_scan", linear_scan, (log_a, x_in, state["h"]),
            ("bsc", "bsc", "bc"), ("bsc", "bc"), local="bc")
    else:
        # the incoming carry folds into the first element
        x_in = torch.cat([x_in[:, :1] + torch.exp(log_a[:, :1])
                          * state["h"][:, None], x_in[:, 1:]], dim=1)
        h = _associative_scan(log_a, x_in)
        h_last = h[:, -1, :]
    out = L.mm(h.to(x.dtype) * y_branch, p.w_out)
    return out, {"h": h_last, "conv": conv_state}


def rglru_block_step(p, cfg: RGLRUConfig, x: torch.Tensor, state: dict
                     ) -> tuple[torch.Tensor, dict]:
    """Decode: ``x (B, 1, d)`` with O(1) state."""
    y_branch = L.gelu(L.mm(x, p.w_in_y))
    u = L.mm(x, p.w_in_x)
    u, conv_state = _conv1d_causal(p, u, state["conv"])
    log_a, x_in = _gates(p, u)
    h = torch.exp(log_a[:, 0, :]) * state["h"] + x_in[:, 0, :]
    out = L.mm(h[:, None, :].to(x.dtype) * y_branch, p.w_out)
    return out, {"h": h, "conv": conv_state}
