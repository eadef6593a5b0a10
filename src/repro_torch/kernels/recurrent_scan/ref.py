"""Plain PyTorch versions of the recurrent-scan kernels.

Both are the sequential fp32 recurrences of the reference's oracles
(``src/repro/kernels/recurrent_scan/ref.py``), step for step what the
CUDA kernels compute:

* ``wkv_ref`` — the RWKV-6 time-mix state recurrence: matrix state
  ``S (hd_k, hd_v)`` per head, diagonal data-dependent decay, bonus
  ``u`` on the current token;
* ``linear_scan_ref`` — the RG-LRU per-channel recurrence
  ``h_t = exp(log_a_t) h_{t-1} + x_t``.
"""
from __future__ import annotations

import torch

__all__ = ["wkv_ref", "linear_scan_ref"]


def wkv_ref(r, k, v, logw, u, state):
    """``r/k/v/logw (B, S, H, hd)``, ``u (H, hd)``, ``state (B, H, hd, hd)``
    -> ``(out (B, S, H, hd) f32, final state f32)``."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    u = u.float()[None, :, :, None]
    s = state.float()
    outs = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * a))
        s = torch.exp(logw[:, t])[..., None] * s + a
    return torch.stack(outs, dim=1), s


def linear_scan_ref(log_a, x, h0):
    """``log_a/x (B, S, D)``, ``h0 (B, D)`` -> ``(h (B, S, D) f32,
    h_last (B, D) f32)``."""
    log_a, x = log_a.float(), x.float()
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = torch.exp(log_a[:, t]) * h + x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
