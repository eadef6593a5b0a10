"""Plain PyTorch versions of the recurrent-scan kernels.

* ``wkv_ref`` — the RWKV-6 time-mix state recurrence, the sequential
  fp32 oracle of the reference (``src/repro/kernels/recurrent_scan/
  ref.py``): matrix state ``S (hd_k, hd_v)`` per head, diagonal
  data-dependent decay, bonus ``u`` on the current token;
* ``wkv_chunked_ref`` — the same function in the chunk form the CUDA
  kernel computes (sub-chunks of 16 tokens, the state passed between
  them), with its roundings under ``compute_dtype="bf16"``;
* ``linear_scan_ref`` — the RG-LRU per-channel recurrence
  ``h_t = exp(log_a_t) h_{t-1} + x_t``, step for step what its kernel
  computes.
"""
from __future__ import annotations

import torch

__all__ = ["wkv_ref", "wkv_chunked_ref", "linear_scan_ref"]

COMPUTE_DTYPES = ("fp32", "bf16")


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


def wkv_chunked_ref(r, k, v, logw, u, state, *, sub: int = 16,
                    compute_dtype: str = "bf16"):
    """``wkv_ref``'s function in the chunk form: ``r/k/v/logw (B, S, H,
    hd)``, ``u (H, hd)``, ``state (B, H, hd, hd)`` -> ``(out (B, S, H, hd)
    f32, final state f32)``.

    Per sub-chunk of ``sub`` tokens, with ``cum`` the running sum of
    ``logw`` (summed token by token), ``cum_prev`` that of the token before
    (0 for the first) and ``cum_last`` that of the last:
    ``o = (r e^{cum_prev}) S + W v + (r . (u k)) v`` with
    ``W[t, s] = sum_i r[t,i] e^{min(cum_prev[t,i] - cum[s,i], 0)} k[s,i]``
    for ``s < t``, and ``S' = e^{cum_last} S + (k e^{min(cum_last - cum,
    0)})^T v``.  Under ``"bf16"`` the operands the reference's kernel rounds
    are rounded to bf16 (``r e^{cum_prev}``, ``S`` in that product, ``r``,
    each pairwise decay and ``k`` in ``W``, ``W``, ``v``, ``k
    e^{cum_last - cum}``) and every product sums in fp32; the bonus, the
    decay of ``S`` and the state stay fp32.
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if sub < 1:
        raise ValueError(f"sub must be positive, got {sub}")
    if compute_dtype == "bf16":
        def rnd(x):
            return x.to(torch.bfloat16).float()
    else:
        def rnd(x):
            return x
    # (B, H, S, hd) in fp32
    r, k, v, logw = (t.float().transpose(1, 2) for t in (r, k, v, logw))
    u = u.float()[None, :, None, :]
    s = state.float()
    outs = []
    for t0 in range(0, r.shape[2], sub):
        rc, kc, vc, lw = (t[:, :, t0:t0 + sub] for t in (r, k, v, logw))
        n = rc.shape[2]
        cum = torch.empty_like(lw)
        acc = torch.zeros_like(lw[:, :, 0])
        for t in range(n):
            acc = acc + lw[:, :, t]
            cum[:, :, t] = acc
        cum_prev = torch.cat([torch.zeros_like(acc)[:, :, None],
                              cum[:, :, :-1]], dim=2)
        o_state = rnd(rc * torch.exp(cum_prev)) @ rnd(s)
        a = torch.exp(torch.clamp_max(cum_prev[:, :, :, None, :]
                                      - cum[:, :, None, :, :], 0.0))
        w = ((rnd(rc)[:, :, :, None, :] * rnd(a)) * rnd(kc)[:, :, None, :, :]
             ).sum(-1)                                       # (B, H, n, n)
        tri = torch.ones((n, n), dtype=torch.bool, device=w.device).tril(-1)
        w = torch.where(tri, w, torch.zeros((), device=w.device))
        o_intra = rnd(w) @ rnd(vc)
        bonus = ((rc * u) * kc).sum(-1, keepdim=True)
        outs.append((o_state + o_intra) + bonus * vc)
        k_dec = rnd(kc * torch.exp(torch.clamp_max(acc[:, :, None, :] - cum,
                                                   0.0)))
        s = torch.exp(acc)[..., None] * s + k_dec.transpose(-1, -2) @ rnd(vc)
    if not outs:
        return torch.zeros_like(r).transpose(1, 2), s
    return torch.cat(outs, dim=2).transpose(1, 2), s


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
