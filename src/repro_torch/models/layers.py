"""Shared transformer building blocks, PyTorch port of
``src/repro/models/layers.py``.

Conventions (the reference's):
  * activations run in ``cfg.act_dtype`` (bf16 by default); norms and
    softmax accumulate in fp32;
  * initializers take an explicit ``torch.Generator`` and a fan-in.

JAX promotes mixed operand types in a matrix product (bf16 @ f32 -> f32);
``torch.matmul`` refuses them, so every product of the model zoo goes
through ``mm``, which promotes the same way.  Elementwise ops already
promote alike in both frameworks, Python scalars being weak in both.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["mm", "rms_norm", "rms_norm_init", "dense_init", "embed_init",
           "trunc_normal", "mlp_init", "mlp_apply", "rope", "gelu"]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion for mixed operands."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def trunc_normal(gen: torch.Generator, shape, std: float,
                 dtype=torch.float32) -> torch.Tensor:
    """``std`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(-2, 2)``), drawn on ``gen``'s device by
    inverting the normal CDF of a uniform draw.  The numbers differ from
    JAX's for the same seed; the distribution is the same."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (x * (math.sqrt(2.0) * std)).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32
               ) -> torch.Tensor:
    return trunc_normal(gen, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5,
                        dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return trunc_normal(gen, (vocab, d), d ** -0.5, dtype)


def rms_norm_init(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, variant: str = "swiglu",
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if variant == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_apply(p, x: torch.Tensor, variant: str = "swiglu") -> torch.Tensor:
    """``p`` holds ``w_up``, ``w_down`` (and ``w_gate`` for SwiGLU)."""
    up = mm(x, p.w_up)
    if variant == "swiglu":
        h = F.silu(mm(x, p.w_gate)) * up
    else:
        h = gelu(up)
    return mm(h, p.w_down)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Apply RoPE.  ``x (..., S, H, hd)``, ``positions (..., S)``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq            # (..., S, half)
    ang = ang[..., None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
