"""Plain version of the 3xTF32 split (``csrc/mma.cuh``).

The ``featurize_gram`` and ``gram_project`` kernels run their fp32
products on the TF32 tensor cores: each fp32 operand ``a`` is split into
``hi = tf32(a)`` and ``lo = tf32(a - hi)``, and a product is
``lo_a hi_b + hi_a lo_b + hi_a hi_b`` in fp32.  These functions compute
the same split and products on any device, so that a test can hold the
kernels against it, and ``matmul_1xtf32`` (``hi_a hi_b`` alone) is the
negative control: a kernel whose ``lo`` products went missing lands
there.  No main path calls them.
"""
from __future__ import annotations

import torch

__all__ = ["tf32_round", "split_tf32", "matmul_3xtf32", "matmul_1xtf32"]

_HALF_ULP = 0x1000      # half a TF32 ulp, on the fp32 bit pattern
_KEEP = -0x2000         # 0xffffe000 as int32: sign, exponent, 10 bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, on the fp32 bit pattern: the rounding of
    ``cvt.rna.tf32.f32``.  Zeros, subnormals and signs are handled by the
    same integer step; inf and NaN are returned as they are."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _HALF_ULP) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, both
    fp32 tensors holding TF32 values; ``x - hi`` is exact in fp32 and
    ``hi + lo`` is within ``2^-22 |x|`` of ``x``."""
    hi = tf32_round(x.to(torch.float32))
    return hi, tf32_round(x.to(torch.float32) - hi)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An fp32 product of TF32 values: each product is exact in fp32, so
    only the fp32 sums round (TF32 matmul must be off on a card)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul_3xtf32 needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: ``lo_a hi_b + hi_a lo_b +
    hi_a hi_b``, the three products in fp32, summed in that order."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (_mm(a_lo, b_hi) + _mm(a_hi, b_lo)) + _mm(a_hi, b_hi)


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``hi_a hi_b`` alone: one TF32 product, the negative control."""
    return _mm(tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32)))
