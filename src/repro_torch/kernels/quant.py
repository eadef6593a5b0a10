"""Symmetric quantization of the membership directory.

Copies ``src/repro/kernels/quant.py``.  The prototype table ``(T, d, d)``
is stored in f32, bf16 (2x smaller, no scales) or int8 (4x smaller) with
one symmetric scale per prototype:

  scale_t = max(|P_t|) / 127          (zero entries get scale 1)
  Q_t     = clip(round(P_t / scale_t), -127, 127)  int8
  P_t     ~ Q_t * scale_t

The assign kernel applies the scale in its epilogue, so the f32 table
never has to exist at serving time.  The int8 codes and scales equal the
reference's bit for bit: fp32 division, round half to even, clip.

Helpers take numpy arrays or tensors and return the same family.  numpy
has no bfloat16 type, so the numpy family stores a bf16 table as its bit
patterns in ``uint16`` (rounded to nearest even, as the reference's
``ml_dtypes`` cast rounds); ``dequantize_directory`` reads them back.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DIRECTORY_DTYPES", "quantize_directory", "dequantize_directory",
           "directory_nbytes"]

DIRECTORY_DTYPES = ("f32", "bf16", "int8")
_INT8_MAX = 127.0


def _np_to_bf16_bits(p: np.ndarray) -> np.ndarray:
    bits = torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy()
    return bits.view(np.uint16)


def _np_from_bf16_bits(q: np.ndarray) -> np.ndarray:
    return (np.asarray(q, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_directory(p, dtype: str):
    """``(T, ...) f32 -> (table, scales | None)`` in the directory dtype.

    int8 returns per-entry symmetric scales ``(T,) f32``; f32 and bf16
    return ``scales=None`` (a plain cast).  All-zero entries quantize
    exactly (scale pinned to 1, so dequantization returns zeros).
    """
    if dtype not in DIRECTORY_DTYPES:
        raise ValueError(f"directory dtype must be one of "
                         f"{DIRECTORY_DTYPES}, got {dtype!r}")
    if isinstance(p, torch.Tensor):
        p = p.to(torch.float32)
        if dtype == "f32":
            return p, None
        if dtype == "bf16":
            return p.to(torch.bfloat16), None
        flat = p.reshape(p.shape[0], -1)
        amax = flat.abs().amax(dim=1)
        scales = torch.where(amax > 0, amax / _INT8_MAX,
                             torch.ones_like(amax))
        q = torch.clamp(torch.round(flat / scales[:, None]), -_INT8_MAX,
                        _INT8_MAX)
        return q.to(torch.int8).reshape(p.shape), scales
    p = np.asarray(p, np.float32)
    if dtype == "f32":
        return p, None
    if dtype == "bf16":
        return _np_to_bf16_bits(p), None
    flat = p.reshape(p.shape[0], -1)
    amax = np.max(np.abs(flat), axis=1)
    scales = np.where(amax > 0, amax / _INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(flat / scales[:, None]), -_INT8_MAX, _INT8_MAX)
    return q.astype(np.int8).reshape(p.shape), scales


def dequantize_directory(q, scales=None):
    """Inverse of ``quantize_directory``: back to f32 (exact for f32 and
    bf16 tables; the int8 rounding is the only loss)."""
    if isinstance(q, torch.Tensor):
        out = q.to(torch.float32)
        if scales is None:
            return out
        return out * scales.to(torch.float32).reshape(
            (-1,) + (1,) * (out.ndim - 1))
    q = np.asarray(q)
    out = (_np_from_bf16_bits(q) if q.dtype == np.uint16
           else q.astype(np.float32))
    if scales is None:
        return out
    return out * np.reshape(np.asarray(scales, np.float32),
                            (-1,) + (1,) * (out.ndim - 1))


def directory_nbytes(table, scales=None) -> int:
    """Serving-directory footprint in bytes (table + scales)."""
    def nbytes(a) -> int:
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return int(np.asarray(a).nbytes)

    return nbytes(table) + (0 if scales is None else nbytes(scales))
