"""Public wrapper for the flash attention kernel
(``csrc/flash_attention.cu``).

Keeps the reference's contract (``src/repro/kernels/flash_attention/
ops.py``): ``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` with the KV heads
already group-expanded to ``H``, causal, sliding-window or bidirectional
masks, ``scale = hd^-0.5``, fp32 softmax statistics and ``p @ v`` in
fp32, output in ``q.dtype``.  The kernel reads and writes the
``(B, S, H, hd)`` layout in place of the reference's flattened
``(BH, S, hd)``, and masks ragged edges, so any ``S`` and ``Skv`` run on
the card: where the reference falls back to its oracle for sequences
or head dims off the 128 grid, the port's kernel takes ``hd`` in
``HEAD_DIMS`` and raises for any other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ref import flash_ref

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 64, 128, 256)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the kernel's
    16-byte loads need: a view whose storage offset breaks the alignment
    is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` -> ``(B, S, H, hd)``."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not dispatch.on_cuda(q, k, v):
        return flash_ref(q, k, v, causal=causal, window=window)
    b, s, h, hd = q.shape
    skv = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes float32 or bfloat16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the grid's 65535")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            skv, h, hd, hd ** -0.5, int(causal), int(window),
            int(q.dtype == torch.bfloat16), dispatch.stream_of(q))
    build.check(rc, "flash_attention")
    dispatch.count_launch("flash_attention")
    return out
