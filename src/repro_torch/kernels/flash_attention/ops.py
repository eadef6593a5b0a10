"""Public wrapper for the flash attention kernels
(``csrc/flash_attention_tc.cu`` and ``csrc/flash_attention.cu``).

Keeps the reference's contract (``src/repro/kernels/flash_attention/
ops.py``): ``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` with the KV heads
already group-expanded to ``H``, causal, sliding-window or bidirectional
masks, ``scale = hd^-0.5``, fp32 softmax statistics and ``p @ v`` in
fp32, output in ``q.dtype``.  The kernels read and write the
``(B, S, H, hd)`` layout in place of the reference's flattened
``(BH, S, hd)``, and mask ragged edges, so any ``S`` and ``Skv`` run on
the card: where the reference falls back to its oracle for sequences
or head dims off the 128 grid, the port's kernels take ``hd`` in
``HEAD_DIMS`` and raise for any other.

The input dtype alone chooses the kernel (``kernel_entry``): bf16 runs
on the tensor cores (``mma.sync``, with p split into two bf16 parts so
that ``p @ v`` keeps fp32 p), fp32 on the CUDA cores.  The kernels
have no backward: on CUDA inputs that require grad under grad mode the
wrapper raises (``dispatch.refuse_grad``); the plain version on the CPU
stays differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ref import flash_ref

#: Head dims the kernels are instantiated for.
HEAD_DIMS = (16, 32, 64, 128, 256)

#: Input dtype -> the C entry point of the kernel that takes it.
_ENTRIES = {torch.bfloat16: "repro_flash_attention_tc",
            torch.float32: "repro_flash_attention"}


def kernel_entry(dtype: torch.dtype) -> str:
    """The C entry point for q, k, v of ``dtype``: bf16 -> the
    tensor-core kernel, fp32 -> the CUDA-core kernel."""
    if dtype not in _ENTRIES:
        raise TypeError(f"the flash kernels take float32 or bfloat16 q, k, "
                        f"v, got {dtype}")
    return _ENTRIES[dtype]


def _check(q, k, v, window: int) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k, v, causal: bool, window: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    dispatch.refuse_grad("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    skv = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    entry = kernel_entry(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernels take q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the grid's 65535")
    q, k, v = (dispatch.aligned16(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            skv, h, hd, hd ** -0.5, int(causal), int(window)]
    if entry == "repro_flash_attention_tc":
        args.append(int(out_dtype == torch.float32))
    lib = build.library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(*args, dispatch.stream_of(q))
    build.check(rc, "flash_attention")
    dispatch.count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q (B, S, H, hd)``, ``k/v (B, Skv, H, hd)`` -> ``(B, S, H, hd)``."""
    _check(q, k, v, window)
    if not dispatch.on_cuda(q, k, v):
        return flash_ref(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window, q.dtype)


def _flash_attention_fp32_out(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """The tensor-core kernel on bf16 inputs with its output left in fp32:
    the fp32 function of the bf16 values, without the output rounding
    that hides an error in ``p @ v``.  For the card's checks only."""
    _check(q, k, v, window)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the fp32-output check takes bf16 q, k, v, got "
                        f"{q.dtype}")
    if not dispatch.on_cuda(q, k, v):
        return flash_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    return _launch(q, k, v, causal, window, torch.float32)
