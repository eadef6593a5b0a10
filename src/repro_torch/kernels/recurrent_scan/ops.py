"""Public wrappers for the recurrent-scan kernels
(``csrc/recurrent_scan.cu``).

``wkv_chunked`` keeps the calling convention of the reference's
``src/repro/kernels/recurrent_scan/ops.py::wkv_chunked`` (``(B, S, H,
hd)`` operands, matrix state ``(B, H, hd, hd)``; out in ``r.dtype``,
final state in fp32) so that ``models/rwkv6.py`` routes to it with
``impl="pallas"``; ``linear_scan`` is the RG-LRU scan (``h`` and
``h_last`` in fp32).  The kernels read the operands in their layout and
mask ragged edges, where the reference pads the head, channel and
sequence axes to its tiles; they have fixed tiles, so the reference's
``chunk`` and ``block_d`` have no counterpart.  The scan's load route
resolves through ``tuning.get_blocks`` (``resolve_scan`` checks a tuned
one).

The wkv kernel computes the chunk form over sub-chunks of 16 tokens
(``ref.wkv_chunked_ref`` is its plain version): under
``compute_dtype="bf16"`` it rounds the operands the reference's kernel
rounds and runs its products on bf16 tensor cores, under ``"fp32"`` it
keeps fp32 products; the state is fp32 under both.  The reference's
``linear_scan`` takes a ``compute_dtype`` that its only caller leaves at
fp32; the port has none, and its scan steps in fp32.  The scan kernel
streams its operands through a ring of stages in shared memory, by TMA
where it can (``linear_scan_plan``).  Neither kernel has a backward: on
CUDA inputs that require grad under grad mode both wrappers raise
(``dispatch.refuse_grad``); their plain versions on the CPU stay
differentiable.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, dispatch, tuning
from repro_torch.kernels.recurrent_scan.ref import (COMPUTE_DTYPES,
                                                    linear_scan_ref,
                                                    wkv_chunked_ref)

#: Channels a scan block owns (one warp, a lane a channel), tokens a
#: stage of its ring, and stages in the ring.
SCAN_CHANNELS, SCAN_TOKENS, SCAN_STAGES = 32, 128, 4


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The scan kernel's launch for ``(b, s, d)``: ``tokens`` a stage,
    ``stages`` in the ring, the ``route`` ("tma": operands in and h out by
    TMA, where a row is a multiple of 16 bytes, ``s > 0`` and the operands
    start 16-byte aligned; else "cp.async4": 4-byte ``cp.async`` in and
    plain stores out; the tuner may pick either where both fit), the
    block's ``smem`` (the ring, two output stages
    and the barriers) and the ``blocks`` (batch x 32-channel tiles)."""
    tokens: int
    stages: int
    route: str
    smem: int
    blocks: int


def linear_scan_plan(b: int, s: int, d: int, aligned: bool = True
                     ) -> ScanPlan:
    if min(b, s, d) < 0:
        raise ValueError(f"bad shape ({b}, {s}, {d})")
    route = "tma" if aligned and d % 4 == 0 and s > 0 else "cp.async4"
    stage = SCAN_TOKENS * SCAN_CHANNELS * 4
    smem = SCAN_STAGES * (2 * stage + 8) + 2 * stage
    return ScanPlan(SCAN_TOKENS, SCAN_STAGES, route, smem,
                    b * -(-d // SCAN_CHANNELS))


def resolve_scan(blocks: dict, s: int, d: int, aligned: bool) -> dict:
    """A plan whose ``route`` came from the tuner's cache, checked as the
    kernel checks it: "tma" needs a row a multiple of 16 bytes, ``s > 0``
    and 16-byte aligned operands.  Raises ``ValueError`` on one that does
    not fit."""
    route = blocks["route"]
    if route not in ("tma", "cp.async4"):
        raise ValueError(f"linear_scan: route must be 'tma' or 'cp.async4', "
                         f"got {route!r}")
    if route == "tma" and not (aligned and d % 4 == 0 and s > 0):
        raise ValueError(f"linear_scan: the TMA route needs d % 4 == 0, "
                         f"s > 0 and 16-byte aligned operands (d={d}, "
                         f"s={s}, aligned={aligned})")
    return blocks


def kernel_scan_plan(b: int, s: int, d: int, aligned: bool = True
                     ) -> ScanPlan:
    """The C side's plan, to hold ``linear_scan_plan`` against (builds the
    kernel library)."""
    tokens, stages, tma = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = build.library().repro_linear_scan_plan(
        b, s, d, int(aligned), ctypes.byref(tokens), ctypes.byref(stages),
        ctypes.byref(tma))
    return ScanPlan(tokens.value, stages.value,
                    "tma" if tma.value else "cp.async4", smem,
                    b * -(-d // SCAN_CHANNELS))


#: Head dims the wkv kernel is instantiated for (hd / 4 warps a block,
#: the first hd / 8 holding 8 value columns of the state each).
WKV_HEAD_DIMS = (32, 64)


def wkv_chunked(r, k, v, logw, u, state, *, compute_dtype: str = "bf16"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV: ``r/k/v/logw (B, S, H, hd)``, ``u (H, hd)``,
    ``state (B, H, hd, hd)`` -> ``(out (B, S, H, hd) in r.dtype, final
    state (B, H, hd, hd) f32)``, in the chunk form with the compute
    dtype's roundings (``wkv_chunked_ref``)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"r, k, v, logw must share one (B, S, H, hd) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, hd = r.shape
    if u.shape != (h, hd) or state.shape != (b, h, hd, hd):
        raise ValueError(f"u must be ({h}, {hd}) and state ({b}, {h}, {hd}, "
                         f"{hd}), got {tuple(u.shape)} and "
                         f"{tuple(state.shape)}")
    if not dispatch.on_cuda(r, k, v, logw, u, state):
        out, st = wkv_chunked_ref(r, k, v, logw, u, state,
                                  compute_dtype=compute_dtype)
        return out.to(r.dtype), st
    dispatch.refuse_grad("wkv_chunked", r, k, v, logw, u, state)
    if hd not in WKV_HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes head dims {WKV_HEAD_DIMS}, "
                         f"got {hd}")
    if r.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"the wkv kernel takes float32 or bfloat16 r, k, v "
                        f"of one dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    r, k, v, logw = (dispatch.aligned16(t_)
                     for t_ in (r, k, v, logw.float()))
    u, state = (t_.float().contiguous() for t_ in (u, state))
    out = torch.empty_like(r)
    st = torch.empty_like(state)
    if b * h == 0:
        return out, st
    lib = build.library()
    with torch.cuda.device(r.device):
        rc = lib.repro_wkv(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           logw.data_ptr(), u.data_ptr(), state.data_ptr(),
                           out.data_ptr(), st.data_ptr(), b, s, h, hd,
                           int(r.dtype == torch.bfloat16),
                           int(compute_dtype == "bf16"),
                           dispatch.stream_of(r))
    build.check(rc, "wkv_chunked")
    dispatch.count_launch("wkv_chunked")
    return out, st


def linear_scan(log_a, x, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(log_a_t) h_{t-1} + x_t`` per channel, in fp32: ``log_a/x
    (B, S, D)``, ``h0 (B, D)`` -> ``(h (B, S, D) f32, h_last (B, D)
    f32)``."""
    if x.ndim != 3 or log_a.shape != x.shape \
            or h0.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"bad shapes log_a={tuple(log_a.shape)} "
                         f"x={tuple(x.shape)} h0={tuple(h0.shape)}")
    if not dispatch.on_cuda(log_a, x, h0):
        return linear_scan_ref(log_a, x, h0)
    dispatch.refuse_grad("linear_scan", log_a, x, h0)
    b, s, d = x.shape
    log_a, x, h0 = (t.float().contiguous() for t in (log_a, x, h0))
    h = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if b * d == 0:
        return h, h_last
    aligned = log_a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    plan = ScanPlan(**tuning.get_blocks(
        "linear_scan", lambda blocks: resolve_scan(blocks, s, d, aligned),
        x.device, b=b, s=s, d=d, aligned=int(aligned)))
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_linear_scan(log_a.data_ptr(), x.data_ptr(),
                                   h0.data_ptr(), h.data_ptr(),
                                   h_last.data_ptr(), b, s, d,
                                   int(plan.route == "tma"),
                                   dispatch.stream_of(x))
    build.check(rc, "linear_scan")
    dispatch.count_launch("linear_scan", recorded=True)
    return h, h_last
