"""GQA attention, PyTorch port of ``src/repro/models/attention.py``:
training / prefill (causal, sliding-window, bidirectional, cross) and
decode against a KV cache (full or rolling-window) or against an
encoder's memory.

Layouts:
  q (B, S, H, hd)   k/v (B, S, K, hd)   K = n_kv_heads, G = H // K groups.
  full cache:    {k, v: (B, S_max, K, hd)}  + scalar or per-row length
  rolling cache: {k, v: (B, W, K, hd)}      + scalar length (absolute)

RoPE is applied at write time (keys stored rotated).  Softmax in fp32,
logits from fp32 products of the operands (JAX's
``preferred_element_type=f32``).  ``impl``: ``"jnp"`` is the plain
einsum path (the reference's name, kept so that configs carry over),
``"chunked"`` the online-softmax loop over KV chunks, ``"pallas"`` the
flash kernel (``kernels/flash_attention``: the CUDA kernel for CUDA
tensors, its plain version on the CPU).

Decode writes the new keys and values into the cache tensors in place
(the reference's donated buffers) and returns the same tensors.
Cross-attention (``attention(kv_x=)``, ``memory_kv``, ``cross_decode``)
takes its keys and values from another sequence, without rope and
without a causal mask (the encoder-decoder models, ``models/encdec.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import structural_mask
from repro_torch.models import layers as L

__all__ = ["AttnConfig", "attn_init", "attention", "decode_step",
           "decode_chunk", "init_cache", "multi_query_attention",
           "chunked_attention", "cross_decode", "memory_kv"]

NEG_INF = -2.0 ** 30  # large-negative for masking (bf16-safe)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: int = 0            # 0 = full attention; >0 = sliding window
    causal: bool = True
    rope_theta: float = 10000.0
    impl: str = "jnp"          # jnp (plain einsum) | chunked | pallas


def attn_init(gen, cfg: AttnConfig, dtype=torch.float32,
              kv_dim: int | None = None) -> dict:
    """``kv_dim``: the source width of cross-attention K/V (defaults to
    d_model)."""
    kv_dim = kv_dim or cfg.d_model
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim,
                           dtype),
        "wk": L.dense_init(gen, kv_dim, cfg.n_kv_heads * cfg.head_dim,
                           dtype),
        "wv": L.dense_init(gen, kv_dim, cfg.n_kv_heads * cfg.head_dim,
                           dtype),
        "wo": L.dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model,
                           dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rms_norm_init(cfg.head_dim, dtype, gen.device)
        p["k_norm"] = L.rms_norm_init(cfg.head_dim, dtype, gen.device)
    return p


def _project_qkv(p, cfg: AttnConfig, x, kv_x=None):
    kv_x = x if kv_x is None else kv_x
    b, s = x.shape[:2]
    sk = kv_x.shape[1]
    q = L.mm(x, p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.mm(kv_x, p.wk).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = L.mm(kv_x, p.wv).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p.q_norm)
        k = L.rms_norm(k, p.k_norm)
    return q, k, v


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*G, hd) by repeat (GQA group expansion)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def multi_query_attention(q, k, v, mask) -> torch.Tensor:
    """Core attention.  q (B,S,H,hd), k/v (B,Sk,H,hd), mask (B|1,1|H,S,Sk)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v.to(q.dtype))


def chunked_attention(q, k, v, causal: bool, window: int = 0,
                      chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention as a loop over KV chunks (the reference's
    ``lax.scan``): peak memory O(S * chunk).  Same contract as the einsum
    path; a ``Skv`` that is not a chunk multiple takes the einsum path,
    as in the reference."""
    b, s, h, hd = q.shape
    skv = k.shape[1]
    c = min(chunk, skv)
    if skv % c:
        return multi_query_attention(
            q, k, v, structural_mask(s, skv, causal, window, q.device))
    scale = hd ** -0.5
    qf = q.float() * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for start in range(0, skv, c):
        kc = k[:, start:start + c].float()
        vc = v[:, start:start + c].float()
        sij = torch.einsum("bshd,bthd->bhst", qf, kc)
        kpos = start + torch.arange(c, device=q.device)[None, :]
        mask = torch.ones((s, c), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= (qpos - kpos) < window
        sij = torch.where(mask[None, None], sij, NEG_INF)
        m_new = torch.maximum(m, sij.amax(dim=-1))
        p = torch.where(mask[None, None], torch.exp(sij - m_new[..., None]),
                        0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(p, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor | None = None,
              kv_x: torch.Tensor | None = None,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Training / prefill path.  ``x (B, S, d)`` -> ``(B, S, d)``.
    ``kv_x (B, Skv, d_kv)`` makes it cross-attention: keys and values
    from ``kv_x``, no rope, no causal mask."""
    b, s = x.shape[:2]
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    is_cross = kv_x is not None
    causal = cfg.causal and not is_cross
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if not is_cross:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    groups = cfg.n_heads // cfg.n_kv_heads
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    if cfg.impl == "pallas" and mask is None:
        out = flash_attention(q, k, v, causal=causal, window=cfg.window)
    elif cfg.impl == "chunked" and mask is None:
        out = chunked_attention(q, k, v, causal=causal, window=cfg.window)
    else:
        if mask is None:
            # the reference's training mask: no window without causality
            mask = structural_mask(s, k.shape[1], causal,
                                   cfg.window if causal else 0, x.device)
        out = multi_query_attention(q, k, v, mask)
    return L.mm(out.reshape(b, s, -1), p.wo)


# ---------------------------------------------------------------------------
# Decode against a KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Cache dict.  For SWA (cfg.window > 0) the cache is the rolling
    window."""
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _grouped_attention(p, cfg: AttnConfig, q, ck, cv, mask):
    """Grouped-head attention over the cache without expanding it:
    ``q (B, C, H, hd)``, ``ck/cv (B, T, K, hd)``, ``mask`` broadcast to
    ``(B, K, G, C, T)``."""
    b, c = q.shape[:2]
    groups = cfg.n_heads // cfg.n_kv_heads
    scale = q.shape[-1] ** -0.5
    qg = q.reshape(b, c, cfg.n_kv_heads, groups, cfg.head_dim)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), ck.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv.to(q.dtype))
    return L.mm(out.reshape(b, c, -1), p.wo)


def decode_step(p, cfg: AttnConfig, x: torch.Tensor, cache: dict, length
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  ``x (B, 1, d)``, ``length`` = #tokens already
    cached: a Python int, or a per-row ``(B,)`` tensor (the slot-serving
    layout), which delegates to ``decode_chunk`` with a one-token chunk
    (full caches only).  Returns (out (B, 1, d), cache)."""
    if isinstance(length, torch.Tensor) and length.ndim == 1:
        return decode_chunk(p, cfg, x, cache, length)
    length = int(length)
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (length % size) if cfg.window else length
    slot = min(slot, size - 1)         # dynamic_update_slice clamps
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

    idx = torch.arange(size, device=x.device)
    if cfg.window:
        valid = (idx <= slot) | (length >= size)   # rolling occupancy
    else:
        valid = idx <= length
    out = _grouped_attention(p, cfg, q, cache["k"], cache["v"],
                             valid[None, None, None, None, :])
    return out, cache


def decode_chunk(p, cfg: AttnConfig, x: torch.Tensor, cache: dict, lengths
                 ) -> tuple[torch.Tensor, dict]:
    """Multi-token decode / prefill against a full KV cache with per-row
    write positions: ``x (B, C, d)``, ``lengths (B,)`` (or a scalar) =
    #tokens already cached per row.  Token ``t`` of row ``b`` lands at
    ``lengths[b] + t``; the causal mask admits exactly the cache prefix
    up to that position, so right-padded rows are exact without a
    validity mask (garbage written past a row's true length is never
    attended before it is overwritten)."""
    if cfg.window:
        raise ValueError("decode_chunk serves full caches only "
                         "(cfg.window > 0 uses a rolling cache)")
    b, c = x.shape[:2]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=x.device).expand(b)
    positions = lengths[:, None] + torch.arange(c, dtype=torch.int32,
                                                device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)

    size = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)[:, None]
    slots = positions.clamp(0, size - 1).long()
    cache["k"][rows, slots] = k.to(cache["k"].dtype)
    cache["v"][rows, slots] = v.to(cache["v"].dtype)

    idx = torch.arange(size, device=x.device)
    mask = idx[None, None, :] <= positions[:, :, None]       # (B, C, size)
    out = _grouped_attention(p, cfg, q, cache["k"], cache["v"],
                             mask[:, None, None])
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention decode against an encoder's memory
# ---------------------------------------------------------------------------

def cross_decode(p, cfg: AttnConfig, x: torch.Tensor,
                 memory_k: torch.Tensor, memory_v: torch.Tensor
                 ) -> torch.Tensor:
    """Cross-attention of one new token ``x (B, 1, d)`` against
    precomputed encoder memory ``memory_k/v (B, S_src, K, hd)``
    (``memory_kv``, computed once and reused every step)."""
    b = x.shape[0]
    q = L.mm(x, p.wq).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p.q_norm)
    groups = cfg.n_heads // cfg.n_kv_heads
    kk = _expand_kv(memory_k, groups)
    vv = _expand_kv(memory_v, groups)
    mask = torch.ones((1, 1, 1, kk.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = multi_query_attention(q, kk, vv, mask)
    return L.mm(out.reshape(b, 1, -1), p.wo)


def memory_kv(p, cfg: AttnConfig, memory: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of an encoder output ``memory (B, S, d)``."""
    b, s = memory.shape[:2]
    k = L.mm(memory, p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.mm(memory, p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = L.rms_norm(k, p.k_norm)
    return k, v
