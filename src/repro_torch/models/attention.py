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
import functools

import torch

from repro_torch.kernels.dispatch import on_local_shards
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
    q = L.split_heads(L.mm(x, p.wq), cfg.n_heads, cfg.head_dim)
    k = L.split_last(L.mm(kv_x, p.wk), cfg.n_kv_heads, cfg.head_dim,
                     replicate="kv_heads")
    v = L.split_last(L.mm(kv_x, p.wv), cfg.n_kv_heads, cfg.head_dim,
                     replicate="kv_heads")
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
    s = x.shape[1]
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    is_cross = kv_x is not None
    causal = cfg.causal and not is_cross
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if not is_cross:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    groups = cfg.n_heads // cfg.n_kv_heads
    # (query heads a mesh axis does not divide come padded: keys and
    # values get zero heads to match)
    k = L.pad_heads(_expand_kv(k, groups), q.shape[2])
    v = L.pad_heads(_expand_kv(v, groups), q.shape[2])
    # Sharded q/k/v reach the attention core as their local (batch,
    # head) shards; the kernel takes them as they come, the plain paths
    # trade a sequence sharding for heads first.
    if cfg.impl == "pallas" and mask is None:
        out = on_local_shards(
            "flash_attention", functools.partial(
                flash_attention, causal=causal, window=cfg.window),
            (q, k, v), ("bshd",) * 3, "bshd", local="bh")
    elif cfg.impl == "chunked" and mask is None:
        out = on_local_shards(
            "chunked_attention", functools.partial(
                chunked_attention, causal=causal, window=cfg.window),
            (q, k, v), ("bshd",) * 3, "bshd", local="hb", move=True)
    else:
        if mask is None:
            # the reference's training mask: no window without causality
            mask = structural_mask(s, k.shape[1], causal,
                                   cfg.window if causal else 0, x.device)
        out = on_local_shards(
            "attention", lambda q_, k_, v_: multi_query_attention(
                q_, k_, v_, mask), (q, k, v), ("bshd",) * 3, "bshd",
            local="hb", move=True)
    return L.mm(L.merge_heads(out, cfg.n_heads), p.wo)


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


def _id_shard(x, name):
    del name
    return x


def _grouped_attention(p, cfg: AttnConfig, q, ck, cv, mask, shard):
    """Grouped-head attention over the cache without expanding it:
    ``q (B, C, H, hd)``, ``ck/cv (B, T, K, hd)``, ``mask`` broadcast to
    ``(B, K, G, C, T)``.  The ``:K`` suffix of the logits' shard name
    tells the rule whether the cache is kv-head or seq sharded.  A
    sharded cache whose sequence is whole runs on its local (batch, kv
    head) shards; a seq-sharded one takes DTensor's rules (a partial
    softmax over the shards), every query head meeting every seq shard:
    q is replicated over the axes that shard the cache's sequence before
    its heads split into (kv head, group)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    groups = cfg.n_heads // cfg.n_kv_heads
    scale = q.shape[-1] ** -0.5
    if q.shape[2] != cfg.n_heads:
        # padded query heads (``split_heads``) are made whole first: the
        # cache of such a config is never sharded on its kv heads
        q = L.unpad_heads(q, cfg.n_heads)
    seq_sharded = isinstance(ck, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == 1 for pl in ck.placements)
    if seq_sharded and isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh, [
            Replicate() if isinstance(cp, Shard) and cp.dim == 1 else qp
            for qp, cp in zip(q.placements, ck.placements)])
    qg = L.split_dim(q, 2, cfg.n_kv_heads, groups)

    def core(qg, ck, cv, mask):
        logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                              ck.float()) * scale
        logits = shard(torch.where(mask, logits, NEG_INF),
                       f"attn_logits:{cfg.n_kv_heads}")
        probs = torch.softmax(logits, dim=-1).to(qg.dtype)
        return torch.einsum("bkgst,btkd->bskgd", probs, cv.to(qg.dtype))

    if seq_sharded:
        out = core(qg, ck, cv, mask)
    else:
        out = on_local_shards(
            "decode_attention", core, (qg, ck, cv, mask),
            ("bskgd", "btkd", "btkd",
             "vwxyt" if mask.shape[0] == 1 else "bwxyt"), "bskgd",
            local="bk")
    return L.mm(L.merge_last(out, 3), p.wo)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new[:, 0]`` in place.  A DTensor cache is
    written on its local shards: ``new`` takes the cache's placements
    (its length-1 seq dim replicated) and the rank whose seq range holds
    ``slot`` writes it, so a seq-sharded cache is never gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    mesh = cache.device_mesh
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in cache.placements]
    local_new = new.redistribute(mesh, want).to_local()
    local = cache.to_local()
    # this rank's chunk of the seq dim: the axes sharding it split it in
    # mesh order, evenly
    coord = mesh.get_coordinate()
    chunk = 0
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            chunk = chunk * mesh.size(i) + coord[i]
    start = chunk * local.shape[1]
    if start <= slot < start + local.shape[1]:
        local[:, slot - start] = local_new[:, 0].to(local.dtype)


def decode_step(p, cfg: AttnConfig, x: torch.Tensor, cache: dict, length,
                shard=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  ``x (B, 1, d)``, ``length`` = #tokens already
    cached: a Python int, or a per-row ``(B,)`` tensor (the slot-serving
    layout), which delegates to ``decode_chunk`` with a one-token chunk
    (full caches only).  Returns (out (B, 1, d), cache).  ``shard(x,
    name)`` keeps the cache (``kv_cache``) and the logits
    (``attn_logits:K``) on the cache's partitioned axis."""
    shard = shard or _id_shard
    if isinstance(length, torch.Tensor) and length.ndim == 1:
        return decode_chunk(p, cfg, x, cache, length, shard)
    length = int(length)
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (length % size) if cfg.window else length
    slot = min(slot, size - 1)         # dynamic_update_slice clamps
    _write_slot(cache["k"], k, slot)
    _write_slot(cache["v"], v, slot)
    cache["k"] = shard(cache["k"], "kv_cache")
    cache["v"] = shard(cache["v"], "kv_cache")

    idx = torch.arange(size, device=x.device)
    if cfg.window:
        valid = (idx <= slot) | (length >= size)   # rolling occupancy
    else:
        valid = idx <= length
    out = _grouped_attention(p, cfg, q, cache["k"], cache["v"],
                             valid[None, None, None, None, :], shard)
    return out, cache


def decode_chunk(p, cfg: AttnConfig, x: torch.Tensor, cache: dict, lengths,
                 shard=None) -> tuple[torch.Tensor, dict]:
    """Multi-token decode / prefill against a full KV cache with per-row
    write positions: ``x (B, C, d)``, ``lengths (B,)`` (or a scalar) =
    #tokens already cached per row.  Token ``t`` of row ``b`` lands at
    ``lengths[b] + t``; the causal mask admits exactly the cache prefix
    up to that position, so right-padded rows are exact without a
    validity mask (garbage written past a row's true length is never
    attended before it is overwritten)."""
    shard = shard or _id_shard
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
    cache["k"] = shard(cache["k"], "kv_cache")
    cache["v"] = shard(cache["v"], "kv_cache")

    idx = torch.arange(size, device=x.device)
    mask = idx[None, None, :] <= positions[:, :, None]       # (B, C, size)
    out = _grouped_attention(p, cfg, q, cache["k"], cache["v"],
                             mask[:, None, None], shard)
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention decode against an encoder's memory
# ---------------------------------------------------------------------------

def cross_decode(p, cfg: AttnConfig, x: torch.Tensor,
                 memory_k: torch.Tensor, memory_v: torch.Tensor
                 ) -> torch.Tensor:
    """Cross-attention of one new token ``x (B, 1, d)`` against
    precomputed encoder memory ``memory_k/v (B, S_src, K, hd)``
    (``memory_kv``, computed once and reused every step).  The memory is
    read as a decode step reads its cache (``_grouped_attention``), so a
    memory sharded over its sequence takes the seq-sharded cache's
    partial softmax."""
    q = L.split_heads(L.mm(x, p.wq), cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p.q_norm)
    mask = torch.ones((1, 1, 1, 1, memory_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _grouped_attention(p, cfg, q, memory_k, memory_v, mask,
                              _id_shard)


def memory_kv(p, cfg: AttnConfig, memory: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of an encoder output ``memory (B, S, d)``."""
    memory = L.gather_inner(memory)
    k = L.split_last(L.mm(memory, p.wk), cfg.n_kv_heads, cfg.head_dim,
                     replicate="kv_heads")
    v = L.split_last(L.mm(memory, p.wv), cfg.n_kv_heads, cfg.head_dim,
                     replicate="kv_heads")
    if cfg.qk_norm:
        k = L.rms_norm(k, p.k_norm)
    return k, v
