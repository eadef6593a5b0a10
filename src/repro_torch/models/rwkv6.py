"""RWKV-6 "Finch" block (arXiv:2404.05892), PyTorch port of
``src/repro/models/rwkv6.py``: data-dependent token shift and
per-channel data-dependent decay, attention-free.

Time-mix recurrence per head (key dim = value dim = hd):

    a_t   = k_t v_t^T                      (rank-1 update)
    o_t   = r_t (S_t + diag(u) a_t)        (readout, bonus on current)
    S_t+1 = diag(w_t) S_t + a_t            (data-dependent diagonal decay)

Three implementations with one contract, chosen by ``RWKVConfig.impl``:
  * ``"scan"``   : ``time_mix_ref``, a loop over time (the oracle);
  * ``"chunked"``: ``time_mix_chunked``, the chunked parallel form
    (pairwise decay ratios as log differences, state carried across
    chunks by a loop);
  * ``"pallas"`` : the ``wkv_chunked`` kernel (``kernels/recurrent_scan``;
    the CUDA kernel for CUDA tensors, its plain version on the CPU).
Single-token decode always takes the scan.  Channel-mix is the RWKV
squared-ReLU FFN with token shift.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import on_local_shards
from repro_torch.kernels.recurrent_scan import wkv_chunked
from repro_torch.models import layers as L

__all__ = ["RWKVConfig", "rwkv_block_init", "rwkv_block_apply",
           "rwkv_block_step", "init_rwkv_state", "time_mix_ref",
           "time_mix_chunked"]

MIX_NAMES = ("r", "k", "v", "w", "g")


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_mix: int = 32          # rank of the token-shift ddlerp LoRA
    lora_decay: int = 64        # rank of the decay LoRA
    chunk: int = 64             # chunk length for the chunked form
    impl: str = "chunked"       # chunked | scan (oracle) | pallas (kernel)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv_block_init(gen, cfg: RWKVConfig, dtype=torch.float32) -> dict:
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    dev = gen.device
    u_init = torch.linspace(-1.0, 1.0, hd, dtype=torch.float32, device=dev)
    return {
        "time": {
            "mu_x": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "mu": torch.full((5, d), 0.5, dtype=dtype, device=dev),
            "mix_a1": L.dense_init(gen, d, 5 * cfg.lora_mix, dtype),
            "mix_a2": L.trunc_normal(gen, (5, cfg.lora_mix, d), 0.01, dtype),
            "w0": torch.full((d,), -2.0, dtype=dtype, device=dev),
            "w_a1": L.dense_init(gen, d, cfg.lora_decay, dtype),
            "w_a2": L.trunc_normal(gen, (cfg.lora_decay, d), 0.01, dtype),
            "u": u_init[None, :].repeat(h, 1).to(dtype),
            "wr": L.dense_init(gen, d, d, dtype),
            "wk": L.dense_init(gen, d, d, dtype),
            "wv": L.dense_init(gen, d, d, dtype),
            "wg": L.dense_init(gen, d, d, dtype),
            "wo": L.dense_init(gen, d, d, dtype),
            "ln_x": L.rms_norm_init(d, dtype, dev),
        },
        "channel": {
            "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "wk": L.dense_init(gen, d, cfg.d_ff, dtype),
            "wv": L.dense_init(gen, cfg.d_ff, d, dtype),
            "wr": L.dense_init(gen, d, d, dtype),
        },
        "ln1": L.rms_norm_init(d, dtype, dev),
        "ln2": L.rms_norm_init(d, dtype, dev),
    }


# ---------------------------------------------------------------------------
# Token shift + projections
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Sequence shift: y_t = x_{t-1}; y_0 = prev (the carried token)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(tp, x: torch.Tensor, x_prev_tok: torch.Tensor) -> dict:
    """Data-dependent token-shift mix for the five branches (Finch eq. 2-4)."""
    xx = x_prev_tok - x
    xbase = x + xx * tp.mu_x
    lora = torch.tanh(L.mm(xbase, tp.mix_a1))                 # (B, S, 5 r)
    lora = L.split_last(lora, 5, lora.shape[-1] // 5,
                        replicate="rwkv_mix_lora")
    dt = torch.promote_types(lora.dtype, tp.mix_a2.dtype)
    delta = torch.einsum("bsnr,nrd->bsnd", lora.to(dt),
                         tp.mix_a2.to(dt))                    # (B, S, 5, d)
    return {name: x + xx * (tp.mu[i] + delta[:, :, i, :])
            for i, name in enumerate(MIX_NAMES)}


def _rkvwg(tp, mixed: dict, h: int, hd: int):
    """Project the mixed branches -> per-head r, k, v, decay logs, gate."""
    r = L.split_last(L.mm(mixed["r"], tp.wr), h, hd)
    k = L.split_last(L.mm(mixed["k"], tp.wk), h, hd)
    v = L.split_last(L.mm(mixed["v"], tp.wv), h, hd)
    g = F.silu(L.mm(mixed["g"], tp.wg))
    w_raw = tp.w0 + L.mm(torch.tanh(L.mm(mixed["w"], tp.w_a1)), tp.w_a2)
    # log-decay in (-inf, 0): log w = -exp(w_raw)
    logw = -torch.exp(torch.clamp(w_raw.float(), -8.0, 5.0))
    return r, k, v, L.split_last(logw, h, hd), g


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------

def time_mix_ref(r, k, v, logw, u, state):
    """Oracle: loop over time.  r/k/v/logw (B,S,H,hd), u (H,hd),
    state (B,H,hd,hd).  Returns (out (B,S,H,hd), final state), with the
    reference's dtypes: ``k v^T`` in the operands' dtype, the readout
    and the state in fp32 (they meet the fp32 state and ``u``)."""
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        a = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        x = state + uu * a
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(x.dtype), x))
        state = torch.exp(logw[:, t])[..., None] * state + a
    return torch.stack(outs, dim=1), state


def time_mix_chunked(r, k, v, logw, u, state, chunk: int = 64):
    """Chunked parallel form in fp32 (overflow-safe log-space decay
    ratios).  Within a chunk of length C:
      cum[t]  = sum_{s<=t} logw_s                       (per key dim)
      inter-token weight A[t,s,d] = exp(cum[t-1]-cum[s]) for s<t  (<=1)
      state passthrough uses exp(cum[t-1]) (<=1)
      chunk state update uses exp(cum[C-1]-cum[s]) (<=1)
    """
    b, s, h, hd = r.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}")
    r_, k_, v_, lw = (t.float() for t in (r, k, v, logw))
    s0 = state.float()
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, :, :, None, None]
    outs = []
    for start in range(0, s, c):
        rc, kc, vc, lwc = (t[:, start:start + c] for t in (r_, k_, v_, lw))
        cum = torch.cumsum(lwc, dim=1)                        # (B,C,H,hd)
        cum_prev = cum - lwc                                  # cum[t-1]
        o_state = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(cum_prev),
                               s0)
        diff = cum_prev[:, :, None] - cum[:, None, :, :, :]   # (B,C,C,H,hd)
        a = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        w_ts = torch.einsum("bthk,btshk,bshk->btsh", rc, a, kc)
        o_intra = torch.einsum("btsh,bshv->bthv", w_ts, vc)
        o_bonus = torch.einsum("bchk,bchk->bch", rc * u[None, None], kc
                               )[..., None] * vc
        dec_total = torch.exp(cum[:, -1])                     # (B,H,hd)
        k_dec = kc * torch.exp(torch.clamp(cum[:, -1][:, None] - cum,
                                           max=0.0))
        s0 = dec_total[..., None] * s0 + torch.einsum("bshk,bshv->bhkv",
                                                      k_dec, vc)
        outs.append(o_state + o_intra + o_bonus)
    return torch.cat(outs, dim=1).to(r.dtype), s0


def init_rwkv_state(cfg: RWKVConfig, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        "shift_att": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
        "shift_ffn": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
    }


# ---------------------------------------------------------------------------
# Full block (train / prefill / decode)
# ---------------------------------------------------------------------------

def _time_mix_out(tp, cfg: RWKVConfig, o, g, b, s):
    # per-head group norm (rms variant), then the gate
    ohf = o.reshape(b, s, cfg.n_heads, cfg.head_dim).float()
    var = ohf.square().mean(dim=-1, keepdim=True)
    oh = (ohf * torch.rsqrt(var + 1e-6)).to(o.dtype)
    o = L.merge_last(oh) * tp.ln_x
    return L.mm(o * g, tp.wo)


def _last_valid(t: torch.Tensor, valid: torch.Tensor, fallback: torch.Tensor
                ) -> torch.Tensor:
    """Gather ``t (B, S, d)`` at each row's last valid position; rows with
    no valid token keep ``fallback (B, d)`` (the incoming carry)."""
    s = t.shape[1]
    pos = torch.arange(s, device=t.device)[None, :]
    last = torch.where(valid, pos, -1).amax(dim=1)
    picked = t.gather(1, last.clamp(min=0)[:, None, None].expand(
        -1, 1, t.shape[2]))[:, 0]
    return torch.where((last >= 0)[:, None], picked, fallback.to(t.dtype))


def rwkv_block_apply(params, cfg: RWKVConfig, x: torch.Tensor,
                     state: dict | None = None,
                     valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """Training / prefill: ``x (B, S, d)`` -> (y, final recurrent state).

    ``valid (B, S)`` bool marks live positions of ragged right-padded
    chunks (the serving prefill): pad positions become identity state
    updates (``k`` and ``logw`` zeroed: decay 1, rank-1 update 0) and the
    token-shift carries come from each row's last valid position, so the
    final state equals a per-row unpadded run.  Outputs at pad positions
    are garbage and must be ignored by the caller.
    """
    b, s, _ = x.shape
    if state is None:
        state = init_rwkv_state(cfg, b, device=x.device)
    tp, cp = params.time, params.channel

    # --- time mix ---
    # each mix's input gathered over its sequence once (a block's
    # input, sequence-sharded between blocks on a mesh)
    xn = L.gather_inner(L.rms_norm(x, params.ln1))
    mixed = _ddlerp(tp, xn, _shift(xn, state["shift_att"]))
    r, k, v, logw, g = _rkvwg(tp, mixed, cfg.n_heads, cfg.head_dim)
    if valid is not None:
        vm = valid[:, :, None, None]
        k = torch.where(vm, k, torch.zeros((), dtype=k.dtype,
                                           device=k.device))
        logw = torch.where(vm, logw, torch.zeros((), dtype=logw.dtype,
                                                 device=logw.device))
    u = tp.u.float()
    if cfg.impl == "pallas" and s > 1:
        # bf16 compute only when the model runs bf16 activations (the
        # reference's rule)
        cd = "bf16" if x.dtype == torch.bfloat16 else "fp32"
        o, wkv = on_local_shards(
            "wkv_chunked", functools.partial(wkv_chunked, compute_dtype=cd),
            (r, k, v, logw, u, state["wkv"]),
            ("bshk", "bshk", "bshv", "bshk", "hk", "bhkv"),
            ("bshv", "bhkv"), local="bh")
    elif cfg.impl == "chunked" and s > 1:
        # sharded operands scan on their local (batch, head) shards, a
        # sequence sharding traded for heads first
        o, wkv = on_local_shards(
            "time_mix_chunked", functools.partial(time_mix_chunked,
                                                  chunk=cfg.chunk),
            (r, k, v, logw, u, state["wkv"]),
            ("bshk", "bshk", "bshv", "bshk", "hk", "bhkv"),
            ("bshv", "bhkv"), local="hb", move=True)
    else:
        o, wkv = on_local_shards(
            "time_mix", time_mix_ref, (r, k, v, logw, u, state["wkv"]),
            ("bshk", "bshk", "bshv", "bshk", "hk", "bhkv"),
            ("bshv", "bhkv"), local="hb", move=True)
    o = o.to(x.dtype)
    x = x + L.placed_like(_time_mix_out(tp, cfg, o, g, b, s).to(x.dtype), x)

    # --- channel mix ---
    xn2 = L.gather_inner(L.rms_norm(x, params.ln2))
    shifted = _shift(xn2, state["shift_ffn"])
    xk = xn2 + (shifted - xn2) * cp.mu_k
    xr = xn2 + (shifted - xn2) * cp.mu_r
    kk = torch.square(torch.relu(L.mm(xk, cp.wk)))
    out = L.mm(kk, cp.wv) * torch.sigmoid(L.mm(xr, cp.wr))
    x = x + L.placed_like(out.to(x.dtype), x)

    if valid is None:
        new_state = {"wkv": wkv, "shift_att": xn[:, -1, :],
                     "shift_ffn": xn2[:, -1, :]}
    else:
        new_state = {"wkv": wkv,
                     "shift_att": _last_valid(xn, valid, state["shift_att"]),
                     "shift_ffn": _last_valid(xn2, valid,
                                              state["shift_ffn"])}
    return x, new_state


def rwkv_block_step(params, cfg: RWKVConfig, x: torch.Tensor, state: dict
                    ) -> tuple[torch.Tensor, dict]:
    """Decode: ``x (B, 1, d)`` with O(1) state."""
    return rwkv_block_apply(params, dataclasses.replace(cfg, impl="scan"), x,
                            state)
