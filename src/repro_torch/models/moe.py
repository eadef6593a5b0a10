"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch,
PyTorch port of ``src/repro/models/moe.py``.

GShard/Switch-style: tokens pick top-k experts; each expert processes at
most ``capacity`` tokens of a dispatch chunk (overflow dropped).  The
reference dispatches and combines through one-hot einsums; here a kept
pick is an index into its expert's slots: the tokens are gathered into
``(g, E, C, d)``, the expert products run batched over experts, and each
token gathers its picks' outputs back.  The kept and dropped picks, and
so the function, are the reference's.

Experts are stacked ``(E, d_model, d_ff)``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["MoEConfig", "moe_init", "moe_apply", "route", "capacity_of",
           "dispatch_slots", "dispatch"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    mlp_variant: str = "swiglu"
    dispatch_chunk: int = 1024
    # ^ tokens are dispatched in chunks ("groups") of this size with a
    # per-chunk expert capacity, so the dispatch is linear in tokens.


def moe_init(gen, cfg: MoEConfig, dtype=torch.float32) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def stack(d_in, d_out):
        return torch.stack([L.dense_init(gen, d_in, d_out, dtype)
                            for _ in range(e)])

    p = {"router": L.dense_init(gen, d, e, dtype),
         "w_up": stack(d, f),
         "w_down": stack(f, d)}
    if cfg.mlp_variant == "swiglu":
        p["w_gate"] = stack(d, f)
    return p


def route(p, cfg: MoEConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of ``xt (T, d)``: (fp32 probabilities (T, E), renormalised
    gates (T, k), expert ids (T, k)).  Among equal probabilities the lower
    expert id comes first, as ``jax.lax.top_k`` orders them (a stable
    descending sort; ``torch.topk`` does not promise an order)."""
    probs = torch.softmax(L.mm(xt, p.router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def capacity_of(cfg: MoEConfig, t: int) -> tuple[int, int]:
    """``(tc, capacity)`` for ``t`` tokens: the dispatch chunk (one group
    of all tokens when ``t`` is not a chunk multiple) and its per-expert
    slots, as the reference computes them."""
    e, k = cfg.n_experts, cfg.top_k
    tc = min(cfg.dispatch_chunk, t)
    if t % tc:
        tc = t  # one group for odd tiny shapes
    capacity = max(1, int(cfg.capacity_factor * k * tc / e))
    capacity = min(capacity, tc)
    return tc, capacity


def dispatch_slots(gate_idx: torch.Tensor, cfg: MoEConfig, t: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pos, keep)``, both ``(T, k)``, for the expert ids ``gate_idx``:
    a pick's slot in its expert (the picks of its dispatch chunk before
    it, token-major and pick-minor, that chose the same expert) and
    whether that slot is within the capacity."""
    tc, capacity = capacity_of(cfg, t)
    k = gate_idx.shape[1]
    sel = F.one_hot(gate_idx, cfg.n_experts).reshape(t // tc, tc * k, -1)
    pos = ((torch.cumsum(sel, dim=1) * sel).sum(dim=-1) - 1).reshape(t, k)
    return pos, pos < capacity


def dispatch(xt: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """Every kept pick's token ``xt (T, d)`` written into its slot of an
    ``(n_slots, d)`` buffer (slots are unique).  A dropped pick writes a
    spare last row, which is then cut off, so every shape is static (no
    boolean-mask index; it traces under ``FakeTensorMode``).

    The backward is a gather, as the combine is: each token's gradient
    is its kept picks' slot rows (``layers.lookup_rows``; zero for a
    dropped pick) summed over its picks, the values and the order of
    the write's own backward (an index of the buffer's gradient, then
    the sum over picks), so the gradients are the same bits.  On a mesh
    the lookup runs on local shards, where an ``aten.index`` of a buffer
    sharded on three axes has no sharding rule in some torch versions."""
    return _Dispatch.apply(xt, slot, keep, n_slots)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, slot, keep, n_slots):
        t, d = xt.shape
        k = slot.shape[1]
        ctx.save_for_backward(slot, keep)
        dest = torch.where(keep, slot, n_slots).reshape(t * k)
        src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
        return xt.new_zeros((n_slots + 1, d)).index_put((dest,),
                                                        src)[:n_slots]

    @staticmethod
    def backward(ctx, grad):
        slot, keep = ctx.saved_tensors
        rows = L.lookup_rows(grad, torch.where(keep, slot, 0))  # (T, k, d)
        return (torch.where(keep[..., None], rows, 0.0).sum(dim=1),
                None, None, None)


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` -> ``(out (B, S, d), aux_loss scalar)``.

    Picks are numbered within each dispatch chunk token-major and
    pick-minor; a pick is kept when fewer than ``capacity`` earlier picks
    of its chunk chose its expert, so a token's second pick can drop
    while its first is kept.  aux_loss is the load-balancing loss (mean
    routed fraction of the first pick x mean router probability, scaled
    by E) over all tokens.
    """
    b, s, d = x.shape
    t = b * s
    xt = L.gather_inner(x).reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = route(p, cfg, xt)
    tc, capacity = capacity_of(cfg, t)
    g = t // tc

    pos, keep = dispatch_slots(gate_idx, cfg, t)
    chunk = (torch.arange(t, device=x.device) // tc)[:, None]
    # slots expert-major: (expert, dispatch chunk, position)
    slot = (gate_idx * g + chunk) * capacity + pos           # (T, k)

    xe = dispatch(xt, slot, keep, e * g * capacity).reshape(e, g * capacity,
                                                            d)
    up = _expert_mm(xe, p.w_up)
    if cfg.mlp_variant == "swiglu":
        h = F.silu(_expert_mm(xe, p.w_gate)) * up
    else:
        h = L.gelu(up)
    ye = _expert_mm(h, p.w_down).reshape(e * g * capacity, d)

    # combine: each token's kept picks, weighted by their gates in the
    # activation dtype, summed over picks in pick order in fp32
    w = torch.where(keep, gate_vals.to(x.dtype).float(), 0.0)
    # (on a mesh, ye's rows are sharded by expert: a vocab-parallel
    # lookup)
    picked = L.lookup_rows(ye, torch.where(keep, slot, 0)).float()  # (T, k, d)
    out = (picked * w[..., None]).sum(dim=1).to(ye.dtype).reshape(b, s, d)

    frac_tokens = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out, aux


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(E, n, a) x (E, a, c) -> (E, n, c)``: one batched product over
    experts, with JAX's type promotion."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.bmm(x.to(dt), w.to(dt))
