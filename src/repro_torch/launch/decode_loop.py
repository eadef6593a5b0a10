"""Cluster-routed continuous-batching LM serving, PyTorch port of
``src/repro/launch/decode_loop.py``.

Three layers, slowest to fastest:

* ``greedy_decode`` — the uniform-batch baseline: one dispatch per token
  for prefill and decode, with the reference's phase accounting
  (``decode_s`` covers the ``gen - 1`` steps after the first token;
  time to first token is reported apart).
* ``ClusterHeads`` / ``cluster_logits`` — per-cluster output heads plus
  a low-rank adapter over the shared trunk: the multi-task serving
  surface.  The reference gathers a ``(d, vocab)`` head for every row;
  the port groups the rows by cluster and multiplies each group by its
  head, the same per-row function in another fp32 summation order.
* ``ServeEngine`` — the continuous-batching slot scheduler: an admission
  wave runs a chunked teacher-forced prefill (one dispatch a wave: a
  loop over ``max_prompt / prefill_chunk`` chunks), decode steps every
  slot each round with per-slot lengths and cluster ids, and finished
  requests free their slots for the next wave.

Cluster ids come from ``MembershipEngine.assign`` over
``data/tokens.py::token_features`` signatures (``route_requests``).
``ServeEngine.serve`` records the reference's telemetry while
``repro_torch.obs`` is enabled: the ``serve.run`` span, the
``serve.requests`` and dispatch counters, the slot-utilization gauge,
the ``serve.ttft_us`` histogram and the ``wave_admitted``,
``slot_freed`` and ``request_done`` events.  They read host values the
loop already holds, so telemetry adds no synchronisation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.tokens import token_features
from repro_torch.models import layers as L

__all__ = ["DecodeStats", "greedy_decode", "ClusterHeads", "cluster_logits",
           "cluster_logits_fn", "Request", "RequestResult", "ServeConfig",
           "ServeStats", "ServeEngine", "token_signature", "route_requests"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Uniform-batch baseline (per-token dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeStats:
    """One serving run: generated tokens and phase wall-clock.

    ``prefill_s`` covers the teacher-forced prompt; ``ttft_s`` adds the
    first-token argmax (time to first token); ``decode_s`` covers exactly
    the ``gen - 1`` steps that produce tokens 2..gen, so ``tok_per_s``
    divides the tokens that phase produced.
    """

    tokens: torch.Tensor       # (batch, gen) greedy continuations
    prompt_len: int
    prefill_s: float
    ttft_s: float
    decode_s: float
    prefill_dispatches: int    # counted dispatches in prefill

    @property
    def tok_per_s(self) -> float:
        """Decode-phase throughput over the steps ``decode_s`` covers."""
        b, g = self.tokens.shape
        return b * (g - 1) / max(self.decode_s, 1e-9)

    @property
    def total_tok_per_s(self) -> float:
        """End-to-end throughput including prefill and the first token."""
        b, g = self.tokens.shape
        return b * g / max(self.ttft_s + self.decode_s, 1e-9)


def greedy_decode(model, params, prompts: torch.Tensor, gen: int,
                  logits_fn: Callable[[torch.Tensor], torch.Tensor]
                  | None = None) -> DecodeStats:
    """Prefill ``prompts (batch, prompt_len)`` through a fresh decode
    state one token per dispatch, then generate ``gen`` tokens greedily
    on ``prompts``' device.

    ``logits_fn(hn (B, d)) -> (B, V)`` swaps the stock head for another
    readout (one cluster's head via ``cluster_logits_fn``) over the same
    trunk: the sequential baseline the slot scheduler is held to.
    """
    batch, prompt_len = prompts.shape
    device = prompts.device
    state = model.init_decode_state(batch, prompt_len + gen, device=device)

    def step(toks, st):
        if logits_fn is None:
            return model.decode_step(params, toks, st)
        hn, st = model.decode_hidden(params, toks, st)
        return logits_fn(hn[:, 0])[:, None, :], st

    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, state = step(prompts[:, t:t + 1], state)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    _sync(device)
    ttft_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = step(tok, state)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(device)
    return DecodeStats(tokens=tokens, prompt_len=prompt_len,
                       prefill_s=prefill_s, ttft_s=ttft_s,
                       decode_s=time.perf_counter() - t0,
                       prefill_dispatches=prompt_len)


# ---------------------------------------------------------------------------
# Per-cluster heads/adapters over the shared trunk
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterHeads:
    """Per-cluster serving parameters: a full output head plus a low-rank
    residual adapter on the final hidden, selected per row.  The trunk
    (embeddings and blocks) stays shared."""

    head: torch.Tensor       # (T, d, vocab) fp32
    adapter_a: torch.Tensor  # (T, d, rank)
    adapter_b: torch.Tensor  # (T, rank, d)

    @property
    def n_clusters(self) -> int:
        return self.head.shape[0]

    @classmethod
    def init(cls, generator: torch.Generator | int, base_head: torch.Tensor,
             n_clusters: int, rank: int = 4, scale: float = 0.05
             ) -> "ClusterHeads":
        """Distinct per-cluster heads = shared base + seeded noise, drawn
        on ``base_head``'s device (a seed makes a generator there)."""
        if isinstance(generator, int):
            generator = torch.Generator(
                device=base_head.device).manual_seed(generator)
        d, v = base_head.shape

        def noise(*shape):
            return scale * torch.randn(shape, generator=generator,
                                       device=base_head.device)

        return cls(head=base_head.float()[None] + noise(n_clusters, d, v),
                   adapter_a=noise(n_clusters, d, rank),
                   adapter_b=noise(n_clusters, rank, d))


def cluster_logits(heads: ClusterHeads, hn: torch.Tensor, cids
                   ) -> torch.Tensor:
    """Routed readout: ``hn (B, d)`` normed hidden, ``cids (B,)`` cluster
    ids (host or device) -> ``(B, vocab)`` fp32 logits through each row's
    cluster head and adapter."""
    hf = hn.float()
    cids = torch.as_tensor(cids).cpu()
    out = torch.empty((hf.shape[0], heads.head.shape[2]), dtype=torch.float32,
                      device=hf.device)
    for t in torch.unique(cids).tolist():
        rows = torch.nonzero(cids == t)[:, 0].to(hf.device)
        h_t = hf[rows]
        h_t = h_t + (h_t @ heads.adapter_a[t]) @ heads.adapter_b[t]
        out[rows] = h_t @ heads.head[t]
    return out


def cluster_logits_fn(heads: ClusterHeads, cluster: int
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A ``greedy_decode(logits_fn=...)`` readout pinned to one cluster."""
    def fn(hn):
        return cluster_logits(heads, hn, torch.full((hn.shape[0],), cluster))
    return fn


# ---------------------------------------------------------------------------
# Cluster routing from token-statistics signatures
# ---------------------------------------------------------------------------

def token_signature(tokens: np.ndarray, d: int = 32, k: int = 2,
                    window: int = 16, vocab: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One request's ``(lam (k,), v (d, k))`` signature from its prompt's
    token statistics: ``token_features`` windows -> Gram -> top-k
    eigenpairs (host numpy, as in the reference)."""
    x = token_features(np.asarray(tokens, np.int64), d=d, window=window,
                       vocab=vocab)
    if x.shape[0] == 0:
        return np.zeros(k, np.float32), np.zeros((d, k), np.float32)
    g = x.T @ x / x.shape[0]
    w, u = np.linalg.eigh(g.astype(np.float64))
    return (w[-k:][::-1].astype(np.float32),
            np.ascontiguousarray(u[:, -k:][:, ::-1]).astype(np.float32))


def route_requests(membership, token_streams: Sequence[np.ndarray],
                   d: int = 32, k: int = 2, window: int = 16,
                   vocab: int | None = None) -> np.ndarray:
    """Route requests to cluster ids through a seeded ``MembershipEngine``:
    signatures -> ``assign`` -> labels.  Unassigned verdicts (label -1)
    fall back to cluster 0 rather than stalling the request."""
    sigs = [token_signature(t, d=d, k=k, window=window, vocab=vocab)
            for t in token_streams]
    lam = np.stack([s[0] for s in sigs])
    v = np.stack([s[1] for s in sigs])
    labels = membership.assign(lam, v).labels
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    return np.where(labels < 0, 0, labels).astype(np.int32)


# ---------------------------------------------------------------------------
# The continuous-batching slot scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shapes of the serving programs; everything per request
    rides in as data."""

    slots: int = 8             # S: concurrent decode rows
    max_len: int = 256         # per-slot KV/state capacity (prompt + gen)
    prefill_chunk: int = 16    # C: tokens per prefill step
    max_prompt: int = 64       # P: admission-wave prompt pad (mult of C)
    wave: int = 4              # W: requests prefilled per admission wave
    max_gen: int = 64          # cap on generated tokens per request

    def validate(self) -> None:
        if self.max_prompt % self.prefill_chunk:
            raise ValueError(f"max_prompt {self.max_prompt} must be a "
                             f"multiple of prefill_chunk "
                             f"{self.prefill_chunk}")
        if self.max_prompt + self.max_gen > self.max_len:
            raise ValueError(f"max_prompt + max_gen "
                             f"{self.max_prompt + self.max_gen} exceeds "
                             f"max_len {self.max_len}")
        if min(self.slots, self.wave, self.prefill_chunk, self.max_gen) < 1:
            raise ValueError("slots/wave/prefill_chunk/max_gen must be >= 1")


@dataclasses.dataclass(frozen=True)
class Request:
    tokens: np.ndarray         # (prompt_len,) i32 prompt
    gen: int                   # tokens to generate (>= 1)
    cluster: int = 0           # routed cluster id (see route_requests)
    arrive_round: int = 0      # earliest decode round it may be admitted


@dataclasses.dataclass(frozen=True)
class RequestResult:
    tokens: np.ndarray         # (gen,) generated tokens
    ttft_s: float              # admission wall-clock -> first token
    done_s: float              # wall-clock when the request completed
    cluster: int


@dataclasses.dataclass(frozen=True)
class ServeStats:
    results: list[RequestResult]
    wall_s: float
    decode_rounds: int
    prefill_dispatches: int    # counted prefill dispatches (one a wave)
    decode_dispatches: int     # counted decode-round dispatches
    prefill_scan_steps: int    # chunks per wave inside the one dispatch
    slot_utilization: float    # mean active-slot fraction per decode round
    traces: dict[str, int]     # programs built (one each, see ServeEngine)

    @property
    def total_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self.results))

    @property
    def aggregate_tok_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def mean_ttft_s(self) -> float:
        return float(np.mean([r.ttft_s for r in self.results]))


class ServeEngine:
    """Continuous-batching decode over a fixed slot grid.

    Three programs over state shapes pinned by ``ServeConfig``:

      _prefill(tokens (W,P), lengths (W,), cids (W,))
          -> (first token (W,), wave state)   [a loop over P/C chunks]
      _admit(slot_state, wave_state, slot_ids (W,))
          -> the wave's rows written into free slots, in place
      _decode(slot_state, cur_tok (S,), cids (S,), active (S,))
          -> (next token (S,), slot_state)

    The reference jits each program and counts its traces; eager PyTorch
    has none, so ``traces`` counts each program once, when it is built,
    and stays there across ``serve`` calls.  Slot state is updated in
    place where the reference donates its buffers.  Inactive slots are
    stepped with the rest and hold garbage until an admit overwrites
    them, as in the reference.  The host loop only decides which request
    enters which free slot.
    """

    def __init__(self, model, params, heads: ClusterHeads,
                 cfg: ServeConfig | None = None):
        cfg = cfg or ServeConfig()
        cfg.validate()
        if model.cfg.attn_window or model.cfg.local_window:
            raise ValueError("slot scheduling serves full KV caches only "
                             "(sliding-window archs unsupported)")
        self.model = model
        self.params = params
        self.heads = heads
        self.cfg = cfg
        self.device = params.embed.device
        self.prefill_scan_steps = cfg.max_prompt // cfg.prefill_chunk
        self.traces = {"prefill": 1, "admit": 1, "decode": 1}

    # -- programs -----------------------------------------------------------

    def _prefill(self, tokens, lengths, cids):
        model, scfg, w = self.model, self.cfg, self.cfg.wave
        c = scfg.prefill_chunk
        state = model.init_decode_state(w, scfg.max_len, per_slot=True,
                                        device=self.device)
        h_last = torch.zeros((w, model.cfg.d_model), dtype=torch.float32,
                             device=self.device)
        for start in range(0, scfg.max_prompt, c):
            pos = torch.arange(start, start + c, device=self.device)
            valid = pos[None, :] < lengths[:, None]
            h, state = model.prefill_chunk(self.params,
                                           tokens[:, start:start + c], state,
                                           start, valid)
            # keep each row's hidden at its last valid position
            in_chunk = lengths - 1 - start
            g = h.gather(1, in_chunk.clamp(0, c - 1)[:, None, None].expand(
                -1, 1, h.shape[2]))[:, 0].float()
            h_last = torch.where(((in_chunk >= 0) & (in_chunk < c))[:, None],
                                 g, h_last)
        final_norm = self.params.final_norm
        hn = L.rms_norm(h_last.to(final_norm.dtype), final_norm)
        first = cluster_logits(self.heads, hn, cids).argmax(dim=-1)
        return first.to(torch.int32), state

    def _admit(self, slot_state, wave_state, slot_ids: np.ndarray):
        """Write the wave's rows into their slots.  A slot id equal to
        ``slots`` drops its row (the reference's ``mode="drop"``
        scatter), so those rows are masked out here."""
        keep = np.flatnonzero(slot_ids < self.cfg.slots)
        if not len(keep):
            return slot_state
        src = torch.from_numpy(keep).to(self.device)
        dst = torch.from_numpy(slot_ids[keep].astype(np.int64)).to(
            self.device)
        slot_state["length"][dst] = wave_state["length"][src]
        for slot_layer, wave_layer in zip(slot_state["layers"],
                                          wave_state["layers"]):
            for key, leaf in slot_layer.items():
                leaf[dst] = wave_layer[key][src].to(leaf.dtype)
        return slot_state

    def _decode(self, slot_state, cur_tok, cids, active):
        hn, new_state = self.model.decode_hidden(self.params, cur_tok[:, None],
                                                 slot_state)
        nxt = cluster_logits(self.heads, hn[:, 0], cids).argmax(dim=-1)
        # frozen (inactive) slots: length and token stay
        new_state["length"] = torch.where(active, slot_state["length"] + 1,
                                          slot_state["length"])
        return torch.where(active, nxt.to(torch.int32), cur_tok), new_state

    # -- host scheduling loop ----------------------------------------------

    def _check(self, requests: Sequence[Request]) -> None:
        scfg = self.cfg
        t = self.heads.n_clusters
        for i, r in enumerate(requests):
            n = len(np.asarray(r.tokens))
            if not 1 <= n <= scfg.max_prompt:
                raise ValueError(f"request {i}: prompt len {n} outside "
                                 f"[1, {scfg.max_prompt}]")
            if not 1 <= r.gen <= scfg.max_gen:
                raise ValueError(f"request {i}: gen {r.gen} outside "
                                 f"[1, {scfg.max_gen}]")
            if n + r.gen > scfg.max_len:
                raise ValueError(f"request {i}: prompt+gen {n + r.gen} "
                                 f"exceeds max_len {scfg.max_len}")
            if not 0 <= r.cluster < t:
                raise ValueError(f"request {i}: cluster {r.cluster} outside "
                                 f"directory [0, {t})")

    def serve(self, requests: Sequence[Request]) -> ServeStats:
        """Run every request to completion, admitting continuously as
        slots free up.  Returns per-request tokens and latencies and the
        counted dispatches and slot utilization."""
        with obs.span("serve.run", n_requests=len(requests),
                      slots=self.cfg.slots) as sp:
            stats = sp.sync(self._serve(requests))
        if obs.enabled():
            obs.count("serve.requests", len(stats.results))
            obs.count("serve.prefill_dispatches", stats.prefill_dispatches)
            obs.count("serve.decode_dispatches", stats.decode_dispatches)
            obs.gauge("serve.slot_utilization", stats.slot_utilization)
            for r in stats.results:
                obs.observe("serve.ttft_us", r.ttft_s * 1e6)
        return stats

    def _serve(self, requests: Sequence[Request]) -> ServeStats:
        self._check(requests)
        scfg, dev = self.cfg, self.device
        s_slots, w, p = scfg.slots, scfg.wave, scfg.max_prompt
        n_req = len(requests)

        def put(a):
            return torch.from_numpy(a).to(dev)

        t_start = time.perf_counter()
        slot_state = self.model.init_decode_state(s_slots, scfg.max_len,
                                                  per_slot=True, device=dev)
        active = np.zeros(s_slots, bool)
        slot_req = np.full(s_slots, -1, np.int64)
        remaining = np.zeros(s_slots, np.int64)
        cur_tok = np.zeros(s_slots, np.int32)
        cids = np.zeros(s_slots, np.int32)
        out_toks: list[list[int]] = [[] for _ in range(n_req)]
        ttft = np.zeros(n_req)
        done = np.zeros(n_req)
        pending = list(range(n_req))
        rounds = prefill_dispatches = decode_dispatches = 0
        active_slot_rounds = 0

        while True:
            free = np.flatnonzero(~active)
            avail = [i for i in pending
                     if requests[i].arrive_round <= rounds]
            if len(avail) and len(free):
                take = avail[:min(w, len(free))]
                tokens = np.zeros((w, p), np.int32)
                lengths = np.zeros(w, np.int32)
                wcids = np.zeros(w, np.int32)
                for j, i in enumerate(take):
                    tk = np.asarray(requests[i].tokens, np.int32)
                    tokens[j, :len(tk)] = tk
                    lengths[j] = len(tk)
                    wcids[j] = requests[i].cluster
                first, wave_state = self._prefill(put(tokens), put(lengths),
                                                  torch.from_numpy(wcids))
                first = first.cpu().numpy()
                prefill_dispatches += 1
                now = time.perf_counter() - t_start
                slot_ids = np.full(w, s_slots, np.int32)  # default: dropped
                for j, i in enumerate(take):
                    pending.remove(i)
                    out_toks[i].append(int(first[j]))
                    ttft[i] = now
                    if requests[i].gen == 1:
                        done[i] = now      # complete; never occupies a slot
                        if obs.enabled():
                            obs.event("request_done", request=i,
                                      ttft_s=now, done_s=now, n_tokens=1)
                        continue
                    s = int(free[j])
                    slot_ids[j] = s
                    active[s] = True
                    slot_req[s] = i
                    remaining[s] = requests[i].gen - 1
                    cur_tok[s] = first[j]
                    cids[s] = requests[i].cluster
                slot_state = self._admit(slot_state, wave_state, slot_ids)
                if obs.enabled():
                    obs.event("wave_admitted", round=rounds,
                              n_admitted=len(take),
                              free_slots=int((~active).sum()))
                continue                   # admit again while possible
            if not active.any():
                if not pending:
                    break
                rounds += 1                # idle: wait for arrivals
                continue

            nxt, slot_state = self._decode(slot_state, put(cur_tok),
                                           torch.from_numpy(cids),
                                           put(active))
            nxt = nxt.cpu().numpy()
            decode_dispatches += 1
            rounds += 1
            active_slot_rounds += int(active.sum())
            now = time.perf_counter() - t_start
            for s in np.flatnonzero(active):
                i = int(slot_req[s])
                out_toks[i].append(int(nxt[s]))
                remaining[s] -= 1
                if remaining[s] == 0:
                    done[i] = now
                    active[s] = False
                    slot_req[s] = -1
                    if obs.enabled():
                        obs.event("slot_freed", slot=int(s), request=i,
                                  round=rounds)
                        obs.event("request_done", request=i,
                                  ttft_s=float(ttft[i]), done_s=now,
                                  n_tokens=len(out_toks[i]))
                else:
                    cur_tok[s] = nxt[s]

        wall = time.perf_counter() - t_start
        results = [RequestResult(tokens=np.asarray(out_toks[i], np.int32),
                                 ttft_s=float(ttft[i]),
                                 done_s=float(done[i]),
                                 cluster=requests[i].cluster)
                   for i in range(n_req)]
        util = (active_slot_rounds / (decode_dispatches * s_slots)
                if decode_dispatches else 0.0)
        return ServeStats(results=results, wall_s=wall,
                          decode_rounds=rounds,
                          prefill_dispatches=prefill_dispatches,
                          decode_dispatches=decode_dispatches,
                          prefill_scan_steps=self.prefill_scan_steps,
                          slot_utilization=util, traces=dict(self.traces))
