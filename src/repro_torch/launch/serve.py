"""Serving launcher for the port: cluster-routed continuous-batching
decode for a decoder ``--arch`` (dense, MoE, fusion, SSM or hybrid; an
encoder-decoder arch exits with the reference's message).  Mirrors
``src/repro/launch/serve.py``.

  # on the CUDA device (the default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1_6b

  # the plain versions of the kernels on the CPU, a REDUCED config
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen3_1_7b --requests 8 --prompt-len 32 --gen 8

``--mode static`` runs the uniform-batch per-token baseline
(``greedy_decode``) on the same request mix, one cluster at a time; the
default ``continuous`` mode runs the slot scheduler with chunked prefill
and per-cluster heads.  Weights are random, drawn from ``--seed``.
``--events PATH`` turns ``repro_torch.obs`` on for the run and writes its
event stream (``wave_admitted``, ``slot_freed``, ``request_done``) to
``PATH`` as JSONL, in both modes, as the reference's flag does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.decode_loop import (ClusterHeads, Request,
                                            ServeConfig, ServeEngine,
                                            cluster_logits_fn, greedy_decode)
from repro_torch.models.registry import get_model


def make_requests(rng: np.random.Generator, n: int, vocab: int,
                  max_prompt: int, max_gen: int, clusters: int
                  ) -> list[Request]:
    """A ragged multi-tenant mix: prompt lengths and generation budgets
    vary per request; cluster ids round-robin over the directory."""
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(4, max_prompt // 4), max_prompt + 1))
        gen = int(rng.integers(max(2, max_gen // 4), max_gen + 1))
        reqs.append(Request(
            tokens=rng.integers(0, vocab, size=plen).astype(np.int32),
            gen=gen, cluster=i % clusters,
            arrive_round=0 if i < n // 2 else int(rng.integers(0, 8))))
    return reqs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--mode", choices=["continuous", "static"],
                    default="continuous")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--events", default=None,
                    help="record the obs event stream (wave_admitted/"
                         "slot_freed/request_done) to this JSONL")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.events:
        obs.reset()
        obs.enable()
    cfg = get_arch(args.arch, reduced=bool(args.reduced))
    m = get_model(cfg)
    if m.is_encdec:
        raise SystemExit("decoder-only serving; use examples for enc-dec")
    params = m.init(0, device=device)
    heads = ClusterHeads.init(1, params.head, n_clusters=args.clusters)

    rng = np.random.default_rng(args.seed)
    reqs = make_requests(rng, args.requests, cfg.vocab, args.prompt_len,
                         args.gen, args.clusters)
    total_tok = sum(r.gen for r in reqs)

    if args.mode == "static":
        # pad everything to a uniform batch, per-token dispatch, one
        # cluster at a time
        t0 = obs.now()
        for t in range(args.clusters):
            batch = [r for r in reqs if r.cluster == t]
            if not batch:
                continue
            plen = max(len(r.tokens) for r in batch)
            gen = max(r.gen for r in batch)
            prompts = np.zeros((len(batch), plen), np.int32)
            for j, r in enumerate(batch):
                prompts[j, plen - len(r.tokens):] = r.tokens  # left pad
            stats = greedy_decode(m, params,
                                  torch.from_numpy(prompts).to(device), gen,
                                  logits_fn=cluster_logits_fn(heads, t))
            print(f"cluster {t}: batch {len(batch)} prefill {plen} tok "
                  f"({stats.prefill_dispatches} dispatches) ttft "
                  f"{stats.ttft_s * 1e3:.1f}ms decode {stats.tok_per_s:.0f} "
                  f"tok/s")
        wall = obs.now() - t0
        print(f"static: {total_tok} tok (upper bound) in {wall:.2f}s")
        _save_events(args.events)
        return

    scfg = ServeConfig(slots=args.slots, wave=args.wave,
                       prefill_chunk=args.prefill_chunk,
                       max_prompt=args.prompt_len, max_gen=args.gen,
                       max_len=args.prompt_len + args.gen)
    engine = ServeEngine(m, params, heads, scfg)
    stats = engine.serve(reqs)
    print(f"continuous: {stats.total_tokens} tok in {stats.wall_s:.2f}s "
          f"({stats.aggregate_tok_per_s:.0f} tok/s aggregate) on "
          f"{device.type}")
    print(f"  decode rounds {stats.decode_rounds}, slot utilization "
          f"{stats.slot_utilization:.2f}, mean ttft "
          f"{stats.mean_ttft_s * 1e3:.1f}ms")
    print(f"  prefill dispatches {stats.prefill_dispatches} "
          f"({stats.prefill_scan_steps} chunks each), decode "
          f"dispatches {stats.decode_dispatches}, programs {stats.traces}")
    print("sample:", stats.results[0].tokens.tolist()[:24])
    _save_events(args.events)


def _save_events(path) -> None:
    if path:
        obs.save_events(path)
        print(f"wrote {len(obs.events())} event(s) to {path}")
        obs.disable()


if __name__ == "__main__":
    main()
