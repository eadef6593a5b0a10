"""Batched serving demo, the port's counterpart of
``examples/serve_demo.py``: prefill and KV-cache decode on a REDUCED
arch, on the CUDA device.

Teacher-forced prefill fills the cache, then the decode step generates
tokens one at a time (greedy).  The loop is
``launch/decode_loop.py::greedy_decode``, the one ``launch/serve.py``
drives.  Weights are the port's random init (seed 0).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo \\
        --arch granite_8b --batch 4 --gen 16
    PYTHONPATH=src python -m repro_torch.examples.serve_demo \\
        --arch rwkv6_1_6b --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.decode_loop import DecodeStats, greedy_decode
from repro_torch.models.registry import get_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> DecodeStats:
    """Run the demo; returns ``greedy_decode``'s stats."""
    return run(build_parser().parse_args(argv))


def run(args, model=None, prompt: torch.Tensor | None = None
        ) -> DecodeStats:
    """The demo on ``args.device``; ``model`` and ``prompt`` replace the
    random weights and the random prompt."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=True)
    m = get_model(cfg)
    if m.is_encdec:
        raise SystemExit("use a decoder-only arch for this demo")
    if model is None:
        model = m.init(0, device=device)
    if prompt is None:
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                               generator=gen, dtype=torch.int32)
    with torch.no_grad():
        stats = greedy_decode(m, model, prompt.to(device), args.gen)
    print(f"prefill {args.prompt_len} tokens: {stats.prefill_s:.2f}s")
    print(f"generated {args.gen} tokens x {args.batch} seqs "
        f"in {stats.decode_s:.2f}s ({stats.tok_per_s:.1f} tok/s)")
    print("sample:", stats.tokens[0].tolist())
    return stats


if __name__ == "__main__":
    main()
