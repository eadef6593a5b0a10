"""The paper's technique on the transformer zoo: federated LM users, the
port's counterpart of ``examples/lm_federated.py``.

Users hold token streams from different domains (low-rank bigram
sources).  Phi for token data is a fixed shared random embedding,
mean-pooled over windows (the LM analogue of the paper's fixed conv
features).  The one-shot algorithm groups same-domain users on the CUDA
device; each LPS then fine-tunes a REDUCED qwen3-family model with
FedAvg (``fed/fedavg.py``) and AdamW (``repro_torch.optim``), sharing
the common representation (the embedding) through the GPS
(``fed/hierarchy.py::gps_aggregate``).  Training runs the models' plain
paths, as ``launch/train.py`` does.

    PYTHONPATH=src python -m repro_torch.examples.lm_federated --steps 30
    PYTHONPATH=src python -m repro_torch.examples.lm_federated --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.base import get_arch
from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data import tokens as tok
from repro_torch.examples.common import to_host
from repro_torch.fed import hierarchy as hier
from repro_torch.fed import partition as fpart
from repro_torch.fed.fedavg import fedavg
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.registry import get_model

VOCAB = 256
BATCH, SEQ = 4, 64


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--users-per-domain", type=int, default=3)
    ap.add_argument("--domains", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def model_config():
    """The REDUCED qwen3 config at the example's vocabulary."""
    return dataclasses.replace(get_arch("qwen3_1_7b", reduced=True),
                               vocab=VOCAB)


def main(argv=None) -> dict:
    """Run the example; returns the clustering labels and accuracy, each
    round's per-LPS mean client loss (``losses[round][lps]``, the loss
    before each client's last step) and every client step's loss
    (``step_losses[round][lps][member]``)."""
    return run(build_parser().parse_args(argv))


def run(args, lps_init: list[dict] | None = None) -> dict:
    """The example on ``args.device``.  ``lps_init`` replaces each LPS's
    initial parameters (port names -> tensors)."""
    device = resolve_device(args.device)
    # --- 1. users + one-shot clustering on token features -------------
    specs = [tok.TokenTaskSpec(vocab=VOCAB, seed=d)
             for d in range(args.domains)]
    users, true = [], []
    for d, spec in enumerate(specs):
        for u in range(args.users_per_domain):
            users.append(tok.sample_tokens(spec, 4096, seed=(d, u)))
            true.append(d)
    feats = [tok.token_features(s, d=64, window=8, vocab=VOCAB)
             for s in users]
    res = oneshot.one_shot_clustering(feats, n_clusters=args.domains,
                                      cfg=SimilarityConfig(top_k=8),
                                      device=device)
    labels = to_host(res.labels)
    acc = clu.clustering_accuracy(labels, true)
    print(f"one-shot clustering on token features: accuracy {acc:.0%} "
        f"(labels={labels.tolist()})")

    # --- 2. per-LPS FedAvg on a reduced qwen3, common layers via GPS ---
    cfg = model_config()
    m = get_model(cfg)
    is_common = fpart.prefix_predicate(["embed"])  # shared representation
    work = m.init(0, device=device).requires_grad_(True)
    names = [name for name, _ in work.named_parameters()]
    if lps_init is None:
        lps_params = [{k: p.detach() for k, p in
                       m.init(t, device=device).named_parameters()}
                      for t in range(args.domains)]
    else:
        lps_params = [{k: v.to(device) for k, v in p.items()}
                      for p in lps_init]
    opt = optim.adamw(3e-3)

    def client_step(params, batch):
        """One AdamW step from a fresh optimizer state, as the
        reference's client step takes it."""
        with torch.no_grad():
            for name, p in work.named_parameters():
                p.copy_(params[name])
        loss = m.loss_fn(work, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, list(work.parameters()))))
        with torch.no_grad():
            upd, _ = opt.update(grads, opt.init(params), params)
            return optim.apply_updates(params, upd), loss.detach()

    history, step_history = [], []
    for rnd in range(args.steps // 10):
        round_losses, round_steps = [], []
        for t in range(args.domains):
            members = [i for i, l in enumerate(labels) if l == t]
            new_params, losses, steps = [], [], []
            for i in members:
                stream = users[i]
                off = (rnd * 17) % (len(stream) - BATCH * SEQ - 1)
                chunk = stream[off: off + BATCH * SEQ + 1]
                batch = {
                    "tokens": torch.from_numpy(
                        chunk[:-1].reshape(BATCH, SEQ)).to(device),
                    "labels": torch.from_numpy(
                        chunk[1:].reshape(BATCH, SEQ)).to(device)}
                p = lps_params[t]
                steps.append([])
                for _ in range(10 // args.domains):
                    p, loss = client_step(p, batch)
                    steps[-1].append(float(loss))
                new_params.append(p)
                losses.append(steps[-1][-1])
            lps_params[t] = fedavg(new_params, [1] * len(new_params))
            round_losses.append(float(np.mean(losses)))
            round_steps.append(steps)
            print(f"round {rnd} LPS {t}: loss {round_losses[-1]:.3f}")
        history.append(round_losses)
        step_history.append(round_steps)
        # GPS: average the common representation across LPSs
        lps_params = hier.gps_aggregate(lps_params, [1.0] * args.domains,
                                        is_common)
    print("done — per-LPS models trained; common layers GPS-averaged.")
    return {"labels": labels, "accuracy": acc, "losses": history,
            "step_losses": step_history}


if __name__ == "__main__":
    main()
