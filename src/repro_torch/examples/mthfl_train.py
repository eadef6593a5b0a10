"""End-to-end MT-HFL driver (paper Algorithms 1 and 2), the port's
counterpart of ``examples/mthfl_train.py``.

Clusters users with the one-shot algorithm, then runs hierarchical
federated training (per-LPS FedAvg; the GPS aggregates the common
layers) and compares it against the random-clustering baseline: the
paper's Fig. 2 / 3 experiment as one script, on the CUDA device.

    PYTHONPATH=src python -m repro_torch.examples.mthfl_train \\
        --dataset fmnist --rounds 8 --seeds 3
    PYTHONPATH=src python -m repro_torch.examples.mthfl_train \\
        --dataset cifar --rounds 4 --device cpu

``--fused`` / ``--backend`` select the trainer's execution
(``repro_torch.fed.trainer``): the paper layouts have per-task head
sizes, so ``--fused auto`` (default) runs the reference loop; ``--fused
on`` forces the cluster-stacked fused program and so requires
homogeneous heads (it raises otherwise, by design).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data import partition as dpart
from repro_torch.data import synthetic as syn
from repro_torch.examples import common
from repro_torch.fed import client as fclient
from repro_torch.fed import partition as fpart
from repro_torch.fed import trainer as ftrainer
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import cnn, mlp


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["fmnist", "cifar"],
                    default="fmnist")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--fused", choices=["auto", "on", "off"],
                    default="auto",
                    help="trainer path: cluster-stacked fused program "
                         "(on/auto) or the reference loop (off)")
    ap.add_argument("--backend", choices=ftrainer.TRAINER_BACKENDS,
                    default="torch",
                    help="fused execution backend (shard_map shards the "
                         "cluster axis over the default process group)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def setup(dataset: str):
    """``(users, tasks, eval spec, n_clusters, model_builder)`` of the
    paper's layout for ``dataset``."""
    if dataset == "fmnist":
        users = dpart.paper_fmnist_three_task(seed=0, scale=0.25)
        tasks, spec, n_clusters = dpart.FMNIST_TASKS, syn.FMNIST_LIKE, 3

        def builder(classes):
            c = mlp.PaperMLPConfig(m=784, n_classes=len(classes))
            return ftrainer.TaskModel(
                init=lambda g, cc=c: mlp.init(cc, g),
                loss_fn=mlp.loss_fn(c),
                accuracy=lambda p, x, y, cc=c: mlp.accuracy(cc, p, x, y),
                is_common=fpart.prefix_predicate(mlp.COMMON_PREFIXES))
    else:
        users = dpart.paper_cifar_two_task(n_per_user=300, seed=0)
        tasks, spec, n_clusters = dpart.CIFAR_TASKS, syn.CIFAR_LIKE, 2

        def builder(classes):
            c = cnn.PaperCNNConfig(n_classes=len(classes))
            return ftrainer.TaskModel(
                init=lambda g, cc=c: cnn.init(cc, g),
                loss_fn=cnn.loss_fn(c),
                accuracy=lambda p, x, y, cc=c: cnn.accuracy(cc, p, x, y),
                is_common=fpart.prefix_predicate(cnn.COMMON_PREFIXES))
    return users, tasks, common.make_eval_spec(spec, n=60), n_clusters, \
        builder


def main(argv=None) -> dict:
    """Run the comparison; returns ``common.mthfl_compare``'s dict."""
    return run(build_parser().parse_args(argv))


def run(args, draws=None) -> dict:
    """The comparison of ``args`` on ``args.device``; ``draws`` as
    ``common.mthfl_compare``'s."""
    device = resolve_device(args.device)
    fused = {"auto": "auto", "on": True, "off": False}[args.fused]
    users, tasks, eval_spec, n_clusters, builder = setup(args.dataset)
    cfg = ftrainer.MTHFLConfig(
        global_rounds=args.rounds, local_rounds=1,
        local_steps=args.local_steps, batch_size=32,
        client=fclient.ClientConfig(lr=0.05, optimizer="momentum"),
        backend=args.backend)
    out = common.mthfl_compare(users, tasks, builder, eval_spec,
                               n_clusters, tuple(range(args.seeds)), cfg,
                               fused=fused, device=device, draws=draws)

    print(f"\n=== MT-HFL on {args.dataset} "
          f"({args.rounds} global rounds, {args.seeds} seeds) ===")
    print(f"one-shot clustering accuracy : "
          f"{out['clustering_accuracy']:.0%}")
    print(f"proposed : acc={out['proposed_mean']:.4f} "
          f"+- {out['proposed_std']:.4f}  per-task="
          f"{np.round(out['proposed_per_task'], 3)}")
    print(f"random   : acc={out['random_mean']:.4f} "
          f"+- {out['random_std']:.4f}  per-task="
          f"{np.round(out['random_per_task'], 3)}")
    verdict = "BEATS" if out["proposed_mean"] > out["random_mean"] else \
        "does NOT beat"
    print(f"--> proposed clustering {verdict} the random baseline "
          f"(paper Fig. {'3' if args.dataset == 'fmnist' else '2'})")
    return out


if __name__ == "__main__":
    main()
