"""The MT-HFL comparison of the paper's Fig. 2 / 3, the port's copy of
``benchmarks/common.py::mthfl_compare`` and ``make_eval_spec`` (the
benchmark's timing and stamping helpers are not part of it).

``mthfl_compare`` clusters the users in one shot, trains Algorithm 1 on
those clusters and on a random partition of the same sizes
(``core/clustering.py::random_clusters``, the reference's numpy draw, so
the random labels are the reference's), seed by seed, and reports the
mean and standard deviation of the final per-cluster accuracies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data import synthetic as syn
from repro_torch.fed import trainer as ftrainer

__all__ = ["mthfl_compare", "make_eval_spec", "to_host"]


def to_host(x) -> np.ndarray:
    """A result that may live on the device (labels, R) as a host
    array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mthfl_compare(users, tasks: dict, model_builder: Callable,
                  eval_spec, n_clusters: int, seeds: Sequence[int],
                  cfg: ftrainer.MTHFLConfig,
                  feature_fn: Callable | None = None,
                  top_k: int = 8,
                  fused: bool | str = "auto",
                  device: str | torch.device = "cuda",
                  draws: Callable | None = None) -> dict:
    """Proposed (one-shot similarity) against random clustering over
    ``seeds``, on ``device``.

    Returns the reference's keys (clustering accuracy; per method the
    mean and standard deviation over seeds of the final per-cluster
    accuracy, and its per-cluster mean) and the runs behind them:
    ``labels`` (the one-shot labels), ``random_labels`` (one a seed),
    ``proposed_runs`` and ``random_runs`` (``(seeds, T)``).  ``draws(
    labels, seed, cluster_classes)`` gives a run's trainer draws
    (``train_mthfl(draws=)``); by default the trainer's own.
    """
    feats = [feature_fn(u.x) if feature_fn else u.x for u in users]
    res = oneshot.one_shot_clustering(feats, n_clusters,
                                      cfg=SimilarityConfig(top_k=top_k),
                                      device=device)
    labels = to_host(res.labels)
    true = [u.task_id for u in users]
    clu_acc = clu.clustering_accuracy(labels, true)

    def run(run_labels, seed):
        cc = []
        for t in range(n_clusters):
            counts: dict[tuple, int] = {}
            for u, l in zip(users, run_labels):
                if l == t:
                    key = tuple(u.task_classes)
                    counts[key] = counts.get(key, 0) + 1
            cc.append(list(max(counts, key=counts.get)) if counts
                      else list(list(tasks.values())[t]))
        models = [model_builder(c) for c in cc]
        evals = [eval_spec(c, tasks) for c in cc]
        hist = ftrainer.train_mthfl(
            users, run_labels, models, evals,
            dataclasses.replace(cfg, seed=seed), cluster_classes=cc,
            fused=fused, device=device,
            draws=draws(run_labels, seed, cc) if draws else None)
        return hist.accuracy[-1]

    proposed, random_base, random_labels = [], [], []
    sizes = np.bincount(labels, minlength=n_clusters)
    for seed in seeds:
        proposed.append(run(labels, seed))
        rand = clu.random_clusters(len(users), n_clusters, rng=seed,
                                   cluster_sizes=list(sizes))
        random_labels.append(rand)
        random_base.append(run(rand, seed))
    proposed = np.stack(proposed)
    random_base = np.stack(random_base)
    return {
        "clustering_accuracy": clu_acc,
        "proposed_mean": proposed.mean(),
        "proposed_std": proposed.std(),
        "proposed_per_task": proposed.mean(0),
        "random_mean": random_base.mean(),
        "random_std": random_base.std(),
        "random_per_task": random_base.mean(0),
        "labels": labels,
        "random_labels": random_labels,
        "proposed_runs": proposed,
        "random_runs": random_base,
    }


def make_eval_spec(spec: syn.SyntheticImageSpec, n: int = 60,
                   seed: int = 999):
    """``eval_spec(classes, tasks) -> (x, y_local)``: a held-out set of
    ``n`` samples a class of the task whose classes are ``classes``,
    labels remapped to the cluster's head (host numpy arrays)."""
    def eval_spec(classes, tasks):
        task_id = [k for k, v in tasks.items() if set(v) == set(classes)]
        tid = task_id[0] if task_id else 0
        x, y = syn.make_task_dataset(spec, list(classes), n, seed=seed,
                                     task_of_class={c: tid for c in classes})
        lut = {c: i for i, c in enumerate(classes)}
        return (np.asarray(x),
                np.asarray([lut[int(v)] for v in y], np.int32))
    return eval_spec
