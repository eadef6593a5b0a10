"""Shared helpers for the port's trainer tests: the reference's draws,
injected into the port's trainer, and model bundles of both packages.

``ReferenceDraws`` derives every draw exactly as the JAX trainer does
(``_cluster_base_key``, ``fold_in``, ``sample_batch_indices``,
``participation_mask``, ``models[t].init(init_keys[t])``), so the two
trainers see the same initial parameters, batches and masks.
"""
import jax
import numpy as np

from repro.fed import client as ref_client
from repro.fed import partition as ref_part
from repro.fed import trainer as ref_trainer
from repro.models import cnn as ref_cnn
from repro.models import mlp as ref_mlp
from _torch_dist_support import port_mlp_models  # noqa: F401
from repro_torch import convert
from repro_torch.fed import partition as fpart
from repro_torch.fed import trainer as ftrainer
from repro_torch.models import cnn


class ReferenceDraws:
    """The JAX trainer's draws for ``train_mthfl(..., draws=...)``."""

    def __init__(self, users, labels, ref_models, cfg, cluster_classes,
                 to_port):
        self.cfg = cfg
        self.setup = ref_trainer._setup_clusters(
            users, np.asarray(labels), len(ref_models), cfg.seed,
            cluster_classes)
        self.params = [to_port(m.init(k))
                       for m, k in zip(ref_models, self.setup.init_keys)]

    def init_params(self, t):
        return self.params[t]

    def batch_indices(self, t, g, l):
        rk = jax.random.fold_in(
            jax.random.fold_in(self.setup.data_keys[t], g), l)
        return np.stack([np.asarray(ref_client.sample_batch_indices(
            jax.random.fold_in(rk, uid), self.cfg.local_steps,
            self.cfg.batch_size, n))
            for uid, n in zip(self.setup.uids[t], self.setup.n_samples[t])])

    def participation(self, t, g, rate):
        return np.asarray(ref_client.participation_mask(
            jax.random.fold_in(self.setup.data_keys[t], g),
            self.setup.uids[t], rate))


def ref_mlp_models(mcfg, n):
    return [ref_trainer.TaskModel(
        init=lambda k, c=mcfg: ref_mlp.init(c, k),
        loss_fn=ref_mlp.loss_fn(mcfg),
        accuracy=lambda p, x, y, c=mcfg: ref_mlp.accuracy(c, p, x, y),
        is_common=ref_part.prefix_predicate(ref_mlp.COMMON_PREFIXES))
        for _ in range(n)]


def ref_cnn_models(ccfg, n):
    return [ref_trainer.TaskModel(
        init=lambda k, c=ccfg: ref_cnn.init(c, k),
        loss_fn=ref_cnn.loss_fn(ccfg),
        accuracy=lambda p, x, y, c=ccfg: ref_cnn.accuracy(c, p, x, y),
        is_common=ref_part.prefix_predicate(ref_cnn.COMMON_PREFIXES))
        for _ in range(n)]


def port_cnn_models(ccfg, n):
    return [ftrainer.TaskModel(
        init=lambda g, c=ccfg: cnn.init(c, g),
        loss_fn=cnn.loss_fn(ccfg),
        accuracy=lambda p, x, y, c=ccfg: cnn.accuracy(c, p, x, y),
        is_common=fpart.prefix_predicate(cnn.COMMON_PREFIXES))
        for _ in range(n)]


def mlp_to_port(mcfg):
    return lambda p: convert.paper_mlp_params_from_reference(
        p, mcfg, device="cpu")


def cnn_to_port(ccfg):
    return lambda p: convert.paper_cnn_params_from_reference(
        p, ccfg, device="cpu")


def port_evals(evals):
    return [(np.asarray(x), np.asarray(y)) for x, y in evals]
