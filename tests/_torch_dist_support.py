"""Rank bodies and helpers for the port's multi-device tests.

Nothing here imports JAX or the reference package: the ranks are fresh
processes that unpickle these functions by import path, and each would
otherwise pay for a JAX import.  The test process computes every
reference output and hands the ranks plain arrays.
"""
import contextlib
import dataclasses
import os
import tempfile
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as mdist
from repro_torch.core import similarity as sim
from repro_torch.core.engine import ProtocolEngine
from repro_torch.core.membership_engine import (MembershipConfig,
                                                MembershipEngine)
from repro_torch.core.oneshot import one_shot_clustering
from repro_torch.core import signature_engine as sig
from repro_torch.core.signature_engine import SignatureConfig
from repro_torch.fed import hierarchy as fhier
from repro_torch.fed import partition as fpart
from repro_torch.fed import trainer as ftrainer
from repro_torch.models import mlp

CPU = torch.device("cpu")


@contextlib.contextmanager
def one_rank_world(axis: str = "data", device_type: str = "cpu"):
    """A one-rank process group in this process (gloo for the CPU, NCCL
    for the current CUDA device) and its 1-D mesh; the group is destroyed
    on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(mdist.BACKEND_FOR[device_type],
                                init_method=f"file://"
                                f"{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0)
        try:
            yield mdist.make_user_mesh(axis, device_type)
        finally:
            dist.destroy_process_group()


class RecordedDraws:
    """A trainer's draws (``init_params``, ``batch_indices``,
    ``participation``) recorded as arrays for the clusters that have
    members, so that they cross to the ranks by pickle."""

    def __init__(self, draws, sizes, cfg):
        self.params = [{k: v.detach().cpu().clone()
                        for k, v in draws.init_params(t).items()}
                       for t in range(len(sizes))]
        live = [t for t, n in enumerate(sizes) if n]
        rounds = range(cfg.global_rounds)
        self.batches = {(t, g, l): np.asarray(draws.batch_indices(t, g, l))
                        for t in live for g in rounds
                        for l in range(cfg.local_rounds)}
        self.rate = cfg.dropout_frac
        self.parts = {(t, g): np.asarray(draws.participation(t, g,
                                                             self.rate))
                      for t in live for g in rounds}

    def init_params(self, t):
        return {k: v.clone() for k, v in self.params[t].items()}

    def batch_indices(self, t, g, l):
        return self.batches[(t, g, l)]

    def participation(self, t, g, rate):
        assert rate == self.rate, (rate, self.rate)
        return self.parts[(t, g)]


def port_mlp_models(mcfg, n):
    return [ftrainer.TaskModel(
        init=lambda g, c=mcfg: mlp.init(c, g),
        loss_fn=mlp.loss_fn(mcfg),
        accuracy=lambda p, x, y, c=mcfg: mlp.accuracy(c, p, x, y),
        is_common=fpart.prefix_predicate(mlp.COMMON_PREFIXES))
        for _ in range(n)]


def recording(models, seen: dict):
    """``models`` whose accuracy records, per cluster, the parameters it
    was last called with (the final round's, after a run): the port's as
    numpy arrays, the reference's as they come."""
    def rec(t, acc):
        def f(p, x, y):
            seen[t] = {k: v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else v for k, v in p.items()}
            return acc(p, x, y)
        return f
    return [dataclasses.replace(m, accuracy=rec(t, m.accuracy))
            for t, m in enumerate(models)]


def train_port(case, cfg, mesh=None):
    """The port's fused trainer on a case from the test process; returns
    ``(history, final params per cluster)``."""
    seen: dict = {}
    hist = ftrainer.train_mthfl(
        case["users"], case["labels"],
        recording(port_mlp_models(case["mcfg"], case["n"]), seen),
        case["evals"], cfg, cluster_classes=case["classes"], fused=True,
        draws=case["draws"], device=CPU, mesh=mesh)
    return hist, seen


def _error(fn) -> str:
    """The message of the ValueError or RuntimeError ``fn`` raises, or
    ``""`` if it raises none."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return str(e)
    return ""


def suite(rank: int, world: int, inputs: dict) -> dict:
    """Every sharded path on this rank, over the default group: what each
    returns, as numpy, for the test process to check."""
    mesh = mdist.make_user_mesh("data")
    out = {}

    feats = inputs["protocol"]
    out["protocol"] = {}
    for top_k in (6, 2):
        cfg = sim.SimilarityConfig(top_k=top_k, backend="shard_map")
        res = ProtocolEngine(cfg, mesh=mesh, device=CPU).run(feats)
        out["protocol"][top_k] = {
            k: getattr(res, k).numpy()
            for k in ("similarity", "relevance", "lam", "v")}
    cfg = sim.SimilarityConfig(top_k=6, backend="shard_map")
    out["labels"] = one_shot_clustering(feats, 3, cfg=cfg, device=CPU,
                                        mesh=mesh).labels.numpy()
    out["indivisible"] = _error(lambda: ProtocolEngine(
        cfg, mesh=mesh, device=CPU).similarity(feats[:22]))
    out["distributed_similarity"] = mdist.distributed_similarity(
        inputs["fed"], mesh, sim.SimilarityConfig(top_k=8),
        axis="data").numpy()

    raw, fcfg = inputs["raw"], inputs["raw_feature"]
    scfg = SignatureConfig(backend="shard_map", chunk_rows=16, check=True)
    eng = ProtocolEngine(cfg, mesh=mesh, device=CPU)
    out["raw"] = eng.similarity_from_raw(raw, fcfg,
                                         signature_cfg=scfg).numpy()
    # The residuals the check reads, as the sharded path gathers them.
    check = sig.SignatureEngine.verify_convergence
    with mock.patch.object(sig.SignatureEngine, "verify_convergence",
                           autospec=True, side_effect=check) as spy:
        eng.run_raw(raw, fcfg, signature_cfg=scfg)
    out["raw_resid"] = spy.call_args.args[1].numpy()
    out["raw_unconverged"] = _error(lambda: eng.run_raw(
        raw, fcfg, signature_cfg=dataclasses.replace(
            scfg, subspace_iters=0, oversample=2)))

    lam, v, labels = inputs["directory"]
    mem = MembershipEngine(MembershipConfig(backend="torch"), device=CPU)
    mem.seed(lam, v, labels, n_clusters=4)
    got = mem.assign_sharded(lam, v, mesh=mesh)
    out["assign"] = {k: getattr(got, k).numpy()
                     for k in ("labels", "affinity", "margin")}
    mem3 = MembershipEngine(MembershipConfig(backend="torch"), device=CPU)
    mem3.seed(lam, v, np.minimum(labels, 2), n_clusters=3)
    out["assign_indivisible"] = _error(
        lambda: mem3.assign_sharded(lam, v, mesh=mesh))

    values, onehot, weights = inputs["cluster_mean"]
    rows = mdist.local_rows(len(weights), mesh.get_group("data"), "data")
    out["cluster_mean"] = {
        k: v.numpy() for k, v in fhier.masked_cluster_mean(
            {k: torch.from_numpy(v[rows]) for k, v in values.items()},
            torch.from_numpy(onehot[rows]), torch.from_numpy(weights[rows]),
            axis=mesh.get_group("data")).items()}

    tmesh = mdist.make_user_mesh("clusters")
    out["trainer"] = {}
    for name, case in inputs["trainer"].items():
        cfg_t = dataclasses.replace(case["cfg"], backend="shard_map")
        hist, params = train_port(case, cfg_t, mesh=tmesh)
        out["trainer"][name] = (hist.accuracy, hist.train_loss, params)
    return out
