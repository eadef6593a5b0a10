"""MT-HFL training loop (paper Algorithm 1), PyTorch port of
``src/repro/fed/trainer.py``: the fused path and the reference loop.

Given per-user datasets and a cluster assignment (from the one-shot
algorithm, the random baseline or the oracle), run::

  for each global round g:
    for each LPS t (cluster):
      for each local round:
        every client runs ``local_steps`` optimizer steps from the LPS model
        the LPS FedAvg-aggregates its clients
    the GPS averages the COMMON parameters across LPSs and broadcasts them

The model is pluggable through a ``TaskModel`` (init, loss, accuracy and
the common-parameter predicate).  Two executions of the same semantics:

* **Fused** (the default when the clusters' models stack): all clusters
  padded into one ``(T, C_max, ...)`` stack with a membership mask, every
  client of every cluster stepped by one vmapped gradient call a step
  (``client.masked_lps_round``), then the GPS average over the cluster
  axis (``hierarchy.gps_aggregate_stacked``).  The users' data is padded
  into a ``(T, C_max, n_max, ...)`` stack on the device once a run.
* **Reference** (``fused=False``, or ``"auto"`` when the models do not
  stack): the host loop over clusters, one ``client.fused_lps_round`` a
  cluster and local round.

``cfg.backend="shard_map"`` runs the fused path with the cluster axis
sharded over the ranks of a ``torch.distributed`` mesh axis
(``cfg.mesh_axis``), one process a device: the axis is padded to a
multiple of the axis size with inert clusters (no members, GPS weight 0),
each rank trains its slice, the GPS average is an ``all_reduce``, and the
stack and losses are gathered every round, so every rank evaluates and
returns the whole history.

Both paths train on the same draws: the initial parameters, the batch
indices and the participation masks come from one ``draws`` object.  By
default that is ``KeyedDraws``: numpy streams derived from ``cfg.seed``
and each cluster's SORTED member ids, so the batches a group of users
trains on do not depend on how the clusters are numbered or on the device,
and relabelling the clusters only permutes the history.  Tests inject the
reference's own draws through the same seam.

Masking rules (identical in both paths): an empty cluster never trains,
has weight 0 in the GPS average (it still receives the common broadcast),
and reports NaN accuracy and train loss; a misassigned user still trains
against the wrong cluster head (the degradation the paper measures).
Dropped clients still train but have weight 0, the round loss averages
only the participating clients, and a fully dropped cluster keeps its
parameters and reports a NaN loss.

The training runs in IEEE fp32 (``client.fp32_scope``), as the reference
computes.

Telemetry (``repro_torch.obs``, the reference's records): the
``trainer.train_mthfl`` span (``fused``, ``backend``, ``rounds``) over a
run, the fused path's round loop under ``trainer.rounds``, or under
``trainer.scan_rounds`` where ``cfg.scan_rounds`` is set (the name the
reference's scanned rounds record; the port's rounds run one by one
either way), and the ``trainer.runs`` and ``trainer.global_rounds``
counters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import distributed as mdist
from repro_torch.fed import client as fed_client
from repro_torch.fed import hierarchy as hier
from repro_torch.fed import partition as part
from repro_torch.kernels.dispatch import resolve_device

Params = dict[str, torch.Tensor]

__all__ = ["TaskModel", "MTHFLConfig", "MTHFLHistory", "KeyedDraws",
           "infer_cluster_classes", "train_mthfl", "TRAINER_BACKENDS"]

TRAINER_BACKENDS = ("torch", "shard_map")


@dataclasses.dataclass(frozen=True)
class TaskModel:
    """Everything the trainer needs to know about one task's model."""

    init: Callable[[torch.Generator], Params]
    loss_fn: Callable[[Params, dict], torch.Tensor]
    accuracy: Callable[[Params, Any, Any], float]
    is_common: part.PathPred


@dataclasses.dataclass(frozen=True)
class MTHFLConfig:
    global_rounds: int = 10
    local_rounds: int = 2          # LPS-level FedAvg rounds per global round
    local_steps: int = 10          # client optimizer steps per local round
    batch_size: int = 32
    client: fed_client.ClientConfig = fed_client.ClientConfig()
    seed: int = 0
    backend: str = "torch"         # fused execution: torch | shard_map
    mesh_axis: str = "clusters"    # mesh axis the cluster dim shards over
    scan_rounds: bool = False      # kept for the reference's API; the
    #                                rounds run one by one either way
    dropout_frac: float = 0.0      # per-global-round straggler/dropout rate


@dataclasses.dataclass
class MTHFLHistory:
    """Per-global-round, per-cluster test accuracy and mean train loss.

    Empty (memberless) clusters are NaN in both.  ``fused`` records which
    execution path produced the history.
    """

    accuracy: np.ndarray           # (G, T)
    train_loss: np.ndarray         # (G, T)
    labels: np.ndarray             # (N,) cluster assignment used
    fused: bool = False


# ---------------------------------------------------------------------------
# Shared setup: cluster membership, label remapping, per-cluster streams
# ---------------------------------------------------------------------------

def _cluster_base_words(seed: int, member_uids: Sequence[int], t: int
                        ) -> tuple[int, ...]:
    """Per-cluster stream root: four words from ``seed`` and the SORTED
    member ids (``uid + 1`` each), so a group of users trains under the
    same stream whatever its cluster's number; an empty cluster falls back
    to ``(0, t)``, which only seeds its unused init params."""
    if len(member_uids):
        key = [seed] + [int(u) + 1 for u in sorted(int(u)
                                                   for u in member_uids)]
    else:
        key = [seed, 0, t]
    return tuple(int(w) for w in np.random.SeedSequence(key).generate_state(4))


@dataclasses.dataclass
class _ClusterSetup:
    members: list[list]            # per-cluster member user lists
    datasets: list[list[tuple]]    # per-cluster [(x, y_local)] pairs
    uids: list[list[int]]
    n_samples: list[list[int]]
    cluster_weights: list[float]   # total samples; 0.0 for empty clusters
    cluster_classes: list[list[int]]


def _local_y(y: np.ndarray, classes: Sequence[int]) -> np.ndarray:
    """Labels remapped to the cluster's class list; a class outside it
    becomes 0, as in the reference."""
    lut = {c: i for i, c in enumerate(classes)}
    values, inverse = np.unique(np.asarray(y), return_inverse=True)
    mapped = np.asarray([lut.get(int(c), 0) for c in values], np.int32)
    return mapped[inverse.reshape(-1)]


def infer_cluster_classes(users, labels, n_clusters: int
                          ) -> list[list[int]]:
    """Each cluster's class list: its members' majority task's classes
    (on a tie, the task seen first; an empty cluster gets ``range(10)``).
    ``train_mthfl`` uses it unless the caller pins ``cluster_classes``."""
    out = []
    for t in range(n_clusters):
        counts: dict[tuple, int] = {}
        for u, l in zip(users, labels):
            if l == t:
                key_t = tuple(u.task_classes)
                counts[key_t] = counts.get(key_t, 0) + 1
        out.append(list(max(counts, key=counts.get)) if counts
                   else list(range(10)))
    return out


def _setup_clusters(users, labels: np.ndarray, n_clusters: int,
                    cluster_classes) -> _ClusterSetup:
    # Each LPS t is dedicated to one task; under random clustering
    # misplaced users train against the wrong head.
    members = [[u for u, l in zip(users, labels) if l == t]
               for t in range(n_clusters)]
    if cluster_classes is None:
        cluster_classes = infer_cluster_classes(users, labels, n_clusters)
    else:
        cluster_classes = [list(c) for c in cluster_classes]
    return _ClusterSetup(
        members=members,
        datasets=[[(u.x, _local_y(u.y, cluster_classes[t]))
                   for u in members[t]] for t in range(n_clusters)],
        uids=[[int(u.user_id) for u in members[t]]
              for t in range(n_clusters)],
        n_samples=[[int(u.n) for u in members[t]] for t in range(n_clusters)],
        cluster_weights=[float(sum(u.n for u in members[t]))
                         for t in range(n_clusters)],
        cluster_classes=cluster_classes)


class KeyedDraws:
    """The port's own draws, keyed like the reference's.

    Cluster ``t``'s stream root comes from ``seed`` and its sorted member
    ids; from it come the init stream (word 0), and under word 1 the
    batch stream of global round ``g``, local round ``l`` and user id, and
    the participation stream of round ``g``.  All are drawn on the host
    (numpy, and a CPU ``torch.Generator`` for the init), so every device
    and both execution paths see the same draws.
    """

    def __init__(self, seed: int, uids: Sequence[Sequence[int]],
                 n_samples: Sequence[Sequence[int]],
                 models: Sequence[TaskModel], steps: int, batch_size: int):
        self.uids, self.n_samples = uids, n_samples
        self.models, self.steps, self.batch_size = models, steps, batch_size
        self.base = [_cluster_base_words(seed, u, t)
                     for t, u in enumerate(uids)]

    def init_params(self, t: int) -> Params:
        seed = np.random.SeedSequence([*self.base[t], 0]).generate_state(
            1, np.uint64)[0]
        return self.models[t].init(torch.Generator().manual_seed(int(seed)))

    def batch_indices(self, t: int, g: int, l: int) -> np.ndarray:
        """``(C_t, steps, B)`` indices into each member's own rows."""
        out = np.empty((len(self.uids[t]), self.steps, self.batch_size),
                       np.int64)
        for c, (uid, n) in enumerate(zip(self.uids[t], self.n_samples[t])):
            out[c] = fed_client.sample_batch_indices(
                fed_client.keyed_stream(*self.base[t], 1, g, l, uid),
                self.steps, self.batch_size, n)
        return out

    def participation(self, t: int, g: int, rate: float) -> np.ndarray:
        """``(C_t,)`` float32 mask of the members taking part in round
        ``g``."""
        return fed_client.participation_mask((*self.base[t], 1, g),
                                             self.uids[t], rate)


def _stackable(params_list: Sequence[Params]) -> bool:
    """True iff every cluster's params have the same names, shapes and
    dtypes: the precondition for the ``(T, ...)`` stack."""
    def sig(p):
        return [(k, tuple(v.shape), v.dtype) for k, v in p.items()]
    first = sig(params_list[0])
    return all(sig(p) == first for p in params_list[1:])


def _to_device(a, dev: torch.device, dtype=None) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return a.to(device=dev, dtype=dtype)


def _data_stack(setup: _ClusterSetup, c_max: int, dev: torch.device,
                clusters: Sequence[int] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The members' data of ``clusters`` (default: all) padded into ``x
    (T, C_max, n_max, ...)`` and ``y (T, C_max, n_max)`` on ``dev``: one
    copy a user, once a run.  An index past the last cluster is an inert
    padding cluster with no members."""
    n_real = len(setup.datasets)
    clusters = list(range(n_real) if clusters is None else clusters)
    pairs = [p for ds in setup.datasets for p in ds]
    n_max = max([int(len(y)) for _, y in pairs], default=1)
    sample_shape = tuple(pairs[0][0].shape[1:]) if pairs else (1,)
    x = torch.zeros((len(clusters), c_max, n_max) + sample_shape,
                    dtype=torch.float32, device=dev)
    y = torch.zeros((len(clusters), c_max, n_max), dtype=torch.int64,
                    device=dev)
    for i, t in enumerate(clusters):
        for c, (xu, yu) in enumerate(setup.datasets[t] if t < n_real
                                     else []):
            x[i, c, :len(yu)] = _to_device(xu, dev, torch.float32)
            y[i, c, :len(yu)] = _to_device(yu, dev, torch.int64)
    return x, y


def _eval_sets(eval_sets, dev: torch.device) -> list[tuple]:
    return [(_to_device(ex, dev, torch.float32), _to_device(ey, dev))
            for ex, ey in eval_sets]


# ---------------------------------------------------------------------------
# Fused path: every cluster's clients in one vmapped call a step
# ---------------------------------------------------------------------------

def _train_fused(models, evals, cfg: MTHFLConfig, setup: _ClusterSetup,
                 lps_params: list[Params], draws, dev: torch.device,
                 group=None) -> tuple[np.ndarray, np.ndarray]:
    n_clusters = len(models)
    sizes = [len(m) for m in setup.members]
    c_max = max(1, max(sizes))
    own = list(range(n_clusters))
    if group is not None:
        # Pad the cluster axis to a multiple of the axis size; the
        # padding clusters (the first cluster's parameters, as in the
        # reference) have no members and no GPS weight.
        n_pad = (-n_clusters) % dist.get_world_size(group)
        rows = mdist.local_rows(n_clusters + n_pad, group, cfg.mesh_axis)
        own = list(range(rows.start, rows.stop))
    n_own = len(own)
    size = [sizes[t] if t < n_clusters else 0 for t in own]
    x, y = _data_stack(setup, c_max, dev, own)
    n_per = torch.ones((n_own, c_max))               # pads: n=1, masked
    mask = torch.zeros((n_own, c_max))
    for i, t in enumerate(own):
        if size[i]:
            n_per[i, :size[i]] = torch.tensor(setup.n_samples[t],
                                              dtype=torch.float32)
            mask[i, :size[i]] = 1.0
    n_per, mask = n_per.to(dev), mask.to(dev)
    p_stack = {k: torch.stack([lps_params[t if t < n_clusters else 0][k]
                               for t in own])
               for k in lps_params[0]}
    cluster_w = torch.tensor([setup.cluster_weights[t] if t < n_clusters
                              else 0.0 for t in own],
                             dtype=torch.float32, device=dev)
    optimizer = fed_client.make_optimizer(cfg.client)
    loss_fn, is_common = models[0].loss_fn, models[0].is_common
    steps, batch = cfg.local_steps, cfg.batch_size

    acc_hist = np.zeros((cfg.global_rounds, n_clusters))
    loss_hist = np.zeros((cfg.global_rounds, n_clusters))
    name = "trainer.scan_rounds" if cfg.scan_rounds else "trainer.rounds"
    with obs.span(name, rounds=cfg.global_rounds) as sp:
        for g in range(cfg.global_rounds):
            m_eff = torch.zeros((n_own, c_max))
            for i, t in enumerate(own):
                if size[i]:
                    m_eff[i, :size[i]] = torch.tensor(
                        draws.participation(t, g, cfg.dropout_frac))
            m_eff = mask * m_eff.to(dev)
            losses = []
            for l in range(cfg.local_rounds):
                idx = torch.zeros((n_own, c_max, steps, batch),
                                  dtype=torch.int64)
                for i, t in enumerate(own):
                    if size[i]:
                        idx[i, :size[i]] = torch.tensor(
                            draws.batch_indices(t, g, l))
                p_stack, loss = fed_client.masked_lps_round(
                    p_stack, x, y, n_per, m_eff, idx.to(dev), loss_fn,
                    optimizer, cfg.client.clip_norm)
                losses.append(loss)
            loss_hist[g] = mdist.all_gather_cat(
                torch.stack(losses).mean(dim=0),
                group)[:n_clusters].cpu().numpy()
            p_stack = hier.gps_aggregate_stacked(p_stack, cluster_w,
                                                 is_common, axis=group)
            full = {k: mdist.all_gather_cat(v, group)
                    for k, v in p_stack.items()}
            for t in range(n_clusters):
                if not sizes[t]:
                    acc_hist[g, t] = np.nan
                    continue
                ex, ey = evals[t]
                acc_hist[g, t] = models[t].accuracy(
                    {k: v[t] for k, v in full.items()}, ex, ey)
        sp.sync(p_stack)
    return acc_hist, loss_hist


# ---------------------------------------------------------------------------
# Reference path: the host loop over clusters
# ---------------------------------------------------------------------------

def _train_reference(models, evals, cfg: MTHFLConfig, setup: _ClusterSetup,
                     lps_params: list[Params], draws, dev: torch.device
                     ) -> tuple[np.ndarray, np.ndarray]:
    n_clusters = len(models)
    sizes = [len(m) for m in setup.members]
    x, y = _data_stack(setup, max(1, max(sizes)), dev)
    acc_hist = np.zeros((cfg.global_rounds, n_clusters))
    loss_hist = np.zeros((cfg.global_rounds, n_clusters))
    any_weight = sum(setup.cluster_weights) > 0

    for g in range(cfg.global_rounds):
        for t in range(n_clusters):
            if not sizes[t]:
                loss_hist[g, t] = np.nan
                continue
            # Dropped clients keep weight 0 in the FedAvg and are left out
            # of the round loss.
            pmask = np.asarray(draws.participation(t, g, cfg.dropout_frac))
            if pmask.sum() == 0:               # whole cluster dropped
                loss_hist[g, t] = np.nan
                continue
            ns = np.asarray(setup.n_samples[t], np.float32) * pmask
            p = lps_params[t]
            round_losses = []
            for l in range(cfg.local_rounds):
                idx = torch.tensor(draws.batch_indices(t, g, l),
                                   dtype=torch.int64, device=dev)
                batches = fed_client.batch_stack(x[t, :sizes[t]],
                                                 y[t, :sizes[t]], idx)
                p, losses = fed_client.fused_lps_round(
                    p, batches, ns, models[t].loss_fn, cfg.client)
                round_losses.append(
                    float(np.mean(losses.cpu().numpy()[pmask > 0])))
            lps_params[t] = p
            loss_hist[g, t] = float(np.mean(round_losses))
        # GPS round: average the common parameters and broadcast them
        # (empty clusters carry weight 0; skipped if every cluster is).
        if any_weight:
            lps_params = hier.gps_aggregate(
                lps_params, setup.cluster_weights, models[0].is_common)
        for t in range(n_clusters):
            if not sizes[t]:
                acc_hist[g, t] = np.nan
                continue
            ex, ey = evals[t]
            acc_hist[g, t] = models[t].accuracy(lps_params[t], ex, ey)
    return acc_hist, loss_hist


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def train_mthfl(users: Sequence,
                labels,
                models: Sequence[TaskModel],
                eval_sets: Sequence[tuple],
                cfg: MTHFLConfig,
                cluster_classes: Sequence[Sequence[int]] | None = None,
                *,
                fused: bool | str = "auto",
                draws=None,
                device: str | torch.device = "cuda",
                mesh=None) -> MTHFLHistory:
    """Run Algorithm 1 on ``device`` (default ``"cuda"``, which raises
    without a card; ``"cpu"`` only when asked).

    ``users[i]`` needs ``.x (n_i, m)``, ``.n``, ``.user_id``, ``.y`` and
    ``.task_classes``; training labels are remapped to the head of the
    cluster the user is ASSIGNED to.  ``labels`` may be a host sequence or
    a device tensor straight from the ``ClusterEngine`` cut; it is read to
    the host once, for the member bookkeeping.  ``models[t]`` /
    ``eval_sets[t]``: per-cluster model bundle and held-out ``(x,
    y_local)`` test set.

    ``fused``: ``"auto"`` runs the fused path when every cluster's params
    stack (same names, shapes and dtypes) and the reference loop
    otherwise; ``True`` requires them to stack (and uses ``models[0]``'s
    loss and predicate for every cluster); ``False`` forces the loop.
    ``draws``: the source of the initial parameters, batch indices and
    participation masks (``init_params(t)``, ``batch_indices(t, g, l)``,
    ``participation(t, g, rate)``); by default ``KeyedDraws``.
    ``cfg.backend`` picks the fused execution: ``"torch"`` on one device,
    ``"shard_map"`` with the cluster axis sharded over ``mesh``'s
    ``cfg.mesh_axis`` (default: ``make_user_mesh`` over the default
    process group); every rank passes the same arguments and gets the
    same history.
    """
    if cfg.backend not in TRAINER_BACKENDS:
        raise ValueError(f"cfg.backend must be one of {TRAINER_BACKENDS}, "
                         f"got {cfg.backend!r}")
    if not 0.0 <= cfg.dropout_frac < 1.0:
        raise ValueError("cfg.dropout_frac must be in [0, 1), got "
                         f"{cfg.dropout_frac!r}")
    dev = resolve_device(device)
    labels = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
              else np.asarray(labels))
    n_clusters = len(models)
    setup = _setup_clusters(users, labels, n_clusters, cluster_classes)
    if draws is None:
        draws = KeyedDraws(cfg.seed, setup.uids, setup.n_samples, models,
                           cfg.local_steps, cfg.batch_size)
    lps_params = [{k: _to_device(v, dev) for k, v in
                   draws.init_params(t).items()} for t in range(n_clusters)]

    can_fuse = _stackable(lps_params)
    if fused == "auto":
        use_fused = can_fuse
    elif fused:
        if not can_fuse:
            raise ValueError(
                "fused=True requires every cluster's params to stack: "
                "same names, shapes and dtypes (got heterogeneous "
                "models); use fused='auto' to fall back to the reference "
                "loop")
        use_fused = True
    else:
        use_fused = False

    with fed_client.fp32_scope(), obs.span(
            "trainer.train_mthfl", fused=use_fused, backend=cfg.backend,
            rounds=cfg.global_rounds):
        if not use_fused:
            acc, loss = _train_reference(models, _eval_sets(eval_sets, dev),
                                         cfg, setup, lps_params, draws, dev)
        else:
            group = None
            if cfg.backend == "shard_map":
                group = mdist.axis_group(
                    mesh or mdist.make_user_mesh(cfg.mesh_axis, dev.type),
                    cfg.mesh_axis, dev)
            acc, loss = _train_fused(models, _eval_sets(eval_sets, dev),
                                     cfg, setup, lps_params, draws, dev,
                                     group)
    if obs.enabled():
        obs.count("trainer.runs")
        obs.count("trainer.global_rounds", cfg.global_rounds)
    return MTHFLHistory(accuracy=acc, train_loss=loss, labels=labels,
                        fused=use_fused)
