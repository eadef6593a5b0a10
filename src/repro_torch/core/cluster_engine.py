"""GPS decision layer (paper §II-C), PyTorch port of ``ClusterEngine``.

Mirrors ``src/repro/core/cluster_engine.py``:

  backend   | execution
  ----------|------------------------------------------------------------
  "numpy"   | the host reference: ``clustering.hac`` / ``clustering.cut``
  "torch"   | nearest-neighbour-chain HAC on the engine's device, then a
            | device cut (top-(N-T) union forest + pointer jumping)

On a CUDA device the whole NN-chain loop is one persistent kernel
(``kernels/linkage``); on the CPU it is the plain Python loop over the
fused step.  For the reducible linkages (single / complete / average)
the reciprocal-NN merges are exactly the greedy dendrogram, so the labels
equal the reference HAC's up to tie order.  Telemetry: the ``cluster.hac``
span (``backend``, ``linkage``) and ``cluster.hac_runs`` counter, and the
``cluster.cut`` span (``n_clusters``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import clustering as clu
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.linkage import ops as lk_ops
from repro_torch.kernels.linkage.ref import LINKAGES

__all__ = ["ClusterConfig", "ClusterEngine", "DeviceDendrogram",
           "CLUSTER_BACKENDS", "cut_device", "cut_device_grouped"]

CLUSTER_BACKENDS = ("numpy", "torch")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """``backend``: "torch" (the default: NN-chain on the engine's device)
    or "numpy" (the host reference, only when asked for); ``linkage``:
    "average" | "single" | "complete" (similarity semantics)."""

    backend: str = "torch"
    linkage: str = "average"


@dataclasses.dataclass(frozen=True)
class DeviceDendrogram:
    """Merge history of the device NN-chain HAC, in CHAIN order.

    ``merge_rows[t] = (i, j)``: at chain step ``t`` the cluster at row
    ``j`` merged into row ``i`` (``i < j``) at similarity ``heights[t]``.
    Chain order is not height order: ``to_host()`` sorts into the greedy
    sequence.
    """

    n_leaves: int
    merge_rows: torch.Tensor       # (N-1, 2) int32, (surviving, dying)
    heights: torch.Tensor          # (N-1,) float32

    def to_host(self) -> clu.Dendrogram:
        """Greedy-order ``clustering.Dendrogram`` (sort by height desc,
        replay to assign node ids)."""
        rows = self.merge_rows.cpu().numpy()
        h = self.heights.cpu().numpy().astype(np.float64)
        order = np.argsort(-h, kind="stable")
        node_of = {i: i for i in range(self.n_leaves)}
        merges = []
        for t, m in enumerate(order):
            i, j = int(rows[m, 0]), int(rows[m, 1])
            merges.append((node_of[i], node_of[j], float(h[m])))
            node_of[i] = self.n_leaves + t
        return clu.Dendrogram(n_leaves=self.n_leaves, merges=tuple(merges))


def cut_device(merge_rows: torch.Tensor, heights: torch.Tensor,
               n_leaves: int, n_clusters: int) -> torch.Tensor:
    """Labels from chain-order merges: apply the ``N - T`` highest merges
    as a union forest (dying row -> surviving row), resolve roots by
    ``ceil(log2 N)`` pointer-jumping rounds, and number clusters by
    sorted root.  One group of ``cut_device_grouped``."""
    return cut_device_grouped(merge_rows[None], heights[None], n_leaves,
                              n_clusters)[0]


def cut_device_grouped(merge_rows: torch.Tensor, heights: torch.Tensor,
                       n_leaves: int, n_clusters: int) -> torch.Tensor:
    """``cut_device`` on each group of a group axis at once:
    ``merge_rows (B, n-1, 2)``, ``heights (B, n-1)`` -> labels ``(B, n)``
    int32, each group's clusters numbered ``0..T-1`` by sorted root.

    Group b's leaves are offset by ``b n``, so the B union forests are one
    forest over ``B n`` leaves, pointer-jumped together; one sorted
    ``unique`` over all roots numbers group b's clusters ``b T .. b T + T
    - 1`` in root order (every group keeps exactly T roots), and
    subtracting ``b T`` gives the per-group numbering."""
    batch = merge_rows.shape[0]
    dev = merge_rows.device
    keep = n_leaves - n_clusters
    order = torch.argsort(-heights, dim=1, stable=True)[:, :keep]
    sel = torch.gather(merge_rows.long(), 1,
                       order[..., None].expand(-1, -1, 2))     # (B, keep, 2)
    offset = (torch.arange(batch, device=dev) * n_leaves)[:, None]
    parent = torch.arange(batch * n_leaves, dtype=torch.int64, device=dev)
    parent[(sel[..., 1] + offset).reshape(-1)] = \
        (sel[..., 0] + offset).reshape(-1)
    for _ in range(max(1, math.ceil(math.log2(max(n_leaves, 2))))):
        parent = parent[parent]
    _, labels = torch.unique(parent, sorted=True, return_inverse=True)
    labels = labels.reshape(batch, n_leaves) \
        - (torch.arange(batch, device=dev) * n_clusters)[:, None]
    return labels.to(torch.int32)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class ClusterEngine:
    """One object that owns the GPS clustering decision.

    The torch backend runs on ``device`` (default ``"cuda"``, which
    raises without a card); the numpy backend needs no device.
    """

    def __init__(self, cfg: ClusterConfig | None = None,
                 device: str | torch.device = "cuda"):
        cfg = cfg or ClusterConfig()
        if cfg.backend not in CLUSTER_BACKENDS:
            raise ValueError(f"backend must be one of {CLUSTER_BACKENDS}, "
                             f"got {cfg.backend!r}")
        if cfg.linkage not in LINKAGES:
            raise ValueError(f"linkage must be one of {LINKAGES}, "
                             f"got {cfg.linkage!r}")
        self.cfg = cfg
        self.device = resolve_device(device) if self.on_device else None

    @property
    def on_device(self) -> bool:
        return self.cfg.backend != "numpy"

    @staticmethod
    def _check_n_clusters(n_clusters: int, n: int) -> None:
        if not 1 <= n_clusters <= n:
            raise ValueError(f"n_clusters must be in [1, {n}], "
                             f"got {n_clusters}")

    def _prepare(self, similarity) -> torch.Tensor:
        """Linkage matrix on the device: a float32 copy that the NN-chain
        kernel owns and updates in place, with the diagonal at ``-inf``."""
        s = torch.as_tensor(similarity).to(device=self.device,
                                           dtype=torch.float32, copy=True)
        if s.ndim != 2 or s.shape[0] != s.shape[1]:
            raise ValueError(f"similarity must be square, got "
                             f"{tuple(s.shape)}")
        s.fill_diagonal_(float("-inf"))
        return s.contiguous()

    def hac(self, similarity) -> clu.Dendrogram | DeviceDendrogram:
        """Agglomerative clustering -> dendrogram (host or device form)."""
        with obs.span("cluster.hac", backend=self.cfg.backend,
                      linkage=self.cfg.linkage):
            dend = self._hac(similarity)
        if obs.enabled():
            obs.count("cluster.hac_runs")
        return dend

    def _hac(self, similarity) -> clu.Dendrogram | DeviceDendrogram:
        if self.cfg.backend == "numpy":
            return clu.hac(_host(similarity), linkage=self.cfg.linkage)
        s = self._prepare(similarity)
        n = s.shape[0]
        merge_rows, heights, steps = lk_ops.nn_chain(s, self.cfg.linkage)
        # NaN/Inf in R stalls the chain's comparisons and the loop stops
        # with the merge buffers part-filled; the step count is the
        # completion witness (one scalar sync).
        steps = int(steps)
        if steps != n - 1:
            raise ValueError(
                f"device HAC stopped after {steps}/{n - 1} merges — the "
                "similarity matrix likely contains NaN/Inf (the numpy "
                "backend validates values; device inputs are only "
                "shape-checked)")
        return DeviceDendrogram(n_leaves=n, merge_rows=merge_rows,
                                heights=heights)

    def cut(self, dend, n_clusters: int):
        """Dendrogram -> labels; device dendrograms cut on their device."""
        with obs.span("cluster.cut", n_clusters=n_clusters) as sp:
            if isinstance(dend, clu.Dendrogram):
                return clu.cut(dend, n_clusters)
            self._check_n_clusters(n_clusters, dend.n_leaves)
            return sp.sync(cut_device(dend.merge_rows, dend.heights,
                                      dend.n_leaves, n_clusters))

    def labels(self, similarity, n_clusters: int):
        """HAC + cut.  numpy backend -> ``np.ndarray``; torch backend -> a
        tensor on the engine's device."""
        return self.cut(self.hac(similarity), n_clusters)
