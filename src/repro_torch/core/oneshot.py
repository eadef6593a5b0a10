"""One-shot clustering protocol (paper Algorithm 2), PyTorch port.

Mirrors ``src/repro/core/oneshot.py`` on one device: the
``ProtocolEngine`` (Eqs. 1-5; dense, blockwise, landmarks, or from raw
data), the ``ClusterEngine`` (HAC + cut) and the communication ledger;
``hierarchy_cfg`` routes to the two-level protocol of
``core/hierarchy.py``.  Telemetry: the flat paths record the
``oneshot.run`` span (``n_clusters``) around protocol, HAC and cut, and
mirror the ledger into the ``comm.*`` gauges after it, as the reference
does; the hierarchical path returns before the span.
With the torch cluster backend, ``R`` and the labels stay on the device
from protocol to labels.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import clustering as clu
from repro_torch.core import similarity as sim
from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                             DeviceDendrogram)
from repro_torch.core.engine import ProtocolEngine

__all__ = ["CommLedger", "OneShotResult", "one_shot_clustering"]

_LEDGER_MODES = ("broadcast", "streaming")


@dataclasses.dataclass(frozen=True)
class CommLedger:
    """Bytes moved by the clustering protocol.

    ``dtype_bytes`` parameterizes the wire precision (4 = fp32 default;
    2 models an fp16/bf16 signature exchange).  ``mode`` selects the
    exchange pattern the engine actually ran:

    * ``"broadcast"`` — the paper's star topology: every user receives
      each other user's ``V_j`` as a separate per-peer transfer, so the
      per-user download is ``(N - 1) * k * d`` duplicated broadcasts.
    * ``"streaming"`` — the blockwise engine mode: the GPS assembles the
      signature table once and each user fetches the whole
      ``O(N * d * k)`` table in one download (its own row rides along for
      table alignment) instead of N - 1 per-peer duplicates.

    The ledger is INGEST-INVARIANT: whether signatures come from the
    host-numpy Phi stage, the streaming ``SignatureEngine`` (raw-data
    entry point) or the subspace-iteration eigensolver, what each user
    uploads is the same ``(k x d)`` eigenvector block + relevance row —
    the per-user upload stays O(k * d) regardless of how it was computed.

    ``per_user_upload``: what one user sends (V_i + its relevance row).
    ``gps_total``: what the GPS receives (N relevance rows).
    ``iterative_equiv``: what ONE ROUND of weight-based iterative
    clustering would upload per user for a ``model_params``-weight model —
    the literature baseline the paper contrasts against (its Fig. 4
    point).

    ARRIVAL ACCOUNTING (``core.membership_engine`` serving): a newcomer
    joining AFTER the one-shot round uploads exactly one ``(k x d)``
    signature block (``assign_upload`` — no relevance row: the GPS scores
    it against its cluster directory) and downloads one ``int32`` label
    (``assign_download`` — no signature-table broadcast).  Arrival cost
    is independent of the population N, unlike ``per_user_upload``, which
    carries the O(N) relevance row.
    """

    n_users: int
    d: int
    top_k: int
    model_params: int = 0
    dtype_bytes: int = 4
    mode: str = "broadcast"

    def __post_init__(self):
        if self.mode not in _LEDGER_MODES:
            raise ValueError(f"mode must be one of {_LEDGER_MODES}, "
                             f"got {self.mode!r}")
        if self.dtype_bytes <= 0:
            raise ValueError(f"dtype_bytes must be positive, "
                             f"got {self.dtype_bytes}")

    @property
    def signature_table_bytes(self) -> int:
        """The assembled ``(N, d, k)`` signature table the GPS hosts."""
        return self.dtype_bytes * self.n_users * self.top_k * self.d

    @property
    def per_user_upload(self) -> int:
        return self.dtype_bytes * (self.top_k * self.d + self.n_users)

    @property
    def per_user_download(self) -> int:
        if self.mode == "streaming":
            return self.signature_table_bytes
        return self.dtype_bytes * (self.n_users - 1) * self.top_k * self.d

    @property
    def assign_upload(self) -> int:
        """One newcomer's arrival upload: its ``(k x d)`` signature."""
        return self.dtype_bytes * self.top_k * self.d

    @property
    def assign_download(self) -> int:
        """One newcomer's arrival download: a single ``int32`` cluster
        label — no signature-table or model download."""
        return 4

    @property
    def gps_total(self) -> int:
        return self.dtype_bytes * self.n_users * self.n_users

    @property
    def iterative_equiv(self) -> int:
        return self.dtype_bytes * self.model_params

    def summary(self) -> dict:
        return {
            "n_users": self.n_users,
            "d": self.d,
            "top_k": self.top_k,
            "dtype_bytes": self.dtype_bytes,
            "mode": self.mode,
            "per_user_upload_bytes": self.per_user_upload,
            "per_user_download_bytes": self.per_user_download,
            "assign_upload_bytes": self.assign_upload,
            "assign_download_bytes": self.assign_download,
            "assign_vs_protocol_upload_ratio": (
                self.assign_upload / self.per_user_upload),
            "signature_table_bytes": self.signature_table_bytes,
            "gps_total_bytes": self.gps_total,
            "iterative_per_round_upload_bytes": self.iterative_equiv,
            "oneshot_vs_iterative_ratio": (
                self.per_user_upload / self.iterative_equiv
                if self.model_params else None),
        }


@dataclasses.dataclass(frozen=True)
class OneShotResult:
    """Labels + intermediates.  With the torch cluster backend, ``labels``,
    ``similarity`` and ``relevance`` are tensors on the device; the numpy
    backend returns host arrays.  ``lam``/``v`` are the shared per-user
    signatures, exactly what each user uploaded."""

    labels: np.ndarray | torch.Tensor        # (N,) cluster 0..T-1
    similarity: np.ndarray | torch.Tensor    # (N, N) symmetrized R
    relevance: np.ndarray | torch.Tensor     # (N, N) directed r(i, j)
    dendrogram: clu.Dendrogram | DeviceDendrogram
    ledger: CommLedger
    lam: torch.Tensor | None = None          # (N, k) shared spectra
    v: torch.Tensor | None = None            # (N, d, k) shared eigenvectors


def one_shot_clustering(features: Sequence[np.ndarray] | np.ndarray
                        | torch.Tensor,
                        n_clusters: int,
                        cfg: sim.SimilarityConfig | None = None,
                        model_params: int = 0,
                        n_valid=None,
                        cluster_cfg: ClusterConfig | None = None,
                        feature_cfg=None,
                        probe: np.ndarray | None = None,
                        signature_cfg=None,
                        device: str | torch.device = "cuda",
                        hierarchy_cfg=None,
                        mesh=None):
    """Run paper Algorithm 2 end to end on per-user feature matrices.

    ``features``: a list of ``(n_i, d)`` arrays, or a padded ``(N, n, d)``
    array or tensor with the true per-user counts in ``n_valid``.  The
    protocol runs on ``device`` (default ``"cuda"``, which raises without
    a card; ``"cpu"`` runs the kernels' plain versions).  ``cluster_cfg``
    chooses the decision layer and its linkage: by default the NN-chain
    on ``device`` (``backend="torch"``), which keeps ``R`` and the labels
    there; the host reference HAC only with ``backend="numpy"``.
    ``mesh`` is only consulted by the sharded backend
    (``cfg.backend="shard_map"``): every rank passes the same users, and
    every rank runs the decision layer on the replicated ``R`` and gets
    the same labels.

    Raw-data entry point: passing ``feature_cfg`` (a
    ``repro_torch.data.features.FeatureConfig``) declares ``features`` to
    be raw user shards ``(n_i, m)`` instead; the ``SignatureEngine``
    then runs featurize -> Gram -> top-k signatures on the device
    (configured by ``signature_cfg``), with no host Phi stage and no
    ``(N, n, d)`` feature stack.  ``probe`` carries the public ``pca``
    probe set.

    Hierarchical entry point: passing ``hierarchy_cfg`` (a
    ``repro_torch.core.hierarchy.HierarchyConfig``) routes to the
    two-level edge-group protocol, O(G (N/G)^2 + (G T_g)^2) instead of
    O(N^2), and returns a ``HierarchicalResult``: the same ``labels`` /
    ``lam`` / ``v`` / ``ledger`` contract (``from_oneshot`` serves it),
    and no N x N ``similarity`` or dendrogram.  Pre-featurised users
    only; the cluster backend defaults to the device NN-chain.
    """
    if not isinstance(model_params, numbers.Integral):
        # The reference's fourth positional argument is the linkage; here
        # it lands in model_params.
        raise TypeError(
            f"model_params must be an integer parameter count, got "
            f"{model_params!r}; the linkage goes in "
            f"cluster_cfg=ClusterConfig(linkage=...)")
    if feature_cfg is None and (probe is not None
                                or signature_cfg is not None):
        raise ValueError("probe/signature_cfg configure the raw-data "
                         "entry point; pass feature_cfg to enable it")
    if hierarchy_cfg is not None:
        if feature_cfg is not None:
            raise ValueError("the hierarchical path consumes pre-"
                             "featurized users; run the SignatureEngine "
                             "separately before hierarchy_cfg")
        from repro_torch.core.hierarchy import hierarchical_one_shot

        return hierarchical_one_shot(
            features, n_clusters, cfg=cfg, hierarchy_cfg=hierarchy_cfg,
            cluster_cfg=cluster_cfg, n_valid=n_valid,
            model_params=model_params, device=device)
    with obs.span("oneshot.run", n_clusters=n_clusters):
        engine = ProtocolEngine(cfg, mesh=mesh, device=device)
        if feature_cfg is not None:
            res = engine.run_raw(features, feature_cfg, n_valid=n_valid,
                                 probe=probe, signature_cfg=signature_cfg)
        else:
            res = engine.run(features, n_valid)
        cengine = ClusterEngine(cluster_cfg, device=engine.device)
        if cengine.on_device:
            big_r, relevance = res.similarity, res.relevance
        else:
            big_r = res.similarity.cpu().numpy()
            relevance = res.relevance.cpu().numpy()
        dend = cengine.hac(big_r)
        labels = cengine.cut(dend, n_clusters)
        ledger = CommLedger(
            n_users=res.n_users, d=res.d, top_k=res.top_k,
            model_params=model_params,
            mode="streaming" if engine.cfg.block_users else "broadcast")
    obs.record_ledger(ledger)
    return OneShotResult(labels=labels, similarity=big_r,
                         relevance=relevance, dendrogram=dend,
                         ledger=ledger, lam=res.lam, v=res.v)
