"""Online cluster-identity serving (the MembershipEngine), PyTorch port.

Mirrors ``src/repro/core/membership_engine.py``.  After
``one_shot_clustering`` the GPS keeps a **cluster directory**: the
member signature table and per-cluster prototype projectors
``P_t = mean_{i in t} V_i V_i^T``.  A newcomer's cluster comes from the
``(d, k)`` signature it uploads, in O(T k d^2), with no protocol round.

  backend  | execution
  ---------|-------------------------------------------------------------
  "numpy"  | host reference: np.einsum affinities, host lifecycle
  "torch"  | the directory on the engine's device (``"cuda"`` unless the
           | caller asks for the CPU); waves are scored by the
           | ``kernels/assign`` wave kernel (its plain version on the CPU)

Lifecycle: ``assign`` (a wave -> labels, affinities, margins; low-margin
or low-affinity arrivals go to the unassigned bucket, label -1),
``admit`` (append to the table, streaming-mean prototype update),
``evict`` (masked removal, prototype down-date), and the drift-triggered
``recluster`` (HAC over the current table on the signature-only
relevance, relabelled for continuity with the previous ids).

Resistant prototypes: ``aggregator="trimmed"`` (coordinate-wise trimmed
mean) and ``"medians"`` (coordinate-wise median of group means) bound
the pull of Byzantine members; order statistics do not stream, so those
modes recompute the prototypes from the live table on admit and evict.
``drift_stat="median"`` trips the re-cluster on the median prototype
shift instead of the max.

Where the reference forms the ``(capacity, d, d)`` outer products of the
whole table, the port forms each cluster's mean as one
``(d, m_t k) @ (m_t k, d)`` product over its members, and the robust
statistics from one cluster's members at a time: the same sums in
another fp32 order.  ``assign_sharded`` shards the directory's
prototypes over the ranks of a ``torch.distributed`` mesh axis and
gathers the wave's affinity columns (``_verdict_from_affinity`` gives the
verdict from them).

Telemetry (``repro_torch.obs``), the reference's records by name: the
``seed``, ``assign_wave``, ``admit``, ``evict``, ``drift_trip`` and
``recluster`` events; the ``membership.assign``, ``membership.admit``,
``membership.evict`` and ``membership.recluster`` spans; the
``assign_latency_us`` histogram; the ``membership.assign_waves``,
``membership.admits``, ``membership.evicts`` and ``recluster_events``
counters; and the ``directory_bytes``, ``unassigned_frac`` and
``proto_shift`` gauges.  ``assign_sharded`` records nothing, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distributed as mdist
from repro_torch.core import similarity as sim
from repro_torch.core.cluster_engine import ClusterConfig, ClusterEngine
from repro_torch.core.hierarchy import greedy_match_labels
from repro_torch.kernels import quant
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.assign.ref import verdict as _verdict
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["MembershipConfig", "MembershipEngine", "MembershipState",
           "AssignResult", "MEMBERSHIP_BACKENDS", "UNASSIGNED",
           "signature_relevance"]

MEMBERSHIP_BACKENDS = ("numpy", "torch")
AGGREGATORS = ("mean", "trimmed", "medians")
DRIFT_STATS = ("max", "median")
UNASSIGNED = -1

#: The re-cluster's relevance, also used by the hierarchy's global stage.
signature_relevance = sim.signature_relevance


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    """Configuration of the online membership layer.

    Attributes:
      backend: "torch" (the directory on the engine's device) or "numpy"
        (the host reference).
      capacity: signature-table slots; ``0`` sizes the directory at 2x
        the seed population.
      affinity_floor: arrivals whose best affinity falls below this go to
        the unassigned bucket (label -1).  Affinities lie in [0, 1].
      margin_floor: arrivals whose best-minus-second margin falls below
        this are unassigned: the outlier and drift statistic.
      recluster_unassigned_frac: re-cluster when the unassigned fraction
        of the table exceeds this.
      recluster_proto_shift: re-cluster when the prototype shift since
        the last (re)cluster exceeds this (relative Frobenius norm).
      eig_floor: relevance eigenvalue floor of the re-cluster similarity.
      aggregator: "mean" (streaming), "trimmed" or "medians" (windowed
        recompute on admit and evict).
      trim_frac: per-end trim fraction of "trimmed", in [0, 0.5).
      mom_groups: member groups of "medians".
      drift_stat: "max" or "median" of the per-cluster prototype shifts.
      linkage: HAC linkage of the re-cluster.
      compute_dtype: input type of the assign kernel's product, "bf16"
        (default) or "fp32"; sums are fp32 either way.
      directory_dtype: storage type of the prototype table, "f32", "bf16"
        or "int8" (per-prototype scales from ``kernels.quant``, applied
        in the kernel's epilogue on the torch backend; the numpy backend
        dequantizes before scoring).
    """

    backend: str = "torch"
    capacity: int = 0
    affinity_floor: float = 0.0
    margin_floor: float = 0.0
    recluster_unassigned_frac: float = 0.25
    recluster_proto_shift: float = 0.75
    eig_floor: float = 1e-6
    aggregator: str = "mean"
    trim_frac: float = 0.1
    mom_groups: int = 5
    drift_stat: str = "max"
    linkage: str = "average"
    compute_dtype: str = "bf16"
    directory_dtype: str = "f32"

    def __post_init__(self):
        if self.backend not in MEMBERSHIP_BACKENDS:
            raise ValueError(f"backend must be one of "
                             f"{MEMBERSHIP_BACKENDS}, got {self.backend!r}")
        if self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if not 0.0 < self.recluster_unassigned_frac <= 1.0:
            raise ValueError(f"recluster_unassigned_frac must be in "
                             f"(0, 1], got {self.recluster_unassigned_frac}")
        if self.recluster_proto_shift <= 0:
            raise ValueError(f"recluster_proto_shift must be positive, "
                             f"got {self.recluster_proto_shift}")
        if self.eig_floor <= 0:
            raise ValueError(f"eig_floor must be positive, "
                             f"got {self.eig_floor}")
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"aggregator must be one of {AGGREGATORS}, "
                             f"got {self.aggregator!r}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), "
                             f"got {self.trim_frac}")
        if self.mom_groups < 1:
            raise ValueError(f"mom_groups must be >= 1, "
                             f"got {self.mom_groups}")
        if self.drift_stat not in DRIFT_STATS:
            raise ValueError(f"drift_stat must be one of {DRIFT_STATS}, "
                             f"got {self.drift_stat!r}")
        if self.compute_dtype not in assign_ops.COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be 'fp32' or 'bf16', "
                             f"got {self.compute_dtype!r}")
        if self.directory_dtype not in quant.DIRECTORY_DTYPES:
            raise ValueError(f"directory_dtype must be one of "
                             f"{quant.DIRECTORY_DTYPES}, "
                             f"got {self.directory_dtype!r}")


def _np(x) -> np.ndarray:
    """A host numpy view of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class MembershipState:
    """The cluster directory: signature table and prototypes.

    Slots are fixed at ``capacity``; ``valid`` marks occupied ones and
    ``labels`` holds cluster ids (-1: unassigned bucket or empty slot).
    ``protos0`` snapshots the prototypes at the last (re)cluster, the
    baseline of the drift statistic.  Tensors on the torch backend,
    numpy arrays on the numpy backend.  ``protos`` and ``protos0`` are in
    the directory dtype; ``proto_scales`` and ``proto0_scales`` are the
    int8 scales (``None`` for f32 and bf16).
    """

    lam: torch.Tensor | np.ndarray        # (cap, k) member spectra
    v: torch.Tensor | np.ndarray          # (cap, d, k) member eigenvectors
    labels: torch.Tensor | np.ndarray     # (cap,) int32, -1 = unassigned
    valid: torch.Tensor | np.ndarray      # (cap,) bool
    protos: torch.Tensor | np.ndarray     # (T, d, d) directory-dtype table
    counts: torch.Tensor | np.ndarray     # (T,) members per cluster
    protos0: torch.Tensor | np.ndarray    # (T, d, d) at the last cluster
    n_clusters: int
    n_reclusters: int = 0
    proto_scales: torch.Tensor | np.ndarray | None = None
    proto0_scales: torch.Tensor | np.ndarray | None = None

    @property
    def capacity(self) -> int:
        return int(self.lam.shape[0])

    @property
    def directory_bytes(self) -> int:
        """Resident bytes of the serving directory (table + scales)."""
        return quant.directory_nbytes(self.protos, self.proto_scales)

    @property
    def protos_f32(self) -> torch.Tensor | np.ndarray:
        """The dequantized ``(T, d, d)`` prototypes (f32)."""
        return quant.dequantize_directory(self.protos, self.proto_scales)

    @property
    def n_members(self) -> int:
        return int(_np(self.valid).sum())

    @property
    def n_unassigned(self) -> int:
        return int((_np(self.valid) & (_np(self.labels) < 0)).sum())


@dataclasses.dataclass(frozen=True)
class AssignResult:
    """One arrival wave's verdict: labels (-1 = unassigned), the full
    affinity rows and the confidence margins."""

    labels: torch.Tensor | np.ndarray     # (B,) int32
    affinity: torch.Tensor | np.ndarray   # (B, T)
    margin: torch.Tensor | np.ndarray     # (B,)


# ---------------------------------------------------------------------------
# Device directory primitives (torch backend, any device)
# ---------------------------------------------------------------------------

def _members(labels: torch.Tensor, valid: torch.Tensor, n_clusters: int
             ) -> torch.Tensor:
    """``(n, T)`` bool: slot holds a live member of cluster t."""
    cols = torch.arange(n_clusters, device=labels.device)
    return (labels[:, None].long() == cols[None]) & valid[:, None]


def _cluster_outer_sums(v: torch.Tensor, member: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster ``sum V_i V_i^T`` over members and the counts, one
    ``(d, m k) @ (m k, d)`` product per cluster (no ``(n, d, d)``
    tensor)."""
    _, d, _ = v.shape
    n_clusters = member.shape[1]
    sums = v.new_zeros((n_clusters, d, d))
    for t, idx in enumerate(_member_rows(member)):
        if idx.numel():
            x = v[idx].permute(1, 0, 2).reshape(d, -1)
            sums[t] = x @ x.T
    return sums, member.sum(dim=0).to(torch.float32)


def _member_rows(member: torch.Tensor) -> list[torch.Tensor]:
    """Each cluster's member rows, in slot order (one host sync)."""
    host = member.cpu().numpy()
    return [torch.from_numpy(np.flatnonzero(host[:, t])).to(member.device)
            for t in range(host.shape[1])]


def _protos_from_table(v, labels, valid, *, n_clusters: int):
    """Per-cluster mean projector from the live table rows."""
    sums, counts = _cluster_outer_sums(v, _members(labels, valid,
                                                   n_clusters))
    return sums / torch.clamp_min(counts, 1.0)[:, None, None], counts


def _protos_from_table_robust(v, labels, valid, *, n_clusters: int,
                              aggregator: str, trim_frac: float,
                              mom_groups: int):
    """Resistant per-cluster statistics over member projectors.

    "trimmed": per coordinate of the flattened ``V_i V_i^T``, drop the
    ``floor(m * trim_frac)`` smallest and largest member values (the
    count in fp32, as the reference's device path) and average the rest.
    "medians": members split round-robin by slot order into
    ``mom_groups`` groups; the coordinate-wise median of the non-empty
    groups' means.  One cluster's ``(m_t, d^2)`` outer products live at
    a time.
    """
    _, d, _ = v.shape
    member = _members(labels, valid, n_clusters)
    protos = v.new_zeros((n_clusters, d * d))
    for t, idx in enumerate(_member_rows(member)):
        m = idx.numel()
        if not m:
            continue
        vm = v[idx]
        outer = torch.einsum("cdk,cek->cde", vm, vm).reshape(m, d * d)
        if aggregator == "trimmed":
            g = math.floor(float(np.float32(m) * np.float32(trim_frac)))
            kept = torch.sort(outer, dim=0).values[g:m - g]
            protos[t] = kept.sum(dim=0) / max(m - 2 * g, 1)
        else:
            gid = torch.arange(m, device=v.device) % mom_groups
            onehot = (gid[:, None] == torch.arange(
                mom_groups, device=v.device)[None]).to(torch.float32)
            gcnt = onehot.sum(dim=0)
            gmean = (onehot.T @ outer) / torch.clamp_min(gcnt, 1.0)[:, None]
            gmean = gmean[gcnt > 0]
            nv = gmean.shape[0]
            s = torch.sort(gmean, dim=0).values
            protos[t] = (s[(nv - 1) // 2] + s[nv // 2]) / 2.0
    return (protos.reshape(n_clusters, d, d),
            member.sum(dim=0).to(torch.float32))


def _apply_floors(labels, best, margin, affinity_floor, margin_floor):
    """The unassigned-bucket rule of the device verdict paths (the numpy
    backend keeps its own host version, and the tests hold them equal)."""
    out = (best < affinity_floor) | (margin < margin_floor)
    return torch.where(out, UNASSIGNED, labels).to(torch.int32)


def _verdict_from_affinity(aff, affinity_floor, margin_floor):
    """``(B, T)`` affinity rows -> ``(labels, margin)`` with the floors
    applied: the argmax and margin of the assign kernel and its plain
    version, for callers that already hold the rows (the sharded
    directory)."""
    labels, margin = _verdict(aff)
    return _apply_floors(labels, aff.max(dim=1).values, margin,
                         affinity_floor, margin_floor), margin


def _wave_outer_sums(v_wave, labels, n_clusters: int):
    """Per-cluster sums of a wave's ``V V^T`` (rows whose label is not a
    cluster, -1 among them, drop out) and the per-cluster counts."""
    valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return _cluster_outer_sums(v_wave, _members(labels, valid, n_clusters))


def _proto_update(protos, counts, delta, m, *, sign: float):
    """Streaming-mean prototype update: admit (+1) or evict (-1)."""
    new_counts = torch.clamp_min(counts + sign * m, 0.0)
    num = protos * counts[:, None, None] + sign * delta
    upd = num / torch.clamp_min(new_counts, 1.0)[:, None, None]
    return (torch.where((new_counts > 0)[:, None, None], upd,
                        torch.zeros_like(upd)), new_counts)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class MembershipEngine:
    """One object that owns online cluster-identity serving.

    Every lifecycle operation replaces ``self.state`` with a new
    ``MembershipState``; a serving loop is ``engine.assign(...) ->
    engine.admit(...) -> engine.maybe_recluster()``.  The torch backend
    keeps the directory on ``device`` (default ``"cuda"``, which raises
    without a card; ``"cpu"`` runs the kernels' plain versions).
    """

    def __init__(self, cfg: MembershipConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or MembershipConfig()
        self.device = resolve_device(device) if self.on_device else None
        self.state: MembershipState | None = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_oneshot(cls, result, cfg: MembershipConfig | None = None,
                     capacity: int | None = None,
                     device: str | torch.device = "cuda"
                     ) -> "MembershipEngine":
        """Build the directory from a ``OneShotResult``: its signatures
        (``result.lam``, ``result.v``) and its GPS labels."""
        if getattr(result, "lam", None) is None or result.v is None:
            raise ValueError(
                "OneShotResult carries no signatures (lam/v): run "
                "one_shot_clustering, which returns them")
        eng = cls(cfg, device=device)
        labels = _np(result.labels)
        eng.seed(result.lam, result.v, labels,
                 n_clusters=int(labels.max()) + 1, capacity=capacity)
        return eng

    @property
    def on_device(self) -> bool:
        return self.cfg.backend != "numpy"

    def _wave(self, v) -> torch.Tensor:
        """A wave's ``(B, d, k)`` signatures as fp32 on the device."""
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(device=self.device, dtype=torch.float32)

    def _put(self, x):
        """A host array on the engine's side: a tensor on the device for
        the torch backend, unchanged for numpy."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device) \
            if self.on_device else x

    def seed(self, lam, v, labels, n_clusters: int,
             capacity: int | None = None) -> MembershipState:
        """Initialize the directory from seed signatures and labels
        (numpy arrays, or tensors on any device)."""
        lam = _np(lam).astype(np.float32)
        v = _np(v).astype(np.float32)
        labels = _np(labels).astype(np.int32)
        n, k = lam.shape
        d = v.shape[1]
        cap = capacity or self.cfg.capacity or 2 * n
        if cap < n:
            raise ValueError(f"capacity {cap} < seed population {n}")
        if not 1 <= n_clusters:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        lam_t = np.zeros((cap, k), np.float32)
        v_t = np.zeros((cap, d, k), np.float32)
        lab_t = np.full((cap,), UNASSIGNED, np.int32)
        valid = np.zeros((cap,), bool)
        lam_t[:n], v_t[:n], lab_t[:n], valid[:n] = lam, v, labels, True
        lam_t, v_t, lab_t, valid = map(self._put, (lam_t, v_t, lab_t, valid))
        protos, counts = self._rebuild_protos(v_t, lab_t, valid, n_clusters)
        table, scales = self._quantize(protos)
        self.state = MembershipState(
            lam=lam_t, v=v_t, labels=lab_t, valid=valid, protos=table,
            counts=counts, protos0=table, n_clusters=n_clusters,
            proto_scales=scales, proto0_scales=scales)
        if obs.enabled():
            obs.gauge("directory_bytes", self.state.directory_bytes)
            obs.event("seed", n_members=n, n_clusters=n_clusters,
                      capacity=cap, backend=self.cfg.backend)
        return self.state

    def _require_state(self) -> MembershipState:
        if self.state is None:
            raise ValueError("directory is empty: seed() or "
                             "from_oneshot() first")
        return self.state

    def _quantize(self, protos):
        """f32 prototypes -> (directory-dtype table, scales | None)."""
        return quant.quantize_directory(protos, self.cfg.directory_dtype)

    @staticmethod
    def _dequantize(st: MembershipState):
        return quant.dequantize_directory(st.protos, st.proto_scales)

    def _rebuild_protos(self, v, labels, valid, n_clusters: int):
        agg = self.cfg.aggregator
        if self.on_device:
            if agg == "mean":
                return _protos_from_table(v, labels, valid,
                                          n_clusters=n_clusters)
            return _protos_from_table_robust(
                v, labels, valid, n_clusters=n_clusters, aggregator=agg,
                trim_frac=self.cfg.trim_frac,
                mom_groups=self.cfg.mom_groups)
        if agg != "mean":
            return self._np_robust_protos(v, labels, valid, n_clusters)
        member = ((np.asarray(labels)[:, None] == np.arange(n_clusters))
                  & np.asarray(valid)[:, None]).astype(np.float32)
        counts = member.sum(axis=0)
        outer = np.einsum("cdk,cek->cde", v, v)
        protos = (np.einsum("ct,cde->tde", member, outer)
                  / np.maximum(counts, 1.0)[:, None, None])
        return protos.astype(np.float32), counts.astype(np.float32)

    def _np_robust_protos(self, v, labels, valid, n_clusters: int):
        """Host reference of the resistant aggregators, written apart from
        the device path on purpose (the tests hold the two equal)."""
        v = np.asarray(v, np.float32)
        labels, valid = np.asarray(labels), np.asarray(valid)
        d = v.shape[1]
        protos = np.zeros((n_clusters, d, d), np.float32)
        counts = np.zeros((n_clusters,), np.float32)
        for t in range(n_clusters):
            mem = np.flatnonzero((labels == t) & valid)
            counts[t] = len(mem)
            if not len(mem):
                continue
            outers = np.einsum("cdk,cek->cde", v[mem], v[mem]
                               ).reshape(len(mem), d * d)
            m = len(mem)
            if self.cfg.aggregator == "trimmed":
                g = int(np.floor(m * self.cfg.trim_frac))
                flat = np.sort(outers, axis=0)[g:m - g].mean(axis=0)
            else:                                            # medians
                gid = np.arange(m) % self.cfg.mom_groups
                gmeans = np.stack(
                    [outers[gid == j].mean(axis=0)
                     for j in range(self.cfg.mom_groups)
                     if (gid == j).any()])
                flat = np.median(gmeans, axis=0)
            protos[t] = flat.reshape(d, d)
        return protos, counts

    # -- assignment ---------------------------------------------------------

    def assign(self, lam, v) -> AssignResult:
        """Batched arrival wave -> labels, affinities and margins.

        ``lam (B, k)`` rides along for the following ``admit``; the
        affinity needs only ``v (B, d, k)``.  One kernel launch per wave
        on the torch backend.
        """
        st = self._require_state()
        t0 = obs.now()
        with obs.span("membership.assign", backend=self.cfg.backend) as sp:
            res = self._assign(st, v)
            # the labels come last out of the wave, so synchronising on
            # them times the whole wave
            sp.sync(res.labels)
        if obs.enabled():
            obs.observe("assign_latency_us", (obs.now() - t0) * 1e6)
            obs.count("membership.assign_waves")
            labels_np = _np(res.labels)
            obs.event("assign_wave", n=int(labels_np.shape[0]),
                      n_unassigned=int((labels_np == UNASSIGNED).sum()),
                      backend=self.cfg.backend)
        return res

    def _assign(self, st: MembershipState, v) -> AssignResult:
        if self.on_device:
            v_w = self._wave(v)
            aff, labels, margin = assign_ops.assign(
                v_w, st.protos, st.counts > 0,
                compute_dtype=self.cfg.compute_dtype,
                scales=st.proto_scales)
            labels = _apply_floors(labels, aff.max(dim=1).values, margin,
                                   self.cfg.affinity_floor,
                                   self.cfg.margin_floor)
            return AssignResult(labels=labels, affinity=aff, margin=margin)
        v = _np(v).astype(np.float32)
        k = v.shape[-1]
        protos = self._dequantize(st)
        aff = np.einsum("bdk,tde,bek->bt", v, protos, v) / k
        aff = np.where(st.counts > 0, aff, -np.inf)
        labels = aff.argmax(axis=1).astype(np.int32)
        best = aff.max(axis=1)
        if st.n_clusters == 1:
            margin = best.copy()
        else:
            cols = np.arange(st.n_clusters)
            margin = best - np.where(cols[None] == labels[:, None],
                                     -np.inf, aff).max(axis=1)
        out = (best < self.cfg.affinity_floor) | \
              (margin < self.cfg.margin_floor)
        labels = np.where(out, UNASSIGNED, labels).astype(np.int32)
        return AssignResult(labels=labels, affinity=aff, margin=margin)

    def assign_sharded(self, lam, v, mesh=None,
                       axis: str = "data") -> AssignResult:
        """``assign`` with the directory sharded over a mesh axis.

        Every rank passes the same wave.  Each keeps ``T / W`` of the
        dequantised prototypes, scores the wave against them with one
        product (``-inf`` on empty prototypes), one all_gather assembles
        the ``(B, T)`` affinity rows, and the verdict runs replicated.
        The axis size must divide ``T``; ``mesh`` defaults to
        ``make_user_mesh(axis)`` over the engine's device type.
        """
        st = self._require_state()
        if not self.on_device:
            raise ValueError("assign_sharded needs a device backend "
                             "('torch'); numpy is host-only")
        mesh = mesh or mdist.make_user_mesh(axis, self.device.type)
        group = mdist.axis_group(mesh, axis, self.device)
        rows = mdist.local_rows(st.n_clusters, group, axis,
                                what="n_clusters")
        v_w = self._wave(v)
        # Dequantised before sharding: the product has no dequantising
        # epilogue, and the scales would need a shard layout of their own.
        protos = self._dequantize(st)[rows]                   # (T_l, d, d)
        aff_l = torch.einsum("bdk,tde,bek->bt", v_w, protos,
                             v_w) / v_w.shape[-1]             # (B, T_l)
        aff_l = torch.where((st.counts[rows] > 0)[None, :], aff_l,
                            -torch.inf)
        aff = mdist.all_gather_cat(aff_l.T, group).T          # (B, T)
        labels, margin = _verdict_from_affinity(
            aff, self.cfg.affinity_floor, self.cfg.margin_floor)
        return AssignResult(labels=labels, affinity=aff, margin=margin)

    # -- lifecycle ----------------------------------------------------------

    def _free_slots(self, n: int) -> np.ndarray:
        st = self._require_state()
        free = np.flatnonzero(~_np(st.valid))
        if len(free) < n:
            raise ValueError(
                f"directory full: {n} arrivals but only {len(free)} free "
                f"slots of {st.capacity}; grow MembershipConfig.capacity")
        return free[:n].astype(np.int32)

    def admit(self, lam, v, labels) -> np.ndarray:
        """Append an assigned wave to the table (streaming-mean prototype
        update; unassigned rows join the table but no prototype).  The
        resistant aggregators recompute from the live table instead.
        Returns the occupied slot indices (for ``evict``)."""
        with obs.span("membership.admit") as sp:
            slots = self._admit(lam, v, labels)
            sp.sync(self.state.protos)
        if obs.enabled():
            st = self.state
            obs.count("membership.admits", len(slots))
            obs.gauge("directory_bytes", st.directory_bytes)
            obs.event("admit", n=len(slots), slots=slots,
                      n_members=int(st.n_members))
        return slots

    def _admit(self, lam, v, labels) -> np.ndarray:
        st = self._require_state()
        lam = _np(lam).astype(np.float32)
        slots = self._free_slots(lam.shape[0])
        labels = _np(labels).astype(np.int32)
        streaming = self.cfg.aggregator == "mean"
        if self.on_device:
            v_w = self._wave(v)
            lab_w = self._put(labels)
            sl = self._put(slots).long()
            lam_t, v_t = st.lam.clone(), st.v.clone()
            lab_t, valid = st.labels.clone(), st.valid.clone()
            lam_t[sl] = self._put(lam)
            v_t[sl] = v_w
            lab_t[sl] = lab_w
            valid[sl] = True
            if streaming:
                delta, m = _wave_outer_sums(v_w, lab_w, st.n_clusters)
                protos, counts = _proto_update(self._dequantize(st),
                                               st.counts, delta, m,
                                               sign=1.0)
            else:
                protos, counts = self._rebuild_protos(v_t, lab_t, valid,
                                                      st.n_clusters)
        else:
            v = _np(v).astype(np.float32)
            lam_t, v_t = st.lam.copy(), st.v.copy()
            lab_t, valid = st.labels.copy(), st.valid.copy()
            lam_t[slots], v_t[slots], lab_t[slots], valid[slots] = \
                lam, v, labels, True
            if streaming:
                protos, counts = self._np_proto_shift(st, v, labels, +1.0)
            else:
                protos, counts = self._rebuild_protos(v_t, lab_t, valid,
                                                      st.n_clusters)
        table, scales = self._quantize(protos)
        self.state = dataclasses.replace(
            st, lam=lam_t, v=v_t, labels=lab_t, valid=valid,
            protos=table, counts=counts, proto_scales=scales)
        return slots

    def evict(self, slots) -> None:
        """Masked removal of table slots (churn): free the rows and
        down-date the prototypes by the departing members' projectors."""
        with obs.span("membership.evict") as sp:
            self._evict(slots)
            sp.sync(self.state.protos)
        if obs.enabled():
            st = self.state
            obs.count("membership.evicts", len(np.asarray(slots)))
            obs.gauge("directory_bytes", st.directory_bytes)
            obs.event("evict", n=len(np.asarray(slots)),
                      slots=np.asarray(slots), n_members=int(st.n_members))

    def _evict(self, slots) -> None:
        st = self._require_state()
        slots = _np(slots).astype(np.int32)
        if len(np.unique(slots)) != len(slots):
            # a repeated slot would down-date the prototype twice for one
            # departure, corrupting the streaming mean
            raise ValueError(f"duplicate slots in evict: {slots.tolist()}")
        occupied = _np(st.valid)[slots]
        if not occupied.all():
            raise ValueError(f"evicting empty slots "
                             f"{slots[~occupied].tolist()}")
        labels_out = _np(st.labels)[slots]
        streaming = self.cfg.aggregator == "mean"
        if self.on_device:
            sl = self._put(slots).long()
            lab_t, valid = st.labels.clone(), st.valid.clone()
            lab_t[sl] = UNASSIGNED
            valid[sl] = False
            if streaming:
                delta, m = _wave_outer_sums(st.v[sl], self._put(labels_out),
                                            st.n_clusters)
                protos, counts = _proto_update(self._dequantize(st),
                                               st.counts, delta, m,
                                               sign=-1.0)
            else:
                protos, counts = self._rebuild_protos(st.v, lab_t, valid,
                                                      st.n_clusters)
        else:
            lab_t, valid = st.labels.copy(), st.valid.copy()
            lab_t[slots], valid[slots] = UNASSIGNED, False
            if streaming:
                protos, counts = self._np_proto_shift(
                    st, np.asarray(st.v)[slots], labels_out, -1.0)
            else:
                protos, counts = self._rebuild_protos(st.v, lab_t, valid,
                                                      st.n_clusters)
        table, scales = self._quantize(protos)
        self.state = dataclasses.replace(st, labels=lab_t, valid=valid,
                                         protos=table, counts=counts,
                                         proto_scales=scales)

    def _np_proto_shift(self, st: MembershipState, v: np.ndarray,
                        labels: np.ndarray, sign: float):
        onehot = (labels[:, None] == np.arange(st.n_clusters)
                  ).astype(np.float32)
        outer = np.einsum("bdk,bek->bde", v, v)
        delta = np.einsum("bt,bde->tde", onehot, outer)
        m = onehot.sum(axis=0)
        counts = np.maximum(st.counts + sign * m, 0.0)
        num = self._dequantize(st) * st.counts[:, None, None] + sign * delta
        protos = np.where((counts > 0)[:, None, None],
                          num / np.maximum(counts, 1.0)[:, None, None],
                          0.0).astype(np.float32)
        return protos, counts.astype(np.float32)

    # -- drift statistics + re-cluster --------------------------------------

    def drift_stats(self) -> dict:
        """The two trigger statistics: the unassigned fraction of the live
        table and the relative prototype shift since the last (re)cluster
        (the worst cluster's, or the median under ``drift_stat="median"``).
        Computed on the host in fp32, as in the reference."""
        st = self._require_state()
        n = max(st.n_members, 1)
        p = _np(quant.dequantize_directory(st.protos, st.proto_scales))
        p0 = _np(quant.dequantize_directory(st.protos0, st.proto0_scales))
        shift = np.linalg.norm((p - p0).reshape(st.n_clusters, -1), axis=1)
        base = np.maximum(
            np.linalg.norm(p0.reshape(st.n_clusters, -1), axis=1), 1e-6)
        rel = shift / base
        stat = (np.median(rel) if self.cfg.drift_stat == "median"
                else rel.max())
        stats = {
            "unassigned_frac": st.n_unassigned / n,
            "proto_shift": float(stat),
            "proto_shift_max": float(rel.max()),
            "n_members": st.n_members,
            "n_reclusters": st.n_reclusters,
        }
        if obs.enabled():
            obs.gauge("unassigned_frac", stats["unassigned_frac"])
            obs.gauge("proto_shift", stats["proto_shift"])
        return stats

    def _tripped(self, stats: dict) -> bool:
        return (stats["unassigned_frac"] > self.cfg.recluster_unassigned_frac
                or stats["proto_shift"] > self.cfg.recluster_proto_shift)

    def should_recluster(self) -> bool:
        return self._tripped(self.drift_stats())

    def recluster(self, force: bool = False) -> bool:
        """Drift-triggered re-cluster: HAC over the CURRENT table
        (unassigned bucket included) on the signature-only relevance,
        with the host HAC on the numpy backend and the NN-chain on the
        engine's device otherwise; the new cut ids are greedily matched
        onto the previous labels.  Returns whether a re-cluster ran."""
        if not force:
            stats = self.drift_stats()
            if not self._tripped(stats):
                return False
            obs.event("drift_trip", **stats)
        st = self._require_state()
        live = np.flatnonzero(_np(st.valid))
        if len(live) < st.n_clusters:
            raise ValueError(f"cannot cut {st.n_clusters} clusters from "
                             f"{len(live)} members")
        if self.on_device:
            sel = self._put(live).long()
            big_r = signature_relevance(st.lam[sel], st.v[sel],
                                        self.cfg.eig_floor)
            cengine = ClusterEngine(ClusterConfig(
                backend="torch", linkage=self.cfg.linkage),
                device=self.device)
        else:
            big_r = signature_relevance(
                torch.from_numpy(np.asarray(st.lam)[live]),
                torch.from_numpy(np.asarray(st.v)[live]),
                self.cfg.eig_floor).numpy()
            cengine = ClusterEngine(ClusterConfig(
                backend="numpy", linkage=self.cfg.linkage))
        with obs.span("membership.recluster", n_members=len(live)) as sp:
            fresh = _np(cengine.labels(big_r, st.n_clusters))
            matched = greedy_match_labels(fresh, _np(st.labels)[live],
                                          st.n_clusters)
            lab_t = _np(st.labels).copy()
            lab_t[live] = matched
            labels = self._put(lab_t)
            protos, counts = self._rebuild_protos(st.v, labels, st.valid,
                                                  st.n_clusters)
            table, scales = self._quantize(protos)
            sp.sync((labels, table, counts))
        self.state = dataclasses.replace(
            st, labels=labels, protos=table, counts=counts,
            protos0=table, n_reclusters=st.n_reclusters + 1,
            proto_scales=scales, proto0_scales=scales)
        if obs.enabled():
            before = _np(st.labels)[live]
            obs.count("recluster_events")
            obs.event("recluster", n_members=len(live), forced=bool(force),
                      label_agreement=float((matched == before).mean()),
                      n_reclusters=int(self.state.n_reclusters))
        return True

    def maybe_recluster(self) -> bool:
        """The serve-loop hook: re-cluster iff a drift trigger tripped."""
        return self.recluster(force=False)
