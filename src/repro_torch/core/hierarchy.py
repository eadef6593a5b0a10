"""Two-level hierarchical one-shot clustering, PyTorch port of
``src/repro/core/hierarchy.py``.

Every flat path builds an N x N relevance matrix before HAC runs.  This
module is the edge-server decomposition of the same Algorithm-2 maths:

  1. **Shard** the N users into G edge groups of N_g = N / G.
  2. **Group protocol + HAC**, a batch of groups at a time: per-user
     Grams and spectra over the batch's users, the cross-projections
     inside each group in one ``eigproject`` launch with a group axis
     (``project_norms_grouped``), relevance and symmetrization per group,
     then one NN-chain launch with one block a group
     (``nn_chain_grouped``) and one batched cut
     (``cluster_engine.cut_device_grouped``).  The reference vmaps its
     jitted stages over the group axis; the port's kernels carry the
     axis themselves, so no host loop runs over groups.
  3. **Compress** each group's T_g clusters into a directory entry: the
     cluster-mean rank-k Gram ``Ghat_t = mean_i V_i diag(lam_i) V_i^T``
     re-eigendecomposed to an entry signature ``(lam_e, V_e)``, the mean
     projector ``P_t = mean_i V_i V_i^T`` and the member count.
  4. **Global stage**: the E = G * T_g entries are clustered into the
     final T by the ``ClusterEngine`` over
     ``similarity.signature_relevance``, at O(E^2) cost.
  5. **Stitch**: user i's global label is the global label of its
     group-local cluster's entry.

The ledger on the result accounts the per-user view inside an edge group
(``n_users = N_g``).  The result carries ``labels`` / ``lam`` / ``v`` as
``OneShotResult`` does, so ``MembershipEngine.from_oneshot`` serves it
unchanged.  ``greedy_match_labels`` aligns label ids across runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import similarity as sim
from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                             cut_device_grouped)
from repro_torch.core.oneshot import CommLedger
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.eigproject import ops as proj_ops
from repro_torch.kernels.linkage import ops as lk_ops

__all__ = ["HierarchyConfig", "HierarchicalResult", "hierarchical_one_shot",
           "greedy_match_labels", "group_permutation"]

_ASSIGNMENTS = ("contiguous", "strided")

#: Floats of the ``(users, d, d)`` products ``_compress_entries`` holds at
#: once (256 MiB): the reference materialises two ``(N, d, d)`` stacks,
#: 2 GiB at N = 1024, d = 512.
_COMPRESS_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Configuration of the two-level protocol.

    Attributes:
      n_groups: G edge groups.  ``n_users % n_groups == 0`` is required:
        phantom-user padding would distort the group HAC heights.
      group_clusters: T_g clusters cut per group; ``0`` means the final
        ``n_clusters``.  Must end up <= N / G.
      group_batch: groups a batch of launches; ``0`` = all G at once.
        Bounds peak memory at O(group_batch * (N/G)^2 + N * d * k).
      assignment: how user ids map to groups: "contiguous" (group g =
        ids [g*N_g, (g+1)*N_g)) or "strided" (group g = ids g, g+G, ...).
    """

    n_groups: int
    group_clusters: int = 0
    group_batch: int = 0
    assignment: str = "contiguous"

    def __post_init__(self):
        if self.n_groups < 2:
            raise ValueError(f"n_groups must be >= 2 (use the flat path "
                             f"for one group), got {self.n_groups}")
        if self.group_clusters < 0:
            raise ValueError(f"group_clusters must be >= 0, "
                             f"got {self.group_clusters}")
        if self.group_batch < 0:
            raise ValueError(f"group_batch must be >= 0, "
                             f"got {self.group_batch}")
        if self.assignment not in _ASSIGNMENTS:
            raise ValueError(f"assignment must be one of {_ASSIGNMENTS}, "
                             f"got {self.assignment!r}")


@dataclasses.dataclass(frozen=True)
class HierarchicalResult:
    """Global labels + the directory the global stage clustered, as
    tensors on the run's device.

    ``entry_labels[e]`` is the global cluster of directory entry ``e = g
    * T_g + t_local``, and a user's global label is
    ``entry_labels[group_ids * T_g + local_labels]`` by construction.
    """

    labels: torch.Tensor             # (N,) global cluster ids 0..T-1
    lam: torch.Tensor                # (N, k) shared per-user spectra
    v: torch.Tensor                  # (N, d, k) shared eigenvectors
    group_ids: torch.Tensor          # (N,) edge group of each user
    local_labels: torch.Tensor       # (N,) group-local cluster ids
    entry_labels: torch.Tensor       # (E,) global label per entry
    entry_lam: torch.Tensor          # (E, k) entry spectra
    entry_v: torch.Tensor            # (E, d, k) entry eigenvectors
    entry_protos: torch.Tensor       # (E, d, d) mean projectors
    entry_counts: torch.Tensor       # (E,) members per entry
    global_similarity: torch.Tensor  # (E, E) signature-only relevance
    ledger: CommLedger               # per-user view: n_users = N / G


def greedy_match_labels(new_labels: np.ndarray, old_labels: np.ndarray,
                        n_clusters: int) -> np.ndarray:
    """Greedy-overlap relabeling of ``new_labels`` onto ``old_labels``'
    ids (both length-N, values in [0, n_clusters) or -1 = unassigned).

    HAC cut ids are arbitrary, so two runs need id alignment before
    exact-match agreement means anything.  Host-side: matching is a rare,
    tiny (T x T) event.
    """
    new_labels = np.asarray(new_labels)
    old_labels = np.asarray(old_labels)
    overlap = np.zeros((n_clusters, n_clusters), np.int64)
    for new, old in zip(new_labels, old_labels):
        if new >= 0 and old >= 0:
            overlap[new, old] += 1
    perm = np.full(n_clusters, -1, np.int64)
    used = np.zeros(n_clusters, bool)
    for new, old in zip(*np.unravel_index(np.argsort(-overlap, axis=None),
                                          overlap.shape)):
        if perm[new] < 0 and not used[old]:
            perm[new] = old
            used[old] = True
    for t in range(n_clusters):                 # clusters with no overlap
        if perm[t] < 0:
            perm[t] = int(np.flatnonzero(~used)[0])
            used[perm[t]] = True
    return np.where(new_labels >= 0, perm[np.clip(new_labels, 0, None)],
                    -1).astype(np.int32)


def group_permutation(n_users: int, cfg: HierarchyConfig) -> np.ndarray:
    """User-id order such that ``perm.reshape(G, N_g)`` rows are the
    edge groups.  A pure host-side index computation."""
    if n_users % cfg.n_groups:
        raise ValueError(
            f"n_users={n_users} not divisible by n_groups="
            f"{cfg.n_groups}: phantom-user padding would distort the "
            "group HAC — resize the groups instead")
    perm = np.arange(n_users)
    if cfg.assignment == "strided":
        perm = perm.reshape(-1, cfg.n_groups).T.ravel()
    return perm


# ---------------------------------------------------------------------------
# Batched group stage: protocol + NN-chain HAC over a group axis
# ---------------------------------------------------------------------------

def _batched_protocol(feats: torch.Tensor, nv: torch.Tensor, top_k: int,
                      eig_floor: float):
    """``feats (B, N_g, n, d)`` -> per-group ``(R (B, N_g, N_g), lam (B,
    N_g, k), v (B, N_g, d, k))``: the dense protocol of
    ``engine._dense_protocol`` on every group, one launch a kernel."""
    b, ng, n, d = feats.shape
    grams = sim.batched_gram(feats.reshape(b * ng, n, d), nv.reshape(-1))
    lam, v = sim.spectrum(grams, top_k)
    k = lam.shape[-1]
    lam, v = lam.reshape(b, ng, k), v.reshape(b, ng, d, k)
    lam_hat = proj_ops.project_norms_grouped(grams.reshape(b, ng, d, d), v)
    r = sim.relevance(lam[:, :, None, :], lam_hat, eig_floor)
    return (r + r.transpose(1, 2)) / 2.0, lam, v


def _batched_hac_cut(big_r: torch.Tensor, *, linkage: str, n_clusters: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched device HAC: prepare (diag -inf) + NN-chain + cut over the
    leading group axis -> ``(labels (B, n), steps (B,))``."""
    s = big_r.to(torch.float32, copy=True).contiguous()
    s.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
    merge_rows, heights, steps = lk_ops.nn_chain_grouped(s, linkage)
    labels = cut_device_grouped(merge_rows, heights, s.shape[1], n_clusters)
    return labels, steps


# ---------------------------------------------------------------------------
# Directory compression: per-entry mean rank-k Gram -> entry signature
# ---------------------------------------------------------------------------

def _compress_entries(lam: torch.Tensor, v: torch.Tensor,
                      entry_id: torch.Tensor, *, n_entries: int, top_k: int):
    """``(lam (N, k), v (N, d, k), entry_id (N,))`` -> ``(lam_e, v_e,
    protos, counts)``.

    The entry's rank-k Gram reconstruction ``Ghat = mean_i V_i
    diag(lam_i) V_i^T`` is re-eigendecomposed so the entry signature has
    the ``(lam_e, V_e)`` shape ``signature_relevance`` expects; the mean
    projector rides along.  The per-user ``(d, d)`` products are formed
    and summed into their entries (``index_add_``) a chunk of users at a
    time, so no ``(N, d, d)`` stack is held.
    """
    n, d, _ = v.shape
    seg_w = v.new_zeros((n_entries, d, d))
    seg_p = v.new_zeros((n_entries, d, d))
    step = max(1, _COMPRESS_CHUNK_ELEMS // (d * d))
    for s in range(0, n, step):
        vs, ids = v[s:s + step], entry_id[s:s + step]
        seg_w.index_add_(0, ids, (vs * lam[s:s + step, None, :])
                         @ vs.transpose(1, 2))          # V diag(lam) V^T
        seg_p.index_add_(0, ids, vs @ vs.transpose(1, 2))  # V V^T
    counts = v.new_zeros((n_entries,)).index_add_(
        0, entry_id, v.new_ones((n,)))
    denom = torch.clamp_min(counts, 1.0)[:, None, None]
    lam_e, v_e = sim.spectrum(seg_w / denom, top_k)
    return lam_e, v_e, seg_p / denom, counts


# ---------------------------------------------------------------------------
# The two-level protocol
# ---------------------------------------------------------------------------

def _group_rows(x: torch.Tensor, perm: torch.Tensor | None, start: int,
                stop: int) -> torch.Tensor:
    """Users ``perm[start:stop]`` of ``x``: a view for the contiguous
    assignment (``perm`` None), a gathered copy of the batch otherwise."""
    return x[start:stop] if perm is None else x[perm[start:stop]]


def hierarchical_one_shot(features, n_clusters: int,
                          cfg: sim.SimilarityConfig | None = None,
                          hierarchy_cfg: HierarchyConfig | None = None,
                          cluster_cfg: ClusterConfig | None = None,
                          n_valid=None, model_params: int = 0,
                          device: str | torch.device = "cuda"
                          ) -> HierarchicalResult:
    """Two-level one-shot clustering of ``features`` into ``n_clusters``.

    ``cfg`` supplies the protocol maths knobs (``top_k``, ``eig_floor``);
    its routing fields must be off: groups are the scaling mechanism
    here, so ``backend`` must be single-host and ``block_users`` /
    ``landmarks`` zero.  ``cluster_cfg`` drives both HAC stages and must
    be the device backend ("torch", the default): the group stage is a
    batched NN-chain, which the host reference cannot batch.  Runs on
    ``device`` (default ``"cuda"``, which raises without a card).
    """
    cfg = cfg or sim.SimilarityConfig()
    hcfg = hierarchy_cfg or HierarchyConfig(n_groups=2)
    ccfg = cluster_cfg or ClusterConfig(backend="torch")
    if cfg.backend == "shard_map":
        raise ValueError("hierarchical_one_shot shards users into groups "
                         "itself; use the single-host backend ('torch') "
                         "for the group protocol")
    if cfg.block_users or cfg.landmarks:
        raise ValueError(
            "hierarchical_one_shot runs the DENSE protocol per edge "
            "group (each group is already small); block_users="
            f"{cfg.block_users} / landmarks={cfg.landmarks} must be 0")
    if ccfg.backend == "numpy":
        raise ValueError("the group HAC stage is a batched device "
                         "NN-chain; use cluster backend 'torch'")
    dev = resolve_device(device)

    feats, nv = sim.prepare_user_batch(features, n_valid, device=dev)
    n_users, n_samples, d = feats.shape
    g = hcfg.n_groups
    perm = group_permutation(n_users, hcfg)
    inv_perm = np.argsort(perm)
    ng = n_users // g
    t_g = hcfg.group_clusters or n_clusters
    if not 1 <= t_g <= ng:
        raise ValueError(f"group_clusters={t_g} must be in [1, N/G={ng}]")
    n_entries = g * t_g
    if not 1 <= n_clusters <= n_entries:
        raise ValueError(
            f"n_clusters={n_clusters} must be in [1, G*T_g={n_entries}] — "
            "raise group_clusters or n_groups")
    top_k = min(cfg.top_k or d, d)
    perm_t = (None if hcfg.assignment == "contiguous"
              else torch.from_numpy(perm).to(dev))

    # -- level 1: per-group protocol + HAC, batches of groups ---------------
    batch = hcfg.group_batch or g
    lam_parts, v_parts, local_parts = [], [], []
    for s in range(0, g, batch):
        nb = min(batch, g - s)
        lo, hi = s * ng, (s + nb) * ng
        big_r, lam_b, v_b = _batched_protocol(
            _group_rows(feats, perm_t, lo, hi).reshape(nb, ng, n_samples, d),
            _group_rows(nv, perm_t, lo, hi).reshape(nb, ng), top_k,
            cfg.eig_floor)
        labels_b, steps = _batched_hac_cut(big_r, linkage=ccfg.linkage,
                                           n_clusters=t_g)
        bad = np.flatnonzero(steps.cpu().numpy() != ng - 1)
        if bad.size:                            # same witness as ClusterEngine
            raise ValueError(
                f"group HAC stopped early in group(s) {s + bad} — the "
                "group similarity likely contains NaN/Inf")
        lam_parts.append(lam_b.reshape(-1, top_k))
        v_parts.append(v_b.reshape(-1, d, top_k))
        local_parts.append(labels_b.reshape(-1))
    lam_g = torch.cat(lam_parts)                # (N, k), group order
    v_g = torch.cat(v_parts)                    # (N, d, k), group order
    local_g = torch.cat(local_parts)            # (N,), group order
    group_of = torch.arange(g, dtype=torch.int32,
                            device=dev).repeat_interleave(ng)

    # -- level 2: compress clusters -> directory entries --------------------
    entry_id = (group_of * t_g + local_g).long()  # (N,) in [0, E)
    lam_e, v_e, protos_e, counts_e = _compress_entries(
        lam_g, v_g, entry_id, n_entries=n_entries, top_k=top_k)

    # -- level 2: global clustering on signature-only relevance -------------
    r_global = sim.signature_relevance(lam_e, v_e, eig_floor=cfg.eig_floor)
    entry_labels = ClusterEngine(ccfg, device=dev).labels(r_global,
                                                          n_clusters)

    # -- stitch back to user order ------------------------------------------
    labels_g = entry_labels[entry_id]           # (N,), group order
    inv = torch.from_numpy(inv_perm).to(dev)
    ledger = CommLedger(n_users=ng, d=d, top_k=top_k,
                        model_params=model_params, mode="broadcast")
    return HierarchicalResult(
        labels=labels_g[inv], lam=lam_g[inv], v=v_g[inv],
        group_ids=group_of[inv], local_labels=local_g[inv],
        entry_labels=entry_labels, entry_lam=lam_e, entry_v=v_e,
        entry_protos=protos_e, entry_counts=counts_e,
        global_similarity=r_global, ledger=ledger)
