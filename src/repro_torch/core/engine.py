"""One-shot protocol engine (paper Algorithm 2), PyTorch port.

Mirrors the single-device paths of ``src/repro/core/engine.py``:

  * **dense** (``_dense_protocol``): per-user Grams (Eq. 1) in one
    kernel launch, the top-k spectrum by batched ``eigh``, all ``N x N``
    cross-projections (Eq. 2) in one kernel launch, relevance (Eqs. 3-4)
    and symmetrization (Eq. 5) in plain torch;
  * **blockwise** (``block_users > 0``): users in tiles; each tile's
    Grams give its signatures and die, then each tile's relevance rows
    come Gram-free from ``||G_i v|| = ||F_i^T (F_i v)|| / n_i`` against
    the whole signature table, one ``gram_project`` launch per tile;
  * **landmarks** (``landmarks = m > 0``): the Nystrom-sketched path.
    The signatures come tile by tile as on the blockwise path; every
    user is then scored against the m landmark projectors ``V_j V_j^T``
    by the ``assign`` wave kernel, one launch per tile of users, and R
    is completed from that ``(N, m)`` block as ``C W^+ C^T``;
  * **raw** (``run_raw``): raw shards + a ``FeatureConfig`` go through
    the ``SignatureEngine`` (streamed featurize -> Gram, batched top-k
    subspace iteration) before the relevance stage;
  * **shard_map** (``backend="shard_map"``): users sharded over a
    ``torch.distributed`` mesh axis, one process a device.  Every rank
    passes the same full batch and moves only its own users to its
    device; the paper's star-topology messages become two all_gathers
    (signatures, then relevance rows), and every rank gets the replicated
    ``R``.  The raw entry point shards the raw shards the same way.

Everything stays on the engine's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as mdist
from repro_torch.core import signature_engine as sig
from repro_torch.core import similarity as sim
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.gram_project import ops as gp_ops

__all__ = ["ProtocolEngine", "ProtocolResult", "landmark_indices",
           "make_user_mesh"]

make_user_mesh = mdist.make_user_mesh


@dataclasses.dataclass(frozen=True)
class ProtocolResult:
    """Everything the protocol produces before clustering.  ``lam``/``v``
    are the shared per-user signatures (what each user uploaded)."""

    relevance: torch.Tensor       # (N, N) directed r(i, j)
    similarity: torch.Tensor      # (N, N) symmetrized R
    n_users: int
    d: int
    top_k: int
    lam: torch.Tensor | None = None   # (N, k) shared spectra
    v: torch.Tensor | None = None     # (N, d, k) shared eigenvectors


def _dense_protocol(features: torch.Tensor, n_valid: torch.Tensor,
                    top_k: int, eig_floor: float, group=None):
    """``features (N, n, d)`` -> ``(r, R, lam, v)`` on their device.

    Under the sharded backend ``features`` are this rank's users and
    ``group`` the user axis's process group; the paper's messages are
    then two all_gathers, and every rank gets the replicated result:

      paper                               | here
      ------------------------------------|------------------------------
      user i broadcasts V_i to all users  | all_gather of (d, k) blocks
      user i uploads row r(i, .) to GPS   | all_gather of relevance rows
      GPS symmetrizes R, runs HAC         | every rank holds R
    """
    grams = sim.batched_gram(features, n_valid)
    lam, v = sim.spectrum(grams, top_k)
    # Relevance rows of these users' Grams against every user's
    # eigenvectors (Algorithm 2 lines 7-12), one eigproject launch.
    v_all = mdist.all_gather_cat(v, group)
    r = mdist.all_gather_cat(
        sim.relevance_matrix(grams, lam, v_all, eig_floor), group)
    return r, sim.symmetrize(r), mdist.all_gather_cat(lam, group), v_all


def _tile_signatures(features: torch.Tensor, n_valid: torch.Tensor,
                     top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One tile's shared signatures; the ``(block, d, d)`` Grams die here."""
    return sim.spectrum(sim.batched_gram(features, n_valid), top_k)


def _tile_rows(features: torch.Tensor, n_valid: torch.Tensor,
               lam_tile: torch.Tensor, v_flat: torch.Tensor,
               eig_floor: float, top_k: int) -> torch.Tensor:
    """Relevance rows ``(block, N_pad)`` of one user tile against the
    whole signature table ``v_flat (d, N_pad * k)``: one ``gram_project``
    launch for the tile, no ``(d, d)`` Gram."""
    lam_hat = gp_ops.batched_gram_project(features, v_flat, n_valid)
    lam_hat = lam_hat.reshape(features.shape[0], -1, top_k)  # (B, N_pad, k)
    return sim.relevance(lam_tile[:, None, :], lam_hat, eig_floor)


def landmark_indices(n: int, m: int) -> np.ndarray:
    """``m`` deterministic landmark user ids out of ``n``, NESTED: every
    set is a prefix of one fixed seeded permutation, so the set for any
    ``m' > m`` contains the set for ``m`` and the Nystrom error can only
    shrink as landmarks are added.  The same ids as the reference's."""
    if not 0 < m <= n:
        raise ValueError(f"need 0 < m <= n, got m={m}, n={n}")
    return np.random.default_rng(0x5EED).permutation(n)[:m].astype(np.int32)


def _nystroem_complete(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``R ~= C W^+ C^T`` from the scored columns ``C (N, m)`` and the
    landmark block ``W (m, m)``, symmetrized and clipped to [0, 1] (pinv
    noise can leave tiny negatives or spill above 1).  The pseudo-inverse
    is a library call, as ``jnp.linalg.pinv`` is in the reference."""
    r = c @ torch.linalg.pinv(w, rtol=1e-6) @ c.T
    return torch.clamp(sim.symmetrize(r), 0.0, 1.0)


def _raw_finish(grams: torch.Tensor, top_k: int, eig_floor: float,
                engine: "sig.SignatureEngine", group=None):
    """Gram stack -> ``(r, R, resid, lam, v)``: top-k spectrum (subspace
    iteration by default), relevance and symmetrization.  The per-user
    eigen-residual is only computed when the engine will check it
    (``resid`` is ``None`` otherwise).  Under the sharded backend the
    Grams are this rank's users' and ``group`` gathers every output, as
    in ``_dense_protocol``."""
    lam, v = engine.spectrum(grams, top_k)
    resid = (mdist.all_gather_cat(sig.subspace_residual(grams, lam, v),
                                  group) if engine.cfg.check else None)
    v_all = mdist.all_gather_cat(v, group)
    r = mdist.all_gather_cat(
        sim.relevance_matrix(grams, lam, v_all, eig_floor), group)
    return (r, sim.symmetrize(r), resid, mdist.all_gather_cat(lam, group),
            v_all)


class ProtocolEngine:
    """One object that owns the whole one-shot protocol.

    ``cfg.backend`` selects one device (``"torch"``) or users sharded
    over ``mesh`` (``"shard_map"``, one process a device; the mesh
    defaults to ``make_user_mesh(cfg.mesh_axis)`` over the default
    process group).  ``device`` defaults to ``"cuda"`` (the rank's current
    card) and raises when no card is present; pass ``device="cpu"`` to run
    the kernels' plain versions, over a gloo mesh when sharded.
    """

    def __init__(self, cfg: sim.SimilarityConfig | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        cfg = cfg or sim.SimilarityConfig()
        if cfg.block_users and cfg.backend == "shard_map":
            raise ValueError("blockwise streaming (block_users > 0) is a "
                             "single-host mode; the shard_map backend "
                             "already tiles users over devices")
        if cfg.landmarks and cfg.backend == "shard_map":
            raise ValueError("the landmark-sketched path (landmarks > 0) "
                             "is a single-host mode; shard_map computes "
                             "exact relevance rows per device")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)

    def _top_k(self, d: int) -> int:
        """Effective signature width: ``0`` means all d, and a Gram only
        has d eigenpairs however large ``cfg.top_k`` is."""
        return min(self.cfg.top_k or d, d)

    def _group(self):
        """The process group of the user axis, checked against the
        engine's device."""
        axis = self.cfg.mesh_axis
        mesh = self.mesh or make_user_mesh(axis, self.device.type)
        return mdist.axis_group(mesh, axis, self.device)

    def prepare(self, features, n_valid=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Any accepted input form -> ``(padded, n_valid)`` on the device."""
        return sim.prepare_user_batch(features, n_valid, device=self.device)

    def signatures(self, features, n_valid=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-user ``(lam (N, k), V (N, d, k), G (N, d, d))``: dense
        single-device only, since it materialises every Gram."""
        if self.cfg.backend == "shard_map" or self.cfg.block_users:
            raise ValueError(
                "signatures() materializes the full (N, d, d) Gram stack "
                "and is only available on the dense single-host config "
                f"(got backend={self.cfg.backend!r}, "
                f"block_users={self.cfg.block_users})")
        feats, nv = self.prepare(features, n_valid)
        grams = sim.batched_gram(feats, nv)
        lam, v = sim.spectrum(grams, self._top_k(feats.shape[-1]))
        return lam, v, grams

    def _protocol(self, features, n_valid):
        """Backend dispatch on any accepted input -> ``(r, R, lam, v, N,
        d)``; shard_map before landmarks and blockwise, as the reference's
        ``_dispatch``."""
        if self.cfg.backend == "shard_map":
            return self._run_shard_map(features, n_valid)
        feats, nv = self.prepare(features, n_valid)
        n_users, _, d = feats.shape
        if self.cfg.landmarks:
            out = self._run_landmarks(feats, nv)
        elif self.cfg.block_users:
            out = self._run_blockwise(feats, nv)
        else:
            out = _dense_protocol(feats, nv, self._top_k(d),
                                  self.cfg.eig_floor)
        return (*out, n_users, d)

    def _run_shard_map(self, features, n_valid):
        """Every rank holds the same full batch; only this rank's users
        go to its device.  Shapes are checked before the first
        collective, so a bad input raises on every rank alike."""
        group = self._group()
        if not isinstance(features, (torch.Tensor, np.ndarray)):
            features, n_valid = sim.pad_ragged(features, device="cpu")
        if features.ndim != 3:
            raise ValueError(f"user batch must be (N, n, m)-shaped "
                             f"(users, rows, dim), got shape "
                             f"{tuple(features.shape)}")
        n_users, _, d = features.shape
        rows = mdist.local_rows(n_users, group, self.cfg.mesh_axis)
        feats, nv = self.prepare(
            features[rows], None if n_valid is None else n_valid[rows])
        out = _dense_protocol(feats, nv, self._top_k(d), self.cfg.eig_floor,
                              group)
        return (*out, n_users, d)

    def _run_blockwise(self, feats: torch.Tensor, nv: torch.Tensor):
        n_users, n, d = feats.shape
        block = min(self.cfg.block_users, n_users)
        top_k = self._top_k(d)
        pad = (-n_users) % block
        if pad:
            # Phantom users (zero features, n_valid 1) square off the last
            # tile, as in the reference; their rows and columns are sliced
            # away below.
            feats = torch.cat([feats, feats.new_zeros((pad, n, d))])
            nv = torch.cat([nv, nv.new_ones((pad,))])
        n_total = n_users + pad

        # Pass 1: the signature table, one tile at a time (O(block d^2)
        # live Grams; the table is O(N d k), what each user downloads).
        tiles = [_tile_signatures(feats[s:s + block], nv[s:s + block], top_k)
                 for s in range(0, n_total, block)]
        lam_all = torch.cat([t[0] for t in tiles])            # (N_tot, k)
        v_all = torch.cat([t[1] for t in tiles])              # (N_tot, d, k)
        v_flat = v_all.permute(1, 0, 2).reshape(d, -1).contiguous()

        # Pass 2: relevance rows, tile by tile, Gram-free.
        rows = [_tile_rows(feats[s:s + block], nv[s:s + block],
                           lam_all[s:s + block], v_flat, self.cfg.eig_floor,
                           top_k)
                for s in range(0, n_total, block)]
        r = torch.cat(rows)[:n_users, :n_users]
        return r, sim.symmetrize(r), lam_all[:n_users], v_all[:n_users]

    def _run_landmarks(self, feats: torch.Tensor, nv: torch.Tensor):
        """Nystrom-sketched path -> ``(R, R, lam, v)``.

        Pass 1 makes the signature table in tiles of ``min(2048, N)``
        users (their Grams die with the tile).  Pass 2 scores every user
        against the m landmark projectors ``V_j V_j^T`` with the assign
        wave kernel, ``C[i, j] = ||V_j^T V_i||_F^2 / k``, one launch per
        tile, in bf16 inputs with fp32 sums as the reference's
        accelerator path does; ``_nystroem_complete`` fills in the rest.
        The sketch is symmetric, so the directed slot returns it too.
        """
        n_users, _, d = feats.shape
        m = self.cfg.landmarks
        if m >= n_users:
            raise ValueError(
                f"landmarks={m} must be < n_users={n_users}: the sketch "
                "only pays when m << N; drop landmarks to 0 and run the "
                "exact dense path instead")
        top_k = self._top_k(d)
        tile = min(2048, n_users)
        tiles = [_tile_signatures(feats[s:s + tile], nv[s:s + tile], top_k)
                 for s in range(0, n_users, tile)]
        lam_all = torch.cat([t[0] for t in tiles])            # (N, k)
        v_all = torch.cat([t[1] for t in tiles])              # (N, d, k)
        idx = torch.from_numpy(landmark_indices(n_users, m)).to(
            feats.device).long()
        v_land = v_all[idx]
        protos = torch.einsum("mdk,mek->mde", v_land, v_land)  # (m, d, d)
        c = torch.cat([assign_ops.assign(v_all[s:s + tile], protos,
                                         compute_dtype="bf16")[0]
                       for s in range(0, n_users, tile)])      # (N, m)
        big_r = _nystroem_complete(c, c[idx])
        return big_r, big_r, lam_all, v_all

    def relevance_and_similarity(self, features, n_valid=None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run the full protocol -> ``(r (N, N) directed, R symmetrized)``."""
        return self._protocol(features, n_valid)[:2]

    def similarity(self, features, n_valid=None) -> torch.Tensor:
        """``R (N, N)``: the matrix the GPS feeds to HAC."""
        return self.relevance_and_similarity(features, n_valid)[1]

    def run(self, features, n_valid=None) -> ProtocolResult:
        r, big_r, lam, v, n_users, d = self._protocol(features, n_valid)
        return ProtocolResult(relevance=r, similarity=big_r,
                              n_users=n_users, d=d, top_k=self._top_k(d),
                              lam=lam, v=v)

    # -- raw-data entry point ----------------------------------------------

    def _signature_engine(self, feature_cfg, signature_cfg, probe
                          ) -> "sig.SignatureEngine":
        """Build the ingest engine on this engine's device, deriving its
        backend from the protocol's when not given and rejecting
        conflicting combinations."""
        if signature_cfg is None:
            signature_cfg = sig.SignatureConfig(backend=self.cfg.backend,
                                                mesh_axis=self.cfg.mesh_axis)
        if ((signature_cfg.backend == "shard_map")
                != (self.cfg.backend == "shard_map")):
            raise ValueError(
                f"signature backend {signature_cfg.backend!r} conflicts "
                f"with protocol backend {self.cfg.backend!r}: shard_map "
                "ingest runs inside the sharded protocol; use both or "
                "neither")
        if (signature_cfg.backend == "shard_map"
                and signature_cfg.mesh_axis != self.cfg.mesh_axis):
            raise ValueError(
                f"signature mesh_axis {signature_cfg.mesh_axis!r} "
                f"conflicts with protocol mesh_axis "
                f"{self.cfg.mesh_axis!r}: the raw shard_map pipeline "
                "shards users over ONE axis")
        return sig.SignatureEngine(feature_cfg, signature_cfg, probe=probe,
                                   device=self.device)

    def run_raw(self, raw, feature_cfg, n_valid=None, probe=None,
                signature_cfg: "sig.SignatureConfig | None" = None
                ) -> ProtocolResult:
        """Full protocol from raw user shards: ``raw (N, n, m)`` (numpy
        on the host, a tensor, or a ragged list of ``(n_i, m)``) + a
        ``FeatureConfig`` -> ``(r, R)``.

        The ``SignatureEngine`` ingests on the device (streamed featurize
        -> Gram, batched top-k subspace iteration); the relevance stage
        then runs on the resulting ``(N, d', d')`` Gram stack.  Pass the
        ``pca`` probe set via ``probe=``.  ``block_users`` belongs to the
        pre-featurised path (it never holds the Gram stack, which raw
        relevance needs) and is rejected here.  Under ``shard_map`` every
        rank passes the same full ``raw`` and featurises its own users.
        """
        if self.cfg.block_users:
            raise ValueError(
                "run_raw computes relevance on the (N, d', d') Gram stack "
                "and does not support block_users streaming; stream the "
                "ROW axis instead via SignatureConfig.chunk_rows")
        if self.cfg.landmarks:
            raise ValueError(
                "run_raw computes exact relevance on the Gram stack and "
                "does not support the landmark sketch; featurize first "
                "and use run() with landmarks > 0")
        engine = self._signature_engine(feature_cfg, signature_cfg, probe)
        full = (n_valid is None
                and isinstance(raw, (torch.Tensor, np.ndarray)))
        raw, nv = engine.prepare(raw, n_valid)
        n_users, _, m = raw.shape
        d_out = engine.out_dim(m)
        top_k = self._top_k(d_out)
        group, rows = None, slice(None)
        if self.cfg.backend == "shard_map":
            # This rank's users only; Phi's parameters are rank 0's fit,
            # broadcast, so every rank featurises with the same bits.
            group = self._group()
            rows = mdist.local_rows(n_users, group, self.cfg.mesh_axis)
            params = engine.params_for(m)
            for name in sorted(params):
                dist.broadcast(params[name],
                               src=dist.get_global_rank(group, 0),
                               group=group)
        grams = engine.accumulate_grams(raw[rows], nv[rows],
                                        assume_full=full)
        r, big_r, resid, lam, v = _raw_finish(grams, top_k,
                                              self.cfg.eig_floor, engine,
                                              group)
        if engine.cfg.check:
            engine.verify_convergence(resid)
        return ProtocolResult(relevance=r, similarity=big_r,
                              n_users=n_users, d=d_out, top_k=top_k,
                              lam=lam, v=v)

    def similarity_from_raw(self, raw, feature_cfg, n_valid=None,
                            probe=None, signature_cfg=None) -> torch.Tensor:
        """``R (N, N)`` straight from raw shards; see ``run_raw``."""
        return self.run_raw(raw, feature_cfg, n_valid=n_valid, probe=probe,
                            signature_cfg=signature_cfg).similarity
