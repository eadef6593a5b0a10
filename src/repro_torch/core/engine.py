"""One-shot protocol engine (paper Algorithm 2), PyTorch port.

Mirrors the dense single-device path of ``src/repro/core/engine.py``
(``_dense_protocol``): per-user Grams (Eq. 1) in one kernel launch, the
top-k spectrum by batched ``eigh``, all ``N x N`` cross-projections
(Eq. 2) in one kernel launch, relevance (Eqs. 3-4) and symmetrization
(Eq. 5) in plain torch.  Everything stays on the engine's device.

Not ported yet, and rejected with ``NotImplementedError`` naming the
ROADMAP item that ports them: blockwise streaming (``block_users``),
the landmark sketch (``landmarks``), the sharded backend, and the
raw-data entry point ``run_raw``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import similarity as sim
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["ProtocolEngine", "ProtocolResult"]


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
                    top_k: int, eig_floor: float):
    """``features (N, n, d)`` -> ``(r, R, lam, v)`` on their device."""
    grams = sim.batched_gram(features, n_valid)
    lam, v = sim.spectrum(grams, top_k)
    r = sim.relevance_matrix(grams, lam, v, eig_floor)
    return r, sim.symmetrize(r), lam, v


class ProtocolEngine:
    """One object that owns the whole one-shot protocol on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` to run the kernels' plain versions.
    """

    def __init__(self, cfg: sim.SimilarityConfig | None = None,
                 device: str | torch.device = "cuda"):
        cfg = cfg or sim.SimilarityConfig()
        if cfg.backend == "shard_map":
            raise NotImplementedError(
                "the sharded protocol backend is not ported yet "
                "(ROADMAP Queue 1 item 13)")
        if cfg.block_users:
            raise NotImplementedError(
                "blockwise streaming (block_users > 0) is not ported yet "
                "(ROADMAP Queue 1 item 5, kernel: Queue 2 item 4)")
        if cfg.landmarks:
            raise NotImplementedError(
                "the landmark-sketched path (landmarks > 0) is not ported "
                "yet (ROADMAP Queue 1 item 9)")
        self.cfg = cfg
        self.device = resolve_device(device)

    def _top_k(self, d: int) -> int:
        """Effective signature width: ``0`` means all d, and a Gram only
        has d eigenpairs however large ``cfg.top_k`` is."""
        return min(self.cfg.top_k or d, d)

    def prepare(self, features, n_valid=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Any accepted input form -> ``(padded, n_valid)`` on the device."""
        return sim.prepare_user_batch(features, n_valid, device=self.device)

    def signatures(self, features, n_valid=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-user ``(lam (N, k), V (N, d, k), G (N, d, d))``."""
        feats, nv = self.prepare(features, n_valid)
        grams = sim.batched_gram(feats, nv)
        lam, v = sim.spectrum(grams, self._top_k(feats.shape[-1]))
        return lam, v, grams

    def _dense(self, feats: torch.Tensor, nv: torch.Tensor):
        return _dense_protocol(feats, nv, self._top_k(feats.shape[-1]),
                               self.cfg.eig_floor)

    def relevance_and_similarity(self, features, n_valid=None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run the full protocol -> ``(r (N, N) directed, R symmetrized)``."""
        return self._dense(*self.prepare(features, n_valid))[:2]

    def similarity(self, features, n_valid=None) -> torch.Tensor:
        """``R (N, N)``: the matrix the GPS feeds to HAC."""
        return self.relevance_and_similarity(features, n_valid)[1]

    def run(self, features, n_valid=None) -> ProtocolResult:
        feats, nv = self.prepare(features, n_valid)
        r, big_r, lam, v = self._dense(feats, nv)
        n_users, _, d = feats.shape
        return ProtocolResult(relevance=r, similarity=big_r,
                              n_users=n_users, d=d, top_k=self._top_k(d),
                              lam=lam, v=v)

    def run_raw(self, *args, **kwargs) -> ProtocolResult:
        raise NotImplementedError(
            "the raw-data entry point is not ported yet (ROADMAP Queue 1 "
            "item 7, kernel: Queue 2 item 5)")
