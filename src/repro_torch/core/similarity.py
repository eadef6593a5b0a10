"""Data-similarity estimation (paper §II-B, Eqs. 1-5), PyTorch port.

Mirrors ``src/repro/core/similarity.py``.  Each user i holds features
``F_i in R^{n_i x d}``:

  1. ``gram(F_i)``               -> ``G_i = (1/n_i) F_i^T F_i``        (Eq. 1)
  2. ``spectrum(G_i)``           -> top-k eigenpairs ``(lam_i, V_i)``
  3. ``cross_project(G_i, V_j)`` -> ``lamhat_k = ||G_i v_k^{(j)}||``  (Eq. 2)
  4. ``relevance(lam_i, lamhat)`` -> geometric-mean ratio ``r(i,j)`` (Eqs. 3-4)
  5. ``symmetrize(r)``           -> ``R(i,j) = (r(i,j)+r(j,i))/2``   (Eq. 5)

Functions take tensors and work on the tensors' device.  The Gram and
the cross-projection go through the hand-written kernels
(``kernels/gram``, ``kernels/eigproject``) for CUDA tensors and through
their plain versions for CPU tensors; ``torch.linalg.eigh`` stays a
library call, as ``jnp.linalg.eigh`` was outside any Pallas kernel.

Beyond the paper (its §IV future work): ``perturb_eigenvectors`` puts
noise on the shared eigenvectors and ``subsample_rows`` (numpy only, a
copy of the reference's) estimates a Gram from fewer rows.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.eigproject import ops as proj_ops
from repro_torch.kernels.gram import ops as gram_ops

__all__ = [
    "SimilarityConfig",
    "BACKENDS",
    "pad_ragged",
    "prepare_user_batch",
    "gram",
    "batched_gram",
    "spectrum",
    "user_signature",
    "cross_project",
    "relevance",
    "relevance_matrix",
    "symmetrize",
    "signature_relevance",
    "similarity_matrix",
    "perturb_eigenvectors",
    "perturb_with_noise",
    "subsample_rows",
]

EPS = 1e-12

#: Largest ``(rows, N, k, k)`` block of ``signature_relevance``, in floats.
_SIG_BLOCK_ELEMS = 1 << 24

#: ``"torch"`` runs on one device; ``"shard_map"`` shards users over the
#: ranks of a ``torch.distributed`` mesh axis (``core/distributed.py``).
BACKENDS = ("torch", "shard_map")


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """Configuration of the one-shot similarity protocol.

    Attributes:
      top_k: eigenvectors each user shares; ``0`` means all d.
      eig_floor: eigenvalues below this are clamped before the min/max
        ratio (paper §III).
      backend: ``"torch"`` or ``"shard_map"`` (users sharded over
        ``mesh_axis``, one process a device).
      block_users: ``> 0`` selects blockwise streaming: users in tiles
        of this size, Grams only per tile, Gram-free cross-projection.
      landmarks: ``> 0`` selects the Nystrom-sketched path: every user is
        scored against this many landmark projectors, and R is completed
        from that block.
      mesh_axis: mesh axis users are sharded over (shard_map backend).

    Kernel choice is not configured: it follows the tensors' device.
    """

    top_k: int = 8
    eig_floor: float = 1e-6
    backend: str = "torch"
    block_users: int = 0
    landmarks: int = 0
    mesh_axis: str = "data"

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = all d eigenpairs), "
                             f"got {self.top_k}")
        if self.eig_floor <= 0:
            raise ValueError(f"eig_floor must be positive (it clamps the "
                             f"min/max ratio), got {self.eig_floor}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.block_users < 0:
            raise ValueError(f"block_users must be >= 0, "
                             f"got {self.block_users}")
        if self.landmarks < 0:
            raise ValueError(f"landmarks must be >= 0 (0 = exact, no "
                             f"sketch), got {self.landmarks}")
        if self.landmarks and self.block_users:
            raise ValueError("landmarks and block_users are mutually "
                             "exclusive: pick one")


def pad_ragged(features: Sequence[np.ndarray],
               device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad a ragged list of per-user ``(n_i, d)`` feature matrices.

    Returns ``(padded (N, n_max, d) float32, n_valid (N,) float32)`` on
    ``device``.
    """
    counts = [f.shape[0] for f in features]
    d = features[0].shape[1]
    padded = np.zeros((len(features), max(counts), d), dtype=np.float32)
    for i, f in enumerate(features):
        padded[i, : f.shape[0]] = np.asarray(f)
    return (torch.from_numpy(padded).to(device),
            torch.tensor(counts, dtype=torch.float32, device=device))


def prepare_user_batch(data, n_valid=None,
                       device: str | torch.device = "cuda"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize either accepted user-batch form to ``(padded, n_valid)``.

    Ragged lists of per-user ``(n_i, d)`` arrays are zero-padded via
    ``pad_ragged``; stacked ``(N, n, d)`` arrays or tensors are moved to
    ``device`` as float32, with full-length counts unless the true ones
    are supplied (rows past a user's count must already be zero).
    """
    if not isinstance(data, (torch.Tensor, np.ndarray)):
        if n_valid is not None:
            raise ValueError("n_valid is derived from ragged input; "
                             "pass one or the other")
        return pad_ragged(data, device=device)
    data = torch.as_tensor(data).to(device=device, dtype=torch.float32)
    if data.ndim != 3:
        raise ValueError(f"user batch must be (N, n, m)-shaped "
                         f"(users, rows, dim), got shape {tuple(data.shape)}")
    if n_valid is None:
        n_valid = torch.full((data.shape[0],), data.shape[1],
                             dtype=torch.float32, device=device)
    return data, torch.as_tensor(n_valid).to(device=device,
                                             dtype=torch.float32)


# ---------------------------------------------------------------------------
# Step 1: Gram matrix (Eq. 1)
# ---------------------------------------------------------------------------

def gram(features: torch.Tensor, *, n_valid=None) -> torch.Tensor:
    """``(1/n) F^T F`` for one user's feature matrix ``F (n, d)``.

    Rows ``>= n_valid`` must already be zero; the normalisation uses
    ``max(n_valid, 1)`` instead of the padded length.
    """
    n = features.shape[0] if n_valid is None else n_valid
    n = torch.clamp_min(torch.as_tensor(n, dtype=torch.float32,
                                         device=features.device), 1.0)
    return gram_ops.gram_matrix(features) / n


def batched_gram(features: torch.Tensor, n_valid: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Gram over a user axis: ``features (N, n, d) -> (N, d, d)``, one
    kernel launch for the whole stack, the division by ``max(n_valid, 1)``
    in its epilogue."""
    if n_valid is None:
        n_valid = torch.full((features.shape[0],), features.shape[1],
                             dtype=torch.float32, device=features.device)
    return gram_ops.batched_gram_matrix(features, n_valid)


# ---------------------------------------------------------------------------
# Step 2: eigen-decomposition -> user signature
# ---------------------------------------------------------------------------

def spectrum(g: torch.Tensor, top_k: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of PSD Gram matrices ``g (..., d, d)``,
    descending order: ``(lam (..., k), V (..., d, k))`` with
    ``k = top_k or d``.  Numerical negatives are clamped at 0.

    ``eigh`` returns ascending order; the top k are taken before the flip
    so only ``(d, k)`` blocks are copied.
    """
    lam, v = torch.linalg.eigh(g)
    d = lam.shape[-1]
    k = top_k if top_k and top_k < d else d
    lam = torch.clamp_min(lam[..., d - k:].flip(-1), 0.0)
    return lam, v[..., d - k:].flip(-1)


def user_signature(features: torch.Tensor, cfg: SimilarityConfig,
                   *, n_valid=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One user's public signature: ``(lam (k,), V (d, k), G (d, d))``.

    ``lam`` and ``V`` are what the user shares; ``G`` stays private and is
    used locally for cross-projection.  On a CUDA tensor the Gram is the
    ``gram`` kernel's.
    """
    g = gram(features, n_valid=n_valid)
    lam, v = spectrum(g, cfg.top_k)
    return lam, v, g


# ---------------------------------------------------------------------------
# Step 3: cross-projection (Eq. 2)
# ---------------------------------------------------------------------------

def cross_project(g_own: torch.Tensor, v_other: torch.Tensor
                  ) -> torch.Tensor:
    """``lamhat_k = || G_i v_k^{(j)} ||_2``: ``g_own (d, d)``,
    ``v_other (d, k)`` -> ``(k,)``."""
    return proj_ops.project_norms(g_own, v_other)


# ---------------------------------------------------------------------------
# Step 4: relevance (Eqs. 3-4)
# ---------------------------------------------------------------------------

def relevance(lam_own: torch.Tensor, lam_hat: torch.Tensor,
              eig_floor: float = 1e-6) -> torch.Tensor:
    """Geometric mean of the min/max eigenvalue ratios over the last axis.

    Both spectra are floored at ``eig_floor`` first (paper §III) and the
    mean is taken in log space: ``exp(mean_k log(min/max))``.  Leading
    axes broadcast, so ``(N, 1, k)`` against ``(N, N, k)`` gives every
    pair at once.
    """
    a = torch.clamp_min(lam_own, eig_floor)
    b = torch.clamp_min(lam_hat, eig_floor)
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    return torch.exp(torch.mean(torch.log(lo) - torch.log(hi), dim=-1))


def relevance_matrix(grams: torch.Tensor, lams: torch.Tensor,
                     vs: torch.Tensor, eig_floor: float = 1e-6
                     ) -> torch.Tensor:
    """All-pairs directed relevance ``r (N, N)``.

    ``grams (N, d, d)``: each user's private Gram; ``lams (N, k)``,
    ``vs (M, d, k)``: shared signatures.  ``r[i, j]`` projects j's
    eigenvectors through i's Gram and compares against i's own spectrum
    (Algorithm 2 lines 7-12).  All ``N x M`` cross-projections are one
    kernel launch.
    """
    lam_hat = proj_ops.project_norms_all(grams, vs)      # (N, M, k)
    return relevance(lams[:, None, :], lam_hat, eig_floor)


# ---------------------------------------------------------------------------
# Step 5: symmetrization (Eq. 5)
# ---------------------------------------------------------------------------

def symmetrize(r: torch.Tensor) -> torch.Tensor:
    """``R = (r + r^T) / 2``: the GPS-side average of the two views."""
    return (r + r.T) / 2.0


def signature_relevance(lam: torch.Tensor, v: torch.Tensor,
                        eig_floor: float = 1e-6) -> torch.Tensor:
    """Symmetrized relevance ``R (N, N)`` from SHARED signatures only.

    Rank-k Gram reconstruction: ``G_i v ~ V_i diag(lam_i) (V_i^T v)``, so
    ``lamhat(i, j) = ||diag(lam_i) (V_i^T V_j)||`` column-wise: O(k^2 d)
    per pair and no private Gram.  The membership re-cluster uses it.
    Rows go in blocks so the ``(rows, N, k, k)`` products stay below
    ``_SIG_BLOCK_ELEMS`` floats, as the reference's row map keeps its
    peak memory O(N k^2).
    """
    n, _, k = v.shape
    rows = max(1, _SIG_BLOCK_ELEMS // max(n * k * k, 1))
    out = []
    for s in range(0, n, rows):
        lam_i = lam[s:s + rows]
        c = torch.einsum("rdk,ndl->rnkl", v[s:s + rows], v)   # (R, N, k, k)
        lam_hat = torch.sqrt(((lam_i[:, None, :, None] * c) ** 2)
                             .sum(dim=2))                     # (R, N, k)
        out.append(relevance(lam_i[:, None, :], lam_hat, eig_floor))
    return symmetrize(torch.cat(out))


# ---------------------------------------------------------------------------
# Beyond-paper: privacy noise + subsampled Gram (paper §IV future work)
# ---------------------------------------------------------------------------

def perturb_with_noise(v: torch.Tensor, sigma: float, noise: torch.Tensor,
                       renormalize: bool = True) -> torch.Tensor:
    """``perturb_eigenvectors``'s arithmetic on a given standard-normal
    ``noise`` of ``v``'s shape: ``v + sigma noise`` in float32, columns
    re-normalised (over axis -2) when asked, cast back to ``v.dtype``."""
    out = v.to(torch.float32) + sigma * noise.to(torch.float32)
    if renormalize:
        norms = torch.linalg.vector_norm(out, dim=-2, keepdim=True)
        out = out / torch.clamp_min(norms, EPS)
    return out.to(v.dtype)


def perturb_eigenvectors(v: torch.Tensor, sigma: float,
                         generator: torch.Generator | int,
                         renormalize: bool = True) -> torch.Tensor:
    """Additive Gaussian noise on the SHARED eigenvectors (the only thing
    that leaves a user): the extra privacy layer the paper's §IV names as
    future work.  ``v (d, k)`` or ``(N, d, k)``; columns are re-normalized
    so the projection magnitudes stay comparable.  The noise is drawn
    from ``generator``, a ``torch.Generator`` on ``v``'s device (an int
    seeds a new one there).
    """
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=v.device).manual_seed(
            int(generator))
    noise = torch.randn(v.shape, generator=generator, device=v.device,
                        dtype=torch.float32)
    return perturb_with_noise(v, sigma, noise, renormalize)


def subsample_rows(features: np.ndarray, max_rows: int,
                   seed: int = 0) -> np.ndarray:
    """Nystrom-style row subsampling: the Gram estimate from ``max_rows``
    uniformly-sampled rows is an unbiased second-moment estimator, cutting
    the Eq.-1 cost from O(n d^2) to O(max_rows d^2) for n >> d regimes."""
    n = features.shape[0]
    if n <= max_rows:
        return features
    idx = np.random.default_rng(seed).choice(n, max_rows, replace=False)
    return features[idx]


def similarity_matrix(features, cfg: SimilarityConfig | None = None,
                      n_valid=None, device: str | torch.device = "cuda"
                      ) -> torch.Tensor:
    """Full protocol on a user batch -> ``R (N, N)``; thin wrapper over
    ``repro_torch.core.engine.ProtocolEngine``."""
    from repro_torch.core.engine import ProtocolEngine

    return ProtocolEngine(cfg, device=device).similarity(features,
                                                         n_valid=n_valid)
