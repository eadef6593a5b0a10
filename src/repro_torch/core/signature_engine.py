"""Device-resident signature ingest: raw data -> Gram -> top-k spectrum.

PyTorch port of ``src/repro/core/signature_engine.py``:

  * **Fused featurize -> Gram.**  ``_chunk_gram_accum`` reduces each Phi
    kind to ``(z, w)`` and folds ``(z w)^T (z w)`` into the fp32 Gram
    stack: through the ``featurize_gram`` kernel when Phi ends in a
    projection, through the ``gram`` kernel for the identity.
  * **Row-chunk streaming.**  ``chunk_rows > 0`` accumulates one row
    chunk of every user at a time, so the ``(N, n, d')`` feature stack
    never exists.  A host numpy stack is copied to the device one chunk
    per step; a stack already on the device is sliced there.
  * **Batched top-k subspace iteration.**  ``topk_spectrum`` replaces
    the full ``eigh`` with orthogonal iteration + Rayleigh-Ritz;
    ``eig="eigh"`` is the exact fallback and ``subspace_residual``
    detects non-convergence.

``backend`` is ``"torch"`` (one device; the kernels follow the tensors'
device) or ``"shard_map"``, which marks the config for the sharded raw
protocol: ``ProtocolEngine.run_raw`` runs this engine's streaming step on
each rank's own users.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import similarity as sim
from repro_torch.data import features as feat
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.featurize_gram import ops as fg_ops
from repro_torch.kernels.gram import ops as gram_ops

__all__ = ["SignatureConfig", "SignatureEngine", "SIGNATURE_BACKENDS",
           "EIG_METHODS", "topk_spectrum", "subspace_residual",
           "subspace_start"]

SIGNATURE_BACKENDS = ("torch", "shard_map")
EIG_METHODS = ("subspace", "eigh")
_COMPUTE_DTYPES = ("fp32", "bf16")


@dataclasses.dataclass(frozen=True)
class SignatureConfig:
    """How raw user shards become ``(lam, V, G)`` signatures.

    Attributes:
      backend: ``"torch"``, or ``"shard_map"`` (the sharded raw protocol
        of ``ProtocolEngine.run_raw``; ``grams``/``signatures`` refuse it).
      chunk_rows: ``0`` ingests each user's rows in one pass; ``> 0``
        streams row chunks of this size into the Gram accumulator.
      eig: ``"subspace"`` (batched top-k orthogonal iteration) or
        ``"eigh"`` (exact full decomposition).
      subspace_iters: G-applications of the iteration, QR-ed every
        second one.
      oversample: extra iterated columns beyond ``top_k``.
      check: verify subspace convergence on every ingest; raises
        ``RuntimeError`` above ``resid_tol``.
      resid_tol: max relative eigen-residual the check accepts.
      compute_dtype: ``"fp32"``, or ``"bf16"`` matmul inputs with fp32
        sums.
      mesh_axis: mesh axis users are sharded over (shard_map backend).
    """

    backend: str = "torch"
    chunk_rows: int = 0
    eig: str = "subspace"
    subspace_iters: int = 20
    oversample: int = 8
    check: bool = False
    resid_tol: float = 1e-3
    compute_dtype: str = "fp32"
    mesh_axis: str = "data"

    def __post_init__(self):
        if self.backend not in SIGNATURE_BACKENDS:
            raise ValueError(f"backend must be one of {SIGNATURE_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.chunk_rows < 0:
            raise ValueError(f"chunk_rows must be >= 0, "
                             f"got {self.chunk_rows}")
        if self.eig not in EIG_METHODS:
            raise ValueError(f"eig must be one of {EIG_METHODS}, "
                             f"got {self.eig!r}")
        if self.subspace_iters < 0:
            raise ValueError(f"subspace_iters must be >= 0, "
                             f"got {self.subspace_iters}")
        if self.oversample < 0:
            raise ValueError(f"oversample must be >= 0, "
                             f"got {self.oversample}")
        if self.resid_tol <= 0:
            raise ValueError(f"resid_tol must be positive, "
                             f"got {self.resid_tol}")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {self.compute_dtype!r}")


# ---------------------------------------------------------------------------
# Batched top-k spectrum: subspace (orthogonal) iteration vs eigh
# ---------------------------------------------------------------------------

def subspace_start(d: int, p: int, seed: int = 0) -> torch.Tensor:
    """The iteration's raw start ``(d, p)``: standard normals from a CPU
    ``torch.Generator(seed)``, so the CPU and the card start from the
    same numbers (a CUDA generator would give others).  The reference
    draws its start from ``jax.random``, which no torch generator
    reproduces; tests pass the reference's draw as ``q0``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((d, p), generator=gen, dtype=torch.float32)


def _subspace_topk(grams: torch.Tensor, k: int, p: int, iters: int,
                   seed: int, q0=None) -> tuple[torch.Tensor, torch.Tensor]:
    d = grams.shape[-1]
    if q0 is None:
        q0 = subspace_start(d, p, seed)
    elif not isinstance(q0, torch.Tensor):
        q0 = torch.from_numpy(np.array(q0, dtype=np.float32))
    q0 = q0.to(device="cpu", dtype=torch.float32)
    if tuple(q0.shape) != (d, p):
        raise ValueError(f"q0 must be ({d}, {p}), got {tuple(q0.shape)}")
    # Orthonormalise on the CPU too, so every device starts from the same Q.
    q = torch.linalg.qr(q0)[0].to(grams.device)
    q = q.expand(grams.shape[0], d, p)
    # ``iters`` counts G-applications; re-orthogonalise every second one.
    for _ in range(iters // 2):
        q = torch.linalg.qr(grams @ (grams @ q))[0]
    if iters % 2:
        q = torch.linalg.qr(grams @ q)[0]
    # Rayleigh-Ritz on the iterated subspace.
    b = q.transpose(-1, -2) @ (grams @ q)
    b = (b + b.transpose(-1, -2)) / 2.0
    lam_b, w_b = torch.linalg.eigh(b)                # ascending
    lam = torch.clamp_min(lam_b.flip(-1), 0.0)[..., :k]
    v = (q @ w_b.flip(-1))[..., :k]
    return lam, v


def topk_spectrum(grams: torch.Tensor, top_k: int, *,
                  method: str = "subspace", iters: int = 20,
                  oversample: int = 8, seed: int = 0, q0=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of a PSD Gram stack ``(N, d, d)``, descending.

    Returns ``(lam (N, k), V (N, d, k))``.  ``method="subspace"`` runs
    batched orthogonal iteration on ``k + oversample`` columns and falls
    through to the exact ``eigh`` whenever the iterated subspace would
    cover the whole space anyway, including ``top_k = d``.  ``q0``
    (``(d, k + oversample)``, before orthonormalisation) replaces the
    seeded start.
    """
    if method not in EIG_METHODS:
        raise ValueError(f"method must be one of {EIG_METHODS}, "
                         f"got {method!r}")
    d = grams.shape[-1]
    k = min(top_k or d, d)
    p = min(k + oversample, d)
    if method == "eigh" or p >= d:
        return sim.spectrum(grams, k)   # exact: the dense engine's eigh
    return _subspace_topk(grams, k, p, iters, seed, q0)


def subspace_residual(grams: torch.Tensor, lam: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Relative eigen-residual ``max_k ||G v_k - lam_k v_k|| / lam_1``
    per user: the non-convergence detector of the subspace iteration."""
    r = grams @ v - v * lam[..., None, :]            # (N, d, k)
    num = torch.linalg.vector_norm(r, dim=-2)        # (N, k)
    scale = torch.clamp_min(lam[..., :1], 1e-12)
    return torch.amax(num / scale, dim=-1)


# ---------------------------------------------------------------------------
# Chunked featurize -> Gram accumulation (the streaming step)
# ---------------------------------------------------------------------------

def _project_inputs(x_chunk: torch.Tensor, mask: torch.Tensor | None,
                    params: dict, fcfg: feat.FeatureConfig
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Reduce any Phi kind to ``(z, w)`` with chunk Gram ``(z w)^T (z w)``
    (``w=None`` means identity), the form the kernels take.  The conv
    front end runs here; masking commutes with the trailing linear
    projection, so invalid rows contribute zero.  ``mask=None`` means
    every row is valid."""

    def masked(z):
        return z if mask is None else z * mask

    if fcfg.kind == "identity":
        return masked(x_chunk), None
    if fcfg.kind == "random_projection":
        return masked(x_chunk), params["w"]
    if fcfg.kind == "pca":
        return masked(x_chunk - params["mu"]), params["basis"]
    n_users, c, m = x_chunk.shape
    z = feat._random_conv_features(x_chunk.reshape(n_users * c, m),
                                   params["w1"], params["w2"],
                                   fcfg.image_hw)
    return masked(z.reshape(n_users, c, -1)), params.get("w_rp")


def _chunk_gram_accum(acc: torch.Tensor, x_chunk: torch.Tensor,
                      n_valid: torch.Tensor, start: int, params: dict,
                      fcfg: feat.FeatureConfig, compute_dtype: str,
                      apply_mask: bool = True) -> torch.Tensor:
    """One streaming step: ``acc (N, d', d') += Phi(chunk)^T Phi(chunk)``,
    in place; returns ``acc``.

    ``x_chunk (N, c, m)`` raw rows starting at global row ``start``;
    rows at or beyond each user's ``n_valid`` are masked to zero after
    Phi (the same as zero-padding the featurised stack, for every kind
    including the affine ``pca``).  ``apply_mask=False`` skips the mask
    pass: only valid when every chunk row is a data row.
    """
    x_chunk = x_chunk.to(torch.float32)
    mask = None
    if apply_mask:
        rows = start + torch.arange(x_chunk.shape[1], device=x_chunk.device)
        mask = (rows[None, :] < n_valid[:, None]).to(torch.float32)[..., None]
    z, w = _project_inputs(x_chunk, mask, params, fcfg)
    if w is None:
        if compute_dtype == "bf16":
            # bf16 x bf16 products are exact in fp32 and the reference
            # sums them in fp32, so rounding z to bf16 and running the
            # fp32 gram kernel is the same function.
            z = z.to(torch.bfloat16).to(torch.float32)
        return acc.add_(gram_ops.batched_gram_matrix(z))
    return fg_ops.batched_featurize_gram(z, w, compute_dtype, out=acc)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class SignatureEngine:
    """One object that owns raw-data ingest: Phi, Gram streaming, top-k.

    ``feature_cfg`` fixes the shared Phi (pass the ``pca`` probe set via
    ``probe=``; the config only pins its digest); ``cfg`` picks the
    execution strategy.  Runs on ``device`` (default ``"cuda"``, which
    raises without a card).
    """

    def __init__(self, feature_cfg: feat.FeatureConfig,
                 cfg: SignatureConfig | None = None,
                 probe: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        if not isinstance(feature_cfg, feat.FeatureConfig):
            raise TypeError("feature_cfg must be a FeatureConfig, got "
                            f"{type(feature_cfg).__name__}")
        self.feature_cfg = feature_cfg
        self.cfg = cfg or SignatureConfig()
        self.device = resolve_device(device)
        self._probe = probe
        self._params: dict[int, dict] = {}

    def params_for(self, m: int) -> dict:
        """Phi parameters for input dim ``m``, cached per engine as
        tensors on the engine's device."""
        if m not in self._params:
            self._params[m] = feat.params_on(
                feat.phi_params(self.feature_cfg, m, probe=self._probe),
                self.device)
        return self._params[m]

    def out_dim(self, m: int) -> int:
        return feat.phi_out_dim(self.feature_cfg, m, probe=self._probe)

    def prepare(self, raw, n_valid=None):
        """Normalise raw input to ``(padded (N, n, m), n_valid (N,))``.

        Ragged lists of per-user ``(n_i, m)`` arrays are zero-padded on
        the host; a numpy stack stays on the host and a tensor stays
        where it is, so the streaming step copies one row chunk at a
        time.  ``n_valid`` goes to the engine's device.
        """
        if not isinstance(raw, (torch.Tensor, np.ndarray)):
            if n_valid is not None:
                raise ValueError("n_valid is derived from ragged input; "
                                 "pass one or the other")
            counts = [x.shape[0] for x in raw]
            padded = np.zeros((len(raw), max(counts), raw[0].shape[1]),
                              np.float32)
            for i, x in enumerate(raw):
                padded[i, : x.shape[0]] = np.asarray(x)
            raw, n_valid = padded, counts
        if raw.ndim != 3:
            raise ValueError(f"user batch must be (N, n, m)-shaped "
                             f"(users, rows, dim), got shape "
                             f"{tuple(raw.shape)}")
        if n_valid is None:
            n_valid = [raw.shape[1]] * raw.shape[0]
        nv = torch.as_tensor(np.asarray(n_valid, dtype=np.float32)
                             if not isinstance(n_valid, torch.Tensor)
                             else n_valid)
        return raw, nv.to(device=self.device, dtype=torch.float32)

    def _chunk(self, raw, s: int, e: int) -> torch.Tensor:
        """Rows ``[s, e)`` of every user, on the engine's device."""
        x = raw[:, s:e]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def accumulate_grams(self, raw, nv: torch.Tensor,
                         assume_full: bool = False) -> torch.Tensor:
        """The streaming core: ``raw (N, n, m)`` -> Grams ``(N, d', d')``.

        Streams ``chunk_rows`` rows at a time into the fp32 accumulator;
        each featurised chunk dies in the kernel.  ``assume_full=True``
        declares every user's count equal to n, so the ragged mask pass
        is elided.  (The reference pads the last chunk to the chunk
        size, so that one compiled step serves every chunk, and masks
        that padded tail; eager torch takes the short tail as it is, so
        with ``assume_full`` no chunk needs the mask.)
        """
        n_users, n, m = raw.shape
        d_out = self.out_dim(m)
        params = self.params_for(m)
        chunk = min(self.cfg.chunk_rows or n, n)
        acc = torch.zeros((n_users, d_out, d_out), dtype=torch.float32,
                          device=self.device)
        for s in range(0, n, chunk):
            _chunk_gram_accum(acc, self._chunk(raw, s, s + chunk), nv, s,
                              params, self.feature_cfg,
                              self.cfg.compute_dtype,
                              apply_mask=not assume_full)
        return acc / torch.clamp_min(nv, 1.0)[:, None, None]

    def grams(self, raw, n_valid=None) -> torch.Tensor:
        """Per-user Grams ``(N, d', d')`` straight from raw shards."""
        if self.cfg.backend == "shard_map":
            raise ValueError(
                "the shard_map signature backend runs inside "
                "ProtocolEngine.run_raw (it owns the mesh); use backend "
                "'torch' for direct grams()")
        full = (n_valid is None
                and isinstance(raw, (torch.Tensor, np.ndarray)))
        raw, nv = self.prepare(raw, n_valid)
        return self.accumulate_grams(raw, nv, assume_full=full)

    def verify_convergence(self, resid: torch.Tensor) -> None:
        """Raise ``RuntimeError`` if any user's relative eigen-residual
        exceeds ``cfg.resid_tol`` (a host sync)."""
        worst = float(torch.max(resid))
        if not worst < self.cfg.resid_tol:
            raise RuntimeError(
                f"top-k subspace iteration did not converge: max "
                f"relative residual {worst:.2e} > tol "
                f"{self.cfg.resid_tol:.2e} — raise subspace_iters/"
                f"oversample or set eig='eigh'")

    def spectrum(self, grams: torch.Tensor, top_k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """``topk_spectrum`` with this engine's eigensolver settings."""
        return topk_spectrum(grams, top_k, method=self.cfg.eig,
                             iters=self.cfg.subspace_iters,
                             oversample=self.cfg.oversample)

    def signatures(self, raw, n_valid=None, top_k: int = 8,
                   check: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Raw shards -> ``(lam (N, k), V (N, d', k), G (N, d', d'))``.

        ``check`` (default ``cfg.check``) verifies subspace convergence
        and raises ``RuntimeError`` above ``cfg.resid_tol``.
        """
        g = self.grams(raw, n_valid)
        lam, v = self.spectrum(g, top_k)
        if self.cfg.check if check is None else check:
            self.verify_convergence(subspace_residual(g, lam, v))
        return lam, v, g
