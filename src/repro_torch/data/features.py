"""Feature maps Phi for the similarity protocol (paper Eq. 1), PyTorch port.

Mirrors ``src/repro/data/features.py``.  Four fixed, *shared* maps:

  * identity          : Phi(x) = x                       (FMNIST path)
  * random_projection : x W,  W (m, d) fixed Gaussian / sqrt(d)  (JL)
  * random_conv       : fixed random-init 2-layer conv net -> pooled
                        features (pretrained-feature surrogate; CIFAR path)
  * pca               : top-d PCA basis fit on a public probe set

The parameters come from numpy, seeded by ``FeatureConfig.seed`` (and
the probe content for ``pca``), so ``phi_params`` returns arrays equal
bit for bit to the reference's.  ``phi_apply`` runs Phi in torch on the
tensor's device.  The conv front end is ``torch.nn.functional.conv2d``
(the reference ran it in XLA, outside any kernel); it keeps the
reference's flat ``(n, H*W*C)`` input and NHWC-ordered flat output, and
pads ``"SAME"`` as XLA does (asymmetrically, more after than before).
On a card it runs with cuDNN's TF32 turned off (PyTorch's default
would run fp32 convolutions in TF32, about three decimal digits; the
reference computes in full fp32).

``FeatureConfig`` is a frozen *hashable* dataclass: the ``pca`` probe set
is not stored on it, only its digest; callers pass the array explicitly.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FeatureConfig", "feature_map", "probe_digest",
           "phi_params", "phi_apply", "phi_out_dim", "params_on",
           "PHI_KINDS"]

PHI_KINDS = ("identity", "random_projection", "random_conv", "pca")


def probe_digest(probe: np.ndarray) -> str:
    """Stable content digest of a public probe set (shape + fp32 bytes)."""
    arr = np.ascontiguousarray(np.asarray(probe, dtype=np.float32))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Which shared Phi every user applies (hashable, probe-free).

    ``probe_digest`` optionally pins the ``pca`` probe content: when set,
    any probe array passed alongside this config must hash to it.
    """

    kind: str = "random_projection"   # identity|random_projection|random_conv|pca
    d: int = 256                      # output feature dimension
    seed: int = 7
    image_hw: tuple[int, int, int] | None = None  # (H, W, C) for random_conv
    probe_digest: str | None = None   # content digest of the pca probe set

    def __post_init__(self):
        if self.kind not in PHI_KINDS:
            raise ValueError(f"unknown feature map kind {self.kind!r}; "
                             f"expected one of {PHI_KINDS}")
        if self.d <= 0:
            raise ValueError(f"feature dim d must be positive, got {self.d}")
        if self.kind == "random_conv" and self.image_hw is None:
            raise ValueError("random_conv needs image_hw=(H, W, C)")
        if self.image_hw is not None:
            object.__setattr__(self, "image_hw", tuple(self.image_hw))

    def bind_probe(self, probe: np.ndarray) -> "FeatureConfig":
        """Pin this config to a concrete probe set (content digest)."""
        return dataclasses.replace(self, probe_digest=probe_digest(probe))


def _check_probe(cfg: FeatureConfig, probe: np.ndarray | None) -> np.ndarray:
    if probe is None:
        raise ValueError("pca needs a public probe set: pass probe=... "
                         "explicitly (FeatureConfig carries only its "
                         "digest)")
    if cfg.probe_digest is not None:
        got = probe_digest(probe)
        if got != cfg.probe_digest:
            raise ValueError(
                f"probe content digest {got} does not match the one pinned "
                f"on FeatureConfig ({cfg.probe_digest}) — Phi must be fit "
                "on the same public set for every user")
    return np.asarray(probe, dtype=np.float32)


def _check_dim(cfg: FeatureConfig, m: int, what: str = "input") -> None:
    if cfg.d > m:
        raise ValueError(
            f"feature dim d={cfg.d} exceeds {what} dim m={m}: "
            f"{cfg.kind!r} only projects down — lower d or use identity")


def _rp_matrix(m: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng((seed, 11))
    return (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)


def _conv_params(c_in: int, seed: int) -> dict:
    rng = np.random.default_rng((seed, 13))

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)

    return {
        "w1": he((5, 5, c_in, 32), 5 * 5 * c_in),
        "w2": he((5, 5, 32, 64), 5 * 5 * 32),
    }


def _same_pad(size: int, kernel: int = 5, stride: int = 2
              ) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: ``(before, after)``, with the
    odd element after (32 -> (1, 2) for a 5-wide kernel at stride 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_same(y: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """Stride-2 ``"SAME"`` conv of NCHW ``y`` with an HWIO filter."""
    (t, b), (l, r) = _same_pad(y.shape[2]), _same_pad(y.shape[3])
    y = F.pad(y, (l, r, t, b))
    cudnn = torch.backends.cudnn
    allow_tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        return F.conv2d(y, w_hwio.permute(3, 2, 0, 1), stride=2)
    finally:
        cudnn.allow_tf32 = allow_tf32


def _random_conv_features(x_flat: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor, hw: tuple[int, int, int]
                          ) -> torch.Tensor:
    """``x_flat (n, H*W*C)`` NHWC pixels -> ``(n, conv_dim)`` pooled conv
    features, flattened in NHWC order as the reference flattens them."""
    h, w, c = hw
    y = x_flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = torch.relu(_conv_same(y, w1))
    y = torch.relu(_conv_same(y, w2))
    # 4x4 average-pooled grid -> flattened feature vector.
    gh = max(1, y.shape[2] // 4)
    gw = max(1, y.shape[3] // 4)
    y = F.avg_pool2d(y, (gh, gw), stride=(gh, gw))
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)


# ---------------------------------------------------------------------------
# Parameter / application split
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _cached_params(cfg: FeatureConfig, m: int) -> dict:
    """Seed-deterministic Phi parameters for the probe-free kinds."""
    if cfg.kind == "identity":
        return {}
    if cfg.kind == "random_projection":
        _check_dim(cfg, m)
        return {"w": _rp_matrix(m, cfg.d, cfg.seed)}
    p = _conv_params(cfg.image_hw[2], cfg.seed)
    conv_dim = _conv_out_dim(cfg.image_hw)
    if cfg.d and cfg.d < conv_dim:
        p = dict(p, w_rp=_rp_matrix(conv_dim, cfg.d, cfg.seed + 1))
    return p


def _conv_out_dim(hw: tuple[int, int, int]) -> int:
    """Flat width of ``_random_conv_features`` without running the convs."""
    h, w, _ = hw
    h2 = -(-(-(-h // 2)) // 2)
    w2 = -(-(-(-w // 2)) // 2)
    gh, gw = max(1, h2 // 4), max(1, w2 // 4)
    return (h2 // gh) * (w2 // gw) * 64


def phi_params(cfg: FeatureConfig, m: int,
               probe: np.ndarray | None = None) -> dict:
    """Host-side Phi parameters (numpy float32), deterministic in
    ``cfg.seed`` (and the probe content for ``pca``): the same arrays as
    the reference's ``phi_params``."""
    if cfg.kind == "pca":
        probe = _check_probe(cfg, probe)
        _check_dim(cfg, probe.shape[1], what="probe")
        mu = probe.mean(0, keepdims=True)
        _, _, vt = np.linalg.svd(probe - mu, full_matrices=False)
        return {"mu": mu, "basis": np.ascontiguousarray(vt[: cfg.d].T)}
    return _cached_params(cfg, m)


def phi_out_dim(cfg: FeatureConfig, m: int,
                probe: np.ndarray | None = None) -> int:
    """Output feature dimension d' of Phi for input dim ``m``."""
    if cfg.kind == "identity":
        return m
    if cfg.kind == "random_projection":
        return cfg.d
    if cfg.kind == "pca":
        if probe is not None:
            return min(cfg.d, np.asarray(probe).shape[0],
                       np.asarray(probe).shape[1])
        return cfg.d
    conv_dim = _conv_out_dim(cfg.image_hw)
    return cfg.d if (cfg.d and cfg.d < conv_dim) else conv_dim


def params_on(params: dict, device: str | torch.device) -> dict:
    """Phi parameters (numpy or tensors) as float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in params.items()}


def phi_apply(x: torch.Tensor, params: dict, cfg: FeatureConfig
              ) -> torch.Tensor:
    """Phi on one chunk ``x (n, m)`` -> ``(n, d')`` fp32, on ``x``'s device.

    ``params`` may hold numpy arrays or tensors (see ``params_on``).
    """
    x = x.to(torch.float32)
    p = params_on(params, x.device)
    if cfg.kind == "identity":
        return x
    if cfg.kind == "random_projection":
        return x @ p["w"]
    if cfg.kind == "pca":
        return (x - p["mu"]) @ p["basis"]
    feats = _random_conv_features(x, p["w1"], p["w2"], cfg.image_hw)
    if "w_rp" in p:
        feats = feats @ p["w_rp"]
    return feats


def feature_map(x: np.ndarray, cfg: FeatureConfig,
                probe: np.ndarray | None = None) -> np.ndarray:
    """Apply Phi to one user's raw data ``x (n, m)`` on the host ->
    ``(n, d')`` numpy float32."""
    x = np.asarray(x, dtype=np.float32)
    if cfg.kind == "random_projection":
        _check_dim(cfg, x.shape[1])
    params = phi_params(cfg, x.shape[1], probe=probe)
    return phi_apply(torch.from_numpy(x), params, cfg).numpy()
