"""Carry the reference's state into the port.

The protocol has no learned weights: what must match between the JAX
package and the port is its configuration, the shared Phi parameters
(the raw path's "weights", seeded through numpy), and the shared
signatures.  These functions read the reference's objects by attribute
and its arrays through ``numpy.asarray`` (no import of the JAX
package), so a test can run the port's stages on the reference's own
parameters and signatures, free of ``eigh``'s sign and
degenerate-subspace choices.

The LM model zoo does have weights; ``lm_params_from_reference`` walks
the reference's nested parameter dict into the port's ``LM`` and
``cluster_heads_from_reference`` carries the per-cluster serving heads,
so a test runs both packages on the same random weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cluster_engine import ClusterConfig
from repro_torch.core.membership_engine import MembershipConfig
from repro_torch.core.signature_engine import SignatureConfig
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data.features import FeatureConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.decode_loop import ClusterHeads
from repro_torch.models import transformer

__all__ = ["similarity_config_from_reference",
           "cluster_config_from_reference", "signatures_from_reference",
           "feature_config_from_reference",
           "signature_config_from_reference", "phi_params_from_reference",
           "membership_config_from_reference", "lm_params_from_reference",
           "cluster_heads_from_reference"]


def similarity_config_from_reference(cfg) -> SimilarityConfig:
    """A reference ``SimilarityConfig`` -> the port's.  The ``jnp`` and
    ``pallas`` backends (and ``impl``) map to ``torch``: the port picks
    the kernel by the tensors' device."""
    return SimilarityConfig(
        top_k=cfg.top_k, eig_floor=cfg.eig_floor,
        backend="shard_map" if cfg.backend == "shard_map" else "torch",
        block_users=cfg.block_users, landmarks=cfg.landmarks,
        mesh_axis=cfg.mesh_axis)


def cluster_config_from_reference(cfg) -> ClusterConfig:
    """A reference ``ClusterConfig`` -> the port's: ``numpy`` stays,
    ``jnp`` and ``pallas`` map to ``torch``."""
    return ClusterConfig(
        backend="numpy" if cfg.backend == "numpy" else "torch",
        linkage=cfg.linkage)


def signatures_from_reference(lam, v, grams=None,
                              device: str | torch.device = "cuda"):
    """Reference signatures ``lam (N, k)``, ``v (N, d, k)`` and optional
    Grams ``(N, d, d)`` -> float32 tensors on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return tensor(lam), tensor(v), None if grams is None else tensor(grams)


def feature_config_from_reference(cfg) -> FeatureConfig:
    """A reference ``FeatureConfig`` -> the port's (same fields, so the
    same seeded Phi and the same pinned probe digest)."""
    return FeatureConfig(kind=cfg.kind, d=cfg.d, seed=cfg.seed,
                         image_hw=cfg.image_hw,
                         probe_digest=cfg.probe_digest)


def signature_config_from_reference(cfg) -> SignatureConfig:
    """A reference ``SignatureConfig`` -> the port's.  The ``jnp`` and
    ``pallas`` backends map to ``torch``: the port picks the kernel by
    the tensors' device."""
    return SignatureConfig(
        backend="shard_map" if cfg.backend == "shard_map" else "torch",
        chunk_rows=cfg.chunk_rows, eig=cfg.eig,
        subspace_iters=cfg.subspace_iters, oversample=cfg.oversample,
        check=cfg.check, resid_tol=cfg.resid_tol,
        compute_dtype=cfg.compute_dtype, mesh_axis=cfg.mesh_axis)


def phi_params_from_reference(params: dict,
                              device: str | torch.device = "cuda") -> dict:
    """The reference's ``phi_params`` arrays -> float32 tensors on
    ``device``, in the form ``SignatureEngine.params_for`` caches."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def membership_config_from_reference(cfg) -> MembershipConfig:
    """A reference ``MembershipConfig`` -> the port's.  ``numpy`` stays;
    ``pallas`` maps to ``torch`` with the same ``compute_dtype``; ``jnp``
    maps to ``torch`` with ``compute_dtype="fp32"``, because the
    reference's jnp path scores with the fp32 ``assign_ref``.  Seed the
    port's engine from the reference's ``lam``, ``v`` and labels through
    ``MembershipEngine.seed``, which takes numpy."""
    backend = "numpy" if cfg.backend == "numpy" else "torch"
    compute = "fp32" if cfg.backend == "jnp" else cfg.compute_dtype
    return MembershipConfig(
        backend=backend, capacity=cfg.capacity,
        affinity_floor=cfg.affinity_floor, margin_floor=cfg.margin_floor,
        recluster_unassigned_frac=cfg.recluster_unassigned_frac,
        recluster_proto_shift=cfg.recluster_proto_shift,
        eig_floor=cfg.eig_floor, aggregator=cfg.aggregator,
        trim_frac=cfg.trim_frac, mom_groups=cfg.mom_groups,
        drift_stat=cfg.drift_stat, linkage=cfg.linkage,
        compute_dtype=compute, directory_dtype=cfg.directory_dtype)


def _lm_tensor(a, device) -> torch.Tensor:
    """One reference array -> a tensor of the same dtype on ``device``
    (bf16 goes through float32, which holds it exactly)."""
    arr = np.asarray(a)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=getattr(torch, arr.dtype.name))


def lm_params_from_reference(cfg, params: dict,
                             device: str | torch.device = "cuda"
                             ) -> transformer.LM:
    """The reference's decoder parameter tree -> the port's ``LM`` on
    ``device``.  Takes both of the reference's layouts: stacked
    ``groups`` (``scan_layers=True``, each leaf with a leading
    layer-group axis) and the list ``groups_unrolled``; then the
    remainder layers of ``rest``."""
    dev = resolve_device(device)

    def walk(tree, pick=None):
        return {key: walk(val, pick) if isinstance(val, dict)
                else _lm_tensor(val if pick is None else np.asarray(val)[pick],
                                dev)
                for key, val in tree.items()}

    pattern = cfg.block_pattern
    blocks = []
    if "groups" in params:
        for g in range(cfg.n_groups):
            blocks += [walk(params["groups"][str(j)], g)
                       for j in range(len(pattern))]
    else:
        for group in params.get("groups_unrolled", []):
            blocks += [walk(group[str(j)]) for j in range(len(pattern))]
    blocks += [walk(params["rest"][str(j)])
               for j in range(len(cfg.rest_kinds))]
    top = walk({key: params[key] for key in ("embed", "final_norm", "head")})
    return transformer.from_trees(cfg, top, blocks)


def cluster_heads_from_reference(heads, device: str | torch.device = "cuda"
                                 ) -> ClusterHeads:
    """A reference ``ClusterHeads`` -> the port's, fp32 on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return ClusterHeads(head=tensor(heads.head),
                        adapter_a=tensor(heads.adapter_a),
                        adapter_b=tensor(heads.adapter_b))
