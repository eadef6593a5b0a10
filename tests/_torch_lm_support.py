"""Shared helpers for the port's LM tests: the same architecture built
in both packages, the reference's weights carried into the port, and
the reference's decode state laid out as the port's per-layer list."""
import dataclasses

import jax
import numpy as np

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import get_arch as ref_get_arch
from repro.launch.decode_loop import ClusterHeads as RefClusterHeads
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.convert import (cluster_heads_from_reference,
                                 lm_params_from_reference)
from repro_torch.models.registry import get_model

TINY = dict(arch_type="dense", d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=97, head_dim=16,
            param_dtype="float32", act_dtype="float32", scan_layers=False)


def arch_pair(arch: str, **kw):
    """``(reference cfg, port cfg)``: a REDUCED config by id, or a
    ``tiny-<kind>`` config (the reference's serving-test architecture,
    unrolled layer groups), with ``kw`` replaced in both."""
    if arch.startswith("tiny-"):
        kind = arch.split("-", 1)[1]
        base = dict(TINY, name=f"tiny_{kind}", block_pattern=(kind,))
        base.update(kw)
        return RefArchConfig(**base), ArchConfig(**base)
    return (dataclasses.replace(ref_get_arch(arch, reduced=True), **kw),
            dataclasses.replace(get_arch(arch, reduced=True), **kw))


def build_pair(arch: str, n_clusters: int = 0, **kw):
    """Both bundles on the reference's random weights (``PRNGKey(0)``; the
    serving heads from ``PRNGKey(1)``, as the reference's serve tests):
    ``(ref_model, ref_params, ref_heads, model, params, heads)``."""
    ref_cfg, cfg = arch_pair(arch, **kw)
    ref_m = ref_get_model(ref_cfg)
    ref_params = ref_m.init(jax.random.PRNGKey(0))
    m = get_model(cfg)
    params = lm_params_from_reference(cfg, ref_params, device="cpu")
    ref_heads = heads = None
    if n_clusters:
        ref_heads = RefClusterHeads.init(jax.random.PRNGKey(1),
                                         ref_params["head"], n_clusters)
        heads = cluster_heads_from_reference(ref_heads, device="cpu")
    return ref_m, ref_params, ref_heads, m, params, heads


def ref_layer_states(cfg, state) -> list[dict]:
    """The reference's decode state (stacked ``groups`` or
    ``groups_unrolled``, then ``rest``) as one dict of numpy arrays per
    layer, in layer order."""
    pattern = cfg.block_pattern
    layers = []
    if "groups" in state:
        for g in range(cfg.n_groups):
            layers += [jax.tree.map(lambda a: np.asarray(a)[g],
                                    state["groups"][str(j)])
                       for j in range(len(pattern))]
    for group in state.get("groups_unrolled", []):
        layers += [jax.tree.map(np.asarray, group[str(j)])
                   for j in range(len(pattern))]
    layers += [jax.tree.map(np.asarray, state["rest"][str(j)])
               for j in range(len(cfg.rest_kinds))]
    return layers


def rel_err(got, want) -> float:
    """``max|got - want| / max|want|`` in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / scale
