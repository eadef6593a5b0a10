"""Shared helpers for the port's LM tests: the same architecture built
in both packages, the reference's weights carried into the port, and
the reference's decode state laid out as the port's per-layer list."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import get_arch as ref_get_arch
from repro.launch.decode_loop import ClusterHeads as RefClusterHeads
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.convert import (cluster_heads_from_reference,
                                 encdec_params_from_reference,
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
    """Both bundles (decoder-only or encoder-decoder) on the reference's
    random weights (``PRNGKey(0)``; the
    serving heads from ``PRNGKey(1)``, as the reference's serve tests):
    ``(ref_model, ref_params, ref_heads, model, params, heads)``."""
    ref_cfg, cfg = arch_pair(arch, **kw)
    ref_m = ref_get_model(ref_cfg)
    ref_params = ref_m.init(jax.random.PRNGKey(0))
    m = get_model(cfg)
    convert = encdec_params_from_reference if cfg.encoder_layers \
        else lm_params_from_reference
    params = convert(cfg, ref_params, device="cpu")
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


def ref_routing(params, cfg, x):
    """The reference's routing of ``x (B, S, d)`` by its own expressions
    (``src/repro/models/moe.py:74-95``): expert ids ``(T, k)`` from
    ``jax.lax.top_k`` and the kept picks ``(T, k)``."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax((x.reshape(t, d) @ params["router"]).astype(
        jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    tc = min(cfg.dispatch_chunk, t)
    if t % tc:
        tc = t
    g = t // tc
    capacity = min(max(1, int(cfg.capacity_factor * k * tc / e)), tc)
    sel = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(g, tc * k, e)
    pos = (jnp.cumsum(sel, axis=1) * sel - 1).reshape(t, k, e)
    keep = jnp.any((pos >= 0) & (pos < capacity), axis=-1)
    return gate_idx, keep


def record_port_routes(monkeypatch) -> list:
    """Patch the port's ``moe.dispatch_slots`` so that every call appends
    ``{"idx": (T, k) expert ids, "keep": (T, k) kept picks}`` to the list
    returned, in call order."""
    from repro_torch.models import moe

    log = []
    orig = moe.dispatch_slots

    def recorded(gate_idx, cfg, t):
        pos, keep = orig(gate_idx, cfg, t)
        log.append({"idx": gate_idx, "keep": keep})
        return pos, keep

    monkeypatch.setattr(moe, "dispatch_slots", recorded)
    return log


def record_ref_routes(monkeypatch) -> list:
    """Patch the reference's ``moe_apply`` so that every call, inside its
    layer scan too, appends ``(ids, kept)`` as numpy arrays to the list
    returned (a ``jax.debug.callback``, in call order)."""
    from repro.models import moe as ref_moe

    log = []
    orig = ref_moe.moe_apply

    def recorded(params, cfg, x):
        idx, keep = ref_routing(params, cfg, x)
        jax.debug.callback(lambda i, k: log.append((np.asarray(i),
                                                    np.asarray(k))),
                           idx, keep, ordered=True)
        return orig(params, cfg, x)

    monkeypatch.setattr(ref_moe, "moe_apply", recorded)
    return log
