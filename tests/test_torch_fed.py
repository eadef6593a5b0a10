"""The port's federated substrate against the reference: the parameter
partition, FedAvg, the LPS/GPS hierarchy, and the client rounds with the
reference's batches injected (padding and empty clusters included), to
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import CPU, host, t
from repro.fed import client as ref_client
from repro.fed import fedavg as ref_fedavg
from repro.fed import hierarchy as ref_hier
from repro.fed import partition as ref_part
from repro.models import mlp as ref_mlp
from repro_torch import convert
from repro_torch.fed import client, fedavg, hierarchy, partition
from repro_torch.models import mlp

M, NCLS = 12, 4
REF_CFG = ref_mlp.PaperMLPConfig(m=M, hidden=8, n_classes=NCLS)
CFG = mlp.PaperMLPConfig(m=M, hidden=8, n_classes=NCLS)
NAMES = {("fc1", "w"): "fc1.weight", ("fc1", "b"): "fc1.bias",
         ("head", "w"): "head.weight", ("head", "b"): "head.bias"}


def _ref_params(seed=0):
    return ref_mlp.init(REF_CFG, jax.random.PRNGKey(seed))


def _port(ref_params):
    return convert.paper_mlp_params_from_reference(ref_params, REF_CFG,
                                                   device=CPU)


def _assert_params(port, ref_params, tol=1e-5):
    want = _port(ref_params)
    for k, v in want.items():
        err = float((port[k] - v).abs().max())
        assert err <= tol * max(float(v.abs().max()), 1.0), (k, err)


def _data(n_per, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in n_per:
        out.append((rng.standard_normal((n, M)).astype(np.float32),
                    rng.integers(0, NCLS, n).astype(np.int32)))
    return out


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------

FLAT = {"conv1.weight": t(np.ones((2, 2))), "conv1.bias": t(np.zeros(2)),
        "conv10.weight": t(np.ones(3)), "fc.weight": t(np.ones((4, 3))),
        "head.weight": t(np.ones((3, 10))), "head.bias": t(np.zeros(10))}
NESTED = {"conv1": {"weight": jnp.ones((2, 2)), "bias": jnp.zeros(2)},
          "conv10": {"weight": jnp.ones(3)}, "fc": {"weight": jnp.ones((4, 3))},
          "head": {"weight": jnp.ones((3, 10)), "bias": jnp.zeros(10)}}


@pytest.mark.parametrize("prefixes", [
    ["conv1"], ["conv1", "head.weight"], [("head", "bias")], [], ["fc"]])
def test_split_matches_reference_and_round_trips(prefixes):
    pred = partition.prefix_predicate(prefixes)
    ref_pred = ref_part.prefix_predicate(
        [p.replace(".", "/") if isinstance(p, str) else p for p in prefixes])
    common, spec = partition.split_params(FLAT, pred)
    ref_common, ref_spec = ref_part.split_params(NESTED, ref_pred)
    assert sorted(common) == sorted(".".join(p)
                                    for p in ref_part.tree_paths(ref_common))
    assert sorted(spec) == sorted(".".join(p)
                                  for p in ref_part.tree_paths(ref_spec))
    assert len(common) + len(spec) == len(FLAT)
    assert list(partition.merge_params(common, spec)) == list(common) + \
        list(spec)
    assert sorted(partition.merge_params(common, spec)) == sorted(FLAT)
    assert partition.tree_paths(FLAT) == [
        ".".join(p) for p in ref_part.tree_paths(NESTED)]


def test_prefix_is_a_path_not_a_string_prefix():
    pred = partition.prefix_predicate(["conv1"])
    assert pred("conv1") and pred("conv1.weight")
    assert not pred("conv10.weight") and not pred("conv")


def test_merge_rejects_overlap():
    with pytest.raises(ValueError, match="overlapping"):
        partition.merge_params({"a.w": t([1.0])}, {"a.w": t([2.0])})


def test_tree_path_map_keeps_names():
    out = partition.tree_path_map(
        lambda name, v: v * 2 if name.startswith("head") else v, FLAT)
    assert list(out) == list(FLAT)
    assert torch.equal(out["head.weight"], 2 * FLAT["head.weight"])
    assert out["fc.weight"] is FLAT["fc.weight"]


# ---------------------------------------------------------------------------
# FedAvg and the hierarchy
# ---------------------------------------------------------------------------

def _param_sets(k, seed=0):
    return [_ref_params(seed + i) for i in range(k)]


@pytest.mark.parametrize("weights", [[3.0, 1.0, 2.0], [1.0, 1.0, 1.0],
                                     [0.0, 5.0, 1e-3]])
def test_fedavg_and_weighted_mean_match_reference(weights):
    refs = _param_sets(3)
    ports = [_port(p) for p in refs]
    _assert_params(fedavg.weighted_mean(ports, weights),
                   ref_fedavg.weighted_mean(refs, weights))
    counts = [int(w * 10) + 1 for w in weights]
    _assert_params(fedavg.fedavg(ports, counts),
                   ref_fedavg.fedavg(refs, counts))
    _assert_params(hierarchy.lps_round(ports, counts),
                   ref_hier.lps_round(refs, counts))


def test_fedavg_casts_back_to_the_leaf_dtype():
    trees = [{"w": torch.ones(3, dtype=torch.bfloat16)},
             {"w": 3 * torch.ones(3, dtype=torch.bfloat16)}]
    out = fedavg.weighted_mean(trees, [1.0, 1.0])
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].float(), torch.full((3,), 2.0))


@pytest.mark.parametrize("weights", [[40.0, 25.0, 0.0], [1.0, 2.0, 3.0],
                                     [0.0, 0.0, 0.0]])
def test_gps_aggregate_matches_reference_and_stacked(weights):
    refs = _param_sets(3, seed=5)
    ports = [_port(p) for p in refs]
    pred = partition.prefix_predicate(mlp.COMMON_PREFIXES)
    ref_pred = ref_part.prefix_predicate(ref_mlp.COMMON_PREFIXES)
    stacked = hierarchy.gps_aggregate_stacked(
        {k: torch.stack([p[k] for p in ports]) for k in ports[0]}, weights,
        pred)
    ref_stacked = ref_hier.gps_aggregate_stacked(
        jax.tree.map(lambda *ls: jnp.stack(ls), *refs), jnp.asarray(weights),
        ref_pred)
    for i in range(3):
        _assert_params({k: v[i] for k, v in stacked.items()},
                       jax.tree.map(lambda l: l[i], ref_stacked))
    if sum(weights) > 0:
        listed = hierarchy.gps_aggregate(ports, weights, pred)
        ref_listed = ref_hier.gps_aggregate(refs, weights, ref_pred)
        for i in range(3):
            _assert_params(listed[i], ref_listed[i])
            for k in listed[i]:
                assert torch.allclose(listed[i][k], stacked[k][i],
                                      atol=1e-6)
            assert torch.equal(listed[i]["head.weight"],
                               ports[i]["head.weight"])
    else:
        for k, v in stacked.items():
            assert torch.equal(v, torch.stack([p[k] for p in ports]))


def test_masked_cluster_mean_matches_reference():
    rng = np.random.default_rng(3)
    values = {"a": rng.standard_normal((7, 3, 2)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    labels = np.array([0, 2, 2, 0, 0, 2, 2])           # cluster 1 empty
    onehot = np.eye(3, dtype=np.float32)[labels]
    weights = rng.integers(1, 50, 7).astype(np.float32)
    got = hierarchy.masked_cluster_mean({k: t(v) for k, v in values.items()},
                                        t(onehot), t(weights))
    want = ref_hier.masked_cluster_mean(
        {k: jnp.asarray(v) for k, v in values.items()}, jnp.asarray(onehot),
        jnp.asarray(weights))
    for k in values:
        np.testing.assert_allclose(host(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Client rounds, with the reference's batches injected
# ---------------------------------------------------------------------------

OPTS = [client.ClientConfig(lr=0.1),
        client.ClientConfig(lr=0.05, optimizer="momentum"),
        client.ClientConfig(lr=0.01, optimizer="adamw", weight_decay=0.1),
        client.ClientConfig(lr=0.1, clip_norm=0.5)]


def _ref_cfg(cfg):
    return ref_client.ClientConfig(**vars(cfg))


@pytest.mark.parametrize("cfg", OPTS, ids=lambda c: c.optimizer
                         + ("-clip" if c.clip_norm else ""))
def test_local_update_matches_reference(cfg):
    (x, y), = _data([30])
    idx = np.random.default_rng(1).integers(0, 30, (5, 8))
    ref_p = _ref_params(2)
    ref_new, ref_losses = ref_client.local_update(
        ref_p, {"x": jnp.asarray(x[idx]), "y": jnp.asarray(y[idx])},
        ref_mlp.loss_fn(REF_CFG), _ref_cfg(cfg))
    new, losses = client.local_update(
        _port(ref_p), {"x": t(x[idx]), "y": torch.from_numpy(y[idx])},
        mlp.loss_fn(CFG), cfg)
    _assert_params(new, ref_new)
    np.testing.assert_allclose(host(losses), np.asarray(ref_losses),
                               rtol=1e-5)


@pytest.mark.parametrize("cfg", OPTS, ids=lambda c: c.optimizer
                         + ("-clip" if c.clip_norm else ""))
def test_fused_lps_round_matches_reference(cfg):
    data = _data([30, 12, 25])
    rng = np.random.default_rng(4)
    xs = np.stack([x[rng.integers(0, len(y), (4, 8))] for x, y in data])
    rng = np.random.default_rng(4)
    ys = np.stack([y[rng.integers(0, len(y), (4, 8))] for x, y in data])
    weights = [30.0, 12.0, 0.0]                      # a dropped client
    ref_p = _ref_params(3)
    ref_avg, ref_losses = ref_client.fused_lps_round(
        ref_p, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)},
        jnp.asarray(weights), ref_mlp.loss_fn(REF_CFG), _ref_cfg(cfg))
    avg, losses = client.fused_lps_round(
        _port(ref_p), {"x": t(xs), "y": torch.from_numpy(ys)}, weights,
        mlp.loss_fn(CFG), cfg)
    _assert_params(avg, ref_avg)
    np.testing.assert_allclose(host(losses), np.asarray(ref_losses),
                               rtol=1e-5)


def test_batch_stack_gathers_like_keyed_batch_stack():
    data = _data([30, 12])
    key = jax.random.PRNGKey(9)
    ref = ref_client.make_keyed_batch_stack(data, [4, 7], key, 8, 3)
    idx = np.stack([np.asarray(ref_client.sample_batch_indices(
        jax.random.fold_in(key, uid), 3, 8, len(y)))
        for uid, (_, y) in zip([4, 7], data)])
    x = np.zeros((2, 30, M), np.float32)
    y = np.zeros((2, 30), np.int64)
    for c, (xc, yc) in enumerate(data):
        x[c, :len(yc)], y[c, :len(yc)] = xc, yc
    got = client.batch_stack(t(x), torch.from_numpy(y), torch.from_numpy(idx))
    np.testing.assert_array_equal(host(got["x"]), np.asarray(ref["x"]))
    np.testing.assert_array_equal(host(got["y"]), np.asarray(ref["y"]))


@pytest.mark.parametrize("cfg", OPTS[:2] + OPTS[3:], ids=lambda c:
                         c.optimizer + ("-clip" if c.clip_norm else ""))
def test_masked_lps_round_matches_reference(cfg):
    """Three clusters padded to C_max = 3: a full one, a ragged one with
    a dropped client, and an empty one (all-masked: params unchanged, NaN
    loss).  The reference runs one cluster a call; the port all three."""
    sizes = [[30, 12, 25], [20], []]
    masks = [[1, 1, 1], [1, 0, 0], [0, 0, 0]]
    steps, batch, c_max, n_max = 3, 8, 3, 30
    x = np.zeros((3, c_max, n_max, M), np.float32)
    y = np.zeros((3, c_max, n_max), np.int32)
    n_per = np.ones((3, c_max), np.float32)
    uids = np.zeros((3, c_max), np.int32)
    uid = 0
    for tt, ns in enumerate(sizes):
        for c, (xc, yc) in enumerate(_data(ns, seed=tt)):
            x[tt, c, :len(yc)], y[tt, c, :len(yc)] = xc, yc
            n_per[tt, c] = len(yc)
            uids[tt, c] = uid
            uid += 1
    if sizes[1]:
        n_per[1, 1] = 30.0     # a dropped slot with data weight left in
    mask = np.asarray(masks, np.float32)
    keys = [jax.random.PRNGKey(20 + tt) for tt in range(3)]
    refs = [_ref_params(tt) for tt in range(3)]
    opt = ref_client._make_opt(_ref_cfg(cfg))
    idx = np.zeros((3, c_max, steps, batch), np.int64)
    ref_out, ref_loss = [], []
    for tt in range(3):
        avg, loss = ref_client.masked_lps_round(
            refs[tt], jnp.asarray(x[tt]), jnp.asarray(y[tt]),
            jnp.asarray(n_per[tt]), jnp.asarray(uids[tt]),
            jnp.asarray(mask[tt]), keys[tt], ref_mlp.loss_fn(REF_CFG), opt,
            cfg.clip_norm, steps, batch)
        ref_out.append(avg)
        ref_loss.append(float(loss))
        for c in range(c_max):
            idx[tt, c] = np.asarray(ref_client.sample_batch_indices(
                jax.random.fold_in(keys[tt], int(uids[tt, c])), steps, batch,
                int(n_per[tt, c])))
    ports = [_port(p) for p in refs]
    stack = {k: torch.stack([p[k] for p in ports]) for k in ports[0]}
    new, loss = client.masked_lps_round(
        stack, t(x), torch.from_numpy(y).long(), t(n_per), t(mask),
        torch.from_numpy(idx), mlp.loss_fn(CFG), client.make_optimizer(cfg),
        cfg.clip_norm)
    for tt in range(3):
        _assert_params({k: v[tt] for k, v in new.items()}, ref_out[tt])
    assert np.isnan(ref_loss[2]) and np.isnan(float(loss[2]))
    np.testing.assert_allclose(host(loss)[:2], ref_loss[:2], rtol=1e-5)
    for k in stack:                       # the empty cluster kept its own
        assert torch.equal(new[k][2], stack[k][2])


def test_keyed_draws_are_keyed():
    a = client.sample_batch_indices(client.keyed_stream(1, 2, 3), 4, 8, 10)
    b = client.sample_batch_indices(client.keyed_stream(1, 2, 3), 4, 8, 10)
    c = client.sample_batch_indices(client.keyed_stream(1, 2, 4), 4, 8, 10)
    assert a.shape == (4, 8) and a.min() >= 0 and a.max() < 10
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    uids = np.array([5, 9, 2, 77])
    full = client.participation_mask((3, 1), uids, 0.0)
    assert (full == 1.0).all() and full.dtype == np.float32
    half = client.participation_mask((3, 1), uids, 0.5)
    perm = np.array([2, 0, 3, 1])
    np.testing.assert_array_equal(
        client.participation_mask((3, 1), uids[perm], 0.5), half[perm])


def test_numpy_batch_helpers_draw_like_reference():
    """``make_batches`` and ``make_batch_stack`` make the reference's numpy
    calls in its order, so a shared seed gives the same batches."""
    data = _data([30, 5, 12], seed=6)
    got = client.make_batch_stack(
        [(t(x), torch.from_numpy(y)) for x, y in data], 8, 3,
        np.random.default_rng(2))
    want = ref_client.make_batch_stack(data, 8, 3, np.random.default_rng(2))
    np.testing.assert_array_equal(host(got["x"]), np.asarray(want["x"]))
    np.testing.assert_array_equal(host(got["y"]), np.asarray(want["y"]))
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    for x, y in data:                     # n = 5 < batch: 5-wide batches
        got = client.make_batches(t(x), torch.from_numpy(y), 8, 4, rng)
        want = ref_client.make_batches(x, y, 8, 4, ref_rng)
        np.testing.assert_array_equal(host(got["x"]), np.asarray(want["x"]))
        np.testing.assert_array_equal(host(got["y"]), np.asarray(want["y"]))
