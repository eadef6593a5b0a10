"""The port's sharded paths over ``torch.distributed`` against the JAX
package's single-device and ``shard_map`` results.

One spawn of four gloo ranks on the CPU runs every sharded path
(``_torch_dist_support.suite``); this process computes the references
and checks what each rank returned.  The reference runs its sharded
paths on forced host devices in one process; the port runs them SPMD,
one process a rank.

Tolerances:
  * the protocol on ``tests/test_engine.py``'s inputs: R at W = 4 within
    1e-6 of the port's own dense R (the two do the same sums a user, and
    give the same bits here); against
    the reference's dense R within 1e-5 at top_k 2 and 1e-4 at top_k 6,
    where the port's dense path itself is 3.2e-5 apart (noise-floor
    eigenvectors past d // 8, ROADMAP Queue 3); labels the same partition
    as the reference's and equal on every rank;
  * the raw ingest: R within 1e-5 x max of the reference's ``run_raw``,
    residuals within 1e-6 (relative) of the single-process ones;
  * ``assign_sharded`` (T = 4 over W = 4): labels equal to the
    reference's ``assign``, affinity and margin within 1e-5;
  * the trainer (the reference's draws injected): histories and final
    parameters within 1e-5 of the JAX fused trainer, within 1e-6 of the
    port's single-process fused path.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_support import (CPU, RecordedDraws, one_rank_world,
                                 port_mlp_models, recording, suite,
                                 train_port)
from _torch_fed_support import ReferenceDraws, mlp_to_port, ref_mlp_models
from repro.core import clustering as ref_clu
from repro.core import oneshot as ref_oneshot
from repro.core import similarity as ref_sim
from repro.core.engine import ProtocolEngine as RefProtocolEngine
from repro.core.membership_engine import (MembershipConfig as RefConfig,
                                          MembershipEngine as RefEngine)
from repro.core.signature_engine import SignatureConfig as RefSigConfig
from repro.data import features as ref_feat
from repro.data import synthetic as ref_syn
from repro.fed import trainer as ref_trainer
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core import distributed as mdist
from repro_torch.core import signature_engine as sig
from repro_torch.core import similarity as sim
from repro_torch.core.engine import ProtocolEngine
from repro_torch.core.membership_engine import (MembershipConfig,
                                                MembershipEngine)
from repro_torch.data import features as feat
from repro_torch.data.partition import UserData
from repro_torch.models import mlp
from test_trainer_parity import (BASE_CFG, LAYOUTS, MCFG, NCLS, M,
                                 make_evals, make_users)

W = 4
RAW_FC = dict(kind="random_projection", d=32)
RAW_SIG = dict(chunk_rows=16, check=True)
PMCFG = mlp.PaperMLPConfig(m=M, hidden=8, n_classes=NCLS)
#: Trainer layouts: ragged clusters padded to W, and an empty cluster.
TRAINER = {"T2-ragged": 0.0, "T4-ragged-empty": 0.3}


def _protocol_inputs():
    return ref_syn.make_task_feature_mixture(24, 48, 16, 3, seed=7)


def _fed_inputs():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 64, 16)).astype(np.float32)


def _raw_inputs():
    return ref_syn.make_task_feature_mixture(24, 48, 96, 3, seed=7)[0]


def _directory():
    """The reference's seed directory (T = 4) and its verdict on its own
    seed users as one wave."""
    feats, _ = ref_syn.make_task_feature_mixture(32, 48, 16, 4, seed=7)
    res = ref_oneshot.one_shot_clustering(
        jnp.asarray(feats), 4, cfg=ref_sim.SimilarityConfig(top_k=6))
    lam, v, labels = (np.asarray(res.lam), np.asarray(res.v),
                      np.asarray(res.labels))
    ref = RefEngine.from_oneshot(res, RefConfig(backend="jnp"))
    out = ref.assign(res.lam, res.v)
    return (lam, v, labels), {k: np.asarray(getattr(out, k))
                              for k in ("labels", "affinity", "margin")}


def _trainer_case(layout_name, dropout):
    """One trainer layout: the ranks' inputs (port users, the reference's
    draws recorded) and the JAX fused run's history and final params."""
    layout = LAYOUTS[layout_name]
    users, labels = make_users(layout)
    n = len(layout)
    cc = [list(range(NCLS))] * n
    ref_cfg = dataclasses.replace(BASE_CFG, dropout_frac=dropout)
    cfg = convert.mthfl_config_from_reference(ref_cfg)
    seen = {}
    ref = ref_trainer.train_mthfl(
        users, labels, recording(ref_mlp_models(MCFG, n), seen),
        make_evals(n), ref_cfg, cluster_classes=cc, fused=True)
    to_port = mlp_to_port(MCFG)
    ref_params = {t: {k: v.numpy() for k, v in to_port(p).items()}
                  for t, p in seen.items()}
    draws = ReferenceDraws(users, labels, ref_mlp_models(MCFG, n), ref_cfg,
                           cc, to_port)
    case = dict(
        users=[UserData(user_id=u.user_id, task_id=u.task_id, x=u.x, y=u.y,
                        task_classes=u.task_classes) for u in users],
        labels=labels, mcfg=PMCFG, n=n, classes=cc, cfg=cfg,
        evals=[(np.asarray(x), np.asarray(y)) for x, y in make_evals(n)],
        draws=RecordedDraws(draws, [len(c) for c in layout], cfg))
    return case, (ref.accuracy, ref.train_loss, ref_params)


def _cluster_mean_inputs():
    """Per-user values (U = 8, sharded over the ranks), a membership with
    an empty cluster, and sample counts."""
    rng = np.random.default_rng(3)
    labels = np.array([0, 2, 0, 2, 2, 0, 0, 2])          # cluster 1 empty
    values = {"w": rng.standard_normal((8, 3, 5)).astype(np.float32),
              "b": rng.standard_normal((8, 5)).astype(np.float32)}
    onehot = np.eye(3, dtype=np.float32)[labels]
    weights = rng.integers(1, 50, 8).astype(np.float32)
    return values, onehot, weights


@pytest.fixture(scope="module")
def inputs():
    cases = {name: _trainer_case(name, rate)
             for name, rate in TRAINER.items()}
    directory, assign_ref = _directory()
    return dict(
        protocol=_protocol_inputs()[0], fed=_fed_inputs(), raw=_raw_inputs(),
        raw_feature=feat.FeatureConfig(**RAW_FC), directory=directory,
        cluster_mean=_cluster_mean_inputs(),
        trainer={k: c for k, (c, _) in cases.items()},
        _assign_ref=assign_ref,
        _trainer_ref={k: r for k, (_, r) in cases.items()})


@pytest.fixture(scope="module")
def ranks(inputs):
    """What every rank of one four-rank gloo run returned."""
    sent = {k: v for k, v in inputs.items() if not k.startswith("_")}
    return mdist.run_ranks(suite, W, "cpu", args=(sent,), timeout=300)


def _ref_dense(top_k):
    feats, _ = _protocol_inputs()
    return np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
        top_k=top_k)).similarity(jnp.asarray(feats)))


@pytest.mark.parametrize("top_k,tol", [(2, 1e-5), (6, 1e-4)])
def test_protocol_matches_reference(ranks, top_k, tol):
    feats, _ = _protocol_inputs()
    dense = ProtocolEngine(sim.SimilarityConfig(top_k=top_k), device=CPU
                           ).run(feats)
    ref_r = _ref_dense(top_k)
    for out in ranks:
        got = out["protocol"][top_k]
        for k in ("similarity", "relevance", "lam"):
            np.testing.assert_allclose(got[k], getattr(dense, k).numpy(),
                                       rtol=0, atol=1e-6)
        assert got["v"].shape == (24, 16, top_k)
        np.testing.assert_allclose(got["similarity"], ref_r, rtol=0,
                                   atol=tol)
        assert clu.adjusted_rand_index(
            clu.hac_clusters(got["similarity"], 3),
            ref_clu.hac_clusters(ref_r, 3)) == 1.0


def test_labels_equal_on_every_rank(ranks):
    _, task_ids = _protocol_inputs()
    first = ranks[0]["labels"]
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["labels"], first)
    assert clu.adjusted_rand_index(
        first, ref_clu.hac_clusters(_ref_dense(6), 3)) == 1.0
    assert clu.clustering_accuracy(first, task_ids) == 1.0


def test_indivisible_users_raise_the_reference_message(ranks):
    for out in ranks:
        assert out["indivisible"] == ("n_users=22 not divisible by mesh "
                                      "axis 'data' of size 4")


def test_distributed_similarity_matches_reference(ranks):
    feats = _fed_inputs()
    ref_r = np.asarray(ref_sim.similarity_matrix(
        jnp.asarray(feats), ref_sim.SimilarityConfig(top_k=8)))
    for out in ranks:
        np.testing.assert_allclose(out["distributed_similarity"], ref_r,
                                   rtol=0, atol=1e-5)


def test_raw_ingest_matches_reference(ranks):
    raw = _raw_inputs()
    ref = np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
        top_k=6)).similarity_from_raw(
        raw, ref_feat.FeatureConfig(**RAW_FC),
        signature_cfg=RefSigConfig(**RAW_SIG)))
    for out in ranks:
        np.testing.assert_allclose(out["raw"], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        np.testing.assert_array_equal(out["raw"], ranks[0]["raw"])


def test_raw_ingest_gathers_the_residuals(ranks):
    """Under ``check`` every rank holds every user's residual: the
    single-process ingest's."""
    eng = sig.SignatureEngine(feat.FeatureConfig(**RAW_FC),
                              sig.SignatureConfig(**RAW_SIG), device=CPU)
    grams = eng.grams(_raw_inputs())
    lam, v = eng.spectrum(grams, 6)
    want = sig.subspace_residual(grams, lam, v).numpy()
    for out in ranks:
        assert out["raw_resid"].shape == (24,)
        np.testing.assert_allclose(out["raw_resid"], want, rtol=1e-6,
                                   atol=0)
        assert "did not converge" in out["raw_unconverged"]


def test_assign_sharded_matches_reference(inputs, ranks):
    want = inputs["_assign_ref"]
    for out in ranks:
        got = out["assign"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["affinity"], want["affinity"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["margin"], want["margin"], rtol=0,
                                   atol=1e-5)
        assert out["assign_indivisible"] == (
            "n_clusters=3 not divisible by mesh axis 'data' of size 4")


def test_masked_cluster_mean_over_sharded_users(ranks):
    """Each rank holds 2 of the 8 users; the group's all_reduce gives
    every rank the reference's single-host means."""
    from repro.fed import hierarchy as ref_hier

    values, onehot, weights = _cluster_mean_inputs()
    want = ref_hier.masked_cluster_mean(
        {k: jnp.asarray(v) for k, v in values.items()}, jnp.asarray(onehot),
        jnp.asarray(weights))
    for out in ranks:
        for k in values:
            np.testing.assert_allclose(out["cluster_mean"][k],
                                       np.asarray(want[k]), rtol=0,
                                       atol=1e-6)
        assert not out["cluster_mean"]["b"][1].any()     # the empty one


@pytest.mark.parametrize("layout", list(TRAINER))
def test_trainer_matches_reference(inputs, ranks, layout):
    acc_ref, loss_ref, params_ref = inputs["_trainer_ref"][layout]
    for out in ranks:
        acc, loss, params = out["trainer"][layout]
        np.testing.assert_allclose(acc, acc_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(loss, loss_ref, rtol=0, atol=1e-5)
        assert params.keys() == params_ref.keys()
        for t in params:
            for k in params[t]:
                np.testing.assert_allclose(params[t][k], params_ref[t][k],
                                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", list(TRAINER))
def test_trainer_matches_single_process(inputs, ranks, layout):
    case = inputs["trainer"][layout]
    hist, params = train_port(case, case["cfg"])
    assert hist.fused
    for out in ranks:
        acc, loss, got = out["trainer"][layout]
        np.testing.assert_allclose(acc, hist.accuracy, rtol=0, atol=1e-6)
        np.testing.assert_allclose(loss, hist.train_loss, rtol=0,
                                   atol=1e-6)
        for t in params:
            for k in params[t]:
                np.testing.assert_allclose(got[t][k], params[t][k], rtol=0,
                                           atol=1e-6)


def test_single_rank_matches_reference():
    """W = 1 in this process: the collectives copy, R is the dense R."""
    feats, _ = _protocol_inputs()
    with one_rank_world() as mesh:
        r = ProtocolEngine(sim.SimilarityConfig(top_k=2, backend="shard_map"),
                           mesh=mesh, device=CPU).similarity(feats)
    np.testing.assert_allclose(r.numpy(), _ref_dense(2), rtol=0, atol=1e-5)
    assert not dist.is_initialized()


def test_make_user_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mdist.make_user_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProtocolEngine(sim.SimilarityConfig(backend="shard_map"),
                       device=CPU).similarity(_fed_inputs())
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend,device,match", [
    ("nccl", "cpu", "needs a gloo process group"),
    ("gloo", "cuda", "needs a nccl process group")])
def test_backend_must_match_device(backend, device, match):
    with pytest.raises(ValueError, match=match):
        mdist.check_backend(backend, torch.device(device))


def test_mesh_must_match_device_and_axis():
    mesh = types.SimpleNamespace(device_type="cuda",
                                 mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="over 'cuda' devices"):
        mdist.axis_group(mesh, "data", CPU)
    with pytest.raises(ValueError, match="no axis 'users'"):
        mdist.axis_group(mesh, "users", CPU)


def test_assign_sharded_needs_a_device_backend(inputs):
    lam, v, labels = inputs["directory"]
    eng = MembershipEngine(MembershipConfig(backend="numpy"), device=CPU)
    eng.seed(lam, v, labels, n_clusters=4)
    with pytest.raises(ValueError, match="device backend"):
        eng.assign_sharded(lam, v)


def test_launcher_shard_map_on_four_ranks(capfd):
    from repro_torch.launch import protocol

    acc = protocol.main(["--device", "cpu", "--backend", "shard_map",
                         "--devices", "4"])
    out = capfd.readouterr().out
    assert acc == 1.0
    assert "clustering accuracy 100.0%" in out
    assert "devices=4" in out and "GPS total" in out
    assert out.count("clustering accuracy") == 1        # rank 0 prints
