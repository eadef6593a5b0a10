"""The port's MT-HFL trainer (``repro_torch.fed.trainer``) against the
reference's ``train_mthfl`` with the reference's draws injected, on the
reference's own parity layouts (T1, T2-ragged, T4-ragged-empty), fused
and loop, with and without dropout, to 1e-5 on accuracy and train loss
(the reference's own fused-against-loop bar); then the port's own keyed
draws on their properties, the API's errors, and the baselines' numpy
copies."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_fed_support import (ReferenceDraws, cnn_to_port, mlp_to_port,
                                port_cnn_models, port_evals, port_mlp_models,
                                ref_cnn_models, ref_mlp_models)
from _torch_support import CPU
from repro.configs import paper_cnn as ref_paper_cnn
from repro.core import clustering as ref_clu
from repro.data import partition as ref_dpart
from repro.data import synthetic as ref_syn
from repro.fed import trainer as ref_trainer
from repro_torch import convert
from repro_torch.configs import paper_cnn
from repro_torch.core import clustering as clu
from repro_torch.fed import trainer as ftrainer
from repro_torch.models import mlp
from test_trainer_parity import (BASE_CFG, LAYOUTS, MCFG, NCLS, M,
                                 make_evals, make_users)

PMCFG = mlp.PaperMLPConfig(m=M, hidden=8, n_classes=NCLS)
CFG = convert.mthfl_config_from_reference(BASE_CFG)


@functools.lru_cache(maxsize=None)
def reference_history(layout_name, fused, dropout):
    layout = LAYOUTS[layout_name]
    users, labels = make_users(layout)
    n = len(layout)
    return ref_trainer.train_mthfl(
        users, labels, ref_mlp_models(MCFG, n), make_evals(n),
        dataclasses.replace(BASE_CFG, dropout_frac=dropout),
        cluster_classes=[list(range(NCLS))] * n, fused=fused)


def port_history(layout, fused, draws="reference", **overrides):
    users, labels = make_users(layout)
    n = len(layout)
    cc = [list(range(NCLS))] * n
    ref_cfg = dataclasses.replace(BASE_CFG, **overrides)
    if draws == "reference":
        draws = ReferenceDraws(users, labels, ref_mlp_models(MCFG, n),
                               ref_cfg, cc, mlp_to_port(MCFG))
    return ftrainer.train_mthfl(
        users, labels, port_mlp_models(PMCFG, n), port_evals(make_evals(n)),
        convert.mthfl_config_from_reference(ref_cfg), cluster_classes=cc,
        fused=fused, draws=draws, device=CPU)


def assert_history_close(a, b, atol=1e-5):
    np.testing.assert_allclose(a.accuracy, b.accuracy, atol=atol)
    np.testing.assert_allclose(a.train_loss, b.train_loss, atol=atol)


class TestReferenceParity:
    @pytest.mark.parametrize("dropout", [0.0, 0.3])
    @pytest.mark.parametrize("fused", [False, True], ids=["loop", "fused"])
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_matches_reference(self, layout, fused, dropout):
        ref = reference_history(layout, fused, dropout)
        port = port_history(LAYOUTS[layout], fused, dropout_frac=dropout)
        assert port.fused == ref.fused == fused
        # NaN where the reference has NaN: empty clusters, and clusters
        # whose every client dropped out in a round.
        assert_history_close(port, ref)
        np.testing.assert_array_equal(port.labels, ref.labels)

    def test_scan_rounds_gives_the_same_history(self):
        layout = LAYOUTS["T4-ragged-empty"]
        plain = port_history(layout, True, dropout_frac=0.3)
        scanned = port_history(layout, True, dropout_frac=0.3,
                               scan_rounds=True)
        np.testing.assert_array_equal(scanned.accuracy, plain.accuracy)
        np.testing.assert_array_equal(scanned.train_loss, plain.train_loss)
        assert_history_close(scanned,
                             reference_history("T4-ragged-empty", True, 0.3))

    def test_nan_masking_of_empty_and_dropped_clusters(self):
        hist = reference_history("T4-ragged-empty", True, 0.3)
        assert np.isnan(hist.accuracy[:, 2]).all()
        dropped = np.isnan(hist.train_loss[:, [0, 1, 3]])
        assert dropped.any()            # the parity above covers this case
        port = port_history(LAYOUTS["T4-ragged-empty"], True,
                            dropout_frac=0.3)
        np.testing.assert_array_equal(np.isnan(port.train_loss),
                                      np.isnan(hist.train_loss))
        assert np.isfinite(port.accuracy[:, [0, 1, 3]]).all()


def test_paper_cnn_two_task_layout_matches_reference():
    """The paper's CIFAR two-task layout at REDUCED width: 4-class and
    6-class heads inferred from each cluster's majority task (so the
    loop runs), one misassigned user training against the wrong head.
    Bar 1e-4: the conv layers' sums run in another order in each package
    (about 1e-7 relative a step), and 2 x 3 momentum steps over 3072
    inputs amplify it; the measured gap is 2.4e-7 on the loss."""
    users = ref_dpart.paper_cifar_two_task(n_per_user=40, seed=0,
                                           users_per_task=(2, 2))
    labels = np.array([0, 0, 1, 0])          # user 3 (task 1) misassigned
    ref_cfg = ref_trainer.MTHFLConfig(
        global_rounds=2, local_rounds=1, local_steps=3, batch_size=8,
        client=ref_trainer.fed_client.ClientConfig(lr=0.01,
                                                   optimizer="momentum"))
    heads = [len(ref_dpart.CIFAR_TASKS[0]), len(ref_dpart.CIFAR_TASKS[1])]
    ref_models = [ref_cnn_models(dataclasses.replace(
        ref_paper_cnn.REDUCED, n_classes=h), 1)[0] for h in heads]
    port_models = [port_cnn_models(dataclasses.replace(
        paper_cnn.REDUCED, n_classes=h), 1)[0] for h in heads]
    evals = []
    for task, classes in ref_dpart.CIFAR_TASKS.items():
        x, y = ref_syn.make_task_dataset(
            ref_syn.CIFAR_LIKE, list(classes), 6, seed=999,
            task_of_class={c: task for c in classes})
        lut = {c: i for i, c in enumerate(classes)}
        evals.append((x, np.asarray([lut[int(v)] for v in y], np.int32)))
    ref = ref_trainer.train_mthfl(users, labels, ref_models, evals, ref_cfg)

    params = iter([cnn_to_port(dataclasses.replace(
        paper_cnn.REDUCED, n_classes=h)) for h in heads])
    draws = ReferenceDraws(users, labels, ref_models, ref_cfg, None,
                           lambda p: next(params)(p))
    port = ftrainer.train_mthfl(
        users, labels, port_models, evals,
        convert.mthfl_config_from_reference(ref_cfg), draws=draws,
        device=CPU)
    assert not ref.fused and not port.fused
    assert_history_close(port, ref, atol=1e-4)
    assert np.isfinite(port.train_loss).all()


class TestKeyedDraws:
    """The port's own draws: keyed by cfg.seed and each cluster's sorted
    member ids, drawn on the host."""

    @pytest.mark.parametrize("fused", [False, True])
    def test_reordering_clusters_permutes_history(self, fused):
        layout = [[40], [25, 33], [30, 8]]
        perm = [2, 0, 1]                       # new index of old cluster t
        users, labels = make_users(layout)
        models = port_mlp_models(PMCFG, 3)
        evals = port_evals(make_evals(3))
        cc = [list(range(NCLS))] * 3
        hist = ftrainer.train_mthfl(users, labels, models, evals, CFG,
                                    cluster_classes=cc, fused=fused,
                                    device=CPU)
        labels2 = np.asarray([perm[l] for l in labels])
        evals2 = [evals[o] for o in np.argsort(perm)]
        hist2 = ftrainer.train_mthfl(users, labels2, models, evals2, CFG,
                                     cluster_classes=cc, fused=fused,
                                     device=CPU)
        np.testing.assert_allclose(hist2.accuracy[:, perm], hist.accuracy,
                                   atol=1e-5)
        np.testing.assert_allclose(hist2.train_loss[:, perm],
                                   hist.train_loss, atol=1e-5)

    def test_same_seed_reproduces_and_other_seed_differs(self):
        layout = LAYOUTS["T2-ragged"]
        a = port_history(layout, True, draws=None)
        b = port_history(layout, True, draws=None)
        np.testing.assert_array_equal(a.train_loss, b.train_loss)
        np.testing.assert_array_equal(a.accuracy, b.accuracy)
        c = port_history(layout, True, draws=None, seed=1)
        assert not np.allclose(a.train_loss, c.train_loss)

    @pytest.mark.parametrize("dropout", [0.0, 0.5])
    def test_fused_equals_loop(self, dropout):
        layout = LAYOUTS["T4-ragged-empty"]
        loop = port_history(layout, False, draws=None, dropout_frac=dropout)
        fus = port_history(layout, True, draws=None, dropout_frac=dropout)
        assert fus.fused and not loop.fused
        assert_history_close(fus, loop)
        np.testing.assert_array_equal(np.isnan(fus.train_loss),
                                      np.isnan(loop.train_loss))
        if dropout:
            assert np.isnan(fus.train_loss[:, [0, 1, 3]]).any()

    def test_rate_zero_is_full_participation(self):
        users, labels = make_users(LAYOUTS["T4-ragged-empty"])
        uids = [[u.user_id for u, l in zip(users, labels) if l == t]
                for t in range(4)]
        draws = ftrainer.KeyedDraws(0, uids, [[40] * len(u) for u in uids],
                                    port_mlp_models(PMCFG, 4), 3, 8)
        for t in (0, 1, 3):
            assert (draws.participation(t, 2, 0.0) == 1.0).all()
            assert draws.batch_indices(t, 1, 0).shape == (len(uids[t]), 3, 8)
        assert draws.participation(2, 0, 0.0).shape == (0,)

    def test_empty_cluster_has_no_gps_weight(self):
        users3, labels3 = make_users([[40, 25], [], [30]])
        evals3 = port_evals(make_evals(3))
        cc = [list(range(NCLS))]
        with_empty = ftrainer.train_mthfl(
            users3, labels3, port_mlp_models(PMCFG, 3), evals3, CFG,
            cluster_classes=cc * 3, fused=True, device=CPU)
        users2, labels2 = make_users([[40, 25], [30]])
        without = ftrainer.train_mthfl(
            users2, labels2, port_mlp_models(PMCFG, 2),
            [evals3[0], evals3[2]], CFG, cluster_classes=cc * 2, fused=True,
            device=CPU)
        assert np.isnan(with_empty.accuracy[:, 1]).all()
        assert_history_close(
            ftrainer.MTHFLHistory(with_empty.accuracy[:, [0, 2]],
                                  with_empty.train_loss[:, [0, 2]],
                                  labels2),
            without)


class TestApi:
    def _hetero(self):
        users, labels = make_users([[40, 25], [30]])
        models = [port_mlp_models(PMCFG, 1)[0], port_mlp_models(
            mlp.PaperMLPConfig(m=M, hidden=8, n_classes=2), 1)[0]]
        evals = [port_evals(make_evals(1, n_classes=4))[0],
                 port_evals(make_evals(1, n_classes=2))[0]]
        return users, labels, models, evals, [[0, 1, 2, 3], [0, 1]]

    def test_fused_true_heterogeneous_raises(self):
        users, labels, models, evals, cc = self._hetero()
        with pytest.raises(ValueError, match="stack"):
            ftrainer.train_mthfl(users, labels, models, evals, CFG,
                                 cluster_classes=cc, fused=True, device=CPU)

    def test_auto_falls_back_heterogeneous(self):
        users, labels, models, evals, cc = self._hetero()
        hist = ftrainer.train_mthfl(users, labels, models, evals, CFG,
                                    cluster_classes=cc, device=CPU)
        assert not hist.fused
        assert np.isfinite(hist.accuracy).all()
        stack = ftrainer.train_mthfl(users, labels, port_mlp_models(PMCFG, 2),
                                     evals[:1] * 2, CFG,
                                     cluster_classes=[cc[0]] * 2, device=CPU)
        assert stack.fused

    @pytest.mark.parametrize("backend,match", [
        ("cuda", "backend must be one of"), ("jnp", "backend must be one of"),
        ("shard_map", None)])
    def test_backends(self, backend, match):
        """Unknown backends raise; ``shard_map`` over a one-rank mesh
        trains the fused path's history."""
        from _torch_dist_support import one_rank_world

        users, labels = make_users(LAYOUTS["T1"])

        def train(backend, mesh=None):
            return ftrainer.train_mthfl(
                users, labels, port_mlp_models(PMCFG, 1),
                port_evals(make_evals(1)),
                dataclasses.replace(CFG, backend=backend), device=CPU,
                mesh=mesh)
        if match is not None:
            with pytest.raises(ValueError, match=match):
                train(backend)
            return
        with one_rank_world("clusters") as mesh:
            sharded = train(backend, mesh)
        plain = train("torch")
        assert sharded.fused and plain.fused
        np.testing.assert_allclose(sharded.train_loss, plain.train_loss,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(sharded.accuracy, plain.accuracy)

    @pytest.mark.parametrize("bad", [1.0, -0.1])
    def test_dropout_validation(self, bad):
        with pytest.raises(ValueError, match="dropout_frac"):
            port_history(LAYOUTS["T1"], False, draws=None, dropout_frac=bad)

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        users, labels = make_users(LAYOUTS["T1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ftrainer.train_mthfl(users, labels, port_mlp_models(PMCFG, 1),
                                 port_evals(make_evals(1)), CFG)

    def test_labels_may_be_a_tensor(self):
        users, labels = make_users(LAYOUTS["T2-ragged"])
        a = ftrainer.train_mthfl(users, labels, port_mlp_models(PMCFG, 2),
                                 port_evals(make_evals(2)), CFG, device=CPU)
        b = ftrainer.train_mthfl(users, torch.from_numpy(labels),
                                 port_mlp_models(PMCFG, 2),
                                 port_evals(make_evals(2)), CFG, device=CPU)
        np.testing.assert_array_equal(a.train_loss, b.train_loss)
        np.testing.assert_array_equal(b.labels, labels)

    def test_config_conversion(self):
        ref = dataclasses.replace(BASE_CFG, backend="shard_map",
                                  dropout_frac=0.2, scan_rounds=True,
                                  mesh_axis="lps")
        port = convert.mthfl_config_from_reference(ref)
        assert port.backend == "shard_map" and port.dropout_frac == 0.2
        assert port.mesh_axis == "lps"
        assert convert.mthfl_config_from_reference(BASE_CFG).mesh_axis == \
            BASE_CFG.mesh_axis == "clusters"
        assert port.client.lr == ref.client.lr and port.scan_rounds
        assert convert.mthfl_config_from_reference(BASE_CFG).backend == \
            "torch"


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_clusters_copy_equals_original(seed):
    np.testing.assert_array_equal(clu.random_clusters(40, 3, rng=seed),
                                  ref_clu.random_clusters(40, 3, rng=seed))
    sizes = [10, 25, 5]
    np.testing.assert_array_equal(
        clu.random_clusters(40, 3, rng=seed, cluster_sizes=sizes),
        ref_clu.random_clusters(40, 3, rng=seed, cluster_sizes=sizes))
    gen, ref_gen = (np.random.default_rng(seed),
                    np.random.default_rng(seed))
    np.testing.assert_array_equal(clu.random_clusters(9, 4, rng=gen),
                                  ref_clu.random_clusters(9, 4, rng=ref_gen))
    for mod in (clu, ref_clu):
        with pytest.raises(ValueError):
            mod.random_clusters(3, 4)
        with pytest.raises(ValueError):
            mod.random_clusters(5, 2, cluster_sizes=[1, 2])


def test_ifca_assign_copy_equals_original():
    losses = np.random.default_rng(3).standard_normal((50, 4))
    losses[7] = losses[7, 0]                   # a tie: first index wins
    got, want = clu.ifca_assign(losses), ref_clu.ifca_assign(losses)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32 and got[7] == 0


def test_infer_cluster_classes_matches_reference_setup():
    """Majority task per cluster, the first seen on a tie, ``range(10)`` for
    an empty cluster: the reference's ``_setup_clusters`` inference."""
    users = ref_dpart.paper_cifar_two_task(n_per_user=20, seed=0,
                                           users_per_task=(3, 3))
    for labels in ([0, 0, 1, 1, 1, 1], [1, 0, 0, 1, 1, 0], [0, 1, 1, 0, 1, 1],
                   [0, 0, 0, 0, 0, 0]):
        labels = np.asarray(labels)
        want = ref_trainer._setup_clusters(users, labels, 3, 0,
                                           None).cluster_classes
        assert ftrainer.infer_cluster_classes(users, labels, 3) == want
