"""The port's Algorithm 2 end to end, against the JAX package.

``one_shot_clustering(device="cpu")`` runs the whole slice with the
kernels' plain versions; labels must reach 100% accuracy and be the
reference's partition, for both decision layers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import host, same_partition
from repro.core import oneshot as ref_oneshot
from repro.core import similarity as ref_sim
from repro.core.cluster_engine import ClusterConfig as RefClusterConfig
from repro.data import synthetic as ref_syn
from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core.cluster_engine import ClusterConfig, DeviceDendrogram
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.launch import protocol


@pytest.fixture(scope="module")
def mixture():
    return ref_syn.make_task_feature_mixture(32, 40, 24, 4, seed=5)


@pytest.fixture(scope="module")
def reference(mixture):
    feats, _ = mixture
    return ref_oneshot.one_shot_clustering(
        jnp.asarray(feats), 4, cfg=ref_sim.SimilarityConfig(top_k=3),
        cluster_cfg=RefClusterConfig(backend="jnp"))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("linkage", ["average", "single", "complete"])
def test_labels_match_reference(mixture, reference, backend, linkage):
    feats, task_ids = mixture
    res = oneshot.one_shot_clustering(
        feats, 4, cfg=SimilarityConfig(top_k=3),
        cluster_cfg=ClusterConfig(backend=backend, linkage=linkage),
        device="cpu")
    assert clu.clustering_accuracy(host(res.labels), task_ids) == 1.0
    assert same_partition(res.labels, reference.labels)
    np.testing.assert_allclose(host(res.similarity),
                               np.asarray(reference.similarity), atol=1e-4)
    if backend == "torch":
        assert isinstance(res.labels, torch.Tensor)
        assert isinstance(res.dendrogram, DeviceDendrogram)
    else:
        assert isinstance(res.labels, np.ndarray)
        assert isinstance(res.similarity, np.ndarray)


def test_result_fields_and_ledger(mixture, reference):
    feats, _ = mixture
    res = oneshot.one_shot_clustering(feats, 4, cfg=SimilarityConfig(top_k=3),
                                      model_params=1000, device="cpu")
    assert res.lam.shape == (32, 3) and res.v.shape == (32, 24, 3)
    assert res.relevance.shape == (32, 32)
    ref = ref_oneshot.CommLedger(n_users=32, d=24, top_k=3,
                                 model_params=1000)
    assert res.ledger.summary() == ref.summary()


def test_ragged_list_input(mixture):
    feats, task_ids = mixture
    ragged = [f[: 20 + (i % 7)] for i, f in enumerate(feats)]
    res = oneshot.one_shot_clustering(ragged, 4, cfg=SimilarityConfig(top_k=3),
                                      device="cpu")
    assert clu.clustering_accuracy(res.labels, task_ids) == 1.0


def test_default_decision_layer_is_the_device_nn_chain(mixture, reference,
                                                       capsys):
    feats, task_ids = mixture
    assert ClusterConfig().backend == "torch"
    res = oneshot.one_shot_clustering(feats, 4, cfg=SimilarityConfig(top_k=3),
                                      device="cpu")
    assert isinstance(res.dendrogram, DeviceDendrogram)
    assert isinstance(res.labels, torch.Tensor)
    assert same_partition(res.labels, reference.labels)
    protocol.main(["--device", "cpu", "--users", "24", "--samples", "32",
                   "--dim", "16", "--tasks", "3", "--top-k", "2"])
    assert "cluster_backend=torch" in capsys.readouterr().out


@pytest.mark.parametrize("cluster_backend", ["numpy", "torch"])
def test_launcher_prints_reference_lines(capsys, cluster_backend):
    acc = protocol.main(["--device", "cpu", "--users", "24", "--samples",
                         "32", "--dim", "16", "--tasks", "3", "--top-k", "2",
                         "--cluster-backend", cluster_backend])
    out = capsys.readouterr().out
    assert acc == 1.0
    assert "clustering accuracy 100.0%" in out
    assert "per-user upload" in out and "GPS total" in out


@pytest.mark.parametrize("flags", [
    ["--block-users", "8"],
    ["--raw-dim", "48", "--dim", "16", "--chunk-rows", "12"],
    ["--raw-dim", "24", "--feature", "identity", "--eig", "eigh"],
])
def test_launcher_raw_and_blockwise_modes(capsys, flags):
    acc = protocol.main(["--device", "cpu", "--users", "24", "--samples",
                         "32", "--dim", "16", "--tasks", "3", "--top-k", "2",
                         *flags])
    out = capsys.readouterr().out
    assert acc == 1.0
    assert "clustering accuracy 100.0%" in out
    if "--raw-dim" in flags:
        assert "raw=True" in out and "m=" in out
    else:
        assert "block_users=8" in out


def test_raw_entry_point_matches_reference(mixture):
    """``feature_cfg`` turns the features into raw shards: labels and the
    ledger equal the reference's raw entry point."""
    from repro.core.signature_engine import SignatureConfig as RefSigConfig
    from repro.data.features import FeatureConfig as RefFeatureConfig
    from repro_torch.core.signature_engine import SignatureConfig
    from repro_torch.data.features import FeatureConfig

    feats, task_ids = mixture
    res = oneshot.one_shot_clustering(
        feats, 4, cfg=SimilarityConfig(top_k=3),
        feature_cfg=FeatureConfig(kind="random_projection", d=12),
        signature_cfg=SignatureConfig(chunk_rows=16), device="cpu")
    ref = ref_oneshot.one_shot_clustering(
        feats, 4, cfg=ref_sim.SimilarityConfig(top_k=3),
        feature_cfg=RefFeatureConfig(kind="random_projection", d=12),
        signature_cfg=RefSigConfig(chunk_rows=16))
    assert clu.clustering_accuracy(host(res.labels), task_ids) == 1.0
    assert same_partition(res.labels, ref.labels)
    np.testing.assert_allclose(host(res.similarity),
                               np.asarray(ref.similarity), atol=1e-5)
    assert res.ledger.summary() == ref.ledger.summary()


@pytest.mark.parametrize("bad", ["single", 2.5, None])
def test_linkage_in_reference_position_names_cluster_cfg(mixture, bad):
    """The reference's fourth positional argument is the linkage; the
    port's is ``model_params``, which must be an integer, and the error
    says where the linkage goes."""
    feats, _ = mixture
    with pytest.raises(TypeError, match=r"cluster_cfg=ClusterConfig\("
                       r"linkage=\.\.\.\)"):
        oneshot.one_shot_clustering(feats, 4, SimilarityConfig(top_k=3),
                                    bad, device="cpu")
    res = oneshot.one_shot_clustering(feats, 4, SimilarityConfig(top_k=3),
                                      np.int64(1000), device="cpu")
    assert res.ledger.model_params == 1000
