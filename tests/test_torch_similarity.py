"""The port's protocol (Eqs. 1-5) against the JAX ``ProtocolEngine``.

Same numpy mixtures on both sides; the JAX side runs its Pallas backend
in interpret mode.  Each side runs its own ``eigh``, so eigenvectors are
compared only through sign-free quantities: spectra, projectors
``V V^T``, R and labels up to permutation.

Tolerances:
  * R end to end: atol 1e-4.  When ``top_k`` exceeds the task rank
    ``d // 8``, some shared eigenvectors lie in the noise floor, where
    ``G_i v`` cancels in fp32; independent ``eigh`` on the two sides then
    moves R by up to 3.7e-5 (worst of 16 mixtures).  With
    ``top_k <= d // 8`` the gap is below 5e-7.
  * R from the reference's own signatures (``convert.py``): atol 1e-5,
    the reference's own backend-parity bar.
  * spectra: atol 1e-5 of the largest eigenvalue; projectors: atol 1e-4,
    on a mixture whose top-k subspace is separated by a wide gap.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import CPU, host, same_partition, t
from repro.core import clustering as ref_clu
from repro.core import similarity as ref_sim
from repro.core.engine import ProtocolEngine as RefProtocolEngine
from repro.data import synthetic as ref_syn
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core import similarity as sim
from repro_torch.core.engine import ProtocolEngine


def mixture(n_users, n, d, tasks, seed):
    return ref_syn.make_task_feature_mixture(n_users, n, d, tasks, seed=seed)


def port_engine(top_k, **kw):
    return ProtocolEngine(sim.SimilarityConfig(top_k=top_k, **kw),
                          device="cpu")


@pytest.mark.parametrize("n_users,n,d,tasks,top_k,seed", [
    (24, 48, 16, 3, 6, 7),     # top_k > d // 8: noise-floor eigenvectors
    (16, 40, 32, 4, 4, 1),     # top_k == d // 8
    (20, 30, 40, 2, 3, 11),    # top_k < d // 8
])
def test_similarity_matches_pallas_engine(n_users, n, d, tasks, top_k, seed):
    feats, task_ids = mixture(n_users, n, d, tasks, seed)
    ref_r = np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
        top_k=top_k, backend="pallas")).similarity(jnp.asarray(feats)))
    r, big_r = port_engine(top_k).relevance_and_similarity(t(feats))
    np.testing.assert_allclose(host(big_r), ref_r, atol=1e-4)
    np.testing.assert_array_equal(host(big_r), host(big_r).T)
    labels = clu.hac_clusters(host(big_r), tasks)
    assert same_partition(labels, ref_clu.hac_clusters(ref_r, tasks))
    assert clu.clustering_accuracy(labels, task_ids) == 1.0


def test_ragged_users_match_reference():
    rng = np.random.default_rng(4)
    feats, _ = mixture(12, 40, 16, 3, 4)
    ragged = [f[: rng.integers(5, 40)] for f in feats]
    ref_r = np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
        top_k=2, backend="pallas")).similarity(ragged))
    np.testing.assert_allclose(host(port_engine(2).similarity(ragged)),
                               ref_r, atol=1e-4)


class TestSignatures:
    @pytest.fixture(scope="class")
    def both(self):
        feats, _ = mixture(12, 64, 64, 3, 2)
        ref = RefProtocolEngine(ref_sim.SimilarityConfig(top_k=8))
        lam, v, grams = ref.signatures(jnp.asarray(feats))
        port = port_engine(8).signatures(t(feats))
        return (np.asarray(lam), np.asarray(v), np.asarray(grams)), port

    def test_grams(self, both):
        (_, _, ref_g), (_, _, g) = both
        np.testing.assert_allclose(host(g), ref_g, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref_g).max())

    def test_spectra(self, both):
        (ref_lam, _, _), (lam, _, _) = both
        np.testing.assert_allclose(host(lam), ref_lam,
                                   atol=1e-5 * ref_lam.max())
        assert (host(lam)[:, :-1] >= host(lam)[:, 1:]).all()

    def test_projectors(self, both):
        (_, ref_v, _), (_, v, _) = both
        proj = np.einsum("ndk,nek->nde", host(v), host(v))
        ref_proj = np.einsum("ndk,nek->nde", ref_v, ref_v)
        np.testing.assert_allclose(proj, ref_proj, atol=1e-4)

    def test_relevance_from_reference_signatures(self, both):
        (ref_lam, ref_v, ref_g), _ = both
        ref_r = np.asarray(ref_sim.symmetrize(ref_sim.relevance_matrix(
            jnp.asarray(ref_g), jnp.asarray(ref_lam), jnp.asarray(ref_v))))
        lam, v, g = convert.signatures_from_reference(ref_lam, ref_v, ref_g,
                                                      device="cpu")
        r = sim.symmetrize(sim.relevance_matrix(g, lam, v))
        np.testing.assert_allclose(host(r), ref_r, atol=1e-5)

    def test_signatures_without_grams(self, both):
        (ref_lam, ref_v, _), _ = both
        lam, v, g = convert.signatures_from_reference(ref_lam, ref_v,
                                                      device="cpu")
        assert g is None and lam.dtype == v.dtype == torch.float32
        assert lam.shape == ref_lam.shape and v.shape == ref_v.shape


class TestStages:
    def test_spectrum_order_clamp_and_top_k(self):
        q = np.linalg.qr(np.random.default_rng(0).standard_normal((5, 5)))[0]
        g = t(q @ np.diag([3.0, -1e-7, 1.0, 2.0, 0.5]) @ q.T)
        g = (g + g.T) / 2
        lam, v = sim.spectrum(g, 2)
        np.testing.assert_allclose(host(lam), [3.0, 2.0], rtol=1e-5)
        assert v.shape == (5, 2)
        lam_all, _ = sim.spectrum(g, 0)
        assert lam_all.shape == (5,) and float(lam_all.min()) >= 0.0

    def test_relevance_matches_reference(self):
        rng = np.random.default_rng(9)
        lam = np.abs(rng.standard_normal(6)).astype(np.float32)
        lam_hat = np.abs(rng.standard_normal(6)).astype(np.float32)
        lam_hat[2] = 0.0
        np.testing.assert_allclose(
            float(sim.relevance(t(lam), t(lam_hat), 1e-6)),
            float(ref_sim.relevance(jnp.asarray(lam), jnp.asarray(lam_hat),
                                    1e-6)), rtol=1e-6)

    def test_cross_project_and_gram(self):
        rng = np.random.default_rng(2)
        f = rng.standard_normal((10, 6)).astype(np.float32)
        v = rng.standard_normal((6, 3)).astype(np.float32)
        g = sim.gram(t(f), n_valid=8)
        np.testing.assert_allclose(host(g), np.asarray(ref_sim.gram(
            jnp.asarray(f), n_valid=8)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            host(sim.cross_project(g, t(v))),
            np.asarray(ref_sim.cross_project(jnp.asarray(host(g)),
                                             jnp.asarray(v))), rtol=1e-5)

    def test_similarity_matrix_wrapper(self):
        feats, _ = mixture(8, 20, 8, 2, 0)
        r = sim.similarity_matrix(feats, sim.SimilarityConfig(top_k=2),
                                  device="cpu")
        assert r.shape == (8, 8) and r.device == CPU


class TestConfig:
    @pytest.mark.parametrize("kw", [dict(top_k=-1), dict(eig_floor=0.0),
                                    dict(block_users=-1), dict(landmarks=-2),
                                    dict(landmarks=4, block_users=4),
                                    dict(backend="pallas")])
    def test_invalid_raises(self, kw):
        with pytest.raises(ValueError):
            sim.SimilarityConfig(**kw)

    @pytest.mark.parametrize("kw", [dict(backend="shard_map", landmarks=4),
                                    dict(backend="shard_map", block_users=4),
                                    dict(backend="shard_map")])
    def test_unported_options_raise(self, kw):
        """The sharded backend takes neither single-host mode (the
        reference's two errors); alone, at W = 1, it gives the dense R."""
        from _torch_dist_support import one_rank_world

        kw = {"top_k": 4, **kw}
        if "landmarks" in kw or "block_users" in kw:
            with pytest.raises(ValueError, match="single-host mode"):
                port_engine(**kw)
            return
        feats, _ = mixture(16, 40, 32, 4, 1)
        with one_rank_world() as mesh:
            r = ProtocolEngine(sim.SimilarityConfig(**kw), mesh=mesh,
                               device="cpu").similarity(t(feats))
        np.testing.assert_array_equal(host(r),
                                      host(port_engine(4).similarity(feats)))

    def test_run_raw_raises(self):
        """The raw entry point's ingest backend must agree with the
        protocol's (the reference's check), and it needs a FeatureConfig."""
        from repro_torch.core.signature_engine import SignatureConfig
        from repro_torch.data.features import FeatureConfig

        raw = np.zeros((2, 3, 4), np.float32)
        with pytest.raises(ValueError, match="conflicts"):
            port_engine(4).run_raw(raw, FeatureConfig(kind="identity"),
                                   signature_cfg=SignatureConfig(
                                       backend="shard_map"))
        with pytest.raises(TypeError, match="FeatureConfig"):
            port_engine(4).run_raw(raw, None)

    @pytest.mark.parametrize("backend,expect", [("jnp", "torch"),
                                                ("pallas", "torch"),
                                                ("shard_map", "shard_map")])
    def test_config_from_reference(self, backend, expect):
        ref = ref_sim.SimilarityConfig(top_k=5, eig_floor=1e-5,
                                       backend=backend, mesh_axis="users")
        cfg = convert.similarity_config_from_reference(ref)
        assert cfg == sim.SimilarityConfig(top_k=5, eig_floor=1e-5,
                                           backend=expect, mesh_axis="users")

    def test_prepare_rejects_bad_input(self):
        eng = port_engine(2)
        with pytest.raises(ValueError):
            eng.prepare(np.zeros((3, 4)))
        with pytest.raises(ValueError):
            eng.prepare([np.zeros((3, 4))], n_valid=[3])


def _affinity(v):
    """The exact projector-affinity kernel the sketch approximates."""
    v = np.asarray(v)
    c = np.einsum("idk,jdl->ijkl", v, v)
    return (c ** 2).sum((2, 3)) / v.shape[-1]


class TestLandmarks:
    """The Nystrom-sketched path (``landmarks > 0``): the sketch
    properties the reference's ``tests/test_hierarchy.py::
    TestSketchedRelevance`` checks, and parity with the reference's
    ``backend="pallas"`` landmark path (interpret mode).

    Parity tolerance: R within 2e-3.  Each side runs its own ``eigh``;
    the landmark block ``W`` is then inverted (``pinv``, rtol 1e-6), which
    amplifies the fp32 differences of the scored columns, and both sides
    score in bf16 inputs, where an input differing in its last fp32 bits
    can round to another bf16 value.  Measured gap: up to 2.6e-4 over
    five mixtures.  Labels equal up to permutation.
    """

    TOP_K, TASKS = 6, 4

    def mixture(self, n, seed=0, d=16, samples=16):
        return ref_syn.make_task_feature_mixture(n, samples, d, self.TASKS,
                                                 seed=seed)

    def engine(self, m):
        return port_engine(self.TOP_K, landmarks=m)

    def test_landmark_indices_equal_reference(self):
        from repro.core.engine import landmark_indices as ref_indices
        from repro_torch.core.engine import landmark_indices
        for n, m in ((64, 1), (64, 16), (128, 16), (1024, 128), (9, 9)):
            np.testing.assert_array_equal(landmark_indices(n, m),
                                          ref_indices(n, m))
        with pytest.raises(ValueError, match="0 < m <= n"):
            landmark_indices(8, 9)

    def test_symmetric_unit_range(self):
        feats, _ = self.mixture(32)
        r = host(self.engine(8).similarity(t(feats)))
        np.testing.assert_allclose(r, r.T, atol=1e-5)
        assert (r >= 0.0).all() and (r <= 1.0).all()

    def test_permutation_equivariant(self):
        from repro_torch.core.engine import landmark_indices
        n, m = 24, 6
        feats, _ = self.mixture(n, seed=3)
        land = landmark_indices(n, m)
        rng = np.random.default_rng(0)
        perm = np.arange(n)
        perm[land] = land[rng.permutation(m)]
        rest = np.setdiff1d(np.arange(n), land)
        perm[rest] = rest[rng.permutation(rest.size)]
        eng = self.engine(m)
        r = host(eng.similarity(t(feats)))
        r_perm = host(eng.similarity(t(feats[perm])))
        np.testing.assert_allclose(r_perm, r[np.ix_(perm, perm)], atol=1e-4)

    def test_error_monotone_in_landmarks(self):
        feats, _ = self.mixture(48, seed=1)
        target = _affinity(host(port_engine(self.TOP_K).run(t(feats)).v))
        errs = [np.abs(host(self.engine(m).similarity(t(feats)))
                       - target).mean() for m in (4, 12, 24, 47)]
        assert all(b <= a + 1e-6 for a, b in zip(errs, errs[1:])), errs
        assert errs[-1] < 1e-3

    def test_signatures_match_exact_path(self):
        feats, _ = self.mixture(16, seed=2)
        np.testing.assert_allclose(
            host(self.engine(4).run(t(feats)).lam),
            host(port_engine(self.TOP_K).run(t(feats)).lam), atol=1e-5)

    @pytest.mark.parametrize("n,m,d,seed", [(64, 16, 16, 4), (48, 12, 32, 5),
                                            (40, 8, 24, 6)])
    def test_matches_pallas_landmark_path(self, n, m, d, seed):
        from repro.core.cluster_engine import (ClusterConfig as RefCC,
                                               ClusterEngine as RefCE)
        from repro_torch.core.cluster_engine import (ClusterConfig,
                                                     ClusterEngine)
        feats, tids = self.mixture(n, seed=seed, d=d)
        ref_r = np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
            top_k=self.TOP_K, backend="pallas", landmarks=m)).similarity(
                jnp.asarray(feats)))
        r = self.engine(m).similarity(t(feats))
        np.testing.assert_allclose(host(r), ref_r, rtol=0, atol=2e-3)
        labels = ClusterEngine(ClusterConfig(), device="cpu").labels(
            r, self.TASKS)
        ref_labels = RefCE(RefCC(backend="jnp")).labels(
            jnp.asarray(ref_r), self.TASKS)
        assert same_partition(labels, np.asarray(ref_labels))
        assert clu.adjusted_rand_index(host(labels), tids) == 1.0

    def test_landmarks_not_below_users_raise(self):
        feats, _ = self.mixture(8)
        with pytest.raises(ValueError, match="landmarks=8 must be < "
                                             "n_users=8"):
            self.engine(8).similarity(t(feats))

    def test_run_raw_rejects_landmarks(self):
        from repro_torch.data.features import FeatureConfig
        with pytest.raises(ValueError, match="landmark"):
            self.engine(4).run_raw(np.zeros((8, 3, 4), np.float32),
                                   FeatureConfig(kind="identity"))

    def test_launcher_landmarks_flag(self, capsys):
        from repro_torch.launch import protocol
        acc = protocol.main(["--device", "cpu", "--users", "128",
                             "--landmarks", "16"])
        assert acc == 1.0
        assert "landmarks=16" in capsys.readouterr().out
