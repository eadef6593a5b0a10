"""The port's robustness extensions (paper §IV future work) against the
JAX package's: ``user_signature``, ``perturb_eigenvectors`` and
``subsample_rows`` in ``core/similarity.py``.

Tolerances, those ``tests/test_torch_similarity.py`` uses:
  * ``user_signature``: G at rtol 1e-5 and 1e-5 of max|G|; lam at 1e-5
    of the largest eigenvalue; the projectors ``V V^T`` at 1e-4 (each side
    runs its own ``eigh``, so V is compared only through them).
  * ``perturb_eigenvectors``: the reference's ``jax.random.normal`` draw
    injected into the port's arithmetic (``perturb_with_noise``), 1e-6;
    R from the reference's signatures with that noise, 1e-5.
  * ``subsample_rows``: a numpy copy, bit-equal.
The port's own draws (a ``torch.Generator``) are held on their
statistics: unit-norm columns, the identity at sigma 0, and noise whose
mean and spread fit sigma.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_support import host, same_partition, t
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


def projector(v):
    return np.einsum("...dk,...ek->...de", v, v)


class TestUserSignature:
    @pytest.mark.parametrize("n,d,top_k,n_valid,seed", [
        (64, 64, 8, None, 2),      # test_torch_similarity's signatures
        (40, 24, 3, 29, 5),        # rows past n_valid zeroed
        (30, 16, 0, None, 9),      # top_k 0: all d eigenpairs
    ])
    def test_matches_reference(self, n, d, top_k, n_valid, seed):
        feats, _ = mixture(3, n, d, 3, seed)
        f = feats[0].copy()
        if n_valid is not None:
            f[n_valid:] = 0.0
        ref_lam, ref_v, ref_g = (np.asarray(a) for a in ref_sim.user_signature(
            jnp.asarray(f), ref_sim.SimilarityConfig(top_k=top_k),
            n_valid=n_valid))
        lam, v, g = sim.user_signature(
            t(f), sim.SimilarityConfig(top_k=top_k), n_valid=n_valid)
        assert lam.shape == ref_lam.shape and v.shape == ref_v.shape
        assert g.shape == ref_g.shape == (d, d)
        np.testing.assert_allclose(host(g), ref_g, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref_g).max())
        np.testing.assert_allclose(host(lam), ref_lam,
                                   atol=1e-5 * ref_lam.max())
        if top_k:      # a top-k projector needs its gap; all d is I
            np.testing.assert_allclose(projector(host(v)),
                                       projector(ref_v), atol=1e-4)
        np.testing.assert_allclose(projector(host(v)).trace(),
                                   v.shape[1], rtol=1e-5)

    def test_equals_the_engine_signature(self):
        feats, _ = mixture(4, 32, 16, 2, 3)
        lam_all, v_all, g_all = ProtocolEngine(
            sim.SimilarityConfig(top_k=4), device="cpu").signatures(
                t(feats))
        lam, v, g = sim.user_signature(t(feats[1]),
                                       sim.SimilarityConfig(top_k=4))
        np.testing.assert_allclose(host(g), host(g_all[1]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(host(lam), host(lam_all[1]), rtol=1e-5)


#: (v shape, sigma, renormalize) of the injected-noise cases.
PERTURB_CASES = [((16, 4), 0.01, True), ((16, 4), 0.3, False),
                 ((5, 24, 6), 0.1, True), ((5, 24, 6), 1.0, True),
                 ((3, 8, 8), 0.0, True), ((3, 8, 8), 0.05, False)]


class TestPerturbEigenvectors:
    @pytest.mark.parametrize("shape,sigma,renorm", PERTURB_CASES)
    def test_injected_noise_matches_reference(self, shape, sigma, renorm):
        rng = np.random.default_rng(len(shape) * 10 + int(sigma * 100))
        v = np.linalg.qr(rng.standard_normal(shape))[0].astype(np.float32)
        key = jax.random.PRNGKey(17)
        want = np.asarray(ref_sim.perturb_eigenvectors(
            jnp.asarray(v), sigma, key, renormalize=renorm))
        noise = np.asarray(jax.random.normal(key, v.shape, jnp.float32))
        got = sim.perturb_with_noise(t(v), sigma, t(noise), renorm)
        assert got.dtype == torch.float32 and got.shape == v.shape
        np.testing.assert_allclose(host(got), want, atol=1e-6, rtol=0)

    def test_relevance_from_reference_signatures_with_noise(self):
        feats, _ = mixture(12, 64, 64, 3, 2)
        lam, v, grams = RefProtocolEngine(
            ref_sim.SimilarityConfig(top_k=8)).signatures(jnp.asarray(feats))
        key = jax.random.PRNGKey(17)
        vp = ref_sim.perturb_eigenvectors(v, 0.1, key)
        ref_r = np.asarray(ref_sim.symmetrize(
            ref_sim.relevance_matrix(grams, lam, vp)))
        noise = t(jax.random.normal(key, v.shape, jnp.float32))
        p_lam, p_v, p_g = convert.signatures_from_reference(
            np.asarray(lam), np.asarray(v), np.asarray(grams), device="cpu")
        r = sim.symmetrize(sim.relevance_matrix(
            p_g, p_lam, sim.perturb_with_noise(p_v, 0.1, noise)))
        np.testing.assert_allclose(host(r), ref_r, atol=1e-5)
        assert same_partition(clu.hac_clusters(host(r), 3),
                              ref_clu.hac_clusters(ref_r, 3))

    def test_own_draws_unit_norm_columns(self):
        v = torch.linalg.qr(torch.randn(4, 32, 8,
                            generator=torch.Generator().manual_seed(0))).Q
        out = sim.perturb_eigenvectors(v, 0.3, torch.Generator()
                                       .manual_seed(1))
        np.testing.assert_allclose(
            host(torch.linalg.vector_norm(out, dim=-2)), 1.0, atol=1e-6)

    def test_own_draws_identity_at_sigma_zero(self):
        v = torch.linalg.qr(torch.randn(32, 8,
                            generator=torch.Generator().manual_seed(0))).Q
        assert torch.equal(sim.perturb_eigenvectors(v, 0.0, 3,
                                                    renormalize=False), v)
        np.testing.assert_allclose(host(sim.perturb_eigenvectors(v, 0.0, 3)),
                                   host(v), atol=1e-6)

    @pytest.mark.parametrize("sigma", [0.01, 0.1, 1.0])
    def test_own_draws_fit_sigma(self, sigma):
        """Without renormalisation the output is ``v + sigma z``: over
        65,536 entries the sample mean of z lies within 5 standard errors
        of 0 and its spread within 2% of 1."""
        v = torch.zeros(64, 128, 8)
        z = host(sim.perturb_eigenvectors(v, sigma, 5, renormalize=False)
                 ) / sigma
        assert abs(z.mean()) < 5 / np.sqrt(z.size)
        assert z.std() == pytest.approx(1.0, rel=0.02)

    def test_own_draws_keyed_by_the_generator(self):
        v = torch.zeros(8, 4)
        a = sim.perturb_eigenvectors(v, 1.0, 11, renormalize=False)
        b = sim.perturb_eigenvectors(v, 1.0, torch.Generator().manual_seed(
            11), renormalize=False)
        c = sim.perturb_eigenvectors(v, 1.0, 12, renormalize=False)
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_keeps_the_dtype(self):
        v = torch.eye(6, 2, dtype=torch.bfloat16)
        assert sim.perturb_eigenvectors(v, 0.1, 0).dtype == torch.bfloat16


class TestSubsampleRows:
    @pytest.mark.parametrize("n,max_rows,seed", [(100, 30, 0), (100, 99, 4),
                                                 (64, 64, 1), (10, 50, 2),
                                                 (257, 128, 3)])
    def test_bit_equal(self, n, max_rows, seed):
        f = np.random.default_rng(n).standard_normal((n, 6)).astype(
            np.float32)
        got = sim.subsample_rows(f, max_rows, seed=seed)
        want = ref_sim.subsample_rows(f, max_rows, seed=seed)
        np.testing.assert_array_equal(got, want)
        if n <= max_rows:
            assert got is f

    def test_spawned_seeds_end_to_end(self):
        """The reference benchmark's sweep: each user subsampled under its
        own spawned seed, then the protocol; R within 1e-4 (end to end,
        each side its own ``eigh``) and the same partition."""
        feats, tasks = mixture(16, 96, 16, 2, 6)
        seeds = np.random.SeedSequence(3).spawn(len(feats))
        sub = np.stack([sim.subsample_rows(f, 48, seed=s)
                        for f, s in zip(feats, seeds)])
        seeds = np.random.SeedSequence(3).spawn(len(feats))
        ref_sub = np.stack([ref_sim.subsample_rows(f, 48, seed=s)
                            for f, s in zip(feats, seeds)])
        np.testing.assert_array_equal(sub, ref_sub)
        ref_r = np.asarray(RefProtocolEngine(ref_sim.SimilarityConfig(
            top_k=2)).similarity(jnp.asarray(ref_sub)))
        big_r = ProtocolEngine(sim.SimilarityConfig(top_k=2),
                               device="cpu").similarity(t(sub))
        np.testing.assert_allclose(host(big_r), ref_r, atol=1e-4)
        labels = clu.hac_clusters(host(big_r), 2)
        assert same_partition(labels, ref_clu.hac_clusters(ref_r, 2))
        assert clu.clustering_accuracy(labels, tasks) == 1.0
