"""The port's spectral clustering against the JAX package's.

* Host: ``clustering.spectral_clusters`` is a numpy copy of the
  reference's, so its labels are bit-equal for the same seed, on
  ``tests/test_clustering.py``'s and ``tests/test_cluster_engine.py``'s
  inputs, and its ``n_clusters`` errors are the reference's.
* Device (on the CPU here): ``ClusterEngine("torch").spectral`` with the
  reference's own starting rows injected (``jax.random.choice`` under the
  keys ``_spectral_device`` splits) gives the reference's labels, equal
  and not only up to permutation: the two embeddings differ by an
  orthogonal T x T transform where the Laplacian's bottom T eigenvalues
  stand apart from the (T+1)-th, and Lloyd's distances do not see it.
  The objectives agree to 1e-5 relative.  With the port's own generator
  it recovers the blocks and is deterministic for a seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_support import CPU, host, same_partition
from repro.core import clustering as ref_clu
from repro.core.cluster_engine import (ClusterConfig as RefClusterConfig,
                                       ClusterEngine as RefClusterEngine,
                                       _spectral_device as ref_spectral)
from repro_torch.core import clustering as clu
from repro_torch.core import spectral_clusters
from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                             _lloyd, _spectral_device,
                                             _spectral_embedding)

N_INIT, N_ITER = 8, 50


def rand_sim(n, seed):
    """``tests/test_cluster_engine.py``'s random affinity."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (n, n))
    r = (r + r.T) / 2
    np.fill_diagonal(r, 1.0)
    return r


def block_sim(sizes, seed=0, noise=0.02):
    """``tests/test_cluster_engine.py``'s block affinity."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    lab = np.repeat(np.arange(len(sizes)), sizes)
    r = np.where(lab[:, None] == lab[None, :], 0.9, 0.2)
    r = r + rng.uniform(-noise, noise, size=(n, n))
    r = (r + r.T) / 2
    np.fill_diagonal(r, 1.0)
    return r, lab


def block_similarity(sizes, in_sim=0.95, cross_sim=0.2, noise=0.02, seed=0):
    """``tests/test_clustering.py``'s ``_block_similarity``."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    r = np.where(labels[:, None] == labels[None, :], in_sim, cross_sim)
    r = r + rng.uniform(-noise, noise, size=(n, n))
    r = (r + r.T) / 2
    np.fill_diagonal(r, 1.0)
    return r, labels


#: (name, R, n_clusters): the block inputs of both reference test files,
#: plus wider ones at several T.
BLOCK_INPUTS = [
    ("engine-6-6", *block_sim([6, 6], seed=5)),
    ("engine-5-4-3", *block_sim([5, 4, 3], seed=2)),
    ("clustering-6-6", *block_similarity([6, 6], seed=5)),
    ("clustering-5-5-4", *block_similarity([5, 5, 4])),
    ("engine-8x4", *block_sim([8, 8, 8, 8], seed=11)),
    ("engine-10-7-5-9-3", *block_sim([10, 7, 5, 9, 3], seed=4, noise=0.05)),
]


def _ids(inputs):
    return [case[0] for case in inputs]


def _n_clusters(lab):
    return int(lab.max()) + 1


class TestHostCopy:
    @pytest.mark.parametrize("name,r,lab", BLOCK_INPUTS,
                             ids=_ids(BLOCK_INPUTS))
    @pytest.mark.parametrize("seed", [0, 7])
    def test_labels_bit_equal(self, name, r, lab, seed):
        t = _n_clusters(lab)
        got = clu.spectral_clusters(r, t, rng=seed)
        want = ref_clu.spectral_clusters(r, t, rng=seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert clu.clustering_accuracy(got, lab) == 1.0

    @pytest.mark.parametrize("n,seed,t", [(6, 0, 2), (9, 1, 3), (24, 2, 4),
                                          (31, 3, 5)])
    def test_random_affinity_bit_equal(self, n, seed, t):
        r = rand_sim(n, seed)
        np.testing.assert_array_equal(
            clu.spectral_clusters(r, t, rng=np.random.default_rng(seed)),
            ref_clu.spectral_clusters(r, t, rng=np.random.default_rng(seed)))

    @pytest.mark.parametrize("t", [0, 7, -1])
    def test_n_clusters_errors_match(self, t):
        r = rand_sim(6, 0)
        with pytest.raises(ValueError) as port:
            clu.spectral_clusters(r, t)
        with pytest.raises(ValueError) as ref:
            ref_clu.spectral_clusters(r, t)
        assert str(port.value) == str(ref.value)

    def test_exported_from_core(self):
        assert spectral_clusters is clu.spectral_clusters

    def test_numpy_engine_delegates(self):
        r, lab = block_sim([6, 6], seed=5)
        got = ClusterEngine(ClusterConfig(backend="numpy")).spectral(
            r, 2, rng=0)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(
            got, RefClusterEngine(RefClusterConfig(backend="numpy"))
            .spectral(r, 2, rng=0))


def reference_draws(seed: int, n: int, t: int) -> np.ndarray:
    """The starting rows of ``_spectral_device``'s inits under
    ``PRNGKey(seed)``: ``jax.random.choice`` on each split key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N_INIT)
    return np.stack([np.asarray(jax.random.choice(k, n, (t,), replace=False))
                     for k in keys])


def reference_objective(r: np.ndarray, labels: np.ndarray, t: int) -> float:
    """The reference's k-means objective at its labels: its embedding
    (the same jnp operations as ``_spectral_device``) against the means
    of its clusters, which are its final centres once Lloyd has
    converged."""
    s = jnp.asarray(r, jnp.float32)
    eye = jnp.eye(len(r), dtype=s.dtype)
    a = s * (1.0 - eye)
    d_inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(a.sum(axis=1), 1e-12))
    _, v = jnp.linalg.eigh(eye - d_inv_sqrt[:, None] * a
                           * d_inv_sqrt[None, :])
    emb = v[:, :t]
    emb = np.asarray(emb / jnp.maximum(
        jnp.linalg.norm(emb, axis=1, keepdims=True), 1e-12), np.float64)
    centers = np.stack([emb[labels == c].mean(0) for c in range(t)])
    return float(((emb - centers[labels]) ** 2).sum())


class TestDeviceParity:
    @pytest.mark.parametrize("name,r,lab", BLOCK_INPUTS,
                             ids=_ids(BLOCK_INPUTS))
    @pytest.mark.parametrize("seed", [0, 3])
    def test_injected_draws_give_reference_labels(self, name, r, lab, seed):
        t = _n_clusters(lab)
        want = np.asarray(ref_spectral(jnp.asarray(r, jnp.float32),
                                       jax.random.PRNGKey(seed),
                                       n_clusters=t))
        idx = reference_draws(seed, len(r), t)
        eng = ClusterEngine(ClusterConfig(backend="torch"), device="cpu")
        got = eng.spectral(r, t, init_idx=torch.from_numpy(idx))
        assert got.dtype == torch.int32 and got.device == CPU
        np.testing.assert_array_equal(host(got), want)
        # the objectives of the chosen inits
        rt = torch.as_tensor(r, dtype=torch.float32)
        _, objs = _lloyd(_spectral_embedding(rt, t),
                         torch.from_numpy(idx).long(), N_ITER)
        assert float(objs.min()) == pytest.approx(
            reference_objective(r, want, t), rel=1e-5, abs=1e-6)

    def test_vmapped_draws_equal_per_key_draws(self):
        """The injected rows are those the reference's vmapped inits draw:
        ``jax.random.choice`` is the same under ``vmap``."""
        keys = jax.random.split(jax.random.PRNGKey(5), N_INIT)
        batched = jax.vmap(lambda k: jax.random.choice(
            k, 20, (4,), replace=False))(keys)
        np.testing.assert_array_equal(np.asarray(batched),
                                      reference_draws(5, 20, 4))


class TestOwnDraws:
    def test_recovers_blocks(self):
        r, true = block_sim([6, 6], seed=5)
        lab = ClusterEngine(device="cpu").spectral(r, 2, rng=0)
        assert lab.dtype == torch.int32
        assert same_partition(lab, true)

    @pytest.mark.parametrize("sizes,seed", [([5, 4, 3], 2),
                                            ([8, 8, 8, 8], 11)])
    def test_deterministic_for_a_seed(self, sizes, seed):
        r, true = block_sim(sizes, seed=seed)
        eng = ClusterEngine(device="cpu")
        a = host(eng.spectral(r, len(sizes), rng=7))
        b = host(eng.spectral(r, len(sizes), rng=7))
        np.testing.assert_array_equal(a, b)
        gen_a = torch.Generator().manual_seed(7)
        gen_b = torch.Generator().manual_seed(7)
        np.testing.assert_array_equal(
            host(eng.spectral(r, len(sizes), rng=gen_a)),
            host(eng.spectral(r, len(sizes), rng=gen_b)))
        assert same_partition(a, true)

    def test_draws_distinct_rows(self):
        """Each init starts from distinct rows: on R = I (every row its
        own cluster) the T = N run must find a centre for every row."""
        r = torch.eye(7)
        lab = _spectral_device(r, 7, torch.Generator().manual_seed(0))
        assert sorted(host(lab).tolist()) == list(range(7))


class TestValidation:
    def test_rejects_bad_n_clusters(self):
        eng = ClusterEngine(device="cpu")
        for t in (0, 9):
            with pytest.raises(ValueError, match="n_clusters"):
                eng.spectral(rand_sim(5, 0), t)

    def test_rejects_non_square(self):
        with pytest.raises(ValueError, match="square"):
            ClusterEngine(device="cpu").spectral(np.ones((4, 5)), 2)

    def test_rejects_bad_injected_rows(self):
        with pytest.raises(ValueError, match="init_idx"):
            ClusterEngine(device="cpu").spectral(
                rand_sim(6, 0), 2, init_idx=torch.zeros(8, 3,
                                                        dtype=torch.long))

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterEngine().spectral(rand_sim(6, 0), 2)
