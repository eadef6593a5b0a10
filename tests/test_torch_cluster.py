"""The port's NN-chain HAC and cut against the JAX ``ClusterEngine``.

The same R goes to the port's torch backend (on the CPU: the plain
NN-chain loop), the reference's ``jnp`` and ``pallas`` (interpret)
NN-chains, and the numpy HAC.  Labels must be the same partition and
the sorted merge heights agree to rtol 1e-6.  The NN-chain only reads
and Lance-Williams-combines fp32 entries of R; the port does that in
separately rounded IEEE operations (as its CUDA kernel does, bit for
bit), while XLA's fused CPU code may round an average-linkage update
differently in the last bit (seen: 1 ulp, 6e-8).  Against the float64
numpy HAC the gap is fp32 rounding of R and of the averages.
"""
import numpy as np
import pytest
import torch

from _torch_support import host, same_partition, t
from repro.core import clustering as ref_clu
from repro.core.cluster_engine import ClusterConfig as RefClusterConfig
from repro.core.cluster_engine import ClusterEngine as RefClusterEngine
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                             DeviceDendrogram, cut_device)

LINKAGES = ("average", "single", "complete")


def rand_sim(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (n, n))
    r = (r + r.T) / 2
    np.fill_diagonal(r, 1.0)
    return r.astype(np.float32)


def block_sim(sizes, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.arange(len(sizes)), sizes)
    r = np.where(lab[:, None] == lab[None, :], 0.9, 0.2)
    r = r + rng.uniform(-noise, noise, size=r.shape)
    r = (r + r.T) / 2
    np.fill_diagonal(r, 1.0)
    return r.astype(np.float32), lab


def port(linkage="average"):
    return ClusterEngine(ClusterConfig(backend="torch", linkage=linkage),
                         device="cpu")


def reference(backend, linkage="average"):
    return RefClusterEngine(RefClusterConfig(backend=backend,
                                             linkage=linkage))


@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("n,seed", [(2, 0), (9, 1), (24, 2), (31, 3)])
def test_labels_and_heights_match_jnp_and_numpy(linkage, n, seed):
    r = rand_sim(n, seed)
    dend = port(linkage).hac(r)
    ref_dend = reference("jnp", linkage).hac(r)
    np.testing.assert_allclose(np.sort(host(dend.heights)),
                               np.sort(np.asarray(ref_dend.heights)),
                               rtol=1e-6)
    np_heights = ref_clu.hac(r, linkage).heights()
    np.testing.assert_allclose(np.sort(host(dend.heights)),
                               np.sort(np_heights), rtol=1e-6)
    for n_clusters in sorted({1, 2, max(2, n // 3), n}):
        labels = port(linkage).cut(dend, n_clusters)
        assert labels.dtype == torch.int32
        assert same_partition(labels, reference("jnp", linkage).cut(
            ref_dend, n_clusters))
        assert same_partition(labels, ref_clu.hac_clusters(r, n_clusters,
                                                           linkage))


@pytest.mark.parametrize("linkage", LINKAGES)
def test_matches_pallas_backend(linkage):
    r = rand_sim(17, 2)
    dend = port(linkage).hac(r)
    ref_dend = reference("pallas", linkage).hac(r)
    np.testing.assert_allclose(np.sort(host(dend.heights)),
                               np.sort(np.asarray(ref_dend.heights)),
                               rtol=1e-6)
    assert same_partition(port(linkage).cut(dend, 3),
                          reference("pallas", linkage).cut(ref_dend, 3))


@pytest.mark.parametrize("linkage", LINKAGES)
def test_tied_blocks(linkage):
    r, true = block_sim([4, 4, 3], noise=0.0)
    assert same_partition(port(linkage).labels(r, 3), true)
    assert same_partition(port(linkage).labels(r, 3),
                          ref_clu.hac_clusters(r, 3, linkage))


def test_cut_extremes():
    r, _ = block_sim([5, 6], seed=3)
    dend = port().hac(r)
    assert torch.equal(port().cut(dend, 1), torch.zeros(11, dtype=torch.int32))
    assert torch.equal(port().cut(dend, 11),
                       torch.arange(11, dtype=torch.int32))
    with pytest.raises(ValueError):
        port().cut(dend, 0)
    with pytest.raises(ValueError):
        port().cut(dend, 12)


def test_labels_canonical_by_sorted_root():
    # Chain-order merges whose forest roots are 0 and 3.
    merges = torch.tensor([[0, 1], [3, 4], [0, 2]], dtype=torch.int32)
    heights = torch.tensor([0.9, 0.8, 0.7])
    labels = cut_device(merges, heights, 5, 2)
    assert labels.tolist() == [0, 0, 0, 1, 1]


def test_to_host_matches_numpy_cut():
    r, _ = block_sim([3, 5, 4], seed=1)
    dend = port().hac(r)
    assert isinstance(dend, DeviceDendrogram)
    host_dend = dend.to_host()
    ref = ref_clu.hac(r)
    np.testing.assert_allclose(np.sort(host_dend.heights()),
                               np.sort(ref.heights()), rtol=1e-6)
    for k in (1, 3, 12):
        assert same_partition(clu.cut(host_dend, k), ref_clu.cut(ref, k))


def test_nan_raises():
    r = rand_sim(10, 0)
    r[2, 5] = r[5, 2] = np.nan
    with pytest.raises(ValueError, match="stopped after"):
        port().hac(r)
    with pytest.raises(ValueError):
        ClusterEngine(ClusterConfig(backend="numpy")).hac(r)


def test_input_is_not_modified():
    r = t(rand_sim(8, 4))
    before = r.clone()
    port().labels(r, 2)
    assert torch.equal(r, before)


def test_numpy_backend_takes_tensors():
    r, true = block_sim([4, 5], seed=2)
    eng = ClusterEngine(ClusterConfig(backend="numpy"))
    assert eng.device is None and not eng.on_device
    labels = eng.labels(t(r), 2)
    assert isinstance(labels, np.ndarray) and same_partition(labels, true)


class TestConfig:
    def test_invalid(self):
        with pytest.raises(ValueError):
            ClusterEngine(ClusterConfig(backend="jnp"), device="cpu")
        with pytest.raises(ValueError):
            ClusterEngine(ClusterConfig(backend="torch", linkage="ward"),
                          device="cpu")
        with pytest.raises(ValueError):
            port().hac(np.zeros((3, 4)))

    @pytest.mark.parametrize("backend,expect", [("numpy", "numpy"),
                                                ("jnp", "torch"),
                                                ("pallas", "torch")])
    def test_config_from_reference(self, backend, expect):
        cfg = convert.cluster_config_from_reference(
            RefClusterConfig(backend=backend, linkage="single"))
        assert cfg == ClusterConfig(backend=expect, linkage="single")
