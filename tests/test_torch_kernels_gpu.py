"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA
device.  The file imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the gram and eigproject kernels sum in fp32 in another order
than cuBLAS, so they agree to 1e-5 of the largest entry; the linkage
kernels use the plain version's IEEE operations and agree exactly.
"""
import numpy as np
import pytest
import torch

from _torch_support import cuda_device, host, same_partition, t  # noqa: F401
from repro_torch.core import clustering as clu
from repro_torch.core.cluster_engine import ClusterConfig
from repro_torch.core.oneshot import one_shot_clustering
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data.synthetic import make_task_feature_mixture
from repro_torch.kernels import dispatch
from repro_torch.kernels.eigproject import (project_norms_all,
                                            project_norms_all_ref)
from repro_torch.kernels.gram import batched_gram_matrix, gram_ref
from repro_torch.kernels.linkage import (LINKAGES, linkage_step,
                                         linkage_step_ref, nn_chain,
                                         nn_chain_ref)


def close(out, ref, tol=1e-5):
    err = float((out.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), err


def _rows(n, seed):
    """Rows with exact ties (values on a 1/4 grid), a random mask."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 4, n) / 4).astype(np.float32)
    b = (rng.integers(0, 4, n) / 4).astype(np.float32)
    mask = rng.uniform(size=n) > 0.3
    return a, b, mask


@pytest.mark.gpu
class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card."""

    def test_gram(self, cuda_device):
        torch.manual_seed(0)
        for shape in [(3, 17, 5), (4, 100, 784), (2, 256, 512)]:
            x = torch.randn(shape, device=cuda_device)
            before = dispatch.LAUNCHES["gram"]
            out = batched_gram_matrix(x)
            assert dispatch.LAUNCHES["gram"] == before + 1
            close(out, gram_ref(x))

    def test_eigproject(self, cuda_device):
        torch.manual_seed(0)
        for n_g, n_v, d, k in [(3, 4, 9, 2), (5, 33, 130, 5), (4, 8, 512, 8)]:
            g = torch.randn((n_g, d, d), device=cuda_device)
            v = torch.randn((n_v, d, k), device=cuda_device)
            close(project_norms_all(g, v), project_norms_all_ref(g, v))

    @pytest.mark.parametrize("linkage", LINKAGES)
    def test_linkage_step(self, cuda_device, linkage):
        for n in (1, 7, 1000, 3000):
            a, b, mask = _rows(n, n)
            args = (t(a).to(cuda_device), t(b).to(cuda_device), 2.0, 3.0,
                    torch.from_numpy(mask).to(cuda_device), linkage)
            for x, y in zip(linkage_step(*args), linkage_step_ref(*args)):
                assert torch.equal(x, y)

    @pytest.mark.parametrize("linkage", LINKAGES)
    def test_nn_chain(self, cuda_device, linkage):
        r = np.random.default_rng(5).uniform(size=(300, 300))
        s = t((r + r.T) / 2).to(cuda_device)
        s.fill_diagonal_(float("-inf"))
        a = nn_chain(s.clone(), linkage)
        b = nn_chain_ref(s.clone(), linkage)
        assert int(a[2]) == int(b[2]) == 299
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_one_shot_matches_cpu(self, cuda_device):
        feats, tasks = make_task_feature_mixture(64, 64, 64, 4, seed=1)
        cfg = SimilarityConfig(top_k=8)
        ccfg = ClusterConfig(backend="torch")
        dispatch.reset_launches()
        on_card = one_shot_clustering(feats, 4, cfg=cfg, cluster_cfg=ccfg,
                                      device=cuda_device)
        assert all(dispatch.LAUNCHES[k] == 1
                   for k in ("gram", "eigproject", "linkage"))
        on_cpu = one_shot_clustering(feats, 4, cfg=cfg, cluster_cfg=ccfg,
                                     device="cpu")
        np.testing.assert_allclose(host(on_card.similarity),
                                   host(on_cpu.similarity), atol=1e-4)
        assert same_partition(on_card.labels, on_cpu.labels)
        assert clu.clustering_accuracy(host(on_card.labels), tasks) == 1.0

    def test_nn_chain_nan_stops_short(self, cuda_device):
        r = np.random.default_rng(1).uniform(size=(40, 40))
        s = t((r + r.T) / 2).to(cuda_device)
        s.fill_diagonal_(float("-inf"))
        s[2, 7] = s[7, 2] = float("nan")
        assert int(nn_chain(s)[2]) < 39
