"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA
device.  The file imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the gram, eigproject, featurize_gram (fp32) and
gram_project kernels sum in fp32 in another order than cuBLAS, so they
agree to 1e-5 of the largest entry; featurize_gram in bf16 is held to
the reference's 2e-2 of the largest entry; the linkage kernels use the
plain version's IEEE operations and agree exactly.
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
from repro_torch.kernels.featurize_gram import (batched_featurize_gram,
                                                featurize_gram_ref)
from repro_torch.kernels.gram_project import (batched_gram_project,
                                              gram_project_ref)
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

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_featurize_gram(self, cuda_device, compute_dtype):
        torch.manual_seed(0)
        tol = 1e-5 if compute_dtype == "fp32" else 2e-2
        for n_users, c, m, d in [(3, 17, 5, 3), (4, 100, 784, 100),
                                 (2, 128, 3072, 512), (2, 40, 96, 900)]:
            x = torch.randn((n_users, c, m), device=cuda_device)
            x[:, c - c // 3:] = 0.0              # zero tail rows
            w = torch.randn((m, d), device=cuda_device) / d ** 0.5
            before = dispatch.LAUNCHES["featurize_gram"]
            out = batched_featurize_gram(x, w, compute_dtype)
            assert dispatch.LAUNCHES["featurize_gram"] == before + 1
            close(out, featurize_gram_ref(x, w, compute_dtype), tol)
            assert torch.equal(out, out.transpose(1, 2))
            acc = torch.randn((n_users, d, d), device=cuda_device)
            expect = acc + featurize_gram_ref(x, w, compute_dtype)
            close(batched_featurize_gram(x, w, compute_dtype, out=acc),
                  expect, tol)

    def test_gram_project(self, cuda_device):
        torch.manual_seed(0)
        for n_users, n, d, k in [(3, 40, 24, 70), (2, 100, 784, 50),
                                 (4, 256, 512, 1000), (2, 17, 1500, 33)]:
            x = torch.randn((n_users, n, d), device=cuda_device)
            nv = torch.tensor([max(1, n - 7 * i) for i in range(n_users)],
                              device=cuda_device, dtype=torch.float32)
            x[torch.arange(n, device=cuda_device)[None] >= nv[:, None]] = 0.0
            v = torch.randn((d, k), device=cuda_device)
            before = dispatch.LAUNCHES["gram_project"]
            out = batched_gram_project(x, v, nv)
            assert dispatch.LAUNCHES["gram_project"] == before + 1
            close(out, gram_project_ref(x, v, nv))

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

    @pytest.mark.parametrize("mode", ["raw", "blockwise"])
    def test_raw_and_blockwise_match_cpu(self, cuda_device, mode):
        from repro_torch.core.signature_engine import SignatureConfig
        from repro_torch.data.features import FeatureConfig

        raw, tasks = make_task_feature_mixture(48, 40, 96, 3, seed=2)
        ccfg = ClusterConfig(backend="torch")
        if mode == "raw":
            kw = dict(cfg=SimilarityConfig(top_k=4),
                      feature_cfg=FeatureConfig(d=32),
                      signature_cfg=SignatureConfig(chunk_rows=16))
            kernel = "featurize_gram"
        else:
            kw = dict(cfg=SimilarityConfig(top_k=4, block_users=16))
            kernel = "gram_project"
        dispatch.reset_launches()
        on_card = one_shot_clustering(raw, 3, cluster_cfg=ccfg,
                                      device=cuda_device, **kw)
        assert dispatch.LAUNCHES[kernel] > 0
        on_cpu = one_shot_clustering(raw, 3, cluster_cfg=ccfg, device="cpu",
                                     **kw)
        np.testing.assert_allclose(host(on_card.similarity),
                                   host(on_cpu.similarity), atol=1e-4)
        assert same_partition(on_card.labels, on_cpu.labels)
        assert clu.clustering_accuracy(host(on_card.labels), tasks) == 1.0
