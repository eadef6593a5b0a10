"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA
device.  The file imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the gram, eigproject, featurize_gram (fp32) and
gram_project kernels sum in fp32 in another order than cuBLAS, so they
agree to 1e-5 of the largest entry; featurize_gram in bf16 is held to
the reference's 2e-2 of the largest entry.  featurize_gram (fp32),
gram_project and eigproject run their products as 3xTF32 on the tensor
cores (eigproject: ``project_norms_all_tf32(..., 1)``): each is
also held to at most 1/8 of the error of the plain 1xTF32 emulation
(``kernels/tf32.py::matmul_1xtf32``, hi hi alone) on the same inputs,
and two runs give the same bits; the linkage kernels use the
plain version's IEEE operations and agree exactly (the NN-chain with its
cached nearest neighbours, whose counters also equal those of the plain
model of the cache, ``nn_chain_cached_ref``, on ties, NaN and overflow
corners, and past the 19,370 leaves that shared memory once capped).  The assign kernels
agree with their plain versions to 1e-4 of the largest affinity in fp32
(the reference's bar; a d = 512 affinity sums 262,144 terms) and 1e-5
in bf16 (the same bf16 operands, fp32 sums in another order;
``chip_smoke.py`` measures up to 1.1e-6 on such random inputs on an
H100), finite margins to twice that, NaN and inf margins in the same
places, and equal labels wherever the plain margin exceeds the
tolerance.  At d = 512 bf16 and fp32 differ by far more than the bf16
tolerance, so a kernel that ignored the compute dtype fails.  The bf16
wave kernel (tensor cores, split over the d^2 axis) adds its partial
sums in a fixed order, so two runs on the same inputs are bit-equal; so
does assign_one (split over arrival groups x slices of P, bf16 on the
tensor cores), held over every table and compute dtype, T in {1, 4,
33}, B in {1, 5, 128} and (d, k) up to (1024, 64).  The gram kernel
(3xTF32 on wgmma, one triangle of tile pairs) is held on both load
routes (TMA, and 4-byte cp.async where 4 d % 16 != 0) to 1e-5 of the
largest entry and to 1/8 of the 1xTF32 emulation's error, symmetric bit
for bit, with its n_valid divisor equal to the division after it.

The LM kernels: flash in fp32 agrees with its plain version to 1e-5 of
the largest output (another summation order; an H100 measured 1.3e-6);
on bf16 inputs each element of its bf16 output is within 2^-8 of its
own value plus 1e-5 of the largest output of the fp32 function of the
same inputs (its rounding plus the fp32 gap).  The tensor-core kernel
behind bf16 inputs, with its output left in fp32
(``ops._flash_attention_fp32_out``), agrees with the fp32 function of
the bf16 values to 1e-5 of the largest output: p.v keeps p to about 16
bits (its bf16 hi and lo parts), where p rounded to bf16 once would
miss by 100x that.  The wkv kernel computes
the chunk form (sub-chunks of 16 tokens) on the tensor cores: under fp32
compute (3xTF32) its output and state agree with the sequential oracle
and with the plain chunk form to 1e-5 of the largest entry (2^-8 for an
output rounded to bf16); under bf16 compute, with the reference's bf16
roundings, to 2^-8 of the plain chunk form's (``wkv_chunked_ref``), whose
gap to the oracle the CPU tests hold within 2x the reference's own bf16
kernel's.  The linear scan uses the plain version's separately rounded
IEEE operations and equals it bit for bit on both load routes (TMA, and
4-byte cp.async for misaligned views and D % 4 != 0), two runs alike.

The group axis of eigproject and the NN-chain (the hierarchical
protocol): each grouped call is held to G single calls (the norms within
1e-6 of the largest and bit-equal; the chains' merges, heights and
steps exact, a NaN stopping only its own group) and to the plain
versions, and the batched cut to the per-group cut.
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
from repro_torch.kernels import dispatch, quant
from repro_torch.kernels.assign import (assign, assign_looped,
                                        assign_looped_plain,
                                        assign_wave_plain)
from repro_torch.kernels.eigproject import (eig_plan, project_norms_all,
                                            project_norms_all_ref,
                                            project_norms_all_tf32,
                                            project_norms_grouped,
                                            project_norms_grouped_ref,
                                            split_w_ref)
from repro_torch.kernels.eigproject.ops import kernel_plan, split_w
from repro_torch.kernels.featurize_gram import (batched_featurize_gram,
                                                featurize_gram_ref)
from repro_torch.kernels.gram_project import (batched_gram_project,
                                              gram_project_ref)
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_ref)
from repro_torch.kernels.flash_attention.ops import _flash_attention_fp32_out
from repro_torch.kernels.gram import batched_gram_matrix, gram_ref
from repro_torch.kernels.recurrent_scan import (linear_scan, linear_scan_plan,
                                                linear_scan_ref, wkv_chunked,
                                                wkv_chunked_ref, wkv_ref)
from repro_torch.kernels.tf32 import matmul_1xtf32
from repro_torch.core.cluster_engine import cut_device, cut_device_grouped
from repro_torch.core.hierarchy import HierarchyConfig, hierarchical_one_shot
from repro_torch.kernels.linkage import (LINKAGES, chain_plan, linkage_step,
                                         linkage_step_ref, nn_chain,
                                         nn_chain_cached_ref, nn_chain_grouped,
                                         nn_chain_grouped_ref, nn_chain_ref)
from repro_torch.kernels.linkage import ops as lk_ops


def close(out, ref, tol=1e-5):
    err = float((out.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), err


def close_bf16(out, ref):
    """A bf16 output element by element against the fp32 function of the
    same inputs: its rounding (half a bf16 ulp) plus the fp32 gap."""
    gap = (out.double() - ref.double()).abs()
    limit = 2 ** -8 * ref.double().abs() + 1e-5 * float(ref.abs().max())
    assert bool((gap <= limit).all()), float((gap / limit).max())


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

    @pytest.mark.parametrize("shape", [(3, 17, 5), (8, 37, 130),
                                       (16, 300, 784), (2, 64, 128),
                                       (5, 1, 257), (2, 0, 64)])
    def test_gram_tensor_cores(self, cuda_device, shape):
        """Both load routes (TMA where 4 d % 16 == 0, 4-byte cp.async
        else), ragged n and d: 1e-5 of the largest entry and 1/8 of the
        1xTF32 emulation's error, symmetric bit for bit, two runs
        bit-equal, and the divisor equal to the division after."""
        torch.manual_seed(shape[2])
        x = torch.randn(shape, device=cuda_device)
        out = batched_gram_matrix(x)
        ref = gram_ref(x)
        assert torch.equal(out, out.mT)
        assert torch.equal(out, batched_gram_matrix(x))
        if shape[1] == 0:
            assert torch.equal(out, torch.zeros_like(out))
            return
        close(out, ref)
        err = float((out.double() - ref.double()).abs().max())
        err_1x = float((matmul_1xtf32(x.mT, x).double()
                        - ref.double()).abs().max())
        assert 8 * err <= err_1x, (err, err_1x)
        nv = torch.arange(shape[0], device=cuda_device, dtype=torch.float32)
        assert torch.equal(batched_gram_matrix(x, nv),
                           out / torch.clamp_min(nv, 1.0)[:, None, None])

    def test_gram_reads_misaligned_views(self, cuda_device):
        base = torch.randn(6 * 40 * 128 + 1, device=cuda_device)
        x = base[1:].view(6, 40, 128)
        assert x.data_ptr() % 16
        close(batched_gram_matrix(x), gram_ref(x))

    @pytest.mark.parametrize("n_g,n_v,d,k", [
        (3, 4, 9, 2), (5, 33, 130, 5), (4, 8, 512, 8), (2, 17, 512, 8),
        (3, 5, 784, 5), (1, 1, 1, 1), (4, 6, 16, 8), (3, 20, 28, 7)])
    def test_eigproject(self, cuda_device, n_g, n_v, d, k):
        """Both load routes of G (TMA where 4 d % 16 == 0, also at d = 16
        and 28, where the 32-deep, 128-row box is larger than G; 4-byte
        cp.async at d = 9 and 130), NV k off the 128-column slab, NG !=
        NV, G not symmetric: 1e-5 of the largest norm and 1/8 of the 1xTF32
        emulation's error, two runs bit-equal, one launch a call, and the
        split W^T equal to its plain layout bit for bit."""
        torch.manual_seed(d + k)
        g = torch.randn((n_g, d, d), device=cuda_device)
        v = torch.randn((n_v, d, k), device=cuda_device)
        before = dispatch.LAUNCHES["eigproject"]
        out = project_norms_all(g, v)
        assert dispatch.LAUNCHES["eigproject"] == before + 1
        ref = project_norms_all_ref(g, v)
        close(out, ref)
        err = float((out.double() - ref.double()).abs().max())
        err_1x = float((project_norms_all_tf32(g, v, 1).double()
                        - ref.double()).abs().max())
        assert 8 * err <= err_1x, (err, err_1x)
        assert torch.equal(out, project_norms_all(g, v))
        assert torch.equal(split_w(v)[:, :, :d], split_w_ref(v)[:, :, :d])
        assert kernel_plan(d) == eig_plan(d)

    @pytest.mark.parametrize("b,ng,d,k", [
        (3, 20, 130, 5), (4, 33, 64, 8), (5, 16, 16, 8), (2, 200, 16, 8),
        (2, 128, 512, 8), (1, 3, 9, 1)])
    def test_eigproject_grouped(self, cuda_device, b, ng, d, k):
        """The group axis against G single calls (column tiles that cross
        a group's end at Ng k = 100, 264 and 1600; both load routes; the
        hierarchical cells' shapes (200, 16, 8) and (128, 512, 8)): within
        1e-6 of the largest norm, and bit-equal as run (each group's tiles
        start at its first column, so each sum runs as in a single call);
        against the plain version to 1e-5 and 1/8 of the 1xTF32
        emulation's error; one launch a call."""
        torch.manual_seed(b * 1000 + ng + d)
        g = torch.randn((b, ng, d, d), device=cuda_device)
        v = torch.randn((b, ng, d, k), device=cuda_device)
        before = dispatch.LAUNCHES["eigproject"]
        out = project_norms_grouped(g, v)
        assert dispatch.LAUNCHES["eigproject"] == before + 1
        single = torch.stack([project_norms_all(g[i], v[i])
                              for i in range(b)])
        close(out, single, 1e-6)
        assert torch.equal(out, single)
        ref = project_norms_grouped_ref(g, v)
        close(out, ref)
        err = float((out.double() - ref.double()).abs().max())
        err_1x = max(float((project_norms_all_tf32(g[i], v[i], 1).double()
                            - ref[i].double()).abs().max())
                     for i in range(b))
        assert 8 * err <= err_1x, (err, err_1x)
        assert torch.equal(out, project_norms_grouped(g, v))

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

    def test_featurize_gram_live_split(self, cuda_device):
        # 3xTF32 against the plain fp32 function: within 1e-5 and at most
        # 1/8 of the plain 1xTF32 emulation's error on the same inputs.
        torch.manual_seed(1)
        x = torch.randn((4, 128, 3072), device=cuda_device)
        x[:, 100:] = 0.0
        w = torch.randn((3072, 512), device=cuda_device) / 512 ** 0.5
        ref = featurize_gram_ref(x, w)
        f1 = matmul_1xtf32(x, w)
        err = float((batched_featurize_gram(x, w).double()
                     - ref.double()).abs().max())
        err_1x = float((matmul_1xtf32(f1.transpose(1, 2), f1).double()
                        - ref.double()).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
        assert 8 * err <= err_1x, (err, err_1x)

    def test_gram_project_live_split(self, cuda_device):
        torch.manual_seed(1)
        x = torch.randn((4, 256, 512), device=cuda_device)
        v = torch.randn((512, 1000), device=cuda_device)
        ref = gram_project_ref(x, v)
        q1 = matmul_1xtf32(x.transpose(1, 2), matmul_1xtf32(x, v))
        err = float((batched_gram_project(x, v).double()
                     - ref.double()).abs().max())
        emulated = torch.linalg.vector_norm(q1, dim=1) / 256
        err_1x = float((emulated.double() - ref.double()).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
        assert 8 * err <= err_1x, (err, err_1x)

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_featurize_gram_runs_are_bit_equal(self, cuda_device,
                                               compute_dtype):
        torch.manual_seed(2)
        x = torch.randn((3, 200, 784), device=cuda_device)
        w = torch.randn((784, 300), device=cuda_device) / 300 ** 0.5
        out = batched_featurize_gram(x, w, compute_dtype)
        assert torch.equal(out, batched_featurize_gram(x, w, compute_dtype))

    def test_gram_project_runs_are_bit_equal(self, cuda_device):
        torch.manual_seed(2)
        x = torch.randn((3, 100, 512), device=cuda_device)
        v = torch.randn((512, 300), device=cuda_device)
        assert torch.equal(batched_gram_project(x, v),
                           batched_gram_project(x, v))

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_featurize_gram_ragged_edges(self, cuda_device, compute_dtype):
        # c, m and d off every tile (rows 64/32/16, k-stages 32/16,
        # 16-byte copies, 8-column W rows, Gram tile 128, slabs 256/512),
        # every row tile of the plan (d = 1500: 16 rows in fp32; d = 3200:
        # 16 rows and a one-stage ring in fp32), and a row-chunk view of a
        # larger stack (users a stride apart).
        torch.manual_seed(3)
        tol = 1e-5 if compute_dtype == "fp32" else 2e-2
        for n_users, c, m, d in [(3, 71, 197, 131), (2, 65, 1001, 257),
                                 (2, 33, 50, 1029), (2, 37, 90, 1500),
                                 (1, 21, 40, 3200)]:
            x = torch.randn((n_users, c, m), device=cuda_device)
            w = torch.randn((m, d), device=cuda_device) / d ** 0.5
            out = batched_featurize_gram(x, w, compute_dtype)
            close(out, featurize_gram_ref(x, w, compute_dtype), tol)
            assert torch.equal(out, out.transpose(1, 2))
        stack = torch.randn((3, 90, 200), device=cuda_device)
        w = torch.randn((200, 96), device=cuda_device)
        view = stack[:, 13:80]
        close(batched_featurize_gram(view, w, compute_dtype),
              featurize_gram_ref(view, w, compute_dtype), tol)

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_featurize_gram_accumulates_symmetric(self, cuda_device,
                                                  compute_dtype):
        # out= a non-zero symmetric Gram: the sum stays symmetric bit for
        # bit.
        torch.manual_seed(4)
        tol = 1e-5 if compute_dtype == "fp32" else 2e-2
        x = torch.randn((3, 150, 640), device=cuda_device)
        w = torch.randn((640, 384), device=cuda_device) / 384 ** 0.5
        a = torch.randn((3, 384, 384), device=cuda_device)
        acc = a + a.transpose(1, 2)
        expect = acc + featurize_gram_ref(x, w, compute_dtype)
        out = batched_featurize_gram(x, w, compute_dtype, out=acc)
        assert out is acc
        close(out, expect, tol)
        assert torch.equal(out, out.transpose(1, 2))

    def test_gram_project_ragged_edges(self, cuda_device):
        # n, d and K off every tile (16 rows, depth 128, slabs 64/32/16/8).
        torch.manual_seed(5)
        for n_users, n, d, k in [(3, 37, 131, 77), (2, 19, 1029, 67),
                                 (2, 50, 2000, 21), (1, 5, 7, 9)]:
            x = torch.randn((n_users, n, d), device=cuda_device)
            v = torch.randn((d, k), device=cuda_device)
            close(batched_gram_project(x, v), gram_project_ref(x, v))

    def test_plans_match_the_kernels(self, cuda_device):
        from repro_torch.kernels import build
        from repro_torch.kernels.featurize_gram import ops as fg_ops
        from repro_torch.kernels.assign import ops as assign_ops
        from repro_torch.kernels.gram import ops as gram_ops
        from repro_torch.kernels.gram_project import ops as gp_ops

        lib = build.library()
        for d in (3, 100, 512, 900, 1500, 2048):
            for cd in ("fp32", "bf16"):
                plan = fg_ops.featurize_plan(d, cd)
                assert lib.repro_featurize_gram_smem(
                    d, plan.rows, plan.stages, int(cd == "bf16")) == plan.smem
            plan = gp_ops.project_plan(d)
            assert lib.repro_gram_project_smem(d, plan.bk, plan.stages) \
                == plan.smem
        for d in (1, 5, 127, 128, 129, 512, 784):
            plan = gram_ops.gram_plan(d)
            assert gram_ops.kernel_plan(d) == (plan.smem, len(plan.pairs),
                                               plan.route)
        for args in [(128, 4, 512, 8), (16, 3, 1024, 64), (1, 1, 16, 1),
                     (5, 33, 130, 13), (3, 2, 40, 200)]:
            for cd in ("fp32", "bf16"):
                plan = assign_ops.one_plan(*args, 132, cd)
                assert lib.repro_assign_one_smem(
                    plan.slice_rows, plan.v_rows, plan.stages,
                    int(cd == "bf16")) \
                    == plan.smem

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

    @pytest.mark.parametrize("linkage", LINKAGES)
    @pytest.mark.parametrize("case", ["grid", "nan", "inf_rows"])
    def test_nn_chain_corners(self, cuda_device, linkage, case):
        """Ties on a 1/8 grid, NaN entries, an all--inf row and a row past
        FLT_MAX / 2: merges, heights and the step count equal the plain
        loop's, the counters the plain model's of the cache."""
        rng = np.random.default_rng(11)
        if case == "grid":
            r = rng.integers(0, 8, size=(200, 200)) / 8
            s = t(np.maximum(r, r.T))
        else:
            r = rng.uniform(size=(41, 41))
            s = t((r + r.T) / 2)
        s.fill_diagonal_(float("-inf"))
        if case == "nan":
            s[2, 7] = s[7, 2] = s[11, 30] = float("nan")
        if case == "inf_rows":
            s[5, :] = s[:, 5] = float("-inf")
            s[3, :] = s[:, 3] = 3e38
            s[3, 3] = float("-inf")
        got = lk_ops._nn_chain_counted(s.to(cuda_device), linkage)
        want = nn_chain_ref(s.clone(), linkage)
        model = nn_chain_cached_ref(s.clone(), linkage)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert int(got[2][0]) == int(want[2])
        assert got[2].tolist()[1:] == [model[3]["iterations"],
                                       model[3]["rescans"]]

    @pytest.mark.parametrize("linkage", LINKAGES)
    @pytest.mark.parametrize("b,n", [(6, 12), (8, 128), (5, 200),
                                     (3, 1024)])
    def test_nn_chain_grouped(self, cuda_device, linkage, b, n):
        """The group axis, one block a group, against G single calls and
        the plain loop: merges, heights and steps exact, one launch a
        call; a NaN in group 1 stops that group alone."""
        rng = np.random.default_rng(b * n)
        r = rng.uniform(size=(b, n, n))
        s = t((r + r.transpose(0, 2, 1)) / 2).to(cuda_device)
        s.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
        s[1, 2, 7] = s[1, 7, 2] = float("nan")
        before = dispatch.LAUNCHES["linkage"]
        merges, heights, steps = nn_chain_grouped(s.clone(), linkage)
        assert dispatch.LAUNCHES["linkage"] == before + 1
        for i in range(b):
            m1, h1, st1 = nn_chain(s[i].clone(), linkage)
            assert torch.equal(merges[i], m1)
            assert torch.equal(heights[i], h1)
            assert int(steps[i]) == int(st1)
        done = steps.cpu().numpy() == n - 1
        assert not done[1] and np.delete(done, 1).all()
        if n <= 200:
            want = nn_chain_grouped_ref(s.cpu().clone(), linkage)
            assert torch.equal(merges.cpu(), want[0])
            assert torch.equal(heights.cpu(), want[1])
            assert torch.equal(steps.cpu(), want[2])

    def test_cut_device_grouped(self, cuda_device):
        rng = np.random.default_rng(3)
        r = rng.uniform(size=(7, 128, 128))
        s = t((r + r.transpose(0, 2, 1)) / 2).to(cuda_device)
        s.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
        merges, heights, _ = nn_chain_grouped(s)
        for n_clusters in (1, 4, 128):
            got = cut_device_grouped(merges, heights, 128, n_clusters)
            for i in range(7):
                assert torch.equal(got[i], cut_device(merges[i], heights[i],
                                                      128, n_clusters))

    @pytest.mark.parametrize("group_batch", [0, 3])
    def test_hierarchical_matches_cpu(self, cuda_device, group_batch):
        """The two-level protocol on the card against the CPU: the same
        partition and group-local labels, entry spectra to 1e-4, and one
        eigproject and one NN-chain launch a batch of groups, plus the
        global stage's chain."""
        feats, tasks = make_task_feature_mixture(256, 32, 64, 4, seed=2)
        cfg = SimilarityConfig(top_k=8)
        hcfg = HierarchyConfig(n_groups=8, group_batch=group_batch)
        dispatch.reset_launches()
        on_card = hierarchical_one_shot(feats, 4, cfg=cfg,
                                        hierarchy_cfg=hcfg,
                                        device=cuda_device)
        batches = -(-8 // (group_batch or 8))
        assert dispatch.LAUNCHES["eigproject"] == batches
        assert dispatch.LAUNCHES["gram"] == batches
        assert dispatch.LAUNCHES["linkage"] == batches + 1
        on_cpu = hierarchical_one_shot(feats, 4, cfg=cfg,
                                       hierarchy_cfg=hcfg, device="cpu")
        assert clu.clustering_accuracy(host(on_card.labels), tasks) == 1.0
        assert same_partition(on_card.labels, on_cpu.labels)
        assert torch.equal(on_card.local_labels.cpu(), on_cpu.local_labels)
        np.testing.assert_allclose(host(on_card.entry_lam),
                                   host(on_cpu.entry_lam), rtol=1e-4)

    def test_nn_chain_2048(self, cuda_device):
        r = np.random.default_rng(6).uniform(size=(2048, 2048))
        s = t((r + r.T) / 2).to(cuda_device)
        s.fill_diagonal_(float("-inf"))
        assert chain_plan(2048).route == "smem"
        a = nn_chain(s.clone())
        b = nn_chain_ref(s.clone())
        assert int(a[2]) == int(b[2]) == 2047
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_nn_chain_past_shared_memory(self, cuda_device):
        """20,000 leaves, where the per-leaf state lives in device scratch
        (the wrapper refused n past 19,370 before): every merge is done
        and the cut at 4 clusters recovers the 4 blocks of R."""
        n, blocks = 20000, 4
        assert chain_plan(n).route == "scratch"
        lab = torch.arange(n, device=cuda_device) * blocks // n
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        s = torch.rand((n, n), generator=gen, device=cuda_device) * 0.1
        s = (s + s.T) / 2 + torch.where(lab[:, None] == lab[None, :], 0.8,
                                        0.1)
        s.fill_diagonal_(float("-inf"))
        merges, heights, steps = nn_chain(s)
        assert int(steps) == n - 1
        del s
        assert same_partition(cut_device(merges, heights, n, blocks), lab)

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

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    def test_assign_kernels(self, cuda_device, dtype, compute_dtype):
        torch.manual_seed(0)
        tol = 1e-4 if compute_dtype == "fp32" else 1e-5
        for b, n_protos, d, k in [(1, 4, 512, 8), (13, 130, 100, 3),
                                  (9, 1, 64, 8), (2, 3, 128, 128),
                                  (200, 5, 100, 8), (300, 33, 64, 3),
                                  (1100, 2, 64, 8)]:
            v = torch.randn((b, d, k), device=cuda_device)
            p = torch.randn((n_protos, d, d), device=cuda_device)
            mask = (torch.rand(n_protos, device=cuda_device) > 0.2).float()
            mask[0] = 1.0
            table, scales = quant.quantize_directory(p, dtype)
            cases = [("assign_wave", assign(v, table, mask, compute_dtype,
                                            scales=scales),
                      assign_wave_plain(v, table, scales, mask,
                                        compute_dtype))]
            if dtype != "int8":
                cases.append(("assign_one",
                              assign_looped(v, table, mask, compute_dtype),
                              assign_looped_plain(v, table, mask,
                                                  compute_dtype)))
            for name, got, want in cases:
                aff, margin = got[0] * k, got[2] * k
                assert torch.equal(torch.isinf(aff), torch.isinf(want[0]))
                fin = torch.isfinite(want[0])
                scale = float(want[0][fin].abs().max())
                close(aff[fin], want[0][fin], tol)
                assert torch.equal(torch.isnan(margin),
                                   torch.isnan(want[2])), name
                assert torch.equal(torch.isinf(margin),
                                   torch.isinf(want[2])), name
                m_fin = torch.isfinite(want[2])
                m_err = float((margin[m_fin].double()
                               - want[2][m_fin].double()).abs().max())
                assert m_err <= 2 * tol * scale, (name, m_err)
                decided = want[2] > tol * scale
                assert torch.equal(got[1][decided], want[1][decided]), name

    @pytest.mark.parametrize("d,k", [(16, 1), (130, 13), (512, 8),
                                     (1024, 64)])
    @pytest.mark.parametrize("n_protos", [1, 4, 33])
    @pytest.mark.parametrize("b", [1, 5, 128])
    def test_assign_one_tensor_cores(self, cuda_device, b, n_protos, d, k):
        """The redesigned assign_one over the dtype grid: every table
        dtype x compute dtype, a dead prototype, T = 1, and (d, k) whose
        V is staged in chunks of d; one launch, two runs bit-equal."""
        torch.manual_seed(b * 100 + n_protos)
        v = torch.randn((b, d, k), device=cuda_device)
        p = torch.randn((n_protos, d, d), device=cuda_device)
        mask = torch.ones(n_protos, device=cuda_device)
        if n_protos > 2:
            mask[2] = 0.0
        for dtype in ("f32", "bf16", "int8"):
            table, _ = quant.quantize_directory(p, dtype)
            for cd in ("fp32", "bf16"):
                tol = 1e-4 if cd == "fp32" else 1e-5
                before = dispatch.LAUNCHES["assign_one"]
                got = assign_looped(v, table, mask, cd)
                assert dispatch.LAUNCHES["assign_one"] == before + 1
                want = assign_looped_plain(v, table, mask, cd)
                aff, margin = got[0] * k, got[2] * k
                assert torch.equal(torch.isinf(aff), torch.isinf(want[0]))
                fin = torch.isfinite(want[0])
                scale = float(want[0][fin].abs().max())
                close(aff[fin], want[0][fin], tol)
                assert torch.equal(torch.isnan(margin), torch.isnan(want[2]))
                m_fin = torch.isfinite(want[2])
                assert float((margin[m_fin] - want[2][m_fin]).abs().max()
                             ) <= 2 * tol * scale
                decided = want[2] > tol * scale
                assert torch.equal(got[1][decided], want[1][decided])
                if n_protos == 1:
                    assert torch.equal(got[2], got[0][:, 0])
                again = assign_looped(v, table, mask, cd)
                assert all(torch.equal(x, y) for x, y in zip(got, again))

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_assign_bf16_differs_from_fp32(self, cuda_device, fn):
        torch.manual_seed(1)
        v = torch.randn((16, 512, 8), device=cuda_device)
        p = torch.randn((4, 512, 512), device=cuda_device)
        a32 = fn(v, p, None, "fp32")[0]
        gap = float((fn(v, p, None, "bf16")[0] - a32).abs().max())
        assert gap > 1e-4 * float(a32.abs().max()), gap

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_assign_edges(self, cuda_device, fn):
        v = torch.randn((11, 64, 4), device=cuda_device)
        p = torch.randn((3, 64, 64), device=cuda_device)
        before = dict(dispatch.LAUNCHES)
        _, lab, mar = fn(v, torch.cat([p[:1], p[:1]]), None, "bf16")
        assert bool((lab == 0).all()) and bool((mar == 0).all())
        _, lab, mar = fn(v, p, torch.zeros(3, device=cuda_device), "fp32")
        assert bool((lab == 0).all()) and bool(torch.isnan(mar).all())
        _, lab, mar = fn(v, p, torch.tensor([0.0, 1.0, 0.0],
                                            device=cuda_device), "fp32")
        assert bool((lab == 1).all()) and bool(torch.isinf(mar).all())
        aff, lab, mar = fn(v, p[:1], None, "fp32")
        assert torch.equal(mar, aff[:, 0])
        name = "assign_wave" if fn is assign else "assign_one"
        assert dispatch.LAUNCHES[name] == before[name] + 4

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("n_protos", [1, 4, 7, 128])
    def test_assign_wave_tensor_cores(self, cuda_device, dtype, n_protos):
        """The bf16 wave kernel: B off the 64-arrival tile, d of 64 and
        512, dead prototypes and an exact tie (the first index wins)."""
        torch.manual_seed(n_protos)
        for b, d, k in [(100, 64, 8), (130, 512, 8), (3, 64, 3)]:
            v = torch.randn((b, d, k), device=cuda_device)
            p = torch.randn((n_protos, d, d), device=cuda_device)
            if n_protos > 1:
                p[1] = p[0]
            mask = torch.ones(n_protos, device=cuda_device)
            if n_protos > 2:
                mask[2::3] = 0.0
            table, scales = quant.quantize_directory(p, dtype)
            before = dispatch.LAUNCHES["assign_wave"]
            got = assign(v, table, mask, "bf16", scales=scales)
            assert dispatch.LAUNCHES["assign_wave"] == before + 1
            want = assign_wave_plain(v, table, scales, mask, "bf16")
            aff, margin = got[0] * k, got[2] * k
            assert torch.equal(torch.isinf(aff), torch.isinf(want[0]))
            fin = torch.isfinite(want[0])
            scale = float(want[0][fin].abs().max())
            close(aff[fin], want[0][fin], 1e-5)
            assert torch.equal(torch.isnan(margin), torch.isnan(want[2]))
            m_fin = torch.isfinite(want[2])
            assert float((margin[m_fin] - want[2][m_fin]).abs().max()
                         ) <= 2e-5 * scale
            decided = want[2] > 1e-5 * scale
            assert torch.equal(got[1][decided], want[1][decided])
            if n_protos > 1:
                assert torch.equal(aff[:, 1], aff[:, 0])
                assert not bool((got[1] == 1).any())

    def test_assign_wave_runs_are_bit_equal(self, cuda_device):
        """The partial sums are added in a fixed order: two runs on the
        same inputs give the same bits."""
        torch.manual_seed(2)
        v = torch.randn((300, 512, 8), device=cuda_device)
        p = torch.randn((128, 512, 512), device=cuda_device)
        first = assign(v, p, None, "bf16")
        second = assign(v, p, None, "bf16")
        for x, y in zip(first, second):
            assert torch.equal(x, y)

    def test_landmarks_and_membership_match_cpu(self, cuda_device):
        from repro_torch.core.membership_engine import (MembershipConfig,
                                                        MembershipEngine)

        feats, tasks = make_task_feature_mixture(64, 32, 32, 4, seed=4)
        cfg = SimilarityConfig(top_k=4, landmarks=16)
        ccfg = ClusterConfig(backend="torch")
        dispatch.reset_launches()
        on_card = one_shot_clustering(feats, 4, cfg=cfg, cluster_cfg=ccfg,
                                      device=cuda_device)
        assert dispatch.LAUNCHES["assign_wave"] == 1
        on_cpu = one_shot_clustering(feats, 4, cfg=cfg, cluster_cfg=ccfg,
                                     device="cpu")
        np.testing.assert_allclose(host(on_card.similarity),
                                   host(on_cpu.similarity), atol=2e-3)
        assert same_partition(on_card.labels, on_cpu.labels)
        assert clu.clustering_accuracy(host(on_card.labels), tasks) == 1.0
        engines = [MembershipEngine.from_oneshot(on_cpu, MembershipConfig(),
                                                 device=dev)
                   for dev in (cuda_device, "cpu")]
        wave, _ = make_task_feature_mixture(16, 32, 32, 4, seed=5)
        from repro_torch.core.engine import ProtocolEngine
        lam, v, _ = ProtocolEngine(SimilarityConfig(top_k=4),
                                   device="cpu").signatures(wave)
        outs = [e.assign(lam, v) for e in engines]
        np.testing.assert_array_equal(host(outs[0].labels),
                                      host(outs[1].labels))
        for e, out in zip(engines, outs):
            e.admit(lam, v, out.labels)
        np.testing.assert_allclose(host(engines[0].state.protos),
                                   host(engines[1].state.protos), atol=1e-5)


    def test_sharded_protocol_one_rank_over_nccl(self, cuda_device):
        """The sharded protocol on a one-rank NCCL group: R within 1e-5 of
        the dense path's, the same labels, and one launch each of gram,
        eigproject and the NN-chain."""
        import dataclasses

        from _torch_dist_support import one_rank_world

        feats, tasks = make_task_feature_mixture(64, 32, 64, 4, seed=6)
        cfg = SimilarityConfig(top_k=8)
        ccfg = ClusterConfig(backend="torch")
        dense = one_shot_clustering(feats, 4, cfg=cfg, cluster_cfg=ccfg,
                                    device=cuda_device)
        with one_rank_world("data", "cuda") as mesh:
            dispatch.reset_launches()
            sharded = one_shot_clustering(
                feats, 4, cfg=dataclasses.replace(cfg, backend="shard_map"),
                cluster_cfg=ccfg, device=cuda_device, mesh=mesh)
            torch.cuda.synchronize()
            launches = dict(dispatch.LAUNCHES)
        close(sharded.similarity, dense.similarity)
        assert sharded.similarity.device.type == "cuda"
        for name in ("gram", "eigproject", "linkage"):
            assert launches[name] == 1, launches
        assert torch.equal(sharded.labels, dense.labels)
        assert clu.clustering_accuracy(host(sharded.labels), tasks) == 1.0


    def test_sharded_trainer_one_rank_over_nccl(self, cuda_device):
        """train_mthfl with its cluster axis sharded over a one-rank NCCL
        group: the fused path's losses and accuracies bit for bit (the
        gathers copy, the all_reduce adds nothing)."""
        import dataclasses

        from _torch_dist_support import one_rank_world, port_mlp_models
        from repro_torch.data.partition import UserData
        from repro_torch.fed.trainer import MTHFLConfig, train_mthfl
        from repro_torch.models import mlp

        rng = np.random.default_rng(0)
        users = [UserData(user_id=i, task_id=i % 3,
                          x=rng.standard_normal((n, 12)).astype(np.float32),
                          y=rng.integers(0, 4, n).astype(np.int32),
                          task_classes=(0, 1, 2, 3))
                 for i, n in enumerate([40, 25, 33, 30, 8])]
        labels = np.array([0, 1, 2, 0, 2])
        evals = [(u.x, u.y) for u in users[:3]]
        models = port_mlp_models(mlp.PaperMLPConfig(m=12, hidden=8,
                                                    n_classes=4), 3)
        cfg = MTHFLConfig(global_rounds=2, local_rounds=2, local_steps=3,
                          batch_size=8)
        fused = train_mthfl(users, labels, models, evals, cfg, fused=True,
                            device=cuda_device)
        with one_rank_world("clusters", "cuda") as mesh:
            sharded = train_mthfl(
                users, labels, models, evals,
                dataclasses.replace(cfg, backend="shard_map"), fused=True,
                device=cuda_device, mesh=mesh)
        assert np.array_equal(sharded.train_loss, fused.train_loss)
        assert np.array_equal(sharded.accuracy, fused.accuracy)


@pytest.mark.gpu
class TestLMKernelsOnCard:
    """flash_attention, wkv_chunked and linear_scan against their plain
    versions on the card."""

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_flash(self, cuda_device, hd, dtype):
        torch.manual_seed(hd)
        for b, s, skv, h in [(2, 100, 100, 3), (1, 257, 257, 2),
                             (1, 70, 130, 2)]:
            q = torch.randn((b, s, h, hd), device=cuda_device).to(dtype)
            k = torch.randn((b, skv, h, hd), device=cuda_device).to(dtype)
            v = torch.randn((b, skv, h, hd), device=cuda_device).to(dtype)
            for causal, window in [(True, 0), (True, 48), (True, 130),
                                   (False, 0), (False, 33), (False, 130)]:
                before = dispatch.LAUNCHES["flash_attention"]
                out = flash_attention(q, k, v, causal=causal, window=window)
                assert dispatch.LAUNCHES["flash_attention"] == before + 1
                assert out.dtype == dtype and out.shape == q.shape
                want = flash_ref(q.float(), k.float(), v.float(), causal,
                                 window)
                if dtype == torch.float32:
                    close(out, want)
                else:
                    close_bf16(out, want)

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    def test_flash_tensor_cores_fp32_out(self, cuda_device, hd):
        """bf16 inputs through the tensor-core kernel with fp32 output,
        against the fp32 function of the same values, to 1e-5 x
        max|plain|: ragged S and Skv, windows over several key tiles and
        of one key, bidirectional.  S <= Skv, so every row sees a key
        (a row that sees none is 0 in the kernels and the mean of V in the
        plain version)."""
        torch.manual_seed(hd + 1)
        for b, s, skv, h in [(2, 100, 100, 3), (1, 257, 257, 2),
                             (1, 70, 130, 2), (1, 200, 300, 1)]:
            q, k, v = (torch.randn((b, n, h, hd), device=cuda_device
                                   ).to(torch.bfloat16)
                       for n in (s, skv, skv))
            for causal, window in [(True, 0), (True, 1), (True, 150),
                                   (False, 0), (False, 1), (False, 130)]:
                before = dispatch.LAUNCHES["flash_attention"]
                out = _flash_attention_fp32_out(q, k, v, causal, window)
                assert dispatch.LAUNCHES["flash_attention"] == before + 1
                assert out.dtype == torch.float32 and out.shape == q.shape
                close(out, flash_ref(q.float(), k.float(), v.float(),
                                     causal, window))

    def test_flash_tensor_cores_misaligned_view(self, cuda_device):
        base = torch.randn(70 * 2 * 64 + 1, device=cuda_device).to(
            torch.bfloat16)
        q = base[1:].view(1, 70, 2, 64)
        assert q.data_ptr() % 16
        close(_flash_attention_fp32_out(q, q, q),
              flash_ref(q.float(), q.float(), q.float()))

    def test_flash_reads_misaligned_views(self, cuda_device):
        base = torch.randn(70 * 2 * 64 + 1, device=cuda_device)
        q = base[1:].view(1, 70, 2, 64)
        assert q.data_ptr() % 16
        close(flash_attention(q, q, q), flash_ref(q, q, q))

    def test_flash_rejects_other_head_dims(self, cuda_device):
        q = torch.zeros((1, 8, 2, 48), device=cuda_device)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, q, q)

    @pytest.mark.parametrize("hd", [32, 64])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_wkv(self, cuda_device, hd, dtype, compute_dtype):
        """The chunk form on the tensor cores.  fp32 compute: out and state
        within 1e-5 of the largest entry of the sequential oracle and of
        the plain chunk form (out rounded to bf16: 2^-8).  bf16 compute:
        out and state within 2^-8 of the plain chunk form with its bf16
        roundings.  Ragged sub-chunks, and decays down to -exp(randn + 2)
        with nothing non-finite."""
        torch.manual_seed(hd)
        cases = [(1, 1, 2, 0.0), (2, 7, 3, 0.0), (1, 16, 2, 0.0),
                 (2, 17, 3, 0.0), (4, 64, 32, 0.0), (2, 130, 2, 0.0),
                 (1, 200, 2, 0.0), (2, 200, 2, 2.0)]
        for b, s, h, shift in cases:
            r, k, v = (torch.randn((b, s, h, hd), device=cuda_device
                                   ).to(dtype) for _ in range(3))
            logw = -torch.exp(torch.randn((b, s, h, hd), device=cuda_device)
                              + shift)
            u = torch.randn((h, hd), device=cuda_device)
            st = torch.randn((b, h, hd, hd), device=cuda_device)
            before = dispatch.LAUNCHES["wkv_chunked"]
            out, new_st = wkv_chunked(r, k, v, logw, u, st,
                                      compute_dtype=compute_dtype)
            assert dispatch.LAUNCHES["wkv_chunked"] == before + 1
            assert out.dtype == dtype and new_st.dtype == torch.float32
            assert bool(torch.isfinite(out).all()
                        and torch.isfinite(new_st).all())
            plain, plain_st = wkv_chunked_ref(r, k, v, logw, u, st,
                                              compute_dtype=compute_dtype)
            if compute_dtype == "fp32":
                tol = 1e-5 if dtype == torch.float32 else 2 ** -8
                want, want_st = wkv_ref(r, k, v, logw, u, st)
                close(out.float(), want, tol)
                close(out.float(), plain, tol)
                close(new_st, want_st)
                close(new_st, plain_st)
            else:
                close(out.float(), plain, 2 ** -8)
                close(new_st, plain_st, 2 ** -8)

    def test_wkv_misaligned_view(self, cuda_device):
        base = torch.randn(2 * 20 * 2 * 32 + 1, device=cuda_device)
        r = base[1:].view(2, 20, 2, 32)
        assert r.data_ptr() % 16
        logw = -torch.exp(r)
        u = torch.randn((2, 32), device=cuda_device)
        st = torch.randn((2, 2, 32, 32), device=cuda_device)
        out, new_st = wkv_chunked(r, r, r, logw, u, st, compute_dtype="fp32")
        want, want_st = wkv_ref(r, r, r, logw, u, st)
        close(out, want)
        close(new_st, want_st)

    def test_linear_scan(self, cuda_device):
        torch.manual_seed(0)
        for b, s, d in [(1, 1, 100), (2, 77, 1000), (1, 2048, 4096),
                        (1, 4096, 4097), (3, 77, 512)]:
            log_a = -torch.exp(torch.randn((b, s, d), device=cuda_device) - 1)
            x = torch.randn((b, s, d), device=cuda_device)
            h0 = torch.randn((b, d), device=cuda_device)
            before = dispatch.LAUNCHES["linear_scan"]
            h, h_last = linear_scan(log_a, x, h0)
            assert dispatch.LAUNCHES["linear_scan"] == before + 1
            want, want_last = linear_scan_ref(log_a, x, h0)
            assert torch.equal(h, want) and torch.equal(h_last, want_last)

    def test_linear_scan_misaligned_and_rerun(self, cuda_device):
        """A view 4 bytes off 16 (the 4-byte cp.async route), D off the
        warp and off 16 bytes, B > 1 with S off the stage: equal to the
        plain version, and two runs bit-equal."""
        torch.manual_seed(1)
        b, s, d = 2, 300, 1024
        buf = torch.randn(2 * b * s * d + 1, device=cuda_device)
        log_a = -torch.exp(buf[1:1 + b * s * d].view(b, s, d) - 1)
        log_a = torch.empty(b * s * d + 1, device=cuda_device)[1:].view(
            b, s, d).copy_(log_a)
        x = buf[1 + b * s * d:].view(b, s, d)
        assert log_a.data_ptr() % 16 and x.data_ptr() % 16
        assert linear_scan_plan(b, s, d, False).route == "cp.async4"
        h0 = torch.randn((b, d), device=cuda_device)
        for args in [(log_a, x, h0)] + [
                (-torch.exp(torch.randn((b_, s_, d_), device=cuda_device)),
                 torch.randn((b_, s_, d_), device=cuda_device),
                 torch.randn((b_, d_), device=cuda_device))
                for b_, s_, d_ in [(1, 4096, 4097), (3, 77, 512),
                                   (2, 5, 6)]]:
            h, h_last = linear_scan(*args)
            want, want_last = linear_scan_ref(*args)
            assert torch.equal(h, want) and torch.equal(h_last, want_last)
            again = linear_scan(*args)
            assert torch.equal(h, again[0]) and torch.equal(h_last,
                                                            again[1])

    def test_scan_and_chain_plans_match_the_kernels(self, cuda_device):
        from repro_torch.kernels.recurrent_scan import ops as rs_ops

        for args in [(1, 4096, 4096, True), (1, 4096, 4097, True),
                     (3, 77, 512, False), (1, 0, 8, True), (2, 5, 12, True)]:
            assert rs_ops.kernel_scan_plan(*args) == linear_scan_plan(*args)
        for n in (0, 2, 1024, 11019, 11020, 19371, 20000):
            assert lk_ops.kernel_chain_plan(n) == chain_plan(n)

    @pytest.mark.parametrize("arch", ["qwen3_1_7b", "rwkv6_1_6b",
                                      "recurrentgemma_9b"])
    def test_reduced_forward_matches_cpu(self, cuda_device, arch):
        """A REDUCED config's forward through the kernels on the card
        against the plain versions on the CPU, same weights."""
        import dataclasses

        from repro_torch.configs.base import get_arch
        from repro_torch.models.registry import get_model

        cfg = dataclasses.replace(get_arch(arch, reduced=True),
                                  attn_impl="pallas", rec_impl="pallas")
        m = get_model(cfg)
        params = m.init(0, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 80),
                             generator=torch.Generator().manual_seed(0))
        want, _ = m.forward(params, {"tokens": toks})
        dispatch.reset_launches()
        got, _ = m.forward(params.to(cuda_device),
                           {"tokens": toks.to(cuda_device)})
        assert sum(dispatch.LAUNCHES[k] for k in (
            "flash_attention", "wkv_chunked", "linear_scan")) == 2
        close(got.cpu(), want, 1e-4)


@pytest.mark.gpu
class TestTrainingOnCard:
    """LM training on the card: the kernels refuse inputs that require
    grad under grad mode and launch under ``no_grad``; a REDUCED train
    step on the card matches the same step on the CPU."""

    def test_kernels_refuse_grad_and_launch_without(self, cuda_device):
        g = torch.Generator(device=cuda_device).manual_seed(0)

        def r(*shape):
            return torch.randn(*shape, generator=g, device=cuda_device)

        calls = {
            "flash_attention": lambda x: flash_attention(
                x(1, 64, 2, 64), x(1, 64, 2, 64), x(1, 64, 2, 64)),
            "wkv_chunked": lambda x: wkv_chunked(
                x(1, 64, 2, 64), x(1, 64, 2, 64), x(1, 64, 2, 64),
                -x(1, 64, 2, 64).abs(), x(2, 64), x(1, 2, 64, 64)),
            "linear_scan": lambda x: linear_scan(
                -x(1, 64, 32).abs(), x(1, 64, 32), x(1, 32)),
        }
        for name, call in calls.items():
            dispatch.reset_launches()
            with pytest.raises(RuntimeError, match=f"{name}: the CUDA "
                                                   f"kernel has no backward"):
                call(lambda *sh: r(*sh).requires_grad_(True))
            assert dispatch.LAUNCHES[name] == 0
            with torch.no_grad():
                out = call(lambda *sh: r(*sh).requires_grad_(True))
            call(r)
            torch.cuda.synchronize()
            assert dispatch.LAUNCHES[name] == 2, name
            out = out[0] if isinstance(out, tuple) else out
            assert out.grad_fn is None and torch.isfinite(out).all()

    def test_reduced_train_step_matches_cpu(self, cuda_device):
        """The first step of ``launch/train.py`` on REDUCED fp32 qwen3:
        the loss and the gradients' global norm on the card within 1e-4 x
        max(1, |loss|) (relative for the norm) of the CPU's, on the same
        weights and batch; the step runs and leaves finite parameters."""
        from repro_torch import optim
        from repro_torch.configs.base import get_arch
        from repro_torch.launch import train as launch_train
        from repro_torch.models.registry import get_model

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = get_arch("qwen3_1_7b", reduced=True)
        m = get_model(cfg)
        raw = next(launch_train.batch_stream(cfg, 2, 64))
        out = []
        for dev in (torch.device("cpu"), cuda_device):
            model = m.init(0, device="cpu").to(dev)
            model.requires_grad_(True)
            batch = launch_train.make_batch(cfg, raw, 0, dev)
            loss = m.loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out.append((float(loss),
                        float(optim.global_norm(dict(enumerate(grads))))))
            opt = launch_train.make_optimizer(3e-3, 10)
            state = opt.init(dict(model.named_parameters()))
            for _ in range(2):
                state, _ = launch_train.train_step(m, model, opt, state,
                                                   batch)
            assert all(torch.isfinite(p).all() for p in model.parameters())
        (l_c, n_c), (l_g, n_g) = out
        bar = 1e-4 * max(1.0, abs(l_c))
        assert abs(l_g - l_c) <= bar and abs(n_g - n_c) <= bar * n_c


@pytest.mark.gpu
class TestTelemetryOnCard:
    """``repro_torch.obs`` on the card: a span synchronises the devices
    of the tensors it was given before it reads the clock, and
    ``kernel_calls`` counts the wrappers' real launches."""

    def test_span_syncs_and_counts_launches(self, cuda_device):
        from repro_torch import obs

        x = torch.randn(256, 256, 512, device=cuda_device)
        batched_gram_matrix(x)                     # build and warm up
        torch.cuda.synchronize()
        obs.reset()
        dispatch.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        try:
            with obs.scope(True):
                with obs.span("gram") as sp:
                    start.record()
                    for _ in range(8):
                        out = batched_gram_matrix(x)
                    end.record()
                    sp.sync({"out": [out]})
                assert end.query()                 # synchronised at exit
            (rec,) = obs.trace_records()
            assert rec["dur_us"] >= start.elapsed_time(end) * 1e3
            assert dispatch.LAUNCHES["gram"] == 8
            assert obs.counter_value("kernel_calls", kernel="gram") == 8
            assert obs.counter_value("dispatch_count") == 8
            assert obs.counter_value("retrace_count") == 0
        finally:
            obs.disable()
            obs.reset()


@pytest.fixture
def empty_tuner(monkeypatch):
    """An empty tuner cache with no file, before and after."""
    from repro_torch.kernels import tuning

    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    tuning.clear_cache()
    yield tuning
    tuning.clear_cache()


@pytest.mark.gpu
class TestTunerAndSpectralOnCard:
    """Each tunable wrapper under a cached plan that is not its default,
    held to its plain version at this file's tolerances; a cached plan
    that does not fit raises and launches nothing; spectral clustering on
    the card."""

    def test_non_default_plans(self, cuda_device, empty_tuner):
        from repro_torch import obs
        from repro_torch.kernels.assign import ops as assign_ops

        tuning = empty_tuner
        torch.manual_seed(0)
        sms = assign_ops._sm_count(torch.device("cuda", 0))
        b, n_protos, d, k = 128, 4, 512, 8
        v = torch.randn((b, d, k), device=cuda_device)
        p = torch.randn((n_protos, d, d), device=cuda_device)
        base = assign_ops.wave_plan(b, n_protos, d, sms)
        per = (2 * base.ksteps_per_slice if base.n_slices > 1
               else -(-base.ksteps // 2))
        n_slices = -(-base.ksteps // per)
        assert n_slices != base.n_slices
        tuning.record("assign_wave", {"n_slices": n_slices,
                                      "ksteps_per_slice": per},
                      device=cuda_device, b=b, t=n_protos, d=d, sms=sms)
        one = assign_ops.one_plan(b, n_protos, d, k, sms, "bf16")
        tuning.record("assign_one", {"slice_rows": 48 - one.slice_rows,
                                     "stages": 3}, device=cuda_device,
                      b=b, t=n_protos, d=d, k=k, sms=sms, itemsize=2)
        x = torch.randn((3, 256, d), device=cuda_device)
        w = torch.randn((d, 8), device=cuda_device)
        tuning.record("gram_project", {"bk": 16, "stages": 1},
                      device=cuda_device, b=3, n=256, d=d, k=8)
        log_a = -torch.exp(torch.randn((1, 4096, 4096), device=cuda_device)
                           - 1)
        xs = torch.randn((1, 4096, 4096), device=cuda_device)
        h0 = torch.randn((1, 4096), device=cuda_device)
        tuning.record("linear_scan", {"route": "cp.async4"},
                      device=cuda_device, b=1, s=4096, d=4096, aligned=1)
        try:
            with obs.scope(True):
                aff = assign(v, p, None, "bf16")[0] * k
                gauges = [obs.gauge_value("kernel_blocks", kernel="assign")]
                aff_one = assign_looped(v, p, None, "bf16")[0] * k
                gauges.append(obs.gauge_value("kernel_blocks",
                                              kernel="assign"))
                out = batched_gram_project(x, w)
                gauges.append(obs.gauge_value("kernel_blocks",
                                              kernel="gram_project"))
                h, h_last = linear_scan(log_a, xs, h0)
                gauges.append(obs.gauge_value("kernel_blocks",
                                              kernel="recurrent_scan"))
        finally:
            obs.disable()
            obs.reset()
        close(aff, assign_wave_plain(v, p, None, None, "bf16")[0])
        close(aff_one, assign_looped_plain(v, p, None, "bf16")[0])
        close(out, gram_project_ref(x, w))
        want, want_last = linear_scan_ref(log_a, xs, h0)
        assert torch.equal(h, want) and torch.equal(h_last, want_last)
        assert f"n_slices={n_slices}" in gauges[0].split(",")
        assert f"slice_rows={48 - one.slice_rows}" in gauges[1].split(",")
        assert "bk=16" in gauges[2].split(",")
        assert "route=cp.async4" in gauges[3].split(",")

    def test_cached_plan_that_does_not_fit_raises(self, cuda_device,
                                                  empty_tuner):
        tuning = empty_tuner
        x = torch.randn((2, 64, 2048), device=cuda_device)
        w = torch.randn((2048, 8), device=cuda_device)
        tuning.record("gram_project", {"bk": 64}, device=cuda_device, b=2,
                      n=64, d=2048, k=8)
        a = torch.randn((1, 64, 30), device=cuda_device)
        tuning.record("linear_scan", {"route": "tma"}, device=cuda_device,
                      b=1, s=64, d=30, aligned=1)
        before = dict(dispatch.LAUNCHES)
        with pytest.raises(ValueError, match="does not fit"):
            batched_gram_project(x, w)
        with pytest.raises(ValueError, match="TMA route"):
            linear_scan(a, a, torch.zeros((1, 30), device=cuda_device))
        assert dispatch.LAUNCHES == before

    def test_spectral_on_card(self, cuda_device):
        from repro_torch.core.cluster_engine import ClusterEngine

        rng = np.random.default_rng(5)
        sizes = [40, 30, 20, 10]
        lab = np.repeat(np.arange(4), sizes)
        r = np.where(lab[:, None] == lab[None, :], 0.9, 0.2) \
            + rng.uniform(-0.02, 0.02, (100, 100))
        r = ((r + r.T) / 2).astype(np.float32)
        got = ClusterEngine(device=cuda_device).spectral(r, 4, rng=3)
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert same_partition(got, lab)
        host_labels = ClusterEngine(ClusterConfig(backend="numpy")).spectral(
            r, 4, rng=3)
        assert same_partition(got, host_labels)


@pytest.mark.gpu
class TestMeshOnCard:
    """The launch family's mesh path on the card: a one-rank NCCL group,
    a (1, 1) ("data", "model") mesh."""

    def test_flash_through_local_map_is_bit_equal(self, cuda_device):
        """q, k, v as DTensors of the prefill's placements reach the
        kernel as their local (batch, head) shards through ``local_map``:
        one launch, the plain call's bits."""
        import os
        import tempfile

        import torch.distributed as dist

        from repro_torch.kernels.dispatch import on_local_shards
        from repro_torch.launch import mesh as ML
        from repro_torch.launch import sharding as SH

        torch.manual_seed(0)
        q, k, v = (torch.randn((2, 256, 16, 128), device=cuda_device)
                   .to(torch.bfloat16) for _ in range(3))
        want = flash_attention(q, k, v, causal=True)
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl", init_method="file://"
                                    f"{os.path.join(tmp, 'store')}",
                                    world_size=1, rank=0)
            try:
                mesh = ML.make_mesh((1, 1), ("data", "model"))
                spec = SH.P(("data",), None, "model", None)
                dq, dk, dv = (SH.attach({"t": t}, {"t": spec}, mesh)["t"]
                              for t in (q, k, v))
                before = dispatch.LAUNCHES["flash_attention"]
                got = on_local_shards(
                    "flash_attention", lambda a, b, c: flash_attention(
                        a, b, c, causal=True), (dq, dk, dv),
                    ("bshd",) * 3, "bshd", local="bh")
                assert dispatch.LAUNCHES["flash_attention"] == before + 1
                assert torch.equal(got.to_local(), want)
            finally:
                dist.destroy_process_group()
