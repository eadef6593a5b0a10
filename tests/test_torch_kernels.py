"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions against the reference Pallas
kernels in interpret mode, on the same numpy inputs.  Tolerance: fp32
sums taken in another order agree to rtol 1e-5; entries near zero from
cancellation get an absolute floor of 1e-5 of the largest entry.  The
linkage step is elementwise IEEE arithmetic plus an argmax, so it must
agree exactly.  featurize_gram in bf16 rounds F to bf16 on both sides;
a sum taken in another order can flip one rounding (one bf16 ulp is
3.9e-3 of the entry), so it is held to 2e-3 of the largest entry, and
to the reference's own 2e-2 against the fp32 function.  The CUDA
kernels are held against the plain versions on the card in
``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import CPU, host, t
from repro.core import similarity as ref_sim
from repro.kernels.eigproject import ops as ref_proj
from repro.kernels.featurize_gram import ops as ref_fg
from repro.kernels.gram import ops as ref_gram
from repro.kernels.gram_project import ops as ref_gp
from repro.kernels.linkage import linkage_step as ref_linkage_step
from repro.kernels.linkage import linkage_step_ref as ref_linkage_step_ref
from repro_torch.core import similarity as sim
from repro_torch.kernels import dispatch
from repro_torch.kernels.eigproject import (project_norms, project_norms_all,
                                            project_norms_all_ref,
                                            project_norms_ref)
from repro_torch.kernels.featurize_gram import (batched_featurize_gram,
                                                featurize_gram,
                                                featurize_gram_ref)
from repro_torch.kernels.gram import (batched_gram_matrix, gram_matrix,
                                      gram_ref)
from repro_torch.kernels.gram_project import (batched_gram_project,
                                              gram_project, gram_project_ref)
from repro_torch.kernels.linkage import (LINKAGES, linkage_step,
                                         linkage_step_ref, nn_chain,
                                         nn_chain_ref)


def close(out, ref, rtol=1e-5):
    out, ref = host(out), np.asarray(ref)
    assert out.shape == ref.shape
    floor = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=floor)


class TestGramPlain:
    @pytest.mark.parametrize("n,d", [(1, 1), (17, 5), (64, 16), (100, 130),
                                     (130, 33)])
    def test_matches_pallas(self, n, d):
        x = np.random.default_rng(n * 1000 + d).standard_normal(
            (n, d)).astype(np.float32)
        close(gram_ref(t(x)), ref_gram.gram_matrix(jnp.asarray(x),
                                                   interpret=True))

    def test_wrapper_on_cpu_is_plain(self):
        x = t(np.random.default_rng(1).standard_normal((3, 9, 7)))
        assert torch.equal(batched_gram_matrix(x), gram_ref(x))
        assert torch.equal(gram_matrix(x[0]), gram_ref(x[0]))

    @pytest.mark.parametrize("d", [12, 40])
    def test_ragged_batch_matches_pallas(self, d):
        rng = np.random.default_rng(d)
        counts = [5, 19, 1, 33]
        feats = [rng.standard_normal((c, d)).astype(np.float32)
                 for c in counts]
        pad, nv = sim.pad_ragged(feats, device=CPU)
        ref_pad, ref_nv = ref_sim.pad_ragged(feats)
        np.testing.assert_array_equal(host(pad), np.asarray(ref_pad))
        close(sim.batched_gram(pad, nv),
              ref_sim.batched_gram(ref_pad, ref_nv, impl="pallas"))

    def test_zero_count_user_divides_by_one(self):
        x = torch.zeros((2, 4, 3))
        x[1] = 1.0
        g = sim.batched_gram(x, torch.tensor([0.0, 4.0]))
        assert torch.equal(g[0], torch.zeros(3, 3))
        assert torch.equal(g[1], torch.ones(3, 3))

    def test_rejects_bad_rank(self):
        with pytest.raises(ValueError):
            batched_gram_matrix(torch.zeros(3, 4))


class TestEigprojectPlain:
    @pytest.mark.parametrize("d,k", [(5, 2), (16, 6), (33, 8), (130, 5)])
    def test_matches_pallas(self, d, k):
        rng = np.random.default_rng(d * 10 + k)
        g = rng.standard_normal((d, d)).astype(np.float32)
        v = rng.standard_normal((d, k)).astype(np.float32)
        close(project_norms_ref(t(g), t(v)),
              ref_proj.project_norms(jnp.asarray(g), jnp.asarray(v),
                                     interpret=True))

    @pytest.mark.parametrize("n_g,n_v,d,k", [(3, 4, 9, 2), (5, 5, 33, 3)])
    def test_all_pairs_matches_pallas_per_pair(self, n_g, n_v, d, k):
        rng = np.random.default_rng(n_g + d)
        g = rng.standard_normal((n_g, d, d)).astype(np.float32)
        v = rng.standard_normal((n_v, d, k)).astype(np.float32)
        ref = np.stack([np.stack([np.asarray(ref_proj.project_norms(
            jnp.asarray(g[i]), jnp.asarray(v[j]), interpret=True))
            for j in range(n_v)]) for i in range(n_g)])
        close(project_norms_all_ref(t(g), t(v)), ref)

    def test_chunking_is_exact(self, monkeypatch):
        from repro_torch.kernels.eigproject import ref as proj_ref

        rng = np.random.default_rng(3)
        g = t(rng.standard_normal((7, 6, 6)))
        v = t(rng.standard_normal((5, 6, 2)))
        whole = project_norms_all_ref(g, v)
        monkeypatch.setattr(proj_ref, "CHUNK_BYTES", 1)
        assert torch.equal(project_norms_all_ref(g, v), whole)

    def test_zero_vector_column(self):
        g = t(np.random.default_rng(0).standard_normal((8, 8)))
        v = torch.zeros((8, 3))
        v[:, 1] = 1.0
        out = project_norms(g, v)
        assert out[0] == 0.0 and out[2] == 0.0 and out[1] > 0.0

    def test_wrapper_on_cpu_is_plain(self):
        rng = np.random.default_rng(2)
        g = t(rng.standard_normal((4, 6, 6)))
        v = t(rng.standard_normal((3, 6, 2)))
        assert torch.equal(project_norms_all(g, v),
                           project_norms_all_ref(g, v))

    def test_rejects_mismatched_width(self):
        with pytest.raises(ValueError):
            project_norms_all(torch.zeros(2, 4, 4), torch.zeros(2, 5, 1))


class TestFeaturizeGramPlain:
    @pytest.mark.parametrize("n,m,d", [(128, 128, 128), (100, 96, 40),
                                       (130, 300, 72), (64, 40, 12),
                                       (1, 7, 3)])
    def test_fp32_matches_pallas(self, n, m, d):
        rng = np.random.default_rng(n * 3 + m + d)
        x = rng.standard_normal((n, m)).astype(np.float32)
        w = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
        close(featurize_gram_ref(t(x), t(w)),
              ref_fg.featurize_gram(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True))

    @pytest.mark.parametrize("n,m,d", [(256, 200, 64), (37, 50, 20)])
    def test_bf16_matches_pallas(self, n, m, d):
        rng = np.random.default_rng(9 + n)
        x = rng.standard_normal((n, m)).astype(np.float32)
        w = (rng.standard_normal((m, d)) / 8.0).astype(np.float32)
        out = featurize_gram_ref(t(x), t(w), "bf16")
        assert out.dtype == torch.float32
        ref = np.asarray(ref_fg.featurize_gram(
            jnp.asarray(x), jnp.asarray(w), compute_dtype="bf16",
            interpret=True))
        scale = np.abs(ref).max()
        assert np.abs(out.numpy() - ref).max() <= 2e-3 * scale
        fp32 = featurize_gram_ref(t(x), t(w)).numpy()
        assert np.abs(out.numpy() - fp32).max() < 2e-2 * scale

    def test_identity_and_zero_rows(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((40, 48)).astype(np.float32)
        padded = np.zeros((64, 48), np.float32)
        padded[:40] = x
        w = t(rng.standard_normal((48, 16)))
        assert torch.equal(featurize_gram_ref(t(x)), gram_ref(t(x)))
        close(featurize_gram_ref(t(padded), w), featurize_gram_ref(t(x), w))

    def test_wrapper_on_cpu_is_plain_and_accumulates(self):
        rng = np.random.default_rng(6)
        x = t(rng.standard_normal((3, 10, 12)))
        w = t(rng.standard_normal((12, 5)))
        for cd in ("fp32", "bf16"):
            assert torch.equal(batched_featurize_gram(x, w, cd),
                               featurize_gram_ref(x, w, cd))
        assert torch.equal(featurize_gram(x[1], w),
                           featurize_gram_ref(x[1:2], w)[0])
        acc = t(rng.standard_normal((3, 5, 5)))
        expect = acc + featurize_gram_ref(x, w)
        out = batched_featurize_gram(x, w, out=acc)
        assert out is acc and torch.equal(out, expect)

    def test_rejects_bad_arguments(self):
        x, w = torch.zeros(2, 8, 8), torch.zeros(8, 4)
        with pytest.raises(ValueError, match="compute_dtype"):
            batched_featurize_gram(x, w, compute_dtype="fp16")
        with pytest.raises(ValueError):
            batched_featurize_gram(x, torch.zeros(7, 4))
        with pytest.raises(ValueError, match="out"):
            batched_featurize_gram(x, w, out=torch.zeros(2, 4, 5))


class TestGramProjectPlain:
    @pytest.mark.parametrize("n,d,k,n_valid", [(128, 128, 128, None),
                                               (100, 40, 70, 63),
                                               (17, 33, 5, 17), (1, 8, 3, 0),
                                               (300, 70, 9, 257)])
    def test_matches_pallas(self, n, d, k, n_valid):
        rng = np.random.default_rng(n + d + k)
        x = rng.standard_normal((n, d)).astype(np.float32)
        if n_valid is not None:
            x[n_valid:] = 0.0
        v = rng.standard_normal((d, k)).astype(np.float32)
        close(gram_project_ref(t(x), t(v), n_valid),
              ref_gp.gram_project(jnp.asarray(x), jnp.asarray(v),
                                  n_valid=n_valid, interpret=True))

    def test_batched_ragged_and_chunked(self, monkeypatch):
        from repro_torch.kernels.gram_project import ref as gp_ref

        rng = np.random.default_rng(8)
        x = rng.standard_normal((5, 30, 12)).astype(np.float32)
        nv = np.array([30, 1, 17, 0, 29], np.float32)
        for i, c in enumerate(nv):
            x[i, int(c):] = 0.0
        v = rng.standard_normal((12, 7)).astype(np.float32)
        out = batched_gram_project(t(x), t(v), t(nv))
        for i in range(5):
            close(out[i], ref_gp.gram_project(
                jnp.asarray(x[i]), jnp.asarray(v), n_valid=float(nv[i]),
                interpret=True))
            assert torch.equal(gram_project(t(x[i]), t(v), float(nv[i])),
                               gram_project_ref(t(x[i]), t(v), float(nv[i])))
        monkeypatch.setattr(gp_ref, "CHUNK_BYTES", 1)
        assert torch.equal(gram_project_ref(t(x), t(v), t(nv)), out)

    def test_equals_gram_then_eigproject(self):
        rng = np.random.default_rng(3)
        x = t(rng.standard_normal((4, 20, 9)))
        v = t(rng.standard_normal((9, 6)))
        via_gram = project_norms_all_ref(gram_ref(x) / 20.0,
                                         v.reshape(1, 9, 6))[:, 0]
        close(batched_gram_project(x, v), via_gram.numpy())

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            batched_gram_project(torch.zeros(2, 3, 4), torch.zeros(5, 2))
        with pytest.raises(ValueError):
            gram_project(torch.zeros(2, 3, 4), torch.zeros(4, 2))


def _rows(n, seed):
    """Rows with exact ties (values on a 1/4 grid), a random mask."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 4, n) / 4).astype(np.float32)
    b = (rng.integers(0, 4, n) / 4).astype(np.float32)
    mask = rng.uniform(size=n) > 0.3
    return a, b, mask


class TestLinkageStepPlain:
    @pytest.mark.parametrize("linkage", LINKAGES)
    @pytest.mark.parametrize("n,masked", [(128, False), (256, False),
                                          (128, True)])
    def test_matches_pallas(self, linkage, n, masked):
        a, b, mask = _rows(n, n)
        if masked:      # an all-masked row: (-inf, ..., -inf), index 0
            mask[:] = False
        new, idx, val = linkage_step_ref(t(a), t(b), 3.0, 5.0,
                                         torch.from_numpy(mask), linkage)
        r_new, r_idx, r_val = ref_linkage_step(
            jnp.asarray(a), jnp.asarray(b), 3.0, 5.0, jnp.asarray(mask),
            linkage=linkage, interpret=True)
        np.testing.assert_array_equal(host(new), np.asarray(r_new))
        assert int(idx) == int(r_idx)
        assert float(val) == float(r_val)

    @pytest.mark.parametrize("linkage", LINKAGES)
    @pytest.mark.parametrize("n", [1, 7, 130])
    def test_unaligned_matches_reference_oracle(self, linkage, n):
        a, b, mask = _rows(n, n + 1)
        new, idx, val = linkage_step_ref(t(a), t(b), 2.0, 1.0,
                                         torch.from_numpy(mask), linkage)
        r_new, r_idx, r_val = ref_linkage_step_ref(
            jnp.asarray(a), jnp.asarray(b), 2.0, 1.0, jnp.asarray(mask),
            linkage)
        np.testing.assert_array_equal(host(new), np.asarray(r_new))
        assert int(idx) == int(r_idx)
        assert float(val) == float(r_val)

    def test_ties_resolve_to_first_index(self):
        row = torch.tensor([0.5, 1.0, 0.25, 1.0, 1.0])
        _, idx, val = linkage_step_ref(row, row, 1.0, 1.0,
                                       torch.ones(5, dtype=torch.bool))
        assert int(idx) == 1 and float(val) == 1.0

    def test_all_masked_row_gives_index_zero(self):
        row = torch.rand(6)
        new, idx, val = linkage_step_ref(row, row, 1.0, 1.0,
                                         torch.zeros(6, dtype=torch.bool))
        assert int(idx) == 0 and float(val) == float("-inf")
        assert torch.isneginf(new).all()

    def test_float_mask_and_wrapper_on_cpu(self):
        a, b, mask = _rows(9, 4)
        out = linkage_step(t(a), t(b), 1.0, 2.0, t(mask), "average")
        ref = linkage_step_ref(t(a), t(b), 1.0, 2.0, torch.from_numpy(mask))
        for x, y in zip(out, ref):
            assert torch.equal(x, y)

    def test_bad_linkage_raises(self):
        row = torch.zeros(4)
        with pytest.raises(ValueError):
            linkage_step(row, row, 1, 1, torch.ones(4, dtype=torch.bool),
                         "ward")


class TestNNChainPlain:
    def test_wrapper_on_cpu_is_plain(self):
        r = np.random.default_rng(0).uniform(size=(9, 9))
        s = t((r + r.T) / 2)
        s.fill_diagonal_(float("-inf"))
        a = nn_chain(s.clone())
        b = nn_chain_ref(s.clone())
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert int(a[2]) == 8

    def test_single_leaf(self):
        merges, heights, steps = nn_chain(torch.full((1, 1), float("-inf")))
        assert merges.shape == (0, 2) and heights.shape == (0,)
        assert int(steps) == 0

    def test_nan_stops_short(self):
        r = np.random.default_rng(1).uniform(size=(12, 12))
        s = t((r + r.T) / 2)
        s.fill_diagonal_(float("-inf"))
        s[2, 7] = s[7, 2] = float("nan")
        assert int(nn_chain(s)[2]) < 11


class TestDispatch:
    def test_launch_counts_untouched_on_cpu(self):
        dispatch.reset_launches()
        x = torch.ones((2, 3, 4))
        project_norms_all(batched_gram_matrix(x), torch.ones((2, 4, 1)))
        batched_featurize_gram(x, torch.ones((4, 2)))
        batched_gram_project(x, torch.ones((4, 2)))
        assert all(v == 0 for v in dispatch.LAUNCHES.values())

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError):
            dispatch.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))

    def test_resolve_cpu(self):
        assert dispatch.resolve_device("cpu") == CPU
        assert dispatch.device_kind("cpu") == "cpu"
        with pytest.raises(ValueError):
            dispatch.resolve_device("meta")
