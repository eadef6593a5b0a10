"""The port's directory quantization and assign kernels' plain versions
against the JAX package (Pallas in interpret mode).

Tolerances:
  * ``quant``: equal to the reference, bit for bit (codes, scales and
    dequantized values), for numpy arrays and tensors.
  * ``assign`` (wave) against the reference's ``assign(...,
    interpret=True)``: fp32 within 1e-5 x max|aff|, labels equal.  bf16
    within 1e-4 x max|aff| (both sides round the same fp32 S and table
    to bf16 and sum exactly representable products in fp32; S itself is
    summed in another order on each side, which can move one bf16
    rounding; measured below 3e-7), labels equal.
  * ``assign_looped`` against the reference's ``assign_looped(...,
    interpret=True)``: the same two tolerances.
  * the tensor-core wave kernel's split of the d^2 axis
    (``ops.wave_plan``): its slices cover every entry once, and the
    plain emulation of its per-slice sums, added in the kernel's order, gives
    ``assign_wave_plain``'s labels, -inf and NaN places, and affinities
    within 1e-6 x max|aff| (the same bf16 operands, fp32 sums in another
    order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import host, t
from repro.kernels import quant as ref_quant
from repro.kernels.assign import ops as ref_ops
from repro.kernels.assign.ref import assign_ref as ref_assign_ref
from repro_torch.kernels import dispatch, quant
from repro_torch.kernels.assign import (assign, assign_looped, assign_ref,
                                        assign_wave_plain)
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.assign.ref import verdict

SWEEP = [(4, 3, 16, 6), (8, 8, 32, 8), (2, 1, 128, 128), (5, 2, 40, 3),
         (3, 130, 12, 3)]
TOL = {"fp32": 1e-5, "bf16": 1e-4}


def case(b, n_protos, d, k, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, d, k)).astype(np.float32)
    p = rng.standard_normal((n_protos, d, d)).astype(np.float32)
    return v, (p + p.transpose(0, 2, 1)) / 2


def assert_matches(out, ref, tol):
    aff, lab, mar = (host(x) for x in out)
    r_aff, r_lab, r_mar = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(np.isinf(aff), np.isinf(r_aff))
    fin = np.isfinite(r_aff)
    scale = np.abs(r_aff[fin]).max()
    np.testing.assert_allclose(aff[fin], r_aff[fin], rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(lab, r_lab)
    fin = np.isfinite(r_mar)
    np.testing.assert_allclose(mar[fin], r_mar[fin], rtol=0,
                               atol=2 * tol * scale)
    np.testing.assert_array_equal(np.isnan(mar), np.isnan(r_mar))


class TestQuant:
    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("family", ["numpy", "torch"])
    def test_equals_reference_bit_for_bit(self, dtype, family):
        rng = np.random.default_rng(3)
        p = rng.standard_normal((5, 20, 20)).astype(np.float32)
        p[2] = 0.0                                 # all-zero entry
        ref_table, ref_scales = ref_quant.quantize_directory(p, dtype)
        arg = t(p) if family == "torch" else p
        table, scales = quant.quantize_directory(arg, dtype)
        assert isinstance(table, torch.Tensor) == (family == "torch")
        if dtype == "int8":
            np.testing.assert_array_equal(host(table), ref_table)
            np.testing.assert_array_equal(host(scales), ref_scales)
            assert host(scales)[2] == 1.0
        else:
            assert scales is None
        np.testing.assert_array_equal(
            host(quant.dequantize_directory(table, scales)),
            np.asarray(ref_quant.dequantize_directory(ref_table,
                                                      ref_scales)))
        assert quant.directory_nbytes(table, scales) == \
            ref_quant.directory_nbytes(ref_table, ref_scales)

    def test_torch_dtypes(self):
        p = torch.ones((2, 4, 4))
        assert quant.quantize_directory(p, "bf16")[0].dtype == torch.bfloat16
        assert quant.quantize_directory(p, "int8")[0].dtype == torch.int8
        assert quant.quantize_directory(p, "f32")[0].dtype == torch.float32

    def test_nbytes_ratio(self):
        p = np.zeros((8, 32, 32), np.float32)
        f32 = quant.directory_nbytes(*quant.quantize_directory(p, "f32"))
        i8 = quant.directory_nbytes(*quant.quantize_directory(p, "int8"))
        bf = quant.directory_nbytes(*quant.quantize_directory(p, "bf16"))
        assert f32 == 8 * 32 * 32 * 4 and f32 / bf == 2.0
        assert 3.9 < f32 / i8 <= 4.0

    def test_unknown_dtype_rejected(self):
        with pytest.raises(ValueError, match="directory dtype"):
            quant.quantize_directory(np.zeros((1, 2, 2), np.float32), "fp8")


class TestAssignPlain:
    """The wrappers on CPU tensors (the kernels' plain versions) against
    the reference's interpret-mode kernels."""

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("b,n_protos,d,k", SWEEP)
    def test_wave_sweep(self, b, n_protos, d, k, compute_dtype):
        v, p = case(b, n_protos, d, k, seed=b * 13 + n_protos)
        ref = ref_ops.assign(jnp.asarray(v), jnp.asarray(p),
                             compute_dtype=compute_dtype, interpret=True)
        assert_matches(assign(t(v), t(p), compute_dtype=compute_dtype), ref,
                       TOL[compute_dtype])

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("b,n_protos,d,k", SWEEP)
    def test_looped_sweep(self, b, n_protos, d, k, compute_dtype):
        v, p = case(b, n_protos, d, k, seed=b * 7 + n_protos)
        ref = ref_ops.assign_looped(jnp.asarray(v), jnp.asarray(p),
                                    compute_dtype=compute_dtype,
                                    interpret=True)
        assert_matches(assign_looped(t(v), t(p),
                                     compute_dtype=compute_dtype), ref,
                       TOL[compute_dtype])

    def test_oracle_equals_reference_oracle(self):
        v, p = case(6, 4, 24, 5, seed=1)
        mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
        ref = ref_assign_ref(jnp.asarray(v), jnp.asarray(p),
                             jnp.asarray(mask))
        assert_matches(assign_ref(t(v), t(p), t(mask)), ref, 1e-5)

    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("dtype", ["bf16", "int8"])
    def test_quantized_directory(self, dtype, compute_dtype):
        v, p = case(6, 5, 20, 4, seed=1)
        q, sc = ref_quant.quantize_directory(jnp.asarray(p), dtype)
        ref = ref_ops.assign(jnp.asarray(v), q, scales=sc,
                             compute_dtype=compute_dtype, interpret=True)
        table, scales = quant.quantize_directory(t(p), dtype)
        assert_matches(assign(t(v), table, compute_dtype=compute_dtype,
                              scales=scales), ref, TOL[compute_dtype])

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_mask_excludes_clusters(self, fn):
        v, p = case(4, 3, 16, 4, seed=9)
        mask = np.array([1.0, 0.0, 1.0], np.float32)
        aff, lab, _ = fn(t(v), t(p), t(mask), "fp32")
        ref = ref_ops.assign(jnp.asarray(v), jnp.asarray(p),
                             jnp.asarray(mask), compute_dtype="fp32",
                             interpret=True)
        assert not (host(lab) == 1).any()
        np.testing.assert_array_equal(host(lab), np.asarray(ref[1]))
        assert np.isneginf(host(aff)[:, 1]).all()

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_tie_breaks_to_first_index(self, fn, compute_dtype):
        v, p = case(3, 1, 16, 4, seed=11)
        dup = np.concatenate([p, p])
        _, lab, mar = fn(t(v), t(dup), None, compute_dtype)
        assert (host(lab) == 0).all()
        np.testing.assert_allclose(host(mar), 0.0, atol=1e-5)

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_single_cluster_margin_is_affinity(self, fn):
        v, p = case(4, 1, 16, 4, seed=2)
        aff, lab, mar = fn(t(v), t(p), None, "fp32")
        assert (host(lab) == 0).all()
        np.testing.assert_array_equal(host(mar), host(aff)[:, 0])

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_all_dead_and_one_live(self, fn):
        v, p = case(5, 3, 16, 4, seed=4)
        _, lab, mar = fn(t(v), t(p), torch.zeros(3), "fp32")
        assert (host(lab) == 0).all() and np.isnan(host(mar)).all()
        _, lab, mar = fn(t(v), t(p), torch.tensor([0.0, 1.0, 0.0]), "fp32")
        assert (host(lab) == 1).all() and np.isposinf(host(mar)).all()

    @pytest.mark.parametrize("fn", [assign, assign_looped])
    def test_bad_compute_dtype_raises(self, fn):
        v, p = case(1, 1, 16, 4)
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(t(v), t(p), compute_dtype="fp16")

    def test_bad_shapes_and_int8_without_scales_raise(self):
        v, p = case(2, 2, 8, 3)
        with pytest.raises(ValueError, match="bad shapes"):
            assign(t(v), t(p)[:, :4])
        table, _ = quant.quantize_directory(t(p), "int8")
        with pytest.raises(ValueError, match="scales"):
            assign(t(v), table)

    def test_plain_path_counts_no_launch(self):
        v, p = case(3, 2, 8, 3)
        before = dict(dispatch.LAUNCHES)
        assign(t(v), t(p))
        assign_looped(t(v), t(p))
        assert dispatch.LAUNCHES == before

    def test_wave_plain_is_raw(self):
        """The plain wave version returns the kernel's raw outputs: the
        wrapper's affinities times k."""
        v, p = case(4, 3, 12, 5, seed=8)
        raw = assign_wave_plain(t(v), t(p), None, None, "fp32")
        aff = assign(t(v), t(p), compute_dtype="fp32")[0]
        np.testing.assert_allclose(host(raw[0]) / 5, host(aff), rtol=1e-6)


def split_k_plain(v, table, scales, mask, plan):
    """The tensor-core wave kernel's arithmetic in plain PyTorch: S formed
    as the kernel forms it and rounded to bf16, the table cast to bf16,
    one fp32 product per slice over that slice's entries, the partials
    added as the kernel adds them (four interleaved runs over whole groups
    of four slices, the rest into the first run, then the runs pairwise),
    then scale, liveness and the verdict: RAW ``(aff, labels, margin)``."""
    b, d, _ = v.shape
    s = torch.zeros((b, d, d))
    for c in range(v.shape[2]):
        s += v[:, :, c, None] * v[:, None, :, c]
    s = s.reshape(b, d * d).to(torch.bfloat16).float()
    p = table.float().reshape(table.shape[0], d * d).to(
        torch.bfloat16).float()
    runs = [torch.zeros((b, table.shape[0])) for _ in range(4)]
    whole = plan.n_slices // 4 * 4
    for sl in range(plan.n_slices):
        idx = assign_ops.slice_entries(plan, d, sl)
        u = sl % 4 if sl < whole else 0
        runs[u] = runs[u] + s[:, idx] @ p[:, idx].T
    aff = (runs[0] + runs[1]) + (runs[2] + runs[3])
    if scales is not None:
        aff = aff * scales[None, :]
    if mask is not None:
        aff = torch.where(mask[None, :] > 0.5, aff, float("-inf"))
    labels, margin = verdict(aff)
    return aff, labels, margin


class TestTensorCoreWave:
    """What the CPU can hold of the tensor-core wave kernel: its routing,
    its split plan and its order of summation."""

    def test_wave_entry_by_compute_dtype(self):
        assert assign_ops.wave_entry("bf16") == "repro_assign_wave_tc"
        assert assign_ops.wave_entry("fp32") == "repro_assign_wave"
        with pytest.raises(ValueError, match="compute_dtype"):
            assign_ops.wave_entry("fp16")

    @pytest.mark.parametrize("d", [8, 64, 512])
    @pytest.mark.parametrize("b,n_protos", [(1, 1), (128, 4), (100, 7),
                                            (1024, 128), (13, 130)])
    def test_plan_covers_each_entry_once(self, d, b, n_protos):
        plan = assign_ops.wave_plan(b, n_protos, d, 132)
        assert plan.block_n == (8 if n_protos <= 8 else 32
                                if n_protos <= 32 else 128)
        assert plan.m_tiles * assign_ops.BLOCK_M >= b
        assert plan.n_tiles * plan.block_n >= n_protos
        assert (plan.n_slices - 1) * plan.ksteps_per_slice < plan.ksteps \
            <= plan.n_slices * plan.ksteps_per_slice
        covered = torch.cat([assign_ops.slice_entries(plan, d, sl)
                             for sl in range(plan.n_slices)])
        assert covered.numel() == d * d
        assert torch.equal(torch.sort(covered).values, torch.arange(d * d))

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("b,n_protos,d,k", [(9, 4, 64, 8),
                                                (70, 7, 40, 3),
                                                (5, 130, 24, 4)])
    def test_split_sum_matches_plain(self, dtype, b, n_protos, d, k):
        v, p = case(b, n_protos, d, k, seed=b + d)
        p[1] = p[0]  # an exact tie: the first index wins
        mask = torch.ones(n_protos)
        mask[-1] = 0.0
        table, scales = quant.quantize_directory(t(p), dtype)
        plan = assign_ops.wave_plan(b, n_protos, d, 132)
        assert plan.n_slices > 1
        got = split_k_plain(t(v), table, scales, mask, plan)
        want = assign_wave_plain(t(v), table, scales, mask, "bf16")
        assert torch.equal(torch.isinf(got[0]), torch.isinf(want[0]))
        fin = torch.isfinite(want[0])
        scale = float(want[0][fin].abs().max())
        assert float((got[0] - want[0])[fin].abs().max()) <= 1e-6 * scale
        assert torch.equal(got[1], want[1])
        assert torch.equal(torch.isnan(got[2]), torch.isnan(want[2]))
        assert torch.equal(got[0][:, 1], got[0][:, 0])

    def test_split_sum_edges(self):
        """All dead: label 0, NaN margin; one live: +inf margin; T = 1:
        margin = affinity, as the plain version."""
        v, p = case(6, 3, 16, 4, seed=5)
        for n_protos, mask in [(3, torch.zeros(3)),
                               (3, torch.tensor([0.0, 1.0, 0.0])),
                               (1, None)]:
            plan = assign_ops.wave_plan(6, n_protos, 16, 132)
            got = split_k_plain(t(v), t(p[:n_protos]), None, mask, plan)
            want = assign_wave_plain(t(v), t(p[:n_protos]), None, mask,
                                     "bf16")
            assert torch.equal(got[1], want[1])
            np.testing.assert_array_equal(np.isnan(host(got[2])),
                                          np.isnan(host(want[2])))
            np.testing.assert_array_equal(np.isinf(host(got[2])),
                                          np.isinf(host(want[2])))
