"""The redesigned assign_one kernel's split of a wave (``one_plan``) and
the plain model of its partial sums, on the CPU.

The kernel computes each prototype's ``P_t [V_1 .. V_B]`` as one product,
a block owning a group of arrivals x a slice of P's rows; each block
writes one partial ``sum(W o V)`` per (arrival, prototype), and a second
kernel adds a pair's partials in slice order.  ``one_plan`` must cover
every (arrival, prototype, row, channel) exactly once.  The plain model
of the split (``ops.assign_one_sliced_plain``) is held against the
reference's ``assign_looped`` (Pallas in interpret mode) and against
``assign_looped_plain`` within 1e-6 of the largest affinity: the same
compute-dtype operands, fp32 sums in another order (at these widths the
orders differ by a few 1e-7).  Labels equal, dead prototypes at -inf in
the same places.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import host, t
from repro.kernels.assign import ops as ref_ops
from repro_torch.kernels import quant
from repro_torch.kernels.assign import assign_looped, assign_looped_plain
from repro_torch.kernels.assign import ops

TOL = 1e-6


def case(b, n_protos, d, k, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, d, k)).astype(np.float32)
    p = rng.standard_normal((n_protos, d, d)).astype(np.float32)
    return v, (p + p.transpose(0, 2, 1)) / 2


def assert_close(got, want, k):
    """``got``: wrapper units (divided by k); ``want``: raw."""
    aff, lab, mar = (host(x) for x in got)
    w_aff, w_lab, w_mar = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(np.isinf(aff), np.isinf(w_aff))
    fin = np.isfinite(w_aff)
    scale = np.abs(w_aff[fin]).max()
    np.testing.assert_allclose(aff[fin] * k, w_aff[fin], rtol=0,
                               atol=TOL * scale)
    np.testing.assert_array_equal(lab, w_lab)
    fin = np.isfinite(w_mar)
    np.testing.assert_allclose(mar[fin] * k, w_mar[fin], rtol=0,
                               atol=2 * TOL * scale)


@pytest.mark.parametrize("b,n_protos,d,k,sms", [
    (128, 4, 512, 8, 132), (16, 3, 1024, 64, 132), (1, 4, 512, 8, 132),
    (5, 33, 130, 13, 8), (3, 2, 40, 200, 4), (300, 1, 16, 1, 132),
    (7, 3, 64, 3, 2)])
@pytest.mark.parametrize("compute_dtype", ["bf16", "fp32"])
def test_plan_covers_each_entry_once(b, n_protos, d, k, sms, compute_dtype):
    plan = ops.one_plan(b, n_protos, d, k, sms, compute_dtype)
    assert plan.slice_rows in ops.SLICE_ROWS
    assert plan.stages in ops.ONE_STAGES
    assert plan.smem == ops.one_smem_bytes(plan.slice_rows, plan.v_rows,
                                           plan.stages, compute_dtype)
    assert plan.smem <= ops.MAX_SMEM
    assert plan.v_rows % ops.ONE_STEP == 0
    if k <= ops.ONE_COLS:
        assert plan.col_tiles == 1 and plan.group * k <= ops.ONE_COLS
    else:
        assert plan.group == 1
    # Each block walks every prototype, so (arrival, row, channel) once
    # each is (arrival, prototype, row, channel) once each.
    seen = np.zeros((b, d, k), dtype=np.int64)
    for block in range(plan.blocks):
        arrivals, rows, chans = ops.one_block(plan, b, k, block)
        rows = range(rows.start, min(rows.stop, d))
        seen[np.ix_(arrivals, list(rows), list(chans))] += 1
    assert (seen == 1).all()


def test_plan_fills_the_card_at_the_serving_shape():
    plan = ops.one_plan(128, 4, 512, 8, 132)
    assert plan.blocks >= 128
    assert (plan.group, plan.slice_rows, plan.v_rows) == (16, 32, 512)
    # d = 1024 at k = 64 (past the old kernel's shared memory) chunks V.
    wide = ops.one_plan(16, 3, 1024, 64, 132)
    assert wide.v_rows < 1024 and wide.smem <= ops.MAX_SMEM
    assert (plan.stages, wide.stages) == (5, 5)


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        ops.one_plan(0, 1, 8, 2, 132)
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.one_plan(1, 1, 8, 2, 132, "fp16")


@pytest.mark.parametrize("compute_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n_protos,d,k,sms", [
    (9, 4, 40, 6, 4), (3, 1, 33, 5, 8), (2, 3, 24, 140, 3)])
def test_sliced_sum_matches_reference(b, n_protos, d, k, sms, dtype,
                                      compute_dtype):
    v, p = case(b, n_protos, d, k, seed=b * 31 + d)
    table, _ = quant.quantize_directory(t(p), dtype)
    stored = table.to(torch.float32)  # scored as stored, no scales
    mask = np.ones(n_protos, np.float32)
    if n_protos > 1:
        mask[1] = 0.0  # a dead prototype
    plan = ops.one_plan(b, n_protos, d, k, sms, compute_dtype)
    got = ops.assign_one_sliced_plain(t(v), table, t(mask), compute_dtype,
                                      plan)
    ref = ref_ops.assign_looped(jnp.asarray(v), jnp.asarray(host(stored)),
                                jnp.asarray(mask),
                                compute_dtype=compute_dtype, interpret=True)
    assert_close(got, tuple(np.asarray(x) * s for x, s in
                            zip(ref, (k, 1, k))), k)
    assert_close(got, assign_looped_plain(t(v), table, t(mask),
                                          compute_dtype), k)
    if n_protos == 1:
        assert torch.equal(got[2], got[0][:, 0])


def test_looped_takes_a_v_wider_than_shared_memory():
    # At (d, k) = (1024, 64) V holds 256 KB even in bf16: the kernel stages
    # it in chunks of d; on the CPU the plain path runs.
    v, p = case(2, 2, 1024, 64, seed=5)
    aff, labels, margin = assign_looped(t(v), t(p), None, "bf16")
    assert aff.shape == (2, 2) and bool(torch.isfinite(aff).all())
    plan = ops.one_plan(2, 2, 1024, 64, 132)
    want = ops.assign_one_sliced_plain(t(v), t(p), None, "bf16", plan)
    scale = float(want[0].abs().max())
    assert float((aff - want[0]).abs().max()) <= TOL * scale
    assert torch.equal(labels, want[1])
