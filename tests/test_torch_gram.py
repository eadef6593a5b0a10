"""The redesigned Gram kernel's plan and arithmetic, on the CPU.

``gram_plan(d)`` is the kernel's grid: the upper triangle of 128 x 128
output tiles and the load route.  The kernel computes ``x^T x`` as
3xTF32 on the tensor cores and mirrors its upper triangle; its plain
model (``gram_3xtf32``) is held against the reference's Pallas
``gram_matrix`` in interpret mode to 1e-5 of the largest entry (3xTF32
keeps about 21 bits of each operand; fp32 sums in another order), is
symmetric bit for bit, and the 1xTF32 product (``hi hi`` alone) lands at
least 8x further off, the separation the card's checks require.  The
epilogue's divisor on the CPU path is the division after the Gram, bit
for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import CPU, host, t
from repro.core import similarity as ref_sim
from repro.kernels.gram import ops as ref_gram
from repro_torch.core import similarity as sim
from repro_torch.kernels import dispatch
from repro_torch.kernels.gram import (batched_gram_matrix, gram_3xtf32,
                                      gram_plan, gram_ref)
from repro_torch.kernels.tf32 import matmul_1xtf32

WIDTHS = [1, 5, 127, 128, 129, 512, 784]


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_covers_the_upper_triangle_once(d):
    plan = gram_plan(d)
    assert plan.tiles == -(-d // plan.tile)
    covered = np.zeros((d, d), dtype=np.int64)
    for i, j in plan.pairs:
        assert i <= j
        covered[i * plan.tile:(i + 1) * plan.tile,
                j * plan.tile:(j + 1) * plan.tile] += 1
    assert (np.triu(covered) == np.triu(np.ones((d, d), np.int64))).all()
    assert len(set(plan.pairs)) == len(plan.pairs) \
        == plan.tiles * (plan.tiles + 1) // 2
    # Blocks of a user run in the plan's order: row-major over I <= J.
    assert list(plan.pairs) == sorted(plan.pairs)


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_route_and_shared_memory(d):
    plan = gram_plan(d)
    assert plan.route == ("cp.async4" if 4 * d % 16 else "tma")
    assert plan.smem <= 232448


def test_plan_rejects_empty_width():
    with pytest.raises(ValueError):
        gram_plan(0)


@pytest.mark.parametrize("n,d", [(17, 5), (64, 130), (300, 129), (37, 130)])
def test_3xtf32_gram_matches_pallas(n, d):
    x = np.random.default_rng(n * 7 + d).standard_normal(
        (n, d)).astype(np.float32)
    ref = np.asarray(ref_gram.gram_matrix(jnp.asarray(x), interpret=True))
    got = gram_3xtf32(t(x))
    scale = float(np.abs(ref).max())
    err = float(np.abs(host(got) - ref).max())
    assert err <= 1e-5 * scale, err / scale
    assert torch.equal(got, got.T)
    exact = t(x).double().T @ t(x).double()
    err3 = float((got.double() - exact).abs().max())
    err1 = float((matmul_1xtf32(t(x).T, t(x)).double() - exact).abs().max())
    assert err1 >= 8 * err3, (err1 / scale, err3 / scale)


def test_3xtf32_gram_batched_is_symmetric():
    x = t(np.random.default_rng(3).standard_normal((4, 50, 33)))
    g = gram_3xtf32(x)
    assert torch.equal(g, g.transpose(1, 2))
    assert torch.equal(g[2], gram_3xtf32(x[2]))


@pytest.mark.parametrize("counts", [[5, 19, 0, 33], [40, 40, 1]])
def test_divisor_equals_division_after(counts):
    rng = np.random.default_rng(len(counts))
    x = t(rng.standard_normal((len(counts), 40, 12)))
    nv = torch.tensor(counts, dtype=torch.float32)
    want = gram_ref(x) / torch.clamp_min(nv, 1.0)[:, None, None]
    assert torch.equal(batched_gram_matrix(x, nv), want)
    assert torch.equal(batched_gram_matrix(x, torch.tensor(counts)), want)
    assert torch.equal(batched_gram_matrix(x), gram_ref(x))


def test_divisor_rejects_wrong_length():
    with pytest.raises(ValueError, match="n_valid"):
        batched_gram_matrix(torch.zeros(3, 4, 2), torch.ones(2))


@pytest.mark.parametrize("d", [7, 130])
def test_batched_gram_matches_reference_ragged(d):
    rng = np.random.default_rng(d + 1)
    feats = [rng.standard_normal((c, d)).astype(np.float32)
             for c in (3, 40, 1, 17)]
    pad, nv = sim.pad_ragged(feats, device=CPU)
    ref_pad, ref_nv = ref_sim.pad_ragged(feats)
    ref = np.asarray(ref_sim.batched_gram(ref_pad, ref_nv, impl="pallas"))
    got = host(sim.batched_gram(pad, nv))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    before = dict(dispatch.LAUNCHES)
    sim.batched_gram(pad, nv)
    assert dispatch.LAUNCHES == before
