"""The plain 3xTF32 split (``repro_torch/kernels/tf32.py``) and the tile
plans of the two kernels that run fp32 products on the TF32 tensor cores
(``featurize_gram``, ``gram_project``), on the CPU.

The split is the kernels' arithmetic: ``hi = tf32(a)``, ``lo = tf32(a -
hi)``, each rounded to nearest with ties away from zero on the fp32 bit
pattern, and a product ``lo hi + hi lo + hi hi`` in fp32.  Tolerances:
``hi + lo`` is within ``2^-22 |a|`` of ``a`` (21-22 significant bits); a
3xTF32 product at (64, 3072) x (3072, 512) is within 1e-6 of the largest
entry of the fp64 product (fp32 itself lands near 5e-7), and the 1xTF32
product (``hi hi`` alone) is at least 8x further off, the separation the
card's checks require of the kernels.  The plans are pure functions of
``d``: every width the port's tests and paths use gets a plan that fits
an H100 block's shared memory.
"""
import numpy as np
import pytest
import torch

from _torch_support import t  # noqa: F401  (pins torch to one thread)
from repro_torch.kernels.featurize_gram import ops as fg_ops
from repro_torch.kernels.gram_project import ops as gp_ops
from repro_torch.kernels.tf32 import (matmul_1xtf32, matmul_3xtf32,
                                      split_tf32, tf32_round)

WIDTHS = [3, 100, 512, 900, 1500, 2048]


def _float(bits: int) -> float:
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("x_bits, want_bits", [
    # 1 + 2^-11 is halfway between 1 and 1 + 2^-10: ties away from zero.
    (0x3F800000 | 0x1000, 0x3F800000 | 0x2000),
    # Just below the tie rounds down; just above rounds up.
    (0x3F800000 | 0x0FFF, 0x3F800000),
    (0x3F800000 | 0x1001, 0x3F800000 | 0x2000),
    # 1 + 3 2^-11: a tie above an odd TF32 value still goes away from 0.
    (0x3F800000 | 0x3000, 0x3F800000 | 0x4000),
    # Negatives round their magnitude the same way.
    (0xBF800000 | 0x1000, 0xBF800000 | 0x2000),
    (0xBF800000 | 0x0FFF, 0xBF800000),
    # Zeros keep their sign.
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    # Subnormals round on the same grid of their bit pattern.
    (0x00000FFF, 0x00000000),
    (0x00001000, 0x00002000),
    (0x80001800, 0x80002000),
    # The largest finite value rounds to infinity (away from zero).
    (0x7F7FFFFF, 0x7F800000),
    # Infinities and NaN are kept.
    (0x7F800000, 0x7F800000),
    (0xFF800000, 0xFF800000),
])
def test_tf32_round_bit_patterns(x_bits, want_bits):
    x = torch.tensor([_float(x_bits)], dtype=torch.float32)
    got = int(tf32_round(x).view(torch.int32).numpy().view(np.uint32)[0])
    assert got == want_bits, (hex(got), hex(want_bits))


def test_tf32_round_keeps_nan_and_clears_low_bits():
    x = torch.tensor([float("nan")], dtype=torch.float32)
    assert bool(torch.isnan(tf32_round(x)).all())
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    low = tf32_round(y).view(torch.int32) & 0x1FFF
    assert int(low.abs().max()) == 0
    # Within half a TF32 ulp (2^-11 relative).
    assert float(((tf32_round(y) - y).abs() / y.abs()).max()) <= 2 ** -11


def test_tf32_round_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tf32_round(torch.zeros(3, dtype=torch.float64))


def test_split_recovers_the_value():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        (rng.standard_normal(100_000) * 10.0 ** rng.integers(-20, 20, 100_000)
         ).astype(np.float32))
    hi, lo = split_tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    gap = (hi.double() + lo.double() - x.double()).abs()
    assert bool((gap <= 2 ** -22 * x.double().abs()).all())


@pytest.fixture(scope="module")
def product():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 3072)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3072, 512)).astype(np.float32))
    exact = a.double() @ b.double()
    return a, b, exact, float(exact.abs().max())


def test_matmul_3xtf32_keeps_fp32(product):
    a, b, exact, scale = product
    err = float((matmul_3xtf32(a, b).double() - exact).abs().max())
    assert err <= 1e-6 * scale, err / scale


def test_matmul_1xtf32_is_8x_further_off(product):
    a, b, exact, scale = product
    err3 = float((matmul_3xtf32(a, b).double() - exact).abs().max())
    err1 = float((matmul_1xtf32(a, b).double() - exact).abs().max())
    assert err1 >= 8 * err3, (err1 / scale, err3 / scale)


def test_matmul_3xtf32_of_tf32_values_is_their_product():
    # On operands that are TF32 already, lo is 0 and the product is one
    # fp32 matmul of them.
    rng = np.random.default_rng(3)
    a = tf32_round(torch.from_numpy(rng.standard_normal((8, 40)).astype(
        np.float32)))
    b = tf32_round(torch.from_numpy(rng.standard_normal((40, 5)).astype(
        np.float32)))
    assert torch.equal(matmul_3xtf32(a, b), a @ b)
    assert torch.equal(matmul_1xtf32(a, b), a @ b)


@pytest.mark.parametrize("compute_dtype", fg_ops.COMPUTE_DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_featurize_plan_covers_width(d, compute_dtype):
    plan = fg_ops.featurize_plan(d, compute_dtype)
    assert plan.rows in fg_ops.ROWS and 1 <= plan.stages <= 4
    assert plan.d_pad >= d and plan.d_pad % fg_ops.TILE == 0
    assert plan.smem == fg_ops.smem_bytes(d, plan.rows, plan.stages,
                                          compute_dtype)
    assert plan.smem <= fg_ops.MAX_SMEM


def test_featurize_plan_choices():
    # The raw path's width takes 64-row tiles (two 32-deep stages in fp32,
    # three in bf16); wider F trades rows first, then ring depth.
    def rows_stages(d, cd="fp32"):
        plan = fg_ops.featurize_plan(d, cd)
        return plan.rows, plan.stages

    assert rows_stages(512) == (64, 2)
    assert rows_stages(512, "bf16") == (64, 3)
    assert rows_stages(900) == (32, 2)
    assert rows_stages(2048) == (16, 4)
    assert rows_stages(3200) == (16, 1)
    # Each plan is the tallest tile that fits: one row step up does not.
    for d in WIDTHS:
        plan = fg_ops.featurize_plan(d, "fp32")
        if plan.rows < 64:
            assert fg_ops.smem_bytes(d, 2 * plan.rows, 2, "fp32") \
                > fg_ops.MAX_SMEM
    with pytest.raises(ValueError):
        fg_ops.featurize_plan(4096, "fp32")
    with pytest.raises(ValueError):
        fg_ops.featurize_plan(512, "fp16")


@pytest.mark.parametrize("d", WIDTHS)
def test_project_plan_covers_width(d):
    plan = gp_ops.project_plan(d)
    assert plan.bk in gp_ops.MAX_DEPTH and plan.stages in (1, 2)
    assert d <= plan.d_pad <= gp_ops.MAX_DEPTH[plan.bk]
    assert plan.smem == gp_ops.smem_bytes(d, plan.bk, plan.stages)
    assert plan.smem <= gp_ops.MAX_SMEM


def test_project_plan_choices():
    # The blockwise path's width takes the 64-column slab with two X tiles
    # in flight; the widest depth the kernel takes is 2048.
    plan = gp_ops.project_plan(512)
    assert (plan.bk, plan.stages) == (64, 2)
    assert [gp_ops.project_plan(d).bk for d in (100, 900, 1500, 2048)] \
        == [64, 32, 16, 8]
    with pytest.raises(ValueError):
        gp_ops.project_plan(2049)
    with pytest.raises(ValueError):
        gp_ops.project_plan(0)
