"""The redesigned eigen-projection kernel's layout and arithmetic, on the
CPU.

The kernel splits the stacked signature matrix ``W = [V_0 | V_1 | ...]``
once into TF32 hi and lo, laid out transposed (``split_w_ref``: stacked
column ``j k + c`` as a row, d contiguous, rows ``eig_plan(d).pitch``
apart), and computes ``||G_i W||`` per column as 3xTF32 on the tensor
cores.  Its plain model (``project_norms_all_tf32``) is held against the
reference's Pallas ``project_norms`` in interpret mode, pair by pair, to
1e-5 of the largest norm (3xTF32 keeps about 21 bits of each operand;
fp32 sums in another order), on G that is not symmetric; the 1xTF32
product (``hi hi`` alone) lands at least 8x further off, the separation
the card's checks require.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import host, t
from repro.kernels.eigproject import ops as ref_proj
from repro_torch.kernels.eigproject import (eig_plan, project_norms_all,
                                            project_norms_all_ref,
                                            project_norms_all_tf32,
                                            split_w_ref)
from repro_torch.kernels.eigproject.ref import stacked_w
from repro_torch.kernels.tf32 import split_tf32

WIDTHS = [1, 9, 32, 130, 512, 784]


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_route_pitch_and_shared_memory(d):
    plan = eig_plan(d)
    assert plan.route == ("cp.async4" if 4 * d % 16 else "tma")
    assert plan.pitch % 4 == 0 and d <= plan.pitch < d + 4
    assert plan.smem <= 232448


def test_plan_rejects_empty_width():
    with pytest.raises(ValueError):
        eig_plan(0)


@pytest.mark.parametrize("n_v,d,k", [(3, 9, 2), (5, 130, 5), (2, 512, 8),
                                     (1, 1, 1)])
def test_split_layout(n_v, d, k):
    """Row j k + c of each half holds split_tf32 of column c of V_j, d
    contiguous; hi + lo is within 2^-22 of the value; the pad is 0."""
    v = t(np.random.default_rng(d + k).standard_normal((n_v, d, k)))
    wt = split_w_ref(v)
    assert wt.shape == (2, n_v * k, eig_plan(d).pitch)
    w = stacked_w(v)
    for j in range(n_v):
        for c in range(k):
            assert torch.equal(w[:, j * k + c], v[j][:, c])
            hi, lo = split_tf32(v[j][:, c])
            assert torch.equal(wt[0, j * k + c, :d], hi)
            assert torch.equal(wt[1, j * k + c, :d], lo)
    assert not wt[:, :, d:].any()
    assert float((wt[0, :, :d] + wt[1, :, :d] - w.t()).abs().max()
                 ) <= 2 ** -22 * float(v.abs().max())


@pytest.mark.parametrize("n_g,n_v,d,k", [(2, 3, 9, 2), (3, 2, 33, 3),
                                         (2, 2, 130, 5), (1, 2, 256, 8)])
def test_3xtf32_matches_pallas(n_g, n_v, d, k):
    rng = np.random.default_rng(n_g * 100 + d + k)
    g = rng.standard_normal((n_g, d, d)).astype(np.float32)  # not symmetric
    v = rng.standard_normal((n_v, d, k)).astype(np.float32)
    want = np.stack([np.stack([np.asarray(ref_proj.project_norms(
        jnp.asarray(g[i]), jnp.asarray(v[j]), interpret=True))
        for j in range(n_v)]) for i in range(n_g)])
    got = host(project_norms_all_tf32(t(g), t(v)))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale
    err_1x = float(np.abs(host(project_norms_all_tf32(t(g), t(v), 1))
                          - want).max())
    assert 8 * err <= err_1x, (err, err_1x)
    # The fp32 plain version (the wrapper on the CPU) is the same function.
    assert float(np.abs(host(project_norms_all(t(g), t(v))) - want).max()
                 ) <= 1e-5 * scale


def test_emulation_rejects_other_product_counts():
    with pytest.raises(ValueError, match="products"):
        project_norms_all_tf32(torch.zeros(1, 2, 2), torch.zeros(1, 2, 1), 2)


def test_emulation_chunks_exactly(monkeypatch):
    from repro_torch.kernels.eigproject import ref as proj_ref

    rng = np.random.default_rng(4)
    g = t(rng.standard_normal((7, 6, 6)))
    v = t(rng.standard_normal((5, 6, 2)))
    whole = project_norms_all_tf32(g, v)
    monkeypatch.setattr(proj_ref, "CHUNK_BYTES", 1)
    assert torch.equal(project_norms_all_tf32(g, v), whole)
    assert torch.allclose(whole, project_norms_all_ref(g, v), rtol=1e-5)
