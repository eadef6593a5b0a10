"""The NN-chain's cached-neighbour bookkeeping and the scan and chain
plans, on the CPU.

``nn_chain_cached_ref`` is the plain model of what the CUDA chain kernel
keeps: every live row's nearest neighbour, updated at each merge and
rescanned only where its neighbour merged away with a lower value.  It
must give ``nn_chain_ref``'s merges and heights bit for bit and the same
step count, and with ``verify=True`` it recomputes every live row's
argmax after each merge and fails where the cache differs.  The card can
show only the kernel's result; these tests show the cache itself stays
exact.  Inputs are seeded through numpy; the labels are also held to the
JAX reference's ``ClusterEngine`` (``backend="jnp"``) on the same R.
"""
import numpy as np
import pytest
import torch

from _torch_support import same_partition, t
from repro.core.cluster_engine import ClusterConfig as RefClusterConfig
from repro.core.cluster_engine import ClusterEngine as RefClusterEngine
from repro_torch.core.cluster_engine import cut_device
from repro_torch.kernels.linkage import (LINKAGES, chain_plan,
                                         nn_chain_cached_ref, nn_chain_ref)
from repro_torch.kernels.linkage import ops as lk_ops
from repro_torch.kernels.recurrent_scan import linear_scan_plan

#: Shared memory a block may use on the H100 (opt-in maximum).
MAX_SMEM = 232448


def prepared(r):
    s = t(r)
    s.fill_diagonal_(float("-inf"))
    return s


def random_sim(n, seed):
    r = np.random.default_rng(seed).uniform(size=(n, n))
    return prepared((r + r.T) / 2)


def grid_sim(n, seed):
    """Values on a grid of 1/8: ties everywhere."""
    r = np.random.default_rng(seed).integers(0, 8, size=(n, n)) / 8
    return prepared(np.maximum(r, r.T))


def assert_same_chain(s, linkage):
    want = nn_chain_ref(s.clone(), linkage)
    got = nn_chain_cached_ref(s.clone(), linkage, verify=True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2])
    return got


@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("n", [2, 9, 64, 300])
def test_cached_chain_equals_plain_loop(linkage, n):
    got = assert_same_chain(random_sim(n, n), linkage)
    assert int(got[2]) == n - 1
    assert got[3]["iterations"] >= n - 1


@pytest.mark.parametrize("linkage", LINKAGES)
def test_cached_chain_on_ties(linkage):
    got = assert_same_chain(grid_sim(120, 3), linkage)
    assert int(got[2]) == 119


@pytest.mark.parametrize("linkage", LINKAGES)
def test_cached_chain_on_nan(linkage):
    s = random_sim(40, 1)
    s[2, 7] = s[7, 2] = float("nan")
    s[11, 30] = float("nan")
    got = assert_same_chain(s, linkage)
    assert int(got[2]) < 39


@pytest.mark.parametrize("linkage", LINKAGES)
def test_cached_chain_on_inf_rows(linkage):
    """An all--inf row (its argmax is index 0 whatever the mask), and a
    row past FLT_MAX / 2, whose average with itself overflows in the
    extension step: the cache keeps that step's value."""
    s = random_sim(41, 2)
    s[5, :] = s[:, 5] = float("-inf")
    s[3, :] = s[:, 3] = 3e38
    s[3, 3] = float("-inf")
    assert_same_chain(s, linkage)


@pytest.mark.parametrize("linkage", LINKAGES)
def test_cached_chain_labels_match_reference(linkage):
    r = np.random.default_rng(7).uniform(size=(48, 48))
    r = ((r + r.T) / 2).astype(np.float32)
    np.fill_diagonal(r, 1.0)
    merges, heights, steps, _ = nn_chain_cached_ref(prepared(r), linkage)
    assert int(steps) == 47
    ref = RefClusterEngine(RefClusterConfig(backend="jnp", linkage=linkage))
    dend = ref.hac(r)
    for n_clusters in (1, 3, 8, 48):
        assert same_partition(cut_device(merges, heights, 48, n_clusters),
                              np.asarray(ref.cut(dend, n_clusters)))


def test_counted_helper_needs_the_card():
    """The kernel's counters come from the card alone: on a CPU tensor the
    private helper raises (the plain model gives them there)."""
    s = random_sim(30, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lk_ops._nn_chain_counted(s.clone())


@pytest.mark.parametrize("n", [0, 2, 1024, 11019, 11020, 19370, 19371,
                               20000, 100000])
def test_chain_plan(n):
    plan = chain_plan(n)
    assert plan.smem <= lk_ops.SMEM_LIMIT <= MAX_SMEM
    assert plan.scratch >= 21 * n
    if n > 11019:
        assert plan.route == "scratch" and plan.smem == 0
    else:
        assert plan.route == "smem" and plan.smem == plan.scratch


@pytest.mark.parametrize("b,s,d,aligned,route", [
    (1, 4096, 4096, True, "tma"), (1, 4096, 4097, True, "cp.async4"),
    (3, 77, 512, True, "tma"), (1, 300, 1024, False, "cp.async4"),
    (2, 5, 6, True, "cp.async4"), (1, 0, 8, True, "cp.async4"),
    (1, 1, 100, True, "tma")])
def test_linear_scan_plan(b, s, d, aligned, route):
    plan = linear_scan_plan(b, s, d, aligned)
    assert plan.route == route
    assert plan.smem <= MAX_SMEM and plan.tokens % 16 == 0
    assert plan.blocks == b * -(-d // 32)
    # Three stages in flight keep at least Little's law's 26 KB an SM.
    assert (plan.stages - 1) * plan.tokens * 32 * 4 * 2 >= 26 * 1024
