"""The port's hierarchical two-level protocol against the JAX package.

``hierarchical_one_shot(device="cpu")`` runs with the kernels' plain
versions against the reference's ``hierarchical_one_shot`` with
``ClusterConfig(backend="jnp")``, on the inputs of
``tests/test_hierarchy.py``.  Tolerances: ``labels`` the same partition;
``group_ids``, ``local_labels`` (each group's clusters numbered by their
smallest member, a function of the partition) and ``entry_counts``
equal; ``entry_lam`` to rtol 1e-4; the ledger equal.  Raw ``V`` is never
compared (``eigh``'s signs are free).

At ``top_k = 6`` on these d = 16 mixtures an entry's mean Gram has two
large eigenvalues and a tail of near-equal small ones (gaps of about
3e-4), so its top-6 eigenvectors are not determined past the first two:
on the same signatures two fp32 ``eigh`` give entry projectors 1.5e-4
apart, and a one-ulp nudge of the reference's own inputs moves its
``V_e V_e^T``, its ``entry_protos`` and its ``global_similarity`` by the
spread in ``NUDGE_SPREAD`` (the largest over three nudge seeds, measured
on the CPU; up to 6.8e-4, 5.6e-5 and 3.0e-4).  So the determined
quantities are held end to end at 1e-5: the projector onto the
eigenvectors above the entry's last large spectral gap, and the rank-k
reconstruction ``V_e diag(lam_e) V_e^T``.  ``entry_protos`` (atol 1e-5),
``global_similarity`` (atol 1e-4, the tolerance ``test_torch_oneshot.py``
uses for R) and the full projectors are held at those bars on the
reference's own signatures (``test_stages_on_reference_signatures``), and
end to end at the larger of those bars and 4x the reference's spread
under a one-ulp nudge of its inputs, the largest over three nudge seeds,
measured here; that spread must stay within 2x of ``NUDGE_SPREAD``, so a
drift in it shows.  The grouped plain versions of the two kernels with a
group axis equal G single plain calls exactly, and the batched cut equals
the per-group cut.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import host, same_partition
from repro.core import hierarchy as ref_hier
from repro.core.cluster_engine import ClusterConfig as RefClusterConfig
from repro.core.similarity import SimilarityConfig as RefSimilarityConfig
from repro.data import synthetic as ref_syn
from repro.fed import partition as ref_part
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core import hierarchy as hier
from repro_torch.core import oneshot
from repro_torch.core.cluster_engine import (ClusterConfig, cut_device,
                                             cut_device_grouped)
from repro_torch.core.hierarchy import (HierarchicalResult, HierarchyConfig,
                                        hierarchical_one_shot)
from repro_torch.core.membership_engine import (MembershipConfig,
                                                MembershipEngine)
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data.features import FeatureConfig
from repro_torch.fed import partition as fpart
from repro_torch.kernels.eigproject import (project_norms_all,
                                            project_norms_grouped)
from repro_torch.kernels.linkage import (LINKAGES, nn_chain,
                                         nn_chain_grouped)
from repro_torch.launch import membership as launch_membership
from repro_torch.launch import protocol as launch_protocol

TASKS = 4
TOP_K = 6

#: (n users, mixture seed, HierarchyConfig fields): the inputs of
#: ``tests/test_hierarchy.py``.
CASES = {
    "agrees_with_exact": (128, 5, dict(n_groups=8)),
    "contiguous": (96, 6, dict(n_groups=6)),
    "strided": (96, 6, dict(n_groups=6, assignment="strided")),
    "batched": (64, 7, dict(n_groups=8, group_batch=3)),
    "unbatched": (64, 7, dict(n_groups=8)),
    "group_clusters": (64, 8, dict(n_groups=4, group_clusters=5)),
}


def _mixture(n, seed=0, d=16, samples=16, tasks=TASKS):
    return ref_syn.make_task_feature_mixture(n, samples, d, tasks, seed=seed)


#: Per case, the reference's largest move over ``NUDGE_SEEDS`` under a
#: one-ulp nudge of its inputs (projectors, entry_protos,
#: global_similarity), as measured on the CPU.
NUDGE_SPREAD = {
    "agrees_with_exact": (2.63e-4, 4.76e-5, 7.03e-5),
    "contiguous": (1.82e-4, 2.77e-5, 1.10e-4),
    "strided": (6.76e-4, 5.53e-5, 1.17e-4),
    "batched": (9.02e-5, 3.69e-5, 2.97e-4),
    "unbatched": (9.02e-5, 3.69e-5, 2.97e-4),
    "group_clusters": (8.09e-5, 2.22e-5, 1.29e-4),
}
NUDGE_SEEDS = (1, 2, 3)


_REF: dict = {}


def _reference(case, nudge=0):
    """The reference's result on the case's mixture; ``nudge`` (a seed,
    0 for none): on the mixture moved by one ulp (x (1 + 1e-7 r), r
    standard normal)."""
    if (case, nudge) not in _REF:
        n, seed, hkw = CASES[case]
        feats, _ = _mixture(n, seed)
        if nudge:
            r = np.random.default_rng(nudge).standard_normal(feats.shape)
            feats = (feats * (1 + 1e-7 * r)).astype(np.float32)
        _REF[case, nudge] = ref_hier.hierarchical_one_shot(
            jnp.asarray(feats), TASKS, cfg=RefSimilarityConfig(top_k=TOP_K),
            hierarchy_cfg=ref_hier.HierarchyConfig(**hkw),
            cluster_cfg=RefClusterConfig(backend="jnp"))
    return _REF[case, nudge]


def _port(case, **over):
    n, seed, hkw = CASES[case]
    feats, tids = _mixture(n, seed)
    res = hierarchical_one_shot(
        feats, TASKS, cfg=SimilarityConfig(top_k=TOP_K),
        hierarchy_cfg=HierarchyConfig(**{**hkw, **over}), device="cpu")
    return res, tids


def _projectors(v):
    v = np.asarray(v, np.float64)
    return np.einsum("edk,efk->edf", v, v)


def _separated(v, lam, frac=0.1):
    """Each entry's projector onto its eigenvectors above the last
    spectral gap of at least ``frac`` x its largest eigenvalue, and the
    number of those eigenvectors."""
    v, lam = np.asarray(v, np.float64), np.asarray(lam, np.float64)
    out, ranks = np.empty(v.shape[:1] + v.shape[1:2] * 2), []
    for e, (ve, le) in enumerate(zip(v, lam)):
        big = np.flatnonzero(le[:-1] - le[1:] >= frac * le[0])
        r = int(big.max()) + 1 if big.size else le.size
        out[e] = ve[:, :r] @ ve[:, :r].T
        ranks.append(r)
    return out, ranks


def _reconstruction(v, lam):
    v, lam = np.asarray(v, np.float64), np.asarray(lam, np.float64)
    return np.einsum("edk,ek,efk->edf", v, lam, v)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference(case):
    res, tids = _port(case)
    ref = _reference(case)
    assert isinstance(res, HierarchicalResult)
    assert clu.adjusted_rand_index(host(res.labels), tids) == 1.0
    assert same_partition(res.labels, ref.labels)
    np.testing.assert_array_equal(host(res.group_ids),
                                  np.asarray(ref.group_ids))
    np.testing.assert_array_equal(host(res.local_labels),
                                  np.asarray(ref.local_labels))
    np.testing.assert_array_equal(host(res.entry_counts),
                                  np.asarray(ref.entry_counts))
    np.testing.assert_allclose(host(res.entry_lam), np.asarray(ref.entry_lam),
                               rtol=1e-4)
    sep, ranks = _separated(host(res.entry_v), host(res.entry_lam))
    sep_ref, ranks_ref = _separated(ref.entry_v, ref.entry_lam)
    assert ranks == ranks_ref
    np.testing.assert_allclose(sep, sep_ref, atol=1e-5)
    np.testing.assert_allclose(
        _reconstruction(host(res.entry_v), host(res.entry_lam)),
        _reconstruction(ref.entry_v, ref.entry_lam), atol=1e-5)
    nudged = [_reference(case, nudge=s) for s in NUDGE_SEEDS]
    for (name, got, want, alts, bar), recorded in zip((
            ("projectors", _projectors(host(res.entry_v)),
             _projectors(ref.entry_v),
             [_projectors(a.entry_v) for a in nudged], 1e-5),
            ("entry_protos", host(res.entry_protos), ref.entry_protos,
             [a.entry_protos for a in nudged], 1e-5),
            ("global_similarity", host(res.global_similarity),
             ref.global_similarity, [a.global_similarity for a in nudged],
             1e-4)), NUDGE_SPREAD[case]):
        spread = max(_gap(alt, want) for alt in alts)
        assert spread <= 2 * recorded, (name, spread, recorded)
        limit = max(bar, 4 * spread)
        assert _gap(got, want) <= limit, (name, _gap(got, want), limit)
    assert dataclasses.asdict(res.ledger) == dataclasses.asdict(ref.ledger)
    assert res.ledger.summary() == ref.ledger.summary()
    np.testing.assert_allclose(host(res.lam), np.asarray(ref.lam),
                               rtol=1e-4, atol=1e-6)


def test_group_batching_invariant():
    full, _ = _port("unbatched")
    batched, _ = _port("batched")
    assert torch.equal(full.labels, batched.labels)
    assert torch.equal(full.local_labels, batched.local_labels)
    assert torch.equal(full.entry_counts, batched.entry_counts)


def test_stitch_identity_and_directory_shapes():
    res, _ = _port("group_clusters")
    g, t_g = 4, 5
    entry_id = host(res.group_ids) * t_g + host(res.local_labels)
    np.testing.assert_array_equal(host(res.labels),
                                  host(res.entry_labels)[entry_id])
    assert tuple(res.entry_lam.shape) == (g * t_g, TOP_K)
    assert tuple(res.entry_v.shape) == (g * t_g, 16, TOP_K)
    assert tuple(res.entry_protos.shape) == (g * t_g, 16, 16)
    assert int(res.entry_counts.sum()) == 64
    assert tuple(res.global_similarity.shape) == (g * t_g, g * t_g)
    assert res.labels.dtype == res.local_labels.dtype == torch.int32
    assert res.group_ids.dtype == torch.int32


@pytest.mark.parametrize("case", ["agrees_with_exact", "strided",
                                  "group_clusters"])
@pytest.mark.parametrize("chunk_users", [0, 3])
def test_stages_on_reference_signatures(monkeypatch, case, chunk_users):
    """The compression and the global relevance on the reference's own
    signatures and entry ids: ``entry_protos`` to 1e-5, ``entry_lam`` to
    rtol 1e-4, the counts equal, the separated projectors to 1e-5, and
    ``signature_relevance`` of the reference's entry signatures to its
    ``global_similarity`` within 1e-4; with the entry sums formed a chunk
    of 3 users at a time too (``chunk_users``)."""
    from repro_torch.core import similarity as sim

    ref = _reference(case)
    t_g = CASES[case][2].get("group_clusters") or TASKS
    entry_id = torch.from_numpy(np.asarray(ref.group_ids) * t_g
                                + np.asarray(ref.local_labels)).long()
    if chunk_users:
        monkeypatch.setattr(hier, "_COMPRESS_CHUNK_ELEMS",
                            chunk_users * 16 * 16)
    lam_e, v_e, protos, counts = hier._compress_entries(
        torch.from_numpy(np.array(ref.lam)),
        torch.from_numpy(np.array(ref.v)), entry_id,
        n_entries=int(ref.entry_counts.shape[0]), top_k=TOP_K)
    np.testing.assert_allclose(host(protos), np.asarray(ref.entry_protos),
                               atol=1e-5)
    np.testing.assert_allclose(host(lam_e), np.asarray(ref.entry_lam),
                               rtol=1e-4)
    np.testing.assert_array_equal(host(counts), np.asarray(ref.entry_counts))
    np.testing.assert_allclose(_separated(host(v_e), host(lam_e))[0],
                               _separated(ref.entry_v, ref.entry_lam)[0],
                               atol=1e-5)
    r_global = sim.signature_relevance(
        torch.from_numpy(np.array(ref.entry_lam)),
        torch.from_numpy(np.array(ref.entry_v)))
    np.testing.assert_allclose(host(r_global),
                               np.asarray(ref.global_similarity), atol=1e-4)


# ---------------------------------------------------------------------------
# The group axis of the kernels' plain versions and of the cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,ng,d,k", [(3, 5, 9, 2), (4, 16, 16, 6),
                                      (1, 7, 32, 8), (2, 1, 4, 4)])
def test_project_norms_grouped_equals_single_calls(b, ng, d, k):
    gen = torch.Generator().manual_seed(b * 100 + ng)
    g = torch.randn((b, ng, d, d), generator=gen)
    v = torch.randn((b, ng, d, k), generator=gen)
    out = project_norms_grouped(g, v)
    assert tuple(out.shape) == (b, ng, ng, k)
    for i in range(b):
        assert torch.equal(out[i], project_norms_all(g[i], v[i]))


def test_project_norms_grouped_rejects_bad_shapes():
    with pytest.raises(ValueError, match="bad shapes"):
        project_norms_grouped(torch.zeros(2, 3, 4, 4), torch.zeros(2, 4, 4, 2))
    with pytest.raises(ValueError, match="bad shapes"):
        project_norms_grouped(torch.zeros(3, 4, 4), torch.zeros(3, 4, 2))


def _linkage_stack(b, n, seed, nan_group=None):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((b, n, n), generator=gen)
    s = (x + x.transpose(1, 2)) / 2
    s.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
    if nan_group is not None:
        s[nan_group, 1, 2] = s[nan_group, 2, 1] = float("nan")
    return s


@pytest.mark.parametrize("linkage", LINKAGES)
def test_nn_chain_grouped_equals_single_calls(linkage):
    s = _linkage_stack(5, 12, seed=1, nan_group=3)
    merges, heights, steps = nn_chain_grouped(s.clone(), linkage)
    assert tuple(merges.shape) == (5, 11, 2)
    assert tuple(heights.shape) == (5, 11) and tuple(steps.shape) == (5,)
    for i in range(5):
        m1, h1, st1 = nn_chain(s[i].clone(), linkage)
        assert torch.equal(merges[i], m1)
        assert torch.equal(heights[i], h1)
        assert int(steps[i]) == int(st1)
    # The NaN stops its own group only.
    done = host(steps) == 11
    assert not done[3] and done[[0, 1, 2, 4]].all()


def test_nn_chain_grouped_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        nn_chain_grouped(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="square"):
        nn_chain_grouped(torch.zeros(3, 3))


@pytest.mark.parametrize("n,n_clusters", [(12, 1), (12, 4), (12, 12),
                                          (9, 3)])
def test_cut_device_grouped_equals_per_group_cut(n, n_clusters):
    s = _linkage_stack(4, n, seed=n + n_clusters)
    merges, heights, _ = nn_chain_grouped(s.clone())
    labels = cut_device_grouped(merges, heights, n, n_clusters)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (4, n)
    for i in range(4):
        assert torch.equal(labels[i],
                           cut_device(merges[i], heights[i], n, n_clusters))


# ---------------------------------------------------------------------------
# fed.partition.group_stack_layout
# ---------------------------------------------------------------------------

def test_group_stack_layout_equals_reference():
    rng = np.random.default_rng(1)
    labels = rng.integers(-1, 4, 48)
    gids = np.repeat(np.arange(3), 16)
    gids[5] = 7                                # out of range: sentinel
    got = fpart.group_stack_layout(torch.from_numpy(labels),
                                   torch.from_numpy(gids), 3, 4)
    want = ref_part.group_stack_layout(jnp.asarray(labels),
                                       jnp.asarray(gids), 3, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(host(a), np.asarray(b))
    got = fpart.group_stack_layout(labels, gids, 3, 4, c_max=16)
    want = ref_part.group_stack_layout(labels, gids, 3, 4, c_max=16)
    np.testing.assert_array_equal(host(got[3]), np.asarray(want[3]))


def test_group_stack_layout_checks():
    with pytest.raises(ValueError, match="c_max"):
        fpart.group_stack_layout([0, 0, 0], [0, 0, 0], 1, 1, c_max=2)
    with pytest.raises(ValueError, match="align"):
        fpart.group_stack_layout(torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(5, dtype=torch.int32), 2, 2)


def test_hierarchical_result_feeds_layout():
    res, _ = _port("group_clusters", group_clusters=0)
    grows, rows, slot, mask = fpart.group_stack_layout(
        res.labels, res.group_ids, 4, TASKS)
    assert int(mask.sum()) == 64
    stack = torch.zeros(tuple(mask.shape))
    stack[grows.long(), rows.long(), slot.long()] = 1.0
    assert torch.equal(stack, mask)


# ---------------------------------------------------------------------------
# Entry points, serving and validation
# ---------------------------------------------------------------------------

def test_oneshot_entry_point_routes():
    feats, tids = _mixture(64, seed=9)
    res = oneshot.one_shot_clustering(
        feats, TASKS, cfg=SimilarityConfig(top_k=TOP_K),
        hierarchy_cfg=HierarchyConfig(n_groups=4), device="cpu")
    ref = ref_hier.hierarchical_one_shot(
        jnp.asarray(feats), TASKS, cfg=RefSimilarityConfig(top_k=TOP_K),
        hierarchy_cfg=ref_hier.HierarchyConfig(n_groups=4),
        cluster_cfg=RefClusterConfig(backend="jnp"))
    assert isinstance(res, HierarchicalResult)
    assert clu.adjusted_rand_index(host(res.labels), tids) == 1.0
    assert same_partition(res.labels, ref.labels)
    assert res.ledger.n_users == 16
    with pytest.raises(ValueError, match="pre-featurized"):
        oneshot.one_shot_clustering(
            feats, TASKS, hierarchy_cfg=HierarchyConfig(n_groups=4),
            feature_cfg=FeatureConfig(kind="identity"), device="cpu")


def test_from_oneshot_serves_hierarchical_result():
    feats, _ = _mixture(64, seed=10)
    res = hierarchical_one_shot(
        feats, TASKS, cfg=SimilarityConfig(top_k=TOP_K),
        hierarchy_cfg=HierarchyConfig(n_groups=4), device="cpu")
    eng = MembershipEngine.from_oneshot(
        res, MembershipConfig(backend="torch"), device="cpu")
    assert eng.state.n_clusters == TASKS
    out = eng.assign(res.lam, res.v)
    assert torch.equal(torch.as_tensor(out.labels).to(torch.int32),
                       res.labels)


def _run(feats, **kw):
    hkw = {k: kw.pop(k) for k in list(kw) if k in
           ("n_groups", "group_clusters", "group_batch", "assignment")}
    return hierarchical_one_shot(
        feats, TASKS, cfg=kw.pop("cfg", SimilarityConfig(top_k=TOP_K)),
        hierarchy_cfg=HierarchyConfig(**hkw), device="cpu", **kw)


@pytest.mark.parametrize("what,match", [
    ("not_divisible", "not divisible"),
    ("one_group", "n_groups must be >= 2"),
    ("assignment", "assignment must be one of"),
    ("group_clusters_negative", "group_clusters must be >= 0"),
    ("group_batch_negative", "group_batch must be >= 0"),
    ("group_clusters_range", r"group_clusters=3 must be in \[1, N/G=2\]"),
    ("n_clusters_range", r"n_clusters=4 must be in \[1, G\*T_g=2\]"),
    ("landmarks", "must be 0"),
    ("block_users", "must be 0"),
    ("numpy_backend", "batched"),
    ("shard_map", "single-host"),
])
def test_validation(what, match):
    feats, _ = _mixture(64)
    with pytest.raises(ValueError, match=match):
        if what == "not_divisible":
            _run(feats, n_groups=7)
        elif what == "one_group":
            HierarchyConfig(n_groups=1)
        elif what == "assignment":
            HierarchyConfig(n_groups=4, assignment="random")
        elif what == "group_clusters_negative":
            HierarchyConfig(n_groups=4, group_clusters=-1)
        elif what == "group_batch_negative":
            HierarchyConfig(n_groups=4, group_batch=-1)
        elif what == "group_clusters_range":
            _run(feats, n_groups=32, group_clusters=3)     # > N/G = 2
        elif what == "n_clusters_range":
            _run(feats, n_groups=2, group_clusters=1)      # G*T_g = 2 < 4
        elif what == "landmarks":
            _run(feats, n_groups=4,
                 cfg=SimilarityConfig(top_k=TOP_K, landmarks=8))
        elif what == "block_users":
            _run(feats, n_groups=4,
                 cfg=SimilarityConfig(top_k=TOP_K, block_users=8))
        elif what == "numpy_backend":
            _run(feats, n_groups=4,
                 cluster_cfg=ClusterConfig(backend="numpy"))
        else:
            _run(feats, n_groups=4,
                 cfg=SimilarityConfig(top_k=TOP_K, backend="shard_map"))


@pytest.mark.parametrize("group_batch,named", [(0, "[3]"), (2, "[1]")])
def test_group_hac_witness_names_the_groups(monkeypatch, group_batch,
                                            named):
    """NaN in the relevance of the last group of every batch stops that
    group's chain short, and the run raises naming the first such group
    (the reference's witness), counted across batches."""
    protocol = hier._batched_protocol

    def with_nan(feats, nv, top_k, eig_floor):
        big_r, lam, v = protocol(feats, nv, top_k, eig_floor)
        big_r[-1, 2, 5] = big_r[-1, 5, 2] = float("nan")
        return big_r, lam, v

    monkeypatch.setattr(hier, "_batched_protocol", with_nan)
    feats, _ = _mixture(64)
    with pytest.raises(ValueError, match=r"stopped early in group\(s\) "
                       + re.escape(named)):
        _run(feats, n_groups=4, group_batch=group_batch)


def test_messages_match_reference():
    """The validation the reference and the port share raises the
    reference's messages."""
    makers = [
        lambda m: m.HierarchyConfig(n_groups=1),
        lambda m: m.HierarchyConfig(n_groups=4, group_clusters=-2),
        lambda m: m.HierarchyConfig(n_groups=4, group_batch=-2),
        lambda m: m.HierarchyConfig(n_groups=4, assignment="random"),
        lambda m: m.group_permutation(10, m.HierarchyConfig(n_groups=4)),
    ]
    for make in makers:
        with pytest.raises(ValueError) as got:
            make(hier)
        with pytest.raises(ValueError) as want:
            make(ref_hier)
        assert str(got.value) == str(want.value)


def test_group_permutation_equals_reference():
    for assignment in ("contiguous", "strided"):
        for n, g in ((16, 4), (96, 6), (12, 2)):
            np.testing.assert_array_equal(
                hier.group_permutation(n, HierarchyConfig(
                    n_groups=g, assignment=assignment)),
                ref_hier.group_permutation(n, ref_hier.HierarchyConfig(
                    n_groups=g, assignment=assignment)))


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    feats, _ = _mixture(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hierarchical_one_shot(feats, TASKS,
                              hierarchy_cfg=HierarchyConfig(n_groups=2))


def test_hierarchy_config_from_reference():
    for kw in (dict(n_groups=8), dict(n_groups=6, group_clusters=5,
                                      group_batch=3, assignment="strided")):
        got = convert.hierarchy_config_from_reference(
            ref_hier.HierarchyConfig(**kw))
        assert got == HierarchyConfig(**kw)


def test_greedy_match_labels_equals_reference():
    rng = np.random.default_rng(0)
    new = rng.integers(-1, 4, 64)
    old = rng.integers(-1, 4, 64)
    np.testing.assert_array_equal(hier.greedy_match_labels(new, old, 4),
                                  ref_hier.greedy_match_labels(new, old, 4))


def test_protocol_launcher_groups(capsys):
    acc = launch_protocol.main(["--groups", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert acc == 1.0
    assert "clustering accuracy 100.0%" in out
    assert "directory: 8 groups -> 32 entries -> 4 global clusters" in out
    assert "WITHIN its 32-user edge group" in out
    acc = launch_protocol.main(["--groups", "8", "--group-clusters", "6",
                                "--group-batch", "3", "--users", "128",
                                "--device", "cpu"])
    assert acc == 1.0
    assert "8 groups -> 48 entries" in capsys.readouterr().out


def test_membership_launcher_seed_groups(capsys):
    cells = launch_membership.main(["--seed-groups", "4", "--device",
                                    "cpu"])
    out = capsys.readouterr().out
    assert "hierarchical (4 groups) protocol + HAC" in out
    assert "clustering accuracy 100.0%" in out
    assert cells[0]["seed_accuracy"] == 1.0
