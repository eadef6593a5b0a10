"""The port's membership serving against the JAX package's.

Both engines are seeded with the same signatures (the reference's own
one-shot result), and both sides see the same waves.  The port's numpy
backend is held against the reference's numpy backend, and its torch
backend (on the CPU: the assign kernel's plain version) against the
reference's jnp backend, the mapping ``convert.py`` makes (fp32 scoring).

Tolerances:
  * engine state after seed, assign, admit, evict and re-cluster:
    prototypes within 1e-6 (entries are <= 1; the port forms each
    cluster's sum as one matmul over its members, the reference over the
    whole table: fp32 sums in another order), counts, labels, ``valid``
    and slots equal, drift statistics within 1e-6;
  * the corruption injectors, ``stack_layout`` and ``admit_layout``:
    equal to the reference;
  * the launcher's ``--matrix --quick`` summaries: equal (accuracy per
    wave, final unassigned fraction and re-cluster waves) in all eight
    cells, on both port backends.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import CPU, host, t
from repro.core import oneshot as ref_oneshot
from repro.core import similarity as ref_sim
from repro.core.engine import ProtocolEngine as RefProtocolEngine
from repro.core.hierarchy import greedy_match_labels as ref_greedy
from repro.core.membership_engine import (MembershipConfig as RefConfig,
                                          MembershipEngine as RefEngine,
                                          _protos_from_table_robust
                                          as ref_robust)
from repro.data import synthetic as ref_syn
from repro.fed import partition as ref_part
from repro.launch import membership as ref_launch
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core.hierarchy import greedy_match_labels
from repro_torch.core.membership_engine import (
    UNASSIGNED, MembershipConfig, MembershipEngine, _protos_from_table,
    _protos_from_table_robust, signature_relevance)
from repro_torch.data import synthetic as syn
from repro_torch.fed import partition as fpart
from repro_torch.launch import membership as launch

BACKENDS = ("numpy", "torch")
#: Port backend -> the reference backend it is held against.
REF_BACKEND = {"numpy": "numpy", "torch": "jnp"}
N_SEED, N_TASKS, D, TOP_K = 24, 3, 16, 6
CAP, TD, TK, TT = 32, 8, 4, 3          # tiny table for aggregator tests


@pytest.fixture(scope="module")
def seed_result():
    feats, task_ids = ref_syn.make_task_feature_mixture(
        n_users=N_SEED, n_samples=48, d=D, n_tasks=N_TASKS, seed=7)
    res = ref_oneshot.one_shot_clustering(
        jnp.asarray(feats), N_TASKS, cfg=ref_sim.SimilarityConfig(top_k=TOP_K))
    return (np.asarray(res.lam), np.asarray(res.v),
            np.asarray(res.labels), task_ids)


@pytest.fixture(scope="module")
def wave():
    feats, task_ids = ref_syn.make_task_feature_mixture(
        n_users=N_SEED + 9, n_samples=48, d=D, n_tasks=N_TASKS, seed=7)
    lam, v, _ = RefProtocolEngine(ref_sim.SimilarityConfig(
        top_k=TOP_K)).signatures(jnp.asarray(feats[N_SEED:]))
    return np.asarray(lam), np.asarray(v), task_ids[N_SEED:]


def make_engine(seed_result, backend, **cfg_kw):
    lam, v, labels, _ = seed_result
    eng = MembershipEngine(MembershipConfig(backend=backend, **cfg_kw),
                           device="cpu")
    eng.seed(lam, v, labels, n_clusters=N_TASKS)
    return eng


def make_ref(seed_result, backend, **cfg_kw):
    lam, v, labels, _ = seed_result
    eng = RefEngine(RefConfig(backend=REF_BACKEND[backend], **cfg_kw))
    eng.seed(lam, v, labels, n_clusters=N_TASKS)
    return eng


def assert_same_state(port, ref):
    a, b = port.state, ref.state
    np.testing.assert_allclose(host(a.protos_f32), np.asarray(b.protos_f32),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(host(a.counts), np.asarray(b.counts))
    np.testing.assert_array_equal(host(a.labels), np.asarray(b.labels))
    np.testing.assert_array_equal(host(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(host(a.v), np.asarray(b.v))
    assert a.n_clusters == b.n_clusters
    assert a.n_reclusters == b.n_reclusters
    assert a.directory_bytes == b.directory_bytes
    sa, sb = port.drift_stats(), ref.drift_stats()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key] == pytest.approx(sb[key], abs=1e-6), key


class TestEngineParity:
    """The whole lifecycle on both engines, step by step."""

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("agg", ["mean", "trimmed", "medians"])
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_lifecycle_matches_reference(self, seed_result, wave, backend,
                                         agg, dtype):
        kw = dict(aggregator=agg, directory_dtype=dtype, trim_frac=0.2,
                  mom_groups=3, compute_dtype="fp32")
        port = make_engine(seed_result, backend, **kw)
        ref = make_ref(seed_result, backend, **kw)
        assert_same_state(port, ref)
        lam_w, v_w, _ = wave
        out = port.assign(lam_w, v_w)
        ref_out = ref.assign(lam_w, v_w)
        np.testing.assert_array_equal(host(out.labels),
                                      np.asarray(ref_out.labels))
        np.testing.assert_allclose(host(out.affinity),
                                   np.asarray(ref_out.affinity), atol=1e-6)
        slots = port.admit(lam_w, v_w, out.labels)
        np.testing.assert_array_equal(
            slots, ref.admit(lam_w, v_w, ref_out.labels))
        assert_same_state(port, ref)
        gone = slots[::2].tolist() + [0, 5]
        port.evict(gone)
        ref.evict(gone)
        assert_same_state(port, ref)
        assert port.recluster(force=True) and ref.recluster(force=True)
        assert_same_state(port, ref)

    def test_convert_maps_backends(self):
        for ref_backend, want in (("numpy", ("numpy", "bf16")),
                                  ("jnp", ("torch", "fp32")),
                                  ("pallas", ("torch", "bf16"))):
            cfg = convert.membership_config_from_reference(
                RefConfig(backend=ref_backend, margin_floor=0.1,
                          aggregator="trimmed", directory_dtype="int8"))
            assert (cfg.backend, cfg.compute_dtype) == want
            assert cfg.margin_floor == 0.1 and cfg.aggregator == "trimmed"
            assert cfg.directory_dtype == "int8"


class TestSeedParity:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_seed_reassigned_exact(self, seed_result, backend):
        lam, v, labels, _ = seed_result
        out = make_engine(seed_result, backend).assign(lam, v)
        np.testing.assert_array_equal(host(out.labels), labels)
        assert (host(out.margin) > 0).all()

    def test_backends_agree_with_reference(self, seed_result, wave):
        lam_w, v_w, _ = wave
        want = np.asarray(make_ref(seed_result, "numpy").assign(
            lam_w, v_w).labels)
        for backend in BACKENDS:
            for cd in ("fp32", "bf16"):
                got = make_engine(seed_result, backend,
                                  compute_dtype=cd).assign(lam_w, v_w)
                np.testing.assert_array_equal(host(got.labels), want)

    def test_wave_matches_oracle(self, seed_result, wave):
        _, _, seed_labels, seed_tasks = seed_result
        lam_w, v_w, wave_tasks = wave
        out = make_engine(seed_result, "torch").assign(lam_w, v_w)
        task_of = np.array([np.bincount(
            seed_tasks[seed_labels == t]).argmax() for t in range(N_TASKS)])
        np.testing.assert_array_equal(task_of[host(out.labels)], wave_tasks)


class TestConstruction:
    def test_missing_signatures_raise(self):
        bare = types.SimpleNamespace(lam=None, v=None, labels=np.zeros(3))
        with pytest.raises(ValueError, match="signatures"):
            MembershipEngine.from_oneshot(bare, device="cpu")

    def test_from_oneshot_takes_port_result(self):
        from repro_torch.core.oneshot import one_shot_clustering
        feats, tasks = syn.make_task_feature_mixture(16, 32, 16, 2, seed=3)
        res = one_shot_clustering(feats, 2, device="cpu")
        eng = MembershipEngine.from_oneshot(res, device="cpu")
        assert eng.state.n_members == 16 and eng.state.capacity == 32
        np.testing.assert_array_equal(
            host(eng.assign(res.lam, res.v).labels), host(res.labels))

    def test_capacity_too_small_raises(self, seed_result):
        with pytest.raises(ValueError, match="capacity"):
            make_engine(seed_result, "torch", capacity=N_SEED - 1)

    def test_unseeded_engine_raises(self):
        with pytest.raises(ValueError, match="directory is empty"):
            MembershipEngine(device="cpu").assign(
                np.zeros((1, TOP_K)), np.zeros((1, D, TOP_K)))

    def test_default_device_raises_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MembershipEngine(MembershipConfig(backend="torch"))
        assert MembershipEngine(MembershipConfig(backend="numpy")).device \
            is None
        assert MembershipEngine(device="cpu").device == CPU

    @pytest.mark.parametrize("kw", [
        {"backend": "cuda"},
        {"backend": "jnp"},
        {"capacity": -1},
        {"recluster_unassigned_frac": 0.0},
        {"recluster_unassigned_frac": 1.5},
        {"recluster_proto_shift": 0.0},
        {"eig_floor": 0.0},
        {"compute_dtype": "fp16"},
        {"aggregator": "nope"},
        {"trim_frac": 0.5},
        {"trim_frac": -0.1},
        {"mom_groups": 0},
        {"drift_stat": "mean"},
        {"directory_dtype": "fp8"},
    ])
    def test_config_validation(self, kw):
        with pytest.raises(ValueError):
            MembershipConfig(**kw)

    def test_verdict_and_floors_equal_reference(self):
        # The torch backend's verdict (the kernels' argmax and margin, as
        # their plain ``verdict``) and ``_apply_floors`` against the
        # reference's verdict-plus-floors rule on the same affinity rows.
        from repro.core.membership_engine import (
            _verdict_from_affinity as ref_verdict)
        from repro_torch.core.membership_engine import _apply_floors
        from repro_torch.kernels.assign.ref import verdict
        rng = np.random.default_rng(6)
        aff = rng.uniform(size=(9, 4)).astype(np.float32)
        aff[1, 2] = aff[1, 0] = aff[1].max() + 1.0      # tie: first wins
        aff[2, :3] = -np.inf                            # one live column
        for cols in (aff, aff[:, :1]):
            raw, margin = verdict(t(cols))
            labels = _apply_floors(raw, t(cols).max(dim=1).values, margin,
                                   0.2, 0.05)
            r_labels, r_margin = ref_verdict(jnp.asarray(cols), 0.2, 0.05)
            np.testing.assert_array_equal(host(labels), np.asarray(r_labels))
            np.testing.assert_array_equal(host(margin), np.asarray(r_margin))

    def test_assign_sharded_not_ported(self, seed_result):
        """The directory sharded over a one-rank mesh: the verdict of the
        single-device path in fp32 (the reference's W = 1 case; the
        sharded product runs in fp32, as the reference's einsum does)."""
        from _torch_dist_support import one_rank_world

        lam, v, _, _ = seed_result
        eng = make_engine(seed_result, "torch", compute_dtype="fp32")
        single = eng.assign(lam, v)
        with one_rank_world() as mesh:
            sharded = eng.assign_sharded(lam, v, mesh=mesh)
        np.testing.assert_array_equal(host(sharded.labels),
                                      host(single.labels))
        np.testing.assert_allclose(host(sharded.affinity),
                                   host(single.affinity), atol=1e-5)
        np.testing.assert_allclose(host(sharded.margin),
                                   host(single.margin), atol=1e-5)

    def test_assign_sharded_requires_device_backend(self, seed_result):
        lam, v, _, _ = seed_result
        with pytest.raises(ValueError, match="device backend"):
            make_engine(seed_result, "numpy").assign_sharded(lam, v)


class TestUnassignedBucket:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_margin_floor_unassigns(self, seed_result, wave, backend):
        lam_w, v_w, _ = wave
        out = make_engine(seed_result, backend, margin_floor=10.0).assign(
            lam_w, v_w)
        assert (host(out.labels) == UNASSIGNED).all()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_affinity_floor_unassigns(self, seed_result, backend):
        junk = np.linalg.qr(np.random.default_rng(0).standard_normal(
            (D, TOP_K)))[0].astype(np.float32)
        out = make_engine(seed_result, backend, affinity_floor=0.9).assign(
            np.ones((1, TOP_K), np.float32), junk[None])
        assert host(out.labels)[0] == UNASSIGNED

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_emptied_cluster_cannot_win(self, seed_result, backend):
        lam, v, labels, _ = seed_result
        eng = make_engine(seed_result, backend)
        gone = int(labels[0])
        eng.evict(np.flatnonzero(labels == gone))
        assert not (host(eng.assign(lam, v).labels) == gone).any()


class TestLifecycle:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_admit_then_evict_roundtrip(self, seed_result, wave, backend):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, backend)
        st0 = eng.state
        slots = eng.admit(lam_w, v_w, eng.assign(lam_w, v_w).labels)
        assert eng.state.n_members == N_SEED + len(lam_w)
        eng.evict(slots)
        np.testing.assert_array_equal(host(eng.state.valid), host(st0.valid))
        np.testing.assert_array_equal(host(eng.state.labels),
                                      host(st0.labels))
        np.testing.assert_allclose(host(eng.state.counts), host(st0.counts),
                                   atol=1e-5)
        np.testing.assert_allclose(host(eng.state.protos),
                                   host(st0.protos), atol=1e-5)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_streaming_admit_equals_rebuild(self, seed_result, wave,
                                            backend):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, backend)
        eng.admit(lam_w, v_w, eng.assign(lam_w, v_w).labels)
        st = eng.state
        rebuilt, counts = eng._rebuild_protos(st.v, st.labels, st.valid,
                                              st.n_clusters)
        np.testing.assert_allclose(host(st.protos), host(rebuilt), atol=1e-5)
        np.testing.assert_allclose(host(st.counts), host(counts), atol=1e-5)

    def test_unassigned_admit_skips_prototypes(self, seed_result, wave):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, "torch")
        protos0 = host(eng.state.protos)
        eng.admit(lam_w, v_w, np.full(len(lam_w), UNASSIGNED))
        np.testing.assert_allclose(host(eng.state.protos), protos0,
                                   atol=1e-6)
        assert eng.state.n_unassigned == len(lam_w)

    def test_directory_full_raises(self, seed_result, wave):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, "torch", capacity=N_SEED + 2)
        with pytest.raises(ValueError, match="directory full"):
            eng.admit(lam_w, v_w, np.zeros(len(lam_w)))

    def test_evicting_empty_or_duplicate_slots_raises(self, seed_result):
        eng = make_engine(seed_result, "torch")
        with pytest.raises(ValueError, match="empty slots"):
            eng.evict([eng.state.capacity - 1])
        with pytest.raises(ValueError, match="duplicate"):
            eng.evict([0, 0])

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_assignment_permutation_invariant(self, seed_result, wave,
                                              backend):
        lam, v, labels, _ = seed_result
        lam_w, v_w, _ = wave
        base = make_engine(seed_result, backend).assign(lam_w, v_w)
        perm = np.random.default_rng(0).permutation(N_SEED)
        eng = MembershipEngine(MembershipConfig(backend=backend),
                               device="cpu")
        eng.seed(lam[perm], v[perm], labels[perm], n_clusters=N_TASKS)
        out = eng.assign(lam_w, v_w)
        np.testing.assert_array_equal(host(out.labels), host(base.labels))
        np.testing.assert_allclose(host(out.affinity), host(base.affinity),
                                   atol=1e-5)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_streaming_matches_recompute_randomized(self, backend):
        """Any admit/evict sequence keeps the streaming prototypes equal
        to a fresh recompute, including a cluster emptied to count 0."""
        rng = np.random.default_rng(11)
        eng = MembershipEngine(MembershipConfig(backend=backend,
                                                capacity=CAP), device="cpu")
        v0, labels0, _ = make_table(rng, n=9, n_clusters=TT)
        eng.seed(rng.standard_normal((9, TK)).astype(np.float32), v0[:9],
                 labels0[:9], n_clusters=TT)
        live = list(range(9))
        for _ in range(12):
            if rng.random() < 0.5 and len(live) > 2:
                gone = rng.choice(len(live), int(rng.integers(1, 3)),
                                  replace=False)
                eng.evict([live[g] for g in gone])
                live = [s for i, s in enumerate(live)
                        if i not in set(gone.tolist())]
            else:
                k = int(rng.integers(1, 4))
                slots = eng.admit(
                    rng.standard_normal((k, TK)).astype(np.float32),
                    rng.standard_normal((k, TD, TK)).astype(np.float32),
                    rng.integers(-1, TT, k).astype(np.int32))
                live.extend(int(s) for s in slots)
            st = eng.state
            p_re, c_re = eng._rebuild_protos(st.v, st.labels, st.valid, TT)
            np.testing.assert_allclose(host(st.protos), host(p_re),
                                       atol=1e-4)
            np.testing.assert_allclose(host(st.counts), host(c_re),
                                       atol=1e-5)
        in0 = [s for s, lb in zip(live, host(eng.state.labels)[live])
               if lb == 0]
        if in0:
            eng.evict(in0)
        assert host(eng.state.counts)[0] == 0
        np.testing.assert_array_equal(host(eng.state.protos)[0], 0.0)


class TestDrift:
    def test_fresh_directory_has_no_drift(self, seed_result):
        eng = make_engine(seed_result, "torch")
        s = eng.drift_stats()
        assert s["unassigned_frac"] == 0.0 and s["proto_shift"] == 0.0
        assert not eng.should_recluster()

    def test_unassigned_fraction_trips_trigger(self, seed_result, wave):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, "torch",
                          recluster_unassigned_frac=0.1)
        eng.admit(lam_w, v_w, np.full(len(lam_w), UNASSIGNED))
        assert eng.drift_stats()["unassigned_frac"] > 0.1
        assert eng.should_recluster()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_recluster_preserves_clean_directory(self, seed_result, wave,
                                                 backend):
        lam_w, v_w, _ = wave
        eng = make_engine(seed_result, backend)
        eng.admit(lam_w, v_w, eng.assign(lam_w, v_w).labels)
        before = host(eng.state.labels).copy()
        assert eng.recluster(force=True)
        assert eng.state.n_reclusters == 1
        np.testing.assert_array_equal(host(eng.state.labels), before)
        assert eng.drift_stats()["proto_shift"] == 0.0

    def test_too_few_members_raises(self, seed_result):
        lam, v, _, _ = seed_result
        eng = MembershipEngine(MembershipConfig(backend="torch"),
                               device="cpu")
        eng.seed(lam[:2], v[:2], np.asarray([0, 1]), n_clusters=3)
        with pytest.raises(ValueError, match="cannot cut"):
            eng.recluster(force=True)

    def test_trigger_determinism(self, seed_result, wave):
        lam_w, v_w, _ = wave

        def replay():
            eng = make_engine(seed_result, "torch",
                              recluster_unassigned_frac=0.08)
            events = []
            for start in (0, 3, 6):
                lw, vw = lam_w[start:start + 3], v_w[start:start + 3]
                labels = (np.full(3, -1) if start == 3
                          else eng.assign(lw, vw).labels)
                eng.admit(lw, vw, labels)
                events.append(eng.maybe_recluster())
            return events, host(eng.state.labels)

        ev1, lab1 = replay()
        ev2, lab2 = replay()
        assert ev1 == ev2 and any(ev1)
        np.testing.assert_array_equal(lab1, lab2)

    def test_median_stat_ignores_one_poisoned_cluster(self, seed_result,
                                                      wave):
        lam_w, v_w, _ = wave

        def shift(drift_stat):
            eng = make_engine(seed_result, "torch", drift_stat=drift_stat)
            eng.admit(lam_w[:1], 50.0 * v_w[:1], np.asarray([0], np.int32))
            return eng.drift_stats()

        s_max, s_med = shift("max"), shift("median")
        assert s_max["proto_shift"] == s_max["proto_shift_max"]
        assert s_med["proto_shift"] < s_med["proto_shift_max"]
        assert s_med["proto_shift_max"] == pytest.approx(
            s_max["proto_shift_max"])


class TestSignatureRelevance:
    def test_matches_reference(self, seed_result):
        lam, v, _, task_ids = seed_result
        from repro.core.membership_engine import signature_relevance as ref
        r = host(signature_relevance(t(lam), t(v)))
        np.testing.assert_allclose(r, np.asarray(ref(jnp.asarray(lam),
                                                     jnp.asarray(v))),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r, r.T, atol=1e-6)
        same = np.equal.outer(task_ids, task_ids)
        off = ~np.eye(len(task_ids), dtype=bool)
        assert r[same & off].min() > r[~same].max()
        assert clu.clustering_accuracy(clu.hac_clusters(r, N_TASKS),
                                       task_ids) == 1.0

    def test_row_blocks_do_not_change_the_result(self, seed_result,
                                                 monkeypatch):
        from repro_torch.core import similarity as sim
        lam, v, _, _ = seed_result
        whole = signature_relevance(t(lam), t(v))
        monkeypatch.setattr(sim, "_SIG_BLOCK_ELEMS", 5 * N_SEED * TOP_K ** 2)
        np.testing.assert_array_equal(host(signature_relevance(t(lam), t(v))),
                                      host(whole))


def make_table(rng, n=20, cap=CAP, d=TD, k=TK, n_clusters=TT):
    """Random signature table: n live members over n_clusters."""
    v = rng.standard_normal((cap, d, k)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    labels = np.full(cap, UNASSIGNED, np.int32)
    labels[:n] = rng.integers(0, n_clusters, n)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return v, labels, valid


def port_protos(v, labels, valid, agg, trim_frac=0.1, mom_groups=5):
    args = (t(v), torch.from_numpy(labels), torch.from_numpy(valid))
    if agg == "mean":
        p, c = _protos_from_table(*args, n_clusters=TT)
    else:
        p, c = _protos_from_table_robust(*args, n_clusters=TT,
                                         aggregator=agg, trim_frac=trim_frac,
                                         mom_groups=mom_groups)
    return host(p), host(c)


class TestRobustAggregators:
    @pytest.mark.parametrize("agg", ["trimmed", "medians"])
    @pytest.mark.parametrize("trim_frac,mom_groups", [(0.2, 5), (0.3, 7),
                                                      (0.0, 1)])
    def test_matches_reference(self, agg, trim_frac, mom_groups):
        v, labels, valid = make_table(np.random.default_rng(4), n=26)
        p, c = port_protos(v, labels, valid, agg, trim_frac, mom_groups)
        p_ref, c_ref = ref_robust(jnp.asarray(v), jnp.asarray(labels),
                                  jnp.asarray(valid), n_clusters=TT,
                                  aggregator=agg, trim_frac=trim_frac,
                                  mom_groups=mom_groups)
        np.testing.assert_allclose(p, np.asarray(p_ref), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(c, np.asarray(c_ref))

    @pytest.mark.parametrize("agg", ["trimmed", "medians"])
    def test_clean_degenerate_equals_mean(self, agg):
        v, labels, valid = make_table(np.random.default_rng(1))
        kw = dict(trim_frac=0.0) if agg == "trimmed" else dict(mom_groups=1)
        p, c = port_protos(v, labels, valid, agg, **kw)
        p_mean, c_mean = port_protos(v, labels, valid, "mean")
        np.testing.assert_allclose(p, p_mean, atol=1e-5)
        np.testing.assert_array_equal(c, c_mean)

    @pytest.mark.parametrize("agg", ["trimmed", "medians"])
    def test_bounded_under_corruption(self, agg):
        rng = np.random.default_rng(2)
        v, labels, valid = make_table(rng, n=30)
        p_clean, _ = port_protos(v, labels, valid, "mean")
        mem0 = np.flatnonzero((labels == 0) & valid)
        n_bad = int(np.floor(len(mem0) * 0.2))
        v_bad = v.copy()
        v_bad[mem0[:n_bad]] = 10.0 * rng.standard_normal(
            (n_bad, TD, TK)).astype(np.float32)
        p_rob, _ = port_protos(v_bad, labels, valid, agg, trim_frac=0.25,
                               mom_groups=2 * n_bad + 1)
        p_mean, _ = port_protos(v_bad, labels, valid, "mean")
        dev_rob = np.linalg.norm(p_rob[0] - p_clean[0])
        assert np.linalg.norm(p_mean[0] - p_clean[0]) > 10 * dev_rob
        assert dev_rob < np.linalg.norm(p_clean[0])

    @pytest.mark.parametrize("agg", ["mean", "trimmed", "medians"])
    def test_backends_agree_under_corruption(self, seed_result, wave, agg):
        lam, v, labels, _ = seed_result
        lam_c, v_c, _ = syn.byzantine_signatures(
            lam, v, 0.25, mode="colluding_copy", seed=5, labels=labels)
        lam_w, v_w, _ = wave
        got = []
        for backend in BACKENDS:
            eng = MembershipEngine(MembershipConfig(
                backend=backend, aggregator=agg, trim_frac=0.3,
                mom_groups=7), device="cpu")
            eng.seed(lam_c, v_c, labels, n_clusters=N_TASKS)
            got.append(host(eng.assign(lam_w, v_w).labels))
        ref = RefEngine(RefConfig(backend="numpy", aggregator=agg,
                                  trim_frac=0.3, mom_groups=7))
        ref.seed(lam_c, v_c, labels, n_clusters=N_TASKS)
        for labels_b in got:
            np.testing.assert_array_equal(
                labels_b, np.asarray(ref.assign(lam_w, v_w).labels))


class TestInjectors:
    """The corruption injectors are copies: equal outputs for a seed."""

    @pytest.mark.parametrize("seed", [0, 1, 9])
    def test_copies_equal_reference(self, seed):
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 5, 40).astype(np.int32)
        np.testing.assert_array_equal(
            syn.corrupt_labels(y, 0.3, 5, seed=seed),
            ref_syn.corrupt_labels(y, 0.3, 5, seed=seed))
        feats = rng.standard_normal((6, 10, 4)).astype(np.float32)
        tids = np.array([0, 0, 1, 1, 2, 2])
        np.testing.assert_array_equal(
            syn.label_noise_rows(feats, tids, 0.3, seed=seed),
            ref_syn.label_noise_rows(feats, tids, 0.3, seed=seed))
        np.testing.assert_array_equal(
            syn.heavy_tail_noise(feats, 0.5, seed=seed),
            ref_syn.heavy_tail_noise(feats, 0.5, seed=seed))
        spec = dict(flip_frac=0.2, heavy_tail_frac=0.5, seed=seed)
        np.testing.assert_array_equal(
            syn.apply_corruption(feats, tids, syn.CorruptionSpec(**spec)),
            ref_syn.apply_corruption(feats, tids,
                                     ref_syn.CorruptionSpec(**spec)))

    @pytest.mark.parametrize("with_labels", [True, False])
    @pytest.mark.parametrize("mode", syn.BYZANTINE_MODES)
    def test_byzantine_equals_reference(self, mode, with_labels):
        rng = np.random.default_rng(4)
        lam = rng.standard_normal((12, 4)).astype(np.float32)
        v = rng.standard_normal((12, 8, 4)).astype(np.float32)
        labels = np.arange(12) % 3 if with_labels else None
        got = syn.byzantine_signatures(lam, v, 0.25, mode=mode, seed=4,
                                       labels=labels)
        want = ref_syn.byzantine_signatures(lam, v, 0.25, mode=mode, seed=4,
                                            labels=labels)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[2].sum() == 3                  # floor(0.25 * 12)

    def test_spec_validation(self):
        for kw in (dict(flip_frac=1.5), dict(byzantine_mode="nope"),
                   dict(byzantine_scale=0.0), dict(heavy_tail_df=0.0),
                   dict(heavy_tail_scale=-1.0)):
            with pytest.raises(ValueError):
                syn.CorruptionSpec(**kw)
        with pytest.raises(ValueError):
            syn.byzantine_signatures(np.zeros((4, 2)), np.zeros((4, 3, 2)),
                                     0.5, mode="nope")
        feats = np.ones((4, 3, 2), np.float32)
        np.testing.assert_array_equal(
            syn.apply_corruption(feats, np.arange(4), syn.CorruptionSpec()),
            feats)


class TestLayouts:
    """``stack_layout`` / ``admit_layout`` equal the reference, with the
    ``-1`` sentinel rows masked out of every scatter."""

    @pytest.mark.parametrize("seed", [0, 3])
    def test_equal_reference(self, seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(-1, 3, size=14)
        got = fpart.stack_layout(labels, 3, c_max=10)
        want = ref_part.stack_layout(jnp.asarray(labels), 3, c_max=10)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(host(a), np.asarray(b))
        new = np.asarray([0, 2, -1, 1, 7, 0])
        got2 = fpart.admit_layout(got[2], new)
        want2 = ref_part.admit_layout(want[2], jnp.asarray(new))
        for a, b in zip(got2, want2):
            np.testing.assert_array_equal(host(a), np.asarray(b))
        assert host(got2[0])[2] == 3 and host(got2[1])[2] == 10
        assert host(got2[0])[4] == 3              # out-of-range label
        assert fpart.stack_layout(labels, 3)[2].shape[1] == \
            ref_part.stack_layout(jnp.asarray(labels), 3)[2].shape[1]

    def test_admit_layout_matches_full_relayout(self):
        labels = np.random.default_rng(0).integers(0, 3, size=12)
        _, _, mask = fpart.stack_layout(labels, 3, c_max=10)
        r2, s2, mask2 = fpart.admit_layout(mask, [0, 2, -1, 1])
        rf, sf, mf = fpart.stack_layout(np.concatenate([labels, [0, 2, 1]]),
                                        3, c_max=10)
        np.testing.assert_array_equal(host(mf), host(mask2))
        keep = [0, 1, 3]
        np.testing.assert_array_equal(host(rf)[12:], host(r2)[keep])
        np.testing.assert_array_equal(host(sf)[12:], host(s2)[keep])

    def test_refills_holes_and_overflow_raises(self):
        mask = torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0]])
        rows, slot, mask2 = fpart.admit_layout(mask, [0, 1])
        assert host(rows).tolist() == [0, 1] and host(slot).tolist() == [1, 2]
        assert host(mask2).tolist() == [[1, 1, 1], [1, 1, 1]]
        assert host(mask).tolist() == [[1, 0, 1], [1, 1, 0]]  # not modified
        with pytest.raises(ValueError, match="C_max"):
            fpart.admit_layout(mask, [0, 0])
        with pytest.raises(ValueError, match="c_max"):
            fpart.stack_layout([0, 0, 0], 2, c_max=2)
        with pytest.raises(ValueError, match="mask rows"):
            fpart.admit_layout(mask, [0], n_clusters=3)

    def test_greedy_match_equals_reference(self):
        rng = np.random.default_rng(5)
        for _ in range(5):
            new = rng.integers(-1, 4, 30)
            old = rng.integers(-1, 4, 30)
            np.testing.assert_array_equal(greedy_match_labels(new, old, 4),
                                          ref_greedy(new, old, 4))


@pytest.fixture(scope="module")
def ref_matrix():
    """The reference launcher's ``--matrix --quick`` summaries, once."""
    args = _quick_args()
    args.backend = "jnp"
    return [ref_launch.run_cell(args, s, a, verbose=False)
            for s in ref_launch.SCENARIOS
            for a in ref_launch.ARRIVAL_PATTERNS]


def _quick_args(*extra):
    args = launch.build_parser().parse_args(["--device", "cpu", *extra])
    args.seed_users, args.samples = 32, 16
    args.waves, args.wave_size, args.evict = 3, 8, 2
    args.drift_after = 1
    return args


class TestLauncher:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_quick_matrix_equals_reference(self, ref_matrix, backend):
        args = _quick_args("--backend", backend)
        cells = [launch.run_cell(args, s, a, verbose=False)
                 for s in launch.SCENARIOS for a in launch.ARRIVAL_PATTERNS]
        assert len(cells) == len(ref_matrix) == 8
        for got, want in zip(cells, ref_matrix):
            assert (got["scenario"], got["arrivals"]) == \
                (want["scenario"], want["arrivals"])
            for key in ("seed_accuracy", "accuracy_per_wave",
                        "unassigned_frac", "recluster_waves",
                        "n_reclusters", "mean_accuracy"):
                assert got[key] == want[key], (got["scenario"], key)

    def test_wave_plan_equals_reference(self):
        for pattern in launch.ARRIVAL_PATTERNS:
            for waves, size in ((3, 8), (5, 7), (6, 128)):
                assert launch.wave_plan(pattern, waves, size) == \
                    ref_launch.wave_plan(pattern, waves, size)

    def test_main_quick_and_unported_flags(self, capsys):
        cells = launch.main(["--device", "cpu", "--quick"])
        assert all(a == 1.0 for a in cells[0]["accuracy_per_wave"])
        assert "honest accuracy 100.0%" in capsys.readouterr().out
        cells = launch.main(["--device", "cpu", "--quick", "--seed-groups",
                             "2"])
        assert cells[0]["seed_accuracy"] == 1.0
        assert all(a == 1.0 for a in cells[0]["accuracy_per_wave"])
        assert "hierarchical (2 groups)" in capsys.readouterr().out
        with pytest.raises(NotImplementedError, match="item 12"):
            launch.main(["--device", "cpu", "--quick", "--events", "x"])

    def test_default_device_raises_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main(["--quick"])
