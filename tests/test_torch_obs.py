"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

Three parts:

  * ``tests/test_obs.py`` ported to ``repro_torch.obs``: spans, metrics,
    disabled mode, events, the stamp and the instrumented hot paths,
    with tensors where it uses jax arrays.  Its retrace test becomes the
    compile-hook test: the port's only run-time compile is the ``nvcc``
    build of the kernel library (``kernels/build.py``), so a build counts
    one ``retrace_count``, a stamp hit none, and a build while telemetry
    is off none.
  * The registries side by side: the same obs calls give equal
    ``snapshot()``, ``diff()`` and ``format_tree()`` output in both
    packages; ``record_ledger`` on equal ledgers gives equal ``comm.*``
    gauges; the two launchers print the same text.
  * The parity contract (``repro_torch/obs/__init__.py``) on seeded numpy
    inputs, for the dense, blockwise and raw ``one_shot_clustering`` runs
    and membership serving (seed, assign, admit, evict, drift_stats, a
    forced and a drift-tripped re-cluster): the same span names in the
    same parent tree with the same meta keys; the same counter keys and
    values; the same gauge and histogram keys and histogram counts; the
    same event kinds in the same order with the same field names; equal
    integer and string fields; gauges and float fields within 1e-5 (the
    tolerance of the port's parity tests for ``proto_shift``,
    ``unassigned_frac`` and ``label_agreement``); ``comm.*`` gauges
    exactly equal.  Not compared, as the contract says: durations,
    timestamps, sequence numbers, span ids, thread names, and the values
    that name a backend or impl.  ``retrace_count`` is the port's own
    too: the reference counts jit traces, the port kernel-library builds
    (none on the CPU).

A disabled run records nothing and gives results bit-equal to an
enabled run.
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import CPU, host
from repro import obs as ref_obs
from repro.core import oneshot as ref_oneshot
from repro.core import similarity as ref_sim
from repro.core.membership_engine import (MembershipConfig as RefMemConfig,
                                          MembershipEngine as RefMemEngine)
from repro.data import synthetic as ref_syn
from repro.launch import obs as ref_launch_obs
from repro_torch import obs
from repro_torch.core.membership_engine import (UNASSIGNED, MembershipConfig,
                                                MembershipEngine)
from repro_torch.core.oneshot import CommLedger, one_shot_clustering
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.kernels import build, dispatch
from repro_torch.launch import obs as launch_obs

#: Gauges and float fields: the port's parity tolerance for the drift
#: statistics and the re-cluster's label agreement.
FLOAT_TOL = 1e-5
#: Meta and event fields whose values name a backend or impl.
OWN_VALUES = {"backend", "impl"}
#: Counters that are each package's own: jit traces in the reference,
#: kernel-library builds in the port.
OWN_COUNTERS = {"retrace_count"}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with telemetry off and empty, in both
    packages."""
    for o in (obs, ref_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


# ---------------------------------------------------------------- spans

class TestSpans:
    def test_nesting_parent_child_depth(self):
        with obs.scope(True):
            with obs.span("outer", impl="dense"):
                with obs.span("inner"):
                    pass
                with obs.span("inner2"):
                    pass
        recs = {r["name"]: r for r in obs.trace_records()}
        assert set(recs) == {"outer", "inner", "inner2"}
        assert recs["outer"]["parent"] == 0 and recs["outer"]["depth"] == 0
        assert recs["inner"]["parent"] == recs["outer"]["id"]
        assert recs["inner2"]["parent"] == recs["outer"]["id"]
        assert recs["inner"]["depth"] == 1
        assert recs["outer"]["meta"] == {"impl": "dense"}

    def test_timing_monotonic_and_contained(self):
        with obs.scope(True):
            with obs.span("outer"):
                with obs.span("inner"):
                    float(torch.ones(64).sum())  # some real work
        recs = {r["name"]: r for r in obs.trace_records()}
        o, i = recs["outer"], recs["inner"]
        assert o["dur_us"] >= 0 and i["dur_us"] >= 0
        assert i["ts_us"] >= o["ts_us"]
        assert i["ts_us"] + i["dur_us"] <= o["ts_us"] + o["dur_us"] + 1e-3
        with obs.scope(True):
            with obs.span("later"):
                pass
        later = [r for r in obs.trace_records() if r["name"] == "later"][0]
        assert later["ts_us"] >= o["ts_us"]

    def test_sync_returns_value_and_records(self):
        with obs.scope(True):
            with obs.span("compute") as sp:
                out = sp.sync(torch.ones(256, 256) @ torch.ones(256, 256))
        assert float(out[0, 0]) == 256.0
        rec = obs.trace_records()[-1]
        assert rec["name"] == "compute" and rec["dur_us"] > 0

    def test_sync_walks_structures_and_skips_cpu(self, monkeypatch):
        """CPU tensors need no synchronisation; the walk reaches tensors
        inside tuples, lists, dicts and dataclasses."""
        import dataclasses

        from repro_torch.obs import trace

        @dataclasses.dataclass
        class Box:
            a: torch.Tensor
            rest: dict

        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda dev=None: calls.append(dev))
        value = (torch.ones(2), [Box(torch.ones(1), {"x": torch.ones(3)})])
        with obs.scope(True):
            with obs.span("s") as sp:
                assert sp.sync(value) is value
        assert calls == []
        found = set()
        trace._cuda_devices(value, found)
        assert found == set()

    def test_sync_off_registers_nothing(self):
        with obs.scope(True):
            obs.configure(sync=False)
            try:
                with obs.span("s") as sp:
                    sp.sync(torch.ones(2))
                    assert sp._vals == []
            finally:
                obs.configure(sync=True)
            with obs.span("t", sync=True) as sp:
                sp.sync(torch.ones(2))
                assert len(sp._vals) == 1

    def test_note_attaches_meta(self):
        with obs.scope(True):
            with obs.span("s") as sp:
                sp.note(rounds=3, backend="torch")
        rec = obs.trace_records()[-1]
        assert rec["meta"] == {"rounds": 3, "backend": "torch"}

    def test_meta_tensor_scalars_coerced(self):
        with obs.scope(True):
            with obs.span("s", n=torch.tensor(5), frac=np.float32(0.5)):
                pass
        meta = obs.trace_records()[-1]["meta"]
        assert meta == {"n": 5, "frac": 0.5}
        assert isinstance(meta["n"], int)

    def test_threads_get_independent_stacks(self):
        def worker():
            with obs.span("worker.outer"):
                with obs.span("worker.inner"):
                    pass

        with obs.scope(True):
            with obs.span("main.outer"):
                t = threading.Thread(target=worker, name="obs-worker")
                t.start()
                t.join(timeout=60)
                assert not t.is_alive()
        recs = {r["name"]: r for r in obs.trace_records()}
        assert recs["worker.outer"]["parent"] == 0
        assert recs["worker.inner"]["parent"] == recs["worker.outer"]["id"]
        assert recs["worker.outer"]["thread"] == "obs-worker"

    def test_jsonl_round_trip_and_tree(self, tmp_path):
        with obs.scope(True):
            with obs.span("root", impl="x"):
                with obs.span("leaf"):
                    pass
        p = obs.save_trace(tmp_path / "trace.jsonl")
        loaded = obs.load_trace(p)
        assert loaded == obs.trace_records()
        root_line, leaf_line = obs.format_tree(loaded).splitlines()
        assert root_line.startswith("root") and "impl=x" in root_line
        assert leaf_line.startswith("  leaf")

    def test_format_tree_empty(self):
        assert obs.format_tree([]) == "(no spans recorded)"

    def test_profiler_annotations_reach_the_trace(self, tmp_path):
        obs.configure(profiler=True)
        try:
            with obs.scope(True):
                with obs.profile_trace(tmp_path) as prof:
                    with obs.span("annotated.outer"):
                        with obs.span("annotated.inner"):
                            torch.ones(8).sum()
        finally:
            obs.configure(profiler=False)
        assert prof.path.parent == tmp_path
        names = {e.get("name") for e in
                 json.loads(prof.path.read_text())["traceEvents"]}
        assert {"annotated.outer", "annotated.inner"} <= names


# -------------------------------------------------------------- metrics

class TestMetrics:
    def test_counter_semantics(self):
        with obs.scope(True):
            obs.count("c")
            obs.count("c", 4)
            obs.count("c", kernel="assign")
            obs.count("c", 2, kernel="assign")
            obs.count("c", kernel="hac")
        assert obs.counter_value("c") == 5
        assert obs.counter_value("c", kernel="assign") == 3
        assert obs.counter_value("c", kernel="hac") == 1
        assert obs.counter_total("c") == 9

    def test_gauge_last_value_wins(self):
        with obs.scope(True):
            obs.gauge("g", 1.5)
            obs.gauge("g", torch.tensor(2.5))   # 0-dim tensor coerced
            obs.gauge("plan", "bm=32,bn=64", kernel="assign")
        assert obs.gauge_value("g") == 2.5
        assert isinstance(obs.gauge_value("g"), float)
        assert obs.gauge_value("plan", kernel="assign") == "bm=32,bn=64"

    def test_histogram_semantics(self):
        with obs.scope(True):
            for v in (0.5, 1.0, 3.0, 100.0):
                obs.observe("h", v)
        h = obs.snapshot()["histograms"]["h"]
        assert h["count"] == 4
        assert h["total"] == pytest.approx(104.5)
        assert h["min"] == 0.5 and h["max"] == 100.0
        assert h["mean"] == pytest.approx(104.5 / 4)
        assert h["buckets"] == {"1": 2, "4": 1, "128": 1}

    def test_snapshot_diff(self):
        with obs.scope(True):
            obs.count("a")
            obs.gauge("g", 1)
            before = obs.snapshot()
            obs.count("a", 2)
            obs.count("b")
            obs.gauge("g", 7)
            obs.observe("h", 10.0)
            after = obs.snapshot()
        d = obs.diff(before, after)
        assert d["counters"] == {"a": 2, "b": 1}
        assert d["gauges"] == {"g": [1, 7]}
        assert d["histograms"] == {"h": {"count": 1, "total": 10.0}}
        assert not any(obs.diff(after, after).values())

    def test_snapshot_round_trip(self, tmp_path):
        with obs.scope(True):
            obs.count("a", 3)
            obs.observe("h", 2.0)
        p = obs.save_snapshot(tmp_path / "snap.json")
        assert obs.load_snapshot(p) == obs.snapshot()

    def test_ledger_parity_vs_summary(self):
        ledger = CommLedger(n_users=40, d=16, top_k=6,
                            model_params=10_000, mode="streaming")
        with obs.scope(True):
            obs.record_ledger(ledger)
        s = ledger.summary()
        for k, v in s.items():
            if v is None:
                continue
            assert obs.gauge_value(f"comm.{k}") == v, k
        assert (obs.gauge_value("comm_upload_bytes")
                == s["per_user_upload_bytes"] * s["n_users"])

    def test_ledger_none_fields_skipped(self):
        ledger = CommLedger(n_users=8, d=4, top_k=2)
        assert ledger.summary()["oneshot_vs_iterative_ratio"] is None
        with obs.scope(True):
            obs.record_ledger(ledger)
        assert obs.gauge_value("comm.oneshot_vs_iterative_ratio") is None


# ------------------------------------------------------------- disabled

class TestDisabledMode:
    def test_span_is_shared_noop(self):
        s1 = obs.span("a", impl="x")
        s2 = obs.span("b")
        assert s1 is s2
        with s1 as sp:
            v = sp.sync(torch.ones(3))
            sp.note(k=1)
        assert v.shape == (3,)
        assert obs.trace_records() == []

    def test_zero_registry_mutation(self):
        obs.count("c")
        obs.gauge("g", 1)
        obs.observe("h", 2.0)
        obs.event("kind", x=1)
        obs.record_ledger(CommLedger(n_users=4, d=2, top_k=1))
        dispatch.record_dispatch("assign", {"block_n": 8})
        assert obs.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
        assert obs.events() == []

    def test_scope_restores_prior_state(self):
        assert not obs.enabled()
        with obs.scope(True):
            assert obs.enabled()
            with obs.scope(False):
                assert not obs.enabled()
            assert obs.enabled()
        assert not obs.enabled()

    def test_kernel_builds_count_as_retraces(self, monkeypatch, tmp_path):
        """The compile hook: with the ``nvcc`` step stubbed, a build
        counts one ``retrace_count``, a stamp hit (the finished build
        reused) none, and a build while telemetry is off none."""
        builds = []

        def fake_compile(out_dir):
            builds.append(out_dir)
            path = out_dir / build.LIB_NAME
            path.write_bytes(b"stub")
            return path

        monkeypatch.setattr(build, "_compile", fake_compile)
        with obs.scope(True):
            path = build.ensure_built(tmp_path)
            assert path == tmp_path / build.LIB_NAME
            assert len(builds) == 1
            assert obs.counter_value("retrace_count") == 1
            build.ensure_built(tmp_path)          # stamp hit
            assert len(builds) == 1
            assert obs.counter_value("retrace_count") == 1
        (tmp_path / "stamp").unlink()
        build.ensure_built(tmp_path)              # telemetry off
        assert len(builds) == 2
        assert obs.counter_value("retrace_count") == 1
        assert obs.stamp()["retrace_count"] == 1
        build.add_build_listener(print)
        build.add_build_listener(print)
        assert build._BUILD_LISTENERS.count(print) == 1
        build._BUILD_LISTENERS.remove(print)


# --------------------------------------------------------------- events

class TestEvents:
    def test_order_and_fields(self):
        with obs.scope(True):
            obs.event("admit", n=3, slots=[0, 1, 2])
            obs.event("evict", n=1)
        evs = obs.events()
        assert [e["kind"] for e in evs] == ["admit", "evict"]
        assert evs[0]["seq"] < evs[1]["seq"]
        assert evs[0]["t_us"] <= evs[1]["t_us"]
        assert evs[0]["n"] == 3 and evs[0]["slots"] == [0, 1, 2]

    def test_device_scalars_coerced(self):
        with obs.scope(True):
            obs.event("e", frac=torch.tensor(0.25), n=np.int64(7),
                      m=torch.tensor(3, dtype=torch.int32))
        e = obs.events("e")[0]
        assert e["frac"] == 0.25 and isinstance(e["frac"], float)
        assert e["n"] == 7 and isinstance(e["n"], int)
        assert e["m"] == 3 and isinstance(e["m"], int)
        json.dumps(e)

    def test_arrays_coerced_as_the_reference_does(self):
        """A numpy array of several slots becomes the reference's string;
        a list stays a list."""
        slots = np.asarray([10, 11, 12], np.int32)
        for o in (obs, ref_obs):
            with o.scope(True):
                o.event("admit", slots=slots, listed=[1, np.int64(2)])
        assert obs.events() == [
            {**e, "seq": p["seq"], "t_us": p["t_us"]}
            for e, p in zip(ref_obs.events(), obs.events())]
        assert obs.events()[0]["slots"] == "[10 11 12]"

    def test_kind_filter(self):
        with obs.scope(True):
            obs.event("a")
            obs.event("b")
            obs.event("a")
        assert len(obs.events("a")) == 2
        assert len(obs.events("b")) == 1

    def test_jsonl_round_trip(self, tmp_path):
        with obs.scope(True):
            obs.event("admit", n=2)
            obs.event("recluster", label_agreement=0.75)
        p = obs.save_events(tmp_path / "events.jsonl")
        assert obs.load_events(p) == obs.events()


# ------------------------------------------------------ kernel dispatch

class TestDispatch:
    def test_launches_counted_by_tuning_family(self):
        from repro_torch.kernels.linkage.ops import chain_plan

        saved = dict(dispatch.LAUNCHES)
        try:
            with obs.scope(True):
                for name in ("gram", "eigproject", "linkage_step",
                             "featurize_gram", "gram_project",
                             "assign_wave", "assign_one", "wkv_chunked",
                             "linear_scan", "flash_attention"):
                    dispatch.count_launch(name)
                dispatch.count_launch("linkage", chain_plan(64))
        finally:
            dispatch.LAUNCHES.update(saved)
        # flash_attention has no tuning family and is not recorded
        assert obs.counter_value("dispatch_count") == 10
        want = {"gram": 1, "eigproject": 1, "linkage": 2,
                "featurize_gram": 1, "gram_project": 1, "assign": 2,
                "recurrent_scan": 2}
        assert {k: obs.counter_value("kernel_calls", kernel=k)
                for k in want} == want
        assert obs.counter_total("kernel_calls") == 10
        plan = chain_plan(64)
        assert obs.gauge_value("kernel_blocks", kernel="linkage") == (
            f"route={plan.route},scratch={plan.scratch},smem={plan.smem}")
        assert obs.snapshot()["gauges"].keys() == {
            "kernel_blocks{kernel=linkage}"}
        assert set(dispatch.FAMILIES.values()) <= set(
            __import__("repro.kernels.tuning",
                       fromlist=["KERNELS"]).KERNELS)

    def test_plain_versions_record_nothing(self):
        """On the CPU the wrappers run their plain versions: no launch,
        no dispatch recorded."""
        from repro_torch.kernels.assign import assign
        from repro_torch.kernels.gram import batched_gram_matrix

        before = dict(dispatch.LAUNCHES)
        with obs.scope(True):
            batched_gram_matrix(torch.ones(2, 4, 3))
            v = torch.linalg.qr(torch.randn(3, 4, 2)).Q
            assign(v, torch.eye(4).expand(2, 4, 4).contiguous(),
                   compute_dtype="fp32")
        assert dispatch.LAUNCHES == before
        assert obs.counter_total("dispatch_count") == 0
        assert obs.counter_total("kernel_calls") == 0


# --------------------------------------------- instrumented hot paths

@pytest.fixture(scope="module")
def feats_obs():
    """``tests/test_obs.py``'s pipeline input."""
    rng = np.random.default_rng(0)
    return [rng.normal(size=(24, 8)).astype(np.float32) for _ in range(12)]


class TestInstrumentation:
    def test_pipeline_emits_all_three_pillars(self, feats_obs):
        res = one_shot_clustering(feats_obs, 2, device="cpu")
        obs.reset()
        with obs.scope(True):
            eng = MembershipEngine.from_oneshot(
                res, MembershipConfig(backend="torch", capacity=32),
                device="cpu")
            lam, v = res.lam[:4], res.v[:4]
            wave = eng.assign(lam, v)
            eng.admit(lam, v, wave.labels)
            eng.drift_stats()
        names = {r["name"] for r in obs.trace_records()}
        assert {"membership.assign", "membership.admit"} <= names
        assert obs.counter_value("membership.assign_waves") == 1
        assert obs.counter_value("membership.admits") == 4
        assert obs.gauge_value("directory_bytes") > 0
        assert obs.gauge_value("unassigned_frac") is not None
        snap = obs.snapshot()
        assert snap["histograms"]["assign_latency_us"]["count"] == 1
        assert [e["kind"] for e in obs.events()] == ["seed", "assign_wave",
                                                     "admit"]
        assert obs.events("assign_wave")[0]["n"] == 4

    def test_oneshot_records_ledger_and_spans(self):
        rng = np.random.default_rng(1)
        feats = [rng.normal(size=(16, 6)).astype(np.float32)
                 for _ in range(8)]
        with obs.scope(True):
            res = one_shot_clustering(feats, 2, device="cpu")
        names = {r["name"] for r in obs.trace_records()}
        assert {"oneshot.run", "protocol.run", "protocol.dispatch",
                "cluster.hac", "cluster.cut"} <= names
        assert (obs.gauge_value("comm.per_user_upload_bytes")
                == res.ledger.summary()["per_user_upload_bytes"])
        disp = [r for r in obs.trace_records()
                if r["name"] == "protocol.dispatch"][0]
        assert disp["meta"] == {"mode": "dense", "backend": "torch",
                                "impl": "torch", "n_users": 8}

    def test_hierarchical_path_returns_before_the_span(self):
        from repro_torch.core.hierarchy import HierarchyConfig

        feats, _ = ref_syn.make_task_feature_mixture(32, 24, 12, 2, seed=3)
        with obs.scope(True):
            one_shot_clustering(feats, 2, hierarchy_cfg=HierarchyConfig(
                n_groups=2, group_clusters=2), device="cpu")
        names = [r["name"] for r in obs.trace_records()]
        assert "oneshot.run" not in names
        assert "comm.n_users" not in obs.snapshot()["gauges"]

    def test_disabled_run_silent_and_bit_equal(self, feats_obs):
        """Telemetry off: nothing recorded, and the same bits as a run
        with telemetry on."""
        off = one_shot_clustering(feats_obs, 2, device="cpu")
        eng_off = MembershipEngine.from_oneshot(
            off, MembershipConfig(backend="torch", capacity=32),
            device="cpu")
        wave_off = eng_off.assign(off.lam[:4], off.v[:4])
        assert obs.trace_records() == [] and obs.events() == []
        assert obs.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
        with obs.scope(True):
            on = one_shot_clustering(feats_obs, 2, device="cpu")
            eng_on = MembershipEngine.from_oneshot(
                on, MembershipConfig(backend="torch", capacity=32),
                device="cpu")
            wave_on = eng_on.assign(on.lam[:4], on.v[:4])
        assert torch.equal(off.similarity, on.similarity)
        assert torch.equal(off.labels, on.labels)
        for field in ("labels", "affinity", "margin"):
            assert torch.equal(getattr(wave_off, field),
                               getattr(wave_on, field))
        assert any(r["name"] == "membership.assign"
                   for r in obs.trace_records())
        assert obs.counter_value("membership.assign_waves") == 1

    def test_stamp_shape(self):
        s = obs.stamp()
        assert set(s) == {"obs_enabled", "dispatch_count", "retrace_count"}
        assert s["obs_enabled"] is False
        assert set(s) == set(ref_obs.stamp())


# --------------------------------------------- the two registries alike

def _obs_sequence(o, tensor):
    """One fixed sequence of obs calls; ``tensor`` makes the package's
    device scalar."""
    with o.scope(True):
        with o.span("root", impl="x", n=3):
            o.count("c")
            with o.span("child") as sp:
                sp.note(rounds=2)
                o.count("c", 2, kernel="assign")
                o.gauge("g", tensor(1.5))
                before = o.snapshot()
            with o.span("child2", n_clusters=4):
                o.observe("h", 3.0)
                o.observe("h", 100.0)
                o.gauge("g", 7)
                o.gauge("plan", "bm=32", kernel="assign")
                o.count("c")
        o.event("admit", n=2, slots=[0, 1])
        after = o.snapshot()
    return before, after


def _normalised_tree(o):
    """The package's tree of its own records, durations and start times
    replaced by the span's creation order."""
    recs = sorted(o.trace_records(), key=lambda r: r["id"])
    for i, r in enumerate(recs):
        r["dur_us"], r["ts_us"] = float(i), float(i)
    return o.format_tree(recs)


class TestRegistriesAlike:
    def test_same_calls_same_snapshot_diff_and_tree(self):
        port = _obs_sequence(obs, torch.tensor)
        ref = _obs_sequence(ref_obs, jnp.asarray)
        for snap in ref:     # jnp.asarray may trace: a jit compile there
            snap["counters"].pop("retrace_count", None)
        assert port == ref
        assert obs.diff(*port) == ref_obs.diff(*ref)
        assert _normalised_tree(obs) == _normalised_tree(ref_obs)
        recs = ref_obs.trace_records()
        assert obs.format_tree(recs) == ref_obs.format_tree(recs)

    @pytest.mark.parametrize("kw", [
        dict(n_users=40, d=16, top_k=6, model_params=10_000,
             mode="streaming"),
        dict(n_users=8, d=4, top_k=2),
        dict(n_users=1024, d=512, top_k=8, model_params=11_000_000,
             dtype_bytes=2, mode="broadcast"),
    ])
    def test_record_ledger_equal(self, kw):
        from repro.core.oneshot import CommLedger as RefLedger

        with obs.scope(True):
            obs.record_ledger(CommLedger(**kw))
        with ref_obs.scope(True):
            ref_obs.record_ledger(RefLedger(**kw))
        port, ref = obs.snapshot()["gauges"], ref_obs.snapshot()["gauges"]
        assert port == ref
        assert all(type(port[k]) is type(ref[k]) for k in port)


# ------------------------------------------------------ parity contract

def _record(o, fn):
    """Run ``fn`` with the package's telemetry on; returns its records
    and ``fn``'s result."""
    o.reset()
    with o.scope(True):
        out = fn()
    recs = sorted(o.trace_records(), key=lambda r: r["id"])
    return dict(trace=recs, snap=o.snapshot(), events=o.events()), out


def _close(a, b, what):
    if isinstance(a, bool) or isinstance(b, bool) or isinstance(a, str) \
            or isinstance(b, str) or a is None or b is None:
        assert a == b, what
    elif isinstance(a, int) and isinstance(b, int):
        assert a == b, what
    else:
        assert a == pytest.approx(b, rel=0, abs=FLOAT_TOL), what


def _tree(recs):
    """Each span as (name, parent's name, depth, meta keys), in creation
    order."""
    by_id = {r["id"]: r for r in recs}
    return [(r["name"], by_id[r["parent"]]["name"] if r["parent"] else None,
             r["depth"], sorted(r.get("meta", {}))) for r in recs]


def assert_parity(port: dict, ref: dict) -> None:
    """The parity contract (``repro_torch/obs/__init__.py``)."""
    assert _tree(port["trace"]) == _tree(ref["trace"])
    for p, r in zip(port["trace"], ref["trace"]):
        for k, v in p.get("meta", {}).items():
            if k not in OWN_VALUES:
                _close(v, r["meta"][k], f"{p['name']} meta {k}")
    pc = {k: v for k, v in port["snap"]["counters"].items()
          if k not in OWN_COUNTERS}
    rc = {k: v for k, v in ref["snap"]["counters"].items()
          if k not in OWN_COUNTERS}
    assert pc == rc
    pg, rg = port["snap"]["gauges"], ref["snap"]["gauges"]
    assert pg.keys() == rg.keys()
    for k in pg:
        if k.startswith("comm"):
            assert pg[k] == rg[k], k
        else:
            _close(pg[k], rg[k], k)
    ph, rh = port["snap"]["histograms"], ref["snap"]["histograms"]
    assert ph.keys() == rh.keys()
    assert {k: h["count"] for k, h in ph.items()} == \
        {k: h["count"] for k, h in rh.items()}
    assert [e["kind"] for e in port["events"]] == \
        [e["kind"] for e in ref["events"]]
    for p, r in zip(port["events"], ref["events"]):
        assert p.keys() == r.keys(), p["kind"]
        for k in p.keys() - {"seq", "t_us", "kind"} - OWN_VALUES:
            _close(p[k], r[k], f"{p['kind']} {k}")


def _feats_oneshot():
    """``tests/test_obs.py``'s ledger test input."""
    rng = np.random.default_rng(1)
    return [rng.normal(size=(16, 6)).astype(np.float32) for _ in range(8)]


@pytest.fixture(scope="module")
def mixture():
    """``tests/test_torch_oneshot.py``'s raw-path mixture."""
    return ref_syn.make_task_feature_mixture(32, 40, 24, 4, seed=5)


class TestParityContract:
    @pytest.mark.parametrize("block_users", [0, 4])
    def test_oneshot_dense_and_blockwise(self, block_users):
        feats = _feats_oneshot()
        port, res = _record(obs, lambda: one_shot_clustering(
            feats, 2, cfg=SimilarityConfig(block_users=block_users),
            device="cpu"))
        ref, _ = _record(ref_obs, lambda: ref_oneshot.one_shot_clustering(
            feats, 2, cfg=ref_sim.SimilarityConfig(
                block_users=block_users)))
        assert_parity(port, ref)
        mode = "blockwise" if block_users else "dense"
        assert port["snap"]["counters"][
            f"protocol.dispatches{{mode={mode}}}"] == 1
        assert [r["name"] for r in port["trace"]] == [
            "oneshot.run", "protocol.run", "protocol.dispatch",
            "cluster.hac", "cluster.cut"]
        assert port["snap"]["gauges"]["comm.mode"] == (
            "streaming" if block_users else "broadcast")
        assert res.labels.device == CPU

    def test_oneshot_raw(self, mixture):
        from repro.core.signature_engine import SignatureConfig as RefSig
        from repro.data.features import FeatureConfig as RefFeat
        from repro_torch.core.signature_engine import SignatureConfig
        from repro_torch.data.features import FeatureConfig

        feats, _ = mixture
        port, _ = _record(obs, lambda: one_shot_clustering(
            feats, 4, cfg=SimilarityConfig(top_k=3),
            feature_cfg=FeatureConfig(kind="random_projection", d=12),
            signature_cfg=SignatureConfig(chunk_rows=16), device="cpu"))
        ref, _ = _record(ref_obs, lambda: ref_oneshot.one_shot_clustering(
            feats, 4, cfg=ref_sim.SimilarityConfig(top_k=3),
            feature_cfg=RefFeat(kind="random_projection", d=12),
            signature_cfg=RefSig(chunk_rows=16)))
        assert_parity(port, ref)
        assert [r["name"] for r in port["trace"]] == [
            "oneshot.run", "protocol.run_raw", "signature.accumulate_grams",
            "cluster.hac", "cluster.cut"]

    def test_signature_engine_signatures(self, mixture):
        from repro.core.signature_engine import (SignatureConfig as RefSig,
                                                 SignatureEngine as RefEng)
        from repro.data.features import FeatureConfig as RefFeat
        from repro_torch.core.signature_engine import (SignatureConfig,
                                                       SignatureEngine)
        from repro_torch.data.features import FeatureConfig

        feats, _ = mixture
        port, _ = _record(obs, lambda: SignatureEngine(
            FeatureConfig(kind="random_projection", d=12),
            SignatureConfig(chunk_rows=16), device="cpu").signatures(
                feats, top_k=3))
        ref, _ = _record(ref_obs, lambda: RefEng(
            RefFeat(kind="random_projection", d=12),
            RefSig(chunk_rows=16)).signatures(feats, top_k=3))
        assert_parity(port, ref)
        assert [r["name"] for r in port["trace"]] == [
            "signature.signatures", "signature.accumulate_grams"]

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_membership_serving(self, backend):
        """``tests/test_torch_membership.py``'s seed and wave: seed,
        assign, admit, evict, drift_stats, a forced re-cluster, then an
        unassigned wave that trips the drift trigger."""
        n_seed, n_tasks, d, top_k = 24, 3, 16, 6
        feats, _ = ref_syn.make_task_feature_mixture(
            n_users=n_seed + 9, n_samples=48, d=d, n_tasks=n_tasks, seed=7)
        cfg = ref_sim.SimilarityConfig(top_k=top_k)
        seed = ref_oneshot.one_shot_clustering(jnp.asarray(feats[:n_seed]),
                                               n_tasks, cfg=cfg)
        from repro.core.engine import ProtocolEngine as RefProtocolEngine
        lam_w, v_w, _ = RefProtocolEngine(cfg).signatures(
            jnp.asarray(feats[n_seed:]))
        lam, v, labels = (np.asarray(seed.lam), np.asarray(seed.v),
                          np.asarray(seed.labels))
        lam_w, v_w = np.asarray(lam_w), np.asarray(v_w)
        kw = dict(recluster_unassigned_frac=0.1)

        def serve(engine):
            engine.seed(lam, v, labels, n_clusters=n_tasks)
            out = engine.assign(lam_w, v_w)
            slots = engine.admit(lam_w, v_w, out.labels)
            engine.evict(host(slots)[::2].tolist() + [0, 5])
            engine.drift_stats()
            assert engine.recluster(force=True)
            assert not engine.maybe_recluster()
            engine.admit(lam_w[:4], v_w[:4], np.full(4, UNASSIGNED))
            assert engine.maybe_recluster()
            return engine

        port, eng = _record(obs, lambda: serve(MembershipEngine(
            MembershipConfig(backend=backend, **kw), device="cpu")))
        ref, _ = _record(ref_obs, lambda: serve(RefMemEngine(RefMemConfig(
            backend={"numpy": "numpy", "torch": "jnp"}[backend], **kw))))
        assert_parity(port, ref)
        kinds = [e["kind"] for e in port["events"]]
        assert kinds == ["seed", "assign_wave", "admit", "evict",
                         "recluster", "admit", "drift_trip", "recluster"]
        assert [e["forced"] for e in port["events"]
                if e["kind"] == "recluster"] == [True, False]
        assert port["snap"]["counters"]["recluster_events"] == 2
        assert port["snap"]["counters"]["cluster.hac_runs"] == 2
        assert eng.state.n_reclusters == 2


# ------------------------------------------------------------ launchers

class TestLaunchers:
    def _snapshots(self, tmp_path):
        paths = []
        for i, extra in enumerate((0, 3)):
            obs.reset()
            with obs.scope(True):
                obs.count("a", 1 + extra)
                obs.gauge("g", 1.5 + extra)
                obs.gauge("mode", "dense" if extra else "blockwise")
                obs.observe("h", 2.0)
                if extra:
                    obs.observe("h", 40.0)
                    obs.count("b")
            paths.append(str(obs.save_snapshot(tmp_path / f"s{i}.json")))
        return paths

    @pytest.mark.parametrize("as_json", [False, True])
    def test_compare_prints_the_reference_text(self, tmp_path, capsys,
                                               as_json):
        before, after = self._snapshots(tmp_path)
        argv = ["compare", before, after] + (["--json"] if as_json else [])
        launch_obs.main(argv)
        port = capsys.readouterr().out
        ref_launch_obs.main(argv)
        assert port == capsys.readouterr().out
        assert "counter deltas" in port or as_json
        launch_obs.main(["compare", before, before])
        assert capsys.readouterr().out == "no differences\n"

    def test_report_renders_reference_records(self, tmp_path, capsys,
                                              feats_obs):
        ref_obs.reset()
        with ref_obs.scope(True):
            ref_oneshot.one_shot_clustering(feats_obs, 2)
            ref_obs.event("admit", n=2, slots=[0, 1])
        trace = ref_obs.save_trace(tmp_path / "trace.jsonl")
        metrics = ref_obs.save_snapshot(tmp_path / "metrics.json")
        events = ref_obs.save_events(tmp_path / "events.jsonl")
        argv = ["report", "--trace", str(trace), "--metrics", str(metrics),
                "--events", str(events)]
        launch_obs.main(argv)
        port = capsys.readouterr().out
        ref_launch_obs.main(argv)
        assert port == capsys.readouterr().out
        assert "oneshot.run" in port and "by kind: admit=1" in port

    def test_report_quick_on_cpu(self, tmp_path, capsys):
        launch_obs.main(["report", "--quick", "--device", "cpu", "--out",
                         str(tmp_path)])
        out = capsys.readouterr().out
        for section in ("== trace ==", "== metrics ==", "== events =="):
            assert section in out
        assert "membership.assign" in out and "comm_upload_bytes" in out
        assert "by kind: admit=1, assign_wave=1, seed=1" in out
        assert not obs.enabled()

    def test_report_quick_without_card_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_obs.main(["report", "--quick", "--out", str(tmp_path)])

    def test_report_needs_an_input(self):
        with pytest.raises(SystemExit, match="report: pass"):
            launch_obs.main(["report"])
        with pytest.raises(SystemExit, match="profile: give a module"):
            launch_obs.main(["profile", "--"])

    def test_profile_runs_a_launcher(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setattr("sys.argv", list(__import__("sys").argv))
        launch_obs.main(["profile", "--logdir", str(tmp_path), "--",
                         "repro_torch.launch.membership", "--device", "cpu",
                         "--quick"])
        out = capsys.readouterr().out
        assert "honest accuracy 100.0%" in out
        assert not obs.enabled()
        (trace,) = tmp_path.glob("trace_*.json")
        names = {e.get("name") for e in
                 json.loads(trace.read_text())["traceEvents"]}
        assert {"oneshot.run", "membership.assign",
                "membership.admit"} <= names

    def test_membership_events_match_reference(self, tmp_path, capsys,
                                               monkeypatch):
        from repro.launch import membership as ref_launch_membership
        from repro_torch.launch import membership as launch_membership

        port_p, ref_p = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
        launch_membership.main(["--device", "cpu", "--quick", "--events",
                                str(port_p)])
        assert not obs.enabled()
        monkeypatch.setattr("sys.argv", ["membership", "--quick",
                                         "--events", str(ref_p)])
        ref_launch_membership.main()
        out = capsys.readouterr().out
        assert out.count("wrote 10 event(s)") == 2
        port, ref = obs.load_events(port_p), ref_obs.load_events(ref_p)
        assert [e["kind"] for e in port] == [e["kind"] for e in ref]
        assert [e.keys() for e in port] == [e.keys() for e in ref]


class TestShardedRecords:
    """The sharded backend on a one-rank group: the dispatch span's mode
    is ``shard_map``, and the raw path's per-rank body records no ingest
    span, as the reference's sharded body records none."""

    def test_dense_and_raw_on_one_rank(self, mixture):
        from _torch_dist_support import one_rank_world
        from repro.core.signature_engine import SignatureConfig as RefSig
        from repro.data.features import FeatureConfig as RefFeat
        from repro_torch.core.signature_engine import SignatureConfig
        from repro_torch.data.features import FeatureConfig

        feats, _ = mixture
        raw_kw = dict(feature_cfg=FeatureConfig(kind="random_projection",
                                                d=12),
                      signature_cfg=SignatureConfig(backend="shard_map",
                                                    chunk_rows=16))
        ref_raw_kw = dict(feature_cfg=RefFeat(kind="random_projection",
                                              d=12),
                          signature_cfg=RefSig(backend="shard_map",
                                               chunk_rows=16))
        cfg = SimilarityConfig(top_k=3, backend="shard_map")
        ref_cfg = ref_sim.SimilarityConfig(top_k=3, backend="shard_map")
        with one_rank_world() as mesh:
            dense, _ = _record(obs, lambda: one_shot_clustering(
                feats, 4, cfg=cfg, mesh=mesh, device="cpu"))
            raw, _ = _record(obs, lambda: one_shot_clustering(
                feats, 4, cfg=cfg, mesh=mesh, device="cpu", **raw_kw))
        ref_dense, _ = _record(ref_obs, lambda: (
            ref_oneshot.one_shot_clustering(feats, 4, cfg=ref_cfg)))
        ref_raw, _ = _record(ref_obs, lambda: (
            ref_oneshot.one_shot_clustering(feats, 4, cfg=ref_cfg,
                                            **ref_raw_kw)))
        assert_parity(dense, ref_dense)
        assert_parity(raw, ref_raw)
        assert dense["snap"]["counters"][
            "protocol.dispatches{mode=shard_map}"] == 1
        assert [r["name"] for r in raw["trace"]] == [
            "oneshot.run", "protocol.run_raw", "cluster.hac", "cluster.cut"]
