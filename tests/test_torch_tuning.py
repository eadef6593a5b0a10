"""The port's tile tuner (``kernels/tuning.py``) against the JAX
package's, and the launch plans it resolves.

* The reference's pieces keep their semantics: ``shape_bucket``,
  ``divisor_block`` and the bucket part of ``cache_key`` equal the
  reference's; the record / lookup / persistence round trip, memory over
  disk, and an autotune that skips invalid candidates (timed by a fake
  clock, not by sleeps).  The port's file is ``REPRO_TORCH_TUNE_CACHE``;
  it never reads ``REPRO_TUNE_CACHE``.
* ``heuristic_blocks`` is each wrapper's own plan, equal to today's plan
  function over a grid of shapes.
* The four tunable wrappers resolve their plan through ``get_blocks``
  (their CUDA branches driven on CPU tensors by ``fake_launches``): with
  no cache entry they launch the default plan, with one they launch the
  cached plan, and a cached plan that does not fit raises ``ValueError``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_support import fake_launches  # noqa: F401  (fixture)
from repro.kernels import tuning as ref_tuning
from repro_torch.kernels import dispatch, tuning
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.eigproject.ops import eig_plan
from repro_torch.kernels.featurize_gram.ops import featurize_plan
from repro_torch.kernels.gram.ops import gram_plan
from repro_torch.kernels.gram_project import ops as gp_ops
from repro_torch.kernels.linkage.ops import chain_plan
from repro_torch.kernels.recurrent_scan import ops as rs_ops

CPU_DIMS = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clean_cache(monkeypatch):
    """No cache file, an empty memory cache, before and after."""
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    tuning.clear_cache()
    yield
    tuning.clear_cache()


class TestReferencePieces:
    @pytest.mark.parametrize("dims", [dict(n=1000, d=64), dict(n=1025, d=64),
                                      dict(b=1, t=3, d=512, sms=132),
                                      dict(s=0, d=4096, b=7, aligned=1),
                                      dict(k=129, n=2, d=2**20)])
    def test_shape_bucket_equal(self, dims):
        assert tuning.shape_bucket(**dims) == ref_tuning.shape_bucket(**dims)

    def test_shape_bucket_pow2(self):
        assert tuning.shape_bucket(n=1000, d=64) == tuning.shape_bucket(
            n=1024, d=64)
        assert tuning.shape_bucket(n=1025, d=64) != tuning.shape_bucket(
            n=1024, d=64)

    @pytest.mark.parametrize("n,cap", [(1024, 512), (384, 512), (640, 512),
                                       (128, 512), (4096, 4096), (1280, 256),
                                       (896, 4096)])
    def test_divisor_block_equal(self, n, cap):
        assert tuning.divisor_block(n, cap) == ref_tuning.divisor_block(n, cap)

    def test_divisor_block_rejects_the_same(self):
        for mod in (tuning, ref_tuning):
            with pytest.raises(ValueError, match="lane multiple"):
                mod.divisor_block(100)

    @pytest.mark.parametrize("kernel,dims", [
        ("gram", dict(n=300, d=70)), ("linkage", dict(n=256)),
        ("gram_project", dict(b=8, n=256, d=512, k=8))])
    def test_cache_key_bucket_part_equal(self, kernel, dims):
        port = tuning.cache_key(kernel, "cpu", **dims).split("|")
        ref = ref_tuning.cache_key(kernel, **dims).split("|")
        assert port[0] == ref[0] == kernel
        assert port[1] == "cpu:cpu"
        assert port[2] == ref[2]

    def test_h100_tag(self, monkeypatch):
        monkeypatch.setattr(dispatch, "resolve_device",
                            lambda device="cuda": torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None: "NVIDIA H100 80GB HBM3")
        assert tuning.cache_key("assign_one", b=128).split("|")[1] == \
            "gpu:NVIDIA H100 80GB HBM3"

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuning.cache_key("gram", d=64)

    def test_unknown_kernel_rejected(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            tuning.heuristic_blocks("conv", n=8)


class TestCache:
    def test_record_overlays_heuristic(self):
        dims = dict(b=4, n=64, d=512, k=8)
        base = tuning.get_blocks("gram_project", **CPU_DIMS, **dims)
        tuning.record("gram_project", {"stages": 1}, **CPU_DIMS, **dims)
        got = tuning.get_blocks("gram_project", **CPU_DIMS, **dims)
        assert got["stages"] == 1
        assert got["bk"] == base["bk"]            # the default kept

    def test_cache_persists_via_env(self, tmp_path, monkeypatch):
        cache = tmp_path / "tune" / "cache.json"
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
        tuning.record("assign_one", {"slice_rows": 16, "stages": 4},
                      measured_s=1e-3, **CPU_DIMS, b=64, t=4, d=512)
        assert cache.exists()
        disk = json.loads(cache.read_text())
        assert list(disk) == [tuning.cache_key("assign_one", "cpu", b=64,
                                               t=4, d=512)]
        assert disk[list(disk)[0]]["measured_s"] == 1e-3
        assert not cache.with_suffix(".json.tmp").exists()   # atomic
        tuning.clear_cache()                   # drop memory; reload disk
        assert tuning.lookup("assign_one", "cpu", b=64, t=4, d=512) == {
            "slice_rows": 16, "stages": 4}

    def test_memory_wins_over_disk(self, tmp_path, monkeypatch):
        cache = tmp_path / "cache.json"
        key = tuning.cache_key("linear_scan", "cpu", b=1, s=64, d=32)
        cache.write_text(json.dumps({key: {"blocks": {"route": "tma"}}}))
        tuning.record("linear_scan", {"route": "cp.async4"}, **CPU_DIMS,
                      b=1, s=64, d=32)
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
        assert tuning.lookup("linear_scan", "cpu", b=1, s=64, d=32) == {
            "route": "cp.async4"}

    def test_corrupt_file_ignored(self, tmp_path, monkeypatch):
        cache = tmp_path / "cache.json"
        cache.write_text("{not json")
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
        assert tuning.lookup("gram", "cpu", d=64) is None

    def test_never_reads_the_reference_file(self, tmp_path, monkeypatch):
        cache = tmp_path / "ref.json"
        key = tuning.cache_key("gram_project", "cpu", b=4, n=64, d=512, k=8)
        cache.write_text(json.dumps({key: {"blocks": {"stages": 1}}}))
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(cache))
        assert tuning.cache_path() is None
        assert tuning.lookup("gram_project", "cpu", b=4, n=64, d=512,
                             k=8) is None

    def test_autotune_picks_fastest_and_skips_invalid(self, monkeypatch):
        """Times from a patched clock: each candidate's run advances it by
        its own cost, so nothing sleeps and load cannot reorder them."""
        clock = [0.0]
        monkeypatch.setattr(tuning.time, "perf_counter", lambda: clock[0])
        cost = {16: 1e-3, 32: 4e-3}
        calls = []

        def run(blocks):
            calls.append(dict(blocks))
            if blocks["slice_rows"] == 999:
                raise ValueError("does not fit")
            clock[0] += cost[blocks["slice_rows"]]

        best = tuning.autotune(
            "assign_one", run, [{"slice_rows": 999}, {"slice_rows": 32},
                                {"slice_rows": 16}],
            n_iter=2, warmup=1, **CPU_DIMS, b=128, t=4, d=512)
        assert best == {"slice_rows": 16}
        assert tuning.lookup("assign_one", "cpu", b=128, t=4, d=512) == best
        entry = tuning._mem[tuning.cache_key("assign_one", "cpu", b=128,
                                             t=4, d=512)]
        assert entry["measured_s"] == pytest.approx(1e-3)
        assert entry["sweep"] == {'{"slice_rows": 32}': pytest.approx(4e-3),
                                  '{"slice_rows": 16}': pytest.approx(1e-3)}
        assert len(calls) == 1 + 3 + 3          # the invalid one once

    def test_autotune_all_invalid_raises(self):
        def run(blocks):
            raise ValueError("never valid")

        with pytest.raises(ValueError, match="no valid tuning candidate"):
            tuning.autotune("linear_scan", run, [{"route": "x"}],
                            **CPU_DIMS, b=1, s=8, d=8)


def _asdict(plan, drop=()):
    return {k: v for k, v in dataclasses.asdict(plan).items()
            if k not in drop}


class TestDefaultPlans:
    @pytest.mark.parametrize("b,t,d", [(1, 1, 1), (128, 4, 512),
                                       (1024, 128, 512), (37, 9, 130),
                                       (4096, 33, 64), (64, 256, 1024)])
    @pytest.mark.parametrize("sms", [132, 114])
    def test_assign_plans(self, b, t, d, sms):
        assert tuning.heuristic_blocks("assign_wave", b=b, t=t, d=d,
                                       sms=sms) == _asdict(
            assign_ops.wave_plan(b, t, d, sms))
        for k in (1, 8, 200):
            for itemsize, cd in ((2, "bf16"), (4, "fp32")):
                assert tuning.heuristic_blocks(
                    "assign_one", b=b, t=t, d=d, k=k, sms=sms,
                    itemsize=itemsize) == _asdict(
                    assign_ops.one_plan(b, t, d, k, sms, cd))

    @pytest.mark.parametrize("d", [1, 16, 130, 512, 784, 1024, 2048])
    def test_fixed_width_plans(self, d):
        assert tuning.heuristic_blocks("gram_project", b=8, n=256, d=d,
                                       k=8) == _asdict(gp_ops.project_plan(d))
        assert tuning.heuristic_blocks("gram", n=256, d=d) == _asdict(
            gram_plan(d), drop=("pairs",))
        assert tuning.heuristic_blocks("eigproject", d=d) == _asdict(
            eig_plan(d))
        for itemsize, cd in ((2, "bf16"), (4, "fp32")):
            assert tuning.heuristic_blocks(
                "featurize_gram", d=d, itemsize=itemsize) == _asdict(
                featurize_plan(d, cd))

    @pytest.mark.parametrize("b,s,d", [(1, 4096, 4096), (3, 77, 512),
                                       (1, 0, 8), (2, 130, 18)])
    def test_scan_and_chain_plans(self, b, s, d):
        for aligned in (0, 1):
            assert tuning.heuristic_blocks(
                "linear_scan", b=b, s=s, d=d, aligned=aligned) == _asdict(
                rs_ops.linear_scan_plan(b, s, d, bool(aligned)))
        assert tuning.heuristic_blocks("linkage", n=s) == _asdict(
            chain_plan(s))

    def test_compiled_tiles(self):
        assert tuning.heuristic_blocks("flash_attention", hd=128,
                                       itemsize=2)["kernel"] == "tc"
        assert tuning.heuristic_blocks("flash_attention", hd=64,
                                       itemsize=4)["rows"] == 32
        assert tuning.heuristic_blocks("wkv_chunked", hd=64) == {
            "sub_chunk": 16, "warps": 16}
        for kernel in tuning.KERNELS:
            assert kernel in dispatch.LAUNCHES
        assert set(tuning.RUNTIME_FIELDS) <= set(tuning.KERNELS)

    @pytest.mark.parametrize("kernel,dims", [
        ("assign_wave", dict(b=128, t=4, d=512, sms=132)),
        ("assign_one", dict(b=128, t=4, d=512, k=8, sms=132, itemsize=2)),
        ("gram_project", dict(b=128, n=256, d=512, k=8)),
        ("linear_scan", dict(b=1, s=4096, d=4096, aligned=1))])
    def test_get_blocks_without_entry_is_the_default(self, kernel, dims):
        assert tuning.get_blocks(kernel, lambda b: 1 / 0, **CPU_DIMS,
                                 **dims) == tuning.heuristic_blocks(kernel,
                                                                    **dims)


class TestResolve:
    def test_wave(self):
        base = _asdict(assign_ops.wave_plan(128, 4, 512, 132))
        ksteps = base["ksteps"]
        ok = dict(base, n_slices=4, ksteps_per_slice=-(-ksteps // 4))
        assert assign_ops.resolve_wave(ok) == ok
        for n, per in [(4, 10), (2, ksteps), (0, 1), (3, 0)]:
            with pytest.raises(ValueError, match="K-steps"):
                assign_ops.resolve_wave(dict(base, n_slices=n,
                                             ksteps_per_slice=per))

    def test_one(self):
        base = _asdict(assign_ops.one_plan(128, 4, 512, 8, 132, "bf16"))
        got = assign_ops.resolve_one(dict(base, slice_rows=16, stages=3),
                                     512, "bf16")
        assert got["n_slices"] == 32 and got["smem"] == \
            assign_ops.one_smem_bytes(16, base["v_rows"], 3, "bf16")
        for h, st in [(8, 4), (16, 2), (32, 6)]:
            with pytest.raises(ValueError, match="slice_rows"):
                assign_ops.resolve_one(dict(base, slice_rows=h, stages=st),
                                       512, "bf16")

    def test_project(self):
        base = _asdict(gp_ops.project_plan(2048))
        assert base["bk"] == 8
        with pytest.raises(ValueError, match="does not fit"):
            gp_ops.resolve_project(dict(base, bk=64), 2048)
        with pytest.raises(ValueError, match="bk must be"):
            gp_ops.resolve_project(dict(base, bk=12), 2048)
        got = gp_ops.resolve_project(dict(_asdict(gp_ops.project_plan(512)),
                                          bk=16, stages=1), 512)
        assert got["smem"] == gp_ops.smem_bytes(512, 16, 1)

    def test_scan(self):
        base = _asdict(rs_ops.linear_scan_plan(1, 64, 32))
        assert rs_ops.resolve_scan(dict(base, route="cp.async4"), 64, 32,
                                   True)["route"] == "cp.async4"
        for s, d, aligned in [(64, 30, True), (0, 32, True),
                              (64, 32, False)]:
            with pytest.raises(ValueError, match="TMA route"):
                rs_ops.resolve_scan(dict(base, route="tma"), s, d, aligned)
        with pytest.raises(ValueError, match="route must be"):
            rs_ops.resolve_scan(dict(base, route="bulk"), 64, 32, True)

    def test_hit_may_set_only_runtime_fields(self):
        dims = dict(b=4, n=64, d=512, k=8)
        tuning.record("gram_project", {"smem": 1}, **CPU_DIMS, **dims)
        with pytest.raises(ValueError, match="may set only"):
            tuning.get_blocks("gram_project", **CPU_DIMS, **dims)


def _wave_inputs(b=128, t=4, d=64, k=8):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(b, d, k, generator=gen),
            torch.randn(t, d, d, generator=gen))


class TestWrappersResolveThroughTheTuner:
    def test_defaults_launch_the_parents_plan(self, fake_launches):
        v, p = _wave_inputs()
        assign_ops.assign(v, p, compute_dtype="bf16")
        plan = assign_ops.wave_plan(128, 4, 64, 132)
        args = fake_launches.calls["repro_assign_wave_tc"][0]
        assert args[-5:-1] == (8, plan.block_n, plan.n_slices,
                               plan.ksteps_per_slice)
        assign_ops.assign_looped(v, p, compute_dtype="bf16")
        one = assign_ops.one_plan(128, 4, 64, 8, 132, "bf16")
        args = fake_launches.calls["repro_assign_one"][0]
        assert args[12:18] == (one.group, one.col_tiles, one.slice_rows,
                               one.v_rows, one.stages, 1)
        x, w = torch.randn(3, 40, 512), torch.randn(512, 8)
        gp_ops.batched_gram_project(x, w)
        pp = gp_ops.project_plan(512)
        assert fake_launches.calls["repro_gram_project"][0][7:9] == (
            pp.bk, pp.stages)
        a, h0 = torch.randn(1, 64, 32), torch.zeros(1, 32)
        rs_ops.linear_scan(a, a, h0)
        assert fake_launches.calls["repro_linear_scan"][0][8] == 1

    def test_cached_plans_reach_the_launch(self, fake_launches):
        v, p = _wave_inputs()
        plan = assign_ops.wave_plan(128, 4, 64, 132)
        per = -(-plan.ksteps // 2)
        dims = dict(b=128, t=4, d=64, sms=132)
        tuning.record("assign_wave", {"n_slices": 2, "ksteps_per_slice": per},
                      **CPU_DIMS, **dims)
        assign_ops.assign(v, p, compute_dtype="bf16")
        args = fake_launches.calls["repro_assign_wave_tc"][-1]
        assert args[-3:-1] == (2, per)
        tuning.record("assign_one", {"slice_rows": 16, "stages": 3},
                      **CPU_DIMS, b=128, t=4, d=64, k=8, sms=132, itemsize=4)
        assign_ops.assign_looped(v, p, compute_dtype="fp32")
        args = fake_launches.calls["repro_assign_one"][-1]
        assert args[14] == 16 and args[16] == 3 and args[17] == 0
        x, w = torch.randn(3, 40, 512), torch.randn(512, 8)
        tuning.record("gram_project", {"bk": 16, "stages": 1}, **CPU_DIMS,
                      b=3, n=40, d=512, k=8)
        gp_ops.batched_gram_project(x, w)
        assert fake_launches.calls["repro_gram_project"][-1][7:9] == (16, 1)
        a, h0 = torch.randn(1, 64, 32), torch.zeros(1, 32)
        tuning.record("linear_scan", {"route": "cp.async4"}, **CPU_DIMS,
                      b=1, s=64, d=32, aligned=1)
        rs_ops.linear_scan(a, a, h0)
        assert fake_launches.calls["repro_linear_scan"][-1][8] == 0

    @pytest.mark.parametrize("which", ["wave", "one", "project", "scan"])
    def test_cached_plan_that_does_not_fit_raises(self, fake_launches,
                                                  which):
        v, p = _wave_inputs()
        before = dict(dispatch.LAUNCHES)
        if which == "wave":
            tuning.record("assign_wave", {"n_slices": 3,
                                          "ksteps_per_slice": 1},
                          **CPU_DIMS, b=128, t=4, d=64, sms=132)
            call = lambda: assign_ops.assign(v, p, compute_dtype="bf16")
        elif which == "one":
            tuning.record("assign_one", {"stages": 9}, **CPU_DIMS, b=128,
                          t=4, d=64, k=8, sms=132, itemsize=2)
            call = lambda: assign_ops.assign_looped(v, p)
        elif which == "project":
            tuning.record("gram_project", {"bk": 64}, **CPU_DIMS, b=3, n=40,
                          d=2048, k=8)
            call = lambda: gp_ops.batched_gram_project(
                torch.randn(3, 40, 2048), torch.randn(2048, 8))
        else:
            tuning.record("linear_scan", {"route": "tma"}, **CPU_DIMS, b=1,
                          s=64, d=30, aligned=1)
            a = torch.randn(1, 64, 30)
            call = lambda: rs_ops.linear_scan(a, a, torch.zeros(1, 30))
        with pytest.raises(ValueError):
            call()
        assert fake_launches.calls == {}
        assert dispatch.LAUNCHES == before

    def test_plans_change_no_plain_result(self):
        """On the CPU the wrappers take their plain versions: a cache entry
        changes nothing there."""
        v, p = _wave_inputs()
        want = assign_ops.assign(v, p, compute_dtype="bf16")
        tuning.record("assign_wave", {"n_slices": 3, "ksteps_per_slice": 1},
                      **CPU_DIMS, b=128, t=4, d=64, sms=132)
        got = assign_ops.assign(v, p, compute_dtype="bf16")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
