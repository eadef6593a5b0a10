"""The port's dry run (``launch/dryrun.py``) on the CPU.

It starts a fake process group, which becomes its process's default
group, so it runs in a subprocess (the reference keeps its placeholder
devices to its own entry point the same way), with the config table
patched to REDUCED widths (qwen3 at 3 layers, so that the scan
correction extrapolates over two groups, and 16 heads of 16 for the
manual path's 16 tensor-parallel ranks):

* ``main`` writes an artifact with the reference's keys (its memory
  keys but ``generated_code_size_in_bytes``: nothing is compiled), and
  the port's ``flops_counted`` (FLOPs by class, which add up to
  ``hlo_flops_per_device``) and ``sharding.replicated`` (the 8 kv heads
  that the 16-wide "model" axis does not divide, gathered);
* the scan correction's extrapolation from the 1- and 2-group variants
  equals the full-depth count (FLOPs, bytes, collective bytes);
* on a pure data-parallel fake mesh (4, 1) (``activation_mode="dp"``,
  ``fsdp=False``) the per-device product FLOPs are exactly the
  one-device count divided by the chips (the pointwise ones are not:
  AdamW updates the replicated parameters whole on every chip);
* ``argument_size_in_bytes`` equals the local bytes worked out from the
  parameter and batch specs (AdamW's m and v in fp32 and its int32
  step);
* a manual-TP train artifact on the pod mesh, and the refusal of a
  non-dense config there;
* without ``--device-type`` the mesh is a CUDA mesh, which on a host
  without a card fails with the flag to pass;
* Llama-4-Scout with its 40 query heads (narrow: head dim 8, the REDUCED
  widths otherwise) on the pod mesh, whose 16-wide "model" axis does not
  divide them: an ``ok`` artifact whose ``sharding.padded`` records the
  heads padded to 48, with the padded heads' FLOPs a device, while the
  8 kv heads are gathered as before; and an RWKV-6 config with 40 heads
  (not query heads: nothing pads them), which still fails with the
  split's ``ValueError``.

Every run but the last passes ``--device-type cpu``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")

REF_KEYS = {"arch", "arch_name", "shape", "mesh", "chips", "kind", "variant",
            "lower_s", "compile_s", "memory", "roofline",
            "roofline_raw_scanned", "scan_correction", "sharding", "status"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes", "total_hbm_bytes"}
REF_ROOFLINE = {"chips", "hw", "hlo_flops_per_device", "hlo_bytes_per_device",
                "collective_bytes_per_device", "collective_counts",
                "collective_bytes_by_kind", "model_flops_global",
                "compute_term_s", "memory_term_s", "collective_term_s",
                "bottleneck", "useful_flops_ratio"}

SCRIPT = textwrap.dedent("""
    import os
    os.nice(10)   # below the rest of a parallel test run
    import dataclasses, json, math, sys, tempfile
    from pathlib import Path
    import torch
    from repro_torch.configs import base
    from repro_torch.launch import dryrun as DR, sharding as SH, steps as ST

    def reduced(arch):
        # qwen3 at 3 layers, 16 heads (8 kv) of 16: the manual path
        # splits the heads over the 16 tensor-parallel ranks;
        # llama4_scout's 40 query heads (8 kv) and an RWKV-6 of 40 heads
        # on the same 16-wide axis
        cfg = base.get_arch(arch, reduced=True)
        if arch == "qwen3_1_7b":
            return dataclasses.replace(cfg, n_layers=3, n_heads=16,
                                       n_kv_heads=8, head_dim=16)
        if arch == "llama4_scout":
            return dataclasses.replace(cfg, n_heads=40, n_kv_heads=8,
                                       head_dim=8)
        if arch == "rwkv6_1_6b" and PATCH_RWKV[0]:
            return dataclasses.replace(cfg, d_model=40 * cfg.rwkv_head_dim)
        return cfg

    PATCH_RWKV = [False]

    torch.set_num_threads(1)   # fake tensors: the work is Python's
    DR.get_arch = reduced
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cpu = ["--device-type", "cpu"]
        rc = DR.main(["--arch", "qwen3_1_7b", "--shape", "train_4k",
                      "--mesh", "pod", "--out-dir", tmp] + cpu)
        art = json.loads(Path(tmp, "qwen3_1_7b__train_4k__pod.json")
                         .read_text())
        rc2 = DR.main(["--arch", "qwen3_1_7b", "--shape", "train_4k",
                       "--mesh", "pod", "--out-dir", tmp,
                       "--block-impl", "manual", "--tag", "manual"] + cpu)
        manual = json.loads(Path(tmp, "qwen3_1_7b__train_4k__pod__manual"
                                      ".json").read_text())
        DR.main(["--arch", "rwkv6_1_6b", "--shape", "train_4k",
                 "--mesh", "pod", "--out-dir", tmp, "--block-impl",
                 "manual"] + cpu)
        refused = json.loads(Path(tmp, "rwkv6_1_6b__train_4k__pod.json")
                             .read_text())
        # no flag: a fake CUDA mesh, which needs a card
        rc3 = DR.main(["--arch", "qwen3_1_7b", "--shape", "train_4k",
                       "--mesh", "pod", "--out-dir", tmp, "--tag", "cuda"])
        no_card = json.loads(Path(tmp, "qwen3_1_7b__train_4k__pod__cuda"
                                       ".json").read_text())
        rc4 = DR.main(["--arch", "llama4_scout", "--shape", "train_4k",
                       "--mesh", "pod", "--out-dir", tmp] + cpu)
        padded = json.loads(Path(tmp, "llama4_scout__train_4k__pod.json")
                            .read_text())
        PATCH_RWKV[0] = True
        DR.main(["--arch", "rwkv6_1_6b", "--shape", "train_4k",
                 "--mesh", "pod", "--out-dir", tmp, "--tag", "40"] + cpu)
        PATCH_RWKV[0] = False
        unpadded = json.loads(Path(tmp, "rwkv6_1_6b__train_4k__pod__40"
                                        ".json").read_text())
    out["padded"] = (rc4, padded, unpadded)
    out["no_card"] = (rc3, no_card, torch.cuda.is_available())
    out["main_rc"], out["artifact"] = rc, art
    out["manual_rc"], out["manual"], out["refused"] = rc2, manual, refused

    # argument bytes from the specs
    cfg = reduced("qwen3_1_7b")
    shape = base.INPUT_SHAPES["train_4k"]
    sizes = {"data": 16, "model": 16}
    mesh = type("M", (), {"shape": sizes})()

    def local_bytes(shape_, spec, itemsize):
        n = 1
        for i, d in enumerate(shape_):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // math.prod(sizes[a] for a in axes)
        return n * itemsize

    model = ST.abstract_params(cfg)
    specs = SH.param_specs(cfg, model, mesh)
    total = 0
    for name, p in model.named_parameters():
        total += local_bytes(p.shape, specs[name], p.element_size())
        total += 2 * local_bytes(p.shape, specs[name], 4)   # AdamW m, v
    total += 4                                             # AdamW step
    inputs = ST.input_specs(cfg, shape)
    bspecs = SH.batch_specs(inputs, mesh)
    for k, s in inputs.items():
        total += local_bytes(s.shape, bspecs[k],
                             torch.empty((), dtype=s.dtype).element_size())
    out["argument_bytes_from_specs"] = total

    # pure data parallel: 4 chips against 1
    dp = SH.ShardingOptions(fsdp=False, activation_mode="dp")
    flops = {}
    for n in (1, 4):
        r = DR.run_one("qwen3_1_7b", "train_4k", "dp", dp,
                       mesh_shape=((n, 1), ("data", "model")),
                       device_type="cpu")
        flops[n] = r["flops_counted"]["matmul"]
    out["dp_flops"] = flops
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def test_artifact_has_reference_keys(result):
    art = result["artifact"]
    assert result["main_rc"] == 0 and art["status"] == "ok"
    assert set(art) == REF_KEYS | {"flops_counted"}
    assert set(art["memory"]) == REF_MEMORY
    assert set(art["roofline"]) == REF_ROOFLINE
    assert art["chips"] == 256 and art["roofline"]["hw"] == "gpu-h100"
    assert art["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert 0 < art["roofline"]["useful_flops_ratio"] <= 1.05
    assert art["sharding"]["mesh_device_type"] == "cpu"
    assert art["sharding"]["replicated"] == [
        {"split": "kv_heads", "axis": "model", "size": 8,
         "axis_size": 16}]


def test_flops_classes_add_up(result):
    art = result["artifact"]
    counted = art["flops_counted"]
    assert set(counted) == {"matmul", "pointwise", "reduction"}
    assert all(v > 0 for v in counted.values())
    assert art["roofline"]["hlo_flops_per_device"] == sum(counted.values())


def test_default_mesh_is_cuda(result):
    rc, art, has_card = result["no_card"]
    if has_card:
        pytest.skip("this host has a card: the CUDA mesh is traced")
    assert rc == 1 and art["status"] == "fail"
    assert "--device-type cpu" in art["error"]


def test_scan_correction_extrapolates_to_full_depth(result):
    art = result["artifact"]
    sc = art["scan_correction"]
    assert sc["extra_groups"] == 2.0
    for key in ("flops", "bytes", "coll_bytes"):
        assert sc["extrapolated"][key] == art["roofline_raw_scanned"][key]
    assert art["roofline"]["hlo_flops_per_device"] == \
        art["roofline_raw_scanned"]["flops"] > 0


def test_pure_data_parallel_splits_flops_exactly(result):
    flops = result["dp_flops"]
    assert flops["4"] * 4 == flops["1"] > 0


def test_argument_bytes_are_the_specs_local_bytes(result):
    assert result["artifact"]["memory"]["argument_size_in_bytes"] == \
        result["argument_bytes_from_specs"]


def test_uneven_query_heads_are_padded_and_recorded(result):
    rc, art, unpadded = result["padded"]
    assert rc == 0 and art["status"] == "ok"
    sharding = art["sharding"]
    assert sharding["replicated"] == [
        {"split": "kv_heads", "axis": "model", "size": 8, "axis_size": 16}]
    (entry,) = sharding["padded"]
    flops = entry.pop("flops_per_device")
    share = entry.pop("flops_share")
    assert entry == {"split": "q_heads", "axis": "model", "size": 40,
                     "padded_size": 48, "axis_size": 16}
    # the padded heads: 8 of 48 slots of the work on split heads, a
    # part of the step's traced FLOPs
    assert 0 < flops and 0 < share < 1
    assert share == flops / art["roofline"]["hlo_flops_per_device"]
    assert 0 < art["roofline"]["useful_flops_ratio"] <= 1.05
    # heads that are not query heads are not padded: the split raises
    assert unpadded["status"] == "fail"
    assert unpadded["error"].startswith("ValueError: split_dim: 40 of")


def test_manual_block_impl(result):
    art, refused = result["manual"], result["refused"]
    assert result["manual_rc"] == 0 and art["status"] == "ok"
    assert art["roofline"]["collective_counts"]["all-gather"] > 0
    assert art["roofline"]["collective_counts"]["reduce-scatter"] > 0
    assert refused["status"] == "fail"
    assert "dense decoders only" in refused["error"]
