"""The port's roofline model (``launch/roofline.py``, the hardware and
kernel-cost half) against the JAX package's.

For the same ``HardwareSpec`` and arguments the ``Roofline`` terms,
``model_flops``, ``kernel_costs`` and ``kernel_roofline`` equal the
reference's, over all six cost models.  The table's GPU and CPU entries
are the reference's; it holds no TPU entry.  A card reporting
``"NVIDIA H100 80GB HBM3"`` resolves to ``gpu-h100``.
"""
import dataclasses

import pytest

from repro.launch import roofline as ref_rf
from repro_torch.kernels import dispatch
from repro_torch.launch import roofline as rf


def ref_hw(hw: rf.HardwareSpec) -> ref_rf.HardwareSpec:
    return ref_rf.HardwareSpec(**dataclasses.asdict(hw))


def patch_kind(monkeypatch, kind: str, platform: str) -> None:
    monkeypatch.setattr(dispatch, "device_kind", lambda device="cuda": kind)
    monkeypatch.setattr(dispatch, "backend_kind",
                        lambda device="cuda": platform)


class TestHardwareTable:
    @pytest.mark.parametrize("key", ["a100", "h100", "cpu"])
    def test_entries_are_the_references(self, key):
        assert dataclasses.asdict(rf.HW_TABLE[key]) == dataclasses.asdict(
            ref_rf.HW_TABLE[key])

    def test_h100_datasheet_values(self):
        assert rf.H100 == rf.HW_TABLE["h100"]
        assert (rf.H100.peak_flops, rf.H100.hbm_bw, rf.H100.link_bw) == (
            989e12, 3350e9, 450e9)
        assert (rf.FP32_FLOPS, rf.TF32_FLOPS) == (66.9e12, 494.7e12)

    def test_no_tpu_entry(self):
        assert not any(spec.name.startswith("tpu")
                       for spec in rf.HW_TABLE.values())

    def test_cpu_entry(self):
        assert rf.detect_hardware(device="cpu") == rf.HW_TABLE["cpu"]
        assert dataclasses.asdict(rf.detect_hardware(device="cpu")) == \
            dataclasses.asdict(ref_rf.detect_hardware())

    @pytest.mark.parametrize("kind,name", [
        ("NVIDIA H100 80GB HBM3", "gpu-h100"),
        ("NVIDIA H100 PCIe", "gpu-h100"),
        ("NVIDIA A100-SXM4-80GB", "gpu-a100"),
        ("NVIDIA L4", "gpu-a100")])         # an unlisted card: by platform
    def test_cards_resolve(self, monkeypatch, kind, name):
        patch_kind(monkeypatch, kind, "gpu")
        assert rf.detect_hardware().name == name

    def test_peak_override(self, monkeypatch):
        ref = ref_rf.detect_hardware(peak_flops=rf.TF32_FLOPS)
        assert ref.name == "cpu-custom"       # the reference on this host
        assert dataclasses.asdict(rf.detect_hardware(
            peak_flops=rf.TF32_FLOPS, device="cpu")) == \
            dataclasses.asdict(ref)
        patch_kind(monkeypatch, "NVIDIA H100 80GB HBM3", "gpu")
        hw = rf.detect_hardware(peak_flops=rf.TF32_FLOPS)
        assert hw.name == "gpu-h100-custom"
        assert hw.peak_flops == 494.7e12 and hw.hbm_bw == rf.H100.hbm_bw


@pytest.mark.parametrize("n_params,tokens,kind", [
    (2_032_000_000, 2048, "train"), (1_600_000_000, 16, "decode"),
    (7, 3, "prefill")])
def test_model_flops_equal(n_params, tokens, kind):
    assert rf.model_flops(n_params, tokens, kind) == ref_rf.model_flops(
        n_params, tokens, kind)


ROOFLINE_ARGS = [
    dict(chips=1, hlo_flops_per_device=3.3e13, hlo_bytes_per_device=4e10,
         collective_bytes_per_device=0.0, collective_counts={},
         collective_bytes_by_kind={}, model_flops_global=2.4e13),
    dict(chips=4, hlo_flops_per_device=1e12, hlo_bytes_per_device=8e11,
         collective_bytes_per_device=9e11,
         collective_counts={"all-gather": 3},
         collective_bytes_by_kind={"all-gather": 9e11},
         model_flops_global=3e12),
    dict(chips=2, hlo_flops_per_device=0.0, hlo_bytes_per_device=1.0,
         collective_bytes_per_device=0.0, collective_counts={},
         collective_bytes_by_kind={}, model_flops_global=0.0),
]


@pytest.mark.parametrize("args", ROOFLINE_ARGS)
@pytest.mark.parametrize("key", ["h100", "a100", "cpu"])
def test_roofline_terms_equal(args, key):
    hw = rf.HW_TABLE[key]
    port = rf.Roofline(**args, hw=hw)
    ref = ref_rf.Roofline(**args, hw=ref_hw(hw))
    for term in ("compute_term_s", "memory_term_s", "collective_term_s",
                 "bottleneck", "useful_flops_ratio"):
        assert getattr(port, term) == getattr(ref, term), term
    assert port.to_dict() == ref.to_dict()


def test_roofline_defaults_to_the_h100():
    assert rf.Roofline(**ROOFLINE_ARGS[0]).hw == rf.H100


#: (kernel, blocks, itemsize, dims) over all six cost models.
COST_CASES = [
    ("gram", None, 4, dict(n=256, d=512)),
    ("gram", {"block_d": 256}, 2, dict(n=300, d=70)),
    ("gram_project", None, 4, dict(n=256, d=512, k=8)),
    ("gram_project", {"block_k": 64, "block_n": 32}, 4,
     dict(n=1000, d=784, k=200)),
    ("featurize_gram", None, 4, dict(n=252, m=3072, d=512)),
    ("featurize_gram", None, 2, dict(n=64, m=192, d=16)),
    ("eigproject", None, 4, dict(d=512, k=8192)),
    ("eigproject", {"block_d": 64, "block_k": 256}, 4, dict(d=130, k=5)),
    ("linkage", None, 4, dict(n=1024)),
    ("assign", None, 2, dict(b=128, d2=512 * 512, t=4)),
    ("assign", {"block_b": 256}, 1, dict(b=1024, d2=262144, t=128)),
    ("assign", None, 4, dict(b=7, d2=64)),
]


@pytest.mark.parametrize("kernel,blocks,itemsize,dims", COST_CASES)
def test_kernel_costs_equal(kernel, blocks, itemsize, dims):
    assert rf.kernel_costs(kernel, blocks, itemsize, **dims) == \
        ref_rf.kernel_costs(kernel, blocks, itemsize, **dims)


@pytest.mark.parametrize("kernel,blocks,itemsize,dims", COST_CASES)
@pytest.mark.parametrize("key", ["h100", "cpu"])
def test_kernel_roofline_equal(kernel, blocks, itemsize, dims, key):
    hw = rf.HW_TABLE[key]
    port = rf.kernel_roofline(kernel, blocks, hw, itemsize, **dims)
    ref = ref_rf.kernel_roofline(kernel, blocks, ref_hw(hw), itemsize,
                                 **dims)
    assert port == ref
    assert port["hw"] == hw.name


def test_kernel_roofline_on_the_card_by_default(monkeypatch):
    patch_kind(monkeypatch, "NVIDIA H100 80GB HBM3", "gpu")
    assert rf.kernel_roofline("linkage", n=1024)["hw"] == "gpu-h100"


def test_unknown_cost_model_raises_the_same():
    with pytest.raises(ValueError) as port:
        rf.kernel_costs("flash_attention", n=1)
    with pytest.raises(ValueError) as ref:
        ref_rf.kernel_costs("flash_attention", n=1)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# The compiled-artifact half: the HLO parser, traced steps, analyze and
# memory_summary
# ---------------------------------------------------------------------------

# tests/test_infra.py's HLO text, and an async pair of each kind
HLO = """
  %all-gather.1 = f32[1024,512]{1,0} all-gather(f32[64,512]{1,0} %p), x
  %all-reduce.2 = bf16[256]{0} all-reduce(bf16[256]{0} %q), y
  %ag-start = (f32[8]{0}) all-gather-start(f32[2]{0} %r), z
  %done = f32[8]{0} all-gather-done(%ag-start)
  %unrelated = f32[9]{0} add(f32[9]{0} %a, f32[9]{0} %b)
"""
HLO_MORE = HLO + """
  %rs = bf16[16,8]{1,0} reduce-scatter(bf16[256,8]{1,0} %x), dimensions={0}
  %a2a = s32[4,4]{1,0} all-to-all(s32[4,4]{1,0} %y), dimensions={0}
  %cp-start = (u8[100]{0}) collective-permute-start(u8[100]{0} %z)
  %cp-done = u8[100]{0} collective-permute-done(%cp-start)
"""


@pytest.mark.parametrize("text", [HLO, HLO_MORE, ""])
def test_parse_collectives_equals_reference(text):
    assert dataclasses.asdict(rf.parse_collectives(text)) == \
        dataclasses.asdict(ref_rf.parse_collectives(text))


def test_parse_collectives_counts_of_test_infra():
    stats = rf.parse_collectives(HLO)
    assert stats.counts == {"all-gather": 2, "all-reduce": 1}
    assert stats.bytes_by_kind["all-gather"] == 1024 * 512 * 4 + 32
    assert stats.bytes_by_kind["all-reduce"] == 512


def _record():
    return rf.StepRecord(
        flops=197e12, bytes=819e9 * 2,
        collectives=[("all-gather", 64 * 512 * 4, 1024 * 512 * 4),
                     ("all-reduce", 512, 512), ("all-gather", 8, 32)],
        argument_bytes=100.0, output_bytes=30.0, temp_bytes=50.0,
        alias_bytes=20.0)


def test_collective_stats_count_as_the_parser():
    """A traced step's collectives give the stats the HLO of the same
    ops gives the reference's parser."""
    stats = rf.collective_stats(_record())
    assert dataclasses.asdict(stats) == dataclasses.asdict(
        ref_rf.parse_collectives(HLO))


def test_analyze_matches_reference_roofline():
    rec = _record()
    got = rf.analyze(rec, 256, 197e12 * 256 / 2, hw=rf.HW_TABLE["h100"])
    stats = rf.collective_stats(rec)
    want = ref_rf.Roofline(
        chips=256, hlo_flops_per_device=rec.flops,
        hlo_bytes_per_device=rec.bytes,
        collective_bytes_per_device=float(stats.bytes_per_device),
        collective_counts=stats.counts,
        collective_bytes_by_kind=stats.bytes_by_kind,
        model_flops_global=197e12 * 256 / 2,
        hw=ref_hw(rf.HW_TABLE["h100"]))
    assert got.to_dict() == want.to_dict()
    assert got.hw is rf.H100 and rf.analyze(rec, 1, 1.0).hw is rf.H100


def test_memory_summary_keys_and_total():
    out = rf.memory_summary(_record())
    assert out == {"argument_size_in_bytes": 100.0,
                   "output_size_in_bytes": 30.0,
                   "temp_size_in_bytes": 50.0,
                   "alias_size_in_bytes": 20.0,
                   "total_hbm_bytes": 100.0 + 30.0 + 50.0 - 20.0}


def test_trace_step_counts_softmax_and_conversions():
    """A dtype conversion is one FLOP an element (XLA's convert), a
    softmax five (its decomposition), a copy none."""
    import torch

    x = torch.ones((4, 8), dtype=torch.bfloat16)

    def step(x):
        return torch.softmax(x.float(), dim=-1).clone()

    _, rec = rf.trace_step(step, x)
    assert rec.matmul_flops == 0
    assert rec.pointwise_flops == 4 * 8
    assert rec.reduction_flops == 5 * 4 * 8
    assert rec.flops == 6 * 4 * 8


def test_trace_step_counts_flops_bytes_and_memory():
    """A plain step on the CPU: the FLOPs by class (the matmul's, one an
    element of the pointwise add and mul, one an input element of the
    sum), every non-view op's operands and results, the arguments, the
    output, the peak of the temporaries and an in-place write to an
    argument."""
    import torch

    a = torch.ones((8, 16))
    b = torch.ones((16, 4))
    acc = torch.zeros((8, 4))

    def step(a, b, acc):
        t = a @ b                   # 2 * 8 * 16 * 4 FLOPs
        acc.add_(t)                 # in place on an argument
        return (t * 2.0).sum()

    out, rec = rf.trace_step(step, a, b, acc)
    assert float(out) == 2.0 * 8 * 4 * 16
    assert rec.matmul_flops == 2 * 8 * 16 * 4
    assert rec.pointwise_flops == 2 * 8 * 4
    assert rec.reduction_flops == 8 * 4
    assert rec.flops == 2 * 8 * 16 * 4 + 3 * 8 * 4
    assert rec.argument_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert rec.output_bytes == 4
    assert rec.alias_bytes == 8 * 4 * 4
    # a @ b reads 8x16 and 16x4, writes 8x4; add_ reads two 8x4, writes
    # one; mul reads 8x4, writes 8x4; sum reads 8x4, writes 1
    assert rec.bytes == 4 * ((128 + 64 + 32) + 3 * 32 + 2 * 32 + 33)
    assert rec.temp_bytes >= 2 * 8 * 4 * 4
    assert rec.collectives == []
