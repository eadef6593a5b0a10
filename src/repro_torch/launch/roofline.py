"""Roofline model: the hardware table and the analytic kernel costs.

Mirrors the hardware and kernel-cost half of
``src/repro/launch/roofline.py``:

* ``HardwareSpec`` and ``HW_TABLE``, keyed by device kind
  (``kernels.dispatch.device_kind``), with the GPU entries and a CPU entry
  so the host still gets a (rough) roof; ``detect_hardware`` matches the
  device's kind, falling back by platform.  No TPU reaches the port, so
  the table holds no TPU entry.
* ``Roofline``: compute, memory and collective terms of a program from
  its per-device operation and byte counts, its bottleneck and useful
  FLOP ratio; ``model_flops`` (6ND training, 2ND inference).
* ``kernel_costs`` / ``kernel_roofline``: analytic ``{"flops",
  "bytes"}`` of one kernel dispatch under a tile plan, in the reference's
  formulas and block vocabulary, against a hardware roof.

The ``h100`` entry's peak is dense bf16; ``detect_hardware(peak_flops=)``
gives the other roofs: fp32 outside the tensor cores (``FP32_FLOPS``)
and dense TF32 (``TF32_FLOPS``), which the 3xTF32 kernels run on.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.kernels import dispatch

__all__ = ["HardwareSpec", "HW_TABLE", "H100", "FP32_FLOPS", "TF32_FLOPS",
           "detect_hardware", "model_flops", "Roofline", "kernel_costs",
           "kernel_roofline"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks: dense-matmul FLOP/s (bf16 where the unit has one),
    main-memory bandwidth, and per-link interconnect bandwidth."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 column: dense bf16
# tensor-core 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 900 GB/s both ways (450
# GB/s a direction).  The same sheet gives the fp32 (66.9 TFLOP/s) and
# dense TF32 (494.7 TFLOP/s) peaks, passed as ``peak_flops`` overrides.
H100 = HardwareSpec("gpu-h100", peak_flops=989e12, hbm_bw=3350e9,
                    link_bw=450e9)
FP32_FLOPS = 66.9e12
TF32_FLOPS = 494.7e12

#: Device-kind -> peaks.  Keys are matched as lowercase substrings of
#: ``dispatch.device_kind()`` (e.g. "NVIDIA H100 80GB HBM3" matches
#: "h100").
HW_TABLE: dict[str, HardwareSpec] = {
    "a100": HardwareSpec("gpu-a100", peak_flops=312e12, hbm_bw=1555e9,
                         link_bw=300e9),
    "h100": H100,
    # The host: one AVX-ish core-complex worth of f32 matmul and a
    # DDR-class memory system.  Deliberately round numbers: the CPU roof
    # only ranks tile plans, it is not a performance claim.
    "cpu": HardwareSpec("cpu", peak_flops=2e11, hbm_bw=50e9, link_bw=10e9),
}


def detect_hardware(peak_flops: float | None = None,
                    device="cuda") -> HardwareSpec:
    """``device``'s ``HardwareSpec`` by device-kind substring match,
    falling back to the platform ("gpu": the A100 entry; "cpu").
    ``peak_flops`` overrides the matmul peak (another roof, or an
    unlisted card)."""
    kind = dispatch.device_kind(device).lower()
    hw = next((spec for key, spec in HW_TABLE.items() if key in kind), None)
    if hw is None:
        hw = HW_TABLE["a100" if dispatch.backend_kind(device) == "gpu"
                      else "cpu"]
    if peak_flops is not None:
        hw = dataclasses.replace(hw, name=f"{hw.name}-custom",
                                 peak_flops=float(peak_flops))
    return hw


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6ND for training (fwd+bwd), 2ND for inference."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


@dataclasses.dataclass
class Roofline:
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_counts: dict[str, int]
    collective_bytes_by_kind: dict[str, int]
    model_flops_global: float
    hw: HardwareSpec = H100

    @property
    def compute_term_s(self) -> float:
        return self.hlo_flops_per_device / self.hw.peak_flops

    @property
    def memory_term_s(self) -> float:
        return self.hlo_bytes_per_device / self.hw.hbm_bw

    @property
    def collective_term_s(self) -> float:
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_term_s,
                 "memory": self.memory_term_s,
                 "collective": self.collective_term_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "chips": self.chips,
            "hw": self.hw.name,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_counts": self.collective_counts,
            "collective_bytes_by_kind": self.collective_bytes_by_kind,
            "model_flops_global": self.model_flops_global,
            "compute_term_s": self.compute_term_s,
            "memory_term_s": self.memory_term_s,
            "collective_term_s": self.collective_term_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


# ---------------------------------------------------------------------------
# Analytic kernel cost models
# ---------------------------------------------------------------------------

def kernel_costs(kernel: str, blocks: dict | None = None,
                 itemsize: int = 4, **dims: int) -> dict[str, float]:
    """Analytic ``{"flops", "bytes"}`` for one kernel dispatch under a
    tile plan, as the reference counts them.

    FLOPs are tile-independent (the useful work); bytes are not: a tile
    plan that re-streams an operand per output block pays for it here.
    ``itemsize`` is the streamed-operand element size (4 f32, 2 bf16,
    1 int8 directory).  Dims and blocks follow the reference's tuning
    vocabulary (``block_d``, ``block_k``, ``block_n``, ``block_b``).
    """
    b = dict(blocks or {})
    if kernel == "gram":
        n, d = dims["n"], dims["d"]
        bd = b.get("block_d", 128)
        # each of the (d/bd)^2 output tiles streams two (n, bd) panels
        tiles = max(1, -(-d // bd)) ** 2
        return {"flops": 2.0 * n * d * d,
                "bytes": tiles * 2.0 * n * bd * itemsize + d * d * 4.0}
    if kernel == "gram_project":
        n, d, k = dims["n"], dims["d"], dims["k"]
        bk = b.get("block_k", 128)
        kblocks = max(1, -(-k // bk))
        # X re-streams once per k-block; V rides per (k, n) grid step
        return {"flops": 4.0 * n * d * k,
                "bytes": (kblocks * n * d + n // max(b.get("block_n", 128),
                                                     1) * d * k) * itemsize
                + k * 4.0}
    if kernel == "featurize_gram":
        n, m, d = dims["n"], dims["m"], dims["d"]
        return {"flops": 2.0 * n * m * d + 2.0 * n * d * d,
                "bytes": (n * m + m * d) * itemsize + d * d * 4.0}
    if kernel == "eigproject":
        d, k = dims["d"], dims["k"]
        bd = b.get("block_d", 128)
        bk = b.get("block_k", 128)
        kblocks = max(1, -(-k // bk))
        rowblocks = max(1, -(-d // bd))
        # G re-streams per k-block; V re-streams per row-block
        return {"flops": 2.0 * d * d * k,
                "bytes": (kblocks * d * d + rowblocks * d * k) * itemsize
                + k * 4.0}
    if kernel == "linkage":
        n = dims["n"]
        # two source rows + mask in, one row out, plus the fused reduction
        return {"flops": 5.0 * n, "bytes": 4.0 * n * 4.0}
    if kernel == "assign":
        bb, d2, t = dims["b"], dims["d2"], dims.get("t", 128)
        bbk = b.get("block_b", 128)
        rowblocks = max(1, -(-bb // bbk))
        # S streams once; the directory re-streams per wave row-block
        return {"flops": 2.0 * bb * d2 * t,
                "bytes": bb * d2 * 4.0 + rowblocks * t * d2 * itemsize
                + bb * (t + 2) * 4.0}
    raise ValueError(f"no cost model for kernel {kernel!r}")


def kernel_roofline(kernel: str, blocks: dict | None = None,
                    hw: HardwareSpec | None = None, itemsize: int = 4,
                    **dims: int) -> dict[str, Any]:
    """Roofline terms for one kernel dispatch: analytic costs against the
    card's (or the given) hardware roof, plus the bound classification and
    the time floor the tile plan cannot beat."""
    hw = hw or detect_hardware()
    costs = kernel_costs(kernel, blocks, itemsize=itemsize, **dims)
    compute_s = costs["flops"] / hw.peak_flops
    memory_s = costs["bytes"] / hw.hbm_bw
    return {
        "kernel": kernel, "hw": hw.name, "blocks": dict(blocks or {}),
        "flops": costs["flops"], "bytes": costs["bytes"],
        "compute_term_s": compute_s, "memory_term_s": memory_s,
        "roof_s": max(compute_s, memory_s),
        "bound": "compute" if compute_s >= memory_s else "memory",
        "arithmetic_intensity": (costs["flops"] / costs["bytes"]
                                 if costs["bytes"] else 0.0),
    }
