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

And its compiled-artifact half, for ``launch/dryrun.py``.  The reference
reads XLA's compiled module: ``cost_analysis()`` for FLOPs and bytes,
the HLO text (``parse_collectives``) for collectives, and
``memory_analysis()``.  Nothing is compiled here: ``trace_step`` runs a
step once on a rank's local shards (fake tensors on a fake process
group, in the dry run) and records a ``StepRecord``:

* FLOPs of the matmul-class ops (torch's ``flop_registry``: mm, bmm,
  addmm, convolutions, attention) on local shapes, so per device.  XLA
  also counts elementwise ops.
* bytes: every non-view op's operands and results, unfused.  XLA counts
  bytes after fusion, so this memory term is pessimistic.
* collectives: each functional collective DTensor or a manual step
  issues, with its operand and result bytes; ``collective_stats`` sums
  them as ``parse_collectives`` sums the HLO's (the larger of operand
  and result, a ring-transfer proxy).
* memory: the local bytes of the arguments (parameters, optimizer state,
  inputs), of the outputs, the peak of live local bytes above the
  arguments, and the argument bytes written in place.

``parse_collectives`` is the reference's parser of HLO text, copied.

The ``h100`` entry's peak is dense bf16; ``detect_hardware(peak_flops=)``
gives the other roofs: fp32 outside the tensor cores (``FP32_FLOPS``)
and dense TF32 (``TF32_FLOPS``), which the 3xTF32 kernels run on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from typing import Any, Callable

import torch

from repro_torch.kernels import dispatch

__all__ = ["HardwareSpec", "HW_TABLE", "H100", "FP32_FLOPS", "TF32_FLOPS",
           "detect_hardware", "model_flops", "Roofline", "kernel_costs",
           "kernel_roofline", "CollectiveStats", "parse_collectives",
           "StepRecord", "trace_step", "collective_stats", "analyze",
           "memory_summary"]


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


# ---------------------------------------------------------------------------
# The compiled-artifact half: collectives, traced steps, memory
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?:\()?\s*(\w+\[[\d,]*\][^ ]*|\([^)]*\))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")


def _shape_bytes(text: str) -> int:
    """Sum bytes over every TYPE[dims] occurrence in ``text``."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_per_device: int
    counts: dict[str, int]
    bytes_by_kind: dict[str, int]


def _stats(ops) -> CollectiveStats:
    """``(kind, operand bytes, result bytes)`` triples -> the stats, each
    op counted at the larger of its operand and result."""
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    bytes_by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, operand_bytes, result_bytes in ops:
        counts[kind] += 1
        bytes_by_kind[kind] += max(result_bytes, operand_bytes)
    return CollectiveStats(
        bytes_per_device=sum(bytes_by_kind.values()),
        counts={k: v for k, v in counts.items() if v},
        bytes_by_kind={k: v for k, v in bytes_by_kind.items() if v})


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of an HLO module's text (the reference's parser)."""
    ops = []
    for line in hlo_text.splitlines():
        line = line.strip()
        if "-done(" in line:          # async pair: count the -start only
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        result_text, kind = m.groups()
        # operand shapes appear in the argument list after the op name
        ops.append((kind, _shape_bytes(line[m.end():]),
                    _shape_bytes(result_text)))
    return _stats(ops)


#: Functional collective (and DTensor's own all-to-all on a CUDA mesh)
#: -> the HLO kind it stands for.
_COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                     "all_reduce": "all-reduce",
                     "reduce_scatter_tensor": "reduce-scatter",
                     "all_to_all_single": "all-to-all",
                     "shard_dim_alltoall": "all-to-all",
                     "broadcast": "collective-permute"}

#: Ops that move no bytes: allocations and aliases the schema does not
#: mark as views.
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view", "wait_tensor", "device"}


#: FLOPs an element for the softmax family, which torch runs as one op
#: and XLA as its decomposition: max, subtract, exp, sum and divide (or
#: log) forward; a product, a sum, a subtract and a product backward.
_SOFTMAX_FLOPS = {"_softmax": 5, "_log_softmax": 5,
                  "_softmax_backward_data": 4,
                  "_log_softmax_backward_data": 4}
#: Scans, counted like reductions (one FLOP an input element).
_SCANS = {"cumsum", "cumprod", "logcumsumexp"}
#: Pointwise-tagged ops that compute nothing.
_COPIES = {"clone"}


@dataclasses.dataclass
class StepRecord:
    """What one traced step did on one rank (``trace_step``).  ``flops``
    is the sum of its three classes, counted as XLA's cost analysis
    counts them: ``matmul_flops`` (torch's ``flop_registry``: products
    and convolutions), ``pointwise_flops`` (one an output element of a
    pointwise op, a dtype conversion included) and ``reduction_flops``
    (one an input element of a reduction or scan; the softmax family by
    ``_SOFTMAX_FLOPS``)."""
    flops: float = 0.0
    matmul_flops: float = 0.0
    pointwise_flops: float = 0.0
    reduction_flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    alias_bytes: float = 0.0
    ops: int = 0


def _local_tensors(tree) -> list[torch.Tensor]:
    """The plain tensors of a tree: a DTensor's local shard, a module's
    parameters."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _local_tensors(x)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "_asdict"):                 # an OptState
        return _local_tensors(list(tree._asdict().values()))
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors) -> tuple[dict, int]:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return seen, sum(n for _, n in seen.values())


class _Tracer:
    """A dispatch mode over the plain (local) tensors of a step: ops on
    DTensors pass through (``NotImplemented``), so that each op is seen
    as a rank runs it, DTensor's collectives included."""

    def __init__(self, record: StepRecord, arg_storages: dict):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        tracer = self
        self.record = record
        self.args = arg_storages
        self.mutated: set[int] = set()
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.paused = 0
        self.finalizers: list = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not tracer.paused:
                    tracer.account(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.args:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)
        self.finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _count_flops(self, func, name, args, kwargs, out, flat_in,
                     flat_out, flop_registry) -> None:
        rec = self.record
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            rec.matmul_flops += n
        elif not flat_out or not flat_in:
            return
        elif torch.Tag.pointwise in func.tags and name not in _COPIES or (
                name == "_to_copy"
                and flat_out[0].dtype != flat_in[0].dtype):
            n = flat_out[0].numel()
            rec.pointwise_flops += n
        elif torch.Tag.reduction in func.tags or name in _SCANS \
                or name in _SOFTMAX_FLOPS:
            n = flat_in[0].numel() * _SOFTMAX_FLOPS.get(name, 1)
            rec.reduction_flops += n
        else:
            return
        rec.flops += n

    def account(self, func, args, kwargs, out, flop_registry) -> None:
        rec = self.record
        rec.ops += 1
        flat_in = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        flat_out = [a for a in torch.utils._pytree.tree_leaves(out)
                    if isinstance(a, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        namespace = func.namespace
        if namespace in ("_c10d_functional", "_dtensor"):
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is not None:
                rec.collectives.append(
                    (kind, sum(map(_nbytes, flat_in)),
                     sum(map(_nbytes, flat_out))))
        else:
            self._count_flops(func, name, args, kwargs, out, flat_in,
                              flat_out, flop_registry)
            if not func.is_view and name not in _NO_BYTES:
                rec.bytes += sum(map(_nbytes, flat_in)) + sum(
                    map(_nbytes, flat_out))
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is not None and info.is_write:
                target = args[i] if i < len(args) else kwargs.get(arg.name)
                if isinstance(target, torch.Tensor):
                    key = id(target.untyped_storage())
                    if key in self.args:
                        self.mutated.add(key)
        for t in flat_out:
            self._track(t)


@contextlib.contextmanager
def _unseen_metadata(tracer: "_Tracer"):
    """DTensor works out an op's output shape by running it once on fake
    tensors of the global shape (``_propagate_tensor_meta_non_cached``,
    cached after the first call); those runs are not the rank's work and
    the tracer skips them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate(self, *args, **kwargs):
        tracer.paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            tracer.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def trace_step(step: Callable, *args) -> tuple[Any, StepRecord]:
    """Run ``step(*args)`` once under the tracer: ``(its outputs, the
    rank's StepRecord)``.  The arguments are the parameters, optimizer
    state and inputs (trees of tensors or DTensors, or a module)."""
    record = StepRecord()
    arg_storages, record.argument_bytes = _storage_bytes(
        _local_tensors(list(args)))
    tracer = _Tracer(record, arg_storages)
    with _unseen_metadata(tracer), tracer.mode:
        out = step(*args)
    _, record.output_bytes = _storage_bytes(_local_tensors(out))
    record.temp_bytes = float(tracer.peak)
    record.alias_bytes = float(sum(arg_storages[k][1]
                                   for k in tracer.mutated))
    # the finalizers hold the tracer, and it the arguments' storages:
    # let both go with the step
    for fin in tracer.finalizers:
        fin.detach()
    arg_storages.clear()
    return out, record


def collective_stats(record: StepRecord) -> CollectiveStats:
    """``parse_collectives``'s stats from the collectives a traced step
    issued."""
    return _stats(record.collectives)


def analyze(record: StepRecord, chips: int, model_flops_global: float,
            hw: HardwareSpec = H100) -> Roofline:
    stats = collective_stats(record)
    return Roofline(
        chips=chips,
        hlo_flops_per_device=float(record.flops),
        hlo_bytes_per_device=float(record.bytes),
        collective_bytes_per_device=float(stats.bytes_per_device),
        collective_counts=stats.counts,
        collective_bytes_by_kind=stats.bytes_by_kind,
        model_flops_global=model_flops_global,
        hw=hw,
    )


def memory_summary(record: StepRecord) -> dict[str, float]:
    """The reference's ``memory_analysis()`` keys for a traced step (no
    ``generated_code_size_in_bytes``: nothing is compiled)."""
    out = {"argument_size_in_bytes": float(record.argument_bytes),
           "output_size_in_bytes": float(record.output_bytes),
           "temp_size_in_bytes": float(record.temp_bytes),
           "alias_size_in_bytes": float(record.alias_bytes)}
    out["total_hbm_bytes"] = (out["argument_size_in_bytes"]
                              + out["output_size_in_bytes"]
                              + out["temp_size_in_bytes"]
                              - out["alias_size_in_bytes"])
    return out
