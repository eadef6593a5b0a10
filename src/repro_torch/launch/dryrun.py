"""Multi-pod dry run, PyTorch port of ``src/repro/launch/dryrun.py``:
trace every (architecture x input shape) on the production meshes and
record memory, cost and roofline artifacts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_1_7b \\
      --shape train_4k --mesh pod --verbose
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multipod \\
      --skip-existing

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, in the
reference's schema (it writes experiments/dryrun/).

Nothing is compiled and nothing computes.  ``main`` / ``run_one`` start
a fake process group of 256 or 512 ranks in this process (the only
place one exists: it is the process's default group, so the dry run
cannot share a process with a real group), build the production mesh
on it, build the parameters, optimizer state, inputs and decode state
under ``FakeTensorMode`` (shapes, no data), place them as DTensors of
``launch/sharding.py``'s specs, and run the step of ``launch/steps.py``
once on rank 0's local shards under ``roofline.trace_step``.  The
layers run in a loop, so the full-depth counts are exact; the
reference's scan correction (its XLA cost analysis counts a scanned
body once) is kept from the 1-group and 2-group variants, and its
extrapolation beside the full-depth count.

Attention takes the plain path (``attn_impl="jnp"``, the configs'
default): fake tensors launch no kernel.  ``--block-impl manual`` runs
``launch/manual_tp.py``'s step on rank 0's fake local shards (dense
decoders; its functional collectives are recorded like DTensor's).

The fake mesh is a CUDA mesh by default (``--device-type cuda``), whose
collectives are a card mesh's; it needs a machine with a card.
``--device-type cpu`` traces on a cpu mesh anywhere, where DTensor has
no all-to-all and issues an all-gather and a chunk instead.

Beside the reference's keys the artifact has ``flops_counted`` (the
traced FLOPs by class: products, pointwise, reductions),
``sharding.replicated`` (the splits that gathered a mesh axis:
``layers.split_dim``'s kv heads and RWKV mix LoRA) and
``sharding.padded`` (the query-head splits padded to the axis:
``layers.split_heads``, Llama-4-Scout's 40 heads as 48 on a 16-wide
"model" axis), each with the padded heads' FLOPs a device and their
share of the traced FLOPs (``padding_flops``).  ``model_flops`` stays on
the config's heads, so the useful-FLOPs ratio counts the padded work as
not useful.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch import optim
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.launch import mesh as ML
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L

__all__ = ["LM_ARCHS", "OUT_DIR", "fake_world", "trace", "run_one", "main"]

LM_ARCHS = [a for a in ARCH_IDS if not a.startswith("paper_")]
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _real_index_math():
    """``(owner, name, replacement)`` patches for DTensor's index math
    under ``FakeTensorMode``.  DTensor works out shard offsets with small
    ``arange`` tensors and reads them back; under the fake mode those are
    fake and cannot be read (``DataDependentOutputException``).  Each
    patched function runs on real tensors; ``_StridedShard``'s even case
    is closed form (its ``arange`` spans the whole dim, 10^6 rows for a
    flattened batch x sequence).  Written against torch 2.11 and 2.13,
    whose offset-mode arguments differ (``return_first_offset``, then
    ``offset_mode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor import placement_types as pt

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    strided = pt._StridedShard.local_shard_size_and_offset
    modes = getattr(pt, "_StridedShardOffsetMode", None)

    def offset_mode(args, kwargs) -> str:
        """"first", "all" or "none", from either torch's arguments."""
        if modes is not None:
            mode = modes(args[0] if args else kwargs.get(
                "offset_mode", modes.FIRST))
            return mode.name.lower()
        first = args[0] if args else kwargs.get("return_first_offset", True)
        return "first" if first else "all"

    def local_shard_size_and_offset(self, size, num_chunks, rank, *args,
                                    **kwargs):
        sf = int(self.split_factor)
        if isinstance(size, int) and isinstance(rank, int) \
                and size % (sf * num_chunks) == 0:
            c = size // (sf * num_chunks)
            piece = size // sf
            mode = offset_mode(args, kwargs)
            if mode == "none":
                return sf * c, None
            if mode == "first":
                return sf * c, rank * c if c else -1
            return sf * c, [j * piece + rank * c + i
                            for j in range(sf) for i in range(c)]
        return real(strided)(self, size, num_chunks, rank, *args, **kwargs)

    return [(pt._StridedShard, "local_shard_size_and_offset",
             local_shard_size_and_offset),
            (_utils, "_compute_local_shape_and_global_offset",
             real(_utils._compute_local_shape_and_global_offset))]


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this is rank 0) as
    the default group, for the duration."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                        # pragma: no cover
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            f"which this torch lacks: {e}") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "this process already has a default group")
    patches = _real_index_math()
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _fake_inputs(specs: dict) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}


def trace(cfg, shape, mesh, opts: SH.ShardingOptions,
          block_impl: str = "auto") -> RL.StepRecord:
    """Build the step's fake, placed arguments and trace one step on
    rank 0's shards (inside ``fake_world``)."""
    batch = _fake_inputs(ST.input_specs(cfg, shape))
    if shape.kind == "decode":
        batch = {"tokens": batch["tokens"]}
    batch = SH.attach(batch, SH.batch_specs(batch, mesh), mesh)

    if block_impl == "manual" and shape.kind == "train":
        from repro_torch.launch import manual_tp as MT

        return MT.trace_manual_step(cfg, mesh, batch)

    model = ST.abstract_params(cfg)
    pspecs = SH.param_specs(cfg, model, mesh, opts)
    if shape.kind == "train":
        model.requires_grad_(True)
        SH.attach(model, pspecs, mesh)
        optimizer = optim.adamw(1e-4)
        opt_state = ST.abstract_opt_state(cfg, optimizer, model)
        step = ST.make_train_step(cfg, mesh, optimizer, opts,
                                  param_specs=pspecs)
        return RL.trace_step(step, model, opt_state, batch)[1]
    SH.attach(model, pspecs, mesh)
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, mesh, opts)
        return RL.trace_step(step, model, batch)[1]
    state = ST.abstract_decode_state(cfg, shape)
    state = SH.attach(state, SH.state_specs(state, mesh), mesh)
    step = ST.make_serve_step(cfg, mesh, opts)
    return RL.trace_step(step, model, state, batch)[1]


def padding_flops(cfg1, shape, mesh, opts: SH.ShardingOptions,
                  block_impl: str, entry: dict, flops_padded: float
                  ) -> float:
    """The FLOPs a device spends on ``entry``'s padded query heads in one
    layer group (``cfg1``, whose padded trace counted ``flops_padded``).

    A device's FLOPs are linear in its head slots: ``p`` a slot of the
    projections (which hold the config's heads, ``size / w`` a rank)
    and ``c`` a slot of the work on split heads (``padded_size / w``).
    Two more traces of ``cfg1``, with ``padded_size - w`` and
    ``padded_size`` heads (both divide ``w``: no padding), give
    ``u = p + c`` and ``v = flops_padded - F(padded_size - w) =
    (size / w - padded_size / w + 1) p + c``; the padded slots' work is
    ``c (padded_size - size) / w``.  A decode step makes the heads whole
    before its attention, and ``c`` comes out near 0 there."""
    n, n_pad, w = entry["size"], entry["padded_size"], entry["axis_size"]
    heads = (n_pad - w, n_pad)
    if any(h % cfg1.n_kv_heads for h in heads):
        return float("nan")
    lo, hi = (float(trace(dataclasses.replace(cfg1, n_heads=h), shape,
                          mesh, opts, block_impl).flops) for h in heads)
    u, v = hi - lo, flops_padded - lo
    a = (n - n_pad + w) / w               # the projections' slots over lo
    c = (v - a * u) / (1.0 - a)
    return c * (n_pad - n) / w


def _metrics(rec: RL.StepRecord) -> dict:
    stats = RL.collective_stats(rec)
    return {"flops": float(rec.flops), "bytes": float(rec.bytes),
            "coll_bytes": float(stats.bytes_per_device),
            "coll_counts": stats.counts,
            "coll_bytes_by_kind": stats.bytes_by_kind}


def run_one(arch_id: str, shape_name: str, mesh_kind: str,
            opts: SH.ShardingOptions | None = None,
            verbose: bool = False, attn_impl: str | None = None,
            block_impl: str = "auto", cfg=None, mesh_shape=None,
            device_type: str = "cuda") -> dict:
    """One artifact.  ``cfg`` replaces the arch's config (a test's
    REDUCED widths); ``mesh_shape`` = ``(shape, axes)`` replaces the
    production mesh of ``mesh_kind``.  ``device_type`` is the fake
    mesh's: "cuda" (on a machine with a card) makes DTensor issue the
    collectives it issues on cards, where a "cpu" mesh has no
    all-to-all."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run traces on a fake CUDA mesh by "
                           "default and this host has no card; pass "
                           "--device-type cpu (device_type='cpu') for a "
                           "cpu mesh")
    shape = INPUT_SHAPES[shape_name]
    base_cfg = cfg if cfg is not None else get_arch(arch_id)
    cfg = ST.variant_for_shape(base_cfg, shape)
    variant = "swa" if cfg is not base_cfg else "base"
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if cfg.attn_impl == "pallas":
        raise ValueError("the dry run traces the plain attention path: fake "
                         "tensors launch no kernel")
    mesh_dims, axes = mesh_shape or MESHES[mesh_kind]
    chips = math.prod(mesh_dims)
    opts = opts or SH.ShardingOptions()

    from torch._subclasses.fake_tensor import FakeTensorMode

    pat_len = len(cfg.block_pattern)
    if cfg.encoder_layers:
        cfg1 = dataclasses.replace(cfg, scan_layers=False, n_layers=1,
                                   encoder_layers=1)
        cfg2 = dataclasses.replace(cfg, scan_layers=False, n_layers=2,
                                   encoder_layers=2)
        extra_groups = cfg.n_layers - 1.0
    else:
        cfg1 = dataclasses.replace(cfg, scan_layers=False, n_layers=pat_len)
        cfg2 = dataclasses.replace(cfg, scan_layers=False,
                                   n_layers=2 * pat_len)
        extra_groups = cfg.n_groups - 1.0 + len(cfg.rest_kinds) / pat_len
    with fake_world(chips), L.replications() as replicated, \
            L.paddings() as padded:
        mesh = ML.make_mesh(mesh_dims, axes, device_type=device_type)
        with FakeTensorMode():
            # the artifact: the full-depth program
            t0 = time.perf_counter()
            rec = trace(cfg, shape, mesh, opts, block_impl)
            t_trace = time.perf_counter() - t0
            # the scan correction's two unrolled shallow variants
            t0 = time.perf_counter()
            m1 = _metrics(trace(cfg1, shape, mesh, opts, block_impl))
            m2 = _metrics(trace(cfg2, shape, mesh, opts, block_impl))
            t_variants = time.perf_counter() - t0
            for entry in padded:
                entry["flops_per_device"] = padding_flops(
                    cfg1, shape, mesh, opts, block_impl, entry,
                    m1["flops"]) * (1.0 + extra_groups)
                entry["flops_share"] = entry["flops_per_device"] / float(
                    rec.flops)
    raw = _metrics(rec)

    keys = ("flops", "bytes", "coll_bytes")
    extrapolated = {k: m1[k] + extra_groups * (m2[k] - m1[k]) for k in keys}
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mf = RL.model_flops(cfg.n_active_params(), tokens, shape.kind)
    roof = RL.analyze(rec, chips, mf)

    result = {
        "arch": arch_id, "arch_name": cfg.name, "shape": shape_name,
        "mesh": mesh_kind, "chips": chips, "kind": shape.kind,
        "variant": variant,
        # no lowering or compiling: the full-depth trace, and the two
        # shallow variants'
        "lower_s": round(t_trace, 2), "compile_s": round(t_variants, 2),
        "memory": RL.memory_summary(rec),
        "roofline": roof.to_dict(),
        # the port's program is not scanned: its raw counts are exact
        "roofline_raw_scanned": {k: raw[k] for k in keys},
        "scan_correction": {"extra_groups": extra_groups,
                            "g1": {k: m1[k] for k in keys},
                            "g2": {k: m2[k] for k in keys},
                            "extrapolated": extrapolated},
        "sharding": {"fsdp": opts.fsdp,
                     "activation_mode": opts.activation_mode,
                     "replicated": replicated, "padded": padded,
                     "mesh_device_type": device_type},
        "flops_counted": {"matmul": float(rec.matmul_flops),
                          "pointwise": float(rec.pointwise_flops),
                          "reduction": float(rec.reduction_flops)},
        "status": "ok",
    }
    if verbose:
        print(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default=None, choices=["pod", "multipod"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--activation-mode", default="seq",
                    choices=["dp", "seq", "tensor", "megatron"])
    ap.add_argument("--attn-impl", default=None,
                    choices=["jnp", "chunked", "pallas"])
    ap.add_argument("--block-impl", default="auto",
                    choices=["auto", "manual"])
    ap.add_argument("--tag", default="", help="suffix for artifact files")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--device-type", default="cuda", choices=["cpu", "cuda"],
                    help="the fake mesh's device type (cuda needs a card)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else LM_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]
    opts = SH.ShardingOptions(fsdp=bool(args.fsdp),
                              activation_mode=args.activation_mode)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                out = out_dir / f"{arch}__{shape}__{mesh_kind}{tag}.json"
                if args.skip_existing and out.exists():
                    print(f"[skip] {out.name}")
                    continue
                label = f"{arch} x {shape} x {mesh_kind}"
                try:
                    t0 = time.perf_counter()
                    result = run_one(arch, shape, mesh_kind, opts,
                                     args.verbose, args.attn_impl,
                                     args.block_impl,
                                     device_type=args.device_type)
                    dt = time.perf_counter() - t0
                    print(f"[ok]   {label}  ({dt:.1f}s, "
                          f"bottleneck={result['roofline']['bottleneck']})",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    result = {"arch": arch, "shape": shape,
                              "mesh": mesh_kind, "status": "fail",
                              "error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()[-4000:]}
                    failures.append(label)
                    print(f"[FAIL] {label}: {type(e).__name__}: {e}",
                          flush=True)
                out.write_text(json.dumps(result, indent=2))
    if failures:
        print(f"\n{len(failures)} FAILURES:\n  " + "\n  ".join(failures))
        return 1
    print("\nall dry-runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
