"""Rank bodies for the port's mesh tests (``launch/sharding.py``,
``steps.py``, ``manual_tp.py``).

Nothing here imports JAX or the reference package: the ranks are fresh
processes that unpickle these functions by import path.  The test
process computes the reference's outputs and hands the ranks numpy
parameters (by the port's names) and batches.
"""
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import manual_tp as MT
from repro_torch.launch import mesh as ML
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.registry import get_model


@contextlib.contextmanager
def gloo_world(shape=(1, 1), axes=("data", "model")):
    """A one-rank gloo process group in this process and a mesh of
    ``shape`` (all ones) over it; the group is destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://"
                                f"{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0)
        try:
            yield ML.make_mesh(shape, axes, device_type="cpu")
        finally:
            dist.destroy_process_group()


def load_lm(cfg: ArchConfig, named: dict) -> torch.nn.Module:
    """A CPU ``LM`` holding the numpy parameters ``named`` (port names)."""
    model = transformer.init(cfg, 0, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(named[name]))
    return model


def _full(t, mesh, spec):
    """A rank's shard (plain, of ``spec``) -> the global numpy array."""
    from torch.distributed.tensor import DTensor

    d = DTensor.from_local(t, mesh, SH.placements(mesh, spec),
                           run_check=False)
    return d.full_tensor().detach().numpy()


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _auto_loss_and_grads(cfg, named: dict, batch: dict, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    m = get_model(cfg)
    model = load_lm(cfg, named).requires_grad_(True)
    SH.attach(model, SH.param_specs(cfg, model, mesh), mesh)
    dbatch = SH.attach(batch, SH.batch_specs(batch, mesh), mesh)
    with implicit_replication():
        loss = m.loss_fn(model, dbatch, SH.make_shard_fn(mesh))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.full_tensor()), {k: g.full_tensor().numpy()
                                       for k, g in zip(params, grads)}


def manual_and_auto(rank: int, world: int, inputs: dict) -> dict:
    """On a (2, 4) mesh of ``world`` gloo ranks: the manual TP+SP loss and
    gradients, the auto (DTensor) path's (and those of the configs under
    ``inputs["rwkv"]``, ``inputs["kv_replicated"]``, ``inputs["moe"]``
    and ``inputs["uneven_heads"]``, with the splits that gathered an axis
    and those that were padded), one AdamW step of the uneven-heads
    config, the MoE config on a (2, 2, 2) ("pod", "data", "model") mesh,
    the data-major placement of a dim over two axes, and the refusals of
    placements nothing can honour."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.dispatch import on_local_shards

    cfg = ArchConfig(**inputs["cfg"])
    mesh = ML.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    named = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    out: dict = {}

    # -- manual TP+SP: each rank's shards, explicit collectives
    specs = MT.param_specs_manual(cfg)
    local = MT.local_shards(named, specs, mesh)
    bspec = SH.batch_specs(batch, mesh)
    local_batch = {k: SH.attach({k: v}, {k: bspec[k]}, mesh)[k].to_local()
                   for k, v in batch.items()}
    loss_fn, _ = MT.manual_loss_fn(cfg, mesh)
    leaves = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    loss = loss_fn(leaves, local_batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    grads = MT._sum_unnamed(grads, specs, mesh)
    out["manual_loss"] = float(loss)
    out["manual_grads"] = {k: _full(g, mesh, specs[k])
                           for k, g in grads.items()}

    # -- the auto path: DTensors of sharding.py's specs, make_shard_fn;
    # the dense config, and an RWKV one (its scan on local (batch, head)
    # shards, u's gradient summed over the batch shards)
    # one whose 2 kv heads the 4-wide "model" axis does not divide
    # (Megatron's KV-head replication, recorded), an MoE one, and one
    # whose 10 query heads it does not divide (padded to 12, recorded)
    for key in ("auto", "rwkv", "kv_replicated", "moe", "uneven_heads"):
        case = inputs if key == "auto" else inputs[key]
        with L.replications() as replicated, L.paddings() as padded:
            loss, grads = _auto_loss_and_grads(
                ArchConfig(**case["cfg"]), case["params"],
                {k: torch.from_numpy(v) for k, v in case["batch"].items()},
                mesh)
        out[f"{key}_loss"], out[f"{key}_grads"] = loss, grads
        out[f"{key}_replicated"] = replicated
        out[f"{key}_padded"] = padded
    # the MoE config on three axes: the dispatch's backward is a lookup
    # of the slot buffer's gradient on local shards
    mesh3 = ML.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
    case = inputs["moe"]
    out["moe_3axis_loss"], out["moe_3axis_grads"] = _auto_loss_and_grads(
        ArchConfig(**case["cfg"]), case["params"],
        {k: torch.from_numpy(v) for k, v in case["batch"].items()}, mesh3)

    # -- one clipped AdamW step of make_train_step: the clip's norm is
    # replicated, the moments keep their parameters' placements
    from repro_torch import optim
    from repro_torch.launch import steps as ST

    model = load_lm(cfg, inputs["params"]).requires_grad_(True)
    SH.attach(model, SH.param_specs(cfg, model, mesh), mesh)
    opt = optim.adamw(1e-3)
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    norms = []
    clip = optim.clip_by_global_norm

    def recording_clip(tree, max_norm):
        norms.append(optim.global_norm(tree))
        return clip(tree, max_norm)

    optim.clip_by_global_norm = recording_clip
    try:
        state, res = ST.make_train_step(cfg, mesh, opt, clip_norm=1.0)(
            model, state, SH.attach(batch, bspec, mesh))
    finally:
        optim.clip_by_global_norm = clip
    out["step"] = dict(
        loss=float(res["loss"]),
        norm_replicated=all(p.is_replicate() for p in norms[0].placements),
        moments_placed=all(
            state.inner[m][k].placements == p.placements
            for m in ("m", "v") for k, p in model.named_parameters()),
        sharded=sum(any(pl.is_shard() for pl in p.placements)
                    for p in model.parameters()))

    # -- one AdamW step of the uneven-heads config: the padding is made in
    # the forward, so the parameters keep their names and shapes
    case = inputs["uneven_heads"]
    ucfg = ArchConfig(**case["cfg"])
    model = load_lm(ucfg, case["params"]).requires_grad_(True)
    before = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    SH.attach(model, SH.param_specs(ucfg, model, mesh), mesh)
    opt = optim.adamw(1e-3)
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    ubatch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    state, res = ST.make_train_step(ucfg, mesh, opt, clip_norm=1.0)(
        model, state, SH.attach(ubatch, SH.batch_specs(ubatch, mesh), mesh))
    out["uneven_step"] = dict(
        loss=float(res["loss"]), shapes_before=before,
        shapes_after={k: tuple(v.shape)
                      for k, v in model.state_dict().items()},
        moment_shapes={k: tuple(v.shape)
                       for k, v in state.inner["m"].items()})

    # -- cross-attention decode against a memory sharded over its
    # sequence on both axes (a long source at batch 1), against the same
    # call on plain tensors
    from repro_torch.models import attention as A

    acfg = A.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                        causal=False)
    gen = torch.Generator().manual_seed(11)
    ap = transformer.Params(A.attn_init(gen, acfg))
    xq = torch.randn(1, 1, 32, generator=gen)
    mem = [torch.randn(1, 16, 4, 8, generator=gen) for _ in range(2)]
    want = A.cross_decode(ap, acfg, xq, *mem)
    dmem = [SH.attach({"m": t}, {"m": SH.P(None, ("data", "model"))},
                      mesh)["m"] for t in mem]
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        got = A.cross_decode(ap, acfg, xq, *dmem)
    out["cross_decode_gap"] = float((got.full_tensor() - want).abs().max())

    # -- one dim over ("data", "model"): chunk d * 4 + m on rank (d, m)
    t = torch.arange(8 * 3, dtype=torch.float32)
    d = SH.attach({"t": t}, {"t": SH.P(("data", "model"))}, mesh)["t"]
    dc, mc = mesh.get_coordinate()
    out["two_axis_chunk"] = (d.to_local().numpy(), dc * 4 + mc)

    # -- refusals: a kernel given seq-sharded q/k/v, a mis-ordered spec,
    # query heads the axis does not divide, a product of a seq-sharded
    # input
    q = DTensor.from_local(torch.zeros(2, 4, 8, 4), mesh,
                           SH.placements(mesh, SH.P(None, "model")),
                           run_check=False)
    out["seq_sharded_kernel"] = _raises(lambda: on_local_shards(
        "flash_attention", lambda *a: a[0], (q, q, q), ("bshd",) * 3,
        "bshd", local="bh"))
    out["misordered_spec"] = _raises(
        lambda: SH.placements(mesh, SH.P(("model", "data"))))
    proj = DTensor.from_local(torch.zeros(2, 4, 12), mesh,
                              SH.placements(mesh, SH.P(None, None, "model")),
                              run_check=False)
    out["indivisible_query_heads"] = _raises(
        lambda: L.split_last(proj, 6, 8))
    out["seq_sharded_product"] = _raises(
        lambda: L.mm(q.reshape(2, 16, 32), torch.zeros(32, 4)))
    return out if rank == 0 else {"two_axis_chunk": out["two_axis_chunk"]}
