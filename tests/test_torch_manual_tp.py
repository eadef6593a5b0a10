"""Manual Megatron TP+SP (``launch/manual_tp.py``) and the auto (DTensor)
path against the JAX package on the CPU.

One spawn of 8 gloo ranks on a (2, 4) ("data", "model") mesh, with the
reference test's config (``tests/test_manual_tp.py``): the manual loss
and every gradient, and the auto path's (``sharding.param_specs``,
``make_shard_fn``), within 1e-4 of ``T.loss_fn`` and ``jax.grad`` on the
reference's weights, the reference's own bar; so are a REDUCED RWKV-6
config's (auto path), whose time mix scans on local (batch, head)
shards, those of the test config with 2 kv heads, which the 4-wide
"model" axis does not divide (Megatron's KV-head replication, which the
run records), a REDUCED Phi-3.5-MoE config's (its 4 experts over
"model", the combine a vocab-parallel lookup of the expert outputs), and
a REDUCED Llama-4-Scout config's with 10 query heads, which the 4-wide
axis does not divide (2.5 a rank, as 40 on a 16-wide axis): they are
padded to 12 in the activations (``layers.split_heads``), 3 a rank, and
the run records it.  One clipped AdamW step of that config keeps every
parameter's name and shape (the padding is never a parameter) and its
loss is the reference's.  The same spawn builds a (2, 2, 2) ("pod",
"data", "model") mesh and holds the MoE config's loss and gradients
there too: the dispatch's backward is a lookup of the slot buffer's
gradient on local shards.  On torch 2.11's DTensor (the card
machine's) the parent's form, an ``aten.index`` of that buffer sharded
on three axes, had no sharding rule; this host's torch (2.13) has one,
so the failure shows only on the card machine, where ``chip_smoke.py``
phase 3s(e) traces Phi-3.5-MoE training on the multipod mesh.
The same spawn shows a dim over ("data", "model") placed data-major
(chunk d * 4 + m on rank (d, m)), and these raising: a kernel given
seq-sharded inputs, a spec naming its axes out of mesh order, query
heads the "model" axis does not divide, and a product of a seq-sharded
input.

The ranks run at a lower priority (niceness + 10) than the test
process: eight busy processes must not starve the rest of a parallel
test run.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_support as support
from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import get_arch as ref_get_arch
from repro.launch import manual_tp as ref_MT
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.distributed import run_ranks
from repro_torch.launch import manual_tp as MT

CFG = dict(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=8,
           n_kv_heads=4, head_dim=8, d_ff=128, vocab=64, qk_norm=True,
           param_dtype="float32", act_dtype="float32", remat=True)
TOL = 1e-4


def _drop_lead(spec) -> tuple:
    return tuple(spec)[1:]


@pytest.fixture(scope="module")
def spawn():
    # jitted: one compile a config, not one an op
    init = jax.jit(ref_T.init, static_argnums=0)
    ref_cfg = RefArchConfig(**CFG)
    cfg = ArchConfig(**CFG)
    params = init(ref_cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_T.loss_fn(ref_cfg, p, batch, aux_weight=0.0)))(params)
    named = {k: np.asarray(v, np.float32) for k, v in
             convert.reference_named(cfg, jax.tree.map(np.asarray,
                                                       params)).items()}
    want = {k: np.asarray(v, np.float32) for k, v in
            convert.reference_named(cfg, jax.tree.map(np.asarray,
                                                      grads)).items()}
    inputs = {"cfg": CFG, "params": named,
              "batch": {k: np.asarray(v, np.int32) for k, v in
                        batch.items()}}
    # the RWKV config: its time mix scans on the local (batch, head)
    # shards
    rcfg = get_arch("rwkv6_1_6b", reduced=True)
    ref_rcfg = ref_get_arch("rwkv6_1_6b", reduced=True)
    rparams = init(ref_rcfg, jax.random.PRNGKey(2))
    rtoks = jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0,
                               rcfg.vocab)
    rbatch = {"tokens": rtoks, "labels": jnp.roll(rtoks, -1, 1)}
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_T.loss_fn(ref_rcfg, p, rbatch)))(rparams)
    inputs["rwkv"] = {
        "cfg": dataclasses.asdict(rcfg),
        "params": {k: np.asarray(v, np.float32) for k, v in
                   convert.reference_named(rcfg, jax.tree.map(
                       np.asarray, rparams)).items()},
        "batch": {k: np.asarray(v, np.int32) for k, v in rbatch.items()}}
    want_r = {k: np.asarray(v, np.float32) for k, v in
              convert.reference_named(rcfg, jax.tree.map(
                  np.asarray, rgrads)).items()}
    # 2 kv heads on the 4-wide "model" axis
    kcfg = dict(CFG, n_kv_heads=2)
    ref_kcfg = RefArchConfig(**kcfg)
    kparams = init(ref_kcfg, jax.random.PRNGKey(4))
    kloss, kgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_T.loss_fn(ref_kcfg, p, batch, aux_weight=0.0)))(kparams)
    inputs["kv_replicated"] = {
        "cfg": kcfg, "batch": inputs["batch"],
        "params": {k: np.asarray(v, np.float32) for k, v in
                   convert.reference_named(ArchConfig(**kcfg), jax.tree.map(
                       np.asarray, kparams)).items()}}
    want_k = {k: np.asarray(v, np.float32) for k, v in
              convert.reference_named(ArchConfig(**kcfg), jax.tree.map(
                  np.asarray, kgrads)).items()}
    # the MoE config: experts sharded over "model", the combine a
    # vocab-parallel lookup of the expert outputs
    mcfg = get_arch("phi3_5_moe", reduced=True)
    ref_mcfg = ref_get_arch("phi3_5_moe", reduced=True)
    mparams = init(ref_mcfg, jax.random.PRNGKey(5))
    mtoks = jax.random.randint(jax.random.PRNGKey(6), (4, 16), 0,
                               mcfg.vocab)
    mbatch = {"tokens": mtoks, "labels": jnp.roll(mtoks, -1, 1)}
    mloss, mgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_T.loss_fn(ref_mcfg, p, mbatch)))(mparams)
    inputs["moe"] = {
        "cfg": dataclasses.asdict(mcfg),
        "params": {k: np.asarray(v, np.float32) for k, v in
                   convert.reference_named(mcfg, jax.tree.map(
                       np.asarray, mparams)).items()},
        "batch": {k: np.asarray(v, np.int32) for k, v in mbatch.items()}}
    want_m = {k: np.asarray(v, np.float32) for k, v in
              convert.reference_named(mcfg, jax.tree.map(
                  np.asarray, mgrads)).items()}
    # 10 query heads on the 4-wide "model" axis (the fusion config, with
    # patches)
    ucfg = dataclasses.replace(get_arch("llama4_scout", reduced=True),
                               n_heads=10)
    ref_ucfg = dataclasses.replace(ref_get_arch("llama4_scout",
                                                reduced=True), n_heads=10)
    uparams = init(ref_ucfg, jax.random.PRNGKey(7))
    utoks = jax.random.randint(jax.random.PRNGKey(8), (4, 16), 0,
                               ucfg.vocab)
    pmask = np.zeros((4, 16), bool)
    pmask[:, 3:7] = True
    ubatch = {"tokens": utoks, "labels": jnp.roll(utoks, -1, 1),
              "patch_embeds": jnp.asarray(0.1 * np.random.default_rng(9)
                                          .standard_normal((4, 4, 256)),
                                          jnp.float32),
              "patch_mask": jnp.asarray(pmask)}
    uloss, ugrads = jax.jit(jax.value_and_grad(
        lambda p: ref_T.loss_fn(ref_ucfg, p, ubatch)))(uparams)
    inputs["uneven_heads"] = {
        "cfg": dataclasses.asdict(ucfg),
        "params": {k: np.asarray(v, np.float32) for k, v in
                   convert.reference_named(ucfg, jax.tree.map(
                       np.asarray, uparams)).items()},
        "batch": {k: np.asarray(v) for k, v in ubatch.items()}}
    want_u = {k: np.asarray(v, np.float32) for k, v in
              convert.reference_named(ucfg, jax.tree.map(
                  np.asarray, ugrads)).items()}
    # the ranks inherit this process's niceness at their start
    nice = os.getpriority(os.PRIO_PROCESS, 0)
    os.setpriority(os.PRIO_PROCESS, 0, nice + 10)
    try:
        outs = run_ranks(support.manual_and_auto, 8, device_type="cpu",
                         args=(inputs,), timeout=600)
    finally:
        try:
            os.setpriority(os.PRIO_PROCESS, 0, nice)
        except PermissionError:
            pass
    return {"manual": (float(loss), want), "auto": (float(loss), want),
            "rwkv": (float(rloss), want_r),
            "kv_replicated": (float(kloss), want_k),
            "moe": (float(mloss), want_m), "moe_3axis": (float(mloss), want_m),
            "uneven_heads": (float(uloss), want_u)}, outs


@pytest.mark.parametrize("path", ["manual", "auto", "rwkv",
                                  "kv_replicated", "moe", "moe_3axis",
                                  "uneven_heads"])
def test_loss_and_gradients_match_reference(spawn, path):
    wants, outs = spawn
    want_loss, want_grads = wants[path]
    got = outs[0]
    assert abs(got[f"{path}_loss"] - want_loss) < TOL
    grads = got[f"{path}_grads"]
    assert set(grads) == set(want_grads)
    worst = max(float(np.max(np.abs(grads[k] - want_grads[k])))
                for k in grads)
    assert worst < TOL, (path, worst)


@pytest.mark.parametrize("path", ["auto", "kv_replicated"])
def test_kv_head_replication_is_recorded(spawn, path):
    got = spawn[1][0][f"{path}_replicated"]
    want = [] if path == "auto" else [
        {"split": "kv_heads", "axis": "model", "size": 2, "axis_size": 4}]
    assert got == want


@pytest.mark.parametrize("path", ["auto", "uneven_heads"])
def test_query_head_padding_is_recorded(spawn, path):
    got = spawn[1][0][f"{path}_padded"]
    want = [] if path == "auto" else [
        {"split": "q_heads", "axis": "model", "size": 10,
         "padded_size": 12, "axis_size": 4}]
    assert got == want


def test_uneven_heads_step_keeps_parameter_names_and_shapes(spawn):
    """One clipped AdamW step of ``make_train_step`` with 10 query heads
    on the 4-wide axis: its loss is the reference's, and the state dict
    (the checkpoint's names and shapes) and AdamW's moments are those of
    the unpadded config."""
    wants, outs = spawn
    got = outs[0]["uneven_step"]
    assert abs(got["loss"] - wants["uneven_heads"][0]) < TOL
    assert got["shapes_after"] == got["shapes_before"]
    assert set(got["shapes_before"]) == set(wants["uneven_heads"][1])
    assert got["moment_shapes"] == got["shapes_before"]
    assert got["shapes_before"]["layers.0.attn.wq"] == (256, 10 * 32)


def test_train_step_keeps_placements(spawn):
    """One clipped AdamW step of ``make_train_step`` on the (2, 4) mesh:
    its loss is the reference's, the clip's global norm is replicated
    and AdamW's moments keep each parameter's placements."""
    wants, outs = spawn
    got = outs[0]["step"]
    assert abs(got["loss"] - wants["auto"][0]) < TOL
    assert got["norm_replicated"] and got["moments_placed"]
    assert got["sharded"] > 0


def test_cross_decode_on_a_seq_sharded_memory(spawn):
    """Cross-attention decode against a memory sharded over its sequence
    on both axes (the long-source decode at batch 1, more ranks than
    heads): DTensor's partial softmax gives the plain call's output."""
    assert spawn[1][0]["cross_decode_gap"] < 1e-6


def test_two_axis_dim_is_data_major(spawn):
    for local, chunk in (o["two_axis_chunk"] for o in spawn[1]):
        np.testing.assert_array_equal(local, 3 * chunk + np.arange(3))


@pytest.mark.parametrize("case", ["seq_sharded_kernel", "misordered_spec",
                                  "indivisible_query_heads",
                                  "seq_sharded_product"])
def test_unhonourable_placements_raise(spawn, case):
    assert spawn[1][0][case].startswith("ValueError")


def test_param_specs_manual_match_reference():
    cfg = ArchConfig(**CFG)
    ref = ref_MT.param_specs_manual(RefArchConfig(**CFG))
    got = MT.param_specs_manual(cfg)
    blk = ref["groups"]["0"]
    want = {"embed": tuple(ref["embed"]),
            "final_norm": tuple(ref["final_norm"]),
            "head": tuple(ref["head"])}
    for i in range(cfg.n_layers):
        for k in ("ln1", "ln2"):
            want[f"layers.{i}.{k}"] = _drop_lead(blk[k])
        for sub in ("attn", "ffn"):
            for k, s in blk[sub].items():
                want[f"layers.{i}.{sub}.{k}"] = _drop_lead(s)
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ["phi3_5_moe", "rwkv6_1_6b",
                                  "seamless_m4t_v2", "recurrentgemma_9b"])
def test_non_dense_configs_raise(arch):
    cfg = dataclasses.replace(get_arch(arch, reduced=True))
    with pytest.raises(ValueError, match="dense decoders only"):
        MT.manual_loss_fn(cfg, mesh=None)
