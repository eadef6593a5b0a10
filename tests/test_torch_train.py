"""LM training in the port against the JAX package on the CPU: gradients
through every REDUCED architecture of the zoo, AdamW steps, remat, the
kernels under grad mode, ``convert.lm_params_to_reference`` and the
``launch/train.py`` launcher.

Both packages run on the reference's random weights (carried over by
``convert.lm_params_from_reference``) and the same numpy batches (the
launcher's token stream; fusion patches and encoder frames drawn with
numpy).  Bars, fp32: the loss to 1e-5 relative (``tests/
test_torch_lm_zoo.py``'s); every gradient, mapped into the reference's
tree by ``lm_params_to_reference``, to ``jax.grad``'s at rtol 1e-4 /
atol 1e-5; five AdamW steps with the launcher's clip and schedule, each
loss within 1e-4 x max(1, |loss|) of the reference's.  For MoE configs
the routing is held equal first (``_torch_lm_support``), so that a
routing flip fails as a flip.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import (arch_pair, record_port_routes,
                               record_ref_routes)
from _torch_support import host
from repro import optim as ref_optim
from repro.models.registry import get_model as ref_get_model
from repro_torch import convert
from repro_torch.configs.base import PORTED_ARCH_IDS, get_arch
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.recurrent_scan import ops as rs_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.models.registry import get_model

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOSS_REL = 1e-5
STEP_TOL = 1e-4
B, S, STEPS, LR = 2, 32, 5, 3e-3


def _batches(cfg, encdec, n=1, seed=0):
    """``n`` numpy batches from the launcher's token stream, with a fusion
    config's patches (0.1 x a normal, on the first ``patch_frac`` of the
    positions) and an encoder-decoder config's frames."""
    it = launch_train.batch_stream(cfg, B, S)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = next(it)
        batch = {k: raw[k] % cfg.vocab for k in ("tokens", "labels")}
        if cfg.fuse_patches:
            p = max(1, int(S * cfg.patch_frac))
            batch["patch_embeds"] = (0.1 * rng.standard_normal(
                (B, p, cfg.d_model))).astype(np.float32)
            mask = np.zeros((B, S), bool)
            mask[:, :p] = True
            batch["patch_mask"] = mask
        if encdec:
            batch["frames"] = (0.1 * rng.standard_normal(
                (B, S, cfg.d_model))).astype(np.float32)
        out.append(batch)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch, **kw):
    """The reference's bundle and random weights (``PRNGKey(0)``), and
    the port's config, built once a module."""
    ref_cfg, cfg = arch_pair(arch, **kw)
    ref_m = ref_get_model(ref_cfg)
    return ref_m, ref_m.init(jax.random.PRNGKey(0)), get_model(cfg)


def _pair(arch, **kw):
    """``_torch_lm_support.build_pair`` without serving heads, the
    reference's weights built once: ``(ref_model, ref_params, None,
    model, port module, None)``, the port module fresh each call."""
    ref_m, ref_params, m = _reference(arch, **kw)
    convert_fn = convert.encdec_params_from_reference \
        if m.cfg.encoder_layers else convert.lm_params_from_reference
    return ref_m, ref_params, None, m, convert_fn(m.cfg, ref_params,
                                                   device="cpu"), None


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_reference(cfg, params):
    to_ref = convert.encdec_params_to_reference if cfg.encoder_layers \
        else convert.lm_params_to_reference
    return to_ref(cfg, params)


def _port_grads(m, model, batch):
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss = m.loss_fn(model, _torch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_loss_and_gradients_match_reference(arch, monkeypatch):
    ref_log = record_ref_routes(monkeypatch)
    ref_m, ref_params, _, m, model, _ = _pair(arch)
    batch = _batches(m.cfg, m.is_encdec)[0]
    want, want_grads = jax.value_and_grad(
        lambda p: ref_m.loss_fn(p, _jax(batch)))(ref_params)
    routes = record_port_routes(monkeypatch)
    loss, grads = _port_grads(m, model, batch)
    if m.cfg.n_experts:
        assert len(routes) == len(ref_log) > 0
        for layer, (r, (ref_idx, ref_keep)) in enumerate(zip(routes,
                                                             ref_log)):
            np.testing.assert_array_equal(host(r["idx"]), ref_idx,
                                          err_msg=f"picks flip, {layer}")
            np.testing.assert_array_equal(host(r["keep"]), ref_keep,
                                          err_msg=f"drops differ, {layer}")
    assert float(loss) == pytest.approx(float(want), rel=LOSS_REL)
    got = jax.tree_util.tree_flatten_with_path(_to_reference(m.cfg, grads))[0]
    ref = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (key, g), (_, w) in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(key))
    assert any(np.abs(g).max() > 0 for _, g in got)


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_adamw_steps_track_reference(arch):
    """Five steps of the launcher's update (clip to global norm 1.0,
    AdamW under the warm-up cosine schedule) in both packages."""
    ref_m, ref_params, _, m, model, _ = _pair(arch)
    batches = _batches(m.cfg, m.is_encdec, STEPS)
    ref_opt = ref_optim.adamw(ref_optim.warmup_cosine_schedule(
        LR, warmup=max(1, STEPS // 10), total_steps=STEPS))

    @jax.jit
    def ref_step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: ref_m.loss_fn(p, batch))(params)
        grads = ref_optim.clip_by_global_norm(grads, 1.0)
        updates, state = ref_opt.update(grads, state, params)
        return ref_optim.apply_updates(params, updates), state, loss

    ref_state = ref_opt.init(ref_params)
    model.requires_grad_(True)
    opt = launch_train.make_optimizer(LR, STEPS)
    state = opt.init(dict(model.named_parameters()))
    for i, batch in enumerate(batches):
        ref_params, ref_state, want = ref_step(ref_params, ref_state,
                                               _jax(batch))
        state, loss = launch_train.train_step(m, model, opt, state,
                                              _torch(batch))
        assert abs(float(loss) - float(want)) <= STEP_TOL * max(
            1.0, abs(float(want))), f"step {i}"
    assert int(state.step) == STEPS


def test_gradient_parity_covers_every_block_kind():
    kinds = set()
    for arch in PORTED_ARCH_IDS:
        cfg = _pair(arch)[3].cfg
        kinds |= set(transformer.layer_kinds(cfg)) if not \
            cfg.encoder_layers else {"encdec"}
        kinds |= {"moe"} if cfg.n_experts else set()
        kinds |= {"fusion"} if cfg.fuse_patches else set()
    assert kinds == {"attn", "rec", "rwkv", "moe", "fusion", "encdec"}


# ---------------------------------------------------------------- remat

REMAT_ARCHS = ["qwen3_1_7b", "recurrentgemma_9b", "phi3_5_moe",
               "rwkv6_1_6b", "seamless_m4t_v2"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_value(arch, monkeypatch):
    """``remat=True`` checkpoints the layers (counted) and gives the
    loss and gradients of ``remat=False`` bit for bit."""
    from repro_torch.models import encdec

    _, _, _, m, model, _ = _pair(arch)
    batch = _batches(m.cfg, m.is_encdec)[0]
    loss, grads = _port_grads(m, model, batch)
    cfg = dataclasses.replace(m.cfg, remat=True)
    calls = []
    mod = encdec if cfg.encoder_layers else transformer
    orig = mod.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(mod, "checkpoint", counted)
    _, _, _, m_r, model_r, _ = _pair(arch, remat=True)
    loss_r, grads_r = _port_grads(m_r, model_r, batch)
    want = cfg.encoder_layers + cfg.n_layers if cfg.encoder_layers \
        else cfg.n_groups * len(cfg.block_pattern)
    assert len(calls) == want > 0
    assert torch.equal(loss_r, loss)
    for name, g in grads.items():
        assert torch.equal(grads_r[name], g), name
    with torch.no_grad():
        calls.clear()
        m_r.loss_fn(model_r, _torch(batch))
    assert calls == []           # no gradient, no remat


# ------------------------------------------------------- grad-mode guard

def _fake_launch(monkeypatch):
    """Make CPU tensors take the kernels' CUDA branch, with a library
    whose entry points return 0 and record their calls."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    monkeypatch.setattr(dispatch, "on_cuda", lambda *t: True)
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for mod in (flash_ops, rs_ops):
        monkeypatch.setattr(mod.build, "library", lambda: Lib())
    return calls


def _kernel_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(requires_grad)

    return {
        "flash_attention": lambda: flash_ops.flash_attention(
            t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)),
        "wkv_chunked": lambda: rs_ops.wkv_chunked(
            t(1, 8, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32),
            -torch.rand(1, 8, 2, 32, generator=g).requires_grad_(
                requires_grad), t(2, 32), t(1, 2, 32, 32)),
        "linear_scan": lambda: rs_ops.linear_scan(
            -torch.rand(1, 8, 4, generator=g).requires_grad_(requires_grad),
            t(1, 8, 4), t(1, 4)),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv_chunked",
                                    "linear_scan"])
def test_kernel_refuses_inputs_that_require_grad(kernel, monkeypatch):
    calls = _fake_launch(monkeypatch)
    dispatch.reset_launches()
    with pytest.raises(RuntimeError, match=f"{kernel}: the CUDA kernel has "
                                           f"no backward"):
        _kernel_inputs(True)[kernel]()
    assert calls == [] and dispatch.LAUNCHES[kernel] == 0
    # no_grad, inference_mode, or inputs that need no gradient: launches
    for ctx, rg in ((torch.no_grad, True), (torch.inference_mode, True),
                    (contextlib.nullcontext, False)):
        with ctx():
            _kernel_inputs(rg)[kernel]()
    assert len(calls) == 3 and dispatch.LAUNCHES[kernel] == 3
    dispatch.reset_launches()


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv_chunked",
                                    "linear_scan"])
def test_plain_versions_stay_differentiable_on_cpu(kernel):
    dispatch.reset_launches()
    out = _kernel_inputs(True)[kernel]()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert dispatch.LAUNCHES[kernel] == 0


# ------------------------------------------------------------- convert

@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_to_reference_inverts_from_reference(arch, scan_layers):
    ref_m, ref_params, _, m, model, _ = _pair(
        arch, scan_layers=scan_layers)
    got = _to_reference(m.cfg, model)
    want = jax.tree.map(np.asarray, ref_params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    # and a dict named like the parameters (AdamW's m) maps the same way
    named = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    zeros = _to_reference(m.cfg, named)
    assert jax.tree.structure(zeros) == jax.tree.structure(want)


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_reference_named_inverts_reference_tree(arch, scan_layers):
    """``reference_named`` maps the reference's tree back to the parameter
    names, leaves as they are (a stacked tensor's layers as views)."""
    m, model = _pair(arch, scan_layers=scan_layers)[3:5]
    tree = convert.reference_tree(m.cfg, model)
    got = convert.reference_named(m.cfg, tree)
    want = dict(model.named_parameters())
    assert list(got) == list(want)
    for name, p in want.items():
        assert torch.equal(got[name], p.detach()), name


def test_bf16_params_come_out_as_exact_float32():
    ref_m, ref_params, _, m, model, _ = _pair(
        "qwen3_1_7b", param_dtype="bfloat16")
    got = convert.lm_params_to_reference(m.cfg, model)
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(got))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


# ------------------------------------------------------------ launcher

LAUNCH = ["--device", "cpu", "--batch", "2", "--seq", "16"]


def test_launcher_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    argv = LAUNCH + ["--arch", "qwen3_1_7b", "--steps", "6"]
    full = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                     "--ckpt-every", "3"])
    assert len(full) == 6 and all(np.isfinite(full))
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000003.json", "step_00000003.npz", "step_00000006.json",
        "step_00000006.npz"]
    # a run to step 6 from the step-3 checkpoint alone
    (tmp_path / "c").mkdir()
    for ext in ("json", "npz"):
        (tmp_path / "c" / f"step_00000003.{ext}").write_bytes(
            (tmp_path / "a" / f"step_00000003.{ext}").read_bytes())
    resumed = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "restored step 3" in out and "final checkpoint" in out
    assert resumed == full[3:]


def test_launcher_resumes_an_encdec_run(tmp_path):
    """The encoder-decoder tree through the launcher's checkpoint; the
    frames follow the step, so the resumed losses are the same bits."""
    argv = LAUNCH + ["--arch", "seamless_m4t_v2", "--steps", "4"]
    full = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                     "--ckpt-every", "2"])
    (tmp_path / "a" / "step_00000004.npz").unlink()
    (tmp_path / "a" / "step_00000004.json").unlink()
    assert launch_train.main(argv + ["--ckpt-dir",
                                     str(tmp_path / "a")]) == full[2:]


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "llama4_scout",
                                  "seamless_m4t_v2"])
def test_make_batch_follows_the_config(arch):
    """Patches for a fusion config and frames for an encoder-decoder one
    come from the config alone."""
    cfg = get_arch(arch, reduced=True)
    raw = next(launch_train.batch_stream(cfg, B, S))
    batch = launch_train.make_batch(cfg, raw, 3, torch.device("cpu"))
    assert ("patch_embeds" in batch) == bool(cfg.fuse_patches)
    assert ("frames" in batch) == bool(cfg.encoder_layers)
    if cfg.encoder_layers:
        again = launch_train.make_batch(cfg, raw, 3, torch.device("cpu"))
        assert batch["frames"].shape == (B, S, cfg.d_model)
        assert torch.equal(batch["frames"], again["frames"])


@pytest.mark.parametrize("arch", ["llama4_scout", "seamless_m4t_v2"])
def test_launcher_trains_fusion_and_encdec_batches(arch, capsys):
    """The launcher's batches for a fusion config (zero patches on the
    first ``patch_frac`` of the positions) and an encoder-decoder one
    (frames from a generator seeded by the step)."""
    losses = launch_train.main(LAUNCH + ["--arch", arch, "--steps", "3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert capsys.readouterr().out.count("loss") == 3


def test_launcher_checkpoint_is_the_reference_layout(tmp_path):
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.models.registry import get_model as ref_get_model
    from repro.configs.base import get_arch as ref_get_arch

    launch_train.main(LAUNCH + ["--arch", "qwen3_1_7b", "--steps", "2",
                                "--ckpt-dir", str(tmp_path)])
    ref_m = ref_get_model(ref_get_arch("qwen3_1_7b", reduced=True))
    ref_params = ref_m.init(jax.random.PRNGKey(0))
    opt = ref_optim.adamw(1e-3)
    (params, state), step = ref_restore(tmp_path,
                                        (ref_params, opt.init(ref_params)))
    assert step == 2 and int(state.step) == 2
    assert all(np.isfinite(np.asarray(a)).all()
               for a in jax.tree.leaves((params, state)))


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
