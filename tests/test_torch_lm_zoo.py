"""The rest of the port's LM zoo against the JAX package on the CPU: MoE
blocks (``models/moe.py``), early-fusion VLM inputs and the six
decoder-only configs that came with them (the encoder-decoder model is
``test_torch_encdec.py``'s).

Both packages run on the reference's random weights (carried over by
``convert.lm_params_from_reference``) and the same numpy inputs, at the
REDUCED sizes.  Routing is held before values: the port's top-k expert
ids and kept picks must equal the reference's (recorded inside its layer
scan by ``_torch_lm_support.record_ref_routes``, from its own
expressions), so a routing flip fails as a flip.  Values: fp32 logits
and states to 1e-4 x their largest entry (``FP32_TOL``), the aux loss to
1e-6; bf16 logits at most twice as far from the reference's fp32 logits
as the reference's bf16 logits are (the bar of
``test_torch_lm.py::test_bf16_dtype_flow_matches_reference``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import (build_pair, record_port_routes,
                               record_ref_routes, ref_layer_states,
                               ref_routing, rel_err)
from _torch_support import host
from repro.models import moe as ref_moe
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models.transformer import Params

FP32_TOL = 1e-4
AUX_TOL = 1e-6

DECODER_ARCHS = ["phi3_5_moe", "llama4_scout", "chameleon_34b",
                 "deepseek_67b", "granite_8b", "codeqwen1_5_7b"]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _patches(cfg, b, p, seed=2):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (b, p, cfg.d_model))).astype(np.float32)


def _batch(cfg, toks, mask=None, n_patches=None):
    """Tokens, and for a fusion config patches under ``mask`` (default:
    the reference smoke test's prefix of ``patch_frac`` of the positions)."""
    batch = {"tokens": toks}
    if cfg.fuse_patches:
        b, s = toks.shape
        p = max(1, int(s * cfg.patch_frac)) if n_patches is None \
            else n_patches
        if mask is None:
            mask = np.zeros((b, s), bool)
            mask[:, :p] = True
        batch["patch_embeds"] = _patches(cfg, b, p)
        batch["patch_mask"] = mask
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_same_routes(routes, ref_log):
    """The port's routing (``record_port_routes``) equals the reference's,
    layer by layer: expert ids first, then the kept picks."""
    assert len(routes) == len(ref_log) > 0
    for layer, (r, (ref_idx, ref_keep)) in enumerate(zip(routes, ref_log)):
        np.testing.assert_array_equal(host(r["idx"]), ref_idx,
                                      err_msg=f"picks flip at layer {layer}")
        np.testing.assert_array_equal(host(r["keep"]), ref_keep,
                                      err_msg=f"drops differ at layer {layer}")


# ---------------------------------------------------------------------------
# moe_apply alone
# ---------------------------------------------------------------------------

# (name, MoEConfig overrides, (B, S)): d 32, d_ff 48, 4 experts.
MOE_CASES = [
    ("top1", {"top_k": 1}, (2, 16)),
    ("top2", {"top_k": 2}, (2, 16)),
    ("drops", {"top_k": 2, "capacity_factor": 0.5}, (2, 16)),
    ("gelu-drops", {"top_k": 2, "capacity_factor": 0.5,
                    "mlp_variant": "gelu"}, (2, 16)),
    ("t-not-chunk-multiple", {"top_k": 2, "dispatch_chunk": 12}, (2, 16)),
    ("chunks-below-t", {"top_k": 2, "dispatch_chunk": 8,
                        "capacity_factor": 0.75}, (2, 16)),
    ("one-token", {"top_k": 2}, (1, 1)),
    ("tied-router", {"top_k": 2, "capacity_factor": 1.0}, (2, 8)),
]


@pytest.mark.parametrize("name,kw,shape", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_reference(name, kw, shape, monkeypatch):
    """Picks, the drop set, ``out`` and ``aux`` of one MoE layer on the
    same input and weights."""
    base = dict(d_model=32, d_ff=48, n_experts=4)
    ref_cfg = ref_moe.MoEConfig(**base, **kw)
    cfg = moe.MoEConfig(**base, **kw)
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(3), ref_cfg)
    if name == "tied-router":
        ref_p["router"] = jnp.zeros_like(ref_p["router"])
    x = np.random.default_rng(4).standard_normal(
        shape + (32,)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(ref_p, ref_cfg, jnp.asarray(x))
    ref_idx, ref_keep = (np.asarray(a) for a in ref_routing(
        ref_p, ref_cfg, jnp.asarray(x)))
    p = Params({k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()})
    routes = record_port_routes(monkeypatch)
    got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    assert len(routes) == 1
    np.testing.assert_array_equal(host(routes[0]["idx"]), ref_idx)
    np.testing.assert_array_equal(host(routes[0]["keep"]), ref_keep)
    if "drops" in name or name == "chunks-below-t":
        assert not ref_keep.all(), "the case drops no pick"
    if name == "tied-router":
        np.testing.assert_array_equal(ref_idx, np.tile([0, 1], (16, 1)))
        assert not ref_keep.all()
    if name == "one-token":
        assert moe.capacity_of(cfg, 1) == (1, 1)
        np.testing.assert_array_equal(ref_keep, [[True, True]])
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_err(host(got), np.asarray(want)) <= FP32_TOL
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def parent_dispatch(xt, slot, keep, n_slots):
    """The dispatch as it was written before its backward became a
    gather: an ``index_put`` into a buffer with a spare row for the
    dropped picks, differentiated by autograd (an ``aten.index`` of the
    buffer's gradient, then the expand's sum over picks).  The oracle of
    ``test_dispatch_is_bit_equal_to_index_put``."""
    t, d = xt.shape
    k = slot.shape[1]
    dest = torch.where(keep, slot, n_slots).reshape(t * k)
    src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    return xt.new_zeros((n_slots + 1, d)).index_put((dest,), src)[:n_slots]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw,shape", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_dispatch_is_bit_equal_to_index_put(name, kw, shape, dtype,
                                            monkeypatch):
    """``moe.dispatch`` (the write, its backward a gather of the slot
    rows) against ``parent_dispatch`` on plain tensors, on every case of
    ``MOE_CASES``: ``moe_apply``'s output and aux, and the gradients of
    the input and of every parameter, are the same bits.  (The gather
    exists for torch 2.11's DTensor, which has no sharding rule for the
    parent's backward on three mesh axes: that shows only on the card
    machine, ``chip_smoke.py`` phase 3s(e); ``tests/test_torch_manual_tp.
    py`` holds the gradients on a (2, 2, 2) mesh here.)"""
    dt = getattr(torch, dtype)
    cfg = moe.MoEConfig(d_model=32, d_ff=48, n_experts=4, **kw)
    tree = moe.moe_init(torch.Generator().manual_seed(3), cfg)
    if name == "tied-router":
        tree["router"].zero_()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        shape + (32,)).astype(np.float32)).to(dt)
    results = []
    for fn in (parent_dispatch, moe.dispatch):
        monkeypatch.setattr(moe, "dispatch", fn)
        p = Params({k: v.to(dt) for k, v in tree.items()})
        p.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        out, aux = moe.moe_apply(p, cfg, xx)
        weights = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
        grads = torch.autograd.grad((out.float() * weights).sum() + aux,
                                    [xx] + list(p.parameters()))
        results.append((out, aux) + grads)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_moe_second_pick_drops_while_first_is_kept(monkeypatch):
    """Drop order: token-major, pick-minor within a chunk.  Three tokens
    route to (0, 1), (2, 0), (3, 0) at capacity 2: the third token's
    second pick, third in line for expert 0, drops alone."""
    cfg = moe.MoEConfig(d_model=8, d_ff=8, n_experts=4, top_k=2,
                        capacity_factor=1.5)
    assert moe.capacity_of(cfg, 3) == (3, 2)
    w = torch.zeros((8, 4))
    w[0, 0], w[0, 1] = 2.0, 1.0        # feature 0 -> experts 0, then 1
    w[1, 2], w[1, 0] = 2.0, 1.0        # feature 1 -> experts 2, then 0
    w[2, 3], w[2, 0] = 2.0, 1.0        # feature 2 -> experts 3, then 0
    p = Params({"router": w, "w_up": torch.ones((4, 8, 8)),
                "w_gate": torch.ones((4, 8, 8)),
                "w_down": torch.ones((4, 8, 8))})
    x = torch.zeros((1, 3, 8))
    x[0, 0, 0] = x[0, 1, 1] = x[0, 2, 2] = 1.0
    routes = record_port_routes(monkeypatch)
    moe.moe_apply(p, cfg, x)
    np.testing.assert_array_equal(host(routes[0]["idx"]),
                                  [[0, 1], [2, 0], [3, 0]])
    np.testing.assert_array_equal(host(routes[0]["keep"]),
                                  [[True, True], [True, True],
                                   [True, False]])


# ---------------------------------------------------------------------------
# The decoder-only configs
# ---------------------------------------------------------------------------

FORWARD_CASES = [(a, {}) for a in DECODER_ARCHS] + [
    ("granite_8b", {"attn_impl": "pallas"}),
    ("granite_8b", {"attn_impl": "chunked"}),
    ("chameleon_34b", {"attn_impl": "pallas"}),
    ("phi3_5_moe", {"attn_impl": "pallas"}),
    ("llama4_scout", {"attn_impl": "pallas"}),
]


class TestDecoderConfigs:
    @pytest.mark.parametrize("arch,kw", FORWARD_CASES, ids=[
        f"{a}-{k.get('attn_impl', 'jnp')}" for a, k in FORWARD_CASES])
    def test_forward_matches_reference(self, arch, kw, monkeypatch):
        """Logits and aux; for MoE configs the routing first."""
        ref_log = record_ref_routes(monkeypatch)
        ref_m, ref_params, _, m, params, _ = build_pair(arch, **kw)
        batch = _batch(m.cfg, _tokens(m.cfg, 2, 32))
        want, want_aux = ref_m.forward(ref_params, _jax(batch))
        routes = record_port_routes(monkeypatch)
        got, aux = m.forward(params, _torch(batch))
        if m.cfg.n_experts:
            _assert_same_routes(routes, ref_log)
        else:
            assert routes == [] and ref_log == []
        assert got.shape == want.shape and got.dtype == torch.float32
        assert rel_err(host(got), np.asarray(want)) <= FP32_TOL
        assert abs(float(aux) - float(want_aux)) <= AUX_TOL
        assert (float(aux) > 0) == bool(m.cfg.n_experts)
        last, _ = m.forward(params, _torch(batch), last_only=True)
        torch.testing.assert_close(last, got[:, -1:], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("arch", DECODER_ARCHS)
    def test_loss_matches_reference(self, arch):
        ref_m, ref_params, _, m, params, _ = build_pair(arch)
        toks = _tokens(m.cfg, 2, 33, seed=5)
        mask = (np.arange(32)[None, :] < np.array([[32], [20]])
                ).astype(np.float32)
        for use_mask in (False, True):
            batch = _batch(m.cfg, toks[:, :-1])
            batch["labels"] = toks[:, 1:]
            if use_mask:
                batch["loss_mask"] = mask
            want = float(ref_m.loss_fn(ref_params, _jax(batch)))
            got = float(m.loss_fn(params, _torch(batch)))
            assert got == pytest.approx(want, rel=1e-5)

    @pytest.mark.parametrize("arch", DECODER_ARCHS)
    def test_decode_step_matches_reference(self, arch):
        """Scalar-length decode, step by step (an MoE step routes its B
        tokens as one chunk, capacity max(1, int(1.25 k B / E)), so
        picks drop as in the reference): logits each step and the caches
        after."""
        ref_m, ref_params, _, m, params, _ = build_pair(arch)
        steps = 12
        toks = _tokens(m.cfg, 2, steps, seed=1)
        ref_st = ref_m.init_decode_state(2, steps + 2)
        st = m.init_decode_state(2, steps + 2, device="cpu")
        step = jax.jit(ref_m.decode_step)
        worst = 0.0
        for t in range(steps):
            want, ref_st = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                                ref_st)
            got, st = m.decode_step(params, torch.from_numpy(
                toks[:, t:t + 1]), st)
            worst = max(worst, rel_err(host(got), np.asarray(want)))
        assert worst <= FP32_TOL
        assert st["length"] == int(ref_st["length"]) == steps
        for layer, ref_layer in zip(st["layers"],
                                    ref_layer_states(ref_m.cfg, ref_st)):
            for key in ("k", "v"):
                assert rel_err(host(layer[key]), ref_layer[key]) <= FP32_TOL

    @pytest.mark.parametrize("arch", DECODER_ARCHS)
    def test_prefill_chunk_ragged_matches_reference(self, arch):
        """Per-slot prefill of two chunks with ragged ``valid`` (a full
        row, a short row, an empty row); an MoE chunk routes all B x C
        positions, pads included, as the reference does."""
        ref_m, ref_params, _, m, params, _ = build_pair(arch)
        c = 16
        toks = _tokens(m.cfg, 3, 2 * c, seed=2)
        lengths = np.array([2 * c, c + 5, 0])
        ref_st = ref_m.init_decode_state(3, 3 * c, per_slot=True)
        st = m.init_decode_state(3, 3 * c, per_slot=True, device="cpu")
        for start in (0, c):
            valid = (start + np.arange(c))[None, :] < lengths[:, None]
            want, ref_st = ref_m.prefill_chunk(
                ref_params, jnp.asarray(toks[:, start:start + c]), ref_st,
                start, jnp.asarray(valid))
            got, st = m.prefill_chunk(
                params, torch.from_numpy(toks[:, start:start + c]), st,
                start, torch.from_numpy(valid))
            assert rel_err(host(got)[valid], np.asarray(want)[valid]) \
                <= FP32_TOL
            np.testing.assert_array_equal(host(st["length"]),
                                          np.asarray(ref_st["length"]))
            for layer, ref_layer in zip(st["layers"], ref_layer_states(
                    ref_m.cfg, ref_st)):
                for key in ("k", "v"):
                    assert rel_err(host(layer[key]), ref_layer[key]) \
                        <= FP32_TOL


# ---------------------------------------------------------------------------
# Early fusion
# ---------------------------------------------------------------------------

def _scattered_mask(s):
    mask = np.zeros((2, s), bool)
    mask[0, [1, 2, 5, 9, 10, 17, 30, 31]] = True
    mask[1, [0, 4, 8, 12, 16, 20, 24, 28]] = True
    return mask


def _clipped_mask(s):
    # row 0: 14 masked positions for 8 patches (the last 6 take patch 7);
    # row 1: none
    mask = np.zeros((2, s), bool)
    mask[0, 3:17] = True
    return mask


@pytest.mark.parametrize("kind", ["prefix", "scattered", "clipped"])
def test_fusion_matches_reference(kind, monkeypatch):
    """``patch_embeds`` scattered over the token stream under a prefix
    mask, a scattered mask, and a row with more masked positions than
    patches (the index clips to the last patch): the embedded stream,
    then routing and logits of the whole forward."""
    from repro.models import transformer as ref_T
    from repro_torch.models import transformer as T

    ref_log = record_ref_routes(monkeypatch)
    ref_m, ref_params, _, m, params, _ = build_pair("llama4_scout")
    mask = {"prefix": None, "scattered": _scattered_mask(32),
            "clipped": _clipped_mask(32)}[kind]
    batch = _batch(m.cfg, _tokens(m.cfg, 2, 32, seed=6), mask, n_patches=8)
    want_h = np.asarray(ref_T._embed(ref_m.cfg, ref_params, _jax(batch),
                                     lambda x, n: x))
    tb = _torch(batch)
    got_h = T.embed(m.cfg, params, tb["tokens"], tb["patch_embeds"],
                    tb["patch_mask"])
    assert rel_err(host(got_h), want_h) <= FP32_TOL
    plain = np.asarray(ref_params["embed"])[batch["tokens"]]
    fused = batch["patch_mask"]
    assert not np.allclose(want_h[fused], plain[fused])
    np.testing.assert_array_equal(want_h[~fused], plain[~fused])
    if kind == "clipped":
        np.testing.assert_allclose(host(got_h)[0, 11:17],
                                   np.repeat(host(got_h)[0, 10:11], 6, 0))
    want, want_aux = ref_m.forward(ref_params, _jax(batch))
    routes = record_port_routes(monkeypatch)
    got, aux = m.forward(params, tb)
    _assert_same_routes(routes, ref_log)
    assert rel_err(host(got), np.asarray(want)) <= FP32_TOL
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_fusion_without_patches_embeds_tokens_only():
    """A fusion config given no ``patch_embeds`` embeds the tokens, as
    the reference does."""
    ref_m, ref_params, _, m, params, _ = build_pair("llama4_scout")
    toks = _tokens(m.cfg, 2, 16, seed=7)
    want, _ = ref_m.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, _ = m.forward(params, {"tokens": torch.from_numpy(toks)})
    assert rel_err(host(got), np.asarray(want)) <= FP32_TOL


def test_moe_bf16_dtype_flow_matches_reference():
    """phi3_5_moe in bf16 weights and activations: logits within twice
    the reference's own bf16 distance of the fp32 logits, the same
    logits dtype and the same dtypes of every cache leaf."""
    bf = {"param_dtype": "bfloat16", "act_dtype": "bfloat16"}
    ref32, ref_p32, _, _, _, _ = build_pair("phi3_5_moe")
    ref_m, ref_params, _, m, params, _ = build_pair("phi3_5_moe", **bf)
    toks = _tokens(m.cfg, 2, 32, seed=4)
    want32 = np.asarray(ref32.forward(ref_p32, {"tokens": jnp.asarray(toks)}
                                      )[0], np.float32)
    want, want_aux = ref_m.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, aux = m.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert aux.dtype == torch.float32 and want_aux.dtype == jnp.float32
    ref_gap = rel_err(np.asarray(want, np.float32), want32)
    assert 0.0 < rel_err(got.float().numpy(), want32) <= 2 * ref_gap
    ref_st = ref_layer_states(ref_m.cfg, ref_m.init_decode_state(2, 8))
    st = m.init_decode_state(2, 8, device="cpu")["layers"]
    for layer, ref_layer in zip(st, ref_st):
        assert {k: str(v.dtype).replace("torch.", "")
                for k, v in layer.items()} == \
            {k: v.dtype.name for k, v in ref_layer.items()}


def test_serve_launcher_runs_moe_on_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", "phi3_5_moe",
                       "--requests", "4", "--prompt-len", "16",
                       "--prefill-chunk", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "continuous:" in out and "on cpu" in out
