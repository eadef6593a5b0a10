"""The port's encoder-decoder model (``models/encdec.py``, the
seamless_m4t_v2 backbone) and its cross-attention against the JAX
package on the CPU.

Both packages run on the reference's random weights (carried over by
``convert.encdec_params_from_reference``) and the same numpy frames and
tokens at the REDUCED size, under each attention impl: ``encode``,
``forward``, ``loss_fn``, ``decode_state_from_memory`` and
``decode_step``.  fp32 values are held to 1e-4 x their largest entry
(``FP32_TOL``); bf16 logits at most twice as far from the reference's
fp32 logits as the reference's bf16 logits are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import arch_pair, build_pair, rel_err
from _torch_support import host
from repro.models import attention as ref_A
from repro.models import encdec as ref_E
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as A
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Params

FP32_TOL = 1e-4
ARCH = "seamless_m4t_v2"
IMPLS = ["jnp", "chunked", "pallas"]


def _inputs(cfg, b=2, s_src=24, s=16, seed=0):
    rng = np.random.default_rng(seed)
    frames = (0.1 * rng.standard_normal((b, s_src, cfg.d_model))
              ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return frames, toks


def _batch(frames, toks, as_jax):
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if as_jax:
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_and_forward_match_reference(impl):
    ref_m, ref_params, _, m, params, _ = build_pair(ARCH, attn_impl=impl)
    assert m.is_encdec and ref_m.is_encdec
    assert m.decode_hidden is None and m.prefill_chunk is None
    cfg = m.cfg
    frames, toks = _inputs(cfg)
    want_mem = np.asarray(ref_E.encode(ref_m.cfg, ref_params,
                                       jnp.asarray(frames)))
    got_mem = E.encode(cfg, params, torch.from_numpy(frames))
    assert got_mem.shape == want_mem.shape
    assert rel_err(host(got_mem), want_mem) <= FP32_TOL
    want, want_aux = ref_m.forward(ref_params, _batch(frames, toks, True))
    got, aux = m.forward(params, _batch(frames, toks, False))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(host(got), np.asarray(want)) <= FP32_TOL
    assert float(aux) == float(want_aux) == 0.0
    last, _ = m.forward(params, _batch(frames, toks, False), last_only=True)
    want_last = np.asarray(ref_E.forward(ref_m.cfg, ref_params,
                                         _batch(frames, toks, True),
                                         last_only=True)[0])
    assert last.shape == (2, 1, cfg.vocab)
    assert rel_err(host(last), want_last) <= FP32_TOL


def test_loss_matches_reference():
    ref_m, ref_params, _, m, params, _ = build_pair(ARCH)
    frames, toks = _inputs(m.cfg, seed=5)
    want = float(ref_m.loss_fn(ref_params, _batch(frames, toks, True)))
    got = float(m.loss_fn(params, _batch(frames, toks, False)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_decode_from_memory_matches_reference(impl):
    """``decode_state_from_memory`` (its cross K/V of every layer, its
    self cache at the default 1024 slots whatever ``self_len`` says) and
    12 ``decode_step``s: logits each step, the whole state after."""
    ref_m, ref_params, _, m, params, _ = build_pair(ARCH, attn_impl=impl)
    cfg = m.cfg
    frames, toks = _inputs(cfg, seed=1)
    ref_mem = ref_E.encode(ref_m.cfg, ref_params, jnp.asarray(frames))
    ref_st = ref_E.decode_state_from_memory(ref_m.cfg, ref_params, ref_mem,
                                            self_len=16)
    mem = E.encode(cfg, params, torch.from_numpy(frames))
    st = E.decode_state_from_memory(cfg, params, mem, self_len=16)
    assert tuple(st["self"]["k"].shape) == ref_st["self"]["k"].shape \
        == (cfg.n_layers, 2, 1024, cfg.n_kv_heads, cfg.head_dim)
    for key in ("mem_k", "mem_v"):
        assert tuple(st[key].shape) == ref_st[key].shape
        assert rel_err(host(st[key]), np.asarray(ref_st[key])) <= FP32_TOL
    step = jax.jit(ref_m.decode_step)
    worst = 0.0
    for t in range(12):
        want, ref_st = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                            ref_st)
        got, st = m.decode_step(params, torch.from_numpy(toks[:, t:t + 1]),
                                st)
        worst = max(worst, rel_err(host(got), np.asarray(want)))
    assert worst <= FP32_TOL
    assert st["length"] == int(ref_st["length"]) == 12
    for key in ("k", "v"):
        assert rel_err(host(st["self"][key]),
                       np.asarray(ref_st["self"][key])) <= FP32_TOL


def test_decode_matches_teacher_forced_forward():
    """The port's own decode against its forward on the same tokens, at
    the reference's bar for that check (``tests/test_arch_smoke.py``:
    atol 5e-3, rtol 1e-3)."""
    _, _, _, m, params, _ = build_pair(ARCH)
    frames, toks = _inputs(m.cfg, seed=7)
    toks = toks[:, :16]
    full, _ = m.forward(params, {"frames": torch.from_numpy(frames),
                                 "tokens": torch.from_numpy(toks)})
    st = E.decode_state_from_memory(
        m.cfg, params, E.encode(m.cfg, params, torch.from_numpy(frames)))
    outs = []
    for t in range(16):
        lg, st = m.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), st)
        outs.append(lg)
    np.testing.assert_allclose(host(torch.cat(outs, dim=1)), host(full),
                               atol=5e-3, rtol=1e-3)


def test_bundle_decode_state_matches_reference():
    """The bundle's ``init_decode_state(batch, max_len)`` takes
    ``max_len`` as the source length, as the reference's does: the same
    keys, shapes and dtypes, zero memory and length 0."""
    ref_m, _, _, m, _, _ = build_pair(ARCH)
    ref_st = ref_m.init_decode_state(2, 40)
    st = m.init_decode_state(2, 40, device="cpu")
    assert set(st) == set(ref_st)
    pairs = [(st[key], ref_st[key]) for key in ("mem_k", "mem_v")] + \
        [(st["self"][key], ref_st["self"][key]) for key in ("k", "v")]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == "torch." + want.dtype.name
        assert not bool(got.any())
    assert st["length"] == int(ref_st["length"]) == 0


def test_cross_attention_functions_match_reference():
    """``attention(kv_x=)`` with ``kv_dim`` other than d_model and qk
    norm, ``memory_kv`` and ``cross_decode``, on the reference's
    weights."""
    acfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                qk_norm=True, causal=False)
    ref_cfg, cfg = ref_A.AttnConfig(**acfg), A.AttnConfig(**acfg)
    ref_p = ref_A.attn_init(jax.random.PRNGKey(2), ref_cfg, kv_dim=24)
    ref_p["q_norm"] = 1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(3),
                                                    (8,))
    ref_p["k_norm"] = 1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                                    (8,))
    p = Params({k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()})
    gen = torch.Generator().manual_seed(0)
    own = A.attn_init(gen, cfg, kv_dim=24)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in ref_p.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 11, 24)).astype(np.float32)
    for impl in IMPLS:
        r_cfg = dataclasses.replace(ref_cfg, impl=impl)
        p_cfg = dataclasses.replace(cfg, impl=impl)
        want = ref_A.attention(ref_p, r_cfg, jnp.asarray(x),
                               kv_x=jnp.asarray(mem))
        got = A.attention(p, p_cfg, torch.from_numpy(x),
                          kv_x=torch.from_numpy(mem))
        assert rel_err(host(got), np.asarray(want)) <= FP32_TOL, impl
    want_k, want_v = ref_A.memory_kv(ref_p, ref_cfg, jnp.asarray(mem))
    got_k, got_v = A.memory_kv(p, cfg, torch.from_numpy(mem))
    assert rel_err(host(got_k), np.asarray(want_k)) <= FP32_TOL
    assert rel_err(host(got_v), np.asarray(want_v)) <= FP32_TOL
    want = ref_A.cross_decode(ref_p, ref_cfg, jnp.asarray(x[:, :1]), want_k,
                              want_v)
    got = A.cross_decode(p, cfg, torch.from_numpy(x[:, :1]), got_k, got_v)
    assert rel_err(host(got), np.asarray(want)) <= FP32_TOL


def test_bf16_dtype_flow_matches_reference():
    """bf16 weights and activations: logits within twice the reference's
    own bf16 distance of the fp32 logits, the same dtypes of logits and
    of every decode-state leaf."""
    bf = {"param_dtype": "bfloat16", "act_dtype": "bfloat16"}
    ref32, ref_p32, _, _, _, _ = build_pair(ARCH)
    ref_m, ref_params, _, m, params, _ = build_pair(ARCH, **bf)
    frames, toks = _inputs(m.cfg, seed=4)
    want32 = np.asarray(ref32.forward(ref_p32, _batch(frames, toks, True)
                                      )[0], np.float32)
    want = ref_m.forward(ref_params, _batch(frames, toks, True))[0]
    got, _ = m.forward(params, _batch(frames, toks, False))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ref_gap = rel_err(np.asarray(want, np.float32), want32)
    assert 0.0 < rel_err(got.float().numpy(), want32) <= 2 * ref_gap
    ref_st = ref_E.decode_state_from_memory(
        ref_m.cfg, ref_params, ref_E.encode(ref_m.cfg, ref_params,
                                            jnp.asarray(frames)))
    st = E.decode_state_from_memory(
        m.cfg, params, E.encode(m.cfg, params, torch.from_numpy(frames)))
    for key in ("mem_k", "mem_v"):
        assert str(st[key].dtype) == "torch." + ref_st[key].dtype.name
    for key in ("k", "v"):
        assert str(st["self"][key].dtype) == \
            "torch." + ref_st["self"][key].dtype.name


def test_init_and_conversion_layouts():
    """The port's own init has the converted reference tree's names,
    shapes and dtypes; a mismatched layer count raises, and so does the
    decoder-only stack given an encoder-decoder config."""
    _, cfg = arch_pair(ARCH)
    model = E.init(cfg, 0, device="cpu")
    converted = build_pair(ARCH)[4]
    got = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {n: (tuple(p.shape), p.dtype)
            for n, p in converted.named_parameters()}
    assert got == want
    assert "dec.0.self.wq" in got and "dec.1.cross.wk" in got
    top = {k: getattr(model, k) for k in ("frame_proj", "embed", "enc_norm",
                                          "final_norm", "head")}
    with pytest.raises(ValueError, match="layer trees"):
        E.from_trees(cfg, top, [], [])
    with pytest.raises(ValueError, match="encdec"):
        T.init(cfg, 0, device="cpu")


def test_serve_launcher_rejects_encdec_like_reference():
    with pytest.raises(SystemExit,
                       match="decoder-only serving; use examples for "
                             "enc-dec"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH])
