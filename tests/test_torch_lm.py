"""The port's LM model zoo against the JAX package on the CPU.

Both packages run on the reference's random weights (carried over by
``convert.lm_params_from_reference``) and the same numpy tokens, for the
dense, SSM and hybrid REDUCED configs (the rest of the zoo is
``test_torch_lm_zoo.py``'s and ``test_torch_encdec.py``'s) and the
reference serving tests' tiny architectures (unrolled layer groups),
under every attention and recurrence impl.  Tolerances: in fp32 the two frameworks sum in other
orders, so logits agree to 1e-4 x max|logit| (measured about 1.3e-6)
and states to 1e-4 x their largest entry.  In bf16 the frameworks round
at other places (XLA fuses elementwise chains and rounds once), so the
port is held to the reference's own bar: its bf16 logits may be at most
twice as far from the reference's fp32 logits as the reference's bf16
logits are (measured ratios 0.94-1.04), with the same dtypes of logits
and state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import (arch_pair, build_pair, ref_layer_states,
                               rel_err)
from _torch_support import host
from repro.configs import base as ref_base
from repro.data import tokens as ref_tokens
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs import base
from repro_torch.data import tokens
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model

FP32_TOL = 1e-4

# (arch, impl overrides): every attention and recurrence impl of each
# REDUCED config and tiny kind.
FORWARD_CASES = [
    ("qwen3_1_7b", {"attn_impl": "jnp"}),
    ("qwen3_1_7b", {"attn_impl": "chunked"}),
    ("qwen3_1_7b", {"attn_impl": "pallas"}),
    ("rwkv6_1_6b", {"rec_impl": ""}),
    ("rwkv6_1_6b", {"rec_impl": "scan"}),
    ("rwkv6_1_6b", {"rec_impl": "chunked"}),
    ("rwkv6_1_6b", {"rec_impl": "pallas"}),
    ("recurrentgemma_9b", {"rec_impl": "scan", "attn_impl": "jnp"}),
    ("recurrentgemma_9b", {"rec_impl": "scan", "attn_impl": "chunked"}),
    ("recurrentgemma_9b", {"rec_impl": "pallas", "attn_impl": "pallas"}),
    ("tiny-attn", {"attn_impl": "pallas"}),
    ("tiny-rwkv", {"rec_impl": "pallas"}),
    ("tiny-rec", {"rec_impl": "pallas"}),
]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _seq_len(arch):
    # rwkv's chunked form needs a chunk multiple (16); the hybrid's local
    # window (64) binds at 80 positions
    return 80 if arch == "recurrentgemma_9b" else 32


def _close_states(layers, ref_layers, tol=FP32_TOL):
    assert len(layers) == len(ref_layers)
    for i, (st, ref_st) in enumerate(zip(layers, ref_layers)):
        assert set(st) == set(ref_st), (i, set(st), set(ref_st))
        for key in st:
            got = st[key].float().numpy()
            assert got.shape == ref_st[key].shape, (i, key)
            assert rel_err(got, ref_st[key]) <= tol, (i, key)


class TestConfigs:
    @pytest.mark.parametrize("arch", base.PORTED_ARCH_IDS)
    @pytest.mark.parametrize("reduced", [False, True])
    def test_copy_equals_reference(self, arch, reduced):
        got = base.get_arch(arch, reduced=reduced)
        want = ref_base.get_arch(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.layer_kinds == want.layer_kinds
        assert got.rest_kinds == want.rest_kinds
        assert got.n_params() == want.n_params()
        assert T.layer_kinds(got) == tuple(want.block_pattern) \
            * want.n_groups + tuple(want.rest_kinds)

    def test_alias_and_unported(self):
        assert base.get_arch("rwkv6-1.6b").name == "rwkv6-1.6b"
        with pytest.raises(ValueError, match="unknown arch"):
            base.get_arch("no_such_arch")
        assert set(base.PORTED_ARCH_IDS) <= set(base.ARCH_IDS)


class TestForward:
    @pytest.mark.parametrize("arch,kw", FORWARD_CASES, ids=[
        f"{a}-{'-'.join(v or 'default' for v in k.values())}"
        for a, k in FORWARD_CASES])
    def test_logits_match_reference(self, arch, kw):
        ref_m, ref_params, _, m, params, _ = build_pair(arch, **kw)
        toks = _tokens(m.cfg, 2, _seq_len(arch))
        want = np.asarray(ref_m.forward(ref_params,
                                        {"tokens": jnp.asarray(toks)})[0])
        got, aux = m.forward(params, {"tokens": torch.from_numpy(toks)})
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float(aux) == 0.0
        assert rel_err(host(got), want) <= FP32_TOL
        last, _ = m.forward(params, {"tokens": torch.from_numpy(toks)},
                            last_only=True)
        assert last.shape == (2, 1, m.cfg.vocab)
        torch.testing.assert_close(last, got[:, -1:], rtol=1e-5, atol=1e-5)

    def test_last_only_matches_reference_transformer(self):
        """The reference bundle's forward has no ``last_only``; its
        transformer does."""
        from repro.models import transformer as ref_T

        ref_m, ref_params, _, m, params, _ = build_pair("qwen3_1_7b")
        toks = _tokens(m.cfg, 2, 24, seed=3)
        want = np.asarray(ref_T.forward(ref_m.cfg, ref_params,
                                        {"tokens": jnp.asarray(toks)},
                                        last_only=True)[0])
        got, _ = m.forward(params, {"tokens": torch.from_numpy(toks)},
                           last_only=True)
        assert rel_err(host(got), want) <= FP32_TOL

    @pytest.mark.parametrize("arch", ["qwen3_1_7b", "rwkv6_1_6b"])
    def test_loss_matches_reference(self, arch):
        ref_m, ref_params, _, m, params, _ = build_pair(arch)
        toks = _tokens(m.cfg, 2, 33, seed=5)
        mask = (np.arange(32)[None, :] < np.array([[32], [20]])
                ).astype(np.float32)
        for use_mask in (False, True):
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if use_mask:
                batch["loss_mask"] = mask
            want = float(ref_m.loss_fn(ref_params, jax.tree.map(
                jnp.asarray, batch)))
            got = float(m.loss_fn(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()}))
            assert got == pytest.approx(want, rel=1e-5)


class TestDecode:
    @pytest.mark.parametrize("arch,kw", [
        ("qwen3_1_7b", {}), ("rwkv6_1_6b", {}),
        ("recurrentgemma_9b", {}), ("tiny-attn", {}), ("tiny-rec", {})])
    def test_decode_step_matches_reference(self, arch, kw):
        """Scalar-length decode, step by step: logits each step and the
        whole state after (for the hybrid, the rolling window cache
        wraps: 70 steps through a 64-slot window)."""
        ref_m, ref_params, _, m, params, _ = build_pair(arch, **kw)
        steps = 70 if arch == "recurrentgemma_9b" else 12
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
        _close_states(st["layers"], ref_layer_states(ref_m.cfg, ref_st))

    @pytest.mark.parametrize("arch,kw", [
        ("qwen3_1_7b", {}), ("rwkv6_1_6b", {"rec_impl": "pallas"}),
        ("rwkv6_1_6b", {"rec_impl": "chunked"}),
        ("tiny-rec", {"rec_impl": "pallas"}), ("tiny-rec", {}),
        ("tiny-rwkv", {"rec_impl": "pallas"})])
    def test_prefill_chunk_ragged_matches_reference(self, arch, kw):
        """Per-slot prefill of two chunks with ragged ``valid`` (a full
        row, a short row, an empty row): the hidden at valid positions
        and the whole state after each chunk."""
        ref_m, ref_params, _, m, params, _ = build_pair(arch, **kw)
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
            _close_states(st["layers"], ref_layer_states(ref_m.cfg, ref_st))
        assert st["length"].dtype == torch.int32

    def test_windowed_prefill_chunk_raises_like_reference(self):
        ref_m, ref_params, _, m, params, _ = build_pair("recurrentgemma_9b")
        toks = _tokens(m.cfg, 1, 8)
        valid = np.ones((1, 8), bool)
        with pytest.raises(ValueError, match="full caches only"):
            ref_m.prefill_chunk(ref_params, jnp.asarray(toks),
                                ref_m.init_decode_state(1, 16, per_slot=True),
                                0, jnp.asarray(valid))
        with pytest.raises(ValueError, match="full caches only"):
            m.prefill_chunk(params, torch.from_numpy(toks),
                            m.init_decode_state(1, 16, per_slot=True,
                                                device="cpu"),
                            0, torch.from_numpy(valid))


@pytest.mark.parametrize("arch,kw", [
    ("qwen3_1_7b", {"attn_impl": "pallas"}),
    ("rwkv6_1_6b", {"rec_impl": "pallas"}),
    ("recurrentgemma_9b", {"rec_impl": "pallas", "attn_impl": "pallas"})])
def test_bf16_dtype_flow_matches_reference(arch, kw):
    """bf16 weights and activations: logits within the reference's own
    bf16 distance of the fp32 logits (at most 2x), the same dtypes of
    logits and of every decode-state leaf, and the rwkv prefill state
    (fp32 wkv next to bf16 shift carries) within the same bar."""
    bf = dict(kw, param_dtype="bfloat16", act_dtype="bfloat16")
    ref32, ref_p32, _, _, _, _ = build_pair(arch, **kw)
    ref_m, ref_params, _, m, params, _ = build_pair(arch, **bf)
    toks = _tokens(m.cfg, 2, 32, seed=4)
    want32 = np.asarray(ref32.forward(ref_p32, {"tokens": jnp.asarray(toks)}
                                      )[0], np.float32)
    want = ref_m.forward(ref_params, {"tokens": jnp.asarray(toks)})[0]
    got, _ = m.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ref_gap = rel_err(np.asarray(want, np.float32), want32)
    assert 0.0 < rel_err(got.float().numpy(), want32) <= 2 * ref_gap
    ref_st = ref_layer_states(ref_m.cfg, ref_m.init_decode_state(2, 8))
    st = m.init_decode_state(2, 8, device="cpu")["layers"]
    for layer, ref_layer in zip(st, ref_st):
        assert {k: str(v.dtype).replace("torch.", "")
                for k, v in layer.items()} == \
            {k: v.dtype.name for k, v in ref_layer.items()}
    if arch == "rwkv6_1_6b":
        valid = jnp.ones((2, 16), bool)

        def ref_prefill(model, p):
            _, state = model.prefill_chunk(
                p, jnp.asarray(toks[:, :16]),
                model.init_decode_state(2, 32, per_slot=True), 0, valid)
            return ref_layer_states(model.cfg, state)

        want32, want = ref_prefill(ref32, ref_p32), ref_prefill(ref_m,
                                                                ref_params)
        _, st = m.prefill_chunk(params, torch.from_numpy(toks[:, :16]),
                                m.init_decode_state(2, 32, per_slot=True,
                                                    device="cpu"),
                                0, torch.ones((2, 16), dtype=torch.bool))
        for layer, ref_layer, ref32_layer in zip(st["layers"], want, want32):
            assert layer["wkv"].dtype == torch.float32
            assert layer["shift_att"].dtype == torch.bfloat16
            for key in ("wkv", "shift_att", "shift_ffn"):
                assert rel_err(layer[key].float().numpy(), ref32_layer[key]) \
                    <= 2 * rel_err(ref_layer[key], ref32_layer[key]), key


@pytest.mark.parametrize("arch", base.PORTED_ARCH_IDS)
def test_init_matches_reference_statistics(arch):
    """The port's own init: the reference's tree (keys, shapes, dtypes),
    its deterministic leaves exactly, and its random leaves' scale (the
    draws themselves differ between frameworks)."""
    ref_cfg, cfg = arch_pair(arch)
    ref_params = ref_get_model(ref_cfg).init(jax.random.PRNGKey(0))
    model = get_model(cfg).init(0, device="cpu")
    ref_model = build_pair(arch)[4]
    got = dict(model.named_parameters())
    want = dict(ref_model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        q = want[name]
        assert p.shape == q.shape and p.dtype == q.dtype, name
        assert not p.requires_grad
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("mu_x", "mu", "w0", "u", "ln_x", "mu_k", "mu_r", "ln1",
                    "ln2", "ln3", "final_norm", "enc_norm", "q_norm",
                    "k_norm", "conv_b", "b_a", "b_i", "lam"):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6)
        elif p.numel() >= 4096:
            # a truncated normal (+-2 scale) like the reference's draw
            ratio = float(p.std()) / float(q.std())
            assert 0.9 < ratio < 1.1, (name, ratio)
            assert float(p.abs().max()) <= 1.05 * float(q.abs().max()), name
    assert ref_params["embed"].shape == tuple(model.embed.shape)
    # the train path's switch reaches every parameter, and only then
    model.requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())
    assert sum(1 for _ in model.parameters()) == len(got)
    assert not any(p.requires_grad for p in ref_model.parameters())


def test_init_defaults_to_cuda():
    _, cfg = arch_pair("tiny-attn")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg).init_decode_state(1, 8)


@pytest.mark.parametrize("seed", [0, 3])
def test_token_copy_equals_reference(seed):
    spec = tokens.TokenTaskSpec(vocab=64, seed=seed)
    ref_spec = ref_tokens.TokenTaskSpec(vocab=64, seed=seed)
    stream = tokens.sample_tokens(spec, 300, seed=seed)
    np.testing.assert_array_equal(stream,
                                  ref_tokens.sample_tokens(ref_spec, 300,
                                                           seed=seed))
    np.testing.assert_array_equal(
        tokens.token_features(stream, d=32, window=8, vocab=64),
        ref_tokens.token_features(stream, d=32, window=8, vocab=64))
    got = tokens.token_batch_iterator(spec, 2, 16, seed=seed)
    want = ref_tokens.token_batch_iterator(ref_spec, 2, 16, seed=seed)
    for _ in range(2):
        a, b = next(got), next(want)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
