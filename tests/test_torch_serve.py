"""The port's continuous-batching ServeEngine against the JAX engine on
the CPU: the reference serving tests' request mixes (``ragged_requests``)
on the tiny architectures, on the reference's weights and heads.

Bars: the generated tokens and the counts (decode rounds, prefill and
decode dispatches, slot utilization) equal the JAX engine's exactly; the
tokens equal the port's own per-request ``greedy_decode`` (the
reference's bar); ``route_requests`` gives the reference's labels; the
routed readout agrees with the reference's to 1e-5 of its largest logit
(fp32 sums in another order); validation errors carry the reference's
messages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import build_pair, rel_err
from _torch_support import host
from repro.core.membership_engine import MembershipConfig as RefMemConfig
from repro.core.membership_engine import MembershipEngine as RefMemEngine
from repro.data.tokens import TokenTaskSpec, sample_tokens
from repro.launch import decode_loop as ref_dl
from repro_torch.core.membership_engine import (MembershipConfig,
                                                MembershipEngine)
from repro_torch.launch import decode_loop as dl
from repro_torch.launch import serve as launch_serve

SCFG = dict(slots=4, max_len=32, prefill_chunk=4, max_prompt=16, wave=3,
            max_gen=8)


def ragged_requests(rng, n, vocab, n_clusters, max_prompt=16, max_gen=8,
                    staggered=False):
    """The reference serving tests' request mix (same draws)."""
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, max_prompt + 1))
        gen = int(rng.integers(1, max_gen + 1))
        arrive = int(rng.integers(1, 6)) if staggered and i >= n // 2 else 0
        reqs.append(dl.Request(
            tokens=rng.integers(0, vocab, plen).astype(np.int32),
            gen=gen, cluster=i % n_clusters, arrive_round=arrive))
    return reqs


def _ref_requests(reqs):
    return [ref_dl.Request(tokens=r.tokens, gen=r.gen, cluster=r.cluster,
                           arrive_round=r.arrive_round) for r in reqs]


def _serve_both(kind, reqs_fn, **kw):
    ref_m, ref_params, ref_heads, m, params, heads = build_pair(
        f"tiny-{kind}", n_clusters=3, **kw)
    reqs = reqs_fn(m.cfg.vocab)
    ref_stats = ref_dl.ServeEngine(ref_m, ref_params, ref_heads,
                                   ref_dl.ServeConfig(**SCFG)
                                   ).serve(_ref_requests(reqs))
    engine = dl.ServeEngine(m, params, heads, dl.ServeConfig(**SCFG))
    return engine, reqs, engine.serve(reqs), ref_stats, (m, params, heads)


def _assert_same_as_reference(stats, ref_stats):
    assert len(stats.results) == len(ref_stats.results)
    for i, (got, want) in enumerate(zip(stats.results, ref_stats.results)):
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens),
                                      err_msg=f"request {i}")
        assert got.cluster == want.cluster
    for key in ("decode_rounds", "prefill_dispatches", "decode_dispatches",
                "prefill_scan_steps", "slot_utilization"):
        assert getattr(stats, key) == getattr(ref_stats, key), key


def _assert_greedy_identical(model, params, heads, reqs, stats):
    for i, r in enumerate(reqs):
        base = dl.greedy_decode(model, params,
                                torch.from_numpy(r.tokens)[None, :], r.gen,
                                logits_fn=dl.cluster_logits_fn(heads,
                                                               r.cluster))
        np.testing.assert_array_equal(host(base.tokens[0]),
                                      stats.results[i].tokens,
                                      err_msg=f"request {i} diverged")


@pytest.mark.parametrize("kind,kw", [("attn", {}),
                                     ("rwkv", {"rec_impl": "pallas"}),
                                     ("rec", {"rec_impl": "pallas"})])
def test_ragged_mix_equals_jax_engine(kind, kw):
    """8 ragged requests through 4 slots (slot reuse)."""
    engine, reqs, stats, ref_stats, trio = _serve_both(
        kind, lambda vocab: ragged_requests(np.random.default_rng(7), 8,
                                            vocab, 3), **kw)
    _assert_same_as_reference(stats, ref_stats)
    _assert_greedy_identical(*trio, reqs, stats)
    assert stats.slot_utilization > 0
    assert [len(r.tokens) for r in stats.results] == [r.gen for r in reqs]


def test_staggered_arrivals_equal_jax_engine_and_reuse_programs():
    """Late arrivals join mid-decode; a second serve with another mix
    reuses the same programs (each counted once, when built)."""
    engine, reqs, stats, ref_stats, trio = _serve_both(
        "attn", lambda vocab: ragged_requests(np.random.default_rng(11), 10,
                                              vocab, 3, staggered=True))
    _assert_same_as_reference(stats, ref_stats)
    _assert_greedy_identical(*trio, reqs, stats)
    assert stats.prefill_dispatches >= 2
    assert stats.traces == {"prefill": 1, "admit": 1, "decode": 1}
    reqs2 = ragged_requests(np.random.default_rng(12), 6, trio[0].cfg.vocab,
                            3, staggered=True)
    stats2 = engine.serve(reqs2)
    assert engine.traces == stats.traces
    _assert_greedy_identical(*trio, reqs2, stats2)


def test_gen_one_equals_jax_engine():
    """Requests that finish at their first token never take a slot."""
    engine, reqs, stats, ref_stats, trio = _serve_both(
        "rwkv", lambda vocab: [
            dl.Request(tokens=np.arange(5, dtype=np.int32) % vocab, gen=1,
                       cluster=c) for c in range(3)], rec_impl="pallas")
    assert stats.decode_dispatches == ref_stats.decode_dispatches == 0
    _assert_same_as_reference(stats, ref_stats)
    _assert_greedy_identical(*trio, reqs, stats)


def test_validation_errors_are_the_reference_s():
    ref_m, ref_params, ref_heads, m, params, heads = build_pair(
        "tiny-attn", n_clusters=3)
    ref_engine = ref_dl.ServeEngine(ref_m, ref_params, ref_heads,
                                    ref_dl.ServeConfig(**SCFG))
    engine = dl.ServeEngine(m, params, heads, dl.ServeConfig(**SCFG))
    bad = [dict(tokens=np.zeros(17, np.int32), gen=2),
           dict(tokens=np.zeros(4, np.int32), gen=9),
           dict(tokens=np.zeros(4, np.int32), gen=2, cluster=5),
           dict(tokens=np.zeros(0, np.int32), gen=2)]
    for req in bad:
        with pytest.raises(ValueError) as want:
            ref_engine.serve([ref_dl.Request(**req)])
        with pytest.raises(ValueError) as got:
            engine.serve([dl.Request(**req)])
        assert str(got.value) == str(want.value)
    for kw in (dict(prefill_chunk=5, max_prompt=16),
               dict(max_prompt=64, max_gen=64, max_len=100),
               dict(slots=0)):
        with pytest.raises(ValueError) as want:
            ref_dl.ServeConfig(**kw).validate()
        with pytest.raises(ValueError) as got:
            dl.ServeConfig(**kw).validate()
        assert str(got.value) == str(want.value)
    for arch, kw in (("tiny-attn", {"attn_window": 8}),
                     ("recurrentgemma_9b", {})):
        ref_m, ref_params, ref_heads, m, params, heads = build_pair(
            arch, n_clusters=3, **kw)
        with pytest.raises(ValueError, match="full KV") as want:
            ref_dl.ServeEngine(ref_m, ref_params, ref_heads)
        with pytest.raises(ValueError, match="full KV") as got:
            dl.ServeEngine(m, params, heads)
        assert str(got.value) == str(want.value)


def test_cluster_logits_match_reference():
    _, _, ref_heads, m, _, heads = build_pair("tiny-attn", n_clusters=3)
    hn = np.random.default_rng(1).standard_normal((5, m.cfg.d_model)
                                                  ).astype(np.float32)
    cids = np.array([2, 0, 2, 1, 0], np.int32)
    want = np.asarray(ref_dl.cluster_logits(ref_heads, jnp.asarray(hn),
                                            jnp.asarray(cids)))
    got = dl.cluster_logits(heads, torch.from_numpy(hn),
                            torch.from_numpy(cids))
    assert got.dtype == torch.float32
    assert rel_err(host(got), want) <= 1e-5
    one = dl.cluster_logits_fn(heads, 1)(torch.from_numpy(hn))
    assert rel_err(host(one)[3], want[3]) <= 1e-5
    assert not np.allclose(host(one)[0], want[0])
    # the port's own heads: base head plus seeded noise, on its device
    own = dl.ClusterHeads.init(1, m.init(0, device="cpu").head, 4, rank=2)
    assert own.n_clusters == 4 and own.adapter_a.shape == (4, 64, 2)
    assert own.head.dtype == torch.float32


def test_route_requests_labels_equal_reference():
    """Requests from two token distributions route to the clusters their
    signatures seeded, through the port's MembershipEngine (on the CPU,
    fp32 scoring) and the reference's numpy engine alike."""
    d, k = 32, 2
    specs = [TokenTaskSpec(vocab=64, seed=s) for s in (0, 1)]
    streams, labels = [], []
    for t, spec in enumerate(specs):
        for j in range(3):
            streams.append(sample_tokens(spec, 600, seed=10 * t + j))
            labels.append(t)
    sigs = [dl.token_signature(s, d=d, k=k, vocab=64) for s in streams]
    for got_sig, s in zip(sigs, streams):
        want_sig = ref_dl.token_signature(s, d=d, k=k, vocab=64)
        np.testing.assert_array_equal(got_sig[0], want_sig[0])
        np.testing.assert_array_equal(got_sig[1], want_sig[1])
    lam = np.stack([s[0] for s in sigs])
    v = np.stack([s[1] for s in sigs])
    ref_eng = RefMemEngine(RefMemConfig(backend="numpy"))
    ref_eng.seed(lam, v, np.asarray(labels), n_clusters=2)
    eng = MembershipEngine(MembershipConfig(backend="torch",
                                            compute_dtype="fp32"),
                           device="cpu")
    eng.seed(lam, v, np.asarray(labels), n_clusters=2)
    queries = streams + [sample_tokens(specs[t], 300, seed=(5, t))
                         for t in (1, 0)]
    want = ref_dl.route_requests(ref_eng, queries, d=d, k=k, vocab=64)
    got = dl.route_requests(eng, queries, d=d, k=k, vocab=64)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == labels + [1, 0]
    assert got.dtype == np.int32

    class Stub:
        def assign(self, lam, v):
            return dataclasses.make_dataclass("R", ["labels"])(
                torch.tensor([-1, 1]))

    assert dl.route_requests(Stub(), [np.arange(40), np.arange(40)]
                             ).tolist() == [0, 1]


def test_decode_stats_accounting():
    s = dl.DecodeStats(tokens=torch.zeros((4, 9), dtype=torch.int32),
                       prompt_len=7, prefill_s=1.0, ttft_s=1.5, decode_s=2.0,
                       prefill_dispatches=7)
    assert s.tok_per_s == pytest.approx(4 * 8 / 2.0)
    assert s.total_tok_per_s == pytest.approx(4 * 9 / 3.5)


def test_serve_launcher_on_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", "rwkv6_1_6b",
                       "--requests", "4", "--prompt-len", "16",
                       "--prefill-chunk", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "continuous:" in out and "on cpu" in out
    assert "prefill dispatches" in out
    launch_serve.main(["--device", "cpu", "--mode", "static", "--requests",
                       "3", "--clusters", "2", "--prompt-len", "8",
                       "--gen", "3"])
    assert "static:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.main(["--requests", "1"])
