"""The port's raw-data ingest (``core/signature_engine.py``), raw entry
point and blockwise protocol, against the JAX package.

Tolerances and why:

* Grams from raw data (``_chunk_gram_accum``, ``SignatureEngine.grams``)
  in fp32: rtol 1e-5 with an absolute floor of 1e-5 of the largest
  entry; fp32 products summed in another order.  In bf16: 2e-3 of the
  largest entry; the fp32 conv front end differs by rounding, which
  can flip the bf16 rounding of an entry of F (one bf16 ulp is 3.9e-3
  of the entry); the measured gap is 4e-4.
* ``topk_spectrum`` with the reference's start injected: eigenvalues to
  1e-5 of the largest, projectors ``V V^T`` to 1e-4 (never raw ``V``,
  whose signs are arbitrary); the QRs and products round differently.
* R from the raw entry point and from the blockwise path: 1e-5, the
  reference's own bar between its paths, where ``top_k <= d // 8``;
  raw-path R in bf16: 1e-3 (see the test).
  The port draws its own subspace start, so raw-path R agrees only
  because the iteration converges (the reference's own raw-vs-dense
  test holds the same 1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_support import CPU, host, same_partition, t
from repro.core import engine as ref_engine
from repro.core import oneshot as ref_oneshot
from repro.core import signature_engine as ref_sig
from repro.core import similarity as ref_sim
from repro.data import features as ref_feat
from repro.data import partition as ref_part
from repro.data import synthetic as ref_syn
from repro_torch import convert
from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core import signature_engine as sig
from repro_torch.core import similarity as sim
from repro_torch.core.engine import ProtocolEngine
from repro_torch.data import features as feat


def close(out, ref, rtol=1e-5, floor=1e-5):
    out, ref = host(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(
        out, ref, rtol=rtol,
        atol=floor * max(float(np.abs(ref).max()), 1e-30))


def _psd_stack(n_mats, d, decay=0.7, seed=0):
    """Random PSD stack with geometric spectra (well-separated gaps)."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(n_mats):
        q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        mats.append((q * decay ** np.arange(d)) @ q.T)
    return np.stack(mats).astype(np.float32)


def _projector(v):
    v = host(v)
    return np.einsum("ndk,nek->nde", v, v)


class TestTopkSpectrum:
    @pytest.mark.parametrize("k,oversample,iters", [(5, 8, 24), (5, 8, 7),
                                                    (4, 4, 20), (3, 2, 1)])
    def test_matches_reference_with_its_start(self, k, oversample, iters):
        g = _psd_stack(6, 32)
        p = min(k + oversample, 32)
        q0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (32, p),
                                          jnp.float32))
        lam, v = sig.topk_spectrum(t(g), k, iters=iters,
                                   oversample=oversample, q0=q0)
        ref_lam, ref_v = ref_sig.topk_spectrum(jnp.asarray(g), k, iters=iters,
                                               oversample=oversample)
        close(lam, ref_lam, rtol=0)
        close(_projector(v), _projector(ref_v), rtol=0, floor=1e-4)

    def test_own_start_converges_to_eigh(self):
        g = t(_psd_stack(6, 32, seed=2))
        lam_s, v_s = sig.topk_spectrum(g, 5, iters=24)
        lam_e, v_e = sig.topk_spectrum(g, 5, method="eigh")
        close(lam_s, lam_e.numpy(), rtol=0)
        close(_projector(v_s), _projector(v_e), rtol=0, floor=1e-4)
        assert torch.equal(sig.subspace_start(32, 13), sig.subspace_start(32, 13))

    def test_top_k_d_falls_through_to_eigh(self):
        g = t(_psd_stack(3, 12))
        lam_s, v_s = sig.topk_spectrum(g, 12, iters=2)
        lam_e, v_e = sig.topk_spectrum(g, 12, method="eigh")
        assert torch.equal(lam_s, lam_e) and torch.equal(v_s, v_e)
        lam, v = sig.topk_spectrum(t(_psd_stack(2, 8)), 0)
        assert lam.shape == (2, 8) and v.shape == (2, 8, 8)

    def test_rejects_bad_method_and_start(self):
        with pytest.raises(ValueError, match="method"):
            sig.topk_spectrum(t(_psd_stack(1, 8)), 2, method="lanczos")
        with pytest.raises(ValueError, match="q0"):
            sig.topk_spectrum(t(_psd_stack(1, 16)), 2, oversample=2,
                              q0=np.zeros((16, 3), np.float32))


class TestResidual:
    @pytest.mark.parametrize("iters", [0, 3])
    def test_matches_reference(self, iters):
        """On the reference's own eigenpairs.  The residual is relative to
        lam_1 = 1 and cancels near convergence, so it is held to rtol 1e-5
        with an absolute 1e-6 (a few fp32 ulps of lam_1)."""
        g = _psd_stack(4, 24, seed=1)
        lam, v = ref_sig.topk_spectrum(jnp.asarray(g), 5, iters=iters)
        ref = ref_sig.subspace_residual(jnp.asarray(g), lam, v)
        np.testing.assert_allclose(
            sig.subspace_residual(t(g), t(lam), t(v)).numpy(),
            np.asarray(ref), rtol=1e-5, atol=1e-6)

    def test_nonconvergence_detected(self):
        g = t(_psd_stack(4, 32))
        bad = sig.subspace_residual(g, *sig.topk_spectrum(g, 5, iters=0))
        ok = sig.subspace_residual(g, *sig.topk_spectrum(g, 5, iters=24))
        assert float(ok.max()) < 1e-3 < float(bad.max())

    def test_signatures_check_raises_on_stall(self, rng):
        raw = [rng.standard_normal((40, 24)).astype(np.float32)
               for _ in range(4)]
        stalled = sig.SignatureEngine(
            feat.FeatureConfig(kind="identity"),
            sig.SignatureConfig(subspace_iters=0, oversample=2), device=CPU)
        with pytest.raises(RuntimeError, match="did not converge"):
            stalled.signatures(raw, top_k=4, check=True)
        ok = sig.SignatureEngine(feat.FeatureConfig(kind="identity"),
                                 sig.SignatureConfig(subspace_iters=30),
                                 device=CPU)
        lam, v, g = ok.signatures(raw, top_k=4, check=True)
        assert lam.shape == (4, 4) and v.shape == (4, 24, 4)


# (kind, config kwargs, input dim m, probe columns)
KINDS = [
    ("identity", {}, 24, 0),
    ("random_projection", {"d": 16}, 40, 0),
    ("pca", {"d": 12}, 32, 32),
    ("random_conv", {"d": 24, "image_hw": (8, 8, 3)}, 192, 0),
]


def _engines(kind, kwargs, probe, **sig_kw):
    port = sig.SignatureEngine(feat.FeatureConfig(kind=kind, **kwargs),
                               sig.SignatureConfig(**sig_kw), probe=probe,
                               device=CPU)
    ref = ref_sig.SignatureEngine(ref_feat.FeatureConfig(kind=kind, **kwargs),
                                  ref_sig.SignatureConfig(**sig_kw),
                                  probe=probe)
    return port, ref


def _gram_close(out, ref, compute_dtype):
    if compute_dtype == "fp32":
        close(out, ref)
    else:
        close(out, ref, rtol=0, floor=2e-3)


class TestChunkGramAccum:
    @pytest.mark.parametrize("kind,kwargs,m,probe_cols", KINDS)
    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("apply_mask", [True, False])
    def test_matches_reference(self, rng, kind, kwargs, m, probe_cols,
                               compute_dtype, apply_mask):
        """One chunk of a ragged batch (the chunk starts at row 8, so the
        mask cuts users mid-chunk; ``pca``'s affine Phi needs it)."""
        probe = (rng.standard_normal((50, probe_cols)).astype(np.float32)
                 if probe_cols else None)
        port, ref = _engines(kind, kwargs, probe)
        x = rng.standard_normal((3, 11, m)).astype(np.float32)
        nv = np.array([19.0, 8.0, 12.0], np.float32)
        d_out = port.out_dim(m)
        acc = rng.standard_normal((3, d_out, d_out)).astype(np.float32)
        out = sig._chunk_gram_accum(t(acc), t(x), t(nv), 8, port.params_for(m),
                                    port.feature_cfg, compute_dtype,
                                    apply_mask=apply_mask)
        backend = "pallas" if compute_dtype == "fp32" else "jnp"
        ref_out = ref_sig._chunk_gram_accum(
            jnp.asarray(acc), jnp.asarray(x), jnp.asarray(nv),
            jnp.asarray(8.0), ref.params_for(m), ref.feature_cfg, backend,
            compute_dtype, apply_mask=apply_mask)
        _gram_close(out, ref_out, compute_dtype)

    def test_accumulates_in_place(self, rng):
        port, _ = _engines("random_projection", {"d": 8}, None)
        acc = torch.zeros((2, 8, 8))
        out = sig._chunk_gram_accum(acc, t(rng.standard_normal((2, 5, 20))),
                                    torch.tensor([5.0, 5.0]), 0,
                                    port.params_for(20), port.feature_cfg,
                                    "fp32", apply_mask=False)
        assert out is acc and float(acc.abs().max()) > 0


class TestGrams:
    @pytest.mark.parametrize("kind,kwargs,m,probe_cols", KINDS)
    @pytest.mark.parametrize("chunk", [0, 13])
    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_ragged_matches_reference(self, rng, kind, kwargs, m, probe_cols,
                                      chunk, compute_dtype):
        raw = [rng.standard_normal((n, m)).astype(np.float32)
               for n in (30, 17, 41)]
        probe = (rng.standard_normal((50, probe_cols)).astype(np.float32)
                 if probe_cols else None)
        port, ref = _engines(kind, kwargs, probe, chunk_rows=chunk,
                             compute_dtype=compute_dtype)
        _gram_close(port.grams(raw), ref.grams(raw), compute_dtype)

    @pytest.mark.parametrize("chunk", [0, 5, 36, 37, 64])
    def test_full_stack_assume_full(self, rng, chunk):
        """A full numpy stack, a stack tensor and the ragged form give the
        same Grams; chunking changes only the sum order."""
        raw = rng.standard_normal((4, 37, 20)).astype(np.float32)
        port, ref = _engines("random_projection", {"d": 8}, None,
                             chunk_rows=chunk)
        g = port.grams(raw)
        close(g, ref.grams(raw))
        close(port.grams(t(raw)), g.numpy())
        close(port.grams(list(raw)), g.numpy())

    def test_prepare_guards(self):
        port, _ = _engines("random_projection", {"d": 8}, None)
        with pytest.raises(ValueError, match="ragged"):
            port.prepare([np.zeros((4, 3), np.float32)],
                         n_valid=np.ones((1,)))
        with pytest.raises(ValueError, match="N, n, m"):
            port.prepare(np.zeros((4, 3), np.float32))
        with pytest.raises(TypeError, match="FeatureConfig"):
            sig.SignatureEngine({"kind": "identity"}, device=CPU)


@pytest.fixture(scope="module")
def mixture():
    return ref_syn.make_task_feature_mixture(
        n_users=24, n_samples=48, d=96, n_tasks=3, seed=7)


class TestRawEntry:
    FC = dict(kind="random_projection", d=32)

    @pytest.mark.parametrize("sig_kw", [
        dict(), dict(chunk_rows=13), dict(eig="eigh"),
        dict(chunk_rows=16, check=True)])
    def test_r_matches_reference_run_raw(self, mixture, sig_kw):
        raw, _ = mixture
        res = ProtocolEngine(sim.SimilarityConfig(top_k=6), device=CPU
                             ).run_raw(raw, feat.FeatureConfig(**self.FC),
                                       signature_cfg=sig.SignatureConfig(
                                           **sig_kw))
        ref = ref_engine.ProtocolEngine(ref_sim.SimilarityConfig(top_k=6)
                                        ).run_raw(
            raw, ref_feat.FeatureConfig(**self.FC),
            signature_cfg=ref_sig.SignatureConfig(**sig_kw))
        close(res.similarity, ref.similarity, rtol=0)
        close(res.relevance, ref.relevance, rtol=0)
        assert (res.n_users, res.d, res.top_k) == (24, 32, 6)
        close(res.lam, ref.lam, rtol=0)

    @pytest.mark.parametrize("kind,kwargs,m,probe_cols", KINDS)
    @pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
    def test_every_phi_kind_matches_reference(self, kind, kwargs, m,
                                              probe_cols, compute_dtype):
        """Ragged users, every Phi kind, both compute types.  bf16 R is
        held to 1e-3: a flipped bf16 rounding of F (after the conv front
        end's fp32 differences) moves R by up to 9.2e-5 here."""
        rng = np.random.default_rng(0)
        ragged = [rng.standard_normal((n, m)).astype(np.float32)
                  for n in (50, 21, 64, 33, 40)]
        probe = (rng.standard_normal((60, probe_cols)).astype(np.float32)
                 if probe_cols else None)
        sig_kw = dict(chunk_rows=17, compute_dtype=compute_dtype)
        r = ProtocolEngine(sim.SimilarityConfig(top_k=3), device=CPU
                           ).similarity_from_raw(
            ragged, feat.FeatureConfig(kind=kind, **kwargs), probe=probe,
            signature_cfg=sig.SignatureConfig(**sig_kw))
        ref = ref_engine.ProtocolEngine(ref_sim.SimilarityConfig(top_k=3)
                                        ).similarity_from_raw(
            ragged, ref_feat.FeatureConfig(kind=kind, **kwargs), probe=probe,
            signature_cfg=ref_sig.SignatureConfig(**sig_kw))
        close(r, ref, rtol=0, floor=1e-5 if compute_dtype == "fp32" else 1e-3)

    def test_raw_equals_prefeaturized(self, mixture):
        raw, _ = mixture
        fc = feat.FeatureConfig(**self.FC)
        feats = np.stack([feat.feature_map(x, fc) for x in raw])
        cfg = sim.SimilarityConfig(top_k=6)
        r_pre = ProtocolEngine(cfg, device=CPU).similarity(feats)
        r_raw = ProtocolEngine(cfg, device=CPU).similarity_from_raw(raw, fc)
        close(r_raw, r_pre.numpy(), rtol=0)

    def test_guards(self, mixture):
        raw, _ = mixture
        fc = feat.FeatureConfig(**self.FC)
        with pytest.raises(ValueError, match="block_users"):
            ProtocolEngine(sim.SimilarityConfig(block_users=8),
                           device=CPU).run_raw(raw, fc)
        with pytest.raises(ValueError, match="conflicts"):
            ProtocolEngine(device=CPU).run_raw(
                raw, fc, signature_cfg=sig.SignatureConfig(
                    backend="shard_map"))
        with pytest.raises(RuntimeError, match="did not converge"):
            ProtocolEngine(sim.SimilarityConfig(top_k=6), device=CPU
                           ).run_raw(raw, fc, signature_cfg=sig.SignatureConfig(
                               subspace_iters=0, oversample=2, check=True))
        with pytest.raises(ValueError, match="feature_cfg"):
            oneshot.one_shot_clustering(raw, 3, device=CPU,
                                        signature_cfg=sig.SignatureConfig())

    def test_signature_config_validation(self):
        for bad in (dict(backend="jnp"), dict(chunk_rows=-1),
                    dict(eig="power"), dict(subspace_iters=-2),
                    dict(oversample=-1), dict(resid_tol=0.0),
                    dict(compute_dtype="fp16")):
            with pytest.raises(ValueError):
                sig.SignatureConfig(**bad)


class TestBlockwise:
    @pytest.mark.parametrize("block", [8, 13, 40])
    def test_r_matches_reference_and_dense(self, block):
        feats, _ = ref_syn.make_task_feature_mixture(40, 30, 32, 4, seed=3)
        cfg = sim.SimilarityConfig(top_k=3, block_users=block)
        res = ProtocolEngine(cfg, device=CPU).run(feats)
        ref = ref_engine.ProtocolEngine(ref_sim.SimilarityConfig(
            top_k=3, block_users=block)).run(jnp.asarray(feats))
        close(res.similarity, ref.similarity, rtol=0)
        close(res.relevance, ref.relevance, rtol=0)
        close(_projector(res.v), _projector(ref.v), rtol=0, floor=1e-4)
        dense = ProtocolEngine(sim.SimilarityConfig(top_k=3), device=CPU
                               ).similarity(feats)
        close(res.similarity, dense.numpy(), rtol=0)

    def test_ragged_users(self, rng):
        ragged = [rng.standard_normal((n, 16)).astype(np.float32)
                  for n in (9, 20, 3, 14, 11)]
        cfg = sim.SimilarityConfig(top_k=2, block_users=2)
        r = ProtocolEngine(cfg, device=CPU).similarity(ragged)
        ref = ref_engine.ProtocolEngine(ref_sim.SimilarityConfig(
            top_k=2, block_users=2)).similarity(ragged)
        close(r, ref, rtol=0)
        with pytest.raises(ValueError, match="dense"):
            ProtocolEngine(cfg, device=CPU).signatures(ragged)


@pytest.mark.parametrize("layout", ["cifar", "fmnist"])
@pytest.mark.parametrize("path", ["raw", "blockwise"])
def test_paper_layouts_recover_tasks(layout, path):
    """Labels up to permutation on the paper's layouts (small scale),
    equal to the reference's partition."""
    if layout == "cifar":
        users = ref_part.paper_cifar_two_task(n_per_user=64, seed=0,
                                              users_per_task=(4, 4))
        fc_kw, top_k = dict(kind="random_projection", d=64), 4
    else:
        users = ref_part.paper_fmnist_three_task(seed=0, scale=0.05)
        fc_kw, top_k = dict(kind="identity"), 4
    raw = [u.x for u in users]
    task_ids = np.array([u.task_id for u in users])
    n_tasks = len(set(task_ids))
    if path == "raw":
        res = oneshot.one_shot_clustering(
            raw, n_tasks, cfg=sim.SimilarityConfig(top_k=top_k),
            feature_cfg=feat.FeatureConfig(**fc_kw),
            signature_cfg=sig.SignatureConfig(chunk_rows=32), device=CPU)
        ref = ref_oneshot.one_shot_clustering(
            raw, n_tasks, cfg=ref_sim.SimilarityConfig(top_k=top_k),
            feature_cfg=ref_feat.FeatureConfig(**fc_kw),
            signature_cfg=ref_sig.SignatureConfig(chunk_rows=32))
    else:
        fc = feat.FeatureConfig(**fc_kw)
        feats = [feat.feature_map(x, fc) for x in raw]
        res = oneshot.one_shot_clustering(
            feats, n_tasks, cfg=sim.SimilarityConfig(top_k=top_k,
                                                     block_users=3),
            device=CPU)
        ref = ref_oneshot.one_shot_clustering(
            feats, n_tasks, cfg=ref_sim.SimilarityConfig(top_k=top_k,
                                                         block_users=3))
        assert res.ledger.mode == "streaming"
    assert clu.clustering_accuracy(host(res.labels), task_ids) == 1.0
    assert same_partition(res.labels, ref.labels)
    assert res.ledger.summary() == ref.ledger.summary()


def test_convert_reference_configs_and_phi():
    fc = ref_feat.FeatureConfig(kind="random_conv", d=24, seed=3,
                                image_hw=(8, 8, 3), probe_digest="abc")
    port_fc = convert.feature_config_from_reference(fc)
    assert port_fc == feat.FeatureConfig(kind="random_conv", d=24, seed=3,
                                         image_hw=(8, 8, 3),
                                         probe_digest="abc")
    scfg = ref_sig.SignatureConfig(backend="pallas", chunk_rows=7, eig="eigh",
                                   subspace_iters=9, oversample=3, check=True,
                                   resid_tol=2e-3, compute_dtype="bf16")
    assert convert.signature_config_from_reference(scfg) == \
        sig.SignatureConfig(chunk_rows=7, eig="eigh", subspace_iters=9,
                            oversample=3, check=True, resid_tol=2e-3,
                            compute_dtype="bf16")
    assert convert.signature_config_from_reference(
        ref_sig.SignatureConfig(backend="shard_map")).backend == "shard_map"
    ref_params = ref_sig.SignatureEngine(fc).params_for(192)
    params = convert.phi_params_from_reference(ref_params, device=CPU)
    port_params = sig.SignatureEngine(port_fc, device=CPU).params_for(192)
    assert params.keys() == port_params.keys()
    for k in params:
        assert torch.equal(params[k], port_params[k])
