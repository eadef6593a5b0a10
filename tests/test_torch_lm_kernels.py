"""The plain versions of the port's LM kernels against the JAX package's
Pallas kernels (interpret mode) and oracles, on the same numpy inputs.

On the CPU each wrapper runs its kernel's plain version; the CUDA
kernels are held against those plain versions on the card in
``test_torch_kernels_gpu.py``.  Tolerances: fp32 results summed in
another order agree to 1e-5 of the largest entry.  The wkv wrapper runs
the chunk form (``wkv_chunked_ref``), which rounds the operands the
reference's kernel rounds under ``compute_dtype="bf16"``, the default; so
fp32 compute is held to 1e-5 and bf16 to the reference's own bar
(``tests/test_kernels.py::test_wkv_bf16_parity``): 1e-3 at 0.1-scale
inputs, against the oracle and against the reference's bf16 kernel
(``test_torch_wkv.py`` holds it at full scale).  Flash on bf16 inputs returns
bf16; it is held to one bf16 ulp of the largest output (2^-8) against
the fp32 function of the same inputs.  The tensor-core kernel's split of
p into two bf16 parts (``flash_ref(..., p_rounding="hi_lo")``) is held to
2^-15 of the largest output of the reference's fp32 oracle, and p rounded
to bf16 once must miss that oracle by more than 10x as much.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import rel_err
from _torch_support import host
from repro.kernels.flash_attention import ops as ref_fa
from repro.kernels.flash_attention.ref import flash_ref as ref_flash_ref
from repro.kernels.recurrent_scan import ops as ref_rs
from repro.kernels.recurrent_scan.ref import linear_scan_ref as ref_scan_ref
from repro.kernels.recurrent_scan.ref import wkv_ref as ref_wkv_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import flash_attention, flash_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.recurrent_scan import (linear_scan, linear_scan_ref,
                                                wkv_chunked, wkv_chunked_ref,
                                                wkv_ref)

TOL = 1e-5


def _qkv(rng, b, s, skv, h, hd):
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, hd)).astype(np.float32)
    return q, k, v


def _ref_flash_flat(q, k, v, causal, window):
    """The reference's ``(BH, S, hd)`` oracle on ``(B, S, H, hd)`` arrays."""
    b, s, h, hd = q.shape

    def flat(t):
        return jnp.asarray(t).transpose(0, 2, 1, 3).reshape(b * h, -1, hd)

    out = ref_flash_ref(flat(q), flat(k), flat(v), causal=causal,
                        window=window)
    return np.asarray(out).reshape(b, h, s, hd).transpose(0, 2, 1, 3)


class TestFlash:
    @pytest.mark.parametrize("b,s,h,hd", [(1, 128, 4, 128), (2, 256, 2, 256)])
    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                               (False, 0)])
    def test_matches_pallas_kernel(self, b, s, h, hd, causal, window):
        """The reference's aligned shapes, where its wrapper runs the
        Pallas kernel."""
        q, k, v = _qkv(np.random.default_rng(s + h + window), b, s, s, h, hd)
        want = np.asarray(ref_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, interpret=True))
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert rel_err(host(got), want) <= TOL

    @pytest.mark.parametrize("b,s,skv,h,hd", [(1, 100, 100, 2, 64),
                                              (2, 37, 37, 3, 16),
                                              (1, 50, 90, 2, 128),
                                              (2, 200, 200, 1, 256)])
    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                               (False, 0), (False, 20)])
    def test_unaligned_matches_oracle(self, b, s, skv, h, hd, causal,
                                      window):
        """Shapes off the reference's 128 grid (its wrapper takes the
        oracle there; the port's kernel masks the edges instead)."""
        q, k, v = _qkv(np.random.default_rng(s * 7 + hd), b, s, skv, h, hd)
        want = _ref_flash_flat(q, k, v, causal, window)
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
        assert rel_err(host(got), want) <= TOL

    def test_bf16(self):
        q, k, v = _qkv(np.random.default_rng(0), 1, 256, 256, 2, 128)
        qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16)
                      for t in (q, k, v))
        got = flash_attention(qb, kb, vb)
        assert got.dtype == torch.bfloat16
        want = flash_ref(qb.float(), kb.float(), vb.float())
        assert rel_err(got.float().numpy(), host(want)) <= 2 ** -8
        ref_bf16 = np.asarray(ref_fa.flash_attention(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
            interpret=True), np.float32)
        assert rel_err(got.float().numpy(), ref_bf16) <= 2 ** -7

    def test_validation_and_no_launch_on_cpu(self):
        q = torch.zeros((1, 8, 2, 16))
        before = dict(dispatch.LAUNCHES)
        flash_attention(q, q, q)
        assert dispatch.LAUNCHES == before
        with pytest.raises(ValueError, match="bad shapes"):
            flash_attention(q, q[:, :, :1], q[:, :, :1])
        with pytest.raises(ValueError, match="window"):
            flash_attention(q, q, q, window=-1)

    def test_kernel_entry_by_dtype(self):
        """The input dtype alone chooses the kernel: bf16 the tensor
        cores, fp32 the CUDA cores; anything else raises."""
        assert fa_ops.kernel_entry(torch.bfloat16) == \
            "repro_flash_attention_tc"
        assert fa_ops.kernel_entry(torch.float32) == "repro_flash_attention"
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fa_ops.kernel_entry(torch.float16)

    @pytest.mark.parametrize("b,s,skv,h,hd,causal,window", [
        (2, 100, 100, 3, 64, True, 0), (1, 70, 130, 2, 128, False, 33),
        (1, 257, 257, 2, 256, True, 130)])
    def test_hi_lo_split_keeps_fp32_p(self, b, s, skv, h, hd, causal,
                                      window):
        """p split into bf16(p) + bf16(p - bf16(p)) computes the fp32
        function to 2^-15; p rounded to bf16 once misses it by more than
        10x that."""
        q, k, v = (t.astype(np.float32) for t in
                   _qkv(np.random.default_rng(hd + s), b, s, skv, h, hd))
        want = _ref_flash_flat(q, k, v, causal, window)
        tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
        hi_lo = flash_ref(tq, tk, tv, causal, window, p_rounding="hi_lo")
        once = flash_ref(tq, tk, tv, causal, window, p_rounding="bf16")
        assert rel_err(host(hi_lo), want) <= 2 ** -15
        assert rel_err(host(once), want) > 10 * 2 ** -15

    def test_fp32_out_wrapper(self):
        """The check-only wrapper takes bf16 inputs and returns the fp32
        function of their values; on the CPU that is the plain version,
        with no launch."""
        q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in
                   _qkv(np.random.default_rng(3), 1, 40, 40, 2, 64))
        before = dict(dispatch.LAUNCHES)
        got = fa_ops._flash_attention_fp32_out(q, k, v, causal=True,
                                               window=16)
        assert dispatch.LAUNCHES == before
        assert got.dtype == torch.float32
        assert torch.equal(got, flash_ref(q.float(), k.float(), v.float(),
                                          True, 16))
        with pytest.raises(TypeError, match="bf16"):
            fa_ops._flash_attention_fp32_out(q.float(), k.float(),
                                             v.float())
        with pytest.raises(ValueError, match="p_rounding"):
            flash_ref(q, k, v, p_rounding="fp16")


def _wkv_inputs(rng, b, h, s, hd, scale=1.0):
    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = n(b, s, h, hd), n(b, s, h, hd), n(b, s, h, hd)
    logw = -np.exp(rng.standard_normal((b, s, h, hd))).astype(np.float32)
    return r, k, v, logw, n(h, hd), n(b, h, hd, hd)


class TestWKV:
    @pytest.mark.parametrize("b,h,s,hd,chunk", [
        (1, 1, 32, 16, 8), (2, 2, 64, 64, 16), (2, 1, 48, 32, 16),
        (1, 2, 16, 64, 64), (3, 2, 1, 32, 16), (1, 3, 37, 32, 16)])
    def test_fp32_matches_pallas_kernel(self, b, h, s, hd, chunk):
        ins = _wkv_inputs(np.random.default_rng(b * 100 + s + hd), b, h, s,
                          hd)
        want_o, want_s = ref_rs.wkv_chunked(
            *(jnp.asarray(t) for t in ins), chunk=chunk,
            compute_dtype="fp32", interpret=True)
        got_o, got_s = wkv_chunked(*(torch.from_numpy(t) for t in ins),
                                   compute_dtype="fp32")
        assert got_o.dtype == got_s.dtype == torch.float32
        assert rel_err(host(got_o), np.asarray(want_o)) <= TOL
        assert rel_err(host(got_s), np.asarray(want_s)) <= TOL
        want_o, want_s = ref_wkv_ref(*(jnp.asarray(t) for t in ins))
        assert rel_err(host(got_o), np.asarray(want_o)) <= TOL
        assert rel_err(host(got_s), np.asarray(want_s)) <= TOL

    def test_bf16_holds_reference_bar(self):
        """The reference's bf16 parity test, on the port: within 1e-3 of
        the fp32 oracle at 0.1-scale inputs, and of the reference's bf16
        kernel; out in ``r``'s dtype, state in fp32."""
        ins = _wkv_inputs(np.random.default_rng(11), 2, 2, 64, 32, scale=0.1)
        oracle, _ = ref_wkv_ref(*(jnp.asarray(t) for t in ins))
        ref_bf16, _ = ref_rs.wkv_chunked(*(jnp.asarray(t) for t in ins),
                                         chunk=16, compute_dtype="bf16",
                                         interpret=True)
        got, st = wkv_chunked(*(torch.from_numpy(t) for t in ins),
                              compute_dtype="bf16")
        assert float(np.abs(host(got) - np.asarray(oracle)).max()) <= 1e-3
        assert float(np.abs(host(got) - np.asarray(ref_bf16)).max()) <= 1e-3
        rb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16)
                      for t in ins[:3])
        out, st = wkv_chunked(rb, kb, vb, *(torch.from_numpy(t)
                                            for t in ins[3:]))
        assert out.dtype == torch.bfloat16 and st.dtype == torch.float32

    def test_validation(self):
        ins = [torch.from_numpy(t) for t in _wkv_inputs(
            np.random.default_rng(0), 1, 2, 4, 16)]
        with pytest.raises(ValueError, match="compute_dtype"):
            wkv_chunked(*ins, compute_dtype="fp16")
        with pytest.raises(ValueError, match="u must be"):
            wkv_chunked(*ins[:4], ins[4][:1], ins[5])
        with pytest.raises(ValueError, match="share one"):
            wkv_chunked(ins[0], ins[1][:, :2], *ins[2:])
        torch.testing.assert_close(wkv_chunked(*ins, compute_dtype="fp32")[0],
                                   wkv_ref(*ins)[0].to(ins[0].dtype))
        with pytest.raises(ValueError, match="compute_dtype"):
            wkv_chunked_ref(*ins, compute_dtype="fp16")

    def test_default_is_bf16_chunk_form(self):
        """The default compute dtype is bf16: on the CPU the wrapper is
        the chunk form with the reference's bf16 roundings."""
        ins = [torch.from_numpy(t) for t in _wkv_inputs(
            np.random.default_rng(0), 1, 2, 4, 16)]
        got = wkv_chunked(*ins)
        want = wkv_chunked_ref(*ins, compute_dtype="bf16")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[0], wkv_chunked(
            *ins, compute_dtype="fp32")[0])


class TestLinearScan:
    @pytest.mark.parametrize("b,s,d,chunk,block_d", [
        (1, 32, 64, 8, 64), (2, 64, 160, 16, 128), (2, 24, 32, 32, 256),
        (3, 1, 50, 8, 128), (1, 77, 300, 16, 128)])
    def test_matches_pallas_kernel(self, b, s, d, chunk, block_d):
        rng = np.random.default_rng(b * 31 + s + d)
        log_a = -np.exp(rng.standard_normal((b, s, d)) - 1).astype(
            np.float32)
        x = rng.standard_normal((b, s, d)).astype(np.float32)
        h0 = rng.standard_normal((b, d)).astype(np.float32)
        want_h, want_last = ref_rs.linear_scan(
            jnp.asarray(log_a), jnp.asarray(x), jnp.asarray(h0), chunk=chunk,
            block_d=block_d, interpret=True)
        got_h, got_last = linear_scan(torch.from_numpy(log_a),
                                      torch.from_numpy(x),
                                      torch.from_numpy(h0))
        assert got_h.dtype == got_last.dtype == torch.float32
        assert rel_err(host(got_h), np.asarray(want_h)) <= TOL
        assert rel_err(host(got_last), np.asarray(want_last)) <= TOL
        oracle_h, _ = ref_scan_ref(jnp.asarray(log_a), jnp.asarray(x),
                                   jnp.asarray(h0))
        assert rel_err(host(got_h), np.asarray(oracle_h)) <= TOL

    def test_validation(self):
        x = torch.zeros((1, 4, 8))
        with pytest.raises(ValueError, match="bad shapes"):
            linear_scan(x, x, x[:, 0, :4])
        h, h_last = linear_scan(x, x + 1, x[:, 0])
        torch.testing.assert_close(h, linear_scan_ref(x, x + 1, x[:, 0])[0])
        assert torch.equal(h_last, h[:, -1])
