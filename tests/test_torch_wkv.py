"""The wkv kernel's chunk form (``wkv_chunked_ref``) against the JAX
package's Pallas ``wkv_chunked`` (interpret mode) and its sequential
oracle ``wkv_ref``, on the same numpy inputs.

The CUDA kernel computes the chunk form over sub-chunks of 16 tokens with
the roundings of ``wkv_chunked_ref`` (held to it on the card in
``test_torch_kernels_gpu.py``); on the CPU the wrapper runs it.
Tolerances: under fp32 compute the chunk form sums in another order than
the oracle and the reference's kernel, so out and state agree with both to
1e-5 of the largest entry; under the strong decays the reference's kernel
(64-token chunks) itself misses the oracle by more, and the port is held
to the oracle at 1e-5 and to be at least as close to it as that kernel.
Under bf16 compute the error against the fp32 oracle is at most twice that of the reference's own bf16 kernel (chunk 64,
the RWKV-6 config's) on the same inputs, out and state.  Decays reach
``-exp(randn + 2)`` (about -400 over a sub-chunk): nothing may overflow
or turn into NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import rel_err
from _torch_support import host
from repro.kernels.recurrent_scan import ops as ref_rs
from repro.kernels.recurrent_scan.ref import wkv_ref as ref_wkv_ref
from repro_torch.kernels.recurrent_scan import (wkv_chunked, wkv_chunked_ref,
                                                wkv_ref)

TOL = 1e-5
LENGTHS = [1, 15, 16, 17, 37, 64, 200]


def _inputs(s, hd, strong, seed, b=1, h=2):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = n(b, s, h, hd), n(b, s, h, hd), n(b, s, h, hd)
    logw = -np.exp(n(b, s, h, hd) + (2.0 if strong else 0.0))
    return r, k, v, logw.astype(np.float32), n(h, hd), n(b, h, hd, hd)


def _cases():
    for s in LENGTHS:
        for hd in (32, 64):
            yield s, hd, False
    for s in (17, 64, 200):
        for hd in (32, 64):
            yield s, hd, True


@pytest.mark.parametrize("s,hd,strong", list(_cases()))
def test_chunk_form_against_reference(s, hd, strong):
    ins = _inputs(s, hd, strong, seed=s * 7 + hd + strong)
    j_ins = [jnp.asarray(a) for a in ins]
    t_ins = [torch.from_numpy(a) for a in ins]
    oracle_o, oracle_s = (np.asarray(a) for a in ref_wkv_ref(*j_ins))

    got_o, got_s = wkv_chunked_ref(*t_ins, compute_dtype="fp32")
    assert bool(torch.isfinite(got_o).all() and torch.isfinite(got_s).all())
    want_o, want_s = (np.asarray(a) for a in ref_rs.wkv_chunked(
        *j_ins, chunk=64, compute_dtype="fp32", interpret=True))
    assert rel_err(host(got_o), oracle_o) <= TOL
    assert rel_err(host(got_s), oracle_s) <= TOL
    if not strong:
        assert rel_err(host(got_o), want_o) <= TOL
        assert rel_err(host(got_s), want_s) <= TOL
    else:
        # The reference's kernel takes e^{cum_prev - cum} over 64 tokens,
        # where cum reaches several hundred and its fp32 rounding (about
        # 1e-4) moves the ratio: it misses its own oracle by up to 2.6e-5.
        # The 16-token sub-chunks keep the port at least as close.
        assert rel_err(host(got_o), oracle_o) <= rel_err(want_o, oracle_o)
        assert rel_err(host(got_s), oracle_s) <= max(
            rel_err(want_s, oracle_s), 1e-6)
    # The port's own oracle is the reference's.
    port_o, port_s = wkv_ref(*t_ins)
    assert rel_err(host(port_o), oracle_o) <= TOL
    assert rel_err(host(port_s), oracle_s) <= TOL

    got_o, got_s = wkv_chunked_ref(*t_ins, compute_dtype="bf16")
    assert bool(torch.isfinite(got_o).all() and torch.isfinite(got_s).all())
    ref_o, ref_s = (np.asarray(a) for a in ref_rs.wkv_chunked(
        *j_ins, chunk=64, compute_dtype="bf16", interpret=True))
    for got, ref, oracle in ((got_o, ref_o, oracle_o),
                             (got_s, ref_s, oracle_s)):
        gap = float(np.abs(host(got) - oracle).max())
        ref_gap = float(np.abs(ref - oracle).max())
        assert gap <= 2 * ref_gap, (gap, ref_gap)


@pytest.mark.parametrize("sub", [1, 5, 16, 64])
def test_sub_chunk_length_is_the_same_function(sub):
    """Under fp32 compute any sub-chunk length gives the oracle's
    function (1e-5), the state passed between sub-chunks."""
    ins = [torch.from_numpy(a) for a in _inputs(45, 32, False, seed=sub)]
    want_o, want_s = wkv_ref(*ins)
    got_o, got_s = wkv_chunked_ref(*ins, sub=sub, compute_dtype="fp32")
    assert rel_err(host(got_o), host(want_o)) <= TOL
    assert rel_err(host(got_s), host(want_s)) <= TOL


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_wrapper_on_cpu_is_the_chunk_form(compute_dtype):
    """The wrapper on CPU tensors is ``wkv_chunked_ref`` at the caller's
    compute dtype, its output in ``r``'s dtype and its state in fp32;
    an empty sequence returns the state unchanged."""
    ins = [torch.from_numpy(a) for a in _inputs(23, 32, False, seed=3)]
    got_o, got_s = wkv_chunked(*ins, compute_dtype=compute_dtype)
    want_o, want_s = wkv_chunked_ref(*ins, compute_dtype=compute_dtype)
    assert torch.equal(got_o, want_o) and torch.equal(got_s, want_s)
    rb, kb, vb = (a.to(torch.bfloat16) for a in ins[:3])
    out, st = wkv_chunked(rb, kb, vb, *ins[3:], compute_dtype=compute_dtype)
    assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(out, wkv_chunked_ref(
        rb, kb, vb, *ins[3:], compute_dtype=compute_dtype)[0].bfloat16())
    empty = [a[:, :0] for a in ins[:4]]
    out, st = wkv_chunked(*empty, *ins[4:], compute_dtype=compute_dtype)
    assert out.shape == (1, 0, 2, 32) and torch.equal(st, ins[5])


def test_bf16_rounds_the_products_operands():
    """bf16 compute differs from fp32 compute by about bf16's resolution,
    not by nothing: the roundings are live."""
    ins = [torch.from_numpy(a) for a in _inputs(64, 64, False, seed=9)]
    o32, _ = wkv_chunked_ref(*ins, compute_dtype="fp32")
    o16, _ = wkv_chunked_ref(*ins, compute_dtype="bf16")
    gap = float((o16 - o32).abs().max()) / float(o32.abs().max())
    assert 1e-4 < gap < 2 ** -5, gap
