"""The port's step factories and abstract trees (``launch/steps.py``)
against the JAX package's.

* Every arch x input shape: ``variant_for_shape``, the ``input_specs``
  shapes and dtypes, and the shapes of ``abstract_params`` (mapped to
  port names by ``convert.reference_named``, the stacked lead dropped)
  and ``abstract_decode_state`` equal the reference's.
* On a one-rank gloo mesh (1, 1), REDUCED qwen3 and rwkv6 on the
  reference's weights: the loss and the parameters after one AdamW step
  of ``make_train_step`` (eps 1e-4, see ``EPS``),
  ``make_prefill_step``'s last-position logits,
  and 6 greedy tokens of ``make_serve_step`` equal the reference's
  ``make_*_step`` under ``jax.jit`` on a (1, 1) CPU mesh, within 1e-5
  (the tokens exactly).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_support as support
from _torch_lm_support import arch_pair
from repro import optim as ref_optim
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import get_arch as ref_get_arch
from repro.launch import steps as ref_ST
from repro.models.registry import get_model as ref_get_model
from repro_torch import convert, optim
from repro_torch.configs.base import INPUT_SHAPES, PORTED_ARCH_IDS, get_arch
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models.registry import get_model

TOL = 1e-5
B, S, GEN = 2, 16, 6
# AdamW's first update is -lr g / (|g| + eps): at the default eps 1e-8 it
# is the sign of a gradient near 1e-9, which an fp32 rounding flips (a
# gap of up to lr); eps 1e-4 keeps the update a smooth function of g
LR, EPS = 1e-3, 1e-4


class _Lead:
    """A stacked reference leaf: indexing it by a layer
    (``reference_named``) drops the stacked lead of its shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, layer):
        return self.shape[1:]


def _ref_shapes_by_name(cfg, tree) -> dict:
    wrapped = jax.tree.map(lambda l: _Lead(l.shape), tree)
    return {k: v.shape if isinstance(v, _Lead) else tuple(v)
            for k, v in convert.reference_named(cfg, wrapped).items()}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (ref_ST.abstract_params(ref_get_arch(arch)),
            ST.abstract_params(get_arch(arch)))


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_abstract_trees_match_reference(arch, shape_name):
    shape, ref_shape = INPUT_SHAPES[shape_name], REF_SHAPES[shape_name]
    ref_cfg = ref_ST.variant_for_shape(ref_get_arch(arch), ref_shape)
    cfg = ST.variant_for_shape(get_arch(arch), shape)
    assert (cfg.attn_window, cfg is get_arch(arch)) == \
        (ref_cfg.attn_window, ref_cfg is ref_get_arch(arch))
    want = ref_ST.input_specs(ref_cfg, ref_shape)
    got = ST.input_specs(cfg, shape)
    assert {k: (tuple(s.shape), _dtype_name(s.dtype))
            for k, s in got.items()} == \
        {k: (tuple(s.shape), _dtype_name(s.dtype)) for k, s in want.items()}

    ref_params, params = _params(arch)
    assert {k: tuple(p.shape) for k, p in params.named_parameters()} == \
        _ref_shapes_by_name(cfg, ref_params)

    if shape.kind != "decode":
        return
    ref_state = ref_ST.abstract_decode_state(ref_cfg, ref_shape)
    state = ST.abstract_decode_state(cfg, shape)
    if cfg.encoder_layers:
        for key in ("mem_k", "mem_v"):
            assert tuple(state[key].shape) == ref_state[key].shape
        for key in ("k", "v"):
            assert tuple(state["self"][key].shape) == \
                ref_state["self"][key].shape
        return
    width = len(cfg.block_pattern)
    want_layers = [{k: v.shape[1:] for k, v in
                    ref_state["groups"][str(j)].items()}
                   for _ in range(cfg.n_groups) for j in range(width)]
    want_layers += [{k: v.shape for k, v in ref_state["rest"][str(j)]
                     .items()} for j in range(len(cfg.rest_kinds))]
    assert [{k: tuple(v.shape) for k, v in st.items()}
            for st in state["layers"]] == want_layers


# ---------------------------------------------------------------------------
# The steps on a (1, 1) mesh
# ---------------------------------------------------------------------------

def _jax_mesh():
    """The reference's (1, 1) CPU mesh, with the Auto axes its sharding
    constraints need."""
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@pytest.fixture(scope="module", params=["qwen3_1_7b", "rwkv6_1_6b"])
def pair(request):
    ref_cfg, cfg = arch_pair(request.param)
    ref_m = ref_get_model(ref_cfg)
    return ref_cfg, cfg, ref_m, ref_m.init(jax.random.PRNGKey(0))


def _port_model(cfg, ref_params, mesh, grad=False):
    model = convert.lm_params_from_reference(cfg, ref_params, device="cpu")
    model.requires_grad_(grad)
    return SH.attach(model, SH.param_specs(cfg, model, mesh), mesh)


def _dbatch(batch, mesh):
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    return SH.attach(b, SH.batch_specs(b, mesh), mesh)


def test_train_step_matches_reference(pair):
    ref_cfg, cfg, ref_m, ref_params = pair
    batch = _batch(cfg)
    jmesh = _jax_mesh()
    ref_opt = ref_optim.adamw(LR, eps=EPS)
    with jmesh:
        p2, _, met = jax.jit(ref_ST.make_train_step(ref_cfg, jmesh, ref_opt))(
            ref_params, ref_opt.init(ref_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.reference_named(cfg, jax.tree.map(np.asarray, p2))
    with support.gloo_world() as mesh:
        model = _port_model(cfg, ref_params, mesh, grad=True)
        opt = optim.adamw(LR, eps=EPS)
        state = opt.init({k: p.detach()
                          for k, p in model.named_parameters()})
        step = ST.make_train_step(cfg, mesh, opt)
        state, out = step(model, state, _dbatch(batch, mesh))
        assert float(out["loss"]) == pytest.approx(float(met["loss"]),
                                                   abs=TOL)
        got = {k: ST.to_full(p).detach().numpy()
               for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            assert state.inner["m"][k].placements == p.placements
    worst = max(float(np.max(np.abs(got[k] - np.asarray(want[k]))))
                for k in got)
    assert worst < TOL


def test_prefill_step_matches_reference(pair):
    ref_cfg, cfg, ref_m, ref_params = pair
    batch = _batch(cfg)
    jmesh = _jax_mesh()
    with jmesh:
        want = np.asarray(jax.jit(ref_ST.make_prefill_step(ref_cfg, jmesh))(
            ref_params, {"tokens": jnp.asarray(batch["tokens"])}))
    with support.gloo_world() as mesh:
        model = _port_model(cfg, ref_params, mesh)
        got = ST.make_prefill_step(cfg, mesh)(
            model, _dbatch({"tokens": batch["tokens"]}, mesh))
        got = ST.to_full(got).numpy()
    assert got.shape == want.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_serve_step_matches_reference(pair):
    ref_cfg, cfg, ref_m, ref_params = pair
    first = _batch(cfg)["tokens"][:, :1]
    jmesh = _jax_mesh()
    with jmesh:
        serve = jax.jit(ref_ST.make_serve_step(ref_cfg, jmesh))
        st, tok, want = ref_m.init_decode_state(B, 32), jnp.asarray(first), []
        for _ in range(GEN):
            nxt, st = serve(ref_params, st, {"tokens": tok})
            want.append(np.asarray(nxt))
            tok = nxt[:, None]
    m = get_model(cfg)
    with support.gloo_world() as mesh:
        model = _port_model(cfg, ref_params, mesh)
        state = m.init_decode_state(B, 32, device="cpu")
        state = SH.attach(state, SH.state_specs(state, mesh), mesh)
        serve = ST.make_serve_step(cfg, mesh)
        tok, got = torch.from_numpy(first), []
        for _ in range(GEN):
            nxt, state = serve(model, state,
                               _dbatch({"tokens": tok.numpy()}, mesh))
            nxt = ST.to_full(nxt)
            got.append(nxt.numpy())
            tok = nxt[:, None]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_moe_apply_runs_under_fake_tensors():
    """``moe_apply``'s dispatch is shape-static: it runs on fake tensors
    (no data) at phi3_5_moe's published widths, as the dry run needs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = get_arch("phi3_5_moe")
    with FakeTensorMode():
        gen = torch.Generator().manual_seed(0)
        p = T.Params(moe.moe_init(gen, T.moe_config(cfg), torch.bfloat16))
        x = torch.zeros((2, 4096, cfg.d_model), dtype=torch.bfloat16)
        out, aux = moe.moe_apply(p, T.moe_config(cfg), x)
    assert tuple(out.shape) == (2, 4096, cfg.d_model)
    assert out.dtype == torch.bfloat16 and tuple(aux.shape) == ()
