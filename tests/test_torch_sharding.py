"""The port's sharding rules (``launch/sharding.py``) and the models'
shard hooks against the JAX package's, on the reference's shape-only
``AbstractMesh`` (the spec functions read only axis names and sizes).

* Parameter specs of every LM arch at published widths, on the pod
  (16 x 16) and multipod (2 x 16 x 16) meshes, with FSDP on and off,
  equal the reference's with its stacked layer axis dropped (the
  reference's tree mapped to port names by ``convert.reference_named``).
* Decode-state and batch specs, for every input shape.
* The activation constraints: the models call ``shard`` in the
  reference's order with its shapes (the reference unrolled,
  ``scan_layers=False``; the port on fake tensors), and every call gets
  the same spec from both ``make_shard_fn``s in every activation mode
  (the reference's ``with_sharding_constraint`` patched to hand back
  its spec).
* ``TestShardingRules``' cases, and the placements of a spec.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RefP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import get_arch as ref_get_arch
from repro.launch import sharding as ref_SH
from repro.launch import steps as ref_ST
from repro.models.registry import get_model as ref_get_model
from repro_torch import convert
from repro_torch.configs.base import INPUT_SHAPES, PORTED_ARCH_IDS, get_arch
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models.registry import get_model

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("dp", "seq", "tensor", "megatron")


def amesh(kind: str) -> AbstractMesh:
    return AbstractMesh(*MESHES[kind])


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name (JAX's
    ``PartitionSpec`` reads ``("data",)`` back as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """Both packages' shape-only parameters at published widths, built
    once an arch."""
    return (ref_ST.abstract_params(ref_get_arch(arch)),
            ST.abstract_params(get_arch(arch)))


class _Lead:
    """A reference spec standing in for its stacked leaf: indexing it by
    a layer (``reference_named``) drops the stacked lead."""

    def __init__(self, spec):
        self.spec = _norm(spec)

    def __getitem__(self, layer):
        return self.spec[1:]


def _ref_params_by_name(cfg, tree) -> dict:
    wrapped = jax.tree.map(_Lead, tree, is_leaf=lambda x: isinstance(
        x, RefP))
    return {k: v.spec if isinstance(v, _Lead) else _norm(v)
            for k, v in convert.reference_named(cfg, wrapped).items()}


# ---------------------------------------------------------------------------
# Parameters, states, batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    cfg = get_arch(arch)
    ref_params, params = _abstract(arch)
    want = _ref_params_by_name(cfg, ref_SH.param_specs(
        ref_params, amesh(mesh), ref_SH.ShardingOptions(fsdp=fsdp)))
    got = SH.param_specs(cfg, params, amesh(mesh),
                         SH.ShardingOptions(fsdp=fsdp))
    assert {k: _norm(v) for k, v in got.items()} == \
        {k: _norm(v) for k, v in want.items()}


def _ref_layer_specs(cfg, tree) -> list:
    """The reference's decode-state specs -> one dict a layer, in the
    port's layer order, with the stacked lead dropped."""
    if "groups" not in tree and "groups_unrolled" not in tree:
        return []
    width = len(cfg.block_pattern)
    out = []
    for g in range(cfg.n_groups):
        for j in range(width):
            out.append({k: _norm(v)[1:] if len(v) else ()
                        for k, v in tree["groups"][str(j)].items()})
    for j in range(len(cfg.rest_kinds)):
        out.append({k: _norm(v) for k, v in tree["rest"][str(j)].items()})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_state_and_batch_specs_match_reference(arch, mesh):
    am = amesh(mesh)
    for name, shape in INPUT_SHAPES.items():
        ref_cfg = ref_ST.variant_for_shape(ref_get_arch(arch),
                                           REF_SHAPES[name])
        cfg = ST.variant_for_shape(get_arch(arch), shape)
        assert cfg.attn_window == ref_cfg.attn_window
        # batches
        want_b = ref_SH.batch_specs(ref_ST.input_specs(ref_cfg,
                                                       REF_SHAPES[name]), am)
        got_b = SH.batch_specs(ST.input_specs(cfg, shape), am)
        assert {k: _norm(v) for k, v in got_b.items()} == \
            {k: _norm(v) for k, v in want_b.items()}
        if shape.kind != "decode":
            continue
        want = ref_SH.state_specs(ref_ST.abstract_decode_state(
            ref_cfg, REF_SHAPES[name]), am)
        got = SH.state_specs(ST.abstract_decode_state(cfg, shape), am)
        assert tuple(got["length"]) == tuple(want["length"]) == ()
        if cfg.encoder_layers:
            for key in ("mem_k", "mem_v"):
                assert _norm(got[key]) == _norm(want[key])
            for key in ("k", "v"):
                assert _norm(got["self"][key]) == _norm(want["self"][key])
            continue
        layers = [{k: _norm(v) for k, v in st.items()}
                  for st in got["layers"]]
        assert layers == _ref_layer_specs(cfg, want), name


# ---------------------------------------------------------------------------
# Activation constraints: call order, shapes and specs
# ---------------------------------------------------------------------------

def _cut(cfg):
    """Two pattern groups and the remainder layers, the other widths the
    published ones; the reference unrolled, and without remat (a
    ``jax.checkpoint`` body traced once is replayed for a second layer of
    the same shapes, so its calls would not show)."""
    pat = len(cfg.block_pattern)
    n = 2 * pat + cfg.n_layers % pat
    kw = dict(n_layers=n, scan_layers=False, remat=False)
    if cfg.encoder_layers:
        kw = dict(n_layers=2, encoder_layers=2, scan_layers=False,
                  remat=False)
    return dataclasses.replace(cfg, **kw)


def _recorder(log):
    def shard(x, name):
        log.append((name, tuple(x.shape)))
        return x
    return shard


def _ref_calls(arch, shape_name):
    shape = REF_SHAPES[shape_name]
    cfg = _cut(ref_ST.variant_for_shape(ref_get_arch(arch), shape))
    m = ref_get_model(cfg)
    params = ref_ST.abstract_params(cfg)
    batch = ref_ST.input_specs(cfg, shape)
    log: list = []
    if shape.kind == "decode":
        state = ref_ST.abstract_decode_state(cfg, shape)
        jax.eval_shape(lambda p, t, s: m.decode_step(p, t, s,
                                                     _recorder(log)),
                       params, batch["tokens"], state)
    else:
        jax.eval_shape(lambda p, b: m.loss_fn(p, b, _recorder(log)),
                       params, batch)
    return log


def _port_calls(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = _cut(ST.variant_for_shape(get_arch(arch), shape))
    m = get_model(cfg)
    log: list = []
    with FakeTensorMode():
        model = ST.abstract_params(cfg)
        batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in ST.input_specs(cfg, shape).items()}
        with torch.no_grad():
            if shape.kind == "decode":
                state = ST.abstract_decode_state(cfg, shape)
                m.decode_step(model, batch["tokens"], state, _recorder(log))
            else:
                m.loss_fn(model, batch, _recorder(log))
    return log


def _ref_spec(mesh, mode, shape, name, monkeypatch):
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: _norm(s.spec))
    out = ref_SH.make_shard_fn(mesh, ref_SH.ShardingOptions(
        activation_mode=mode))(jax.ShapeDtypeStruct(shape, jnp.float32),
                               name)
    return out if isinstance(out, tuple) else None


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_activation_calls_and_specs_match_reference(arch, monkeypatch):
    for shape_name in ("train_4k", "decode_32k", "long_500k"):
        want = _ref_calls(arch, shape_name)
        got = _port_calls(arch, shape_name)
        assert got == want, shape_name
        for mesh in MESHES:
            am = amesh(mesh)
            for mode in MODES:
                port_shard = SH.make_shard_fn(am, SH.ShardingOptions(
                    activation_mode=mode))
                for name, shape in set(got):
                    spec = port_shard.spec(shape, name)
                    assert (None if spec is None else _norm(spec)) == \
                        _ref_spec(am, mode, shape, name, monkeypatch), \
                        (shape_name, mesh, mode, name, shape)


# ---------------------------------------------------------------------------
# The reference's TestShardingRules, and placements
# ---------------------------------------------------------------------------

class FakeMesh:
    shape = {"model": 16, "data": 16}


class TestShardingRules:
    def setup_method(self):
        self.mesh = AbstractMesh((1, 1), ("data", "model"))

    def test_first_fitting_falls_back(self):
        spec = SH.first_fitting((8,), [SH.P("model"), SH.P()], self.mesh)
        assert spec == SH.P("model")  # size-1 axis always divides
        assert SH.first_fitting((8,), [SH.P("model"), SH.P()],
                                FakeMesh()) == SH.P()

    def test_divides_math(self):
        assert SH._divides(SH.P("model"), (16,), self.mesh)
        assert not SH._divides(SH.P("model"), (8,), FakeMesh())
        assert SH._divides(SH.P("model"), (32,), FakeMesh())
        assert not SH._divides(SH.P(("data", "model")), (64,), FakeMesh())
        assert SH._divides(SH.P(("data", "model")), (256,), FakeMesh())

    def test_batch_specs(self):
        batch = {"tokens": ST.Spec((8, 16), torch.int32)}
        specs = SH.batch_specs(batch, self.mesh)
        assert specs["tokens"] == SH.P(("data",), None)


class TestPlacements:
    def test_spec_to_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        mesh = AbstractMesh((2, 4), ("data", "model"))
        assert SH.placements(mesh, SH.P(None, "model")) == [Replicate(),
                                                            Shard(1)]
        assert SH.placements(mesh, SH.P("model", "data")) == [Shard(1),
                                                              Shard(0)]
        # one dim over two axes in mesh order: data-major
        assert SH.placements(mesh, SH.P(("data", "model"))) == [Shard(0),
                                                                Shard(0)]
        assert SH.placements(mesh, SH.P()) == [Replicate(), Replicate()]

    @pytest.mark.parametrize("spec", [SH.P(("model", "data")),
                                      SH.P("model", "model")])
    def test_unexpressible_specs_raise(self, spec):
        with pytest.raises(ValueError):
            SH.placements(AbstractMesh((2, 4), ("data", "model")), spec)

    def test_identity_on_plain_tensors(self):
        shard = SH.make_shard_fn(AbstractMesh((2, 4), ("data", "model")))
        x = torch.zeros(4, 8, 16)
        assert shard(x, "residual") is x
