"""The port's optimizers (``repro_torch.optim``) against the reference's
on the same random parameter dicts, to 1e-6 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import host, t
from repro import optim as ref_optim
from repro_torch import optim

SHAPES = {"conv1.weight": (3, 2, 5, 5), "conv1.bias": (3,),
          "head.weight": (4, 7), "head.bias": (4,)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    return ({k: t(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def _close(port, ref, rtol=1e-6):
    for k in ref:
        want = np.asarray(ref[k])
        np.testing.assert_allclose(host(port[k]), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05)),
    ("momentum", dict(lr=0.05)),
    ("momentum", dict(lr=0.01, beta=0.5)),
    ("adamw", dict(lr=1e-2)),
    ("adamw", dict(lr=1e-2, weight_decay=0.1)),
    ("sgd", dict(lr="cosine")),
    ("adamw", dict(lr="warmup", weight_decay=0.05)),
])
def test_five_steps_match_reference(name, kw):
    kw = dict(kw)
    if kw["lr"] == "cosine":
        kw["lr"], ref_lr = (optim.cosine_schedule(0.1, 4),
                            ref_optim.cosine_schedule(0.1, 4))
    elif kw["lr"] == "warmup":
        kw["lr"], ref_lr = (optim.warmup_cosine_schedule(0.1, 2, 6),
                            ref_optim.warmup_cosine_schedule(0.1, 2, 6))
    else:
        ref_lr = kw["lr"]
    opt = getattr(optim, name)(**kw)
    ref_opt = getattr(ref_optim, name)(**dict(kw, lr=ref_lr))
    params, ref_params = _trees(0)
    state, ref_state = opt.init(params), ref_opt.init(ref_params)
    assert int(state.step) == 0
    for step in range(5):
        grads, ref_grads = _trees(step + 1)
        upd, state = opt.update(grads, state, params)
        ref_upd, ref_state = ref_opt.update(ref_grads, ref_state, ref_params)
        _close(upd, ref_upd)
        params = optim.apply_updates(params, upd)
        ref_params = ref_optim.apply_updates(ref_params, ref_upd)
        _close(params, ref_params)
    assert int(state.step) == int(ref_state.step) == 5
    assert all(v.dtype == torch.float32 for v in params.values())


@pytest.mark.parametrize("sched", [
    lambda m: m.constant_schedule(0.3),
    lambda m: m.cosine_schedule(0.1, 10),
    lambda m: m.cosine_schedule(0.2, 7, final_frac=0.0),
    lambda m: m.warmup_cosine_schedule(0.1, 3, 12),
    lambda m: m.warmup_cosine_schedule(0.05, 0, 5, final_frac=0.2),
])
def test_schedules_match_reference(sched):
    port, ref = sched(optim), sched(ref_optim)
    for step in range(16):
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree, ref_tree = _trees(7)
    assert float(optim.global_norm(tree)) == pytest.approx(
        float(ref_optim.global_norm(ref_tree)), rel=1e-6)
    _close(optim.clip_by_global_norm(tree, max_norm),
           ref_optim.clip_by_global_norm(ref_tree, max_norm))
