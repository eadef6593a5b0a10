"""The paper's CNN and MLP in the port against the reference on the
reference's own weights: logits, loss, every parameter's gradient
(``fc1``'s catches a wrong flatten order) and accuracy, to 1e-5 x max.
Also the port's own init, on its statistics, and the conversion's names
and shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import CPU, host, t
from repro.configs import paper_cnn as ref_paper_cnn
from repro.configs import paper_mlp as ref_paper_mlp
from repro.models import cnn as ref_cnn
from repro.models import mlp as ref_mlp
from repro_torch import convert
from repro_torch.configs import paper_cnn, paper_mlp
from repro_torch.models import cnn, mlp

CASES = {
    "cnn-reduced": (ref_cnn, cnn, ref_paper_cnn.REDUCED, paper_cnn.REDUCED,
                    convert.paper_cnn_params_from_reference),
    "cnn-config": (ref_cnn, cnn, ref_paper_cnn.CONFIG, paper_cnn.CONFIG,
                   convert.paper_cnn_params_from_reference),
    "mlp-config": (ref_mlp, mlp, ref_paper_mlp.CONFIG, paper_mlp.CONFIG,
                   convert.paper_mlp_params_from_reference),
    "mlp-reduced": (ref_mlp, mlp, ref_paper_mlp.REDUCED, paper_mlp.REDUCED,
                    convert.paper_mlp_params_from_reference),
}

# Reference leaf -> port name, and how the port lays the gradient out.
LAYOUT = {4: (3, 2, 0, 1), 2: (1, 0), 1: None}


def _inputs(ref_cfg, seed=0, batch=6):
    m = (int(np.prod(ref_cfg.image_hw)) if hasattr(ref_cfg, "image_hw")
         else ref_cfg.m)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, m)).astype(np.float32)
    y = rng.integers(0, ref_cfg.n_classes, batch).astype(np.int32)
    return x, y


def _assert_close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(host(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_grads_accuracy_match_reference(case):
    ref_mod, mod, ref_cfg, cfg, to_port = CASES[case]
    ref_params = ref_mod.init(ref_cfg, jax.random.PRNGKey(3))
    params = to_port(ref_params, cfg, device=CPU)
    x, y = _inputs(ref_cfg)
    batch = {"x": t(x), "y": torch.from_numpy(y)}
    ref_batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    ref_logits = jax.jit(lambda p, x: ref_mod.apply(ref_cfg, p, x))(
        ref_params, ref_batch["x"])
    _assert_close(mod.apply(cfg, params, batch["x"]), ref_logits)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        ref_mod.loss_fn(ref_cfg)))(ref_params, ref_batch)
    grads, loss = torch.func.grad_and_value(mod.loss_fn(cfg))(params, batch)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for layer, leaves in ref_grads.items():
        for leaf, g in leaves.items():
            g = np.asarray(g)
            perm = LAYOUT[g.ndim]
            want = g if perm is None else np.transpose(g, perm)
            name = f"{layer}.{'weight' if leaf == 'w' else 'bias'}"
            _assert_close(grads[name], want)
    ref_acc = float(np.mean(np.argmax(np.asarray(ref_logits), -1) == y))
    assert mod.accuracy(cfg, params, x, y) == pytest.approx(ref_acc)


def test_cnn_flatten_order_is_the_reference_s():
    """Swapping fc1's input order to the port's native (c, h, w) leaves the
    loss of one sample class-balanced input close but moves fc1's
    gradient: the guard the parity test above relies on."""
    ref_cfg, cfg = ref_paper_cnn.REDUCED, paper_cnn.REDUCED
    ref_params = ref_cnn.init(ref_cfg, jax.random.PRNGKey(1))
    params = convert.paper_cnn_params_from_reference(ref_params, cfg,
                                                     device=CPU)
    w = params["fc1.weight"].reshape(cfg.fc1, 5, 5, cfg.c2)
    wrong = dict(params, **{"fc1.weight":
                            w.permute(0, 3, 1, 2).reshape(cfg.fc1, -1)})
    x, y = _inputs(ref_cfg, seed=2)
    batch = {"x": t(x), "y": torch.from_numpy(y)}
    good = torch.func.grad(cnn.loss_fn(cfg))(params, batch)["fc1.weight"]
    bad = torch.func.grad(cnn.loss_fn(cfg))(wrong, batch)["fc1.weight"]
    assert not torch.allclose(good, bad, atol=1e-3)


@pytest.mark.parametrize("case", CASES)
def test_conversion_names_and_shapes_equal_port_init(case):
    ref_mod, mod, ref_cfg, cfg, to_port = CASES[case]
    converted = to_port(ref_mod.init(ref_cfg, jax.random.PRNGKey(0)), cfg,
                        device=CPU)
    own = mod.init(cfg, 0)
    assert list(converted) == list(own)
    for k in own:
        assert converted[k].shape == own[k].shape
        assert converted[k].dtype == own[k].dtype == torch.float32


def test_conversion_rejects_wrong_config():
    params = ref_cnn.init(ref_paper_cnn.REDUCED, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="shape"):
        convert.paper_cnn_params_from_reference(params, paper_cnn.CONFIG,
                                                device=CPU)
    params = ref_mlp.init(ref_paper_mlp.REDUCED, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="shape"):
        convert.paper_mlp_params_from_reference(params, paper_mlp.CONFIG,
                                                device=CPU)


@pytest.mark.parametrize("mod,cfg,large", [
    (cnn, paper_cnn.CONFIG, {"conv2.weight": 150, "fc1.weight": 400,
                             "fc2.weight": 120}),
    (mlp, paper_mlp.CONFIG, {"fc1.weight": 784}),
])
def test_port_init_statistics(mod, cfg, large):
    """He-normal init: zero biases; on the large layers the weight std is
    within 5% of sqrt(2 / fan_in) (tens of thousands of draws, so the
    sampling error is well under 1%)."""
    params = mod.init(cfg, torch.Generator().manual_seed(0))
    for name, v in params.items():
        if name.endswith(".bias"):
            assert torch.count_nonzero(v) == 0
    for name, fan_in in large.items():
        std = float(params[name].std())
        assert std == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.05), name
    again = mod.init(cfg, torch.Generator().manual_seed(0))
    other = mod.init(cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert not torch.equal(params["head.weight"], other["head.weight"])
