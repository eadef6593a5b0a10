"""The port's IFCA baseline (``repro_torch.fed.ifca``) against the
reference's ``run_ifca`` with the reference's initial models injected:
the same numpy batch stream, assignments equal every round, final
parameters to 1e-5, bytes equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_support import CPU
from repro.data import partition as ref_dpart
from repro.fed import client as ref_client
from repro.fed import ifca as ref_ifca
from repro.models import mlp as ref_mlp
from repro_torch import convert
from repro_torch.fed import ifca
from repro_torch.models import mlp

REF_MCFG = ref_mlp.PaperMLPConfig(m=784, hidden=16, n_classes=10)
MCFG = mlp.PaperMLPConfig(m=784, hidden=16, n_classes=10)


def _label_fn(u):
    return u.y.astype(np.int32)


def _run_both(users, ref_cfg):
    ref = ref_ifca.run_ifca(users, lambda k: ref_mlp.init(REF_MCFG, k),
                            ref_mlp.loss_fn(REF_MCFG), _label_fn, ref_cfg)
    keys = jax.random.split(jax.random.PRNGKey(ref_cfg.seed),
                            ref_cfg.n_clusters)
    init = [convert.paper_mlp_params_from_reference(
        ref_mlp.init(REF_MCFG, k), REF_MCFG, device=CPU) for k in keys]
    port = ifca.run_ifca(users, lambda g: mlp.init(MCFG, g),
                         mlp.loss_fn(MCFG), _label_fn,
                         convert.ifca_config_from_reference(ref_cfg),
                         init_params=init, device=CPU)
    return ref, port


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_run_ifca_matches_reference(opt):
    """Fashion-MNIST's three-task layout at 5% scale: users of 64, 30 and
    15 samples, so the evaluation slices are ragged (the port's per-user
    loop) and the smaller users' batches are narrower (min(batch, n)),
    so their members train one at a time."""
    users = ref_dpart.paper_fmnist_three_task(seed=0, scale=0.05)
    ref_cfg = ref_ifca.IFCAConfig(
        n_clusters=3, rounds=3, local_steps=4,
        client=ref_client.ClientConfig(lr=0.05, optimizer=opt))
    ref, port = _run_both(users, ref_cfg)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert port.assignments.shape == (3, len(users))
    assert port.per_user_bytes_per_round == ref.per_user_bytes_per_round
    for got, want in zip(port.final_params, ref.final_params):
        want = convert.paper_mlp_params_from_reference(want, REF_MCFG,
                                                       device=CPU)
        for k, v in want.items():
            err = float((got[k] - v).abs().max())
            assert err <= 1e-5 * max(float(v.abs().max()), 1.0), (k, err)


def test_run_ifca_stacked_members_match_reference():
    """Users alike in size: every member's batches stack, so a cluster's
    local round is one vmapped ``fused_lps_round``."""
    users = [dataclasses.replace(u, x=u.x[:40], y=u.y[:40])
             for u in ref_dpart.paper_fmnist_three_task(seed=1, scale=0.05)
             if u.n >= 40]
    ref_cfg = ref_ifca.IFCAConfig(n_clusters=2, rounds=2, local_steps=3,
                                  batch_size=16, seed=3)
    ref, port = _run_both(users, ref_cfg)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    for got, want in zip(port.final_params, ref.final_params):
        want = convert.paper_mlp_params_from_reference(want, REF_MCFG,
                                                       device=CPU)
        for k, v in want.items():
            assert float((got[k] - v).abs().max()) <= \
                1e-5 * max(float(v.abs().max()), 1.0)


def test_run_ifca_own_init_and_device():
    users = ref_dpart.paper_fmnist_three_task(seed=0, scale=0.05)[:4]
    cfg = ifca.IFCAConfig(n_clusters=2, rounds=1, local_steps=2)
    a = ifca.run_ifca(users, lambda g: mlp.init(MCFG, g), mlp.loss_fn(MCFG),
                      _label_fn, cfg, device=CPU)
    b = ifca.run_ifca(users, lambda g: mlp.init(MCFG, g), mlp.loss_fn(MCFG),
                      _label_fn, cfg, device=CPU)
    np.testing.assert_array_equal(a.assignments, b.assignments)
    for pa, pb in zip(a.final_params, b.final_params):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert a.per_user_bytes_per_round == 4 * (784 * 16 + 16 + 16 * 10
                                              + 10) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ifca.run_ifca(users, lambda g: mlp.init(MCFG, g),
                          mlp.loss_fn(MCFG), _label_fn, cfg)


def test_ifca_config_conversion():
    ref = ref_ifca.IFCAConfig(n_clusters=4, rounds=2, local_steps=7,
                              batch_size=8, seed=5,
                              client=ref_client.ClientConfig(
                                  lr=0.2, optimizer="adamw",
                                  weight_decay=0.1, clip_norm=1.0))
    port = convert.ifca_config_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
