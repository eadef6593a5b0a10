"""The port's data layer against the JAX package: the synthetic image
families and the paper's partitions (numpy copies, bit-identical), and
the Phi feature maps.

Phi parameters are seeded through numpy (and fit on the probe with
numpy for ``pca``), so they must equal the reference's bit for bit.
Phi applied to data runs in torch here and in XLA there: fp32 products
and convolutions summed in another order agree to rtol 1e-5 with an
absolute floor of 1e-5 of the largest entry.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_support import t
from repro.data import features as ref_feat
from repro.data import partition as ref_part
from repro.data import synthetic as ref_syn
from repro_torch.data import features as feat
from repro_torch.data import partition as part
from repro_torch.data import synthetic as syn


def close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    floor = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=floor)


# (kind, config kwargs, input dim m, probe rows)
KINDS = [
    ("identity", {}, 24, 0),
    ("random_projection", {"d": 16, "seed": 3}, 40, 0),
    ("pca", {"d": 12}, 32, 50),
    ("random_conv", {"d": 24, "image_hw": (8, 8, 3)}, 192, 0),
    ("random_conv", {"d": 4096, "image_hw": (7, 9, 2)}, 126, 0),
    ("random_conv", {"d": 40, "image_hw": (32, 32, 3), "seed": 11}, 3072, 0),
]


def _configs(kind, kwargs, m, probe_rows, seed=0):
    rng = np.random.default_rng(seed)
    probe = (rng.standard_normal((probe_rows, m)).astype(np.float32)
             if probe_rows else None)
    return (feat.FeatureConfig(kind=kind, **kwargs),
            ref_feat.FeatureConfig(kind=kind, **kwargs), probe)


@pytest.mark.parametrize("kind,kwargs,m,probe_rows", KINDS)
def test_phi_params_bit_identical(kind, kwargs, m, probe_rows):
    fc, ref_fc, probe = _configs(kind, kwargs, m, probe_rows)
    params = feat.phi_params(fc, m, probe=probe)
    ref_params = ref_feat.phi_params(ref_fc, m, probe=probe)
    assert params.keys() == ref_params.keys()
    for name, value in params.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, np.asarray(ref_params[name]))
    assert feat.phi_out_dim(fc, m, probe=probe) == \
        ref_feat.phi_out_dim(ref_fc, m, probe=probe)


@pytest.mark.parametrize("kind,kwargs,m,probe_rows", KINDS)
def test_phi_apply_matches_reference(kind, kwargs, m, probe_rows):
    fc, ref_fc, probe = _configs(kind, kwargs, m, probe_rows, seed=1)
    x = np.random.default_rng(2).standard_normal((9, m)).astype(np.float32)
    params = feat.phi_params(fc, m, probe=probe)
    out = feat.phi_apply(t(x), params, fc)
    ref = ref_feat.phi_apply(jnp.asarray(x), ref_feat.phi_params(
        ref_fc, m, probe=probe), ref_fc)
    assert out.dtype == torch.float32
    close(out.numpy(), ref)
    close(feat.feature_map(x, fc, probe=probe),
          ref_feat.feature_map(x, ref_fc, probe=probe))


@pytest.mark.parametrize("side", [4, 5, 8, 9, 16])
def test_same_padding_matches_xla(side):
    """Stride-2 "SAME" pads (1, 2) on even sides of a 5-wide kernel and
    symmetrically on odd ones; the conv front end must match XLA's on
    both (flat NHWC input and output)."""
    hw = (side, side + 1, 3)
    p = feat._conv_params(3, 5)
    x = np.random.default_rng(side).standard_normal(
        (4, hw[0] * hw[1] * 3)).astype(np.float32)
    out = feat._random_conv_features(t(x), t(p["w1"]), t(p["w2"]), hw)
    ref = ref_feat._random_conv_features(jnp.asarray(x), jnp.asarray(p["w1"]),
                                         jnp.asarray(p["w2"]), hw)
    assert out.shape[1] == feat._conv_out_dim(hw)
    close(out.numpy(), ref)


def test_feature_config_is_hashable_and_validated():
    a = feat.FeatureConfig(kind="random_conv", image_hw=[8, 8, 3])
    assert a.image_hw == (8, 8, 3)
    assert hash(a) == hash(feat.FeatureConfig(kind="random_conv",
                                              image_hw=(8, 8, 3)))
    for bad in (dict(kind="fourier"), dict(d=0), dict(kind="random_conv")):
        with pytest.raises(ValueError):
            feat.FeatureConfig(**bad)
        with pytest.raises(ValueError):
            ref_feat.FeatureConfig(**bad)
    with pytest.raises(ValueError, match="exceeds"):
        feat.phi_params(feat.FeatureConfig(d=50), 40)


def test_probe_digest_and_binding():
    rng = np.random.default_rng(4)
    probe = rng.standard_normal((30, 16)).astype(np.float32)
    assert feat.probe_digest(probe) == ref_feat.probe_digest(probe)
    fc = feat.FeatureConfig(kind="pca", d=4).bind_probe(probe)
    assert fc.probe_digest == ref_feat.FeatureConfig(
        kind="pca", d=4).bind_probe(probe).probe_digest
    feat.phi_params(fc, 16, probe=probe)
    with pytest.raises(ValueError, match="digest"):
        feat.phi_params(fc, 16, probe=probe + 1.0)
    with pytest.raises(ValueError, match="probe"):
        feat.phi_params(feat.FeatureConfig(kind="pca", d=4), 16)


@pytest.mark.parametrize("spec", ["CIFAR_LIKE", "FMNIST_LIKE",
                                  "CIFAR100_LIKE"])
def test_task_dataset_copy_is_bit_identical(spec):
    port_spec, ref_spec = getattr(syn, spec), getattr(ref_syn, spec)
    assert dataclasses.asdict(port_spec) == dataclasses.asdict(ref_spec)
    kw = dict(labels=[0, 3, 5], n_per_class=[4, 0, 6], seed=(3, 1),
              task_of_class={0: 0, 3: 1, 5: 1})
    x, y = syn.make_task_dataset(port_spec, **kw)
    rx, ry = ref_syn.make_task_dataset(ref_spec, **kw)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    tb = ref_syn._class_basis(ref_spec, 3, None, 7)[0]
    np.testing.assert_array_equal(syn.class_mean(port_spec, 3, tb),
                                  ref_syn.class_mean(ref_spec, 3, tb))


@pytest.mark.parametrize("layout", ["cifar", "fmnist"])
def test_paper_partitions_are_bit_identical(layout):
    if layout == "cifar":
        users = part.paper_cifar_two_task(n_per_user=40, seed=2,
                                          users_per_task=(2, 3))
        ref_users = ref_part.paper_cifar_two_task(n_per_user=40, seed=2,
                                                  users_per_task=(2, 3))
    else:
        users = part.paper_fmnist_three_task(seed=1, scale=0.02)
        ref_users = ref_part.paper_fmnist_three_task(seed=1, scale=0.02)
    assert len(users) == len(ref_users)
    for u, r in zip(users, ref_users):
        assert (u.user_id, u.task_id, u.task_classes, u.n) == \
            (r.user_id, r.task_id, r.task_classes, r.n)
        np.testing.assert_array_equal(u.x, r.x)
        np.testing.assert_array_equal(u.y, r.y)
        np.testing.assert_array_equal(u.local_label(), r.local_label())


@pytest.mark.parametrize("case", ["quickstart_arrivals",
                                  "lm_federated_tokens"])
def test_example_data_copies_are_bit_identical(case):
    """The copies the examples (``repro_torch.examples``) draw, at the
    examples' own arguments: quickstart's newcomers (``--arrivals 4``)
    and lm_federated's token streams (a tuple seed) and their
    features."""
    if case == "quickstart_arrivals":
        users = part.paper_cifar_two_task(n_per_user=400, seed=1,
                                          users_per_task=(2, 2))
        ref_users = ref_part.paper_cifar_two_task(n_per_user=400, seed=1,
                                                  users_per_task=(2, 2))
        assert [u.task_id for u in users] == [0, 0, 1, 1]
        for u, r in zip(users, ref_users):
            np.testing.assert_array_equal(u.x, r.x)
            np.testing.assert_array_equal(u.y, r.y)
        return
    from repro.data import tokens as ref_tokens
    from repro_torch.data import tokens

    for d, u in ((0, 0), (1, 2)):
        stream = tokens.sample_tokens(tokens.TokenTaskSpec(vocab=256, seed=d),
                                      4096, seed=(d, u))
        np.testing.assert_array_equal(stream, ref_tokens.sample_tokens(
            ref_tokens.TokenTaskSpec(vocab=256, seed=d), 4096, seed=(d, u)))
        np.testing.assert_array_equal(
            tokens.token_features(stream, d=64, window=8, vocab=256),
            ref_tokens.token_features(stream, d=64, window=8, vocab=256))


def test_conv_runs_without_tf32_and_restores_the_flag(monkeypatch):
    """cuDNN would run fp32 convolutions in TF32 by default; the conv
    front end turns that off for its call only."""
    seen = []
    conv2d = feat.F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(feat.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fc = feat.FeatureConfig(kind="random_conv", d=8, image_hw=(8, 8, 3))
    feat.feature_map(np.ones((2, 192), np.float32), fc)
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 is True
