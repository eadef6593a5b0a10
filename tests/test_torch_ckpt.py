"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU: each package restores the files the other wrote,
for ``tests/test_infra.py``'s tree and for a REDUCED qwen3 ``(params,
opt_state)`` in the reference's layout; the manifests are equal; and
the port keeps the reference's retention, ``latest_step`` and errors.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_support import build_pair
from _torch_support import CPU
from repro import optim as ref_optim
from repro.checkpoint import latest_step as ref_latest
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch import optim
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.launch import train as launch_train


def _tree():
    """``tests/test_infra.py``'s tree, as tensors."""
    return {"a": {"w": torch.arange(6.0).reshape(2, 3)},
            "b": torch.ones((4,), dtype=torch.bfloat16)}


def _ref_tree():
    return {"a": {"w": jnp.arange(6.0).reshape(2, 3)},
            "b": jnp.ones((4,), jnp.bfloat16)}


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}.json").read_text())


class TestInfraTree:
    def test_reference_restores_the_port_s_file(self, tmp_path):
        save_checkpoint(tmp_path, 7, _tree())
        like = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                            _ref_tree())
        restored, step = ref_restore(tmp_path, like)
        assert step == 7 and ref_latest(tmp_path) == 7
        np.testing.assert_allclose(np.asarray(restored["a"]["w"]),
                                   np.arange(6.0).reshape(2, 3))
        assert restored["b"].dtype == jnp.bfloat16

    def test_port_restores_the_reference_s_file(self, tmp_path):
        ref_save(tmp_path, 7, _ref_tree())
        restored, step = restore_checkpoint(tmp_path, _tree(), device=CPU)
        assert step == 7 and latest_step(tmp_path) == 7
        torch.testing.assert_close(restored["a"]["w"],
                                   torch.arange(6.0).reshape(2, 3))
        assert restored["b"].dtype == torch.bfloat16
        assert restored["b"].device == CPU
        assert torch.equal(restored["b"], torch.ones(4, dtype=torch.bfloat16))

    def test_manifests_and_arrays_equal(self, tmp_path):
        save_checkpoint(tmp_path / "port", 3, _tree())
        ref_save(tmp_path / "ref", 3, _ref_tree())
        assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path / "ref",
                                                            3)
        with np.load(tmp_path / "port" / "step_00000003.npz") as got, \
                np.load(tmp_path / "ref" / "step_00000003.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])

    def test_retention_and_latest(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(tmp_path, s, _tree(), keep=2)
        assert latest_step(tmp_path) == 5
        assert len(list(tmp_path.glob("step_*.npz"))) == 2
        assert len(list(tmp_path.glob("step_*.json"))) == 2

    def test_shape_mismatch_raises(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree())
        bad = {"a": {"w": torch.zeros((3, 3))},
               "b": torch.zeros((4,), dtype=torch.bfloat16)}
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(tmp_path, bad, device=CPU)

    def test_missing_key_and_empty_dir_raise(self, tmp_path):
        save_checkpoint(tmp_path / "a", 1, _tree())
        with pytest.raises(KeyError, match="checkpoint missing 'c'"):
            restore_checkpoint(tmp_path / "a",
                               dict(_tree(), c=torch.zeros(1)), device=CPU)
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(tmp_path / "b", _tree(), device=CPU)
        assert latest_step(tmp_path / "b") is None

    def test_restore_defaults_to_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        save_checkpoint(tmp_path, 1, _tree())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_checkpoint(tmp_path, _tree())


def _ref_state(ref_params):
    """The reference's AdamW state after one step on gradients of ones, so
    that ``m``, ``v`` and ``step`` hold something."""
    opt = ref_optim.adamw(1e-3)
    state = opt.init(ref_params)
    _, state = opt.update(jax.tree.map(jnp.ones_like, ref_params), state,
                          ref_params)
    return state


class TestReducedQwen3:
    """``(params, opt_state)`` of REDUCED qwen3_1_7b (bf16 parameters,
    so that the float32 storage is held too), in the reference's tree."""

    def _pair(self):
        ref_m, ref_params, _, m, model, _ = build_pair(
            "qwen3_1_7b", param_dtype="bfloat16")
        return ref_params, m.cfg, model

    def test_port_restores_the_reference_s_run(self, tmp_path):
        ref_params, cfg, model = self._pair()
        ref_state = _ref_state(ref_params)
        ref_save(tmp_path, 1, (ref_params, ref_state))
        fresh = build_pair("qwen3_1_7b", param_dtype="bfloat16")[4]
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        state = optim.adamw(1e-3).init(dict(fresh.named_parameters()))
        like = launch_train.checkpoint_template(cfg, fresh, state)
        assert all(leaf.is_meta for leaf in jax.tree.leaves(like))
        tree, step = restore_checkpoint(tmp_path, like, device=CPU)
        got = launch_train.load_checkpoint_tree(cfg, fresh, tree)
        assert step == 1 and int(got.step) == 1
        for (name, p), (_, q) in zip(fresh.named_parameters(),
                                     model.named_parameters()):
            assert p.dtype == torch.bfloat16 and torch.equal(p, q), name
        want = launch_train.checkpoint_tree(cfg, fresh, got)[1]
        for g, w in zip(jax.tree.leaves(want.inner),
                        jax.tree.leaves(ref_state.inner)):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert all(v.dtype == torch.float32 for v in got.inner["m"].values())

    def test_reference_restores_the_port_s_run(self, tmp_path):
        ref_params, cfg, model = self._pair()
        ref_state = _ref_state(ref_params)
        # the same state on the port's side, through the reference layout
        save = tmp_path / "from_ref"
        ref_save(save, 1, (ref_params, ref_state))
        state = optim.adamw(1e-3).init(dict(model.named_parameters()))
        tree, _ = restore_checkpoint(
            save, launch_train.checkpoint_template(cfg, model, state),
            device=CPU)
        state = launch_train.load_checkpoint_tree(cfg, model, tree)
        save_checkpoint(tmp_path / "port", 4,
                        launch_train.checkpoint_tree(cfg, model, state))
        assert _manifest(tmp_path / "port", 4)["keys"] == \
            _manifest(save, 1)["keys"]
        zeros = jax.tree.map(jnp.zeros_like, (ref_params, ref_state))
        (params, got), step = ref_restore(tmp_path / "port", zeros)
        assert step == 4 and int(got.step) == 1
        for g, w in zip(jax.tree.leaves((params, got)),
                        jax.tree.leaves((ref_params, ref_state))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g, np.float32),
                                          np.asarray(w, np.float32))
