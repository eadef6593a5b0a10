"""Package-level properties of the port: numpy copies equal their
originals, the ledger equals the reference's, the package imports
neither JAX nor the JAX package, and nothing falls back to the CPU
without being asked."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_support import CPU
from repro.core import clustering as ref_clu
from repro.core import oneshot as ref_oneshot
from repro.data import synthetic as ref_syn
from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core.engine import ProtocolEngine
from repro_torch.data import synthetic as syn

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_mixture_copy_is_bit_identical(seed):
    args = (10, 9, 24, 3)
    feats, tasks = syn.make_task_feature_mixture(*args, seed=seed)
    ref_feats, ref_tasks = ref_syn.make_task_feature_mixture(*args, seed=seed)
    assert feats.dtype == ref_feats.dtype == np.float32
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(tasks, ref_tasks)
    feats, _ = syn.make_task_feature_mixture(5, 4, 16, 2, seed=seed,
                                             noise=0.3, rank=5)
    ref_feats, _ = ref_syn.make_task_feature_mixture(5, 4, 16, 2, seed=seed,
                                                     noise=0.3, rank=5)
    np.testing.assert_array_equal(feats, ref_feats)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("linkage", ["average", "single", "complete"])
def test_clustering_copy_equals_original(seed, linkage):
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=(15, 15))
    r = (r + r.T) / 2
    dend, ref_dend = clu.hac(r, linkage), ref_clu.hac(r, linkage)
    assert dend.merges == ref_dend.merges and dend.n_leaves == 15
    for k in (1, 4, 15):
        np.testing.assert_array_equal(clu.cut(dend, k),
                                      ref_clu.cut(ref_dend, k))
        np.testing.assert_array_equal(clu.hac_clusters(r, k, linkage),
                                      ref_clu.hac_clusters(r, k, linkage))
    pred = rng.integers(0, 4, 30)
    true = rng.integers(0, 4, 30)
    assert clu.clustering_accuracy(pred, true) == \
        ref_clu.clustering_accuracy(pred, true)
    assert clu.adjusted_rand_index(pred, true) == \
        ref_clu.adjusted_rand_index(pred, true)
    np.testing.assert_array_equal(clu.oracle_clusters(true),
                                  ref_clu.oracle_clusters(true))


def test_clustering_accuracy_greedy_branch_equals_original():
    rng = np.random.default_rng(2)
    pred, true = rng.integers(0, 12, 60), rng.integers(0, 12, 60)
    assert clu.clustering_accuracy(pred, true) == \
        ref_clu.clustering_accuracy(pred, true)


def test_hac_copy_validates_like_original():
    bad = np.array([[1.0, np.nan], [np.nan, 1.0]])
    for mod in (clu, ref_clu):
        with pytest.raises(ValueError):
            mod.hac(bad)
        with pytest.raises(ValueError):
            mod.hac(np.array([[1.0, 0.2], [0.9, 1.0]]))


@pytest.mark.parametrize("kw", [
    dict(n_users=16, d=64, top_k=8),
    dict(n_users=1024, d=512, top_k=8, model_params=11_000_000),
    dict(n_users=7, d=5, top_k=5, dtype_bytes=2, mode="streaming"),
])
def test_ledger_summary_equals_reference(kw):
    assert oneshot.CommLedger(**kw).summary() == \
        ref_oneshot.CommLedger(**kw).summary()


def test_ledger_validation():
    with pytest.raises(ValueError):
        oneshot.CommLedger(n_users=2, d=2, top_k=1, mode="gossip")
    with pytest.raises(ValueError):
        oneshot.CommLedger(n_users=2, d=2, top_k=1, dtype_bytes=0)


def _run(code: str, cwd=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_reference():
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in ("core.oneshot", "core.signature_engine", "data.features",
                 "data.partition", "kernels.featurize_gram.ops",
                 "kernels.gram_project.ops", "kernels.quant",
                 "kernels.assign.ops", "kernels.assign.ref",
                 "core.membership_engine", "core.hierarchy",
                 "fed.partition", "launch.membership", "optim.optimizers",
                 "models.cnn", "models.mlp", "configs.paper_cnn",
                 "configs.paper_mlp", "fed.fedavg", "fed.hierarchy",
                 "fed.client", "fed.trainer", "fed.ifca", "obs", "obs.core",
                 "obs.events", "obs.metrics", "obs.trace", "launch.obs",
                 "checkpoint", "checkpoint.ckpt", "launch.train",
                 "examples", "examples.common", "examples.quickstart",
                 "examples.mthfl_train", "examples.lm_federated",
                 "examples.serve_demo"):
        assert f"repro_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'benchmarks'))\n"
        "print('BAD', bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout


def test_chip_smoke_imports_neither_jax_nor_reference():
    text = (ROOT / "chip_smoke.py").read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro",
                                                  "benchmarks"), line


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oneshot.one_shot_clustering(np.zeros((4, 3, 2), np.float32), 2)
    assert ProtocolEngine(device="cpu").device == CPU


def test_chip_smoke_fails_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
