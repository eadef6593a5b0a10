"""The port's example entry points (``repro_torch.examples``) against
the repo's ``examples/*.py`` and ``benchmarks/common.py`` on the CPU.

Each reference example is loaded from its file and run with its own
arguments; the values it computes are recorded where it makes them (its
``one_shot_clustering`` result, its arrivals' labels, its per-LPS losses,
the trainer's histories), since it prints them rounded:

* quickstart, raw path with ``--arrivals 4`` and ``--host-ingest``: R
  within 1e-4, the labels (the port's default decision layer is the
  NN-chain, the reference's the host HAC), the ledger summary and the
  newcomers' labels equal;
* ``mthfl_compare`` (``examples/common.py``) on a small FMNIST layout:
  the clustering accuracy, the one-shot labels and each seed's random
  labels equal, and each run's final accuracies within the trainer's
  bar (1e-5, ``tests/test_torch_trainer.py``) with the reference's draws
  injected (initial parameters through ``convert``);
* lm_federated: the clustering labels equal; with the reference's
  initial parameters each client's first and second steps' losses
  within 1e-4, and the first round's per-LPS losses (each client's fifth
  AdamW step) within 4x the reference's own one-ulp spread, which must
  stay under 1e-2;
* serve_demo: the tokens of the reference's ``greedy_decode`` on the
  same weights and prompt (granite: attention; RWKV-6: the recurrence);
* without ``--device cpu`` each example raises on a host without a card.
"""
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fed_support import ReferenceDraws

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:        # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))

from benchmarks import common as ref_common  # noqa: E402
from repro import optim as ref_optim
from repro.configs.base import get_arch as ref_get_arch
from repro.data import partition as ref_dpart
from repro.data import synthetic as ref_syn
from repro.fed import client as ref_client
from repro.fed import partition as ref_fpart
from repro.fed import trainer as ref_trainer
from repro.launch.decode_loop import greedy_decode as ref_greedy_decode
from repro.models import mlp as ref_mlp
from repro.models.registry import get_model as ref_get_model
from repro_torch import convert
from repro_torch.data import partition as dpart
from repro_torch.data import synthetic as syn
from repro_torch.examples import common, lm_federated, mthfl_train
from repro_torch.examples import quickstart, serve_demo
from repro_torch.fed import trainer as ftrainer
from repro_torch.models import mlp

R_TOL = 1e-4
ACC_TOL = 1e-5
LOSS_TOL = 1e-4
# the largest one-ulp spread of lm_federated's round losses that the
# comparison accepts: the measured spread is 7.97e-4 on the CPU (losses
# near 0.8)
SPREAD_CAP = 1e-2


def _reference_example(name: str):
    """``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    mod.main()


def _recording_oneshot(mod, monkeypatch) -> list:
    """Record the example's ``one_shot_clustering`` results."""
    got = []
    real = mod.oneshot.one_shot_clustering

    def one_shot_clustering(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    monkeypatch.setattr(mod, "oneshot", types.SimpleNamespace(
        one_shot_clustering=one_shot_clustering))
    return got


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--arrivals", "4"], ["--host-ingest"]],
                         ids=["raw-arrivals", "host-ingest"])
def test_quickstart_matches_reference(flags, monkeypatch, capsys):
    ref = _reference_example("quickstart")
    results = _recording_oneshot(ref, monkeypatch)
    arrivals = []

    class Engine(ref.MembershipEngine):
        def assign(self, lam, v):
            arrivals.append(super().assign(lam, v))
            return arrivals[-1]

    monkeypatch.setattr(ref, "MembershipEngine", Engine)
    _run_reference(ref, flags, monkeypatch)
    want = results[0]
    got = quickstart.main(["--device", "cpu"] + flags)
    assert got["accuracy"] == 1.0
    np.testing.assert_allclose(got["similarity"],
                               np.asarray(want.similarity), atol=R_TOL)
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    assert got["ledger"] == want.ledger.summary()
    if "--arrivals" in flags:
        np.testing.assert_array_equal(got["arrival_labels"],
                                      np.asarray(arrivals[0].labels))
        np.testing.assert_array_equal(got["arrival_labels"],
                                      got["arrival_tasks"])


# ---------------------------------------------------------------------------
# mthfl_compare
# ---------------------------------------------------------------------------

class _Draws(ReferenceDraws):
    """The reference trainer's draws for one run of ``mthfl_compare``,
    each cluster's initial MLP converted with its own head size."""

    def __init__(self, users, labels, cfg, classes):
        self.cfg = cfg
        self.setup = ref_trainer._setup_clusters(
            users, np.asarray(labels), len(classes), cfg.seed, classes)
        self.params = [convert.paper_mlp_params_from_reference(
            ref_mlp.init(ref_mlp.PaperMLPConfig(m=784, n_classes=len(c)), k),
            mlp.PaperMLPConfig(m=784, n_classes=len(c)), device="cpu")
            for c, k in zip(classes, self.setup.init_keys)]


def _ref_builder(classes):
    c = ref_mlp.PaperMLPConfig(m=784, n_classes=len(classes))
    return ref_trainer.TaskModel(
        init=lambda k, cc=c: ref_mlp.init(cc, k),
        loss_fn=ref_mlp.loss_fn(c),
        accuracy=lambda p, x, y, cc=c: ref_mlp.accuracy(cc, p, x, y),
        is_common=ref_fpart.prefix_predicate(ref_mlp.COMMON_PREFIXES))


def test_mthfl_compare_matches_reference(monkeypatch):
    """Two seeds, two global rounds on the FMNIST layout at scale 0.05
    (10 users of 64 samples)."""
    ref_cfg = ref_trainer.MTHFLConfig(
        global_rounds=2, local_rounds=1, local_steps=3, batch_size=16,
        client=ref_client.ClientConfig(lr=0.05, optimizer="momentum"))
    ref_users = ref_dpart.paper_fmnist_three_task(seed=0, scale=0.05)
    runs = []
    real = ref_trainer.train_mthfl

    def recording(users, labels, models, evals, cfg, **kw):
        hist = real(users, labels, models, evals, cfg, **kw)
        runs.append((np.asarray(labels), cfg.seed, hist.accuracy[-1]))
        return hist

    monkeypatch.setattr(ref_trainer, "train_mthfl", recording)
    want = ref_common.mthfl_compare(
        ref_users, ref_dpart.FMNIST_TASKS, _ref_builder,
        ref_common.make_eval_spec(ref_syn.FMNIST_LIKE, n=20), 3, (0, 1),
        ref_cfg)
    _, _, _, _, builder = mthfl_train.setup("fmnist")
    got = common.mthfl_compare(
        dpart.paper_fmnist_three_task(seed=0, scale=0.05),
        dpart.FMNIST_TASKS, builder,
        common.make_eval_spec(syn.FMNIST_LIKE, n=20), 3,
        (0, 1), convert.mthfl_config_from_reference(ref_cfg),
        device="cpu",
        draws=lambda labels, seed, cc: _Draws(
            ref_users, labels, dataclasses.replace(ref_cfg, seed=seed), cc))
    assert got["clustering_accuracy"] == want["clustering_accuracy"] == 1.0
    # the reference's runs: proposed and random, seed by seed
    proposed, random_ = runs[0::2], runs[1::2]
    for seed in (0, 1):
        np.testing.assert_array_equal(got["labels"], proposed[seed][0])
        np.testing.assert_array_equal(got["random_labels"][seed],
                                      random_[seed][0])
        np.testing.assert_allclose(got["proposed_runs"][seed],
                                   proposed[seed][2], atol=ACC_TOL)
        np.testing.assert_allclose(got["random_runs"][seed],
                                   random_[seed][2], atol=ACC_TOL)
    for key in ("proposed_mean", "proposed_std", "random_mean",
                "random_std"):
        assert abs(got[key] - want[key]) <= ACC_TOL, key


def test_eval_spec_copy_equals_reference():
    got = common.make_eval_spec(syn.CIFAR_LIKE, n=8)(
        [2, 3, 4, 5, 6, 7], dpart.CIFAR_TASKS)
    want = ref_common.make_eval_spec(ref_syn.CIFAR_LIKE, n=8)(
        [2, 3, 4, 5, 6, 7], ref_dpart.CIFAR_TASKS)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# lm_federated
# ---------------------------------------------------------------------------

def _reference_lm_federated(monkeypatch, nudge: bool):
    """The reference example at ``--steps 10`` (one round): its
    clustering result and each LPS's mean client loss; with ``nudge``,
    from initial parameters moved by one ulp."""
    ref = _reference_example("lm_federated")
    results = _recording_oneshot(ref, monkeypatch)
    means = []

    def mean(values):
        means.append(float(np.mean(values)))
        return means[-1]

    monkeypatch.setattr(ref, "np", types.SimpleNamespace(mean=mean))
    if nudge:
        real = ref.get_model

        def get_model(cfg):
            bundle = real(cfg)
            return dataclasses.replace(bundle, init=lambda key: jax.tree.map(
                lambda x: jnp.nextafter(x, jnp.inf), bundle.init(key)))

        monkeypatch.setattr(ref, "get_model", get_model)
    _run_reference(ref, ["--steps", "10"], monkeypatch)
    return results[0], means


def test_lm_federated_matches_reference(monkeypatch, capsys):
    """The labels equal; each client's first and second steps, from the
    reference's initial parameters, have the reference's losses within
    1e-4 (the second checks one AdamW update); the round's per-LPS
    losses (each client's fifth step) within 4x the reference's own
    spread under a one-ulp nudge of its initial parameters, a spread
    held under ``SPREAD_CAP``.  Each client step is AdamW from a fresh
    state, whose first update is about ``lr * sign(g)`` an element, so
    rounding differences grow step by step: under the nudge the
    reference's own fifth-step losses move by more than 1e-4."""
    want, means = _reference_lm_federated(monkeypatch, nudge=False)
    _, nudged = _reference_lm_federated(monkeypatch, nudge=True)
    ref_cfg = dataclasses.replace(ref_get_arch("qwen3_1_7b", reduced=True),
                                  vocab=lm_federated.VOCAB)
    ref_m = ref_get_model(ref_cfg)
    ref_init = [ref_m.init(jax.random.PRNGKey(t)) for t in range(2)]
    cfg = lm_federated.model_config()
    args = lm_federated.build_parser().parse_args(
        ["--steps", "10", "--device", "cpu"])
    got = lm_federated.run(args, lps_init=[
        {k: v.detach() for k, v in convert.lm_params_from_reference(
            cfg, p, device="cpu").named_parameters()} for p in ref_init])
    labels = np.asarray(want.labels)
    np.testing.assert_array_equal(got["labels"], labels)
    assert got["accuracy"] == 1.0
    ref_opt = ref_optim.adamw(3e-3)

    def ref_client_step(params, batch):
        """The reference example's client step."""
        loss, g = jax.value_and_grad(
            lambda q: ref_m.loss_fn(q, batch))(params)
        upd, _ = ref_opt.update(g, ref_opt.init(params), params)
        return ref_optim.apply_updates(params, upd), loss

    # each client's first two steps on the round's batch (offset 0): the
    # loss of the initial parameters, then of one AdamW update
    users = [lm_federated.tok.sample_tokens(
        lm_federated.tok.TokenTaskSpec(vocab=lm_federated.VOCAB, seed=d),
        4096, seed=(d, u)) for d in range(2) for u in range(3)]
    n = lm_federated.BATCH * lm_federated.SEQ
    for t in range(2):
        members = [i for i, l in enumerate(labels) if l == t]
        for j, i in enumerate(members):
            chunk = users[i][:n + 1]
            batch = {"tokens": jnp.asarray(chunk[:-1].reshape(4, -1)),
                     "labels": jnp.asarray(chunk[1:].reshape(4, -1))}
            stepped, first = ref_client_step(ref_init[t], batch)
            second = float(ref_m.loss_fn(stepped, batch))
            assert abs(got["step_losses"][0][t][j][0] - float(first)) \
                <= LOSS_TOL
            assert abs(got["step_losses"][0][t][j][1] - second) <= LOSS_TOL
    spread = max(abs(a - b) for a, b in zip(means, nudged))
    print(f"lm_federated round losses' one-ulp spread: {spread!r}")
    assert len(got["losses"]) == 1 and len(means) == 2
    assert 0 < spread < SPREAD_CAP
    np.testing.assert_allclose(got["losses"][0], means, rtol=0,
                               atol=max(4 * spread, LOSS_TOL))


# ---------------------------------------------------------------------------
# serve_demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_8b", "rwkv6_1_6b"])
def test_serve_demo_matches_reference(arch):
    ref_cfg = ref_get_arch(arch, reduced=True)
    m = ref_get_model(ref_cfg)
    params = m.init(jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                ref_cfg.vocab)
    want = np.asarray(ref_greedy_decode(m, params, prompt, 6).tokens)
    args = serve_demo.build_parser().parse_args(
        ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--gen", "6",
         "--device", "cpu"])
    cfg = serve_demo.get_arch(arch, reduced=True)
    model = convert.lm_params_from_reference(cfg, params, device="cpu")
    got = serve_demo.run(args, model=model, prompt=torch.from_numpy(
        np.array(prompt, np.int32)))
    np.testing.assert_array_equal(got.tokens.numpy(), want)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,argv", [
    (quickstart, []), (mthfl_train, ["--rounds", "1", "--seeds", "1"]),
    (lm_federated, ["--steps", "10"]), (serve_demo, [])],
    ids=["quickstart", "mthfl_train", "lm_federated", "serve_demo"])
def test_examples_default_to_the_card(module, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_trainer_backends_are_the_ports():
    action = next(a for a in mthfl_train.build_parser()._actions
                  if a.dest == "backend")
    assert tuple(action.choices) == ftrainer.TRAINER_BACKENDS
    assert action.default == "torch"
