"""Shared helpers for the port's tests (``tests/test_torch_*.py``).

Data crosses between the JAX package and the port as numpy arrays.  The
torch thread count is pinned to one so that several pytest-xdist
workers do not oversubscribe the host's cores.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a) -> torch.Tensor:
    """A float32 CPU tensor from any array (numpy or JAX)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def same_partition(a, b) -> bool:
    from repro_torch.core import clustering as clu

    return clu.adjusted_rand_index(host(a), host(b)) == pytest.approx(1.0)


@pytest.fixture
def cuda_device():
    """The CUDA device for ``gpu``-marked tests; skips without a Hopper
    card (the kernels are built for sm_90a only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper) only")
    return torch.device("cuda")


class FakeLibrary:
    """Stands in for the kernel library on the CPU: every C entry point
    returns 0 (success) and records its arguments in ``calls``."""

    def __init__(self):
        self.calls: dict[str, list[tuple]] = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.setdefault(name, []).append(args)
            return 0
        return entry


@pytest.fixture
def fake_launches(monkeypatch):
    """Run the wrappers' CUDA branches on CPU tensors against a
    ``FakeLibrary``: the plan resolution, the launch arguments and the
    launch counts are the real ones, the kernels write nothing.  Yields
    the library; its ``calls`` hold each launch's arguments."""
    import contextlib

    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.assign import ops as assign_ops

    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(dispatch, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(assign_ops, "_sm_count", lambda dev: 132)
    saved = dict(dispatch.LAUNCHES)
    yield lib
    dispatch.LAUNCHES.update(saved)
