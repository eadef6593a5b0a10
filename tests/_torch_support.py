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
