"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every ``<family>/ops.py`` wrapper launches the CUDA kernel for CUDA
tensors and raises if it cannot; for CPU tensors it runs the plain
version in ``<family>/ref.py``.  ``dispatch.LAUNCHES`` counts launches.
"""
