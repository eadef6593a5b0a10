"""PyTorch / CUDA port of the one-shot clustering protocol (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module names.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.  Each hand-written kernel (``kernels/``) runs
for CUDA tensors; CPU tensors take the kernel's plain PyTorch version.
Importing the package builds and loads nothing: the kernel library is
compiled at its first CUDA launch.
"""
