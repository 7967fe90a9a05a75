"""PyTorch/CUDA port of garmentnets_tpu for NVIDIA Hopper (H100).

The layout mirrors the JAX package (`models/`, `ops/`, `kernels/`,
`harness/`, `core/`) so each module's counterpart is easy to find. Public
functions keep the JAX package's channels-last `[B, D, H, W, C]` layout.

Hand-written CUDA kernels live in `csrc/` and are built on first use into
`_build/` (see `kernels/_build.py`); importing the package builds nothing.
A CUDA tensor goes through its kernel; a CPU tensor goes through the plain
PyTorch version beside it.
"""
