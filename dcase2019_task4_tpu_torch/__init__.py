"""PyTorch/CUDA port of dcase2019_task4_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names; the JAX package stays the
reference the port is held against. The port imports torch and never jax.
Kernels are hand-written CUDA C++ under csrc/, built with nvcc for sm_90a
at first use (ops/_build.py). Importing this package imports nothing.
"""

__version__ = "0.1.0"
