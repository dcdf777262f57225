"""PyTorch/CUDA port of neural_graph_mapping_tpu.

Mirrors the JAX package's module tree and names; plain tensor code is
PyTorch, and each Pallas kernel on the ported path is a CUDA C++ kernel
under ``csrc/`` built for Hopper (sm_90a) at first use. This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
