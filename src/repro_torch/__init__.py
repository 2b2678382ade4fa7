"""LiteMat on PyTorch and CUDA: the port of the ``repro`` package.

Module for module it mirrors ``src/repro/``; its device hot loops are
hand-written CUDA kernels (``kernels/csrc``) with plain-torch versions
beside them for CPU tensors.  It imports neither JAX nor ``repro``.
"""
