"""PyTorch + CUDA port of the JAX package ``repro`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only. Plain tensor code is PyTorch; every
Pallas TPU kernel of the ported path is a kernel written by hand for
``sm_90a`` (CUDA C++ under ``csrc/`` or Triton), dispatched in
``kernels/ops.py``.
"""
