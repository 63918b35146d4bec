"""Hand-written Hopper kernels of the ported path.

Each kernel ships as its source (``csrc/<name>.cu`` bound by ctypes, or a
Triton function in ``<name>.py``), a public wrapper in ``ops.py`` that
dispatches on the tensors' device and counts launches, and a plain PyTorch
version in ``ref.py``. Importing this package loads no kernel: CUDA sources
are built at first use (``build.py``) and Triton is imported inside the
launching function.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
