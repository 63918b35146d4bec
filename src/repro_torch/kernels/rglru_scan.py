"""ctypes binding of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``_rglru_kernel``); the source's header says what bounds it on the H100 and
how the design answers that. The kernel computes ``h_t = a_t * h_{t-1} + b_t``
over contiguous (B, S, W) arrays, h in f32, output in the inputs' dtype. Its
plain version is ``ref.rglru_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("rglru_scan").rglru_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: contiguous (B, S, W) CUDA tensors of one dtype. The caller
    (``ops.rglru_scan``) has checked devices, types and shapes. Launches on
    the current stream and returns h: (B, S, W) in a's dtype."""
    B, S, W = a.shape
    h = torch.empty_like(a)
    err = _fn()(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPE_CODE[a.dtype], B, S, W,
                torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    return h
