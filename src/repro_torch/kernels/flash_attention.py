"""ctypes binding of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``); the source's header says what bounds it on the H100 and
how the design answers that. The kernel reads q, k, v and writes o in the
model's (B, S, H, D) layout through strides. Its plain version is
``ref.attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (8, 16, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i] + [i64] * 12 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None) -> torch.Tensor:
    """q: (B, S, Hq, D), k/v: (B, T, Hkv, D) CUDA tensors with unit stride on
    D. The caller (``ops.flash_attention``) has checked devices, types and
    shapes. Launches on the current stream and returns o: (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODE[q.dtype],
        B, S, T, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return o
