"""ctypes binding of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Both replace the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``); the source's header says what bounds them on the H100
and how each design answers that. ``variant`` picks one by dtype and head dim
alone:

- ``"wgmma"``: bf16 at D in {16, 64, 128, 256}; tensor cores (wgmma), TMA
  and an mbarrier pipeline, one C entry point ``flash_attention_fwd_wgmma``;
- ``"fma"``: f32 at any head dim, and bf16 at D = 8; f32 FMAs, the C entry
  point ``flash_attention_fwd``.

Both read q, k, v and write o in the model's (B, S, H, D) layout through
strides. Their plain version is ``ref.attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (8, 16, 64, 128, 256)
WGMMA_HEAD_DIMS = (16, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}  # variant -> ctypes function
# Host-side errors of flash_attention_fwd_wgmma, beside the cudaError_t of a launch
_HOST_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled", -2: "a TMA tensor map could not be encoded"}


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs attention in ``dtype`` at head dim ``D``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS else "fma"


def check_tma_layout(*tensors: torch.Tensor) -> None:
    """TMA reads rows of 16-byte aligned memory: raise unless every base
    address is 16-byte aligned and every stride of an axis longer than 1 is
    a multiple of 8 bf16 elements (the model's tensors always are)."""
    for t in tensors:
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s % 8 for s in strides):
            raise ValueError(
                f"the wgmma flash kernel reads through TMA: needs a 16-byte aligned base and strides that are "
                f"multiples of 8 elements, got strides {t.stride()} at address {t.data_ptr():#x}"
            )


def _fn(name: str):
    if name not in _FNS:
        lib = build.load("flash_attention")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "fma":
            fn = lib.flash_attention_fwd
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i] + [i64] * 12 + [p]
        else:
            fn = lib.flash_attention_fwd_wgmma
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i] + [i64] * 12 + [p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _run(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    dtype = [_DTYPE_CODE[q.dtype]] if name == "fma" else []
    err = _fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *dtype,
        B, S, T, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: {_HOST_ERRORS.get(err, f'cudaError {err}')}")
    return o


def launch_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None) -> torch.Tensor:
    """The FMA kernel, f32 or bf16 at any head dim of ``HEAD_DIMS``."""
    return _run("fma", q, k, v, causal, window)


def launch_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None) -> torch.Tensor:
    """The wgmma kernel, bf16 at a head dim of ``WGMMA_HEAD_DIMS``, inputs
    laid out as ``check_tma_layout`` asks."""
    return _run("wgmma", q, k, v, causal, window)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None) -> torch.Tensor:
    """q: (B, S, Hq, D), k/v: (B, T, Hkv, D) CUDA tensors with unit stride on
    D. The caller (``ops.flash_attention``) has checked devices, types and
    shapes. Launches the kernel ``variant`` names on the current stream and
    returns o: (B, S, Hq, D)."""
    run = launch_wgmma if variant(q.dtype, q.shape[-1]) == "wgmma" else launch_fma
    return run(q, k, v, causal=causal, window=window)
