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

Their gradient is computed by ``csrc/flash_attention_bwd.cu``, whose header
says how. ``bwd_variant`` picks one of its two kernel pairs by dtype and head
dim alone, so every dtype and head dim the forward takes has a backward:

- ``"mma"``: bf16 at D in {16, 64, 128} (the models' training path); tensor
  cores through ``mma.sync``, the C entry point ``flash_attention_bwd_mma``;
- ``"fma"``: f32 at any head dim, and bf16 at D = 8 and 256; f32 FMAs, the C
  entry point ``flash_attention_bwd``.

Their plain version is ``ref.attention_bwd_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (8, 16, 64, 128, 256)
WGMMA_HEAD_DIMS = (16, 64, 128, 256)
MMA_BWD_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}  # variant -> ctypes function
# Host-side errors of flash_attention_fwd_wgmma, beside the cudaError_t of a launch
_HOST_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled", -2: "a TMA tensor map could not be encoded"}


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs attention in ``dtype`` at head dim ``D``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS else "fma"


def bwd_variant(dtype: torch.dtype, D: int) -> str:
    """The backward kernel pair that runs attention's gradient in ``dtype`` at head dim ``D``."""
    return "mma" if dtype == torch.bfloat16 and D in MMA_BWD_HEAD_DIMS else "fma"


def check_tma_layout(*tensors: torch.Tensor) -> None:
    """TMA (the wgmma forward) and the 16-byte loads of the mma backward read
    rows of 16-byte aligned memory: raise unless every base address is 16-byte
    aligned and every stride of an axis longer than 1 is a multiple of 8 bf16
    elements (the model's tensors always are)."""
    for t in tensors:
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s % 8 for s in strides):
            raise ValueError(
                f"the wgmma flash kernel and the mma backward read 16-byte rows: they need a 16-byte aligned base "
                f"and strides that are multiples of 8 elements, got strides {t.stride()} at address "
                f"{t.data_ptr():#x}"
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


def _bwd_fn(name: str):
    if name not in _FNS:
        lib = build.load("flash_attention_bwd")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "bwd_fma":
            fn = lib.flash_attention_bwd
            fn.argtypes = [p] * 10 + [i] * 9 + [i64] * 24 + [p]
        else:
            fn = lib.flash_attention_bwd_mma
            fn.argtypes = [p] * 10 + [i] * 8 + [i64] * 24 + [p]
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


def _run_bwd(name: str, q, k, v, o, do, causal: bool, window: int | None):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)  # row statistics, first kernel -> second
    dr = torch.empty_like(lse)
    tensors = (q, k, v, o, do, dq, dk, dv)
    dtype = [_DTYPE_CODE[q.dtype]] if name == "bwd_fma" else []
    err = _bwd_fn(name)(
        *(t.data_ptr() for t in tensors), lse.data_ptr(), dr.data_ptr(), *dtype,
        B, S, T, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
        *(s for t in tensors for s in t.stride()[:3]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward ({name}) kernel launch failed: cudaError {err}")
    return dq, dk, dv


def launch_bwd_fma(q, k, v, o, do, *, causal: bool, window: int | None):
    """The FMA backward pair, f32 or bf16 at any head dim of ``HEAD_DIMS``."""
    return _run_bwd("bwd_fma", q, k, v, o, do, causal, window)


def launch_bwd_mma(q, k, v, o, do, *, causal: bool, window: int | None):
    """The mma backward pair, bf16 at a head dim of ``MMA_BWD_HEAD_DIMS``,
    every tensor laid out as ``check_tma_layout`` asks (16-byte loads)."""
    return _run_bwd("bwd_mma", q, k, v, o, do, causal, window)


def launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor, *, causal: bool,
    window: int | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel pair ``bwd_variant`` names: q, o, do (B, S, Hq, D)
    and k, v (B, T, Hkv, D) CUDA tensors of one dtype with unit stride on D,
    as the forward took them; o is the forward's output. The caller
    (``ops.flash_attention_bwd``) has checked devices, types, shapes and, for
    the mma pair, the layout. -> (dq, dk, dv), contiguous, in q's dtype."""
    run = launch_bwd_mma if bwd_variant(q.dtype, q.shape[-1]) == "mma" else launch_bwd_fma
    return run(q, k, v, o, do, causal=causal, window=window)
