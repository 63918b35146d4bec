"""Public kernel wrappers: dispatch on the tensors' device and count launches.

Layout conventions match the model code: attention takes (B, S, H, D) and
returns the same; the RG-LRU scan takes (B, S, W). For a CUDA tensor a
wrapper launches its hand-written kernel and adds one to its launch counter;
any error raises, there is no fallback. For a CPU tensor it calls the plain
version in ``ref.py`` and the counter does not move. Any other device, an
unsupported dtype or head dim, or a last axis that is not contiguous raises
(the scan needs both inputs contiguous), as does a layout the wgmma flash
kernel cannot read through TMA, on either device.
"""

from __future__ import annotations

import torch

from . import flash_attention as _flash
from . import fused_rmsnorm as _rmsnorm
from . import ref
from . import rglru_scan as _rglru

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = _flash.HEAD_DIMS

# Launch counters: plain ints, bumped only where a kernel is launched.
FLASH_ATTENTION_LAUNCHES = 0  # both flash kernels
FLASH_ATTENTION_WGMMA_LAUNCHES = 0  # those that took the wgmma kernel
FUSED_RMSNORM_LAUNCHES = 0
RGLRU_SCAN_LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    return {
        "flash_attention": FLASH_ATTENTION_LAUNCHES,
        "flash_attention_wgmma": FLASH_ATTENTION_WGMMA_LAUNCHES,
        "fused_rmsnorm": FUSED_RMSNORM_LAUNCHES,
        "rglru_scan": RGLRU_SCAN_LAUNCHES,
    }


def reset_launch_counts() -> None:
    global FLASH_ATTENTION_LAUNCHES, FLASH_ATTENTION_WGMMA_LAUNCHES, FUSED_RMSNORM_LAUNCHES, RGLRU_SCAN_LAUNCHES
    FLASH_ATTENTION_LAUNCHES = 0
    FLASH_ATTENTION_WGMMA_LAUNCHES = 0
    FUSED_RMSNORM_LAUNCHES = 0
    RGLRU_SCAN_LAUNCHES = 0


def _device_type(*tensors: torch.Tensor) -> str:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: the kernels run on cuda, their plain versions on cpu")
    return dev.type


def flash_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    device = _device_type(q, k, v)
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"expected q (B,S,Hq,D) and k, v (B,T,Hkv,D); got {q.shape}, {k.shape}, {v.shape}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2] != 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel is built for {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one of {DTYPES} for all three")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head-dim axis must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    wgmma = _flash.variant(q.dtype, D) == "wgmma"
    if wgmma:
        _flash.check_tma_layout(q, k, v)
    if device == "cpu":
        o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    global FLASH_ATTENTION_LAUNCHES, FLASH_ATTENTION_WGMMA_LAUNCHES
    o = _flash.launch(q, k, v, causal=causal, window=window)
    FLASH_ATTENTION_LAUNCHES += 1
    FLASH_ATTENTION_WGMMA_LAUNCHES += wgmma
    return o


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; x (..., D) in f32 or bf16, scale (D,) f32."""
    device = _device_type(x, scale)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} does not match last axis {D}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype}: need one of {DTYPES}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.stride(-1) != 1 or scale.stride(-1) != 1:
        raise ValueError("the normalised axis must be contiguous")
    if device == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    global FUSED_RMSNORM_LAUNCHES
    y = _rmsnorm.launch(x.view(-1, D), scale, eps)
    FUSED_RMSNORM_LAUNCHES += 1
    return y.view(x.shape)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along S with ``h_{-1} = 0``; a, b (B, S, W)
    contiguous, one dtype, f32 or bf16. -> h (B, S, W) in a's dtype."""
    device = _device_type(a, b)
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b of one (B, S, W) shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype}: need one of {DTYPES} for both")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if device == "cpu":
        return ref.rglru_ref(a, b)
    global RGLRU_SCAN_LAUNCHES
    h = _rglru.launch(a, b)
    RGLRU_SCAN_LAUNCHES += 1
    return h
