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
says how. ``bwd_variant`` picks one of its kernel pairs by dtype and head dim
alone, so every dtype and head dim the forward takes has a backward:

- ``"wgmma"``: bf16 at D in {16, 64, 128, 256} (the models' training path);
  tensor cores through wgmma, TMA and mbarrier rings, reading the row
  statistics ``lse`` that the wgmma forward writes (``launch_wgmma(...,
  lse=...)``); the C entry point ``flash_attention_bwd_wgmma``. At D = 256
  its dK/dV kernel splits D between its two warpgroups and, where the
  (key tile, batch, kv-head) grid leaves the card idle (MQA at batch 1),
  each kv group's q-heads into ``dkdv_splits`` groups whose f32 partial sums
  a second kernel adds in a fixed order;
- ``"fma"``: f32 at any head dim, and bf16 at D = 8; f32 FMAs, the C entry
  point ``flash_attention_bwd``.

Two pairs are kept as yardsticks that ``ops`` never runs: the ``"mma"`` pair
(``mma.sync``, bf16 at D in {16, 64, 128}), which the wgmma one replaced
(``launch_bwd_mma``), and the FMA pair in bf16 at D = 64, 128 and 256
(``launch_bwd_fma``). Their plain version is ``ref.attention_bwd_ref``.

``lse`` is f32 (B, Hq, S), the natural-log row statistic of
``ref.attention_ref(return_lse=True)``, +inf for a row that sees no key. The
kernels keep it in a row of ``lse_stride(S)`` floats per (batch, head), so that
the backward can copy 64 rows of it with one 16-byte aligned bulk copy; the
tensors handed out are views of the first S.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (8, 16, 64, 128, 256)
WGMMA_HEAD_DIMS = (16, 64, 128, 256)
MMA_BWD_HEAD_DIMS = (16, 64, 128)
WGMMA_BWD_HEAD_DIMS = (16, 64, 128, 256)
FMA_BWD_BF16_HEAD_DIMS = (8, 64, 128, 256)  # the FMA pair is not built for bf16 at D = 16 (the wgmma pair's)
LSE_ROWS = 64  # the backward's q tile: lse rows are padded to a multiple of it
KEY_TILE = 64  # keys of a dK/dV block of the wgmma backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}  # variant -> ctypes function
MMA_BWD_LAUNCHES = 0  # launches of the mma backward pair, the yardstick ops never runs
# Host-side errors of flash_attention_fwd_wgmma, beside the cudaError_t of a launch
_HOST_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled", -2: "a TMA tensor map could not be encoded"}


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs attention in ``dtype`` at head dim ``D``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS else "fma"


def bwd_variant(dtype: torch.dtype, D: int) -> str:
    """The backward kernel pair that runs attention's gradient in ``dtype`` at head dim ``D``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_BWD_HEAD_DIMS else "fma"


def dkdv_splits(B: int, Hkv: int, G: int, T: int, n_sm: int) -> int:
    """Groups into which the D = 256 wgmma dK/dV kernel splits each kv group's
    G q-heads: 1 (no partial sums) where its grid of one block per (64-key
    tile, batch, kv-head) already has a block for every one of the card's
    ``n_sm`` SMs; else the smallest divisor of G that gives two blocks an SM
    (the blocks differ in length under a causal mask, and the second wave
    evens them out), or G."""
    blocks = B * Hkv * -(-T // KEY_TILE)
    if blocks >= n_sm:
        return 1
    return next((s for s in range(2, G + 1) if G % s == 0 and blocks * s >= 2 * n_sm), G)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lse_stride(S: int) -> int:
    """Floats per (batch, head) row of an ``lse`` buffer: S rounded up to LSE_ROWS."""
    return -(-S // LSE_ROWS) * LSE_ROWS


def new_lse(B: int, Hq: int, S: int, device) -> torch.Tensor:
    """An ``lse`` buffer for the wgmma forward to fill: the (B, Hq, S) view of
    (B, Hq, lse_stride(S)) floats; the forward writes +inf into the padding."""
    return torch.empty((B, Hq, lse_stride(S)), dtype=torch.float32, device=device)[..., :S]


def check_lse_layout(lse: torch.Tensor) -> None:
    """Raise unless ``lse`` (B, Hq, S) is a ``new_lse`` view, the layout the
    wgmma backward reads: f32 rows of ``lse_stride(S)`` floats from a 16-byte
    aligned base (the wgmma forward fills it)."""
    B, Hq, S = lse.shape
    n = lse_stride(S)
    if not (lse.dtype == torch.float32 and lse.stride() == (Hq * n, n, 1) and lse.data_ptr() % 16 == 0
            and lse.untyped_storage().nbytes() >= (lse.storage_offset() + B * Hq * n) * 4):
        raise ValueError(f"lse of strides {lse.stride()} is not a new_lse view (rows of {n} floats): the wgmma "
                         "backward reads the lse that flash_attention(..., return_lse=True) wrote")


def check_tma_layout(*tensors: torch.Tensor) -> None:
    """TMA (the wgmma forward and backward) and the 16-byte loads of the mma
    backward read rows of 16-byte aligned memory: raise unless every base
    address is 16-byte aligned and every stride of an axis longer than 1 is a
    multiple of 8 bf16 elements (the model's tensors always are)."""
    for t in tensors:
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s % 8 for s in strides):
            raise ValueError(
                f"the wgmma flash kernels and the mma backward read 16-byte rows: they need a 16-byte aligned base "
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
            fn.argtypes = [p, p, p, p, p, i64, i, i, i, i, i, i, i, i] + [i64] * 12 + [p]
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
        elif name == "bwd_mma":
            fn = lib.flash_attention_bwd_mma
            fn.argtypes = [p] * 10 + [i] * 8 + [i64] * 24 + [p]
        else:
            fn = lib.flash_attention_bwd_wgmma
            fn.argtypes = [p] * 11 + [i64] + [i] * 9 + [i64] * 24 + [p]  # part, lse_stride, splits, ...
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _run(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None,
         lse: torch.Tensor | None = None):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    extra = [_DTYPE_CODE[q.dtype]] if name == "fma" else [0 if lse is None else lse.data_ptr(), lse_stride(S)]
    err = _fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *extra,
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


def launch_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None,
                 lse: torch.Tensor | None = None) -> torch.Tensor:
    """The wgmma kernel, bf16 at a head dim of ``WGMMA_HEAD_DIMS``, inputs
    laid out as ``check_tma_layout`` asks. With ``lse`` (a ``new_lse``
    buffer) it also writes the rows' statistics there."""
    return _run("wgmma", q, k, v, causal, window, lse)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None,
           lse: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, S, Hq, D), k/v: (B, T, Hkv, D) CUDA tensors with unit stride on
    D. The caller (``ops.flash_attention``) has checked devices, types and
    shapes. Launches the kernel ``variant`` names on the current stream and
    returns o: (B, S, Hq, D); with ``lse`` (a ``new_lse`` buffer, the wgmma
    kernel only) the rows' statistics go there too."""
    if variant(q.dtype, q.shape[-1]) == "wgmma":
        return launch_wgmma(q, k, v, causal=causal, window=window, lse=lse)
    if lse is not None:
        raise ValueError("only the wgmma flash kernel writes the row statistics")
    return launch_fma(q, k, v, causal=causal, window=window)


def _run_bwd(name: str, q, k, v, o, do, causal: bool, window: int | None, lse: torch.Tensor | None = None,
             splits: int = 1):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    tensors = (q, k, v, o, do, dq, dk, dv)
    if name == "bwd_wgmma":
        dr = torch.empty((B, Hq, lse_stride(S)), dtype=torch.float32, device=q.device)  # dQ kernel -> dK/dV kernel
        # the head groups' partial sums of dK and dV (D = 256 with splits > 1)
        part = torch.empty((2, splits, B, T, Hkv, D), dtype=torch.float32, device=q.device) if splits > 1 else None
        extra = [0 if part is None else part.data_ptr(), lse_stride(S), splits]
    else:  # the row statistics, recomputed by the first kernel for the second
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        dr = torch.empty_like(lse)
        extra = [_DTYPE_CODE[q.dtype]] if name == "bwd_fma" else []
    err = _bwd_fn(name)(
        *(t.data_ptr() for t in tensors), lse.data_ptr(), dr.data_ptr(), *extra,
        B, S, T, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
        *(s for t in tensors for s in t.stride()[:3]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward ({name}) kernel launch failed: "
                           f"{_HOST_ERRORS.get(err, f'cudaError {err}')}")
    return dq, dk, dv


def launch_bwd_fma(q, k, v, o, do, *, causal: bool, window: int | None):
    """The FMA backward pair: f32 at any head dim of ``HEAD_DIMS``, bf16 at one
    of ``FMA_BWD_BF16_HEAD_DIMS``."""
    return _run_bwd("bwd_fma", q, k, v, o, do, causal, window)


def launch_bwd_mma(q, k, v, o, do, *, causal: bool, window: int | None):
    """The mma backward pair, bf16 at a head dim of ``MMA_BWD_HEAD_DIMS``,
    every tensor laid out as ``check_tma_layout`` asks (16-byte loads)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in MMA_BWD_HEAD_DIMS:
        raise ValueError(f"the mma backward pair is built for bf16 at head dims {MMA_BWD_HEAD_DIMS}, "
                         f"not {q.dtype} at {q.shape[-1]}")
    global MMA_BWD_LAUNCHES
    grads = _run_bwd("bwd_mma", q, k, v, o, do, causal, window)
    MMA_BWD_LAUNCHES += 1
    return grads


def launch_bwd_wgmma(q, k, v, o, do, lse, *, causal: bool, window: int | None, splits: int | None = None):
    """The wgmma backward pair, bf16 at a head dim of ``WGMMA_BWD_HEAD_DIMS``,
    every tensor laid out as ``check_tma_layout`` asks; ``lse`` the row
    statistics the wgmma forward wrote (``check_lse_layout``). At D = 256
    ``splits`` (a divisor of Hq / Hkv) sets the dK/dV kernel's q-head
    groups; None takes ``dkdv_splits`` for this card."""
    check_lse_layout(lse)
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if splits is None:
        splits = dkdv_splits(B, Hkv, Hq // Hkv, T, _sm_count(q.device.index)) if D == 256 else 1
    return _run_bwd("bwd_wgmma", q, k, v, o, do, causal, window, lse, splits)


def launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor | None, *, causal: bool, window: int | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel pair ``bwd_variant`` names: q, o, do (B, S, Hq, D)
    and k, v (B, T, Hkv, D) CUDA tensors of one dtype with unit stride on D,
    as the forward took them; o is the forward's output, ``lse`` its row
    statistics (read by the wgmma pair, which needs them; the FMA pair
    recomputes them). The caller (``ops.flash_attention_bwd``) has checked
    devices, types, shapes and, for the wgmma pair, the layout and ``lse``.
    -> (dq, dk, dv), contiguous, in q's dtype."""
    if bwd_variant(q.dtype, q.shape[-1]) == "wgmma":
        return launch_bwd_wgmma(q, k, v, o, do, lse, causal=causal, window=window)
    return launch_bwd_fma(q, k, v, o, do, causal=causal, window=window)
