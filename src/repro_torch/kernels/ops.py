"""Public kernel wrappers: dispatch on the tensors' device and count launches.

Layout conventions match the model code: attention takes (B, S, H, D) and
returns the same; the RG-LRU scan takes (B, S, W). For a CUDA tensor a
wrapper launches its hand-written kernel and adds one to its launch counter;
any error raises, there is no fallback. For a CPU tensor it calls the plain
version in ``ref.py`` and the counter does not move. Any other device, an
unsupported dtype or head dim, or a last axis that is not contiguous raises
(the scan needs both inputs contiguous), as does a layout the wgmma flash
kernel cannot read through TMA, on either device.

Gradients: where autograd records (grad mode on and an input that requires
grad), ``flash_attention``, ``fused_rmsnorm`` and ``rglru_scan`` run through a
``torch.autograd.Function`` whose backward calls ``flash_attention_bwd``,
``fused_rmsnorm_bwd`` or ``rglru_scan_bwd``, which dispatch the same way (the
hand-written backward kernel for a CUDA tensor, the plain backward in
``ref.py`` for a CPU one). Flash attention's forward then also keeps the rows'
statistics ``lse`` for the backward where the backward reads them (the plain
version, and the wgmma backward pair); the scan's keeps a and its output h.

Each public wrapper runs under the range its JAX counterpart's
``jax.named_scope`` names (``flash_attention``, ``fused_rmsnorm``,
``rglru_scan``; ``core/scope.py``, entered only while a profiler records),
and each kernel launch is marked with the work the kernel does
(``flash_work``, ``rmsnorm_work``, ``rglru_work``: the counts that
``chip_smoke.py`` bounds each kernel by), so the device tree of a profiled
step sees the hand-written kernels' work and device time under their
callers.

**The meta device** (shapes only, for the dry-run's plan,
``launch/dryrun.py``): a wrapper checks its inputs as on the card, returns
empty meta tensors of its kernel's outputs (flash attention's ``lse`` where
the card's kernel writes it) and reports the kernel's work to the cost
tracer of ``core/meta_cost.py`` (``record_kernel``) where one traces. It
computes nothing, launches nothing and moves no launch counter; a meta
tensor never reaches a plain version (but inside ``plain_versions``, which
runs them on any device).

``plain_versions`` is for checks that hold the kernels to their plain
versions on the card: inside it the named kernels take their plain versions
(forward and backward) whatever the device, and count no launch. The model's
paths never enter it.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager

import torch

from repro_torch.core import meta_cost
from repro_torch.core.scope import kernel_launch, scope

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
RGLRU_SCAN_LAUNCHES = 0  # the chunked kernel, the only one ops launches
FLASH_ATTENTION_BWD_LAUNCHES = 0  # one per backward (a pair of kernels), either variant ops picks
FLASH_ATTENTION_BWD_WGMMA_LAUNCHES = 0  # those that took the wgmma pair
FUSED_RMSNORM_BWD_LAUNCHES = 0  # one per backward: the row pass and the column sum
RGLRU_SCAN_BWD_LAUNCHES = 0  # the chunked kernel run backward in time

KERNELS = ("flash_attention", "fused_rmsnorm", "rglru_scan")  # each with its backward
_PLAIN: frozenset[str] = frozenset()  # the kernels that take their plain versions on any device


@contextmanager
def plain_versions(*kernels: str):
    """Within: ``kernels`` (all of ``KERNELS`` when none is named), forward and
    backward, run their plain versions in ``ref.py`` whatever the device, and
    count no launch."""
    global _PLAIN
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; expected some of {KERNELS}")
    saved, _PLAIN = _PLAIN, frozenset(kernels or KERNELS)
    try:
        yield
    finally:
        _PLAIN = saved


def _plain(kernel: str, t: torch.Tensor) -> bool:
    """Whether ``kernel`` takes its plain version for a tensor on ``t``'s device."""
    return t.device.type == "cpu" or kernel in _PLAIN


# launch_counts() key -> (module, counter): the wrappers' counters, and the
# two yardstick kernels' that their own launchers keep
_self = sys.modules[__name__]
_COUNTERS = {
    "flash_attention": (_self, "FLASH_ATTENTION_LAUNCHES"),
    "flash_attention_wgmma": (_self, "FLASH_ATTENTION_WGMMA_LAUNCHES"),
    "fused_rmsnorm": (_self, "FUSED_RMSNORM_LAUNCHES"),
    "rglru_scan": (_self, "RGLRU_SCAN_LAUNCHES"),
    "rglru_scan_sequential": (_rglru, "SEQUENTIAL_LAUNCHES"),  # never launched through ops
    "flash_attention_bwd": (_self, "FLASH_ATTENTION_BWD_LAUNCHES"),
    "flash_attention_bwd_wgmma": (_self, "FLASH_ATTENTION_BWD_WGMMA_LAUNCHES"),
    "flash_attention_bwd_mma": (_flash, "MMA_BWD_LAUNCHES"),  # never launched through ops
    "fused_rmsnorm_bwd": (_self, "FUSED_RMSNORM_BWD_LAUNCHES"),
    "rglru_scan_bwd": (_self, "RGLRU_SCAN_BWD_LAUNCHES"),
}


def launch_counts() -> dict[str, int]:
    return {key: getattr(mod, attr) for key, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys of ``launch_counts()``) to the counters. A CUDA
    graph's replay launches the kernels it captured without running the
    wrappers that count them: ``core/engines.py`` adds the capture's count
    once per replay, and takes it back off after the capture, which ran no
    kernel."""
    for key, n in delta.items():
        mod, attr = _COUNTERS[key]
        setattr(mod, attr, getattr(mod, attr) + n)


def causal_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs each (batch, head) of attention computes:
    query i sees keys ``max(0, i - window + 1) .. i`` when causal, all T
    keys otherwise."""
    if not causal:
        return S * T
    w = min(window or T, T)
    full = min(w, S)  # queries 0 .. full-1 see i + 1 keys, the rest w
    return full * (full + 1) // 2 + (S - full) * w


def flash_work(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int | None, *,
               backward: bool = False) -> tuple[float, float]:
    """-> (flops, bytes) of one flash-attention launch: two S x T x D
    products a head over the pairs the mask keeps (the backward: five, 2.5 x
    the forward's, as it recomputes the scores), q, k, v read and o written
    (the backward: q, o, do, k, v read, dq, dk, dv written)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    flops = 4.0 * B * Hq * D * causal_pairs(S, T, causal, window)
    per = 4 if backward else 2
    nbytes = q.element_size() * per * (B * S * Hq * D + B * T * Hkv * D)
    return (2.5 * flops if backward else flops), float(nbytes)


def rmsnorm_work(x: torch.Tensor, dy: torch.Tensor | None = None) -> tuple[float, float]:
    """-> (0, bytes) of one RMSNorm launch: x read and y written, the f32
    scale read; with ``dy``, of the backward: x and dy read, dx written,
    scale read and dscale written. Its arithmetic is no dot: the tree's
    flops stay 0."""
    D = x.shape[-1]
    if dy is not None:
        return 0.0, float(x.numel() * (2 * x.element_size() + dy.element_size()) + 8 * D)
    return 0.0, float(2 * x.numel() * x.element_size() + 4 * D)


def rglru_work(a: torch.Tensor, *, backward: bool = False) -> tuple[float, float]:
    """-> (0, bytes) of one scan launch: a and b read, h written (the
    backward: a, h, dh read, da, db written)."""
    return 0.0, float((5 if backward else 3) * a.numel() * a.element_size())


def _device_type(*tensors: torch.Tensor) -> str:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}: the kernels run on cuda, their plain versions on cpu, "
                         "their shapes on meta")
    return dev.type


def _meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def flash_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention of q over k and v. ``return_lse`` also returns the
    rows' statistics ``lse`` (B, Hq, S) f32 that the backward reads, for a
    caller that runs ``flash_attention_bwd`` itself: it raises where autograd
    records the call, whose output would carry no gradient on the card. On
    the card only the wgmma kernel writes them."""
    with scope("flash_attention"):
        return _flash_attention(q, k, v, causal, window, return_lse)


def _flash_attention(q, k, v, causal: bool, window: int | None, return_lse: bool):
    _device_type(q, k, v)
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
    if _wgmma(q):
        _flash.check_tma_layout(q, k, v)
    if return_lse:
        if _records(q, k, v):
            raise ValueError("return_lse is for a caller that runs flash_attention_bwd itself; autograd records "
                             "this call: drop return_lse, or call under torch.no_grad()")
        if q.device.type == "cuda" and not _wgmma(q):
            raise ValueError(f"only the wgmma flash kernel writes the row statistics; {q.dtype} at D = {D} takes "
                             "the FMA kernel")
        return _flash_fwd(q, k, v, causal, window, with_lse=True)
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_fwd(q, k, v, causal, window)


def _records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _wgmma(q: torch.Tensor) -> bool:
    return _flash.variant(q.dtype, q.shape[-1]) == "wgmma"


def _flash_fwd(q, k, v, causal: bool, window: int | None, with_lse: bool = False):
    """-> o, or (o, lse) ``with_lse``."""
    if _plain("flash_attention", q):
        t = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window,
                              return_lse=with_lse)
        return (t[0].transpose(1, 2), t[1]) if with_lse else t.transpose(1, 2)
    global FLASH_ATTENTION_LAUNCHES, FLASH_ATTENTION_WGMMA_LAUNCHES
    B, S, Hq, _ = q.shape
    lse = _flash.new_lse(B, Hq, S, q.device) if with_lse else None
    if _meta(q):
        meta_cost.record_kernel("flash_attention", *flash_work(q, k, causal, window))
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return (o, lse) if with_lse else o
    with kernel_launch("flash_attention", lambda: flash_work(q, k, causal, window)):
        o = _flash.launch(q, k, v, causal=causal, window=window, lse=lse)
    FLASH_ATTENTION_LAUNCHES += 1
    FLASH_ATTENTION_WGMMA_LAUNCHES += _wgmma(q)
    return (o, lse) if with_lse else o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        # the plain backward and the wgmma pair read the forward's row
        # statistics; the FMA pair recomputes them
        if _plain("flash_attention", q) or _flash.bwd_variant(q.dtype, q.shape[-1]) == "wgmma":
            o, lse = _flash_fwd(q, k, v, causal, window, with_lse=True)
        else:
            o, lse = _flash_fwd(q, k, v, causal, window), None
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal, window=ctx.window, lse=lse)
        return dq, dk, dv, None, None


def flash_attention_bwd(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, Hq, D): the forward's output
    do: torch.Tensor,  # its gradient
    *,
    causal: bool = True,
    window: int | None = None,
    lse: torch.Tensor | None = None,  # (B, Hq, S): the forward's row statistics
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention` -> (dq, dk, dv), in q's dtype
    and layout. Takes what the forward took (checked as there), plus its
    output and the output's gradient, both of q's shape and dtype, and the
    row statistics ``lse`` that ``flash_attention(..., return_lse=True)``
    gives. The plain backward recomputes them when ``lse`` is None; the wgmma
    pair (bf16 at D 16/64/128/256 on the card) needs them."""
    with scope("flash_attention"):
        return _flash_attention_bwd(q, k, v, o, do, causal, window, lse)


def _flash_attention_bwd(q, k, v, o, do, causal: bool, window: int | None, lse):
    _device_type(q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if o.stride(-1) != 1:
        raise ValueError("the head-dim axis must be contiguous")
    B, S, Hq, _ = q.shape
    if lse is not None and (lse.shape != (B, Hq, S) or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} on {lse.device} must be f32 {(B, Hq, S)} on {q.device}")
    do = do.contiguous()  # autograd may hand an expanded or strided gradient
    wgmma = _flash.bwd_variant(q.dtype, q.shape[-1]) == "wgmma"
    if wgmma:
        _flash.check_tma_layout(q, k, v, o, do)
    if _plain("flash_attention", q):
        t = [a.transpose(1, 2) for a in (q, k, v, o, do)]
        return tuple(g.transpose(1, 2) for g in ref.attention_bwd_ref(*t, causal=causal, window=window, lse=lse))
    if wgmma and lse is None:
        raise ValueError("the wgmma backward reads the forward's row statistics: pass lse "
                         "(flash_attention(..., return_lse=True) gives them)")
    if _meta(q):
        meta_cost.record_kernel("flash_attention_bwd", *flash_work(q, k, causal, window, backward=True))
        return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    global FLASH_ATTENTION_BWD_LAUNCHES, FLASH_ATTENTION_BWD_WGMMA_LAUNCHES
    with kernel_launch("flash_attention_bwd", lambda: flash_work(q, k, causal, window, backward=True)):
        grads = _flash.launch_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    FLASH_ATTENTION_BWD_LAUNCHES += 1
    FLASH_ATTENTION_BWD_WGMMA_LAUNCHES += wgmma
    return grads


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; x (..., D) in f32 or bf16, scale (D,) f32."""
    with scope("fused_rmsnorm"):
        return _fused_rmsnorm(x, scale, eps)


def _fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _device_type(x, scale)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} does not match last axis {D}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype}: need one of {DTYPES}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.stride(-1) != 1 or scale.stride(-1) != 1:
        raise ValueError("the normalised axis must be contiguous")
    if _records(x, scale):
        return _FusedRMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if _plain("fused_rmsnorm", x):
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if _meta(x):
        meta_cost.record_kernel("fused_rmsnorm", *rmsnorm_work(x))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    global FUSED_RMSNORM_LAUNCHES
    with kernel_launch("fused_rmsnorm", lambda: rmsnorm_work(x)):
        y = _rmsnorm.launch(x.view(-1, x.shape[-1]), scale, eps)
    FUSED_RMSNORM_LAUNCHES += 1
    return y.view(x.shape)


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = fused_rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def fused_rmsnorm_bwd(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`fused_rmsnorm` -> (dx in x's dtype and shape,
    dscale f32). dy has x's shape, in x's dtype or f32."""
    with scope("fused_rmsnorm"):
        return _fused_rmsnorm_bwd(x, scale, dy, eps)


def _fused_rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float):
    _device_type(x, scale, dy)
    D = x.shape[-1]
    if dy.shape != x.shape or dy.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must have x's shape {tuple(x.shape)}, in {x.dtype} or f32")
    if x.stride(-1) != 1:
        raise ValueError("the normalised axis must be contiguous")
    dy = dy.contiguous()  # autograd may hand an expanded or strided gradient
    if _plain("fused_rmsnorm", x):
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    if _meta(x):
        meta_cost.record_kernel("fused_rmsnorm_bwd", *rmsnorm_work(x, dy))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device), torch.empty(D, device=x.device)
    global FUSED_RMSNORM_BWD_LAUNCHES
    with kernel_launch("fused_rmsnorm_bwd", lambda: rmsnorm_work(x, dy)):
        dx, dscale = _rmsnorm.launch_bwd(x.view(-1, D), scale, dy.view(-1, D), eps)
    FUSED_RMSNORM_BWD_LAUNCHES += 1
    return dx.view(x.shape), dscale


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along S with ``h_{-1} = 0``; a, b (B, S, W)
    contiguous, one dtype, f32 or bf16. -> h (B, S, W) in a's dtype."""
    with scope("rglru_scan"):
        return _rglru_scan(a, b)


def _rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _device_type(a, b)
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b of one (B, S, W) shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype}: need one of {DTYPES} for both")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if _records(a, b):
        return _RGLRUScan.apply(a, b)
    return _rglru_fwd(a, b)


def _rglru_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _plain("rglru_scan", a):
        return ref.rglru_ref(a, b)
    if _meta(a):
        meta_cost.record_kernel("rglru_scan", *rglru_work(a))
        return torch.empty(a.shape, dtype=a.dtype, device=a.device)
    global RGLRU_SCAN_LAUNCHES
    with kernel_launch("rglru_scan", lambda: rglru_work(a)):
        h = _rglru.launch(a, b)
    RGLRU_SCAN_LAUNCHES += 1
    return h


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _rglru_fwd(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_scan` -> (da, db) in a's dtype, from a,
    the scan's output h and h's gradient dh: (B, S, W) of one dtype, f32 or
    bf16, a and h contiguous (checked as there)."""
    with scope("rglru_scan"):
        return _rglru_scan_bwd(a, h, dh)


def _rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _device_type(a, h, dh)
    if a.ndim != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"expected a, h and dh of one (B, S, W) shape; got {tuple(a.shape)}, {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}")
    if a.dtype not in DTYPES or h.dtype != a.dtype or dh.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {h.dtype}, {dh.dtype}: need one of {DTYPES} for all three")
    if not (a.is_contiguous() and h.is_contiguous()):
        raise ValueError("a and h must be contiguous")
    dh = dh.contiguous()  # autograd may hand an expanded or strided gradient
    if _plain("rglru_scan", a):
        return ref.rglru_bwd_ref(a, h, dh)
    if _meta(a):
        meta_cost.record_kernel("rglru_scan_bwd", *rglru_work(a, backward=True))
        return tuple(torch.empty(a.shape, dtype=a.dtype, device=a.device) for _ in range(2))
    global RGLRU_SCAN_BWD_LAUNCHES
    with kernel_launch("rglru_scan_bwd", lambda: rglru_work(a, backward=True)):
        grads = _rglru.launch_bwd(a, h, dh)
    RGLRU_SCAN_BWD_LAUNCHES += 1
    return grads
