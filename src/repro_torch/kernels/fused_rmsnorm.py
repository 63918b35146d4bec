"""Fused RMSNorm in Triton for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_rmsnorm.py``
(``_rmsnorm_kernel``, launched by ``fused_rmsnorm_pallas``):
``y = x * rsqrt(mean(x^2) + eps) * (1 + scale)`` row by row, statistics in
f32, output in x's dtype.

Bound on the H100: bytes. Each element is read once and written once and
costs a handful of operations, far below the ~295 operations per byte at
which the tensor cores would become the limit. The design therefore keeps a
whole row in registers so that x is read from device memory exactly once:
one program normalises a block of rows, the row's columns are padded to the
next power of two (``BLOCK_D``) and masked, and the mean divides by the true
width ``D``. Blocks of rows keep each program at a few thousand elements, so
the narrow qk-norm rows (D = head_dim) still give each program enough work.

Its plain version is ``ref.rmsnorm_ref``.
"""

from __future__ import annotations

import torch

_KERNEL = None


def _kernel():
    """Define the Triton kernel on first use: ``triton`` exists only where a
    card does, and importing this module must not need it."""
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rmsnorm_kernel(
            x_ptr, s_ptr, y_ptr, rows, D, x_stride, y_stride, eps,
            BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr,
        ):
            r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
            c = tl.arange(0, BLOCK_D)
            r64 = r.to(tl.int64)
            cmask = c < D
            m = (r < rows)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + r64[:, None] * x_stride + c[None, :], mask=m, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1) / D
            inv = 1.0 / tl.sqrt(var + eps)
            s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
            y = x * inv[:, None] * (1.0 + s[None, :])
            tl.store(y_ptr + r64[:, None] * y_stride + c[None, :], y.to(y_ptr.dtype.element_ty), mask=m)

        _KERNEL = (triton, _rmsnorm_kernel)
    return _KERNEL


def launch(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x2: (rows, D) CUDA tensor with unit column stride; scale: (D,) f32.
    The caller (``ops.fused_rmsnorm``) has checked devices and types."""
    triton, kern = _kernel()
    rows, D = x2.shape
    y = torch.empty((rows, D), dtype=x2.dtype, device=x2.device)
    block_d = triton.next_power_of_2(D)
    block_r = max(1, min(64, 8192 // block_d))
    grid = (triton.cdiv(rows, block_r),)
    kern[grid](
        x2, scale, y, rows, D, x2.stride(0), y.stride(0), eps,
        BLOCK_R=block_r, BLOCK_D=block_d, num_warps=8 if block_d >= 2048 else 4,
    )
    return y
