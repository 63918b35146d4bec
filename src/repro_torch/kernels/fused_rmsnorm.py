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

The backward (:func:`launch_bwd`; the JAX package has no backward kernel, it
trains through plain ``jnp``) is bound by bytes too: x and dy read once, dx
written once. One program per SM (two at narrow rows, ``_bwd_tiling``)
walks a stride of row blocks, each block several rows wide (``BLOCK_R``
rows of ``BLOCK_D`` columns, about 8K elements) so a program has many loads in
flight, and ``tl.range(..., num_stages=3)`` loads the next blocks' x and dy
while this block's math runs. It recomputes ``rsqrt(mean(x^2) + eps)`` from x
and writes ``dx = r * (g - xhat * mean(g * xhat))`` with ``g = dy * (1 +
scale)``; the column sum ``dscale = sum_rows(dy * xhat)`` is kept per program
in f32 registers and written as one row of partials, few rows since there are
few programs, and a second kernel sums the partials over many narrow column
strips. No atomics: the result is the same on every run.
Its plain version is ``ref.rmsnorm_bwd_ref``.
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

        @triton.jit
        def _rmsnorm_bwd_kernel(
            x_ptr, dy_ptr, s_ptr, dx_ptr, part_ptr, rows, D, x_stride, dy_stride, dx_stride, eps,
            BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr,
        ):
            pid = tl.program_id(0)
            step = tl.num_programs(0) * BLOCK_R
            c = tl.arange(0, BLOCK_D)
            cmask = c < D
            w = 1.0 + tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
            dscale = tl.zeros((BLOCK_D,), dtype=tl.float32)
            for r0 in tl.range(pid * BLOCK_R, rows, step, num_stages=3):
                r = r0 + tl.arange(0, BLOCK_R)
                r64 = r.to(tl.int64)
                m = (r < rows)[:, None] & cmask[None, :]
                x = tl.load(x_ptr + r64[:, None] * x_stride + c[None, :], mask=m, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + r64[:, None] * dy_stride + c[None, :], mask=m, other=0.0).to(tl.float32)
                inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / D + eps)
                xhat = x * inv[:, None]
                g = dy * w[None, :]
                mean_gx = tl.sum(g * xhat, axis=1) / D
                dx = inv[:, None] * (g - xhat * mean_gx[:, None])
                tl.store(dx_ptr + r64[:, None] * dx_stride + c[None, :], dx.to(dx_ptr.dtype.element_ty), mask=m)
                dscale += tl.sum(dy * xhat, axis=0)
            tl.store(part_ptr + pid * D + c, dscale, mask=cmask)

        @triton.jit
        def _colsum_kernel(part_ptr, out_ptr, n, D, BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
            c = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = c < D
            acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
            for n0 in tl.range(0, n, BLOCK_N, num_stages=2):
                i = n0 + tl.arange(0, BLOCK_N)
                m = (i < n)[:, None] & cmask[None, :]
                acc += tl.sum(tl.load(part_ptr + i[:, None] * D + c[None, :], mask=m, other=0.0), axis=0)
            tl.store(out_ptr + c, acc, mask=cmask)

        _KERNEL = (triton, _rmsnorm_kernel, _rmsnorm_bwd_kernel, _colsum_kernel)
    return _KERNEL


def launch(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x2: (rows, D) CUDA tensor with unit column stride; scale: (D,) f32.
    The caller (``ops.fused_rmsnorm``) has checked devices and types."""
    triton, kern, _, _ = _kernel()
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


def _bwd_tiling(rows: int, D: int, n_sm: int) -> tuple[int, int, int, int]:
    """-> (BLOCK_D, BLOCK_R, programs, warps) of the backward's row kernel:
    blocks of about 8K elements, one program of 8 warps an SM at wide rows,
    two of 4 warps at narrow ones (their partial rows of dscale stay few
    either way). Chosen by timing the four training shapes on an H100."""
    block_d = 1 << max(0, D - 1).bit_length()
    block_r = max(1, min(128, 8192 // block_d))
    wide = block_d >= 1024
    return block_d, block_r, min(-(-rows // block_r), (1 if wide else 2) * n_sm), 8 if wide else 4


def launch_bwd(
    x2: torch.Tensor, scale: torch.Tensor, dy2: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """x2, dy2: (rows, D) CUDA tensors with unit column stride (dy2 in x2's
    dtype or f32); scale: (D,) f32. The caller (``ops.fused_rmsnorm_bwd``)
    has checked devices and types. -> (dx in x2's dtype, dscale f32)."""
    triton, _, kern, colsum = _kernel()
    rows, D = x2.shape
    dx = torch.empty((rows, D), dtype=x2.dtype, device=x2.device)
    n_sm = torch.cuda.get_device_properties(x2.device).multi_processor_count
    block_d, block_r, programs, warps = _bwd_tiling(rows, D, n_sm)
    part = torch.empty((programs, D), dtype=torch.float32, device=x2.device)
    kern[(programs,)](
        x2, dy2, scale, dx, part, rows, D, x2.stride(0), dy2.stride(0), dx.stride(0), eps,
        BLOCK_R=block_r, BLOCK_D=block_d, num_warps=warps,
    )
    dscale = torch.empty(D, dtype=torch.float32, device=x2.device)
    colsum[(triton.cdiv(D, 32),)](part, dscale, programs, D, BLOCK_N=64, BLOCK_C=32, num_warps=4)
    return dx, dscale
