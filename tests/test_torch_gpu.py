"""The port on the card (``-m gpu``): each hand-written kernel and backward
kernel against its plain version, the smoke model's kernel path against its
plain path on the CPU, and one train step on the card against the CPU with
the backward kernels' launches counted. Skips where there is no CUDA card;
imports no JAX, so it runs on a machine that has none."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rgk
from repro_torch.launch.serve import BatchedServer, make_requests
from repro_torch.models import Model
from repro_torch.models.modules import at_unstacked_std, tree_map_with_path
from repro_torch.models.transformer import layer_kind

# tests/test_kernels.py's tolerances
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, None),   # MHA, single block
    (2, 256, 256, 4, 1, 64, None),   # MQA, multi-block
    (1, 384, 384, 4, 2, 128, None),  # GQA, non-square block count
    (1, 100, 100, 2, 2, 64, None),   # ragged
    (1, 128, 256, 2, 2, 64, None),   # cross: kv longer than q
    (1, 256, 256, 2, 2, 64, 16),     # sliding windows
    (1, 256, 256, 2, 2, 64, 64),
    (1, 256, 256, 2, 2, 64, 1024),
    (1, 128, 128, 8, 1, 256, None),  # gemma: MQA, D = 256
    (1, 384, 384, 4, 1, 256, 128),   # recurrentgemma: windowed MQA, D = 256; late rows start on masked tiles
    (2, 64, 64, 4, 2, 16, None),     # smoke head dims
    (2, 40, 40, 6, 2, 8, None),
    # tile edges of the wgmma kernel (128 query rows; 128 keys, 64 at D = 256)
    (1, 200, 200, 4, 2, 128, None),  # ragged S and T across a multiple of 128
    (1, 300, 300, 4, 1, 256, None),
    (1, 100, 300, 4, 2, 128, None),  # S < T
    (1, 260, 130, 2, 1, 256, None),  # S > T
    (1, 512, 512, 4, 4, 128, 200),   # windows that are no multiple of a tile
    (1, 512, 512, 2, 1, 256, 100),
    (2, 256, 256, 4, 4, 128, None),  # Hq / Hkv = 1, 4 and 16 with B > 1
    (2, 256, 256, 16, 4, 128, None),
    (2, 320, 320, 16, 1, 256, 96),
    (2, 192, 192, 4, 2, 256, None),  # D = 256 with Hkv > 1 and B > 1: the dK/dV grid's head groups
    (1, 256, 256, 2, 2, 256, 64),    # D = 256 with Hq = Hkv: no head groups
    (4, 64, 64, 4, 1, 16, 8),        # recurrentgemma smoke: windowed MQA at head dim 16
    (2, 256, 256, 12, 2, 128, None),  # qwen2-vl: GQA 12 / 2, a group of 6
    (1, 200, 200, 12, 2, 128, None),
    (2, 192, 192, 24, 24, 64, None),  # musicgen: MHA, 24 heads at head dim 64
    (1, 300, 300, 24, 24, 64, None),
]
# Beside the sweep's tolerance, the wgmma kernel's bf16 output stays within one
# bf16 rounding of the plain version that feeds P as the same two bf16 terms
# (attention_ref(p_bf16=2)): |err| <= 2^-7 |want| + TWO_TERM_ATOL. Both sides
# sum in f32 and round once to bf16, so they part only where the f32 values
# straddle a rounding boundary; the atol covers outputs near 0, where f32
# summation order alone moves the value by ~1e-6.
TWO_TERM_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL[dtype])


def _qkv(card, seed, B, S, T, Hq, Hkv, D, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, S, Hq, D), generator=g, device=card).to(TDT[dtype])
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=card).to(TDT[dtype]) for _ in range(2))
    return q, k, v


def _attention_ref(q, k, v, **kw):
    return ops.ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", FLASH_CASES)
def test_flash_kernel_vs_plain(card, B, S, T, Hq, Hkv, D, window, dtype):
    """Through ops: bf16 at D >= 16 takes the wgmma kernel, the rest the FMA one."""
    q, k, v = _qkv(card, 7, B, S, T, Hq, Hkv, D, dtype)
    wgmma = flash.variant(q.dtype, D) == "wgmma"
    for causal in (True, False):
        before = ops.launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after["flash_attention"] == before["flash_attention"] + 1
        assert after["flash_attention_wgmma"] == before["flash_attention_wgmma"] + wgmma
        _close(got, _attention_ref(q, k, v, causal=causal, window=window), dtype)


BF16_CASES = [c for c in FLASH_CASES if c[5] != 8]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", BF16_CASES)
def test_flash_fma_kernel_vs_plain_in_bf16(card, B, S, T, Hq, Hkv, D, window):
    """The FMA kernel, which ops no longer picks for bf16 at these head dims,
    still holds the bf16 tolerance there."""
    q, k, v = _qkv(card, 7, B, S, T, Hq, Hkv, D, "bf16")
    for causal in (True, False):
        got = flash.launch_fma(q, k, v, causal=causal, window=window)
        _close(got, _attention_ref(q, k, v, causal=causal, window=window), "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", BF16_CASES)
def test_flash_wgmma_kernel_within_one_rounding_of_two_term_p(card, B, S, T, Hq, Hkv, D, window):
    q, k, v = _qkv(card, 11, B, S, T, Hq, Hkv, D, "bf16")
    for causal in (True, False):
        got = flash.launch_wgmma(q, k, v, causal=causal, window=window).float()
        want = _attention_ref(q, k, v, causal=causal, window=window, p_bf16=2).float()
        excess = float(((got - want).abs() - 2.0**-7 * want.abs()).max())
        assert excess <= TWO_TERM_ATOL, (causal, excess)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_inputs(card):
    """q/k/v as views of a fused qkv projection: strides, no copy."""
    g = torch.Generator(device=card).manual_seed(8)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=g, device=card).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = ops.flash_attention(q, k, v)
    want = ops.ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    _close(got, want, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1000, 512), (64, 2560), (300, 16), (5, 3000),
                                   (4096, 768), (2, 9, 1536)])
def test_rmsnorm_kernel_vs_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(shape, generator=g, device=card).to(TDT[dtype])
    s = torch.randn(shape[-1], generator=g, device=card) * 0.1
    before = ops.FUSED_RMSNORM_LAUNCHES
    got = ops.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.FUSED_RMSNORM_LAUNCHES == before + 1
    _close(got, ops.ref.rmsnorm_ref(x, s), dtype)


def _grad_close(got, want, dtype):
    """The dtype's tolerance with the atol scaled by the gradient's largest
    magnitude: a gradient sums many products (dk and dv over every query row
    of a kv group), and the kernel sums them in another f32 order than the
    plain version, so near-zero entries carry an error of the order of the
    terms, not of the result."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, float(want.abs().max()))
    tol = TOL[dtype]
    err = (got - want).abs()
    assert bool((err <= tol["atol"] * scale + tol["rtol"] * want.abs()).all()), (float(err.max()), scale)


# _grad_close's atol scales with a gradient's largest entry, which under a
# causal mask comes from the first keys; so each flash gradient is also held
# per (batch, head, 64 rows) block at a relative L2 error (chip_smoke.py's
# FLASH_BWD_BLOCK_REL_L2), which a kernel that drops one q tile or one q-head
# of a group fails.
FLASH_BWD_BLOCK_REL_L2 = {"f32": 1e-5, "bf16": 1e-2}


def _block_close(got, want, dtype):
    """Every (batch, head, 64 rows) block of two (B, N, H, D) tensors within
    FLASH_BWD_BLOCK_REL_L2 of ``dtype`` relative L2."""
    B, N, H, _ = want.shape
    sums = []
    for x in (got.float() - want.float(), want.float()):
        sq = x.new_zeros((B, -(-N // 64) * 64, H))
        sq[:, :N] = x.square().sum(dim=3)
        sums.append(sq.unflatten(1, (-1, 64)).sum(dim=2))
    rel = float((sums[0] / sums[1].clamp_min(1e-30)).sqrt().max())  # a zero block must stay zero
    assert rel <= FLASH_BWD_BLOCK_REL_L2[dtype], rel


def _flash_grad_close(got, want, dtype):
    _grad_close(got, want, dtype)
    _block_close(got, want, dtype)


def _forward_for_bwd(q, k, v, **kw):
    """The forward kernel's output, and its lse where the backward ops picks
    reads it (the wgmma pair)."""
    if flash.bwd_variant(q.dtype, q.shape[-1]) == "wgmma":
        return ops.flash_attention(q, k, v, **kw, return_lse=True)
    return ops.flash_attention(q, k, v, **kw), None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", FLASH_CASES)
def test_flash_bwd_kernel_vs_plain(card, B, S, T, Hq, Hkv, D, window, dtype):
    """The backward kernels against ref.attention_bwd_ref over the forward's
    sweep, from the forward kernel's own output (and lse), one launch counted
    each: the wgmma pair through ops for bf16 at D 16/64/128/256, the FMA pair
    otherwise; then the pairs ops does not pick on the wgmma pair's cases, the
    mma pair (built for D 16/64/128) and the FMA pair (built there but for
    D = 16)."""
    q, k, v = _qkv(card, 12, B, S, T, Hq, Hkv, D, dtype)
    g = torch.Generator(device=card).manual_seed(13)
    wgmma = flash.bwd_variant(q.dtype, D) == "wgmma"
    for causal in (True, False):
        o, lse = _forward_for_bwd(q, k, v, causal=causal, window=window)
        do = torch.randn(o.shape, generator=g, device=card).to(o.dtype)
        before = ops.launch_counts()
        got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
        assert after["flash_attention_bwd_wgmma"] == before["flash_attention_bwd_wgmma"] + wgmma
        assert after["flash_attention_bwd_mma"] == before["flash_attention_bwd_mma"]
        t = [a.transpose(1, 2) for a in (q, k, v, o, do)]
        want = ops.ref.attention_bwd_ref(*t, causal=causal, window=window)
        for x, w in zip(got, want):
            _flash_grad_close(x, w.transpose(1, 2), dtype)
        if wgmma:  # the pairs ops does not pick here hold the same tolerance
            others = []
            if D in flash.MMA_BWD_HEAD_DIMS:
                others.append(flash.launch_bwd_mma(q, k, v, o, do, causal=causal, window=window))
            if D in flash.FMA_BWD_BF16_HEAD_DIMS:
                others.append(flash.launch_bwd_fma(q, k, v, o, do, causal=causal, window=window))
            for grads in others:
                for x, w in zip(grads, want):
                    _flash_grad_close(x, w.transpose(1, 2), dtype)


@pytest.mark.gpu
def test_flash_bwd_mma_pair_counts_its_own_launches(card):
    q, k, v = _qkv(card, 15, 1, 128, 128, 2, 1, 64, "bf16")
    o = ops.flash_attention(q, k, v)
    before = ops.launch_counts()
    flash.launch_bwd_mma(q, k, v, o, torch.randn_like(o), causal=True, window=None)
    after = ops.launch_counts()
    assert after["flash_attention_bwd_mma"] == before["flash_attention_bwd_mma"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]


@pytest.mark.gpu
def test_flash_wgmma_bwd_needs_the_forwards_lse(card):
    q, k, v = _qkv(card, 16, 1, 64, 64, 2, 1, 64, "bf16")
    o = ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, torch.randn_like(o))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", BF16_CASES)
def test_flash_forward_lse_vs_plain(card, B, S, T, Hq, Hkv, D, window):
    """The wgmma forward's lse against the plain lse (attention_ref with
    return_lse): the same bf16 inputs summed in f32 in other orders, so within
    a relative 1e-4 of |lse| + 1 (they part by ~1e-6); +inf on the same rows;
    the output equal to the bit to the one without lse."""
    q, k, v = _qkv(card, 17, B, S, T, Hq, Hkv, D, "bf16")
    for causal in (True, False):
        o, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal, window=window))
        _, want = ops.ref.attention_ref(*(a.transpose(1, 2) for a in (q, k, v)), causal=causal, window=window,
                                        return_lse=True)
        inf = want == float("inf")
        assert torch.equal(lse == float("inf"), inf)
        rel = ((lse - want).abs() / (want.abs() + 1))[~inf]
        assert rel.numel() == 0 or float(rel.max()) <= 1e-4, float(rel.max())
        pad = lse.as_strided((B, Hq, flash.lse_stride(S)), lse.stride())[..., S:]
        assert bool((pad == float("inf")).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,D", [("bf16", 16), ("bf16", 64), ("bf16", 128), ("bf16", 256), ("f32", 64)])
def test_flash_bwd_rows_that_see_no_key(card, dtype, D, causal):
    """S > T + window: the q tiles from row T + window - 1 on see no key, so
    the dQ kernel loops over no key tile. Their dq is 0, they add nothing to
    dk and dv, and the rest equals the plain backward over the rows that see
    keys (the plain version has no answer for a row without keys)."""
    B, S, T, Hq, Hkv, window = 1, 384, 128, 4, 2, 64
    n = T + window - 1
    q, k, v = _qkv(card, 21, B, S, T, Hq, Hkv, D, dtype)
    o, lse = _forward_for_bwd(q, k, v, causal=causal, window=window)
    do = torch.randn(o.shape, generator=torch.Generator(device=card).manual_seed(22), device=card).to(o.dtype)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    assert all(bool(x.isfinite().all()) for x in (o, dq, dk, dv))
    assert not bool(dq[:, n:].any())
    qt, ot, dot = (a[:, :n].transpose(1, 2) for a in (q, o, do))
    want = ops.ref.attention_bwd_ref(qt, k.transpose(1, 2), v.transpose(1, 2), ot, dot, causal=causal, window=window)
    for x, w in zip((dq[:, :n], dk, dv), want):
        _flash_grad_close(x, w.transpose(1, 2), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_bwd_kernel_is_deterministic(card, D):
    q, k, v = _qkv(card, 14, 1, 384, 384, 8, 2, D, "bf16")
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(o)
    a, b = ops.flash_attention_bwd(q, k, v, o, do, lse=lse), ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (32, 8)], ids=["deepseek-moe-16b", "qwen3-4b"])
def test_flash_bwd_kernel_is_deterministic_over_many_launches(card, Hq, Hkv):
    """2,000 launches of the wgmma backward pair at a training shape (1 x
    2048, D 128) on the same inputs all give the first launch's bits. The
    dK/dV kernel's ring of three stages passes between its two warpgroups in
    turn; with a parity wait alone, a warpgroup could read a stage before its
    tile landed, now and then: one launch in ~300 at deepseek-moe-16b's shape
    gave a whole 64-key tile of dK and dV of one head wrong."""
    q, k, v = _qkv(card, 18, 1, 2048, 2048, Hq, Hkv, 128, "bf16")
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(o)
    first = ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    differ = [i for i in range(2000)
              if not all(torch.equal(x, y) for x, y in zip(ops.flash_attention_bwd(q, k, v, o, do, lse=lse), first))]
    assert not differ, differ[:10]


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_flash_bwd_d256_head_groups_vs_plain(card, splits):
    """The D = 256 wgmma pair at a windowed MQA shape (16 q-heads a kv-head,
    as recurrentgemma-9b) with the dK/dV kernel's q-heads in 1 to 16 groups:
    each within the tolerance of the plain backward, two launches equal to
    the bit (the partial sums are added in a fixed order)."""
    q, k, v = _qkv(card, 24, 1, 640, 640, 16, 1, 256, "bf16")
    o, lse = ops.flash_attention(q, k, v, window=256, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator(device=card).manual_seed(25), device=card).to(o.dtype)
    got = flash.launch_bwd_wgmma(q, k, v, o, do, lse, causal=True, window=256, splits=splits)
    again = flash.launch_bwd_wgmma(q, k, v, o, do, lse, causal=True, window=256, splits=splits)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ops.ref.attention_bwd_ref(*(a.transpose(1, 2) for a in (q, k, v, o, do)), window=256)
    for x, w in zip(got, want):
        _flash_grad_close(x, w.transpose(1, 2), "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1000, 512), (64, 2560), (300, 16), (5, 3000),
                                   (2048, 2560), (2048 * 8, 128), (4096, 768)])
def test_rmsnorm_bwd_kernel_vs_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(15)
    x = torch.randn(shape, generator=g, device=card).to(TDT[dtype])
    s = torch.randn(shape[-1], generator=g, device=card) * 0.1
    dy = torch.randn(shape, generator=g, device=card).to(TDT[dtype])
    before = ops.launch_counts()["fused_rmsnorm_bwd"]
    dx, ds = ops.fused_rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_rmsnorm_bwd"] == before + 1
    want_dx, want_ds = ops.ref.rmsnorm_bwd_ref(x, s, dy)
    assert dx.dtype == x.dtype and ds.dtype == torch.float32
    _grad_close(dx, want_dx, dtype)
    _grad_close(ds, want_ds, "f32")
    again = ops.fused_rmsnorm_bwd(x, s, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)


# tests/test_kernels.py's RG-LRU sweep (B, S, W), then the chunked kernel's
# tiling edges: S at a sub-chunk (8 steps) - 1, + 0, + 1, at a block (32) and
# at a cluster's span (256) - 1, + 0, + 1; S over several rounds; one long
# request; the largest batch; ragged widths 70 and 300 (300 takes 16-byte
# loads in f32 and one element a lane in bf16, 70 one element in both)
SCAN_CASES = [(1, 128, 512), (2, 256, 512), (1, 200, 300), (1, 512, 128), (3, 37, 70),
              (1, 7, 512), (1, 8, 300), (1, 9, 70), (2, 31, 300), (1, 32, 512), (1, 33, 70),
              (1, 255, 300), (1, 256, 70), (1, 257, 256), (2, 1500, 300), (1, 2049, 70),
              (1, 8192, 256), (65535, 3, 4)]


def _scan_inputs(card, B, S, W, dtype, seed=10):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=card)).to(TDT[dtype])
    b = torch.randn((B, S, W), generator=g, device=card).to(TDT[dtype])
    return a, b


def _chunked_model(a, b):
    return ops.ref.rglru_chunked_ref(a, b, rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=rgk.cluster_size(a.shape[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_scan_kernel_vs_plain(card, B, S, W, dtype):
    """Through ops, which launches the chunked kernel; beside the plain
    version, its own order of arithmetic (ref.rglru_chunked_ref) within a
    few f32 roundings, one bf16 rounding for bf16 outputs."""
    a, b = _scan_inputs(card, B, S, W, dtype)
    before = ops.RGLRU_SCAN_LAUNCHES
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.RGLRU_SCAN_LAUNCHES == before + 1
    _close(got, ops.ref.rglru_ref(a, b), dtype)
    torch.testing.assert_close(got.float(), _chunked_model(a, b).float(), rtol=1e-6 if dtype == "f32" else 2**-8,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_sequential_kernel_vs_plain(card, B, S, W, dtype):
    """The kernel the chunked one replaced, kept as its yardstick; its
    counter moves by one a launch."""
    a, b = _scan_inputs(card, B, S, W, dtype)
    before = ops.launch_counts()["rglru_scan_sequential"]
    got = rgk.launch_sequential(a, b)
    assert ops.launch_counts()["rglru_scan_sequential"] == before + 1
    _close(got, ops.ref.rglru_ref(a, b), dtype)


@pytest.mark.gpu
def test_rglru_scan_kernel_carries_state_as_a_running_count(card):
    a = torch.ones((2, 1000, 96), device=card)
    want = torch.arange(1, 1001, dtype=torch.float32, device=card)[None, :, None].expand(2, 1000, 96)
    assert torch.equal(ops.rglru_scan(a, a), want)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [256, 70])
def test_rglru_scan_kernel_bf16_running_sum_is_exact(card, W):
    """a = 1, b = 205/2048 in bf16: the f32 sums (t+1)·b are exact, so h is
    bf16((t+1)·b) bit for bit; a carry rounded to bf16 anywhere is not
    (tests/test_torch_rglru.py shows that it parts)."""
    S = 3000
    a = torch.ones((1, S, W), dtype=torch.bfloat16, device=card)
    b = torch.full((1, S, W), 205 / 2048, dtype=torch.bfloat16, device=card)
    want = (torch.arange(1, S + 1, dtype=torch.float32, device=card) * (205 / 2048)).bfloat16()
    assert torch.equal(ops.rglru_scan(a, b), want[None, :, None].expand(1, S, W))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("W", [512, 70])
def test_rglru_scan_kernel_resets_where_a_is_zero(card, dtype, W):
    """a = 0 at every sub-chunk's start: h there is b exactly, and after it
    the chunked kernel runs the same FMA chain as the sequential one, so the
    two agree bit for bit whatever the carries."""
    a, b = _scan_inputs(card, 2, 1100, W, dtype, seed=12)
    a[:, :: rgk.SUB_CHUNK] = 0
    got = ops.rglru_scan(a, b)
    assert torch.equal(got[:, :: rgk.SUB_CHUNK], b[:, :: rgk.SUB_CHUNK])
    assert torch.equal(got, rgk.launch_sequential(a, b))


@pytest.mark.gpu
def test_rglru_scan_kernel_holds_f32_on_slow_decays(card):
    """a in [0.99, 1) over 4096 steps (the RG-LRU's slow channels): the inputs
    of tests/test_torch_rglru.py's CPU test of the chunked model; f32 2e-5."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.99, 1.0, (1, 4096, 256)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32)).to(card)
    _close(ops.rglru_scan(a, b), ops.ref.rglru_ref(a, b), "f32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_kernel_is_deterministic(card, dtype):
    a, b = _scan_inputs(card, 2, 4096, 512, dtype, seed=13)
    assert torch.equal(ops.rglru_scan(a, b), ops.rglru_scan(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_kernel_reads_misaligned_inputs(card, dtype):
    """Contiguous views 4 or 2 bytes off a 16-byte boundary take the kernel's
    one-element loads; the result is the same."""
    B, S, W = 2, 300, 512
    a, b = _scan_inputs(card, B, S, W, dtype, seed=14)
    a_off = torch.empty(B * S * W + 1, dtype=a.dtype, device=card)[1:].view(B, S, W).copy_(a)
    b_off = torch.empty(B * S * W + 1, dtype=b.dtype, device=card)[1:].view(B, S, W).copy_(b)
    assert a_off.data_ptr() % 16 and a_off.is_contiguous()
    assert torch.equal(ops.rglru_scan(a_off, b_off), ops.rglru_scan(a, b))


def _scan_bwd_inputs(card, B, S, W, dtype, seed=20):
    """a, the scan's output h (through the kernel) and a gradient dh."""
    a, b = _scan_inputs(card, B, S, W, dtype, seed=seed)
    g = torch.Generator(device=card).manual_seed(seed + 1)
    return a, ops.rglru_scan(a, b), torch.randn((B, S, W), generator=g, device=card).to(TDT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_scan_bwd_kernel_vs_plain(card, B, S, W, dtype):
    """Through ops, which launches the chunked kernel backward in time; against
    the plain backward at the dtype's tolerance, beside its own order of
    arithmetic (ref.rglru_bwd_chunked_ref) within a few f32 roundings, one
    bf16 rounding for bf16 outputs; two launches give equal bits."""
    a, h, dh = _scan_bwd_inputs(card, B, S, W, dtype)
    before = ops.launch_counts()["rglru_scan_bwd"]
    da, db = ops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan_bwd"] == before + 1
    want = ops.ref.rglru_bwd_ref(a, h, dh)
    model = ops.ref.rglru_bwd_chunked_ref(a, h, dh, rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=rgk.cluster_size(S))
    for got, w, m in zip((da, db), want, model):
        _close(got, w, dtype)
        torch.testing.assert_close(got.float(), m.float(), rtol=1e-6 if dtype == "f32" else 2**-8, atol=1e-6)
    again = ops.rglru_scan_bwd(a, h, dh)
    assert torch.equal(again[0], da) and torch.equal(again[1], db)


@pytest.mark.gpu
def test_rglru_scan_bwd_kernel_holds_f32_on_slow_decays(card):
    """a in [0.99, 1) over 4096 steps, where g sums ~100 terms of dh (|g| up to
    ~60): within a few f32 roundings of its own order of arithmetic, and
    within f32 2e-5 of the plain loop with the atol scaled by the largest
    |g| (_grad_close): an entry near 0 carries the rounding of its terms, not
    of itself (at the plain atol 3 of the 1M entries part by up to 3.0e-5)."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.99, 1.0, (1, 4096, 256)).astype(np.float32)).to(card)
    h = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32)).to(card)
    dh = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32)).to(card)
    got = ops.rglru_scan_bwd(a, h, dh)
    model = ops.ref.rglru_bwd_chunked_ref(a, h, dh, rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=rgk.cluster_size(4096))
    for x, want, m in zip(got, ops.ref.rglru_bwd_ref(a, h, dh), model):
        _grad_close(x, want, "f32")
        torch.testing.assert_close(x, m, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_bwd_kernel_reads_misaligned_inputs(card, dtype):
    """Views off a 16-byte boundary take the one-element loads: the same bits."""
    B, S, W = 2, 300, 512
    a, h, dh = _scan_bwd_inputs(card, B, S, W, dtype, seed=22)

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=card)[1:].view(t.shape).copy_(t)

    got, want = ops.rglru_scan_bwd(off(a), off(h), off(dh)), ops.rglru_scan_bwd(a, h, dh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_autograd_launches_the_bwd_kernel_once(card, dtype):
    """A recorded scan's backward is one launch of the backward kernel, whose
    gradients are the plain backward's from the saved a and h."""
    a, b = _scan_inputs(card, 2, 300, 256, dtype, seed=23)
    a, b = a.requires_grad_(), b.requires_grad_()
    dh = torch.randn(a.shape, device=card).to(a.dtype)
    ops.reset_launch_counts()
    h = ops.rglru_scan(a, b)
    da, db = torch.autograd.grad(h, (a, b), dh)
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == 1 and counts["rglru_scan_bwd"] == 1
    for got, want in zip((da, db), ops.ref.rglru_bwd_ref(a.detach(), h.detach(), dh)):
        _close(got, want, dtype)


# The launches of one smoke forward: one flash per attn layer, each on the
# wgmma kernel (bf16 at head dim 16), two RMSNorms per layer (four with
# qk-norms) plus the final one, one scan per rec layer.
SMOKE_FORWARD_LAUNCHES = {
    # 3 attn layers, qk-norms
    "qwen3-4b": {"flash_attention": 3, "flash_attention_wgmma": 3, "fused_rmsnorm": 13, "rglru_scan": 0,
                 "rglru_scan_sequential": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                 "flash_attention_bwd_mma": 0,
                 "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0},
    # 2 attn layers
    "gemma-2b": {"flash_attention": 2, "flash_attention_wgmma": 2, "fused_rmsnorm": 5, "rglru_scan": 0,
                 "rglru_scan_sequential": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                 "flash_attention_bwd_mma": 0,
                 "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0},
    # one (rec, rec, attn) unit + two remainder rec layers
    "recurrentgemma-9b": {"flash_attention": 1, "flash_attention_wgmma": 1, "fused_rmsnorm": 11, "rglru_scan": 4,
                          "rglru_scan_sequential": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                 "flash_attention_bwd_mma": 0,
                 "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0},
    # one (slstm, mlstm, mlstm, mlstm) unit: norm1 and the cell's out_norm a layer
    "xlstm-125m": {"flash_attention": 0, "flash_attention_wgmma": 0, "fused_rmsnorm": 9, "rglru_scan": 0,
                   "rglru_scan_sequential": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                   "flash_attention_bwd_mma": 0, "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0},
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(SMOKE_FORWARD_LAUNCHES))
def test_smoke_model_kernel_path_vs_plain_path(card, arch):
    """The same weights and tokens through the kernels on the card and the
    plain versions on the CPU. The bound is the decode/prefill one of the
    CPU tests (0.1): matrix products differ in summation order between the
    card and the CPU."""
    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=card), Model(cfg, device="cpu")
    params = gpu.init(torch.Generator(device=card).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    ops.reset_launch_counts()
    got, _ = gpu.forward(params, {"tokens": tokens.to(card)})
    assert ops.launch_counts() == SMOKE_FORWARD_LAUNCHES[arch]
    want, _ = cpu.forward(tree_map_with_path(lambda _, a: a.cpu(), params), {"tokens": tokens})
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err < 0.1, err


# The embeddings-input families at smoke size: 3 attn layers at head dim 8
# (the FMA flash kernel), two norms a layer plus the final one
EMBEDS_FORWARD_LAUNCHES = {"flash_attention": 3, "flash_attention_wgmma": 0, "fused_rmsnorm": 7, "rglru_scan": 0,
                           "rglru_scan_sequential": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                           "flash_attention_bwd_mma": 0, "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0}


def _image_positions(B: int, S: int):
    """M-RoPE positions whose three streams differ: 4 text tokens, an image
    of 1 x 2 x 3 (t, h, w) patches, then text again."""
    img = torch.tensor([[t, h, w] for t in range(1) for h in range(2) for w in range(3)]) + 4
    tail = torch.arange(S - 10)[:, None].expand(-1, 3) + int(img.max()) + 1
    pos = torch.cat([torch.arange(4)[:, None].expand(-1, 3), img, tail]).to(torch.int32)
    return pos[None].expand(B, S, 3).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_embeds_smoke_model_kernel_path_vs_plain_path(card, arch):
    """The smoke config from bf16 embeddings (qwen2-vl-2b: at image positions
    and at the default ones) through the kernels on the card and the plain
    versions on the CPU, within the 0.1 of the token models above; then
    eight decode steps from embeddings, card against CPU within the bf16
    atol (0.02), the norm kernel launched 7 times a step."""
    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=card), Model(cfg, device="cpu")
    params = gpu.init(torch.Generator(device=card).manual_seed(0))
    params_cpu = tree_map_with_path(lambda _, a: a.cpu(), params)
    embeds = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    batches = [{"embeds": embeds}] + ([{"embeds": embeds, "positions": _image_positions(2, 32)}] if cfg.mrope else [])
    for batch in batches:
        ops.reset_launch_counts()
        got, _ = gpu.forward(params, {k: v.to(card) for k, v in batch.items()})
        assert ops.launch_counts() == EMBEDS_FORWARD_LAUNCHES
        want, _ = cpu.forward(params_cpu, batch)
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err < 0.1, err
    state, state_cpu = gpu.init_decode_state(2, 16), cpu.init_decode_state(2, 16)
    ops.reset_launch_counts()
    for t in range(8):
        got, state = gpu.decode_step(params, {"embeds": embeds[:, t : t + 1].to(card)}, state, t)
        want, state_cpu = cpu.decode_step(params_cpu, {"embeds": embeds[:, t : t + 1]}, state_cpu, t)
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err < 0.02, (t, err)
    assert ops.launch_counts() == {**EMBEDS_FORWARD_LAUNCHES, "flash_attention": 0, "fused_rmsnorm": 7 * 8}


@pytest.mark.gpu
def test_xlstm_smoke_server_on_card(card):
    """xlstm-125m smoke served on the card: the cells step in plain PyTorch,
    the norm kernel launches twice a layer plus once; reused slots keep the
    previous occupant's cell states."""
    cfg = get_config("xlstm-125m", smoke=True)
    server = BatchedServer(Model(cfg, device=card), batch=3, max_len=64)
    ops.reset_launch_counts()
    stats = server.run(make_requests(cfg.vocab, 6, 4))
    assert stats["requests_done"] == 6
    assert ops.launch_counts() == {**SMOKE_FORWARD_LAUNCHES["xlstm-125m"],
                                   "fused_rmsnorm": (2 * cfg.n_layers + 1) * stats["decode_steps"]}
    assert server.state["scan"]["block1"]["C"].abs().sum() > 0


@pytest.mark.gpu
def test_xlstm_train_step_on_card_has_finite_gradients_over_a_whole_chunk(card):
    """One mLSTM layer of xlstm-125m at full width, B 1 x S 256 (one chunk
    of 256), drawn as the stacked unit of 3 is: the masked exponent keeps
    the gradient finite on the card, where the JAX package's is NaN
    (tests/test_torch_xlstm.py)."""
    from repro_torch.models import xlstm
    from repro_torch.models.modules import init_params, stack_specs

    cfg = get_config("xlstm-125m")
    stacked = init_params(stack_specs(xlstm.mlstm_spec(cfg), 3), torch.Generator(device=card).manual_seed(0),
                          train=True)
    params = tree_map_with_path(
        lambda _, a: (a[0].to(torch.bfloat16) if a.ndim >= 3 else a[0].clone()).requires_grad_(), stacked)
    x = torch.randn((1, 256, cfg.d_model), generator=torch.Generator(device=card).manual_seed(1),
                    device=card).bfloat16().requires_grad_()
    ops.reset_launch_counts()
    y, state = xlstm.mlstm(params, x, cfg)
    y.float().square().sum().backward()
    assert torch.isfinite(y.float()).all() and torch.isfinite(x.grad.float()).all()
    assert all(torch.isfinite(p.grad.float()).all() for _, p in _leaves(params))
    assert ops.launch_counts()["fused_rmsnorm"] == 1 and ops.launch_counts()["fused_rmsnorm_bwd"] == 1


@pytest.mark.gpu
def test_smoke_server_on_card_launches_the_norm_kernel(card):
    cfg = get_config("qwen3-4b", smoke=True)
    server = BatchedServer(Model(cfg, device=card), batch=3, max_len=64)
    ops.reset_launch_counts()
    stats = server.run(make_requests(cfg.vocab, 6, 4))
    assert stats["requests_done"] == 6
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "flash_attention_wgmma": 0,
        "fused_rmsnorm": (4 * cfg.n_layers + 1) * stats["decode_steps"],
        "rglru_scan": 0,
        "rglru_scan_sequential": 0,
        "flash_attention_bwd": 0,
        "flash_attention_bwd_wgmma": 0,
        "flash_attention_bwd_mma": 0,
        "fused_rmsnorm_bwd": 0,
        "rglru_scan_bwd": 0,
    }


@pytest.mark.gpu
def test_hybrid_smoke_server_on_card(card):
    """recurrentgemma-9b smoke served on the card: decode steps the recurrent
    state in plain PyTorch, so only the norm kernel launches."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    server = BatchedServer(Model(cfg, device=card), batch=3, max_len=64)
    ops.reset_launch_counts()
    stats = server.run(make_requests(cfg.vocab, 6, 4))
    assert stats["requests_done"] == 6
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "flash_attention_wgmma": 0,
        "fused_rmsnorm": (2 * cfg.n_layers + 1) * stats["decode_steps"],
        "rglru_scan": 0,
        "rglru_scan_sequential": 0,
        "flash_attention_bwd": 0,
        "flash_attention_bwd_wgmma": 0,
        "flash_attention_bwd_mma": 0,
        "fused_rmsnorm_bwd": 0,
        "rglru_scan_bwd": 0,
    }
    assert server.state["remainder"]["layer4"]["h"].abs().sum() > 0


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield ".".join(prefix), tree


def _smoke_train_step(card, remat=None, arch="qwen3-4b", plain_on_card=False):
    """One train step at ``arch``'s smoke config through the kernels on the
    card, and one on the CPU (or, ``plain_on_card``, through the plain
    versions on the card), from the same weights and batch. -> (card (params,
    state, metrics, launches), the other run (...), the weights before the
    step)."""
    from contextlib import nullcontext

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = get_config(arch, smoke=True)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    params_cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0)).batch(0)
    lr_fn = cosine_schedule(1e-2, warmup_steps=0, total_steps=10)
    out = []
    for dev, plain in ((card, False), (card, True) if plain_on_card else (torch.device("cpu"), False)):
        model = Model(cfg, device=dev)
        p = tree_map_with_path(lambda _, x: x.to(dev, copy=True), params_cpu)
        with ops.plain_versions() if plain else nullcontext():
            ops.reset_launch_counts()
            p, st, met = make_train_step(model, lr_fn)(p, adamw_init(p), {k: torch.from_numpy(v).to(dev)
                                                                         for k, v in batch.items()})
            out.append((p, st, met, ops.launch_counts()))
    return (*out, params_cpu)


def _hold_step(card_run, ref_run, p0):
    """chip_smoke.py's TRAIN_CARD_VS_CPU bounds, the card's step against a
    reference run (the CPU's, or the plain path on the card): the loss within
    0.01, each moment leaf within 5 % relative L2, each leaf's update within
    20 % relative L2 (Adam's first update is lr * sign(g), so the update's
    error counts the entries whose sign flips)."""
    (pg, sg, mg, _), (pc, sc, mc, _) = card_run, ref_run
    assert abs(float(mg["loss"]) - float(mc["loss"])) < 1e-2
    for part in ("m", "v"):
        for (name, x), (_, y) in zip(_leaves(sg[part]), _leaves(sc[part])):
            x, y = x.cpu(), y.cpu()
            rel = float((x - y).norm() / y.norm().clamp_min(1e-30))
            assert rel < 5e-2, (part, name, rel)
    for (name, x), (_, y), (_, p) in zip(_leaves(pg), _leaves(pc), _leaves(p0)):
        x, y = x.cpu(), y.cpu()
        rel = float((x - y).norm() / (y - p).norm().clamp_min(1e-30))
        assert rel < 0.2, (name, rel)


@pytest.mark.gpu
def test_smoke_train_step_on_card_vs_cpu(card):
    """Both backward kernels launch once per layer (four norms a layer plus
    the final one), no plain backward on the card."""
    card_run, cpu_run, p0 = _smoke_train_step(card)
    _hold_step(card_run, cpu_run, p0)
    counts = card_run[3]
    assert counts == {"flash_attention": 3, "flash_attention_wgmma": 3, "fused_rmsnorm": 13, "rglru_scan": 0,
                      "rglru_scan_sequential": 0, "flash_attention_bwd": 3, "flash_attention_bwd_wgmma": 3,
                      "flash_attention_bwd_mma": 0, "fused_rmsnorm_bwd": 13,
                      "rglru_scan_bwd": 0}


@pytest.mark.gpu
def test_hybrid_smoke_train_step_kernels_vs_plain_on_card(card):
    """recurrentgemma-9b smoke (one (rec, rec, attn) unit and two remainder
    rec layers, remat "none") through the kernels against the same step
    through the plain versions on the same card, at the bounds above: the
    scan and its backward kernel once per rec layer, flash and its wgmma pair
    once (bf16 at head dim 16), two norms a layer plus the final one, each
    with its backward. Against the CPU the step is ill-posed at this init
    (chip_smoke.py's TRAIN_CHECKS): the card's plain path parts from the
    CPU's by 0.48 on the moments, as far as the kernels do. The hybrid's
    gradients are held to the CPU's in
    test_smoke_grads_on_card_vs_cpu_with_plain_attention."""
    card_run, plain_run, p0 = _smoke_train_step(card, arch="recurrentgemma-9b", plain_on_card=True)
    _hold_step(card_run, plain_run, p0)
    assert not any(plain_run[3].values())
    assert card_run[3] == {"flash_attention": 1, "flash_attention_wgmma": 1, "fused_rmsnorm": 11, "rglru_scan": 4,
                           "rglru_scan_sequential": 0, "flash_attention_bwd": 1, "flash_attention_bwd_wgmma": 1,
                           "flash_attention_bwd_mma": 0, "fused_rmsnorm_bwd": 11, "rglru_scan_bwd": 4}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-9b", "xlstm-125m"])
def test_smoke_grads_on_card_vs_cpu_with_plain_attention(card, arch):
    """The loss and each leaf's gradient of the smoke config, the card
    against the CPU, flash attention through its plain f32 version on both
    sides and the other kernels launched on the card: chip_smoke.py's
    GRADS_CARD_VS_CPU (the loss within 1e-4, each leaf within 5 % relative
    L2). The initial weights with each stacked matrix scaled from std
    1/sqrt(n_units) to 1/sqrt(d_in), its unstacked spec's: at the init itself
    the hybrid's gradients move by up to 0.43 per leaf under a 1e-6 nudge of
    the norm scales on one device, so no two devices can agree there."""
    cfg = get_config(arch, smoke=True)
    params_cpu = at_unstacked_std(Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0)).batch(0)
    out = []
    for dev in (card, torch.device("cpu")):
        model = Model(cfg, device=dev)
        p = tree_map_with_path(lambda _, x: x.to(dev, copy=True), params_cpu)
        grads = tree_map_with_path(lambda _, x: torch.zeros_like(x, dtype=torch.float32), p)
        ops.reset_launch_counts()
        with ops.plain_versions("flash_attention"):
            loss, _ = model.loss(model.grad_leaves(p, grads), {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            loss.backward()
        out.append((float(loss.detach()), grads, ops.launch_counts()))
    (lc, gc, counts), (lw, gw, _) = out
    assert abs(lc - lw) < 1e-4
    for (name, x), (_, y) in zip(_leaves(gc), _leaves(gw)):
        rel = float((x.cpu() - y).norm() / y.norm().clamp_min(1e-30))
        assert rel < 5e-2, (name, rel)
    n_rec = sum(layer_kind(cfg, i) == "rec" for i in range(cfg.n_layers))
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0
    assert counts["rglru_scan"] == counts["rglru_scan_bwd"] == n_rec
    assert counts["fused_rmsnorm"] == counts["fused_rmsnorm_bwd"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_on_card_recomputes_through_the_kernels(card, remat):
    """Under a checkpoint every unit's attention and norms run again in the
    backward pass, through the kernels; the step equals the one without."""
    (pg, sg, _, counts), _, _ = _smoke_train_step(card, remat)
    (pw, sw, _, _), _, _ = _smoke_train_step(card, "none")
    assert counts["flash_attention"] == 6 and counts["fused_rmsnorm"] == 13 + 12
    assert counts["flash_attention_bwd"] == counts["flash_attention_bwd_wgmma"] == 3
    assert counts["fused_rmsnorm_bwd"] == 13
    assert counts["flash_attention_bwd_mma"] == 0
    for (name, x), (_, y) in zip(_leaves({"p": pg, "m": sg["m"]}), _leaves({"p": pw, "m": sw["m"]})):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# MoE (plain PyTorch on the card: sort-based dispatch, bmm experts)
# ---------------------------------------------------------------------------
# A token whose k-th and (k+1)-th router probabilities lie closer than the
# card's and the CPU's rounding may take another expert on one side (a route
# flip), which moves its output by O(1). From the same input the routes agree
# (the router is an f32 product); from the model's own activations the MoE
# tests hold the outputs where the routes agree and count the flips.
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _moe_layer(arch, full=False, **changes):
    """(cfg, one MoE layer's weights on the CPU as a stacked unit hands them
    over: bf16 matrices, the router included). ``full``: the config's full
    width, one layer drawn from its spec with each expert matrix at std
    1/sqrt(d_in) (the spec's std takes fan_in = E: 1/8, which makes outputs
    of ~70, where bf16 rounding of the products alone parts the two devices
    by more than the elementwise tolerance); else unit 0 of the smoke model."""
    import math

    from repro_torch.models.moe import moe_spec
    from repro_torch.models.modules import init_params
    from repro_torch.models.transformer import _unit

    cfg = dataclasses.replace(get_config(arch, smoke=not full), **changes)
    if full:
        layer = init_params(moe_spec(cfg), torch.Generator().manual_seed(0))
        return cfg, tree_map_with_path(
            lambda _, a: (a * math.sqrt(a.shape[0] / a.shape[1])).bfloat16() if a.ndim == 3
            else a.bfloat16() if a.ndim >= 2 else a, layer)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return cfg, _unit(params["layers"]["scan"], 0)["block0"]["moe"]


def _moe_x(cfg, B, S, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))).bfloat16()


# (arch, full width, B, S, capacity_factor)
MOE_CASES = [("deepseek-moe-16b", False, 2, 16, None), ("deepseek-moe-16b", False, 2, 16, 0.5),
             ("qwen3-moe-235b-a22b", False, 2, 16, None), ("qwen3-moe-235b-a22b", False, 4, 1, None),
             ("deepseek-moe-16b", True, 1, 512, None), ("deepseek-moe-16b", True, 4, 1, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,full,B,S,cf", MOE_CASES)
def test_moe_on_card_vs_cpu(card, arch, full, B, S, cf):
    """The same layer and input on the card and on the CPU: routes equal,
    gate weights within f32 2e-5, the output within bf16 2e-2, lb_loss within
    1e-5 relative, dropped_frac and expert_frac equal."""
    from repro_torch.models import moe as tmoe

    cfg, layer = _moe_layer(arch, full, **({} if cf is None else {"capacity_factor": cf}))
    x = _moe_x(cfg, B, S)
    on_card = tree_map_with_path(lambda _, a: a.to(card), layer)
    with torch.inference_mode():
        want_route = tmoe.route(layer, x.reshape(-1, cfg.d_model), cfg)
        got_route = tmoe.route(on_card, x.to(card).reshape(-1, cfg.d_model), cfg)
        want, want_aux = tmoe.moe(layer, x, cfg)
        got, aux = tmoe.moe(on_card, x.to(card), cfg)
    assert torch.equal(got_route[2].cpu(), want_route[2])
    _close(got_route[1], want_route[1], "f32")
    _close(got, want, "bf16")
    assert float(aux["lb_loss"]) == pytest.approx(float(want_aux["lb_loss"]), rel=1e-5)
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    assert torch.equal(aux["expert_frac"].cpu(), want_aux["expert_frac"])
    if cf is not None:
        assert float(aux["dropped_frac"]) > 0.05


@pytest.mark.gpu
def test_moe_on_card_repeats_to_the_bit(card):
    """deepseek-moe-16b's layer at full width, 512 tokens: two forward and
    backward passes on the card give the same bits (the dispatch and combine
    gather through permutations and add in a fixed order; no atomics)."""
    from repro_torch.models import moe as tmoe

    cfg, layer = _moe_layer("deepseek-moe-16b", full=True)
    x = _moe_x(cfg, 1, 512).to(card)
    runs = []
    for _ in range(2):
        leaves = tree_map_with_path(lambda _, a: a.to(card, copy=True).requires_grad_(), layer)
        xl = x.clone().requires_grad_()
        y, aux = tmoe.moe(leaves, xl, cfg)
        (y.float().square().mean() + aux["lb_loss"]).backward()
        runs.append([y, xl.grad] + [a.grad for _, a in _leaves(leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _recording_routes(monkeypatch) -> list:
    """From now on, each call of the MoE router appends its expert ids (on the
    CPU) to the returned list."""
    from repro_torch.models import moe as tmoe

    calls, route = [], tmoe.route

    def recording(params, xt, cfg):
        out = route(params, xt, cfg)
        calls.append(out[2].cpu())
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    return calls


def _first_flip(got_calls, want_calls) -> int | None:
    """The first token (flat index over the batch) whose set of experts
    differs between two runs in any MoE call, or None. Tokens before it saw
    the same routes in every layer: attention is causal and a slot's rank (its
    drop) depends only on the slots before it."""
    assert len(got_calls) == len(want_calls) > 0
    firsts = [int(d.nonzero()[0]) for g, w in zip(got_calls, want_calls)
              if (d := (g.sort(-1).values != w.sort(-1).values).any(-1)).any()]
    return min(firsts, default=None)


MOE_SMOKE_FORWARD_LAUNCHES = {  # head dim 8: flash on the FMA kernel
    # the dense layer 0 and two MoE units: two norms a layer plus the final one
    "deepseek-moe-16b": {"flash_attention": 3, "fused_rmsnorm": 7},
    # four MoE units with qk-norms
    "qwen3-moe-235b-a22b": {"flash_attention": 4, "fused_rmsnorm": 17},
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_model_kernel_path_vs_plain_path(card, arch, monkeypatch):
    """The MoE smoke model through the kernels on the card and the plain
    versions on the CPU, as test_smoke_model_kernel_path_vs_plain_path: the
    logits within 0.1 at every token before the first route flip (all tokens
    when none), and the flip count reported."""
    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=card), Model(cfg, device="cpu")
    params = gpu.init(torch.Generator(device=card).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    calls = _recording_routes(monkeypatch)
    ops.reset_launch_counts()
    got, lb = gpu.forward(params, {"tokens": tokens.to(card)})
    counts = ops.launch_counts()
    assert all(counts[k] == MOE_SMOKE_FORWARD_LAUNCHES[arch].get(k, 0) for k in counts), counts
    n = len(calls)
    want, want_lb = cpu.forward(tree_map_with_path(lambda _, a: a.cpu(), params), {"tokens": tokens})
    flip = _first_flip(calls[:n], calls[n:])
    keep = 2 * 32 if flip is None else flip
    err = float((got.cpu().float() - want.float()).reshape(2 * 32, -1)[:keep].abs().max()) if keep else 0.0
    print(f"{arch}: first route flip at token {flip}; logit error {err} over {keep} tokens")
    assert keep > 0 and err < 0.1, (flip, err)
    if flip is None:
        assert float(lb) == pytest.approx(float(want_lb), rel=1e-4)


@pytest.mark.gpu
def test_moe_smoke_train_step_on_card(card, monkeypatch):
    """One train step at deepseek-moe-16b smoke through the kernels (flash
    and RMSNorm with their backward kernels; flash at head dim 8 on the FMA
    kernel and pair) against the same step through
    the plain versions on the card, at test_smoke_train_step_on_card_vs_cpu's
    bounds, the routes of both runs counted."""
    calls = _recording_routes(monkeypatch)
    card_run, plain_run, p0 = _smoke_train_step(card, arch="deepseek-moe-16b", plain_on_card=True)
    n = len(calls) // 2
    flip = _first_flip(calls[:n], calls[n:])
    print(f"deepseek-moe-16b smoke train step: first route flip at token {flip}")
    _hold_step(card_run, plain_run, p0)
    assert not any(plain_run[3].values())
    assert card_run[3] == {"flash_attention": 3, "flash_attention_wgmma": 0, "fused_rmsnorm": 7, "rglru_scan": 0,
                           "rglru_scan_sequential": 0, "flash_attention_bwd": 3, "flash_attention_bwd_wgmma": 0,
                           "flash_attention_bwd_mma": 0, "fused_rmsnorm_bwd": 7, "rglru_scan_bwd": 0}


def _device_plane_step(card, arch: str, remat: str | None = None):
    """One qwen3-4b smoke train step (B 2 x S 32) on the card after a warm-up
    step, profiled -> (its device tree, the profile)."""
    from repro_torch.benchmarks.fig08_11_breakdown import train_batch
    from repro_torch.core.device_tree import build_device_tree, profiling
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule

    cfg = get_config(arch, smoke=True)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    model = Model(cfg, device=card)
    params = model.init(train=True)
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(1e-3), AdamWConfig())
    step(params, opt, train_batch(cfg, 2, 32, card))
    with profiling(card) as prof:
        step(params, opt, train_batch(cfg, 2, 32, card, seed=1))
    return build_device_tree(prof), prof


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [None, "full"])
def test_device_tree_has_the_flash_backward_under_the_backward_branch(card, remat):
    """The backward's kernels, launched by the autograd engine outside the
    forward's ranges, land under ``transpose(jvp(loss))/.../flash_attention``:
    the wgmma backward pair, and the forward kernel where the checkpoint
    reruns it."""
    tree, _ = _device_plane_step(card, "qwen3-4b", remat)
    bwd = tree.zoom(lambda n: n == "transpose(jvp(loss))")
    flash = bwd.zoom(lambda n: n == "flash_attention")
    assert flash.flatten("kernels").get("kernel:flash_attention_bwd", 0) > 0
    assert flash.total("device_ms") > 0
    assert bwd.flatten("kernels").get("kernel:fused_rmsnorm_bwd", 0) > 0
    fwd = tree.zoom(lambda n: n == "jvp(loss)")
    assert fwd.flatten("kernels").get("kernel:flash_attention", 0) > 0
    assert "kernel:flash_attention_bwd" not in fwd.flatten("kernels")
    if remat:
        remat_part = bwd.zoom(lambda n: n == "rematted_computation")
        assert remat_part.flatten("kernels").get("kernel:flash_attention", 0) > 0


@pytest.mark.gpu
def test_device_tree_counts_each_kernel_once(card):
    """The tree's device ms is the sum of the step's kernel self times, as
    ``key_averages`` gives them without the ranges' device-side spans: no
    kernel counted twice through nested ranges, none lost; every node's own
    device ms sums to the root's."""
    from torch.autograd import DeviceType

    tree, prof = _device_plane_step(card, "qwen3-4b")
    ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and e.key not in ranges]
    want_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    assert tree.total("device_ms") == pytest.approx(want_ms, rel=1e-6)
    assert tree.total("kernels") == sum(e.count for e in kernels)
    own = sum(n.self_metrics.get("device_ms", 0.0) for _, n in tree.root.walk())
    assert own == pytest.approx(tree.total("device_ms"), rel=1e-9)


@pytest.mark.gpu
def test_smoke_trainer_under_the_daemon_backend_on_card(card, tmp_path):
    """The Trainer at qwen3-4b smoke on the card, profiled by a daemon it
    spawns after the model is on the card: the daemon exits 0 and done, its
    tree's total is its status's ``n_stacks``, the host report is written and
    the run launched the kernels it names in its summary."""
    import json
    import os

    from repro_torch.core import CallTree
    from repro_torch.launch.train import Trainer, TrainJobConfig

    job = TrainJobConfig(arch="qwen3-4b", device="cuda", steps=3, global_batch=4, seq_len=64,
                         out_dir=str(tmp_path), profile_backend="daemon", sample_period_s=0.05)
    summary = Trainer(job).run()
    daemon = summary["profile_daemon"]
    assert daemon["spawned"] and daemon["exit_code"] == 0 and daemon["done"]
    with open(os.path.join(daemon["out_dir"], "status.json")) as f:
        status = json.load(f)
    with open(os.path.join(daemon["out_dir"], "tree.json")) as f:
        tree = CallTree.from_json(f.read())
    assert status["n_stacks"] > 0 and tree.total() == status["n_stacks"]
    assert os.path.exists(summary["host_profile"])
    assert summary["kernel_launches"]["flash_attention"] > 0 and summary["kernel_launches"]["fused_rmsnorm_bwd"] > 0


@pytest.mark.gpu
def test_launcher_restarts_a_hung_smoke_trainer_on_card(card, tmp_path):
    """``tests/test_torch_launcher.py``'s hung-once run with the smoke
    xlstm-125m Trainer on the card: attempt 0 stopped after a complete
    checkpoint, killed on its stale heartbeat and restarted; attempt 1
    resumes from that checkpoint, reaches the last step and launches the
    Triton norm forward and backward; one shared daemon saw both attempts.
    The hang timeout covers a cold start on the card (CUDA, the Triton JIT,
    the profiled second step)."""
    from test_torch_launcher import hung_once

    run = hung_once(tmp_path, "cuda", hang_timeout_s=60.0)
    launches = run["summary"]["kernel_launches"]
    assert launches["fused_rmsnorm"] > 0 and launches["fused_rmsnorm_bwd"] > 0
    assert len(run["launcher"]._daemons) == 1
    assert (run["prof"] / "fleet.d" / "targets" / "attempt1" / "tree.json").exists()
    assert (run["prof"] / "merged_tree.json").exists()


@pytest.mark.gpu
def test_serve_convoy_detected_on_card(card):
    """``chip_smoke.py``'s ``faults`` phase at smoke size: the port's
    ``serve_convoy`` scenario through the harness with its child on the card
    (gemma-2b smoke through the batched server) and the port's daemon
    attached from outside; the lock convoy is detected inside the fault
    window, and the child ran its decode on the card through the RMSNorm
    kernel."""
    from repro_torch.faults import SCENARIOS, HarnessConfig, run_scenario, score_runs

    cfg = HarnessConfig(clean_s=1.6, fault_s=2.4, recovery_s=1.2, device="cuda", smoke=True)
    res = run_scenario(SCENARIOS["serve_convoy"], cfg, control=False)
    cells = score_runs(res.events, [], t_inject=res.t_inject, t_clear=res.t_clear, epoch_s=cfg.epoch_s,
                       grace_epochs=cfg.grace_epochs)
    kinds = sorted({e["kind"] for e in res.events})
    assert cells["dominance"].detected and "LOCK_CONVOY" in cells["dominance"].kinds, kinds
    report = res.child_reports["host0"]
    assert report["device"] == torch.cuda.get_device_name(0)
    assert report["kernel_launches"]["fused_rmsnorm"] > 0


def _fresh(card, seed: int, shapes_dtypes):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card, dtype=dt) for s, dt in shapes_dtypes]


# Each forward kernel at a main path's shape: (kernel, counter key, inputs)
GRAPH_KERNELS = {
    # qwen3-4b's prefill: q 2 x 2048 x 32 x 128, kv 8 heads, the wgmma kernel
    "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v, causal=True), "flash_attention_wgmma",
                        [((2, 2048, 32, 128), torch.bfloat16), ((2, 2048, 8, 128), torch.bfloat16),
                         ((2, 2048, 8, 128), torch.bfloat16)]),
    # qwen3-4b's norm1 rows
    "fused_rmsnorm": (lambda x, s: ops.fused_rmsnorm(x, s), "fused_rmsnorm",
                      [((4096, 2560), torch.bfloat16), ((2560,), torch.float32)]),
    # recurrentgemma-9b's prefill scan
    "rglru_scan": (lambda a, b: ops.rglru_scan(torch.sigmoid(a), b), "rglru_scan",
                   [((2, 4096, 4096), torch.float32), ((2, 4096, 4096), torch.float32)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPH_KERNELS))
def test_cuda_graph_replay_of_a_kernel_equals_its_eager_launch(card, name):
    """Each forward kernel captured in a CUDA graph by ``CompiledEngine``:
    fresh inputs copied into the static buffers and replayed give the eager
    launch's output on them to the bit, and each replay counts one launch."""
    from repro_torch.core.engines import CompiledEngine

    fn, key, shapes = GRAPH_KERNELS[name]
    eng = CompiledEngine(fn)
    eng.run_step(*_fresh(card, 0, shapes))
    assert eng.captured
    for seed in (1, 2):
        fresh = _fresh(card, seed, shapes)
        ops.reset_launch_counts()
        got = eng.run_step(*fresh)
        torch.cuda.synchronize()
        assert ops.launch_counts()[key] == 1
        assert torch.equal(got, fn(*fresh))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["eager", "compiled", "blockwise"])
def test_the_first_call_runs_an_in_place_function_once_on_the_card(card, engine):
    """A function that writes its argument in place (as the train step's
    AdamW does) takes one step a call on the card, the first call (warm-up
    and capture) included: x.add_(1) leaves 1, then 2; the RMSNorm kernel
    inside it counts one launch a call."""
    from repro_torch.core.engines import BlockwiseEngine, CompiledEngine, EagerEngine

    scale = torch.zeros(8, device=card)

    def bump(x):
        ops.fused_rmsnorm(x[:, :8].contiguous(), scale)
        return x.add_(1)

    eng = {"eager": lambda: EagerEngine(bump),
           "compiled": lambda: CompiledEngine(bump, donate_argnums=(0,)),
           "blockwise": lambda: BlockwiseEngine([bump], donate_argnums=(0,))}[engine]()
    x = torch.zeros(4, 8, device=card)
    ops.reset_launch_counts()
    eng.run_step(x)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones_like(x)) and ops.launch_counts()["fused_rmsnorm"] == 1
    eng.run_step(x)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 2.0)) and ops.launch_counts()["fused_rmsnorm"] == 2
    assert eng.captured == (engine != "eager")


@pytest.mark.gpu
def test_graph_engines_equal_eager_on_full_width_qwen3(card):
    """``fig01_engines`` on qwen3-4b at full width cut to 2 layers: the
    compiled engine's loss equals the eager full loss to the bit, the
    blockwise engine's the eager chain of its stages, and every engine
    counts the same launches a step (flash 2, RMSNorm 2 x 4 + 1)."""
    from repro_torch.benchmarks import fig01_engines as fig01
    from repro_torch.core.engines import EagerEngine

    model, params, batch = fig01.setup(card, smoke=False, n_layers=2)
    full_loss, stages = fig01.make_fns(model, params, batch)
    eager, blockwise, compiled = fig01.make_engines(full_loss, stages)

    def chain(carry):
        for s in stages:
            carry = s(carry)
        return carry

    eager_chain = EagerEngine(chain)
    got, per_step = {}, {}
    for eng in (eager, eager_chain, blockwise, compiled):
        eng.run(1, lambda i: (params,))  # the graph engines capture here
        ops.reset_launch_counts()
        out = eng.run(3, lambda i: (params,)).outputs
        got[eng] = out.clone()
        per_step[eng] = {k: n / 3 for k, n in ops.launch_counts().items() if n}
    assert blockwise.captured and compiled.captured
    assert torch.equal(got[compiled], got[eager])
    assert torch.equal(got[blockwise], got[eager_chain])
    want = {"flash_attention": 2, "flash_attention_wgmma": 2, "fused_rmsnorm": 9}
    assert all(p == want for p in per_step.values()), per_step


# the flash kernels at 32k tokens against the xla path's chunked softmax on
# f32 copies (``models/attention._attend_chunked``): (arch, S); B = 1
LONG_FLASH = [("qwen3-4b", 32768), ("recurrentgemma-9b", 32768)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,S", LONG_FLASH)
def test_flash_at_32k_against_the_chunked_oracle(card, arch, S):
    from repro_torch.models.attention import _attend_chunked

    cfg = get_config(arch)
    g = torch.Generator(device=card).manual_seed(29)
    q = torch.randn((1, S, cfg.n_heads, cfg.head_dim), generator=g, device=card).bfloat16()
    k, v = (torch.randn((1, S, cfg.n_kv_heads, cfg.head_dim), generator=g, device=card).bfloat16() for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=card).bfloat16()
    leaves = [a.float().requires_grad_(True) for a in (q, k, v)]
    want = _attend_chunked(*leaves, cfg, window=cfg.window)
    want.backward(do.float())
    o, lse = ops.flash_attention(q, k, v, window=cfg.window, return_lse=True)
    _close(o, want.detach(), "bf16")
    # late rows read ~0.006, under the bf16 atol: each 64-row block is held
    # relative to its own size, as chip_smoke.py's long_attention phase does
    _block_close(o, want.detach(), "bf16")
    for got, leaf in zip(ops.flash_attention_bwd(q, k, v, o, do, window=cfg.window, lse=lse), leaves):
        _flash_grad_close(got, leaf.grad, "bf16")


@pytest.mark.gpu
def test_four_gloo_ranks_on_the_card_equal_the_simulation_to_the_bit(card, tmp_path):
    """The expert-parallel MoE layer at smoke size: four spawned ranks, each
    on the one card in a gloo group, against the one-process simulation of
    the same ranks on the card, f32 and bf16, at the default capacity."""
    import torch.multiprocessing as mp

    import _torch_moe_ep_ranks as ranks

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    n = ranks.N_DATA * ranks.N_MODEL
    procs = [ctx.Process(target=ranks.gloo_rank, args=(r, n, str(tmp_path / "store"), out, "cuda", False))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=180) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert all(err is None for _, _, err in results), [err for _, _, err in results]
    got = {r: res for r, res, _ in results}
    for dtype in ranks.DTYPES:
        ys, aux, grads = ranks.simulate_layer(dtype, device="cuda")
        for r in range(n):
            want = {"y": ys[r], **aux[r], **grads[r]}
            for name, w in want.items():
                w = w.detach().cpu()
                bits = (w.view(torch.int16) if w.dtype == torch.bfloat16 else w).numpy()
                np.testing.assert_array_equal(got[r]["layer"][str(dtype)][name], bits, err_msg=f"rank {r} {name}")
