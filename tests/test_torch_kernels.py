"""The port's kernels on the CPU: plain versions against the JAX package's
Pallas kernels (interpret mode), and the dispatch rules. The hand-written
kernels themselves are held against their plain versions on the card in
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_kernels.py's tolerances
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values for both frameworks: bf16 by casting one f32 array."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().cpu().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def _qkv(seed, B, S, T, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, Hq, D), np.float32),
        rng.standard_normal((B, T, Hkv, D), np.float32),
        rng.standard_normal((B, T, Hkv, D), np.float32),
    )


FLASH_CASES = [
    (1, 128, 128, 2, 2, 64),   # MHA, single block
    (2, 256, 256, 4, 1, 64),   # MQA, multi-block
    (1, 384, 384, 4, 2, 128),  # GQA, non-square block count
    (1, 100, 100, 2, 2, 64),   # ragged (padding path)
    (1, 128, 256, 2, 2, 64),   # cross: kv longer than q
]


# ---------------------------------------------------------------------------
# plain versions vs the JAX package's kernels (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D", FLASH_CASES)
def test_flash_plain_vs_pallas_causal(B, S, T, Hq, Hkv, D, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in _qkv(0, B, S, T, Hq, Hkv, D))
    want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, Hq, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [16, 64, 1024])
def test_flash_plain_vs_pallas_window(window):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "f32") for a in _qkv(1, 1, 256, 256, 2, 2, 64))
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True, window=window), want, "f32")


def test_flash_plain_vs_pallas_noncausal():
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "f32") for a in _qkv(2, 1, 128, 128, 2, 2, 64))
    want = jops.flash_attention(jq, jk, jv, causal=False, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=False), want, "f32")


# Every bf16 case of the sweep above, the window cases and gemma's D = 256 MQA:
# (B, S, T, Hq, Hkv, D, window)
P_BF16_CASES = [(*c, None) for c in FLASH_CASES] + [(1, 256, 256, 2, 2, 64, w) for w in (16, 64, 1024)] + [
    (1, 128, 128, 8, 1, 256, None)
]


@pytest.mark.parametrize("p_bf16", [1, 2])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window", P_BF16_CASES)
def test_flash_plain_with_bf16_p_vs_pallas(B, S, T, Hq, Hkv, D, window, p_bf16):
    """Softmax probabilities fed to the PV product as one bf16 term (the TPU
    matrix unit's default pass) or two (the wgmma kernel) stay within the bf16
    tolerance of the JAX kernel, which keeps them in f32 on the CPU."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bf16") for a in _qkv(9, B, S, T, Hq, Hkv, D))
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window, interpret=True)
    got = ref.attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=True,
                            window=window, p_bf16=p_bf16).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16")


def test_flash_plain_vs_pallas_gemma_mqa_d256():
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bf16") for a in _qkv(3, 1, 128, 128, 8, 1, 256))
    want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want, "bf16")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1000, 512)])
def test_rmsnorm_plain_vs_pallas(shape, dtype):
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.standard_normal(shape, np.float32), dtype)
    js, ts = _pair(rng.standard_normal(shape[-1], np.float32) * 0.1, "f32")
    got = ops.fused_rmsnorm(tx, ts)
    assert got.dtype == TDT[dtype]
    _close(got, jops.fused_rmsnorm(jx, js, interpret=True), dtype)


def test_attention_ref_matches_jax_ref():
    from repro.kernels import ref as jref

    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "f32") for a in _qkv(4, 1, 64, 64, 4, 2, 16))
    sw = lambda a: jnp.swapaxes(a, 1, 2)  # noqa: E731
    want = jref.attention_ref(sw(jq), sw(jk), sw(jv), causal=True, window=8)
    got = ref.attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=True, window=8)
    _close(got, want, "f32")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 16, 16, 2, 1, 16))
    ops.flash_attention(q, k, v)
    ops.fused_rmsnorm(q, torch.zeros(16))
    ops.rglru_scan(q[:, :, 0].contiguous(), k[:, :, 0].contiguous())
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_wgmma": 0, "fused_rmsnorm": 0, "rglru_scan": 0,
                                   "rglru_scan_sequential": 0}


@pytest.mark.parametrize("D", flash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_variant_goes_by_dtype_and_head_dim(dtype, D):
    """bf16 at D 16/64/128/256 takes the wgmma kernel; f32, and bf16 at D = 8
    (below one k16 step), the FMA kernel."""
    want = "wgmma" if dtype == "bf16" and D != 8 else "fma"
    assert flash.variant(TDT[dtype], D) == want


@pytest.mark.parametrize(
    "bad",
    ["head_dim_32", "float16", "float64", "strided_head_dim", "zero_window", "mixed_dtypes", "meta_device",
     "bf16_rows_not_16_byte_aligned"],
)
def test_flash_dispatch_rejects(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 16, 16, 2, 1, 16))
    if bad == "head_dim_32":
        q, k, v = (torch.cat([t, t], dim=-1) for t in (q, k, v))
    elif bad in ("float16", "float64"):
        q, k, v = (t.to(getattr(torch, bad)) for t in (q, k, v))
    elif bad == "strided_head_dim":
        q = torch.cat([q, q], dim=-1)[..., ::2]
    elif bad == "mixed_dtypes":
        k = k.bfloat16()
    elif bad == "meta_device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif bad == "bf16_rows_not_16_byte_aligned":  # the wgmma kernel's TMA cannot read a head stride of 20
        q, k, v = (torch.cat([t, t[..., :4]], dim=-1).bfloat16()[..., :16] for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, window=0 if bad == "zero_window" else None)


@pytest.mark.parametrize("bad", ["float16", "scale_bf16", "scale_shape", "strided"])
def test_rmsnorm_dispatch_rejects(bad):
    x, s = torch.randn(4, 64), torch.zeros(64)
    if bad == "float16":
        x = x.half()
    elif bad == "scale_bf16":
        s = s.bfloat16()
    elif bad == "scale_shape":
        s = torch.zeros(32)
    elif bad == "strided":
        x = torch.randn(64, 4).T
    with pytest.raises((ValueError, TypeError)):
        ops.fused_rmsnorm(x, s)
