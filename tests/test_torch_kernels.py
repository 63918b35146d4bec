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
# backward: the plain versions against autograd, the autograd Functions' CPU path
# ---------------------------------------------------------------------------

# (B, S, T, Hq, Hkv, D, window): the forward sweep's shapes, windows, gemma's
# D = 256 MQA, the smoke head dims, S > T and S < T
BWD_CASES = [c + (None,) for c in FLASH_CASES] + [
    (1, 256, 256, 2, 2, 64, 16), (1, 256, 256, 2, 2, 64, 1024), (1, 128, 128, 8, 1, 256, None),
    (1, 96, 96, 4, 1, 256, 40), (2, 64, 64, 4, 2, 16, None), (2, 40, 40, 6, 2, 8, None), (1, 60, 30, 2, 1, 16, None),
]


def _grad_close(got: torch.Tensor, want: torch.Tensor, dtype: str):
    """The dtype's tolerance with the atol scaled by the gradient's largest
    magnitude: gradients sum many products in another f32 order than
    autograd, so near-zero entries carry an error of the order of the terms."""
    got, want = got.float(), want.float()
    tol = TOL[dtype]
    scale = max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    assert bool((err <= tol["atol"] * scale + tol["rtol"] * want.abs()).all()), (float(err.max()), scale)


def _bwd_inputs(case, dtype, causal, seed=20):
    B, S, T, Hq, Hkv, D, window = case
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in _qkv(seed, B, S, T, Hq, Hkv, D))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((B, S, Hq, D), np.float32)).to(TDT[dtype])
    return q, k, v, do, dict(causal=causal, window=window)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_matches_autograd_of_attention_ref(case, dtype, causal):
    """The explicit backward formulas against torch.autograd through the
    plain forward, from the same inputs. In bf16, Dr = rowsum(do * o) reads
    the output rounded to bf16, as the kernel does, where autograd differs
    from the f32 output; the bf16 tolerance covers that."""
    q, k, v, do, kw = _bwd_inputs(case, dtype, causal)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    o = ref.attention_ref(*leaves, **kw)
    want = torch.autograd.grad(o, leaves, do.transpose(1, 2))
    got = ref.attention_bwd_ref(*(t.detach() for t in leaves), o.detach(), do.transpose(1, 2), **kw)
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype]
        _grad_close(g, w, dtype)


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (0, 2, 5, 8, 9)])
def test_attention_bwd_ref_matches_jax_vjp(case):
    """Across frameworks: the port's plain backward against jax.vjp of the JAX
    package's plain attention (repro.kernels.ref.attention_ref), f32."""
    import jax

    from repro.kernels import ref as jref

    B, S, T, Hq, Hkv, D, window = case
    arrays = _qkv(21, B, S, T, Hq, Hkv, D)
    do = np.random.default_rng(22).standard_normal((B, Hq, S, D), np.float32)
    sw = lambda a: np.swapaxes(a, 1, 2)  # noqa: E731
    o, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, causal=True, window=window),
                     *(jnp.asarray(sw(a)) for a in arrays))
    want = vjp(jnp.asarray(do))
    got = ref.attention_bwd_ref(*(torch.from_numpy(sw(a).copy()) for a in arrays), torch.from_numpy(np.array(o)),
                                torch.from_numpy(do), causal=True, window=window)
    for g, w in zip(got, want):
        _grad_close(g, torch.from_numpy(np.array(w)), "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (1, 5, 8, 11)])
def test_flash_function_cpu_path_takes_the_plain_backward(case, dtype):
    """Autograd through ops.flash_attention on CPU tensors gives exactly the
    plain backward from the plain forward's output, and counts no launch."""
    q, k, v, do, kw = _bwd_inputs(case, dtype, True, seed=23)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do)
    want = ops.flash_attention_bwd(q, k, v, o.detach(), do, **kw)
    plain = ref.attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o.detach(), do)), **kw)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p.transpose(1, 2))
    assert set(ops.launch_counts().values()) == {0}


def _masked_scores(q, k, causal, window):
    """(B, Hq, S, T) f32 scores of (B, S, H, D) inputs, -inf where masked."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr) / np.sqrt(D)
    i, j = torch.arange(S)[:, None], torch.arange(T)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= i - j < window
    return s.masked_fill(~mask, -np.inf)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BWD_CASES + [(1, 96, 32, 2, 1, 16, 8)])  # the last: rows 39 on see no key
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(case, causal):
    """attention_ref(return_lse=True) and ops.flash_attention(return_lse=True)
    on the CPU: the output as without it, and lse = logsumexp over the
    visible keys of the scaled scores, +inf on a row that sees none."""
    q, k, v, _, kw = _bwd_inputs(case, "f32", causal, seed=30)
    t = [a.transpose(1, 2) for a in (q, k, v)]
    o, lse = ref.attention_ref(*t, **kw, return_lse=True)
    exact = dict(rtol=0, atol=0, equal_nan=True)  # a row that sees no key has no plain output (NaN)
    torch.testing.assert_close(o, ref.attention_ref(*t, **kw), **exact)
    want = torch.logsumexp(_masked_scores(q, k, **kw), dim=-1)
    empty = want == -np.inf
    assert lse.shape == (case[0], case[3], case[1]) and lse.dtype == torch.float32
    assert bool((lse[empty] == np.inf).all()) and (case[-1] != 8 or causal or bool(empty.any()))
    torch.testing.assert_close(lse[~empty], want[~empty], rtol=1e-6, atol=1e-6)
    o2, lse2 = ops.flash_attention(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(o2, o.transpose(1, 2), **exact)
    assert torch.equal(lse2, lse)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_with_the_forwards_lse_equals_without(case, dtype):
    """The plain backward from the forward's saved lse is the plain backward
    that recomputes it, to the bit (the same scores, the same logsumexp)."""
    q, k, v, do, kw = _bwd_inputs(case, dtype, True, seed=31)
    t = [a.transpose(1, 2) for a in (q, k, v)]
    o, lse = ref.attention_ref(*t, **kw, return_lse=True)
    got = ref.attention_bwd_ref(*t, o, do.transpose(1, 2), **kw, lse=lse)
    want = ref.attention_bwd_ref(*t, o, do.transpose(1, 2), **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (0, 2, 5, 8, 9)])
def test_attention_bwd_ref_from_lse_matches_jax_vjp(case):
    """As test_attention_bwd_ref_matches_jax_vjp, the row statistics taken
    from the plain forward's lse: f32 2e-5 against jax.vjp of the JAX
    package's plain attention."""
    import jax

    from repro.kernels import ref as jref

    B, S, T, Hq, Hkv, D, window = case
    arrays = _qkv(21, B, S, T, Hq, Hkv, D)
    do = np.random.default_rng(22).standard_normal((B, Hq, S, D), np.float32)
    sw = lambda a: np.swapaxes(a, 1, 2)  # noqa: E731
    o, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, causal=True, window=window),
                     *(jnp.asarray(sw(a)) for a in arrays))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(sw(a).copy()) for a in arrays]
    _, lse = ref.attention_ref(*t, causal=True, window=window, return_lse=True)
    got = ref.attention_bwd_ref(*t, torch.from_numpy(np.array(o)), torch.from_numpy(do), causal=True,
                                window=window, lse=lse)
    for g, w in zip(got, want):
        _close(g, np.array(w), "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_function_cpu_path_saves_the_forwards_lse(dtype):
    """Where autograd records on CPU tensors, the forward keeps o and lse for
    the backward: the saved lse is the plain forward's."""
    q, k, v, _, kw = _bwd_inputs(BWD_CASES[5], dtype, True, seed=32)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, **kw)
    saved = o.grad_fn.saved_tensors
    _, lse = ref.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), **kw, return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[3], o.detach()) and torch.equal(saved[4], lse)


def test_plain_backward_of_rows_that_see_no_key_is_zero():
    """S > T + window: rows from T + window - 1 on see no key. Their lse is
    +inf, so their P is 0: dq is 0 there and they add nothing to dk and dv
    (the rows that see keys give the same gradients alone)."""
    B, S, T, Hq, Hkv, D, window = 1, 96, 32, 2, 1, 16, 8
    n = T + window - 1
    q, k, v, do, kw = _bwd_inputs((B, S, T, Hq, Hkv, D, window), "f32", True, seed=33)
    t = [a.transpose(1, 2) for a in (q, k, v, do)]
    o, lse = ref.attention_ref(*t[:3], **kw, return_lse=True)
    assert bool((lse[:, :, n:] == np.inf).all()) and bool(lse[:, :, :n].isfinite().all())
    o = o.nan_to_num()  # the plain forward has no output for such a row; the kernel's is finite
    dq, dk, dv = ref.attention_bwd_ref(t[0], t[1], t[2], o, t[3], **kw, lse=lse)
    assert all(bool(g.isfinite().all()) for g in (dq, dk, dv)) and not bool(dq[:, :, n:].any())
    want = ref.attention_bwd_ref(t[0][:, :, :n], t[1], t[2], o[:, :, :n], t[3][:, :, :n], **kw)
    for g, w in zip((dq[:, :, :n], dk, dv), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S", [1, 64, 100, 130])
def test_padded_lse_layout(S):
    """The wgmma backward reads lse in rows of lse_stride(S) floats: a
    new_lse view passes ``check_lse_layout``; any other lse raises."""
    B, Hq = 2, 3
    n = flash.lse_stride(S)
    assert n % flash.LSE_ROWS == 0 and S <= n < S + flash.LSE_ROWS
    buf = flash.new_lse(B, Hq, S, "cpu")
    assert buf.shape == (B, Hq, S) and buf.stride() == (Hq * n, n, 1)
    flash.check_lse_layout(buf)
    for other in (torch.randn(B, Hq, S), torch.randn(B, Hq, n + flash.LSE_ROWS)[..., :S], buf.double()):
        if other.stride() == buf.stride() and other.dtype == buf.dtype:
            continue  # S a multiple of LSE_ROWS: a plain tensor already is the layout
        with pytest.raises(ValueError, match="new_lse"):
            flash.check_lse_layout(other)


def test_return_lse_refuses_a_recorded_call():
    """return_lse hands back the kernel's output without a grad_fn on the
    card, so it raises where autograd records the call, on the CPU as there."""
    g = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 8, 2, 16)).astype(np.float32)) for _ in range(3))
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert o.shape == q.shape and lse.shape == (1, 2, 8)
    with pytest.raises(ValueError, match="return_lse"):
        ops.flash_attention(q.requires_grad_(), k, v, return_lse=True)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q, k, v, return_lse=True)[1], lse)


RMSNORM_BWD_SHAPES = [(4, 128), (2, 7, 256), (1, 1000, 512), (3, 16), (5, 3000)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", RMSNORM_BWD_SHAPES)
def test_rmsnorm_bwd_ref_matches_autograd_of_rmsnorm_ref(shape, dtype):
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(TDT[dtype]).requires_grad_()
    s = torch.from_numpy(rng.standard_normal(shape[-1], np.float32) * 0.1).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(TDT[dtype])
    want = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), dy)
    dx, ds = ref.rmsnorm_bwd_ref(x.detach(), s.detach(), dy)
    assert dx.dtype == TDT[dtype] and ds.dtype == torch.float32
    _grad_close(dx, want[0], dtype)
    _grad_close(ds, want[1], "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_function_cpu_path_takes_the_plain_backward(dtype):
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal((6, 40), np.float32)).to(TDT[dtype])
    s = torch.from_numpy(rng.standard_normal(40, np.float32) * 0.1)
    dy = torch.from_numpy(rng.standard_normal((6, 40), np.float32)).to(TDT[dtype])
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.fused_rmsnorm(xl, sl), (xl, sl), dy)
    want = ref.rmsnorm_bwd_ref(x, s, dy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_function_cpu_path_takes_the_plain_backward(dtype):
    """A recorded scan on the CPU: the Function saves a and h, and its
    backward is the plain one on them, with no launch counted."""
    rng = np.random.default_rng(27)
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 19, 6)).astype(np.float32)).to(TDT[dtype])
    b = torch.from_numpy(rng.standard_normal((2, 19, 6), np.float32)).to(TDT[dtype])
    dh = torch.from_numpy(rng.standard_normal((2, 19, 6), np.float32)).to(TDT[dtype])
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    ops.reset_launch_counts()
    h = ops.rglru_scan(al, bl)
    assert torch.equal(h.detach(), ref.rglru_ref(a, b))
    got = torch.autograd.grad(h, (al, bl), dh)
    want = ref.rglru_bwd_ref(a, h.detach(), dh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["float16", "shape", "mixed_dtypes", "strided_h", "meta_device"])
def test_rglru_scan_bwd_dispatch_rejects(bad):
    a = h = dh = torch.rand(1, 8, 4)
    if bad == "float16":
        a = h = dh = a.half()
    elif bad == "shape":
        dh = dh[:, :4]
    elif bad == "mixed_dtypes":
        h = h.bfloat16()
    elif bad == "strided_h":
        h = torch.rand(1, 8, 8)[..., ::2]
    elif bad == "meta_device":  # the meta device plans shapes (launch/dryrun.py), but not beside a CPU tensor
        a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan_bwd(a, h, dh)


@pytest.mark.parametrize("bad", ["o_shape", "do_dtype", "strided_o"])
def test_flash_bwd_dispatch_rejects(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(26, 1, 16, 16, 2, 1, 16))
    o, do = q.clone(), q.clone()
    if bad == "o_shape":
        o = o[:, :8]
    elif bad == "do_dtype":
        do = do.bfloat16()
    elif bad == "strided_o":
        o = torch.cat([o, o], dim=-1)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention_bwd(q, k, v, o, do)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 16, 16, 2, 1, 16))
    ops.flash_attention(q, k, v)
    ops.fused_rmsnorm(q, torch.zeros(16))
    ops.rglru_scan(q[:, :, 0].contiguous(), k[:, :, 0].contiguous())
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_wgmma": 0, "fused_rmsnorm": 0,
                                   "rglru_scan": 0, "rglru_scan_sequential": 0, "flash_attention_bwd": 0,
                                   "flash_attention_bwd_wgmma": 0, "flash_attention_bwd_mma": 0,
                                   "fused_rmsnorm_bwd": 0, "rglru_scan_bwd": 0}


def test_plain_versions_names_the_kernels_it_swaps_and_restores_them():
    """Inside ``plain_versions`` the named kernels take their plain versions on
    any device (a meta tensor stands for the card's here), the others do not;
    the context nests and restores on exit, also after an error."""
    t = torch.empty(1, device="meta")
    assert not any(ops._plain(k, t) for k in ops.KERNELS)
    with ops.plain_versions("rglru_scan"):
        assert ops._plain("rglru_scan", t) and not ops._plain("flash_attention", t)
        with ops.plain_versions():
            assert all(ops._plain(k, t) for k in ops.KERNELS)
        assert ops._plain("rglru_scan", t) and not ops._plain("fused_rmsnorm", t)
    with pytest.raises(RuntimeError), ops.plain_versions("flash_attention"):
        raise RuntimeError
    assert not any(ops._plain(k, t) for k in ops.KERNELS)
    assert ops._plain("flash_attention", torch.empty(1))  # a CPU tensor, always
    with pytest.raises(ValueError, match="unknown kernels"), ops.plain_versions("rglru_scan_bwd"):
        pass


@pytest.mark.parametrize("D", flash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_variant_goes_by_dtype_and_head_dim(dtype, D):
    """bf16 at D 16/64/128/256 takes the wgmma kernel; f32, and bf16 at D = 8
    (below one k16 step), the FMA kernel."""
    want = "wgmma" if dtype == "bf16" and D != 8 else "fma"
    assert flash.variant(TDT[dtype], D) == want


@pytest.mark.parametrize("D", flash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_bwd_variant_goes_by_dtype_and_head_dim(dtype, D):
    """bf16 at D 16/64/128/256 takes the wgmma backward (the mma pair is never
    picked); f32, and bf16 at D = 8, the FMA backward: every forward shape has
    a backward, the FMA pair is built for every other one, and in bf16 at
    D = 256 too, as the yardstick of the wgmma pair there."""
    want = "wgmma" if dtype == "bf16" and D in (16, 64, 128, 256) else "fma"
    assert flash.bwd_variant(TDT[dtype], D) == want
    assert want == "wgmma" or dtype == "f32" or D in flash.FMA_BWD_BF16_HEAD_DIMS
    assert dtype == "f32" or D != 256 or D in flash.FMA_BWD_BF16_HEAD_DIMS


H100_SMS = 132


@pytest.mark.parametrize(
    "B,Hkv,G,T,want",
    [
        (1, 1, 16, 4096, 8),  # recurrentgemma-9b training (MQA, 64 key tiles): 512 blocks
        (8, 1, 8, 2048, 1),  # gemma-2b at batch 8: 256 blocks already fill the card
        (1, 8, 4, 2048, 1),  # qwen3-4b's shape (8 kv-heads): 256 blocks
        (1, 1, 16, 1024, 16),  # 16 key tiles: even 16 groups give fewer than two blocks an SM
        (2, 2, 2, 192, 2),  # the GPU sweep's D = 256 case with Hkv > 1, B > 1
        (1, 2, 1, 256, 1),  # Hq = Hkv: nothing to split
    ],
)
def test_dkdv_splits_fill_the_card_only_where_it_is_idle(B, Hkv, G, T, want):
    """The D = 256 dK/dV grid's q-head groups: a divisor of G; none where one
    block per (key tile, batch, kv-head) already covers the SMs; otherwise
    the fewest that give two blocks an SM, or all G."""
    s = flash.dkdv_splits(B, Hkv, G, T, H100_SMS)
    assert s == want and G % s == 0
    blocks = B * Hkv * -(-T // flash.KEY_TILE)
    if blocks >= H100_SMS:
        assert s == 1
    else:
        assert blocks * s >= 2 * H100_SMS or s == G
        assert all(blocks * d < 2 * H100_SMS for d in range(2, s) if G % d == 0)


def test_launch_bwd_mma_refuses_head_dim_256_before_touching_cuda(monkeypatch):
    """The mma pair is built for D 16/64/128: at D = 256 its wrapper raises
    before it builds or loads the library."""

    def no_build(*_):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(flash.build, "load", no_build)
    q = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16)
    k = v = torch.zeros((1, 64, 1, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash.launch_bwd_mma(q, k, v, q, q, causal=True, window=None)


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
    elif bad == "meta_device":  # the meta device plans shapes (launch/dryrun.py), but not beside a CPU tensor
        q, k = q.to("meta"), k.to("meta")
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
