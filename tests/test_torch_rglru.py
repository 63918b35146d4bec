"""The hybrid slice on the CPU against the JAX package: the RG-LRU scan's
plain version against the Pallas kernel (interpret mode), its plain backward
against ``jax.vjp`` of the JAX package's plain scan, the ported
``rglru.py`` functions module by module, and ``recurrentgemma-9b`` smoke
logits of prefill and decode, with the JAX model on its kernel path
(``attention_impl="pallas_interpret"``) and jitted. Inputs come from numpy
seeds. The CUDA kernel itself is held against the plain version on the card
in tests/test_torch_gpu.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rgk  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.modules import ArraySpec  # noqa: E402
from repro_torch.models.transformer import _unit  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

ARCH = "recurrentgemma-9b"
# tests/test_kernels.py's tolerances
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = 0.05  # tests/test_smoke_archs.py's decode/prefill bound
# Prefill logits against JAX: above the JAX package's own kernel-vs-XLA gap
# (0.0049), below what dropping XLA's f32 residual sum across fused blocks
# reads (0.045-0.126; ROADMAP Queue 3)
FORWARD_TOL = 0.01
# tests/test_kernels.py's RG-LRU sweep: (B, S, W) with the Pallas block sizes
SCAN_CASES = [(1, 128, 512, 128, 512), (2, 256, 512, 128, 256), (1, 200, 300, 128, 256), (1, 512, 128, 64, 128)]


def _pair(a: np.ndarray, dtype: str):
    """The same values for both frameworks: bf16 by casting one f32 array."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, dtype: str):
    assert got.dtype == TDT[dtype] and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _bridged(seed=0):
    """(JAX model, JAX params, port model, port params) sharing one set of weights."""
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True), attention_impl="pallas_interpret"))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(ARCH, smoke=True)
    return jm, jp, Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the scan: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,bs,bw", SCAN_CASES)
def test_rglru_plain_vs_pallas(B, S, W, bs, bw, dtype):
    rng = np.random.default_rng(5)
    # decays in (0,1): the RG-LRU regime
    (ja, ta), (jb, tb) = _pair(1 / (1 + np.exp(-rng.standard_normal((B, S, W)))), dtype), _pair(
        rng.standard_normal((B, S, W)), dtype
    )
    want = jops.rglru_scan(ja, jb, block_s=bs, block_w=bw, interpret=True)
    _close(ops.rglru_scan(ta, tb), want, dtype)


def test_rglru_plain_carries_state_as_a_running_count():
    """a = b = 1 gives h_t = t + 1, exact in f32: any lost or reset state shows."""
    a = torch.ones((1, 256, 128))
    want = jops.rglru_scan(jnp.ones((1, 256, 128)), jnp.ones((1, 256, 128)), block_s=64, block_w=128, interpret=True)
    got = ref.rglru_ref(a, a)
    assert torch.equal(got, torch.arange(1, 257, dtype=torch.float32)[None, :, None].expand(1, 256, 128))
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# the scan's backward: plain version vs jax.vjp, and the autograd Function
# ---------------------------------------------------------------------------

# (B, S, W): the Pallas sweep's shapes, ragged W (70, 300: one-element and
# 16-byte loads), S off every multiple of the kernel's sub-chunk (8), block
# (32) and cluster span (256), and one step
BWD_CASES = [(1, 128, 512), (2, 37, 70), (1, 200, 300), (1, 257, 64), (3, 9, 130), (1, 1, 70)]


def _bwd_inputs(B, S, W, dtype, seed=30):
    (ja, ta), (jb, tb) = _scan_inputs(B, S, W, dtype, seed=seed)
    jdh, tdh = _pair(np.random.default_rng(seed + 1).standard_normal((B, S, W)), dtype)
    return (ja, ta), (jb, tb), (jdh, tdh)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", BWD_CASES)
def test_rglru_bwd_plain_vs_jax_vjp(B, S, W, dtype):
    """da, db from the forward's saved h against jax.vjp of the JAX package's
    plain scan (which differentiates through its own f32 h)."""
    (ja, ta), (jb, tb), (jdh, tdh) = _bwd_inputs(B, S, W, dtype)
    h, vjp = jax.vjp(jref.rglru_ref, ja, jb)
    want_da, want_db = vjp(jdh)
    da, db = ref.rglru_bwd_ref(ta, ref.rglru_ref(ta, tb), tdh)
    _close(da, want_da, dtype)
    _close(db, want_db, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", BWD_CASES)
def test_rglru_scan_function_matches_autograd_through_the_plain_forward(B, S, W, dtype, monkeypatch):
    """ops.rglru_scan's Function (its CPU path: the plain backward on the
    saved a and h) against autograd through ref.rglru_ref."""
    (_, ta), (_, tb), (_, tdh) = _bwd_inputs(B, S, W, dtype)
    leaves = [t.clone().requires_grad_() for t in (ta, tb)]
    custom = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, tdh)
    monkeypatch.setattr(ops, "_records", lambda *tensors: False)  # no Function: autograd sees the plain ops
    plain = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, tdh)
    for got, want in zip(custom, plain):
        _close(got, want, dtype)


def _bwd_chunked(a, h, dh, chunk=rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=None):
    cluster = rgk.cluster_size(a.shape[1], chunk * warps) if cluster is None else cluster
    return ref.rglru_bwd_chunked_ref(a, h, dh, chunk, warps=warps, cluster=cluster)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", BWD_CASES + [(1, 1500, 300), (2, 256, 70), (1, 33, 70)])
def test_rglru_bwd_chunked_model_vs_plain(B, S, W, dtype):
    """The backward kernel's order of arithmetic (the chunked scan over
    reversed, shifted inputs) against the plain reverse-time loop; at S over
    several rounds and at the tiling's edges."""
    (_, ta), (_, tb), (_, tdh) = _bwd_inputs(B, S, W, dtype, seed=S)
    h = ref.rglru_ref(ta, tb)
    for got, want in zip(_bwd_chunked(ta, h, tdh), ref.rglru_bwd_ref(ta, h, tdh)):
        _close(got, want, dtype)


@pytest.mark.parametrize("chunk,warps,cluster", [(1, 1, 1), (2, 3, 2), (5, 1, 8)])
@pytest.mark.parametrize("S", [1, 11, 97])
def test_rglru_bwd_chunked_model_at_other_tilings(chunk, warps, cluster, S):
    (_, ta), (_, tb), (_, tdh) = _bwd_inputs(2, S, 9, "f32", seed=S)
    h = ref.rglru_ref(ta, tb)
    for got, want in zip(_bwd_chunked(ta, h, tdh, chunk, warps, cluster), ref.rglru_bwd_ref(ta, h, tdh)):
        _close(got, want, "f32")


def test_rglru_bwd_edges_are_exact():
    """With a = 1 the gradient is the suffix sum of dh: db_t = S - t for
    dh = 1, exact in f32, in the plain loop and in the chunked model; da_0 = 0
    (no h_{-1}) and da_t = db_t h_{t-1}."""
    S, W = 300, 70
    one = torch.ones((1, S, W))
    h = torch.arange(1, S + 1, dtype=torch.float32)[None, :, None].expand(1, S, W).contiguous()
    want_db = torch.arange(S, 0, -1, dtype=torch.float32)[None, :, None].expand(1, S, W)
    for da, db in (ref.rglru_bwd_ref(one, h, one), _bwd_chunked(one, h, one)):
        assert torch.equal(db, want_db)
        assert torch.equal(da[:, 0], torch.zeros((1, W))) and torch.equal(da[:, 1:], db[:, 1:] * h[:, :-1])


# ---------------------------------------------------------------------------
# the chunked kernel's arithmetic (ref.rglru_chunked_ref): the part of the CUDA
# kernel's design that runs here, where there is no card
# ---------------------------------------------------------------------------


def _chunked(a, b, chunk=rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=None):
    cluster = rgk.cluster_size(a.shape[1]) if cluster is None else cluster
    return ref.rglru_chunked_ref(a, b, chunk, warps=warps, cluster=cluster)


def _scan_inputs(B, S, W, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return _pair(1 / (1 + np.exp(-rng.standard_normal((B, S, W)))), dtype), _pair(rng.standard_normal((B, S, W)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,bs,bw", SCAN_CASES)
def test_rglru_chunked_model_vs_pallas_and_plain(B, S, W, bs, bw, dtype):
    (ja, ta), (jb, tb) = _scan_inputs(B, S, W, dtype)
    got = _chunked(ta, tb)
    _close(got, jops.rglru_scan(ja, jb, block_s=bs, block_w=bw, interpret=True), dtype)
    _close(got, ref.rglru_ref(ta, tb), dtype)


# S at each edge of the kernel's tiling: a sub-chunk (8 steps), a block (32), a
# cluster's span (256) and several rounds; W ragged for both load widths
CHUNK_EDGES = [(1, 1, 70), (1, 7, 70), (1, 8, 300), (1, 9, 70), (2, 31, 300), (1, 32, 70), (1, 33, 300),
               (1, 255, 70), (1, 256, 300), (1, 257, 70), (1, 1500, 300)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", CHUNK_EDGES)
def test_rglru_chunked_model_at_the_tiling_edges(B, S, W, dtype):
    (ja, ta), (jb, tb) = _scan_inputs(B, S, W, dtype, seed=S)
    got = _chunked(ta, tb)
    _close(got, ref.rglru_ref(ta, tb), dtype)
    if S in (9, 257, 1500):  # one sub-chunk, one cluster span and several rounds past the edge
        _close(got, jops.rglru_scan(ja, jb, block_s=128, block_w=128, interpret=True), dtype)


@pytest.mark.parametrize("chunk,warps,cluster", [(1, 1, 1), (2, 3, 2), (3, 2, 4), (5, 1, 8)])
@pytest.mark.parametrize("S", [1, 11, 12, 13, 97])
def test_rglru_chunked_model_at_other_tilings(chunk, warps, cluster, S):
    """The same arithmetic with small tiles: many rounds at small S."""
    (_, ta), (_, tb) = _scan_inputs(2, S, 9, "f32", seed=S)
    _close(_chunked(ta, tb, chunk, warps, cluster), ref.rglru_ref(ta, tb), "f32")


def test_rglru_chunked_model_carries_state_as_a_running_count():
    a = torch.ones((1, 1100, 16))
    want = torch.arange(1, 1101, dtype=torch.float32)[None, :, None].expand(1, 1100, 16)
    assert torch.equal(_chunked(a, a), want)
    assert torch.equal(_chunked(a, a, 2, 3, 2), want)


def test_rglru_chunked_model_bf16_running_sum_is_exact():
    """a = 1, b = 205/2048 in bf16: the f32 sums (t+1)·b are exact, so h is
    bf16((t+1)·b) bit for bit. A carry rounded to bf16 between chunks is not."""
    S, W = 3000, 8
    a, b = torch.ones((1, S, W), dtype=torch.bfloat16), torch.full((1, S, W), 205 / 2048, dtype=torch.bfloat16)
    want = (torch.arange(1, S + 1, dtype=torch.float32) * (205 / 2048)).bfloat16()[None, :, None].expand(1, S, W)
    assert torch.equal(_chunked(a, b), want)
    assert torch.equal(ref.rglru_ref(a, b), want)
    got = jops.rglru_scan(jnp.ones((1, S, W), jnp.bfloat16), jnp.full((1, S, W), 205 / 2048, jnp.bfloat16),
                          block_s=128, block_w=8, interpret=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the test has teeth: the same scan with its state rounded to bf16 at each
    # block's start (every 32 steps) parts from it
    h, rounded = torch.zeros((), dtype=torch.float32), []
    for t in range(S):
        h = (h.bfloat16().float() if t % (rgk.SUB_CHUNK * rgk.WARPS) == 0 else h) + b[0, t, 0].float()
        rounded.append(h)
    assert not torch.equal(torch.stack(rounded).bfloat16(), want[0, :, 0])


def test_rglru_chunked_model_resets_where_a_is_zero():
    """a = 0 at every sub-chunk's start sets h to b there, exactly."""
    (_, ta), (_, tb) = _scan_inputs(2, 300, 70, "f32", seed=3)
    ta[:, :: rgk.SUB_CHUNK] = 0.0
    got = _chunked(ta, tb)
    assert torch.equal(got[:, :: rgk.SUB_CHUNK], tb[:, :: rgk.SUB_CHUNK])
    _close(got, ref.rglru_ref(ta, tb), "f32")


def test_rglru_chunked_model_holds_f32_on_slow_decays():
    """a in [0.99, 1) over 4096 steps, the RG-LRU's slow channels: h reaches
    ~40 and the state runs through 512 sub-chunk carries; f32 2e-5."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.99, 1.0, (1, 4096, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32))
    _close(_chunked(a, b), ref.rglru_ref(a, b), "f32")


@pytest.mark.parametrize(
    "S,want", [(1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (129, 8), (256, 8), (257, 8), (4096, 8)]
)
def test_cluster_size_covers_S_in_one_round_up_to_eight_blocks(S, want):
    assert rgk.cluster_size(S) == want


@pytest.mark.parametrize("S,block_steps,want", [(16, 16, 1), (17, 16, 2), (96, 48, 2), (97, 48, 4), (4096, 96, 8)])
def test_cluster_size_at_another_tiling(S, block_steps, want):
    """A library built at another tiling (``rglru_scan.library(flags)``)
    sizes its clusters by its own steps a block."""
    assert rgk.cluster_size(S, block_steps) == want


@pytest.mark.parametrize("bad", ["float16", "float64", "shape", "mixed_dtypes", "strided", "rank2", "meta_device"])
def test_rglru_dispatch_rejects(bad):
    a, b = torch.rand(1, 8, 16), torch.randn(1, 8, 16)
    if bad in ("float16", "float64"):
        a, b = a.to(getattr(torch, bad)), b.to(getattr(torch, bad))
    elif bad == "shape":
        b = b[:, :4]
    elif bad == "mixed_dtypes":
        b = b.bfloat16()
    elif bad == "strided":
        a = torch.rand(1, 16, 8).transpose(1, 2)
    elif bad == "rank2":
        a, b = a[0], b[0]
    elif bad == "meta_device":  # the meta device plans shapes (launch/dryrun.py), but not beside a CPU tensor
        a = a.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan(a, b)


# ---------------------------------------------------------------------------
# module-level parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    return _bridged()


def _rec_params(bridged, where: str):
    """The rec block's weights as each side computes with them: a scan unit's
    (matrices bf16-valued, cast before the scan) or a remainder layer's (f32)."""
    _, jp, _, tp = bridged
    if where == "scan":
        jl = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16) if a.ndim >= 3 else a[0], jp["layers"]["scan"]["block0"])
        tl = _unit(tp["layers"]["scan"], 0)["block0"]
    else:
        jl, tl = jp["layers"]["remainder"]["layer4"], tp["layers"]["remainder"]["layer4"]
    return jl["rec"], tl["rec"]


def test_weight_dtypes_follow_the_jax_casts(bridged):
    js, ts = _rec_params(bridged, "scan")
    jr, tr = _rec_params(bridged, "remainder")
    assert js["lru"]["wa"].dtype == jnp.bfloat16 and ts["lru"]["wa"].dtype == torch.bfloat16
    assert js["conv_w"].dtype == jnp.bfloat16 and ts["conv_w"].dtype == torch.bfloat16
    assert js["lru"]["lam"].dtype == jnp.float32 and ts["lru"]["lam"].dtype == torch.float32
    assert jr["lru"]["wa"].dtype == jnp.float32 and tr["lru"]["wa"].dtype == torch.float32


def _x(shape, dtype: str, seed=1, scale=1.0):
    return _pair(np.random.default_rng(seed).standard_normal(shape) * scale, dtype)


# The gates' input scale. The smoke scan unit's gate weights have std 1
# (fan_in = n_units = 1, ROADMAP Queue 3), so a unit-scale x drives r to ~1e-9
# for some features; there 1 - exp(2 log_a) lies within an f32 ulp of 0 and
# beta = sqrt of it, so one ulp of exp (XLA's against PyTorch's) moves b by up
# to 15 %. At 1/8 scale the pre-activations have std ~1 and the f32 tolerance
# holds; the whole-model tests below run the smoke model at its own scales.
GATE_X_SCALE = 0.125


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_gates_parity(bridged, where, dtype):
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), dtype, scale=GATE_X_SCALE)
    ja, jb = jax.jit(jrg._gates)(jl["lru"], jx)
    ta, tb = trg._gates(tl["lru"], tx)
    _close(ta, ja, "f32")
    _close(tb, jb, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_rglru_parity_on_the_kernel_path(bridged, where, dtype):
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), dtype, scale=GATE_X_SCALE)
    jh, jlast = jax.jit(lambda p, x: jrg.rglru(p, x, impl="pallas_interpret"))(jl["lru"], jx)
    th, tlast = trg.rglru(tl["lru"], tx)
    _close(th, jh, dtype)
    _close(tlast, jlast, "f32")


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_rglru_h0_parity_on_the_xla_path(bridged, where):
    """The Pallas branch ignores h0 (ROADMAP Queue 3), so a carried state is
    held against the JAX package's XLA branch."""
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), "f32", scale=GATE_X_SCALE)
    jh0, th0 = _x((2, 64), "f32", seed=3)
    jh, jlast = jax.jit(lambda p, x, h0: jrg.rglru(p, x, h0=h0, impl="xla"))(jl["lru"], jx, jh0)
    th, tlast = trg.rglru(tl["lru"], tx, h0=th0)
    _close(th, jh, "f32")
    _close(tlast, jlast, "f32")


def test_rglru_continues_from_a_carried_state(bridged):
    """Two halves, the second started from the first's final state, give the
    whole sequence's scan."""
    _, tl = _rec_params(bridged, "remainder")
    _, tx = _x((2, 16, 64), "f32")
    whole, _ = trg.rglru(tl["lru"], tx)
    first, h = trg.rglru(tl["lru"], tx[:, :8])
    second, _ = trg.rglru(tl["lru"], tx[:, 8:].contiguous(), h0=h)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, **TOL["f32"])


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_rglru_step_parity(bridged, where):
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 1, 64), "bf16", scale=GATE_X_SCALE)
    jh0, th0 = _x((2, 64), "f32", seed=3)
    jy, jh = jax.jit(jrg.rglru_step)(jl["lru"], jx, jh0)
    ty, th = trg.rglru_step(tl["lru"], tx, th0)
    _close(ty, jy, "bf16")
    _close(th, jh, "f32")


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_causal_conv1d_parity(bridged, where):
    """Shifted multiply-adds rounded op by op, as the compiled JAX conv rounds
    them; the port's f32 output rounded to bf16 is the JAX conv's, bitwise."""
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), "bf16")
    want = jax.jit(jrg.causal_conv1d)(jl, jx)
    got = trg.causal_conv1d(tl, tx)
    assert got.dtype == torch.float32
    got = got.to(tx.dtype)
    _close(got, want, "bf16")
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_causal_conv1d_step_parity(bridged, where):
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 1, 64), "bf16")
    jc, tc = _x((2, 3, 64), "bf16", seed=4)
    jy, jstate = jax.jit(jrg.causal_conv1d_step)(jl, jx, jc)
    ty, tstate = trg.causal_conv1d_step(tl, tx, tc)
    assert ty.dtype == torch.float32
    _close(ty.to(tx.dtype), jy, "bf16")
    np.testing.assert_array_equal(_np(tstate), _np(jstate))


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_recurrent_block_parity(bridged, where):
    jm, _, tm, _ = bridged
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), "bf16")
    want = jax.jit(lambda p, x: jrg.recurrent_block(p, x, jm.cfg))(jl, jx)
    _close(trg.recurrent_block(tl, tx, tm.cfg), want, "bf16")


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_recurrent_block_parity_with_a_trained_conv_bias(bridged, where):
    """A conv bias away from its initial zeros, as after a train step: jitted,
    XLA keeps the conv's bias add in f32 where the gates read it, and so does
    the port (``causal_conv1d`` returns f32); a bias add rounded to bf16 parts
    from the reference by ~1 % of the block's output here. Gates' input at
    GATE_X_SCALE."""
    jm, _, tm, _ = bridged
    jl, tl = _rec_params(bridged, where)
    cb = np.sign(np.random.default_rng(6).standard_normal(64)).astype(np.float32) * 0.01
    jl, tl = {**jl, "conv_b": jnp.asarray(cb)}, {**tl, "conv_b": torch.from_numpy(cb.copy())}
    jx, tx = _x((2, 16, 64), "bf16", scale=GATE_X_SCALE)
    want = jax.jit(lambda p, x: jrg.recurrent_block(p, x, jm.cfg))(jl, jx)
    _close(trg.recurrent_block(tl, tx, tm.cfg), want, "bf16")


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_recurrent_block_step_parity_with_a_trained_conv_bias(bridged, where):
    """The decode step at the conv bias of the prefill test above, from a
    carried state, against the jitted JAX step: XLA keeps that bias add in f32
    too, where the f32 gates read it."""
    jm, _, tm, _ = bridged
    jl, tl = _rec_params(bridged, where)
    cb = np.sign(np.random.default_rng(6).standard_normal(64)).astype(np.float32) * 0.01
    jl, tl = {**jl, "conv_b": jnp.asarray(cb)}, {**tl, "conv_b": torch.from_numpy(cb.copy())}
    jx, tx = _x((2, 1, 64), "bf16", scale=GATE_X_SCALE)
    jc, tc = _x((2, 3, 64), "bf16", seed=4)
    jh0, th0 = _x((2, 64), "f32", seed=3)
    want, jstate = jax.jit(lambda p, x, s: jrg.recurrent_block_step(p, x, s, jm.cfg))(jl, jx, {"conv": jc, "h": jh0})
    got, state = trg.recurrent_block_step(tl, tx, {"conv": tc.clone(), "h": th0.clone()}, tm.cfg)
    _close(got, want, "bf16")
    _close(state["h"], jstate["h"], "f32")


def test_decode_matches_prefill_with_a_trained_conv_bias(bridged):
    """Eight decode steps against the prefill of the same eight inputs, at
    the trained conv bias above, on the remainder layer's weights. (On the
    scan unit's, whose std-1 gate weights make beta ill-conditioned, decode
    and prefill part by up to 0.31 at any bias: the prefill conv rounds its
    products op by op, the step sums them in f32, as in JAX.)"""
    _, _, tm, _ = bridged
    _, tl = _rec_params(bridged, "remainder")
    cb = np.sign(np.random.default_rng(6).standard_normal(64)).astype(np.float32) * 0.01
    tl = {**tl, "conv_b": torch.from_numpy(cb.copy())}
    _, xs = _x((2, 8, 64), "bf16", seed=5, scale=GATE_X_SCALE)
    state = trg.init_recurrent_state(tm.cfg, 2, "cpu")
    steps = [trg.recurrent_block_step(tl, xs[:, t : t + 1], state, tm.cfg)[0] for t in range(8)]
    _close(torch.cat(steps, dim=1), trg.recurrent_block(tl, xs, tm.cfg), "bf16")


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_recurrent_block_step_parity_and_state_in_place(bridged, where):
    jm, _, tm, _ = bridged
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 1, 64), "bf16")
    jc, tc = _x((2, 3, 64), "bf16", seed=4)
    jh0, th0 = _x((2, 64), "f32", seed=3)
    want, jstate = jax.jit(lambda p, x, s: jrg.recurrent_block_step(p, x, s, jm.cfg))(jl, jx, {"conv": jc, "h": jh0})
    state = {"conv": tc.clone(), "h": th0.clone()}
    conv_buf, h_buf = state["conv"], state["h"]
    got, out_state = trg.recurrent_block_step(tl, tx, state, tm.cfg)
    _close(got, want, "bf16")
    assert out_state["conv"] is conv_buf and out_state["h"] is h_buf  # written in place
    np.testing.assert_array_equal(_np(conv_buf), _np(jstate["conv"]))
    _close(h_buf, jstate["h"], "f32")


# ---------------------------------------------------------------------------
# configs, counts, bridge, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_by_field(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == dataclasses.asdict(jax_config(ARCH, smoke=smoke))


def test_n_params_matches_jax_full():
    cfg = get_config(ARCH)
    assert cfg.n_params() == JaxModel(jax_config(ARCH)).n_params
    assert 9.3e9 < cfg.n_params() < 9.5e9


def test_bridge_covers_every_jax_leaf(bridged):
    _, jp, _, tp = bridged
    jleaves = {jax.tree_util.keystr(p): np.shape(a) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert tleaves == jleaves
    assert tp["embed"]["table"].dtype == torch.bfloat16 and "lm_head" not in tp  # tied


def test_init_draws_the_jax_distributions():
    """Same std per leaf of at least 4096 values (smaller ones, lam among
    them, give too noisy a sample), and the specs' std for all of them."""
    from repro.models import modules as jmod

    cfg = get_config(ARCH, smoke=True)
    jm, tm = JaxModel(jax_config(ARCH, smoke=True)), Model(cfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = tm.init(torch.Generator().manual_seed(0))
    jstd = {jax.tree_util.keystr(p): float(np.std(a)) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    for p, a in jax.tree_util.tree_leaves_with_path(tp):
        key = jax.tree_util.keystr(p)
        if a.numel() >= 4096:
            assert float(a.float().std()) == pytest.approx(jstd[key], rel=0.1, abs=1e-6), key
    jspec = dict(jax.tree_util.tree_leaves_with_path(jm.spec(), is_leaf=lambda s: isinstance(s, jmod.ArraySpec)))
    for p, s in jax.tree_util.tree_leaves_with_path(tm.spec(), is_leaf=lambda s: isinstance(s, ArraySpec)):
        js = jspec[p]
        assert (s.shape, s.init, s.scale) == (js.shape, js.init, js.scale), jax.tree_util.keystr(p)
    assert tm.spec()["layers"]["remainder"]["layer3"]["rec"]["lru"]["lam"].std() == 0.8


# ---------------------------------------------------------------------------
# whole-model logits
# ---------------------------------------------------------------------------


def test_forward_logits_match_jax_kernel_path(bridged):
    """Measured 0.0039 against a logit RMS of 0.16; the JAX package's own gap
    between its kernel and XLA paths is 0.0049 on the same weights."""
    jm, jp, tm, tp = bridged
    toks = _tokens(tm.cfg.vocab, (2, 32))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, lb = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, tm.cfg.vocab) and float(lb) == 0.0
    assert np.isfinite(_np(got)).all()
    err = np.abs(_np(got) - _np(want)).max()
    assert err < FORWARD_TOL, err


@pytest.mark.parametrize("p_bf16", [1, 2])
def test_forward_logits_with_bf16_p_match_jax_kernel_path(bridged, monkeypatch, p_bf16):
    """The CPU attention feeding the softmax probabilities to the PV product
    as one bf16 term (the TPU matrix unit's default pass) or two (the wgmma
    kernel), ``attention_ref(p_bf16=...)``, against the JAX kernel path, which
    keeps them in f32 on the CPU: within the models' LOGIT_TOL."""
    monkeypatch.setattr(ref, "attention_ref", functools.partial(ref.attention_ref, p_bf16=p_bf16))
    jm, jp, tm, tp = bridged
    toks = _tokens(tm.cfg.vocab, (2, 32))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert np.isfinite(_np(got)).all()
    err = np.abs(_np(got) - _np(want)).max()
    assert err < LOGIT_TOL, err


def test_decode_logits_match_jax_over_12_steps(bridged):
    """12 steps, past the smoke window of 8: the windowed ring buffer, the conv
    window and h all carry across steps (measured: equal to JAX's)."""
    jm, jp, tm, tp = bridged
    toks = _tokens(tm.cfg.vocab, (2, 12), seed=1)
    jstate, tstate = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(12):
        want, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        errs.append(float(np.abs(_np(got) - _np(want)).max()))
    assert max(errs) < LOGIT_TOL, errs
    # the recurrent state was written in place, in the stacked units and the remainder layers
    for got, want in ((tstate["scan"]["block0"], jstate["scan"]["block0"]),
                      (tstate["remainder"]["layer4"], jstate["remainder"]["layer4"])):
        assert got["h"].abs().sum() > 0 and got["conv"].abs().sum() > 0
        np.testing.assert_allclose(_np(got["h"]), _np(want["h"]), **TOL["f32"])
        np.testing.assert_allclose(_np(got["conv"]), _np(want["conv"]), **TOL["bf16"])


@pytest.fixture(scope="module")
def jax_jitted(bridged):
    """The JAX model's forward and decode step, compiled once for the module."""
    jm = bridged[0]
    return jax.jit(jm.forward), jax.jit(jm.decode_step)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_decode_matches_port_prefill(bridged, jax_jitted, seed):
    """12 tokens, past the window. Decode and prefill differ by the
    reference's own gap: prefill keeps the softmax probabilities in f32, runs
    the scan and rounds the conv op by op; decode rounds the probabilities to
    bf16, steps h and sums the conv window in f32. The port's gap, step by
    step, is the JAX package's on its kernel path for the same tokens, within
    the prefill parity bound (measured, largest over the steps for seeds 0, 1
    and 2: JAX 0.047, 0.041, 0.084; the port 0.047, 0.041, 0.079)."""
    jm, jp, tm, tp = bridged
    jforward, jstep = jax_jitted
    toks = _tokens(tm.cfg.vocab, (1, 12), seed=seed)
    jfwd, _ = jforward(jp, {"tokens": jnp.asarray(toks)})
    tfwd, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    jstate, tstate = jm.init_decode_state(1, 16), tm.init_decode_state(1, 16)
    jgap, tgap = [], []
    for t in range(12):
        want, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        jgap.append(float(np.abs(_np(want)[0] - _np(jfwd)[0, t]).max()))
        tgap.append(float(np.abs(_np(got)[0] - _np(tfwd)[0, t]).max()))
    np.testing.assert_allclose(tgap, jgap, rtol=0, atol=FORWARD_TOL)
