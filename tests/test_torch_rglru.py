"""The hybrid slice on the CPU against the JAX package: the RG-LRU scan's
plain version against the Pallas kernel (interpret mode), the ported
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
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
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
    elif bad == "meta_device":
        a, b = a.to("meta"), b.to("meta")
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
    """Shifted multiply-adds rounded op by op, as the compiled JAX conv rounds them."""
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), "bf16")
    want = jax.jit(jrg.causal_conv1d)(jl, jx)
    got = trg.causal_conv1d(tl, tx)
    _close(got, want, "bf16")
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_causal_conv1d_step_parity(bridged, where):
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 1, 64), "bf16")
    jc, tc = _x((2, 3, 64), "bf16", seed=4)
    jy, jstate = jax.jit(jrg.causal_conv1d_step)(jl, jx, jc)
    ty, tstate = trg.causal_conv1d_step(tl, tx, tc)
    _close(ty, jy, "bf16")
    np.testing.assert_array_equal(_np(tstate), _np(jstate))


@pytest.mark.parametrize("where", ["scan", "remainder"])
def test_recurrent_block_parity(bridged, where):
    jm, _, tm, _ = bridged
    jl, tl = _rec_params(bridged, where)
    jx, tx = _x((2, 16, 64), "bf16")
    want = jax.jit(lambda p, x: jrg.recurrent_block(p, x, jm.cfg))(jl, jx)
    _close(trg.recurrent_block(tl, tx, tm.cfg), want, "bf16")


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
