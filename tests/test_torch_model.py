"""The port's model against the JAX package on the CPU: configs, parameter
counts, the weight bridge, module-level parity, and logits of the prefill
forward and of decode, with the JAX model run on its kernel path
(``attention_impl="pallas_interpret"``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

DENSE = ["qwen3-4b", "gemma-2b", "llama3.2-3b", "granite-3-8b"]
HYBRID = ["recurrentgemma-9b"]
LOGIT_TOL = 0.05  # tests/test_smoke_archs.py's decode/prefill bound


def _jax_cfg(arch):
    return dataclasses.replace(jax_config(arch, smoke=True), attention_impl="pallas_interpret")


def _bridged(arch, seed=0):
    """(JAX model, JAX params, port model, port params) sharing one set of weights."""
    jm = JaxModel(_jax_cfg(arch))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(arch, smoke=True)
    return jm, jp, Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(a, dtype=torch.bfloat16):
    """JAX array -> torch tensor with the same values."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


# ---------------------------------------------------------------------------
# configs, counts, bridge
# ---------------------------------------------------------------------------


def test_registry_is_the_dense_slice():
    """The dense slice plus the hybrid one: the five registered archs."""
    assert list_archs() == sorted(DENSE + HYBRID)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_jax_field_by_field(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == dataclasses.asdict(jax_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", DENSE)
def test_n_params_matches_jax_full(arch):
    cfg = get_config(arch)
    assert cfg.n_params() == JaxModel(jax_config(arch)).n_params
    if arch == "qwen3-4b":
        assert cfg.n_params() == 4_411_424_256


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_bridge_covers_every_jax_leaf(arch):
    _, jp, _, tp = _bridged(arch)
    jleaves = {jax.tree_util.keystr(p): np.shape(a) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert tleaves == jleaves
    # bf16 only where the JAX package casts before every use; norm scales stay f32
    scan = tp["layers"]["scan"]["block0"]
    assert scan["attn"]["wq"].dtype == torch.bfloat16 and scan["mlp"]["wo"].dtype == torch.bfloat16
    assert scan["norm1"]["scale"].dtype == torch.float32
    if arch == "qwen3-4b":
        assert scan["attn"]["q_norm"]["scale"].dtype == torch.float32
        assert tp["lm_head"]["w"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16 and tp["final_norm"]["scale"].dtype == torch.float32


def test_bridge_rejects_a_wrong_tree():
    _, jp, _, _ = _bridged("qwen3-4b")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        params_from_numpy(tree, get_config("qwen3-4b", smoke=True), "cpu")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_init_draws_the_jax_distributions(arch):
    """Same std per leaf, including fan_in = n_layers for stacked weights."""
    cfg = get_config(arch, smoke=True)
    jp = JaxModel(jax_config(arch, smoke=True)).init(jax.random.key(0))
    tp = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jstd = {jax.tree_util.keystr(p): float(np.std(a)) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    for p, a in jax.tree_util.tree_leaves_with_path(tp):
        key = jax.tree_util.keystr(p)
        assert float(a.float().std()) == pytest.approx(jstd[key], rel=0.1, abs=1e-6), key
    assert jstd["['layers']['scan']['block0']['mlp']['wi']"] == pytest.approx(cfg.n_layers**-0.5, rel=0.05)


# ---------------------------------------------------------------------------
# module-level parity
# ---------------------------------------------------------------------------


def _layer0(arch):
    jm, jp, _, tp = _bridged(arch)
    from repro_torch.models.transformer import _unit

    jl = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16) if a.ndim >= 3 else a[0], jp["layers"]["scan"]["block0"])
    return jm.cfg, jl, get_config(arch, smoke=True), _unit(tp["layers"]["scan"], 0)["block0"]


def _x(shape, seed=1, scale=1.0):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale, jnp.bfloat16)
    return j, _t(j)


def _positions(B, S):
    p = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return jnp.asarray(p), torch.from_numpy(p)


@pytest.mark.parametrize("module", ["rms_norm", "apply_rope", "dense", "mlp", "attention", "decode_attention"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_module_parity(arch, module):
    from repro.models import attention as jatt
    from repro.models import mlp as jmlp
    from repro.models import modules as jmod
    from repro_torch.models import attention as tatt
    from repro_torch.models import mlp as tmlp
    from repro_torch.models import modules as tmod

    jcfg, jl, cfg, tl = _layer0(arch)
    B, S = 2, 16
    jx, tx = _x((B, S, cfg.d_model))
    jpos, tpos = _positions(B, S)
    tol = dict(rtol=2e-2, atol=2e-2)
    if module == "rms_norm":
        want, got = jmod.rms_norm(jl["norm1"], jx), tmod.rms_norm(tl["norm1"], tx)
    elif module == "apply_rope":
        jq, tq = _x((B, S, cfg.n_heads, cfg.head_dim))
        want, got = jmod.apply_rope(jq, jpos, cfg.rope_theta), tmod.apply_rope(tq, tpos, cfg.rope_theta)
    elif module == "dense":
        spec = "bsd,df->bsf"
        want, got = jmod.dense({"w": jl["mlp"]["wi"]}, jx, spec), tmod.dense({"w": tl["mlp"]["wi"]}, tx, spec)
    elif module == "mlp":
        want, got = jmlp.mlp(jl["mlp"], jx, act=cfg.act), tmlp.mlp(tl["mlp"], tx, act=cfg.act)
    elif module == "attention":
        want = jatt.attention(jl["attn"], jx, jcfg, jpos)
        got = tatt.attention(tl["attn"], tx, cfg, tpos)
        tol = dict(rtol=2e-2, atol=0.1)  # outputs reach ~1e2: a few bf16 ulps
    else:
        rng = np.random.default_rng(2)
        c = rng.standard_normal((2, B, 12, cfg.n_kv_heads, cfg.head_dim))
        jc = {"k": jnp.asarray(c[0], jnp.bfloat16), "v": jnp.asarray(c[1], jnp.bfloat16)}
        tc = {k: _t(v) for k, v in jc.items()}
        want, jc = jatt.decode_attention(jl["attn"], jx[:, :1], jc, 5, jcfg)
        got, tc = tatt.decode_attention(tl["attn"], tx[:, :1], tc, 5, cfg)
        np.testing.assert_array_equal(_np(tc["k"]), _np(jc["k"]))
        np.testing.assert_array_equal(_np(tc["v"]), _np(jc["v"]))
        tol = dict(rtol=2e-2, atol=0.1)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# whole-model logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_forward_logits_match_jax_kernel_path(arch):
    jm, jp, tm, tp = _bridged(arch)
    toks = _tokens(tm.cfg.vocab, (2, 32))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, lb = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, tm.cfg.vocab) and float(lb) == 0.0
    assert np.isfinite(_np(got)).all()
    err = np.abs(_np(got) - _np(want)).max()
    assert err < LOGIT_TOL, err


def _forward_err_with_bf16_p(arch, p_bf16, monkeypatch) -> float:
    """Max logit error of the port's smoke forward against the JAX kernel path
    (f32 P on the CPU) with the CPU attention feeding P to the PV product as
    ``p_bf16`` bf16 terms (``attention_ref(p_bf16=...)``)."""
    from repro_torch.kernels import ref

    monkeypatch.setattr(ref, "attention_ref", functools.partial(ref.attention_ref, p_bf16=p_bf16))
    jm, jp, tm, tp = _bridged(arch)
    toks = _tokens(tm.cfg.vocab, (2, 32))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert np.isfinite(_np(got)).all()
    return float(np.abs(_np(got) - _np(want)).max())


@pytest.mark.parametrize("arch,p_bf16", [("qwen3-4b", 2), ("gemma-2b", 2), ("gemma-2b", 1)])
def test_forward_logits_with_bf16_p_match_jax_kernel_path(arch, p_bf16, monkeypatch):
    """Two bf16 terms of P, as the wgmma kernel feeds them, keep both models
    within LOGIT_TOL; one term does at gemma-2b (measured 0.012)."""
    err = _forward_err_with_bf16_p(arch, p_bf16, monkeypatch)
    assert err < LOGIT_TOL, err


def test_one_bf16_term_of_p_misses_logit_tol_at_qwen3_4b(monkeypatch):
    """One bf16 term of P moves the qwen3-4b smoke logits 0.108 from the JAX
    kernel path (0.079-0.108 over token seeds 0-2, against 0.016-0.040 for
    f32 P): past LOGIT_TOL. This is why the wgmma kernel feeds P as two
    bf16 terms."""
    err = _forward_err_with_bf16_p("qwen3-4b", 1, monkeypatch)
    assert err > LOGIT_TOL, err


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_decode_logits_match_jax_over_8_steps(arch):
    jm, jp, tm, tp = _bridged(arch)
    toks = _tokens(tm.cfg.vocab, (2, 8), seed=1)
    jstate, tstate = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(8):
        want, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        errs.append(float(np.abs(_np(got) - _np(want)).max()))
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_port_decode_matches_port_prefill(arch):
    """The bound is 0.1, not test_smoke_archs.py's 0.05: prefill runs the
    flash kernel, which keeps the softmax probabilities in f32, while decode
    rounds them to bf16 as the JAX decode does. The JAX package's own
    decode/prefill gap on its kernel path is 0.060 at qwen3-4b smoke."""
    _, _, tm, tp = _bridged(arch)
    T = 8
    toks = _tokens(tm.cfg.vocab, (1, T), seed=2)
    fwd, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    state = tm.init_decode_state(1, 32)
    errs = []
    for t in range(T):
        logits, state = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, state, t)
        errs.append(float((logits[0] - fwd[0, t]).abs().max()))
    assert max(errs) < 0.1, errs


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-8b"])
def test_other_dense_configs_run_forward_and_decode(arch):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    logits, _ = m.forward(params, {"tokens": torch.from_numpy(_tokens(cfg.vocab, (2, 16)))})
    assert logits.shape == (2, 16, cfg.vocab) and torch.isfinite(logits.float()).all()
    state = m.init_decode_state(2, 8)
    step_logits, _ = m.decode_step(params, {"tokens": torch.zeros((2, 1), dtype=torch.int64)}, state, 0)
    assert step_logits.shape == (2, cfg.vocab) and torch.isfinite(step_logits.float()).all()


def test_unported_families_raise():
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), pattern=("slstm", "attn"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu").spec()
