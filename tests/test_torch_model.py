"""The port's model against the JAX package on the CPU: configs, parameter
counts, the weight bridge, module-level parity, and logits of the prefill
forward and of decode, with the JAX model run on its kernel path
(``attention_impl="pallas_interpret"``).

For the MoE archs a token whose k-th and (k+1)-th router probabilities lie
closer than the two sides' rounding may take another expert on one side (a
route flip), which moves its output by O(1). The logit tests count the MoE
calls' differing routes and print them with the smallest top-k margin; the
logits are held where the routes agree, and the layers are also compared one
by one from the JAX layer's input (``test_moe_layers_match_jax_layer_by_layer``)."""

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
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
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


def test_registry_lists_the_seven_ported_archs():
    """The dense slice, the hybrid, the MoE slice, the xLSTM and the two
    embeddings-input families: all ten of the JAX package's archs (seven
    until the xLSTM and embeddings slice)."""
    from repro.configs import list_archs as jax_archs

    assert list_archs() == sorted(DENSE + HYBRID + MOE + ["xlstm-125m", "qwen2-vl-2b", "musicgen-medium"])
    assert list_archs() == jax_archs()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_config_matches_jax_field_by_field(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == dataclasses.asdict(jax_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_n_params_matches_jax_full(arch):
    cfg = get_config(arch)
    jm = JaxModel(jax_config(arch))
    assert cfg.n_params() == jm.n_params
    assert cfg.n_active_params() == jm.n_active_params
    if arch == "qwen3-4b":
        assert cfg.n_params() == cfg.n_active_params() == 4_411_424_256
    if arch == "deepseek-moe-16b":
        assert (cfg.n_params(), cfg.n_active_params()) == (16_375_728_128, 2_828_650_496)
    if arch == "qwen3-moe-235b-a22b":
        assert (cfg.n_params(), cfg.n_active_params()) == (235_093_634_560, 22_190_763_520)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"] + MOE)
def test_bridge_covers_every_jax_leaf(arch):
    _, jp, _, tp = _bridged(arch)
    jleaves = {jax.tree_util.keystr(p): np.shape(a) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert tleaves == jleaves
    # bf16 only where the JAX package casts before every use; norm scales stay f32
    scan = tp["layers"]["scan"]["block0"]
    assert scan["attn"]["wq"].dtype == torch.bfloat16 and scan["norm1"]["scale"].dtype == torch.float32
    if arch in MOE:
        # the stacked router (n_units, d, E) is cast before the scan as well
        assert all(scan["moe"][k].dtype == torch.bfloat16 for k in ("wi", "wg", "wo"))
        assert scan["moe"]["router"]["w"].dtype == torch.bfloat16
        if arch == "deepseek-moe-16b":  # the dense prefix layer keeps f32; the shared experts are stacked
            assert scan["moe"]["shared"]["wo"].dtype == torch.bfloat16
            assert tp["layers"]["prefix"]["layer0"]["mlp"]["wi"].dtype == torch.float32
    else:
        assert scan["mlp"]["wo"].dtype == torch.bfloat16
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


def _port_routes(monkeypatch) -> list:
    """Record each call of the port's MoE router from now on: (the top K+1
    probabilities, their expert ids) per call, in call order."""
    from repro_torch.models import moe as tmoe

    calls, route = [], tmoe.route

    def recording(params, xt, cfg):
        out = route(params, xt, cfg)
        top = torch.topk(out[0], cfg.top_k + 1, dim=-1)
        calls.append((top.values.numpy(), out[2].numpy()))
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    return calls


def _jax_routes(monkeypatch) -> list:
    """As ``_port_routes``, for the JAX package's MoE under ``jax.jit``: its
    router's top K+1 reported through ``jax.debug.callback`` (a separate
    compiled run; the logits compared come from one without it)."""
    import repro.models.transformer as jtfm

    calls, moe = [], jtfm.moe

    def recording(params, h, cfg, **kw):
        xt = h.reshape(-1, h.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), params["router"]["w"]), axis=-1)
        vals, ids = jax.lax.top_k(probs, cfg.top_k + 1)
        jax.debug.callback(lambda v, i: calls.append((np.asarray(v), np.asarray(i)[:, :-1])), vals, ids,
                           ordered=True)
        return moe(params, h, cfg, **kw)

    monkeypatch.setattr(jtfm, "moe", recording)
    return calls


def _route_flips(port_calls, jax_calls) -> tuple[int, float]:
    """-> (tokens whose set of K experts differs between the two sides over
    all MoE calls, the smallest JAX top-k margin p_k - p_{k+1})."""
    assert len(port_calls) == len(jax_calls) > 0
    flips = sum(int((np.sort(pi, -1) != np.sort(ji, -1)).any(-1).sum())
                for (_, pi), (_, ji) in zip(port_calls, jax_calls))
    margin = min(float((v[:, -2] - v[:, -1]).min()) for v, _ in jax_calls)
    return flips, margin


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"] + MOE)
def test_forward_logits_match_jax_kernel_path(arch, monkeypatch):
    jm, jp, tm, tp = _bridged(arch)
    toks = _tokens(tm.cfg.vocab, (2, 32))
    want, jlb = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, lb = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, tm.cfg.vocab)
    assert float(lb) == pytest.approx(float(jlb), rel=1e-5) and (float(lb) > 0) == (arch in MOE)
    assert np.isfinite(_np(got)).all()
    err = np.abs(_np(got) - _np(want)).max()
    if arch in MOE:
        jax_calls, port_calls = _jax_routes(monkeypatch), _port_routes(monkeypatch)
        jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
        tm.forward(tp, {"tokens": torch.from_numpy(toks)})
        flips, margin = _route_flips(port_calls, jax_calls)
        print(f"{arch}: {flips} differing routes over {len(port_calls)} MoE layers, "
              f"smallest top-k margin {margin:.3g}, logit error {err:.3g}")
        assert flips == 0, f"a route flip: compare layer by layer (test_moe_layers_match_jax_layer_by_layer); {err}"
    assert err < LOGIT_TOL, err


@pytest.mark.parametrize("arch", MOE)
def test_moe_layers_match_jax_layer_by_layer(arch):
    """Each layer of the port takes the JAX layer's input (jitted
    ``block_apply`` on the unit's weights cast to bf16 as the scan casts
    them): its output within bf16 tolerance of JAX's and its load-balance
    loss within 1e-5 relative, so a route flip in one layer cannot hide
    another layer's fault. The routes of each layer come from the same input
    on both sides."""
    from repro.models import transformer as jtfm
    from repro.models.modules import embed as jembed
    from repro_torch.models import transformer as tfm

    jm, jp, tm, tp = _bridged(arch)
    cfg, jcfg = tm.cfg, jm.cfg
    toks = _tokens(cfg.vocab, (2, 32))
    jpos, tpos = _positions(2, 32)
    x = jax.jit(jembed)(jp["embed"], jnp.asarray(toks)).astype(jnp.bfloat16)
    lay = tfm.StackLayout(cfg)
    layers = [(jp["layers"]["prefix"][f"layer{i}"], tp["layers"]["prefix"][f"layer{i}"], i) for i in lay.prefix]
    jscan = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 3 else a, jp["layers"]["scan"])
    layers += [(jax.tree.map(lambda a, u=u: a[u], jscan)["block0"], tfm._unit(tp["layers"]["scan"], u)["block0"],
                cfg.first_dense + u) for u in range(lay.n_units)]
    assert len(layers) == cfg.n_layers
    for jl, tl, i in layers:
        kind, ffn = tfm.layer_kind(cfg, i), tfm._ffn_kind(cfg, i)
        block = jax.jit(functools.partial(jtfm.block_apply, cfg=jcfg, kind=kind, ffn=ffn, scope=f"layer{i}"))
        want, jlb = block(jl, x, positions=jpos)
        got, _, lb = tfm.block_apply(tl, _t(x), cfg, kind, ffn, tpos)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2, err_msg=f"layer {i}")
        if ffn == "moe":
            assert float(lb) == pytest.approx(float(jlb), rel=1e-5), i
        else:
            assert lb is None and float(jlb) == 0.0
        x = want


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"] + MOE)
def test_decode_logits_match_jax_over_8_steps(arch, monkeypatch):
    """For the MoE archs every step routes its B = 2 tokens as one batch
    (capacity 8: nothing drops); the routes of all steps are counted."""
    jm, jp, tm, tp = _bridged(arch)
    toks = _tokens(tm.cfg.vocab, (2, 8), seed=1)
    jstate, tstate = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16)
    if arch in MOE:
        jax_calls, port_calls = _jax_routes(monkeypatch), _port_routes(monkeypatch)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(8):
        want, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        errs.append(float(np.abs(_np(got) - _np(want)).max()))
    if arch in MOE:
        jax.effects_barrier()
        flips, margin = _route_flips(port_calls, jax_calls)
        print(f"{arch}: {flips} differing routes over {len(port_calls)} MoE calls, smallest top-k margin {margin:.3g}, "
              f"logit errors {errs}")
        assert flips == 0, f"a route flip: compare layer by layer (test_moe_layers_match_jax_layer_by_layer); {errs}"
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
    """Every layer kind of the JAX package is ported; a kind it does not
    have still raises, as the JAX package's ``block_spec`` does."""
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), pattern=("ssm", "attn"))
    with pytest.raises(ValueError, match="unknown layer kind ssm"):
        Model(cfg, device="cpu").spec()
    with pytest.raises(ValueError, match="unknown layer kind ssm"):
        Model(cfg, device="cpu").init_decode_state(1, 8)
