"""The xLSTM slice (xlstm-125m) on the CPU against the JAX package: the ported
``xlstm.py`` cells (mLSTM chunkwise and its decode step, sLSTM and its step)
at smoke width and at a narrow width with several chunks and a carried
state, the smoke model's prefill and decode logits, its loss and gradients,
the batched server, and the masked exponent of the mLSTM's intra-chunk
weights, where the reference's gradient is NaN and the port's is not. The
JAX functions run jitted, as the JAX package compiles them; the weights pass
between the packages through ``params_from_numpy``, inputs come from numpy
seeds.

The stacked unit of the smoke config has one unit, so its matrices are drawn
at std 1 (fan_in = n_units = 1, ROADMAP "Reference behaviours"). The mLSTM
then runs with capped input gates (exp(15)) and normalizers far from 1, and
is ill-conditioned in the reference itself: the JAX cell's bf16 gradient
lies 2.4-5.8 % (relative L2) from the same cell run in f32, and the JAX
model's prefill logits move by 0.10-3.46 when its blocks are jitted one by
one instead of as one program. The port follows the compiled program's
roundings (its op-by-op bf16 sigmoid, the f32 residual sum handed to the
next block's norm): at the init its logits read 0.0-0.0078 from the jitted
JAX forward and its decode 0.0. Its gradients read 0.016-0.030 per leaf at
the init (three weight seeds; a 1e-6 nudge of JAX's norm scales moves JAX's
own by 0.0015-0.028), 0.010-0.042 with each stacked matrix at the std of its
unstacked spec (``modules.at_unstacked_std``), where the model's gradient
test runs; each cell's within 0.0034 of the jitted JAX cell's at the init.
"""

import dataclasses
import functools
import inspect
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.serve import BatchedServer as JaxServer  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa: E402
from repro.models.modules import stack_specs as jax_stack_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.modules import at_unstacked_std, tree_map_with_path  # noqa: E402
from repro_torch.models.transformer import _unit  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

ARCH = "xlstm-125m"
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_kernels.py
LOGIT_TOL = 0.05  # tests/test_smoke_archs.py's decode/prefill bound
GAP_TOL = 0.01  # the port's decode-vs-prefill gap against JAX's, step by step
LOSS_TOL = 1e-4
GRAD_REL = 0.02  # per-leaf relative L2 against jax.grad, a cell alone
# The whole smoke model's gradients against jax.grad of the jitted loss, per
# leaf: tests/test_torch_train.py's GRAD_REL_F32_ATTENTION, for the same
# cause. XLA's algebraic simplifier reorders the f32 arithmetic of the
# fused backward (e.g. RMSNorm's constants), which flips the bf16 rounding
# of a cotangent entry now and then, and the mLSTM's normalizer amplifies
# it. The port is within 3e-4 of the JAX cell's gradient run op by op
# (``jax.disable_jit``); against the jitted cell it reads 0.0-0.0034
# (GRAD_REL), the model 0.010-0.042 over weight seeds 0-2.
GRAD_REL_MODEL = 0.05
# (name, d_model, n_heads, chunk, S, scaled): the smoke config's widths and
# chunk at the reference init, and a narrow width whose sequence spans four
# chunks, its stacked matrices at their unstacked spec's std (``scaled``):
# at std 1 its outputs reach ~12, where one bf16 step of h (0.0156 at 3)
# moves a sum of 24 products by 0.07, past the bf16 atol
WIDTHS = [("smoke", 32, 2, 8, 16, False), ("narrow", 24, 3, 4, 16, True)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(a, dtype=torch.bfloat16):
    """JAX array -> torch tensor with the same values."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _bf16_close(got, want):
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bf16"])


def _state_close(got: dict, want: dict):
    """Each f32 state leaf within 2e-5 relative to its largest entry. The
    mLSTM's C and n sum products whose gates reach exp(15) ~ 3e6, so their
    small entries carry an absolute error of the order of the terms' f32
    rounding (measured 1.3e-6 of the largest entry); the sLSTM's states are
    held the same way."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert got[k].dtype == torch.float32 and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL["f32"]["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=k)


def _cell(kind: str, width: str, seed: int = 0):
    """(JAX cfg, JAX cell params as the scan casts them, port cfg, port cell
    params) for one cell of ``kind`` at ``width``, the unit's first of its
    kind, from the JAX package's init of the config's stack."""
    _, d, H, chunk, _, scaled = next(w for w in WIDTHS if w[0] == width)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), d_model=d, n_heads=H, n_kv_heads=H, chunk=chunk)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), d_model=d, n_heads=H, n_kv_heads=H, chunk=chunk)
    block = f"block{cfg.pattern.index(kind)}"
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(seed)))
    if scaled:
        tree = at_unstacked_std(tree)
    tp = params_from_numpy(tree, cfg, "cpu")
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]).astype(jnp.bfloat16) if a.ndim >= 3 else jnp.asarray(a[0]),
                      tree["layers"]["scan"][block])
    return jcfg, jl[kind], cfg, _unit(tp["layers"]["scan"], 0)[block][kind]


def _x(B, S, d, seed=1):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal((B, S, d)), jnp.bfloat16)
    return j, _t(j)


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_state(jstate: dict) -> dict:
    return {k: _t(v, torch.float32) for k, v in jstate.items()}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("width", [w[0] for w in WIDTHS])
def test_cell_matches_jax(kind, width):
    """The prefill cell from the zero state and, for a second sequence, from
    the state the first left (the carried state): y within bf16 tolerance,
    the f32 state within f32 tolerance of its scale."""
    jcfg, jl, cfg, tl = _cell(kind, width)
    S = next(w[4] for w in WIDTHS if w[0] == width)
    jf = jax.jit(functools.partial(getattr(jx, kind), cfg=jcfg))
    state_j, state_t = None, None
    for seed in (1, 2):
        jxs, txs = _x(2, S, cfg.d_model, seed)
        want, state_j = jf(jl, jxs, state=state_j)
        got, state_t = getattr(tx, kind)(tl, txs, cfg, state=state_t)
        _bf16_close(got, want)
        _state_close(state_t, state_j)
        state_t = _port_state(state_j)  # the next sequence starts from JAX's state on both sides


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("width", [w[0] for w in WIDTHS])
def test_cell_step_matches_jax(kind, width):
    """Six decode steps from the state a prefill of 8 tokens left: y and the
    state after every step; the port's state is written in place."""
    jcfg, jl, cfg, tl = _cell(kind, width)
    jxs, _ = _x(2, 8, cfg.d_model, 3)
    _, jstate = jax.jit(functools.partial(getattr(jx, kind), cfg=jcfg))(jl, jxs)
    tstate = _port_state(jstate)
    held = dict(tstate)
    jstep = jax.jit(functools.partial(getattr(jx, f"{kind}_step"), cfg=jcfg))
    for t in range(6):
        jxt, txt = _x(2, 1, cfg.d_model, 10 + t)
        want, jstate = jstep(jl, jxt, jstate)
        got, out = getattr(tx, f"{kind}_step")(tl, txt, tstate, cfg)
        assert out is tstate and all(tstate[k] is held[k] for k in held)
        _bf16_close(got, want)
        _state_close(tstate, jstate)


def test_mlstm_asserts_whole_chunks():
    _, _, cfg, tl = _cell("mlstm", "smoke")
    with pytest.raises(AssertionError, match="divisible by chunk"):
        tx.mlstm(tl, torch.zeros((1, 12, cfg.d_model), dtype=torch.bfloat16), cfg)


def _grads_by_leaf(leaves: dict, x: torch.Tensor) -> dict:
    got = {jax.tree_util.keystr(p): _np(a.grad) for p, a in jax.tree_util.tree_leaves_with_path(leaves)}
    return {**got, "x": _np(x.grad)}


def _jax_grads_by_leaf(fn, jcfg, jl, jxs, ct, *, jit: bool) -> dict:
    """d(sum(y * ct)) of the JAX cell ``fn`` by its weights and input: jitted
    as the JAX package compiles it, or op by op (``jax.disable_jit``)."""
    f = jax.grad(lambda p, x: jnp.sum(fn(p, x, jcfg)[0].astype(jnp.float32) * ct), argnums=(0, 1))
    if jit:
        g, gx = jax.jit(f)(jl, jxs)
    else:
        with jax.disable_jit():
            g, gx = f(jl, jxs)
    return {**{jax.tree_util.keystr(p): _np(a) for p, a in jax.tree_util.tree_leaves_with_path(g)}, "x": _np(gx)}


def _port_grads_by_leaf(fn, cfg, tl, txs, ct) -> dict:
    leaves = tree_map_with_path(lambda _, a: a.detach().clone().requires_grad_(), tl)
    x = txs.clone().requires_grad_()
    y, _ = fn(leaves, x, cfg)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return _grads_by_leaf(leaves, x), y


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_gradients_match_jax_at_the_init(kind):
    """d(sum(y * ct)) by the cell's weights and input at the reference init
    (std-1 stacked matrices): per leaf within GRAD_REL of jax.grad of the
    jitted cell (measured 0.0019-0.0034 for the mLSTM, 0.0 for the sLSTM)
    and within 1e-3 of the JAX cell's run op by op (the mLSTM's f32 chunk
    sums in another order: measured 0.0003 for wi, 2e-5 or 0 elsewhere; the
    sLSTM 0.0)."""
    jcfg, jl, cfg, tl = _cell(kind, "smoke")
    jxs, txs = _x(2, 16, cfg.d_model, 0)
    ct = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    got, _ = _port_grads_by_leaf(getattr(tx, kind), cfg, tl, txs, ct)
    jitted = _jax_grads_by_leaf(getattr(jx, kind), jcfg, jl, jxs, ct, jit=True)
    rel = {k: _rel_l2(got[k], w) for k, w in jitted.items()}
    assert max(rel.values()) < GRAD_REL, rel
    op_by_op = _jax_grads_by_leaf(getattr(jx, kind), jcfg, jl, jxs, ct, jit=False)
    rel = {k: _rel_l2(got[k], w) for k, w in op_by_op.items()}
    assert max(rel.values()) < 1e-3, rel


# ---------------------------------------------------------------------------
# the masked exponent of the intra-chunk weights
# ---------------------------------------------------------------------------


def _masked_jax_mlstm():
    """The JAX package's ``mlstm`` with one line changed, in this test only:
    the intra-chunk weights masked before ``exp``, as the port builds them."""
    old = "w = jnp.where(mask[None, :, :, None], jnp.exp(Eij), 0.0)"
    new = "w = jnp.exp(jnp.where(mask[None, :, :, None], Eij, -jnp.inf))"
    src = inspect.getsource(jx.mlstm)
    assert src.count(old) == 1
    namespace = dict(vars(jx))
    exec(textwrap.dedent(src.replace(old, new)), namespace)
    return namespace["mlstm"]


def _full_width_mlstm_layer():
    """One mLSTM layer of xlstm-125m at full width (d 768, 4 heads of 192,
    chunk 256), drawn as the JAX package draws the stacked unit of 3 (std
    1/sqrt(3)) from PRNGKey(0) and cast to bf16 as its scan casts it."""
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    spec = jax_stack_specs(jx.mlstm_spec(jcfg), 3)
    stacked = jax.tree.map(np.asarray, jax_init_params(spec, jax.random.key(0)))
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]).astype(jnp.bfloat16) if a.ndim >= 3 else jnp.asarray(a[0]),
                      stacked)
    tl = tree_map_with_path(lambda _, a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
                            .to(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), jl)
    return jcfg, jl, cfg, tl


def test_masked_exponent_gradient_is_finite_where_the_reference_is_nan():
    """At xlstm-125m's full width, one mLSTM layer at B 1 x S 256 (one whole
    chunk): above the diagonal E_ij = cumf_i - cumf_j + li_j reaches ~120
    (min cumf -106 at PRNGKey(0)), beyond exp's f32 range. The JAX package's
    ``where(mask, exp(E), 0)`` gives the right forward, but its gradient is
    0 * inf = NaN for wi and wf (documenting the reference). The port's is
    finite, and within GRAD_REL per leaf of the JAX function that masks
    before exp, run op by op (measured 0.0005-0.0053). A port that kept
    ``where(mask, exp(E), 0)`` would be NaN here too.

    The cell is ill-conditioned at these gates (normalizers of ~e^15): the
    jitted masked function parts from its own op-by-op run by 0.006-0.073
    per leaf (XLA reorders the fused backward's f32 arithmetic), and the
    JAX package's jitted and op-by-op forwards by 0.0056 relative L2 (1.28
    in one entry of a y that reaches 51). So the outputs too are held at a
    relative L2 error, the port's against both JAX functions, jitted."""
    jcfg, jl, cfg, tl = _full_width_mlstm_layer()
    jxs, txs = _x(1, 256, cfg.d_model, 4)
    ct = np.random.default_rng(5).standard_normal((1, 256, cfg.d_model)).astype(np.float32)
    reference = _jax_grads_by_leaf(jx.mlstm, jcfg, jl, jxs, ct, jit=True)
    assert not all(np.isfinite(reference[k]).all() for k in ("['wi']", "['wf']"))
    masked = _masked_jax_mlstm()
    got, y = _port_grads_by_leaf(tx.mlstm, cfg, tl, txs, ct)
    for fn in (jx.mlstm, masked):  # the same forward
        assert _rel_l2(_np(y), _np(jax.jit(functools.partial(fn, cfg=jcfg))(jl, jxs)[0])) < GRAD_REL
    assert all(np.isfinite(g).all() for g in got.values())
    want = _jax_grads_by_leaf(masked, jcfg, jl, jxs, ct, jit=False)
    rel = {k: _rel_l2(got[k], w) for k, w in want.items()}
    assert max(rel.values()) < GRAD_REL, rel


# ---------------------------------------------------------------------------
# the smoke model: logits, decode, loss and gradients, the server
# ---------------------------------------------------------------------------


def _bridged(seed=0, scaled=False, train=False):
    """(JAX model, JAX params, port model, port params) sharing one set of
    weights; ``scaled``: each stacked matrix at its unstacked spec's std."""
    jm = JaxModel(jax_config(ARCH, smoke=True))
    cfg = get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    if scaled:
        tree = at_unstacked_std(tree)
    return jm, jax.tree.map(jnp.asarray, tree), Model(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu",
                                                                                             train=train)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_logits_match_jax(seed):
    """Measured 0.0, 0.0078, 0.0 over weight seeds 0-2 (the reference init)."""
    jm, jp, tm, tp = _bridged(seed)
    toks = _tokens(tm.cfg.vocab, (2, 32), seed)
    want, jlb = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, lb = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, tm.cfg.vocab) and float(lb) == float(jlb) == 0.0
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err < LOGIT_TOL, err


def test_decode_logits_match_jax_over_8_steps():
    """Measured 0.0 at every step."""
    jm, jp, tm, tp = _bridged()
    toks = _tokens(tm.cfg.vocab, (2, 8), seed=1)
    jstate, tstate = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(8):
        want, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        errs.append(float(np.abs(_np(got) - _np(want)).max()))
    assert max(errs) < LOGIT_TOL, errs


def test_port_decode_vs_prefill_gap_equals_jax_gap():
    """The decode-vs-prefill gap over 12 tokens (past the smoke chunk of 8),
    the port's against JAX's, step by step within GAP_TOL; both below
    tests/test_smoke_archs.py's 0.05. Measured: both 0.0 over the first
    chunk, and equal after it."""
    jm, jp, tm, tp = _bridged()
    T = 16  # the forward needs whole chunks; decode runs 12 of them
    toks = _tokens(tm.cfg.vocab, (1, T), seed=2)
    jfwd, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tfwd, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    jstate, tstate = jm.init_decode_state(1, 32), tm.init_decode_state(1, 32)
    jstep = jax.jit(jm.decode_step)
    jgap, tgap = [], []
    for t in range(12):
        jl, jstate = jstep(jp, {"tokens": jnp.asarray(toks[:, t : t + 1])}, jstate, jnp.int32(t))
        tl, tstate = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t : t + 1])}, tstate, t)
        jgap.append(float(np.abs(_np(jl)[0] - _np(jfwd)[0, t]).max()))
        tgap.append(float(np.abs(_np(tl)[0] - _np(tfwd)[0, t]).max()))
    assert max(abs(a - b) for a, b in zip(tgap, jgap)) < GAP_TOL, (tgap, jgap)
    assert max(tgap) < LOGIT_TOL, tgap


def _batch(vocab, B=2, S=16, seed=0):
    toks = _tokens(vocab, (B, S + 1), seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _loss_close(got: float, want: float, tm, tp, jm, jp, batch: dict):
    """|got - want| within LOSS_TOL beyond what the two sides' logits move
    it. A token's cross entropy moves by at most twice the largest change
    of its logits, so the loss by at most twice the mask's mean of it (the
    z-loss by a thousandth of that). An f32 summation order of the port's
    that differs from XLA's flips the bf16 rounding of a residual entry now
    and then (one of 1,024 at weight seeds 0 and 2 here): that moves a logit
    by one bf16 step (0.0039) and the loss by up to 1.4e-4 at 29 tokens. The
    logits themselves are held to LOGIT_TOL."""
    toks = batch["tokens"]
    dlogit = np.abs(_np(tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0])
                    - _np(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})[0])).max(-1)
    assert dlogit.max() < LOGIT_TOL, dlogit.max()
    mask = batch["loss_mask"]
    assert abs(got - want) < LOSS_TOL + 2.002 * (dlogit * mask).sum() / mask.sum(), (got, want, dlogit.max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_matches_jax(seed):
    """At the reference init: measured 1.4e-4, 0.0, 0.0 (logits 0.0039, 0,
    0) over weight seeds 0-2."""
    jm, jp, tm, tp = _bridged(seed, train=True)
    b = _batch(tm.cfg.vocab, seed=seed)
    want, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    got, aux = tm.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(aux["lb_loss"]) == 0.0
    _loss_close(float(got), float(want), tm, tp, jm, jp, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grads_match_jax(seed):
    """Each leaf's gradient within GRAD_REL_MODEL of jax.value_and_grad of
    the jitted loss, with each stacked matrix at its unstacked spec's std
    (the module docstring says why): measured 0.010, 0.015, 0.042 over
    weight seeds 0-2 (0.016-0.030 at the reference init)."""
    jm, jp, tm, tp = _bridged(seed, scaled=True, train=True)
    b = _batch(tm.cfg.vocab, seed=seed)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    grads = tree_map_with_path(lambda _, p: torch.zeros_like(p), tp)
    loss, _ = tm.loss(tm.grad_leaves(tp, grads), {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    _loss_close(float(loss.detach()), float(jl), tm, tp, jm, jp, b)
    want = {jax.tree_util.keystr(p): _np(a) for p, a in jax.tree_util.tree_leaves_with_path(jg)}
    got = {jax.tree_util.keystr(p): _np(a) for p, a in jax.tree_util.tree_leaves_with_path(grads)}
    assert got.keys() == want.keys()
    rel = {k: _rel_l2(got[k], w) for k, w in want.items()}
    assert all(np.isfinite(g).all() for g in got.values())
    assert max(rel.values()) < GRAD_REL_MODEL, max(rel.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(remat):
    """The unit under checkpoint recomputes the sLSTM's time loop and the
    mLSTM's chunks (each chunk under its own checkpoint too) in the backward
    pass: the gradients equal those without remat to the bit."""
    cfg = get_config(ARCH, smoke=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    out = {}
    for mode in ("none", remat):
        model = Model(dataclasses.replace(cfg, remat=mode), device="cpu")
        grads = tree_map_with_path(lambda _, p: torch.zeros_like(p), params)
        model.loss(model.grad_leaves(params, grads), b)[0].backward()
        out[mode] = grads
    for (p, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(out[remat]),
                              jax.tree_util.tree_leaves_with_path(out["none"])):
        assert torch.equal(g, w), jax.tree_util.keystr(p)


def test_decode_state_is_the_jax_layout():
    """Stacked per unit, f32: C (n_units, B, H, hd, hd) and n for the mLSTM
    blocks, h, c, n, m for the sLSTM block, as the JAX package's stack_state."""
    jm, _, tm, _ = _bridged()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jm.init_decode_state(3, 16))
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")), tm.init_decode_state(3, 16))
    assert got == want


def test_server_tokens_equal_the_jax_server():
    """xlstm-125m smoke through 3 slots, the JAX server beside it on the same
    weights: reused slots keep the previous occupant's cell states, as in the
    JAX server, and the greedy tokens agree."""
    jserver = JaxServer(JaxModel(jax_config(ARCH, smoke=True)), batch=3, max_len=64)
    cfg = get_config(ARCH, smoke=True)
    server = BatchedServer(Model(cfg, device="cpu"), batch=3, max_len=64)
    server.params = params_from_numpy(jax.tree.map(np.asarray, jserver.params), cfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 4).astype(np.int32) for _ in range(6)]
    reqs = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    stats, jstats = server.run(reqs), jserver.run(jreqs)
    assert stats["requests_done"] == 6 and stats["decode_steps"] == jstats["decode_steps"]
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert server.state["scan"]["block1"]["C"].abs().sum() > 0
