"""The port's MoE module against the JAX package's ``models/moe.py`` on the
CPU, at the smoke configs of both MoE archs: routes, gate weights, the
load-balance statistics, the output and its gradient. The JAX function is
jitted: compiled, XLA rounds some steps otherwise than the eager ops do (the
combine's adds, the fractions' division), and the port follows the compiled
function. The weights are one layer of the stacked units, cast to bf16 as
the JAX package's scan casts them (the router included); the inputs come
from numpy with a seed."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import _unit  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
F32 = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's tolerances
BF16 = dict(rtol=2e-2, atol=2e-2)
LB_REL = 1e-5
# tests/test_torch_train.py's bound for the port's gradients against
# jax.value_and_grad where both sides compute the same arithmetic in another
# order (there: with f32 attention)
GRAD_REL_F32_ATTENTION = 0.05
# (B, S, capacity_factor): a prefill-sized batch, one that drops (capacity
# 0.5 of the mean load), and a decode step (T = B tokens, C = 8)
CASES = {"prefill": (2, 16, None), "forced_drop": (2, 16, 0.5), "decode": (4, 1, None)}


def _layer(arch, capacity_factor=None, **changes):
    """(JAX cfg, JAX layer params, port cfg, port layer params): the MoE of
    unit 0 of a bridged smoke model, as each package's stack hands it over."""
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    jp = JaxModel(jax_config(arch, smoke=True)).init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config(arch, smoke=True), "cpu")
    jl = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16) if a.ndim >= 3 else a[0], jp["layers"]["scan"]["block0"])
    return jcfg, jl["moe"], cfg, _unit(tp["layers"]["scan"], 0)["block0"]["moe"]


def _x(B, S, D, seed=1):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal((B, S, D)), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jax_moe(jcfg):
    return jax.jit(lambda p, x: jmoe.moe(p, x, jcfg))


def _jax_route(jcfg):
    """The JAX package's router (``moe.py`` lines 66-71), jitted."""

    def route(p, x):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"]["w"]), axis=-1)
        w, ids = jax.lax.top_k(probs, jcfg.top_k)
        return probs, w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9), ids

    return jax.jit(route)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, case):
    B, S, cf = CASES[case]
    jcfg, jl, cfg, tl = _layer(arch, cf)
    jx, tx = _x(B, S, cfg.d_model)
    jprobs, jw, jids = _jax_route(jcfg)(jl, jx)
    tprobs, tw, tids = tmoe.route(tl, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_np(tprobs), _np(jprobs), **F32)
    np.testing.assert_allclose(_np(tw), _np(jw), **F32)

    want, jaux = _jax_moe(jcfg)(jl, jx)
    got, aux = tmoe.moe(tl, tx, cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    assert set(aux) == set(jaux) == {"lb_loss", "dropped_frac", "expert_frac"}
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]), rel=LB_REL)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_array_equal(_np(aux["expert_frac"]), _np(jaux["expert_frac"]))
    C = tmoe._capacity(B * S, cfg)
    assert C == jmoe._capacity(B * S, jcfg)
    if case == "forced_drop":
        assert float(aux["dropped_frac"]) > 0.05
    if case == "decode":
        assert C == 8 and abs(float(aux["dropped_frac"])) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_output_equals_the_compiled_jax_output(arch):
    """Not only within bf16 tolerance: every step rounds as XLA compiles it,
    so the outputs are equal to the bit (prefill and forced-drop batches)."""
    for cf in (None, 0.5):
        jcfg, jl, cfg, tl = _layer(arch, cf)
        jx, tx = _x(2, 16, cfg.d_model, seed=3)
        want, _ = _jax_moe(jcfg)(jl, jx)
        got, _ = tmoe.moe(tl, tx, cfg)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_picks_the_lowest_expert_ids(arch):
    """An all-zero router gives every expert the same probability: both
    packages take experts 0..K-1 for every token, each weighted 1/K."""
    jcfg, jl, cfg, tl = _layer(arch)
    jl = {**jl, "router": {"w": jnp.zeros_like(jl["router"]["w"])}}
    tl = {**tl, "router": {"w": torch.zeros_like(tl["router"]["w"])}}
    jx, tx = _x(2, 8, cfg.d_model)
    _, jw, jids = _jax_route(jcfg)(jl, jx)
    _, tw, tids = tmoe.route(tl, tx.reshape(-1, cfg.d_model), cfg)
    first = np.broadcast_to(np.arange(cfg.top_k), (16, cfg.top_k))
    np.testing.assert_array_equal(np.asarray(jids), first)
    np.testing.assert_array_equal(tids.numpy(), first)
    np.testing.assert_array_equal(_np(tw), np.full((16, cfg.top_k), 1 / cfg.top_k, np.float32))
    want, _ = _jax_moe(jcfg)(jl, jx)
    got, _ = tmoe.moe(tl, tx, cfg)
    np.testing.assert_array_equal(_np(got), _np(want))


# the combine's order, shown at top_k = 4: at the configs' top_k = 2 every
# order and rounding of a token's two outputs gives the same bits
COMBINES = {
    "ascending expert id, each add rounded to bf16": (lambda add: add, True),
    "descending expert id, each add rounded to bf16": (lambda add: lambda c: add(c.flip(1)), False),
    "one f32 sum, rounded once": (lambda add: lambda c: c.float().sum(1).to(c.dtype), False),
}


@pytest.mark.parametrize("combine", list(COMBINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_adds_in_ascending_expert_order_in_bf16(arch, combine, monkeypatch):
    """The compiled JAX scatter-add adds a token's K outputs in slot order
    (ascending expert id), rounding each add to bf16: the port's
    ``_add_in_order`` equals it to the bit, and the other orders and
    roundings part from it."""
    make, equal = COMBINES[combine]
    monkeypatch.setattr(tmoe, "_add_in_order", make(tmoe._add_in_order))
    jcfg, jl, cfg, tl = _layer(arch, top_k=4)
    jx, tx = _x(2, 16, cfg.d_model)
    want, _ = _jax_moe(jcfg)(jl, jx)
    got, _ = tmoe.moe(tl, tx, cfg)
    differ = int((_np(got) != _np(want)).sum())
    assert (differ == 0) == equal, differ


def _scalar_loss(y, lb, r):
    return (y.astype(jnp.float32) * r).sum() + lb if isinstance(y, jax.Array) else (y.float() * r).sum() + lb


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradient_matches_jax(arch, cf):
    """sum(y * r) + lb_loss, differentiated by autograd and by jax.grad with
    respect to the f32 weights (cast to bf16 inside, as a training unit
    does) and the bf16 input: each leaf within GRAD_REL_F32_ATTENTION
    relative L2 (measured 0.007-0.009 on router, wg, shared wg and x; 0 on
    wi and wo)."""
    jcfg, _, cfg, _ = _layer(arch, cf)
    jp = jax.tree.map(lambda a: a[0], JaxModel(jax_config(arch, smoke=True)).init(jax.random.key(0))["layers"]["scan"])
    jp = jp["block0"]["moe"]
    jx, tx = _x(2, 16, cfg.d_model)
    r = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe(jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, p), x, jcfg)
        return _scalar_loss(y, aux["lb_loss"], jnp.asarray(r))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jp)
    tx.requires_grad_()
    y, aux = tmoe.moe(jax.tree.map(lambda a: a.to(torch.bfloat16) if a.ndim >= 2 else a, tp), tx, cfg)
    _scalar_loss(y, aux["lb_loss"], torch.from_numpy(r)).backward()
    pairs = {jax.tree_util.keystr(p): (a.grad, g) for (p, a), g in
             zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(jg[0]))}
    pairs["x"] = (tx.grad, jg[1])
    errs = {}
    for k, (got, want) in pairs.items():
        got, want = _np(got), _np(want)
        assert np.isfinite(got).all() and np.abs(want).max() > 0, k
        errs[k] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert max(errs.values()) < GRAD_REL_F32_ATTENTION, errs


def test_router_gradient_comes_from_the_gates_and_the_balance_term():
    """frac carries no gradient, mean(probs) does: with the output's weight
    r = 0 the router's gradient is that of E * sum(frac * mean(probs))."""
    _, _, cfg, tl = _layer("deepseek-moe-16b")
    _, tx = _x(2, 16, cfg.d_model)
    w = tl["router"]["w"].float().clone().requires_grad_()
    y, aux = tmoe.moe({**tl, "router": {"w": w}}, tx, cfg)
    (y.float().sum() * 0 + aux["lb_loss"]).backward()
    w2 = w.detach().clone().requires_grad_()
    probs = torch.softmax(tx.reshape(-1, cfg.d_model).float() @ w2, dim=-1)
    (cfg.n_experts * (aux["expert_frac"].detach() * probs.mean(0)).sum()).backward()
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-7)


def test_moe_runs_where_its_input_lies_and_repeats_to_the_bit():
    """No step moves to another device; two runs give the same bits, the
    backward's too (no scatter accumulates into one place)."""
    _, _, cfg, tl = _layer("deepseek-moe-16b", 0.5)
    _, tx = _x(2, 16, cfg.d_model)
    runs = []
    for _ in range(2):
        x = tx.clone().requires_grad_()
        y, aux = tmoe.moe(tl, x, cfg)
        (y.float().square().sum() + aux["lb_loss"]).backward()
        assert y.device == x.device and aux["lb_loss"].device == x.device
        runs.append((y, x.grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("T,want", [(4, 8), (32, 16), (64, 24), (4096, 488), (2048, 248)])
def test_capacity_matches_jax(T, want):
    """deepseek-moe-16b's capacity (smoke below 2048 tokens): at least 8, a
    multiple of 8; 488 for the 2 x 2048 prefill, 248 for a 2048-token train
    step, 8 at decode."""
    cfg = get_config("deepseek-moe-16b") if T >= 2048 else get_config("deepseek-moe-16b", smoke=True)
    jcfg = jax_config(cfg.name.removesuffix("-smoke"), smoke=cfg.name.endswith("-smoke"))
    assert tmoe._capacity(T, cfg) == jmoe._capacity(T, jcfg) == want
