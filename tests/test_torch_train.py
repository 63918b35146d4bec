"""The port's training slice against the JAX package on the CPU: the loss,
the gradients, AdamW and the cosine schedule, the train step (1 and 3 steps,
grad_accum 2), remat, and loss-decreases, for the dense decoders, the
hybrid (recurrentgemma-9b) and the MoE decoders (deepseek-moe-16b,
qwen3-moe-235b-a22b: their loss carries 1e-2 x the load-balance term). The same weights pass between the packages
through ``params_from_numpy``; tokens come from numpy.

The hybrid runs at S = 16, where the JAX package's RG-LRU takes one
``associative_scan``, and at S = 32, where the smoke config's ``chunk=16``
makes it take the checkpointed loop over chunks
(``src/repro/models/rglru.py``); the port's scan runs its plain version and,
under autograd, the plain backward ``ref.rglru_bwd_ref``.

JAX trains on its xla attention path, which rounds the scores and the softmax
probabilities to bf16 before the PV product (``src/repro/models/attention.py``
``_attend_full``); the port follows its flash kernel, which keeps them in f32.
The gradient tests measure that gap against the xla path as it is, and hold
the port tightly against the same JAX model with ``_attend_full`` replaced,
in the test only, by f32 attention: the kernel's arithmetic.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jax_attention  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import _zeros_f32, make_eval_step, make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

DENSE = ["qwen3-4b", "gemma-2b", "llama3.2-3b", "granite-3-8b"]
HYBRID = "recurrentgemma-9b"
# (arch, S): the dense cases at S = 16 keep their ids; the hybrid at both of
# the JAX package's scan branches (not in test_train_step_matches_jax, see there)
HYBRID_CASES = [pytest.param(HYBRID, 16, id=f"{HYBRID}-S16"), pytest.param(HYBRID, 32, id=f"{HYBRID}-S32")]
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
MOE_S = [pytest.param(a, 16, id=a) for a in MOE]
ARCH_S = [pytest.param(a, 16, id=a) for a in ("qwen3-4b", "gemma-2b")] + HYBRID_CASES
DENSE_S = [pytest.param(a, 16, id=a) for a in DENSE] + HYBRID_CASES + MOE_S
# The MoE archs are held against JAX's kernel path and its f32 attention, not
# its xla path: there the bf16 scores and P move the router's inputs enough
# to send tokens to other experts (route flips), each an O(1) change.
KERNEL_PATH_S = ARCH_S + MOE_S
F32 = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's f32 tolerance
# Loss, port against JAX's kernel path (pallas_interpret, f32 P as the port):
# the same arithmetic up to summation order; measured 5e-7 at qwen3-4b smoke,
# 2.1e-5-3.1e-5 at recurrentgemma-9b smoke (S = 16, 32), 0 at the MoE smoke
# configs (deepseek-moe-16b, qwen3-moe-235b-a22b; lb_loss within 1e-7 relative).
LOSS_TOL_KERNEL_PATH = 1e-4
# Loss against JAX's xla path (bf16 scores and P): measured 0.0004-0.0052 over
# weight seeds 0-1 at qwen3-4b and gemma-2b smoke; 6e-6-2.3e-5 at
# recurrentgemma-9b smoke (S = 16, 32).
LOSS_TOL_XLA = 0.02
# Per-leaf relative L2 error of the gradients against jax.value_and_grad:
# - on the xla path as it is: measured 0.036-0.145 over weight seeds 0-1
#   (the bf16 rounding of scores and P; ROADMAP Queue 3), 0.102 and 0.073 at
#   recurrentgemma-9b smoke, S = 16 and 32;
GRAD_REL_XLA = 0.25
# - with f32 attention in the JAX model (the kernel's arithmetic): measured
#   0.010-0.020, what remains of the bf16 activations' rounding, which XLA's
#   fused backward places elsewhere than autograd does; 0.019 and 0.022 at
#   recurrentgemma-9b smoke, S = 16 and 32; 0.029 at deepseek-moe-16b smoke,
#   0.018 at qwen3-moe-235b-a22b smoke.
GRAD_REL_F32_ATTENTION = 0.05
# The port's custom backward (the plain backward versions, which read the
# forward's bf16 output for Dr as the kernel does) against autograd through
# the plain forwards: measured 0.008-0.012 per leaf; 0.020 and 0.023 at
# recurrentgemma-9b smoke, S = 16 and 32.
GRAD_REL_CUSTOM_VS_AUTOGRAD = 0.03


def _f32_attend_full(q, k, v, cfg, *, q_offset: int = 0, window: int | None = None):
    """JAX's ``_attend_full`` with the scores and P in f32 and the output
    rounded once to q's dtype: what the flash kernel computes."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).astype(jnp.float32)
    s = jnp.einsum("bskgd,btkd->bkgst", qg, k.astype(jnp.float32)) / math.sqrt(D)
    mask = jax_attention._mask(jnp.arange(S) + q_offset, jnp.arange(T), window)
    p = jax.nn.softmax(jnp.where(mask[None, None, None], s, -jnp.inf), axis=-1)
    o = jnp.einsum("bkgst,btkd->bskgd", p, v.astype(jnp.float32))
    return o.reshape(B, S, Hq, D).astype(q.dtype)


@pytest.fixture
def f32_attention(monkeypatch):
    monkeypatch.setattr(jax_attention, "_attend_full", _f32_attend_full)


def _bridged(arch, seed=0, impl="xla"):
    """(JAX model, JAX params, port model, port f32 params) on one set of weights."""
    jm = JaxModel(dataclasses.replace(jax_config(arch, smoke=True), attention_impl=impl))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(arch, smoke=True)
    return jm, jp, Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu", train=True)


def _batch(vocab, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0  # a masked tail: the denominator is the mask's sum
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree):
    """{key path: f32 numpy copy} for a JAX or a port tree."""
    def conv(x):
        return x.detach().float().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x, np.float32)

    return {jax.tree_util.keystr(p): conv(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_l2(got, want) -> dict:
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    return {k: float(np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)) for k in w}


def _port_grads(model, params, batch):
    grads = _zeros_f32(params)
    loss, aux = model.loss(model.grad_leaves(params, grads), batch)
    loss.backward()
    return loss.detach(), aux, grads


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "arch,S,impl",
    [pytest.param(*p.values, impl, id=f"{p.id}-{impl}") for p in ARCH_S for impl in ("pallas_interpret", "xla")]
    + [pytest.param(*p.values, "pallas_interpret", id=f"{p.id}-pallas_interpret") for p in MOE_S],
)
def test_loss_matches_jax(arch, S, impl):
    jm, jp, tm, tp = _bridged(arch, impl=impl)
    b = _batch(tm.cfg.vocab, S=S)
    jl, jaux = jax.jit(jm.loss)(jp, _jb(b))
    with torch.no_grad():
        tl, taux = tm.loss(tp, _tb(b))
    tol = LOSS_TOL_KERNEL_PATH if impl == "pallas_interpret" else LOSS_TOL_XLA
    assert abs(float(tl) - float(jl)) < tol
    assert abs(float(taux["ce"]) - float(jaux["ce"])) < tol
    assert abs(float(taux["z_loss"]) - float(jaux["z_loss"])) < tol * 1e-2
    assert float(taux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]), rel=1e-5)
    assert (float(jaux["lb_loss"]) > 0) == (arch in MOE)


def test_loss_without_mask_is_the_mean_over_all_tokens():
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), train=True)
    b = _tb(_batch(cfg.vocab))
    with torch.no_grad():
        full, _ = model.loss(params, {**b, "loss_mask": torch.ones_like(b["loss_mask"])})
        none, _ = model.loss(params, {k: v for k, v in b.items() if k != "loss_mask"})
    assert torch.equal(full, none)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grad_errors(arch, S=16):
    jm, jp, tm, tp = _bridged(arch)
    b = _batch(tm.cfg.vocab, S=S)
    _, jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, _jb(b))
    _, _, tg = _port_grads(tm, tp, _tb(b))
    for k, g in _flat(tg).items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
    return _rel_l2(tg, jg)


@pytest.mark.parametrize("arch,S", ARCH_S)
def test_grads_match_jax_xla_path(arch, S):
    errs = _grad_errors(arch, S)
    assert max(errs.values()) < GRAD_REL_XLA, max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("arch,S", KERNEL_PATH_S)
def test_grads_match_jax_with_f32_attention(arch, S, f32_attention):
    errs = _grad_errors(arch, S)
    assert max(errs.values()) < GRAD_REL_F32_ATTENTION, max(errs.items(), key=lambda kv: kv[1])


def test_silu_gradient_is_finite_where_exp_overflows():
    """jax.nn.silu's gradient, the logistic's derivative: 0 below x = -88,
    where autograd through x / (1 + exp(-x)) multiplied 0 by exp(-x) = inf
    and gave NaN (the full-width deepseek-moe-16b train step, whose stacked
    weights have std 1/sqrt(5), met it); over [-200, 20] within the bf16
    tolerance of jax.grad's."""
    from repro_torch.models.modules import ACTIVATIONS

    xs = np.concatenate([[-200.0, -100.0, -89.0], np.linspace(-20, 20, 401)])
    jx = jnp.asarray(xs, jnp.bfloat16)
    want = jax.jit(jax.grad(lambda x: jnp.sum(jax.nn.silu(x).astype(jnp.float32))))(jx)
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16().requires_grad_()
    ACTIVATIONS["silu"](x).float().sum().backward()
    assert torch.isfinite(x.grad).all() and not x.grad[:3].any()
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch,S", DENSE_S)
def test_custom_backward_matches_autograd_through_the_plain_forwards(arch, S, monkeypatch):
    """The autograd Functions (their CPU path: the plain backward formulas)
    against autograd through the plain forwards, whole model."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), train=True)
    b = _tb(_batch(cfg.vocab, S=S))
    _, _, custom = _port_grads(model, params, b)
    monkeypatch.setattr(ops, "_records", lambda *tensors: False)  # no Function: autograd sees the plain ops
    _, _, plain = _port_grads(model, params, b)
    errs = _rel_l2(custom, plain)
    assert max(errs.values()) < GRAD_REL_CUSTOM_VS_AUTOGRAD, max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("arch,S", [pytest.param("qwen3-4b", 16, id="qwen3-4b"), *HYBRID_CASES, *MOE_S])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(remat, arch, S):
    """A checkpoint recomputes the same forward (the kernels' plain versions
    are deterministic), so the gradients are equal to the bit."""
    cfg = get_config(arch, smoke=True)
    assert cfg.remat == "none"
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    b = _tb(_batch(cfg.vocab, S=S))
    _, _, want = _port_grads(Model(cfg, device="cpu"), params, b)
    _, _, got = _port_grads(Model(dataclasses.replace(cfg, remat=remat), device="cpu"), params, b)
    g, w = _flat(got), _flat(want)
    assert all(np.array_equal(g[k], w[k]) for k in w)


@pytest.mark.parametrize("arch", MOE)
def test_dots_remat_recomputes_the_expert_bmms_and_saves_the_router_mm(arch):
    """Remat "dots" is the JAX package's ``dots_with_no_batch_dims_saveable``:
    the router's product has no batch dim and is saved, the experts'
    products have one (e) and are recomputed. Counted over ``backward()``
    against remat "none": "dots" adds each MoE unit's three expert ``bmm``s
    (at their forward shapes) and no router ``mm``; "full" adds both."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.moe import _capacity
    from repro_torch.models.transformer import StackLayout

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.calls[(func.overloadpacket.__name__, tuple(args[0].shape), tuple(args[1].shape))] += 1
            return func(*args, **(kwargs or {}))

    cfg = get_config(arch, smoke=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    b = _tb(_batch(cfg.vocab, S=8))  # T = 16 tokens: no backward product takes the router's shapes
    T, D, E, F = 2 * 8, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    C = _capacity(T, cfg)
    router = ("mm", (T, D), (D, E))
    experts = {("bmm", (E, C, D), (E, D, F)): 2, ("bmm", (E, C, F), (E, F, D)): 1}
    units = StackLayout(cfg).n_units
    seen = {}
    for remat in ("none", "dots", "full"):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        loss, _ = model.loss(model.grad_leaves(params, _zeros_f32(params)), b)
        with Products() as products:
            loss.backward()
        seen[remat] = products.calls
    for remat, router_runs in (("dots", 0), ("full", units)):
        extra = seen[remat] - seen["none"]
        assert extra[router] == router_runs, (remat, extra)
        assert all(extra[k] == n * units for k, n in experts.items()), (remat, extra)
    assert seen["none"][router] == 0


def test_stacked_weights_get_one_gradient_buffer():
    """The per-unit gradient leaves write into slices of the stacked buffer."""
    cfg = get_config("qwen3-4b", smoke=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    grads = _zeros_f32(params)
    leaves = Model.grad_leaves(params, grads)
    wq = leaves["layers"]["scan"]["block0"]["attn"]["wq"]
    assert isinstance(wq, list) and len(wq) == cfg.n_layers
    assert wq[1].grad.data_ptr() == grads["layers"]["scan"]["block0"]["attn"]["wq"][1].data_ptr()
    assert wq[1].data_ptr() == params["layers"]["scan"]["block0"]["attn"]["wq"][1].data_ptr()


def test_hybrid_remainder_layers_are_plain_leaves_with_their_gradients():
    """recurrentgemma's two remainder rec layers stay plain leaves (views of
    their parameters, ``.grad`` their place in the buffer) beside the stacked
    unit's per-unit lists; one backward fills every buffer leaf."""
    cfg = get_config(HYBRID, smoke=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    grads = _zeros_f32(params)
    leaves = Model.grad_leaves(params, grads)
    rem = leaves["layers"]["remainder"]
    assert sorted(rem) == ["layer3", "layer4"]
    for name in ("layer3", "layer4"):
        wa = rem[name]["rec"]["lru"]["wa"]
        assert isinstance(wa, torch.Tensor) and wa.requires_grad
        assert wa.data_ptr() == params["layers"]["remainder"][name]["rec"]["lru"]["wa"].data_ptr()
        assert wa.grad.data_ptr() == grads["layers"]["remainder"][name]["rec"]["lru"]["wa"].data_ptr()
    assert isinstance(leaves["layers"]["scan"]["block0"]["rec"]["lru"]["wa"], list)
    model = Model(cfg, device="cpu")
    loss, _ = model.loss(leaves, _tb(_batch(cfg.vocab)))
    loss.backward()
    for k, g in _flat(grads).items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k


def test_inference_forward_is_unchanged_by_trainable_params():
    """forward follows the caller's autograd mode: the same logits with f32
    trainable leaves under grad mode as with the serving params under
    inference_mode."""
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device="cpu")
    serve = model.init(torch.Generator().manual_seed(0))
    train = model.init(torch.Generator().manual_seed(0), train=True)
    tokens = torch.from_numpy(_batch(cfg.vocab)["tokens"])
    with torch.inference_mode():
        want, _ = model.forward(serve, {"tokens": tokens})
    got, _ = model.forward(model.grad_leaves(train, _zeros_f32(train)), {"tokens": tokens})
    assert got.requires_grad and torch.equal(got.detach(), want)


# ---------------------------------------------------------------------------
# AdamW and the schedule (tests/test_substrate.py's TestAdamW, both packages)
# ---------------------------------------------------------------------------


def _tree(seed, shapes=((2,), (3, 4), (2, 3, 5))):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(shapes[0], np.float32),
            "b": {"w": rng.standard_normal(shapes[1], np.float32), "u": rng.standard_normal(shapes[2], np.float32)}}


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


class TestAdamW:
    def test_matches_reference_math(self):
        p, g = {"w": torch.tensor([1.0])}, {"w": torch.tensor([0.5])}
        st = adamw_init(p)
        cfg = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, clip_norm=1e9)
        new_p, st2, _ = adamw_update(g, st, p, lr=0.1, cfg=cfg)
        # bias-corrected first step: update = lr * g/|g| = lr (adam property)
        np.testing.assert_allclose(float(new_p["w"][0]), 1.0 - 0.1, rtol=1e-5)
        assert int(st2["step"]) == 1

    def test_weight_decay_pulls_to_zero(self):
        p, g = {"w": torch.tensor([10.0])}, {"w": torch.tensor([0.0])}
        new_p, _, _ = adamw_update(g, adamw_init(p), p, lr=0.1, cfg=AdamWConfig(weight_decay=0.1))
        assert float(new_p["w"][0]) < 10.0

    def test_clipping_bounds_update(self):
        p, g = {"w": torch.tensor([0.0])}, {"w": torch.tensor([1e6])}
        _, _, m = adamw_update(g, adamw_init(p), p, lr=0.1, cfg=AdamWConfig(clip_norm=1.0))
        assert float(m["clip_scale"]) == pytest.approx(1e-6, rel=1e-3)

    def test_state_mirrors_param_tree(self):
        p = _t(_tree(0))
        st = adamw_init(p)
        assert jax.tree.structure(st["m"]) == jax.tree.structure(p) == jax.tree.structure(st["v"])
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0

    def test_updates_in_place(self):
        p, g = _t(_tree(1)), _t(_tree(2))
        st = adamw_init(p)
        ptrs = [t.data_ptr() for t in jax.tree.leaves(p) + jax.tree.leaves(st["m"])]
        new_p, new_st, _ = adamw_update(g, st, p, lr=0.1)
        assert new_p is p and new_st is st
        assert ptrs == [t.data_ptr() for t in jax.tree.leaves(p) + jax.tree.leaves(st["m"])]

    @pytest.mark.parametrize("moments", ["f32", "bf16"])
    @pytest.mark.parametrize("clip_norm", [1e9, 1.0])
    def test_matches_jax_over_steps(self, moments, clip_norm):
        """Five steps on one tree in both packages, the same gradients each
        step: parameters and moments at f32 2e-5, bias correction at every
        step, clipping when it binds (gradients of norm ~5 against 1), and
        bf16 moments stored rounded with f32 math in between."""
        cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=clip_norm)
        jp = jax.tree.map(jnp.asarray, _tree(3))
        jst = jax_adamw_init(jp, moment_dtype=jnp.bfloat16 if moments == "bf16" else jnp.float32)
        tp = _t(_tree(3))
        tst = adamw_init(tp, moment_dtype=torch.bfloat16 if moments == "bf16" else torch.float32)
        for step in range(5):
            g = _tree(10 + step)
            jp, jst, jm = jax_adamw_update(jax.tree.map(jnp.asarray, g), jst, jp, lr=0.05, cfg=JaxAdamWConfig(**cfg))
            tp, tst, tm = adamw_update(_t(g), tst, tp, lr=0.05, cfg=AdamWConfig(**cfg))
            for name in ("grad_norm", "clip_scale"):
                np.testing.assert_allclose(float(tm[name]), float(jm[name]), **F32)
            assert int(tst["step"]) == int(jst["step"]) == step + 1
            for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
                g_, w_ = _flat(got), _flat(want)
                for k in w_:
                    np.testing.assert_allclose(g_[k], w_[k], **F32)
            if moments == "bf16":
                assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(tst["m"]))

    def test_global_norm(self):
        t = _tree(4)
        want = math.sqrt(sum(float(np.square(a).sum()) for a in jax.tree.leaves(t)))
        np.testing.assert_allclose(float(global_norm(_t(t))), want, rtol=1e-6)

    def test_schedule_warmup_and_decay(self):
        lr = cosine_schedule(1.0, warmup_steps=10, total_steps=100)
        assert float(lr(0)) == 0.0
        assert float(lr(10)) == pytest.approx(1.0, rel=1e-3)
        assert float(lr(100)) == pytest.approx(0.1, rel=1e-2)
        assert float(lr(5)) == pytest.approx(0.5, rel=1e-3)

    @pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (3, 2)])
    def test_schedule_matches_jax_at_every_step(self, warmup, total):
        jl, tl = jax_cosine(3e-3, warmup_steps=warmup, total_steps=total), cosine_schedule(3e-3, warmup_steps=warmup,
                                                                                             total_steps=total)
        for step in range(total + 3):
            np.testing.assert_allclose(float(tl(torch.tensor(step, dtype=torch.int32))), float(jl(step)), **F32)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------
# Adam's update is about lr * sign(g) wherever |g| >> eps, whatever |g| is, so
# an entry whose gradient lies within the two packages' gradient gap of 0 may
# move the other way, 2 lr from JAX's. Each leaf's update (the parameters
# after the steps minus before) is held at a relative L2 error against JAX's,
# about twice the root of the share of such flips: measured 0.14-0.21 over
# these cases (0.5-2 % of the entries flipped). An update of the wrong sign,
# one not applied or one at twice the lr gives 1 or more. The moments, which
# carry the gradients' values, are held at a relative L2 error too.
UPDATE_REL = 0.3
MOMENT_REL_ONE_STEP = 0.05  # measured 0.010-0.023 with f32 attention
LOSS_REL_THREE_STEPS = 0.05  # measured 0.2-2.0 % at step 3 (lr 1e-2 moves the smoke model fast)


def _run_both(arch, steps, grad_accum=1, B=2):
    jm, jp, tm, tp = _bridged(arch)
    lr_j, lr_t = jax_cosine(1e-2, warmup_steps=0, total_steps=10), cosine_schedule(1e-2, warmup_steps=0,
                                                                                   total_steps=10)
    jstep = jax.jit(jax_train_step(jm, lr_j, JaxAdamWConfig(), grad_accum=grad_accum))
    tstep = make_train_step(tm, lr_t, AdamWConfig(), grad_accum=grad_accum)
    jst, tst = jax_adamw_init(jp), adamw_init(tp)
    p0 = _flat(tp)
    out = []
    for i in range(steps):
        b = _batch(tm.cfg.vocab, B=B, seed=100 + i)
        jp, jst, jmet = jstep(jp, jst, _jb(b))
        tp, tst, tmet = tstep(tp, tst, _tb(b))
        out.append((jmet, tmet))
    return jp, jst, tp, tst, p0, out


def _check_against_jax(jp, jst, tp, tst, p0, out, steps):
    for jmet, tmet in out:
        assert set(tmet) == {"loss", "lr", "ce", "z_loss", "lb_loss", "grad_norm", "clip_scale"}
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), **F32)
    assert abs(float(out[0][1]["loss"]) - float(out[0][0]["loss"])) < LOSS_TOL_KERNEL_PATH
    tf, jf = _flat(tp), _flat(jp)
    for k in jf:
        update, want = tf[k] - p0[k], jf[k] - p0[k]
        assert np.any(update), k  # every leaf moved
        assert np.linalg.norm(update - want) <= UPDATE_REL * np.linalg.norm(want), k
    if steps == 1:
        for name in ("m", "v"):
            errs = _rel_l2(tst[name], jst[name])
            assert max(errs.values()) < MOMENT_REL_ONE_STEP, (name, max(errs.items(), key=lambda kv: kv[1]))
    else:
        jl, tl = float(out[-1][0]["loss"]), float(out[-1][1]["loss"])
        assert abs(tl - jl) < LOSS_REL_THREE_STEPS * jl
    assert int(tst["step"]) == int(jst["step"]) == steps


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_train_step_matches_jax(arch, steps, f32_attention):
    _check_against_jax(*_run_both(arch, steps), steps)


# The hybrid is not in test_train_step_matches_jax: its smoke model is chaotic
# in its parameters in the JAX package itself. The stacked unit's matrices
# have std 1 (fan_in = n_units = 1, ROADMAP "Reference behaviours"), which
# drives some gates r to ~1e-9, where beta = sqrt(1 - exp(2 log_a)) takes one
# of a few f32 values; a nudge of 1e-6 to the norm scales moves JAX's first
# gradient norm from 119.8 to 50.4 and its 3-step updates by 1.2 relative L2
# (qwen3-4b: 37.06 to 37.08, 0.17). The port against JAX, each leaf's update
# at f32 attention: S = 16 0.35 after one step (two entries of a 64-entry norm
# scale, at 4e-4 and 1e-3 of its RMS, take opposite signs) and 0.95 after
# three, S = 32 0.25 and 0.91; its gradients at JAX's own parameters after two
# steps stay within 0.02. So the hybrid's step is held against JAX from the
# same parameters (the gradient tests above) and against the card
# (tests/test_torch_gpu.py), not along a trajectory.
NUDGE = 1e-6


@pytest.mark.parametrize("arch,chaotic", [("recurrentgemma-9b", True), ("qwen3-4b", False)])
def test_hybrid_smoke_trajectory_is_chaotic_in_the_reference(arch, chaotic, f32_attention):
    """JAX against JAX with the norm scales moved by NUDGE: the hybrid's first
    gradient norm moves by more than a third and its 3-step updates part by
    more than UPDATE_REL; qwen3-4b's stay within 1 % and UPDATE_REL."""
    jm, jp, tm, _ = _bridged(arch)
    nudged = jax.tree_util.tree_map_with_path(
        lambda path, x: x + NUDGE if "scale" in jax.tree_util.keystr(path) else x, jp)
    step = jax.jit(jax_train_step(jm, jax_cosine(1e-2, warmup_steps=0, total_steps=10), JaxAdamWConfig()))
    runs = []
    for p in (jp, nudged):
        st, norms = jax_adamw_init(p), []
        for i in range(3):
            p, st, met = step(p, st, _jb(_batch(tm.cfg.vocab, seed=100 + i)))
            norms.append(float(met["grad_norm"]))
        runs.append((_flat(p), norms))
    (pa, na), (pb, nb) = runs
    p0 = _flat(jp)
    worst = max(np.linalg.norm((pa[k] - p0[k]) - (pb[k] - p0[k])) / np.linalg.norm(pa[k] - p0[k]) for k in pa)
    first = abs(nb[0] - na[0]) / na[0]
    if chaotic:
        assert first > 1 / 3 and worst > UPDATE_REL, (na, nb, worst)
    else:
        assert first < 0.01 and worst < UPDATE_REL, (na, nb, worst)


@pytest.mark.parametrize("arch,weights", [("recurrentgemma-9b", "init"), ("recurrentgemma-9b", "unstacked_std"),
                                          ("qwen3-4b", "init")])
def test_port_smoke_gradients_under_a_nudge(arch, weights):
    """The port's gradients (attention's plain version: f32) at the batch of
    chip_smoke.py's grads_check, against those with the norm scales moved by
    NUDGE. At its init the hybrid's move by more than 0.2 relative L2 on a
    leaf (measured 0.43, the gates' wa): no two devices can agree there. With
    each stacked matrix at its unstacked spec's std (``at_unstacked_std``),
    and for qwen3-4b at its init, they stay within GRAD_REL_F32_ATTENTION
    (measured 0.017 and 0.02), the bound grads_check holds the card to."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.modules import at_unstacked_std, tree_map_with_path

    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), train=True)
    if weights == "unstacked_std":
        params = at_unstacked_std(params)
    nudged = tree_map_with_path(lambda path, x: x + NUDGE if "scale" in path[-1] else x, params)
    b = _tb(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0)).batch(0))
    errs = _rel_l2(_port_grads(model, nudged, b)[2], _port_grads(model, params, b)[2])
    worst = max(errs.items(), key=lambda kv: kv[1])
    if arch == HYBRID and weights == "init":
        assert worst[1] > 0.2, worst
    else:
        assert worst[1] < GRAD_REL_F32_ATTENTION, worst


def test_train_step_grad_accum_matches_jax(f32_attention):
    _check_against_jax(*_run_both("qwen3-4b", 1, grad_accum=2, B=4), 1)


def test_grad_accum_sums_the_microbatches():
    """grad_accum=2 over a batch of 4 against one pass over the same 4 rows:
    with a full mask the two losses are the same mean, so the moments agree
    to f32 rounding (the order of the sums differs)."""
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device="cpu")
    b = _batch(cfg.vocab, B=4, seed=5)
    b["loss_mask"][:] = 1.0
    states = []
    for accum in (1, 2):
        params = model.init(torch.Generator().manual_seed(0), train=True)
        st = adamw_init(params)
        _, st, met = make_train_step(model, cosine_schedule(1e-2, warmup_steps=0), grad_accum=accum)(
            params, st, _tb(b))
        states.append((st, met))
    (st1, m1), (st2, m2) = states
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    errs = _rel_l2(st2["m"], st1["m"])
    assert max(errs.values()) < 1e-2, max(errs.items(), key=lambda kv: kv[1])


def test_train_step_rejects_a_batch_that_does_not_split():
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(train=True)
    step = make_train_step(model, cosine_schedule(1e-2), grad_accum=2)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), _tb(_batch(cfg.vocab, B=3)))


def test_eval_step_is_the_loss():
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(train=True)
    b = _tb(_batch(cfg.vocab))
    out = make_eval_step(model)(params, b)
    with torch.no_grad():
        want, aux = model.loss(params, b)
    assert torch.equal(out["loss"], want) and torch.equal(out["ce"], aux["ce"])
    assert not out["loss"].requires_grad


# ---------------------------------------------------------------------------
# end to end (tests/test_smoke_archs.py's loss-decreases case)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,S", DENSE_S)
def test_train_step_decreases_loss(arch, S):
    """Normalised SGD on a repeated batch through the port's autograd: the
    loss falls within 6 steps, every gradient finite."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), train=True)
    b = _tb(_batch(cfg.vocab, S=S, seed=1))
    losses = []
    for _ in range(6):
        loss, _, grads = _port_grads(model, params, b)
        losses.append(float(loss))
        gnorm = float(global_norm(grads))
        assert math.isfinite(gnorm) and gnorm > 0
        with torch.no_grad():
            for p, g in zip(jax.tree.leaves(params), jax.tree.leaves(grads)):
                p.sub_(0.05 * g / (gnorm + 1e-6))
    assert math.isfinite(losses[0]) and losses[-1] < losses[0], losses
