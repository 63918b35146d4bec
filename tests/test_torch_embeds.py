"""The two families that take embeddings as input, on the CPU against the
JAX package: ``apply_mrope`` (qwen2-vl's multimodal RoPE), and the
qwen2-vl-2b and musicgen-medium smoke models' prefill and decode logits,
loss and gradients, from bf16 embeddings made from numpy seeds. The JAX
model runs jitted on its kernel path (``attention_impl="pallas_interpret"``)
for the logits, and on its xla path with f32 attention put in by the test
for the gradients, as tests/test_torch_train.py holds the other families."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import _zeros_f32  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

from test_torch_train import GRAD_REL_F32_ATTENTION, LOSS_TOL_KERNEL_PATH, f32_attention  # noqa: E402, F401

ARCHS = ["qwen2-vl-2b", "musicgen-medium"]
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_kernels.py
LOGIT_TOL = 0.05  # tests/test_smoke_archs.py's decode/prefill bound
GAP_TOL = 0.01  # the port's decode-vs-prefill gap against JAX's, step by step


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def image_positions(B: int, S: int, text: int = 8, grid: tuple[int, int, int] = (2, 3, 4)) -> np.ndarray:
    """(B, S, 3) int32 M-RoPE positions of ``text`` text tokens (one position
    in all three streams), then an image of (t, h, w) = ``grid`` patches
    (each stream its own index from the text's end), then text again from
    the largest position + 1, as Qwen2-VL lays them out: the three streams
    differ over the image."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()], -1) + text
    n_img = min(len(img), max(S - text, 0))
    rest = S - text - n_img
    tail = np.arange(rest)[:, None].repeat(3, 1) + (img[:n_img].max() + 1 if n_img else text)
    pos = np.concatenate([np.arange(text)[:, None].repeat(3, 1), img[:n_img], tail])[:S]
    return np.broadcast_to(pos.astype(np.int32), (B, S, 3)).copy()


def _embeds(d: int, shape: tuple[int, int], seed: int = 0):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal((*shape, d)), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _bridged(arch, seed=0, impl="pallas_interpret", train=False):
    """(JAX model, JAX params, port model, port params) sharing one set of weights."""
    jm = JaxModel(dataclasses.replace(jax_config(arch, smoke=True), attention_impl=impl))
    jp = jm.init(jax.random.key(seed))
    cfg = get_config(arch, smoke=True)
    return jm, jp, Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu", train=train)


def _batches(cfg, B, S, seed=0, positions=True):
    """The same batch for both: embeds and, with M-RoPE, image positions."""
    je, te = _embeds(cfg.d_model, (B, S), seed)
    jb, tb = {"embeds": je}, {"embeds": te}
    if cfg.mrope and positions:
        pos = image_positions(B, S)
        jb["positions"], tb["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    return jb, tb


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,sections", [(8, None), (128, None), (8, (2, 1, 1)), (8, (1, 2, 1))])
def test_apply_mrope_matches_jax(D, sections, dtype):
    """(B, S, H, D) rotated by image positions whose three streams differ;
    qwen2-vl's head dims (8 at smoke, 128 in full) at its default sections
    (D/2 - 2 (D/2 // 4), D/2 // 4, D/2 // 4), and two others at D = 8."""
    B, S, H = 2, 40, 3
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(np.random.default_rng(3).standard_normal((B, S, H, D)), jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    pos = image_positions(B, S)
    assert len({tuple(pos[0, :, i]) for i in range(3)}) == 3
    want = jax.jit(lambda x, p: jmod.apply_mrope(x, p, 1e6, sections))(jx, jnp.asarray(pos))
    got = tmod.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_apply_mrope_with_equal_streams_is_rope():
    """Where the three streams are one position, M-RoPE is RoPE, in both
    packages (the sections then rotate by one position)."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 2, 8)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    got = tmod.apply_mrope(x, pos[..., None].expand(2, 16, 3), 1e6)
    torch.testing.assert_close(got, tmod.apply_rope(x, pos, 1e6), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_and_bridge_match_jax(arch):
    """The same leaves and shapes as the JAX package (``embed_proj`` in place
    of the token table), the same parameter counts in full; ``embed_proj.w``
    stored in bf16 for inference, as the JAX package casts it before use."""
    jm, jp, tm, tp = _bridged(arch)
    want = {jax.tree_util.keystr(p): np.shape(a) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert got == want and "embed" not in tp
    assert tp["embed_proj"]["w"].dtype == torch.bfloat16
    assert get_config(arch).n_params() == JaxModel(jax_config(arch)).n_params
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_kernel_path(arch):
    """From bf16 embeddings (qwen2-vl-2b: image positions). Measured 1.9e-6
    at qwen2-vl-2b, 0.0 at musicgen-medium."""
    jm, jp, tm, tp = _bridged(arch)
    jb, tb = _batches(tm.cfg, 2, 32)
    want, _ = jax.jit(jm.forward)(jp, jb)
    got, lb = tm.forward(tp, tb)
    assert got.shape == (2, 32, tm.cfg.vocab) and float(lb) == 0.0
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err < LOGIT_TOL, err


def test_default_mrope_positions_are_the_arange_in_every_stream():
    jm, jp, tm, tp = _bridged("qwen2-vl-2b")
    jb, tb = _batches(tm.cfg, 2, 16, positions=False)
    default, _ = tm.forward(tp, tb)
    pos = torch.arange(16, dtype=torch.int32)[None, :, None].expand(2, 16, 3)
    explicit, _ = tm.forward(tp, {**tb, "positions": pos})
    assert torch.equal(default, explicit)
    want, _ = jax.jit(jm.forward)(jp, jb)
    assert float(np.abs(_np(default) - _np(want)).max()) < LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_jax_over_8_steps(arch):
    """decode_step from embeddings (M-RoPE: all three streams at pos).
    Measured 0.0 at every step for both."""
    jm, jp, tm, tp = _bridged(arch)
    je, te = _embeds(tm.cfg.d_model, (2, 8), seed=1)
    jstate, tstate = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(8):
        want, jstate = jstep(jp, {"embeds": je[:, t : t + 1]}, jstate, jnp.int32(t))
        got, tstate = tm.decode_step(tp, {"embeds": te[:, t : t + 1]}, tstate, t)
        assert got.shape == (2, tm.cfg.vocab)
        errs.append(float(np.abs(_np(got) - _np(want)).max()))
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_vs_prefill_gap_equals_jax_gap(arch):
    """Decode against the prefill over 8 tokens (default positions): the
    flash kernel keeps P in f32, decode rounds it to bf16 as JAX's does, so
    the gap is the reference's own (measured 0.058 at qwen2-vl-2b smoke,
    0.063 at musicgen-medium); the port's equals JAX's within GAP_TOL, step
    by step (measured equal)."""
    jm, jp, tm, tp = _bridged(arch)
    je, te = _embeds(tm.cfg.d_model, (1, 8), seed=2)
    jfwd, _ = jax.jit(jm.forward)(jp, {"embeds": je})
    tfwd, _ = tm.forward(tp, {"embeds": te})
    jstate, tstate = jm.init_decode_state(1, 16), tm.init_decode_state(1, 16)
    jstep = jax.jit(jm.decode_step)
    jgap, tgap = [], []
    for t in range(8):
        jl, jstate = jstep(jp, {"embeds": je[:, t : t + 1]}, jstate, jnp.int32(t))
        tl, tstate = tm.decode_step(tp, {"embeds": te[:, t : t + 1]}, tstate, t)
        jgap.append(float(np.abs(_np(jl)[0] - _np(jfwd)[0, t]).max()))
        tgap.append(float(np.abs(_np(tl)[0] - _np(tfwd)[0, t]).max()))
    assert max(abs(a - b) for a, b in zip(tgap, jgap)) < GAP_TOL, (tgap, jgap)


def _train_batches(cfg, B=2, S=16, seed=0):
    jb, tb = _batches(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    for b, conv in ((jb, jnp.asarray), (tb, torch.from_numpy)):
        b.update(labels=conv(labels), loss_mask=conv(mask))
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax_kernel_path(arch):
    """Measured 9.5e-7 at qwen2-vl-2b, 4.8e-7 at musicgen-medium."""
    jm, jp, tm, tp = _bridged(arch)
    jb, tb = _train_batches(tm.cfg)
    want, _ = jax.jit(jm.loss)(jp, jb)
    with torch.no_grad():
        got, aux = tm.loss(tp, tb)
    assert abs(float(got) - float(want)) < LOSS_TOL_KERNEL_PATH and float(aux["lb_loss"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_with_f32_attention(arch, f32_attention):
    """Each leaf's gradient, embed_proj's included, within
    GRAD_REL_F32_ATTENTION of jax.value_and_grad on the xla path with f32
    attention (tests/test_torch_train.py says why). Measured 0.023 at
    qwen2-vl-2b, 0.014 at musicgen-medium."""
    jm, jp, tm, tp = _bridged(arch, impl="xla", train=True)
    jb, tb = _train_batches(tm.cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    grads = _zeros_f32(tp)
    loss, _ = tm.loss(tm.grad_leaves(tp, grads), tb)
    loss.backward()
    want = {jax.tree_util.keystr(p): _np(a) for p, a in jax.tree_util.tree_leaves_with_path(jg)}
    got = {jax.tree_util.keystr(p): _np(a) for p, a in jax.tree_util.tree_leaves_with_path(grads)}
    assert got.keys() == want.keys() and np.abs(got["['embed_proj']['w']"]).max() > 0
    rel = {k: float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)) for k, w in want.items()}
    assert all(np.isfinite(g).all() for g in got.values())
    assert max(rel.values()) < GRAD_REL_F32_ATTENTION, max(rel.items(), key=lambda kv: kv[1])
    assert abs(float(loss.detach()) - float(jl)) < LOSS_TOL_KERNEL_PATH
