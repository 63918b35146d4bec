"""The port's execution engines (``repro_torch.core.engines``) on the CPU,
against the JAX package's (``repro.core.engines``) and against themselves.

On the CPU no CUDA graph exists: ``BlockwiseEngine`` and ``CompiledEngine``
run the graph protocol without one (static buffers, copy-in, the errors and
the aliasing of outputs), so each engine's loss equals an eager run of the
same function to the bit. The blockwise stages compute the cross-entropy
only, where the full loss adds the z-loss (as in the JAX benchmark), so
blockwise is held to the eager chain of its own stages, the full loss to
``EagerEngine(full_loss)``. Against JAX, the same weights
(``params_from_numpy``) and tokens run through the JAX package's engines on
its kernel path (``attention_impl="pallas_interpret"``, f32 P as the port's
flash kernel): each stage, from the port's input, within the bf16 tolerance
of ``tests/test_kernels.py`` (the head's loss within
``LOSS_TOL_KERNEL_PATH``, ``tests/test_torch_train.py``), and the losses of
the whole chain and of the full loss within ``LOSS_TOL_B2_S64``.

The graph path's launch bookkeeping (the capture's count taken back off,
added once per replay) is held with a stub graph and a stub kernel that
counts, since no graph runs here.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import engines as jax_engines  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.modules import rms_norm as jax_rms_norm  # noqa: E402
from repro.models.transformer import _ffn_kind as jax_ffn_kind  # noqa: E402
from repro.models.transformer import block_apply as jax_block_apply  # noqa: E402
from repro_torch.benchmarks import fig01_engines as fig01  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

LOSS_TOL_KERNEL_PATH = 1e-4  # tests/test_torch_train.py
# The full loss at the benchmark's B 2 x S 64, port against JAX's kernel path:
# measured 6.2e-5-3.2e-4 over weight seeds 0-1 and token seeds 0-2 (S 16:
# 0-8.4e-5). XLA and torch add the bf16 products of a matmul in different
# orders, so 0.05-0.1 % of a layer's bf16 outputs land one rounding step
# apart (stage by stage below), and the smoke model's std-1 stacked matrices
# carry the flips to the loss. Replacing JAX's RoPE cos and sin by torch's
# moves none of these gaps. A dropped z-loss term moves the loss by ~3.6e-3.
LOSS_TOL_B2_S64 = 1e-3
BF16 = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py's bf16 tolerance


@pytest.fixture(scope="module")
def bridged():
    """The JAX package's fig01 functions and the port's on one set of weights
    and tokens: (JAX full loss, JAX stages, port model, port params, batch)."""
    jcfg = dataclasses.replace(jax_config(fig01.ARCH, smoke=True), attention_impl="pallas_interpret")
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(0))
    cfg = get_config(fig01.ARCH, smoke=True)
    model = Model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    batch = fig01.make_batch(cfg, "cpu", seed=1)
    tokens, labels = (jnp.asarray(batch[k].numpy()) for k in ("tokens", "labels"))
    positions = jnp.broadcast_to(jnp.arange(fig01.S, dtype=jnp.int32), (fig01.B, fig01.S))

    # benchmarks/fig01_engines.py's functions, as written there
    def full_loss(p):
        return jm.loss(p, {"tokens": tokens, "labels": labels})[0]

    def stage_embed(_):
        return jnp.take(jp["embed"]["table"], tokens, axis=0).astype(jnp.bfloat16)

    def make_layer_stage(j):
        def stage(x):
            unit = jax.tree.map(lambda a: a[j], jp["layers"]["scan"])
            h, _ = jax_block_apply(unit["block0"], x, jcfg, "attn", jax_ffn_kind(jcfg, 0), positions,
                                   scope=f"layer{j}")
            return h

        return stage

    def stage_head(x):
        x = jax_rms_norm(jp["final_norm"], x, scope="final_norm")
        logits = jm.logits_fn(jp, x)
        lsm = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(lsm, labels[..., None], -1).mean()

    n_units = jp["layers"]["scan"]["block0"]["norm1"]["scale"].shape[0]
    stages = [stage_embed] + [make_layer_stage(j) for j in range(n_units)] + [stage_head]
    return full_loss, jp, stages, model, params, batch


def _chain(stages):
    def run(carry):
        for s in stages:
            carry = s(carry)
        return carry

    return run


def test_the_three_engines_match_eager_to_the_bit_and_jax_within_its_kernel_path(bridged):
    jax_full, jp, jax_stages, model, params, batch = bridged
    full_loss, stages = fig01.make_fns(model, params, batch)
    eager, blockwise, compiled = fig01.make_engines(full_loss, stages)
    got = {e.name: e.run(fig01.STEPS, lambda i: (params,)).outputs.clone() for e in (eager, blockwise, compiled)}
    assert not blockwise.captured and not compiled.captured  # no graph on the CPU
    assert torch.equal(got["compiled"], got["eager"])
    assert torch.equal(got["blockwise"], _chain(stages)(params))
    # the blockwise head's cross-entropy is the full loss's ce term
    assert got["blockwise"].item() == pytest.approx(model.loss(params, batch)[1]["ce"].item(), rel=1e-6)

    want_full = float(jax_engines.CompiledEngine(jax_full).run(fig01.STEPS, lambda i: (jp,)).outputs)
    want_ce = float(jax_engines.BlockwiseEngine(jax_stages).run(fig01.STEPS, lambda i: (jp,)).outputs)
    assert abs(got["compiled"].item() - want_full) < LOSS_TOL_B2_S64
    assert abs(got["blockwise"].item() - want_ce) < LOSS_TOL_B2_S64


def test_blockwise_stages_match_the_jax_stages(bridged):
    _, jp, jax_stages, model, params, batch = bridged
    _, stages = fig01.make_fns(model, params, batch)
    assert len(stages) == len(jax_stages) == model.cfg.n_layers + 2
    x, jx = params, jp
    for i, (stage, jstage) in enumerate(zip(stages, jax_stages)):
        x, jx = stage(x), jax.jit(jstage)(jx)
        assert x.dtype == (torch.float32 if i == len(stages) - 1 else torch.bfloat16)
        np.testing.assert_allclose(x.float().numpy(), np.asarray(jx, np.float32), err_msg=f"stage {i}", **BF16)
        if i < len(stages) - 1:
            jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # each stage from the port's input
    assert abs(x.item() - float(jx)) < LOSS_TOL_KERNEL_PATH


def _affine(x, y):
    return {"z": x * 2 + y, "s": (x * y).sum()}


@pytest.mark.parametrize("make", [lambda: engines.CompiledEngine(_affine),
                                  lambda: engines.BlockwiseEngine([lambda x, y: x * 2 + y, lambda c, y: c - y])],
                         ids=["compiled", "blockwise"])
def test_static_buffers_copy_in_and_alias_the_outputs(make):
    eng = make()
    g = torch.Generator().manual_seed(0)
    x1, y1, x2, y2 = (torch.randn(3, 4, generator=g) for _ in range(4))
    keep_x1 = x1.clone()
    out1 = eng.run_step(x1, y1)
    first = {k: v.clone() for k, v in out1.items()} if isinstance(out1, dict) else out1.clone()
    out2 = eng.run_step(x2, y2)
    if isinstance(out1, dict):
        assert torch.equal(out2["z"], x2 * 2 + y2) and torch.equal(out2["s"], (x2 * y2).sum())
        assert torch.equal(first["z"], x1 * 2 + y1)
        assert all(out1[k] is out2[k] for k in out1)  # the next call overwrote the first call's outputs
    else:
        assert torch.equal(out2, (x2 * 2 + y2) - y2) and torch.equal(first, (x1 * 2 + y1) - y1)
        assert out1 is out2
    assert torch.equal(x1, keep_x1)  # an argument that is not donated is copied, never written
    assert not eng.captured


@pytest.mark.parametrize("engine", ["compiled", "blockwise"])
@pytest.mark.parametrize("change", ["shape", "dtype", "structure", "value"])
def test_a_call_that_differs_from_the_first_raises(engine, change):
    make = {"compiled": lambda: engines.CompiledEngine(lambda x, n: x * n),
            "blockwise": lambda: engines.BlockwiseEngine([lambda x, n: x * n])}[engine]
    eng = make()
    eng.run_step(torch.ones(2, 3), 2)
    bad = {"shape": (torch.ones(3, 3), 2), "dtype": (torch.ones(2, 3, dtype=torch.float64), 2),
           "structure": ([torch.ones(2, 3)], 2), "value": (torch.ones(2, 3), 3)}[change]
    with pytest.raises(ValueError):
        eng.run_step(*bad)
    assert torch.equal(eng.run_step(torch.full((2, 3), 4.0), 2), torch.full((2, 3), 8.0))  # still usable


def test_a_donated_argument_is_the_static_buffer():
    w = torch.ones(4)
    eng = engines.CompiledEngine(lambda w, x: w * x, donate_argnums=(0,))
    eng.run_step(w, torch.full((4,), 2.0))
    assert eng.static.args[0] is w  # handed over, not copied
    w.mul_(3)  # the caller updates it in place, as the trainer's AdamW does
    assert torch.equal(eng.run_step(w, torch.full((4,), 2.0)), torch.full((4,), 6.0))
    with pytest.raises(ValueError, match="donated"):
        eng.run_step(torch.ones(4), torch.full((4,), 2.0))


class _StubGraph:
    """A graph that records by running the function once, as a capture runs
    the Python, and replays nothing: what the engine's bookkeeping sees."""

    def __init__(self, device):
        self.replays = 0

    def warm_up(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        return fn(*args)

    def replay(self):
        self.replays += 1


def _counting_kernel(x):
    """A stub kernel wrapper: counts two RMSNorm launches and one flash launch."""
    ops.add_launches({"fused_rmsnorm": 2, "flash_attention": 1})
    return x + 1


@pytest.mark.parametrize("engine", ["compiled", "blockwise"])
def test_launches_are_counted_once_per_replay(monkeypatch, engine):
    monkeypatch.setattr(engines, "_CUDAGraph", _StubGraph)
    monkeypatch.setattr(engines, "_uses_graph", lambda device: True)
    monkeypatch.setattr(engines.torch.cuda, "synchronize", lambda *a: None)
    eng = (engines.CompiledEngine(_counting_kernel) if engine == "compiled"
           else engines.BlockwiseEngine([_counting_kernel, _counting_kernel]))
    n_stages = 1 if engine == "compiled" else 2
    ops.reset_launch_counts()
    try:
        eng.run_step(torch.zeros(3))
        assert eng.captured
        # the first call: a warm-up per stage and no replay; the capture ran no kernel
        assert ops.launch_counts()["fused_rmsnorm"] == 2 * n_stages
        for _ in range(3):
            eng.run_step(torch.zeros(3))
        counts = ops.launch_counts()
        assert counts["fused_rmsnorm"] == 2 * (1 + 3) * n_stages and counts["flash_attention"] == (1 + 3) * n_stages
    finally:
        ops.reset_launch_counts()


class _ReplayingStubGraph:
    """A graph whose capture runs the Python but writes nothing (the
    arguments' values are put back, as a capture launches no kernel) and
    whose replay runs the function again on the captured arguments."""

    def __init__(self, device):
        self.fn, self.args = None, ()

    def warm_up(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        self.fn, self.args = fn, args
        leaves = [t for t in pytree.tree_leaves(list(args)) if isinstance(t, torch.Tensor)]
        saved = [t.clone() for t in leaves]
        out = fn(*args)
        for t, v in zip(leaves, saved):
            t.copy_(v)
        return out

    def replay(self):
        self.fn(*self.args)


@pytest.mark.parametrize("engine", ["eager", "compiled", "blockwise"])
def test_the_first_call_runs_an_in_place_function_once(monkeypatch, engine):
    """A function that writes its argument in place (as AdamW does) takes one
    step a call, the first included: x.add_(1) leaves 1, then 2."""
    monkeypatch.setattr(engines, "_CUDAGraph", _ReplayingStubGraph)
    monkeypatch.setattr(engines, "_uses_graph", lambda device: True)
    monkeypatch.setattr(engines.torch.cuda, "synchronize", lambda *a: None)

    def bump(x):
        return x.add_(1)

    eng = {"eager": lambda: engines.EagerEngine(bump),
           "compiled": lambda: engines.CompiledEngine(bump, donate_argnums=(0,)),
           "blockwise": lambda: engines.BlockwiseEngine([bump], donate_argnums=(0,))}[engine]()
    x = torch.zeros(4)
    eng.run_step(x)
    assert torch.equal(x, torch.ones(4))
    eng.run_step(x)
    assert torch.equal(x, torch.full((4,), 2.0))


def test_compare_engines_rows_have_the_jax_keys_with_torch_frames():
    from repro.core import SamplerConfig as JaxSamplerConfig
    from repro.core import StackSampler as JaxStackSampler
    from repro_torch.core import SamplerConfig, StackSampler

    def slow(x):
        s = 0.0
        for i in range(20000):
            s += i
        return x + s

    jax_rows = jax_engines.compare_engines([jax_engines.EagerEngine(lambda x: x + 1)], 2, lambda i: (jnp.ones(3),),
                                           lambda: JaxStackSampler(JaxSamplerConfig(period_s=0.001)))
    rows = engines.compare_engines([engines.EagerEngine(slow), engines.CompiledEngine(slow)], 20,
                                   lambda i: (torch.ones(3),), lambda: StackSampler(SamplerConfig(period_s=0.001)))
    want = {"torch_frame_share" if k == "jax_frame_share" else k for k in jax_rows[0]} | {"captured"}
    assert "jax_frame_share" in jax_rows[0]
    assert [r["engine"] for r in rows] == ["eager", "compiled"]
    for r in rows:
        assert set(r) == want and r["captured"] is False and 0 <= r["torch_frame_share"] <= 1
    assert set(engines.compare_engines([engines.EagerEngine(slow)], 1, lambda i: (torch.ones(3),))[0]) == {
        "engine", "steps", "wall_s", "steps_per_s", "captured"}
