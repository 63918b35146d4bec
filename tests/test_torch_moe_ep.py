"""The port's expert-parallel MoE (``repro_torch.models.moe_shard_map``)
against the JAX package's ``moe_shard_map`` and against the port's dense MoE,
on the CPU at the smoke config of deepseek-moe-16b:

* ``_local_capacity`` is JAX's;
* the one-process simulation of a (2 data, 2 model) mesh against JAX's
  ``moe_shard_map`` on 4 forced CPU devices, (2, 2), computed once in a
  subprocess (device-count forcing must precede JAX's start), at capacity 8
  and at the default (which drops): the output, the aux values and the
  gradients of ``(y . r).sum() + lb_loss`` in x, the router, wi, wg and wo,
  the port's summed over its data ranks as JAX's ``shard_map`` sums them;
* four gloo ranks (one spawn, a ``FileStore`` in ``tmp_path``) equal the
  simulation to the bit, forward and backward; ``Model.loss`` with
  ``moe_impl="shard_map"`` on them equals the one-process dense model at
  capacity 8, and the bytes a rank exchanged are the dry-run's formula;
* at capacity 8 the simulation equals the dense ``moe``; ``_apply_moe``
  takes the dense path, to the bit, without a context, without a ``model``
  axis and where the experts do not divide by it.

Tolerances: tests/test_kernels.py's, f32 2e-5 and bf16 2e-2, relative to
each value and, for the gradients, absolute scaled by the gradient's largest
entry (a gradient sums many products in another order).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_moe_ep_ranks as ranks
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import Model
from repro_torch.models import moe_shard_map as tep
from repro_torch.models.modules import init_params, tree_leaves
from repro_torch.models.moe import moe, moe_spec
from repro_torch.models.transformer import _apply_moe
from repro_torch.params import expert_slice
from repro_torch.sharding import sharding_ctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
CAPACITIES = {"8": 8.0, "default": None}
GRADS = ("x", "router", "wi", "wg", "wo")
# Model.loss with EP on the gloo ranks against the dense model, bf16
# activations: each data rank's weight gradient is a bf16 product rounded on
# its own, where the dense model rounds the sum over both data shards once,
# so the gradients part by about a bf16 rounding a layer. Measured: the loss
# 4.7e-8 relative, a gradient at most 1.07e-2 relative L2 (a key projection
# of layer 0); the bounds are chip_smoke.py's for the same check on the card.
MODEL_LOSS_REL = 1e-3
MODEL_GRAD_REL_L2 = 2e-2
N_RANKS = ranks.N_DATA * ranks.N_MODEL

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from repro.configs import get_config
from repro.models.moe_shard_map import moe_shard_map
from repro.launch.mesh import axis_types_kw

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 2), ("data", "model"), **axis_types_kw(2))
base = get_config(sys.argv[3], smoke=True)
out = {}
for cf in ("8", "default"):
    cfg = base if cf == "default" else replace(base, capacity_factor=float(cf))
    for dt in ("float32", "bfloat16"):
        jdt = getattr(jnp, dt)
        p = {}
        for key, a in inp.items():
            if key.startswith(dt + "/p/"):
                node, path = p, key.split("/")[2:]
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = jnp.asarray(a, jdt)
        x, r = jnp.asarray(inp[dt + "/x"], jdt), jnp.asarray(inp[dt + "/r"])

        def f(p, x):
            y, aux = moe_shard_map(p, x, cfg, mesh=mesh, data_axes=("data",))
            return (y.astype(jnp.float32) * r).sum() + aux["lb_loss"], (y, aux)

        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
        res = {"y": y, "x": gx, "router": gp["router"]["w"], "wi": gp["wi"], "wg": gp["wg"], "wo": gp["wo"], **aux}
        for k, v in res.items():
            out[f"{cf}/{dt}/{k}"] = np.asarray(jnp.asarray(v, jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _jax_package_ep():
    """The JAX package's ``moe_shard_map`` module; only the tests held to JAX
    skip where it is missing (the card's machine has none)."""
    pytest.importorskip("jax")
    from repro.models import moe_shard_map

    return moe_shard_map


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, tol: float, *, grad: bool = False, what: str = ""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = tol * (max(1.0, float(np.abs(want).max())) if grad else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX's moe_shard_map on 4 forced CPU devices at both capacities and
    dtypes, on the inputs of ``ranks.layer_inputs``."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("jax_ep")
    inp = {}
    for dtype in ranks.DTYPES:
        name = str(dtype).removeprefix("torch.")
        _, params, x, r = ranks.layer_inputs(dtype)
        inp.update({f"{name}/p/" + "/".join(path): _f32(a) for path, a in tree_leaves(params)})
        inp[f"{name}/x"], inp[f"{name}/r"] = _f32(x), _f32(r)
    np.savez(d / "in.npz", **inp)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"), str(d / "out.npz"), ranks.ARCH],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _rank(d: int, m: int) -> int:
    return d * ranks.N_MODEL + m


def _global_grads(grads: list) -> dict:
    """Each rank's gradients -> the global ones: x by data shard, the router
    summed over the data ranks, the experts summed over them and put back
    together over the model ranks."""
    nd, nm = ranks.N_DATA, ranks.N_MODEL
    out = {"x": torch.cat([grads[_rank(d, 0)]["x"] for d in range(nd)]),
           "router": sum(grads[_rank(d, 0)]["router"].float() for d in range(nd))}
    for n in ("wi", "wg", "wo"):
        out[n] = torch.cat([sum(grads[_rank(d, m)][n].float() for d in range(nd)) for m in range(nm)])
    return out


def test_local_capacity_is_the_jax_packages():
    jep = _jax_package_ep()
    for arch in ("deepseek-moe-16b", "qwen3-moe-235b-a22b"):
        for cf in (0.5, 1.25, 8.0):
            cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
            for t_loc in (1, 2, 7, 16, 64, 100, 511, 2048, 4096):
                assert tep._local_capacity(t_loc, cfg) == jep._local_capacity(t_loc, cfg), (arch, cf, t_loc)
    assert tep._local_capacity(2048, get_config("deepseek-moe-16b")) == 244
    assert tep._local_capacity(2048, get_config("qwen3-moe-235b-a22b")) == 164


@pytest.mark.parametrize("dtype", ranks.DTYPES, ids=str)
@pytest.mark.parametrize("cap", list(CAPACITIES))
def test_simulation_matches_jax_shard_map_on_four_devices(jax_ep, cap, dtype):
    ys, aux, grads = ranks.simulate_layer(dtype, CAPACITIES[cap])
    key = f"{cap}/{str(dtype).removeprefix('torch.')}/"
    tol = TOL[dtype]
    y = torch.cat([ys[_rank(d, 0)] for d in range(ranks.N_DATA)])
    _close(_f32(y), jax_ep[key + "y"], tol, what="y")
    for a in aux:  # every rank holds the same aux
        _close(_f32(a["lb_loss"]), jax_ep[key + "lb_loss"], tol, what="lb_loss")
        _close(_f32(a["expert_frac"]), jax_ep[key + "expert_frac"], tol, what="expert_frac")
        assert float(a["dropped_frac"]) == pytest.approx(float(jax_ep[key + "dropped_frac"]), abs=1e-7)
    assert (float(aux[0]["dropped_frac"]) > 0) == (cap == "default")
    g = _global_grads(grads)
    for n in GRADS:
        _close(_f32(g[n]), jax_ep[key + n], tol, grad=True, what=n)


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """``ranks.gloo_rank`` on four spawned processes, once: rank -> results."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=ranks.gloo_rank, args=(r, N_RANKS, store, out)) for r in range(N_RANKS)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert all(err is None for _, _, err in results), [err for _, _, err in results]
    return {r: res for r, res, _ in results}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ranks.DTYPES, ids=str)
def test_four_gloo_ranks_equal_the_simulation_to_the_bit(gloo_ranks, dtype):
    ys, aux, grads = ranks.simulate_layer(dtype)
    for r in range(N_RANKS):
        got = gloo_ranks[r]["layer"][str(dtype)]
        want = {"y": ys[r], **aux[r], **grads[r]}
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], _bits(w), err_msg=f"rank {r} {k}")


def test_the_gloo_ranks_import_nothing_of_the_jax_package(gloo_ranks):
    assert not any(res["imports_repro"] for res in gloo_ranks.values())


def _model_grads(tree: dict) -> dict:
    return dict(tree_leaves(tree))


def test_model_loss_on_four_gloo_ranks_equals_the_dense_model(gloo_ranks):
    cfg, params, batch = ranks.model_inputs()
    dense_cfg = dataclasses.replace(cfg, moe_impl="dense")
    leaves = ranks._leaves(params)
    loss, _ = Model(dense_cfg, device="cpu").loss(leaves, batch)
    loss.backward()
    want = {p: a.grad for p, a in tree_leaves(leaves)}
    nd, nm = ranks.N_DATA, ranks.N_MODEL
    losses = [float(gloo_ranks[_rank(d, 0)]["model"]["loss"]) for d in range(nd)]
    assert abs(sum(losses) / nd - float(loss.detach())) <= MODEL_LOSS_REL * abs(float(loss.detach()))
    spec = dict(tree_leaves(Model(cfg, device="meta").spec()))
    rank_grads = [_model_grads(gloo_ranks[r]["model"]["grads"]) for r in range(N_RANKS)]
    for path, w in want.items():
        logical = spec[path].logical
        lead = 1 if logical[0] == "layers" else 0
        expert_axis = lead if logical[lead] == "expert" else None
        by_m = [sum(torch.from_numpy(rank_grads[_rank(d, m)][path]) for d in range(nd)) / nd for m in range(nm)]
        if expert_axis is None:  # replicated over model: every model rank holds the same gradient
            assert all(torch.equal(by_m[0], g) for g in by_m[1:]), path
            got = by_m[0]
        else:
            got = torch.cat(by_m, dim=expert_axis)
        rel = float((got - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= MODEL_GRAD_REL_L2, (path, rel)


def test_the_exchanged_bytes_are_the_dry_runs_formula(gloo_ranks):
    cfg, _, batch = ranks.model_inputs()
    B, S = batch["tokens"].shape
    mesh = MeshShape(("data", "model"), (ranks.N_DATA, ranks.N_MODEL))
    cell = dryrun.run_cell(cfg, ShapeSpec("train_smoke", S, B, "train"), mesh=mesh, verbose=False)
    assert cell["status"] == "ok", cell.get("error")
    counted = {gloo_ranks[r]["model"]["exchanged_bytes"] for r in range(N_RANKS)}
    assert counted == {cell["collectives"]["all-to-all"]}, (counted, cell["collectives"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_at_capacity_8_the_simulation_equals_the_dense_moe(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), capacity_factor=8.0)
    g = torch.Generator().manual_seed(0)
    params = init_params(moe_spec(cfg), g)
    x = torch.randn((ranks.B, ranks.S, cfg.d_model), generator=g)
    want, want_aux = moe(params, x, cfg)
    leaves = [expert_slice(params, moe_spec(cfg), i % ranks.N_MODEL, ranks.N_MODEL) for i in range(N_RANKS)]
    ys, aux = tep.simulate(leaves, [ranks.data_shard(x, i) for i in range(N_RANKS)], cfg,
                           n_data=ranks.N_DATA, n_model=ranks.N_MODEL)
    got = torch.cat([ys[_rank(d, 0)] for d in range(ranks.N_DATA)])
    _close(_f32(got), _f32(want), TOL[torch.float32], what="y")
    assert float(aux[0]["dropped_frac"]) == 0.0
    _close(_f32(aux[0]["lb_loss"]), _f32(want_aux["lb_loss"]), TOL[torch.float32], what="lb_loss")


@pytest.mark.parametrize("mesh", [None, MeshShape(("data",), (2,)), MeshShape(("data", "model"), (1, 3))],
                         ids=["no_context", "no_model_axis", "experts_do_not_divide"])
def test_apply_moe_takes_the_dense_path_to_the_bit(mesh):
    cfg, params, x, _ = ranks.layer_inputs(torch.bfloat16)
    cfg = dataclasses.replace(cfg, moe_impl="shard_map")
    want, want_aux = moe(params, x, cfg)
    if mesh is None:
        got, aux = _apply_moe(params, x, cfg)
    else:
        with sharding_ctx(mesh, ranks.RULES):
            got, aux = _apply_moe(params, x, cfg)
    assert torch.equal(got, want)
    assert all(torch.equal(aux[k], want_aux[k]) for k in want_aux)


def test_one_model_rank_exchanges_nothing_and_needs_no_process_group():
    cfg, params, x, _ = ranks.layer_inputs(torch.float32)
    cfg = dataclasses.replace(cfg, moe_impl="shard_map")
    tep.reset_exchanged_bytes()
    with sharding_ctx(MeshShape(("data", "model"), (1, 1)), ranks.RULES):
        got, aux = _apply_moe(params, x, cfg)
    (want,), (want_aux,) = tep.simulate([params], [x], cfg, n_data=1, n_model=1)
    assert torch.equal(got, want) and torch.equal(aux["lb_loss"], want_aux["lb_loss"])
    assert tep.exchanged_bytes() == 0


def test_more_model_ranks_without_a_process_group_raise():
    cfg, params, x, _ = ranks.layer_inputs(torch.float32)
    with pytest.raises(RuntimeError, match="process group"):
        tep.moe_shard_map(ranks.rank_leaves(params, cfg, 0), x, cfg,
                          mesh=MeshShape(("data", "model"), (1, 2)), data_axes=("data",))

