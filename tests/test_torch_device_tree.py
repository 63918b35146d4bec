"""The port's device tree (``repro_torch.core.device_tree``) against the JAX
package's (``repro.core.hlo_tree``) on the CPU, and the rules of ``build_device_tree``.

The JAX tree costs the compiled train step by ``op_name`` path; the port's
is built from a ``torch.profiler`` run of one step of ``make_train_step`` at
the same smoke config and shape (B 2 x S 32; the weights carried over by
``params_from_numpy``). Both count a dot's FLOPs as 2 M N K, so the trees
must agree to 1e-6 relative, path by path, once XLA's loop levels
(``while/body/closed_call``), the ``jit(...)`` head and the leaf ops (the
einsum strings, ``dot``; the aten ops) are dropped. The differences that
remain are stated, each with its reason, and counted exactly:

* **Attention's core.** The JAX step trains through its xla attention
  (``scores``, ``pv``: the Pallas kernel has no gradient); the port through
  its flash kernel, under the wrapper's ``flash_attention`` range, whose
  plain version computes the same two products in the forward. Its backward
  recomputes the scores, as every flash backward does: five S x T x D
  products against the two of the forward, where JAX's transposed pair makes
  four. So the port's backward ``flash_attention`` holds 5/4 of JAX's
  backward ``scores`` + ``pv``.
* **The hybrid's windowed attention** loses its ``op_name`` in the compiled
  JAX step: its dots sit under ``<unattributed>``; they equal the port's
  ``flash_attention`` (its backward at 4/5).
* **Remat "full".** Neither recompute (``rematted_computation``) runs the
  unit's last product (``down_proj``), whose output the backward does not
  need: XLA removes it; ``torch.utils.checkpoint`` stops its recompute inside
  that op's autograd kernel, once it saves its input (the unit's last saved
  tensor), before the product runs. The profiler has opened the op's event by
  then, and the port's tree leaves it out (``device_tree._stopped``), so the
  two trees agree there without a correction.
* **xLSTM's two loops.** Inside the mLSTM's ``chunk_scan`` the three-operand
  einsums contract in another order, and the chunk's recompute reruns what
  XLA leaves out; the sLSTM's backward does not differentiate the zero
  initial state (autograd skips a gradient nothing needs; JAX's transposed
  scan computes it). Outside the two loops the xLSTM trees agree path by
  path; inside, the totals agree within ``XLSTM_SCAN_REL``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import tree_from_compiled  # noqa: E402
from repro.core.hlo_tree import load_device_tree as jax_load_device_tree  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.calltree import CallTree  # noqa: E402
from repro_torch.core.device_tree import (  # noqa: E402
    DEVICE_TREE_SCHEMA,
    build_device_tree,
    load_device_tree,
    profiling,
    save_device_tree,
    tree_from_profile,
)
from repro_torch.core.scope import kernel_launch, parse_kernel_launch, recording, scope  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

B, S = 2, 32
REL = 1e-6  # both count 2 M N K; the sums are of exact integers in f64
XLSTM_SCAN_REL = 0.05  # measured 0.034 (chunk_scan) and 0.010 (time_scan) at xlstm-125m smoke
CASES = [
    pytest.param("qwen3-4b", None, id="qwen3-4b"),
    pytest.param("qwen3-4b", "full", id="qwen3-4b-remat-full"),
    pytest.param("deepseek-moe-16b", None, id="deepseek-moe-16b"),
    pytest.param("recurrentgemma-9b", None, id="recurrentgemma-9b"),
    pytest.param("xlstm-125m", None, id="xlstm-125m"),
]
FORWARD, BACKWARD = "jvp(loss)", "transpose(jvp(loss))"
XLA_LEVELS = {"while", "body", "closed_call"}
XLSTM_SCANS = ("chunk_scan", "time_scan")


def _jax_scopes(path: tuple[str, ...]) -> tuple[str, ...]:
    """A JAX op path without the jit head, XLA's loop levels and the op itself."""
    out = []
    for name in path:
        if name.startswith("jit(") and not out:
            continue
        if "->" in name or name in ("dot", "dot_general", "convolution"):
            break
        if name not in XLA_LEVELS:
            out.append(name)
    return tuple(out)


def _port_scopes(path: tuple[str, ...]) -> tuple[str, ...]:
    """A port op path without its leaf (an aten op or a kernel launch)."""
    out = []
    for name in path:
        if name.startswith("aten::") or name.startswith("kernel:"):
            break
        out.append(name)
    return tuple(out)


def _flops_by_scope(tree: CallTree, scopes) -> dict[tuple[str, ...], float]:
    out: dict[tuple[str, ...], float] = {}
    for path, node in tree.root.walk():
        f = node.self_metrics.get("flops", 0.0)
        if f and node is not tree.root:
            key = scopes(path[1:])
            out[key] = out.get(key, 0.0) + f
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch: str, remat: str | None):
    """(the JAX tree's flops by scope path, the port's, the port's tree, its model) at ``arch``'s smoke config."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if remat:
        jcfg, cfg = dataclasses.replace(jcfg, remat=remat), dataclasses.replace(cfg, remat=remat)
    jm = JaxModel(jcfg)
    params = jm.abstract_params()
    shape = type("Shape", (), {"kind": "train", "global_batch": B, "seq_len": S})()
    jstep = jax_train_step(jm, jax_cosine(1e-3), JaxAdamWConfig())
    jtree = tree_from_compiled(jax.jit(jstep).lower(params, jax.eval_shape(jax_adamw_init, params),
                                                    jm.input_specs(shape)).compile())
    weights = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tp = params_from_numpy(weights, cfg, "cpu", train=True)
    model = Model(cfg, device="cpu")
    step = make_train_step(model, cosine_schedule(1e-3), AdamWConfig())
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)) for k in ("tokens", "labels")}
    _, ptree = tree_from_profile(lambda: step(tp, adamw_init(tp), batch), device="cpu")
    return _flops_by_scope(jtree, _jax_scopes), _flops_by_scope(ptree, _port_scopes), ptree, model


def _in_jax_terms(arch: str, jax_paths: dict, port_paths: dict) -> tuple[dict, dict, dict]:
    """The two trees' flops by scope path with the stated differences taken
    out: -> (JAX's, the port's, what was taken out, by name)."""
    j, p = dict(jax_paths), {}
    taken: dict[str, float] = {}
    core = ("scores", "pv")
    for path, f in port_paths.items():
        if path and path[-1] == "flash_attention" and BACKWARD in path and "rematted_computation" not in path:
            taken["flash_recomputed_scores"] = taken.get("flash_recomputed_scores", 0.0) + f / 5
            f *= 4 / 5  # the flash backward's five products against JAX's four
        p[path] = p.get(path, 0.0) + f
    for path in list(j):
        if path and path[-1] in core:  # JAX's xla attention core -> the flash kernel's range
            key = path[:-1] + ("flash_attention",)
            j[key] = j.get(key, 0.0) + j.pop(path)
    if arch == "recurrentgemma-9b":  # the windowed attention's dots lost their op_name in JAX's step
        taken["jax_unattributed"] = j.pop(("<unattributed>",))
        taken["port_flash"] = sum(f for path, f in p.items() if path[-1:] == ("flash_attention",))
        p = {path: f for path, f in p.items() if path[-1:] != ("flash_attention",)}
    if arch == "xlstm-125m":
        for scan in XLSTM_SCANS:
            taken[f"jax_{scan}"] = sum(j.pop(path) for path in [q for q in j if scan in q])
            taken[f"port_{scan}"] = sum(p.pop(path) for path in [q for q in p if scan in q])
    return j, p, taken


def _flatten(paths: dict) -> dict[str, float]:
    out: dict[str, float] = {}
    for path, f in paths.items():
        for name in set(path):
            out[name] = out.get(name, 0.0) + f
    return out


@pytest.mark.parametrize("arch,remat", CASES)
def test_total_flops_equal_the_jax_trees(arch, remat):
    jax_paths, port_paths, ptree, _ = _trees(arch, remat)
    j, p, taken = _in_jax_terms(arch, jax_paths, port_paths)
    assert math.isclose(sum(p.values()), sum(j.values()), rel_tol=REL), (sum(p.values()), sum(j.values()), taken)
    assert math.isclose(ptree.total("flops"), sum(port_paths.values()), rel_tol=REL)
    if remat:  # the recompute stops inside the units' down_proj, which never runs: no flops of it there
        assert any("rematted_computation" in path for path in port_paths)
        assert not [path for path in port_paths if "rematted_computation" in path and path[-2:] == ("mlp", "down_proj")]
    if arch == "recurrentgemma-9b":  # JAX's lost attention dots are the flash kernel's products (in JAX's count)
        assert math.isclose(taken["jax_unattributed"], taken["port_flash"], rel_tol=REL)
    if arch == "xlstm-125m":
        for scan in XLSTM_SCANS:
            assert taken[f"port_{scan}"] == pytest.approx(taken[f"jax_{scan}"], rel=XLSTM_SCAN_REL)


@pytest.mark.parametrize("arch,remat", CASES)
def test_every_shared_component_has_the_jax_flops(arch, remat):
    """Path by path, and so for every component name both trees have
    (``lm_head``, ``mlp``, ``qkv_proj``, ``out_proj``, ``experts``,
    ``in_proj``, ...), flattened."""
    j, p, _ = _in_jax_terms(arch, *_trees(arch, remat)[:2])
    assert set(p) == set(j)
    for path in j:
        assert math.isclose(p[path], j[path], rel_tol=REL), (path, p[path], j[path])
    fj, fp = _flatten(j), _flatten(p)
    shared = set(fj) & set(fp)
    assert {"lm_head", "model", FORWARD, BACKWARD} <= shared
    for name in shared:
        assert math.isclose(fp[name], fj[name], rel_tol=REL), (name, fp[name], fj[name])


@pytest.mark.parametrize("arch,remat", CASES)
def test_component_names_are_the_jax_scopes(arch, remat):
    jax_paths, port_paths, _, _ = _trees(arch, remat)
    names_j = {n for path in jax_paths for n in path} - {"scores", "pv", "<unattributed>"}
    names_p = {n for path in port_paths for n in path} - {"flash_attention"}
    assert names_p == names_j
    if arch != "recurrentgemma-9b":
        assert ({n for path in jax_paths for n in path} >= {"scores", "pv"}) == (
            "flash_attention" in {n for path in port_paths for n in path})


@pytest.mark.parametrize("arch,remat", CASES)
def test_backward_holds_twice_the_forward_where_jax_does(arch, remat):
    """For every component whose backward dot flops are 2 x its forward's in
    the JAX tree, the port's are too; and the backward ops sit under the
    forward's components (the branches have the same component names)."""
    j, p, _ = _in_jax_terms(arch, *_trees(arch, remat)[:2])

    def by_branch(paths, branch):
        return _flatten({q: f for q, f in paths.items() if branch in q})

    jf, jb, pf, pb = by_branch(j, FORWARD), by_branch(j, BACKWARD), by_branch(p, FORWARD), by_branch(p, BACKWARD)
    twice = [n for n in jf if n != FORWARD and math.isclose(jb.get(n, 0.0), 2 * jf[n], rel_tol=REL)]
    assert twice
    for name in twice:
        assert math.isclose(pb.get(name, 0.0), 2 * pf[name], rel_tol=REL), (name, pb.get(name), pf[name])
    assert set(pf) - {FORWARD} <= set(pb)


def test_flash_backward_holds_five_products_and_the_forward_two():
    """The port's own count beside JAX's: at qwen3-4b smoke the forward's
    ``flash_attention`` equals JAX's ``scores`` + ``pv`` and the backward's is
    5/4 of JAX's transposed pair."""
    jax_paths, port_paths, _, _ = _trees("qwen3-4b", None)

    def core(paths, names, branch):
        return sum(f for q, f in paths.items() if q[-1:][0] in names and branch in q)

    assert core(port_paths, ("flash_attention",), FORWARD) == core(jax_paths, ("scores", "pv"), FORWARD) > 0
    assert math.isclose(core(port_paths, ("flash_attention",), BACKWARD),
                        1.25 * core(jax_paths, ("scores", "pv"), BACKWARD), rel_tol=REL)


def test_remat_recompute_lands_in_the_backward_branch():
    """Under remat "full" the checkpoint's recompute sits under
    ``transpose(jvp(loss))/.../checkpoint/rematted_computation``, as the JAX
    tree's does, and the forward branch keeps no ``checkpoint`` level."""
    jax_paths, port_paths, _, _ = _trees("qwen3-4b", "full")
    for paths in (jax_paths, port_paths):
        remat = [q for q in paths if "rematted_computation" in q]
        assert remat and all(BACKWARD in q and q[q.index("rematted_computation") - 1] == "checkpoint" for q in remat)
        assert not [q for q in paths if FORWARD in q and "checkpoint" in q]
    fwd = sum(f for q, f in port_paths.items() if FORWARD in q)
    assert fwd == sum(f for q, f in jax_paths.items() if FORWARD in q)


def test_the_tree_holds_no_device_time_on_the_cpu():
    _, _, ptree, _ = _trees("qwen3-4b", None)
    assert not ptree.total("device_ms") and not ptree.total("kernels")
    assert ptree.total("ops") > 0 and ptree.total("bytes") > 0


def test_bytes_of_known_traffic():
    """At least the input, read once, and not wildly more (the JAX tree's
    test: tests/test_hlo_tree.py, test_bytes_metric_positive_and_sane)."""
    x = torch.ones((1024, 1024), dtype=torch.float32)
    _, tree = tree_from_profile(lambda: (x * 2.0).sum(), device="cpu")
    b = tree.total("bytes")
    assert b >= x.numel() * 4
    assert b < 20 * x.numel() * 4


def test_views_move_no_bytes_and_launch_nothing():
    x = torch.ones((64, 64))
    _, tree = tree_from_profile(lambda: x.reshape(4096).unsqueeze(0).expand(3, 4096).t(), device="cpu")
    assert tree.total("ops") == 0 and tree.total("bytes") == 0


def test_in_place_ops_count_their_operand_written():
    x, y = torch.ones(1000), torch.ones(1000)
    _, tree = tree_from_profile(lambda: x.add_(y), device="cpu")
    assert tree.total("bytes") == 3 * 4000  # x and y read, x written
    _, tree = tree_from_profile(lambda: x.copy_(y), device="cpu")
    assert tree.total("bytes") == 2 * 4000  # y read, x written


def test_matmul_flops_are_two_m_n_k():
    a, b = torch.ones((8, 16)), torch.ones((16, 32))
    with profiling("cpu") as prof:
        with scope("head"):
            a @ b
    tree = build_device_tree(prof)
    assert tree.flatten("flops")["head"] == 2 * 8 * 16 * 32


def test_a_custom_function_backward_lands_under_its_forward_scope():
    """The backward node of an ``autograd.Function`` (as the kernel wrappers'
    are) carries its forward's sequence number: its ops land under the
    forward's path with the differentiated scope renamed, and a range the
    backward enters again continues that path."""

    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            with scope("kernel_range"):
                return g.matmul(torch.eye(g.shape[-1]))

    w = torch.ones((4, 4), requires_grad=True)
    with profiling("cpu") as prof:
        with scope("fwd_bwd"):
            with scope("loss"):
                with scope("kernel_range"):
                    y = Double.apply(w)
                loss = y.sum()
            loss.backward()
    tree = build_device_tree(prof)
    paths = {p[1:] for p, n in tree.root.walk() if n.self_metrics.get("flops")}
    assert paths == {("fwd_bwd", "transpose(jvp(loss))", "kernel_range", "aten::matmul")}


def test_accumulate_grad_takes_the_path_of_the_node_before_it():
    w = torch.ones((4, 4), requires_grad=True)
    w.grad = torch.zeros((4, 4))  # an accumulation into a buffer, as the train step's views
    with profiling("cpu") as prof:
        with scope("fwd_bwd"):
            with scope("loss"):
                with scope("proj"):
                    y = w @ torch.ones((4, 4))
                loss = y.sum()
            loss.backward()
    tree = build_device_tree(prof)
    leaves = {p[1:] for p, n in tree.root.walk() if not n.children}
    assert any(q[:3] == ("fwd_bwd", "transpose(jvp(loss))", "proj") and q[-1] == "aten::add_" for q in leaves)
    assert ("<unattributed>",) not in {q[:1] for q in leaves}


def test_kernel_launch_marks_its_work_as_a_leaf():
    with profiling("cpu") as prof:
        with scope("flash_attention"):
            with kernel_launch("flash_attention", lambda: (100.0, 40.0)):
                pass
    tree = build_device_tree(prof)
    node = tree.root.children["flash_attention"].children["kernel:flash_attention"]
    assert node.metrics == {"ops": 1.0, "flops": 100.0, "bytes": 40.0}
    assert parse_kernel_launch("kernel:rglru_scan_bwd[flops=0.0,bytes=12.5]") == ("rglru_scan_bwd", 0.0, 12.5)
    assert parse_kernel_launch("flash_attention") is None


def test_kernel_launch_does_not_compute_its_work_without_a_profiler():
    def work():
        raise AssertionError("work() called with no profiler recording")

    with kernel_launch("fused_rmsnorm", work):
        pass
    assert not recording()


def test_save_and_load_roundtrip_in_the_jax_schema(tmp_path):
    _, _, ptree, model = _trees("qwen3-4b", None)
    path = str(tmp_path / "device_tree.json")
    save_device_tree(ptree, path, meta={"arch": model.cfg.name, "source": "train"})
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema"] == DEVICE_TREE_SCHEMA == "repro-device-tree/v1"
    assert doc["meta"] == {"arch": model.cfg.name, "source": "train"}
    back = load_device_tree(path)
    assert back.root == ptree.root
    assert jax_load_device_tree(path).to_json() == ptree.to_json()  # the JAX package reads the port's file


# The flash backward's recomputed scores raise the port's attention share
# (0.009 at qwen3-4b smoke); the hybrid's JAX tree loses its attention dots
# to <unattributed> (0.020)
SHARE_ABS = 0.025


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b", "recurrentgemma-9b", "xlstm-125m"])
def test_breakdown_shares_follow_the_jax_benchmark(arch):
    """``repro_torch.benchmarks.fig08_11_breakdown.component_shares`` on the
    port's tree gives the components and flops shares that the JAX package's
    ``benchmarks/fig08_11_breakdown.py`` rule gives on its tree."""
    from repro_torch.benchmarks.fig08_11_breakdown import COMPONENTS, component_shares

    jax_paths, _, ptree, _ = _trees(arch, None)
    jtree = CallTree()
    for path, f in jax_paths.items():
        jtree.add_stack(list(path), {"flops": f})
    want = {c: jtree.zoom(lambda n, c=c: n.startswith(c)).total("flops") / jtree.total("flops") for c in COMPONENTS}
    got = component_shares(ptree, "flops")
    assert set(got) == {c for c, v in want.items() if v > 0.005}
    for comp, share in got.items():
        assert share == pytest.approx(want[comp], abs=SHARE_ABS), comp


def test_breakdown_cli_on_the_cpu(capsys):
    from repro_torch.benchmarks.fig08_11_breakdown import main

    rows = main(["--device", "cpu", "--arch", "qwen3-4b"])
    assert len(rows) == 1 and rows[0].startswith("fig08_11_breakdown_qwen3-4b,")
    shares = dict(kv.split("=") for kv in rows[0].split(",", 2)[2].split(";"))
    assert set(shares) == {"flops.attention", "flops.mlp", "flops.lm_head"}
    assert sum(float(v) for v in shares.values()) == pytest.approx(1.0, abs=0.02)
    assert capsys.readouterr().out.strip() == rows[0]
