"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and its plan against real CPU steps.

* every (arch, shape): the skip cells and their reasons equal JAX's
  ``run_cell``; ``input_specs``, ``model_flops``, the parameter counts and
  the decode state's shapes equal JAX's ``Model``'s;
* on the host mesh of one device at full width (meta tensors: no memory):
  qwen3-4b's state is 16 bytes a parameter and fits; recurrentgemma-9b at
  1 x 4096 fits at 8 layers and not at 11 (it ran out of memory on an H100);
* at smoke size the plan's flops are a profiled CPU step's device tree's (the
  plan traced through the kernels' plain versions, as the CPU runs them),
  and its kernel calls are the CPU step's calls of each kernel's plain
  version;
* on the (16, 16) mesh: ``ddp`` keeps the whole state on every device, and
  qwen3-4b's ``tp_fsdp`` ranks together do 1.0-1.25 x the single device's
  work at the same global shape (the 8 KV heads, replicated over a model
  axis of 16, are the redundancy);
* ``--moe-impl shard_map`` plans the expert-parallel MoE with its
  all-to-all from the formula; ``--chunk-threshold`` changes no number;
  ``--attn-cp`` divides the attention kernel's work by the model axis where
  the query heads do not divide it (gemma-2b) and changes nothing where
  they do (qwen3-4b); the CLI writes a cell file per (arch, shape, mesh)
  with the JAX package's keys and exits 1 on a fail; ``roofline`` reads its
  files.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from _jax_dryrun import jax_dryrun  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs  # noqa: E402
from repro_torch.core.device_tree import tree_from_profile  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule  # noqa: E402
from repro_torch.sharding import make_strategy  # noqa: E402

ONE = MeshShape(("data", "model"), (1, 1))
CELLS = [(a, s) for a in list_archs() for s in SHAPES]
# the four train kinds (dense, hybrid, MoE, xLSTM), remat "full" as their full configs
SMOKE_TRAIN = ("qwen3-4b", "recurrentgemma-9b", "deepseek-moe-16b", "xlstm-125m")
FLOPS_REL = 0.03  # the plan's flops against the device tree's (they agree exactly on the CPU)
TP_REDUNDANCY = (1.0, 1.25)  # the ranks' summed work over one device's at the same global shape
JAX_KEYS_RENAMED = {"lower_s", "compile_s"}  # JAX's two times; the port's one is trace_s


def test_the_archs_and_shapes_are_the_jax_packages():
    assert list_archs() == jax_list_archs()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_cells_and_model_specs_match_jax(arch, shape):
    jm, model = JaxModel(jax_config(arch)), Model(get_config(arch), device="meta")
    jshape, pshape = JAX_SHAPES[shape], SHAPES[shape]
    from repro.configs import shape_applicable as jax_applicable
    from repro_torch.configs import shape_applicable

    assert shape_applicable(get_config(arch), pshape) == jax_applicable(jax_config(arch), jshape)
    if not jax_applicable(jax_config(arch), jshape)[0]:  # JAX's run_cell returns before any lowering
        for multi in (False, True):
            assert dryrun.run_cell(arch, shape, multi, verbose=False) == jax_dryrun().run_cell(
                arch, shape, multi, verbose=False)
    jin, pin = jm.input_specs(jshape), model.input_specs(pshape)
    assert set(jin) == set(pin)
    for k in jin:
        assert tuple(pin[k].shape) == tuple(jin[k].shape) and pin[k].device.type == "meta"
        assert str(pin[k].dtype).removeprefix("torch.") == str(jin[k].dtype), k
    assert model.model_flops(pshape) == jm.model_flops(jshape)
    assert (model.n_params, model.n_active_params) == (jm.n_params, jm.n_active_params)
    jstate = jm.abstract_decode_state(jshape.global_batch, jshape.seq_len)
    jflat = {tuple(k.key for k in p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    state = dict(tree_leaves(model.abstract_decode_state(pshape.global_batch, pshape.seq_len)))
    assert set(state) == set(jflat)
    for path, leaf in state.items():
        assert tuple(leaf.shape) == tuple(jflat[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(jflat[path].dtype), path


def _train_cell(arch, B: int, S: int, **kw) -> dict:
    cell = dryrun.run_cell(arch, ShapeSpec(f"train_{B}x{S}", S, B, "train"), mesh=ONE, verbose=False, **kw)
    assert cell["status"] == "ok", cell.get("error")
    return cell


def test_qwen3_4b_on_one_device_holds_16_bytes_a_parameter_and_fits():
    cell = _train_cell("qwen3-4b", 1, 2048)
    ma = cell["memory_analysis"]
    assert ma["state_bytes"] == 16 * cell["n_params"] == 70_582_788_096
    assert ma["fits_hbm"] and ma["state_bytes"] < ma["peak_bytes_per_device"] <= dryrun.PLAN_HW.hbm_bytes
    assert cell["kernel_calls"] == {"flash_attention": 72, "flash_attention_bwd": 36, "fused_rmsnorm": 289,
                                    "fused_rmsnorm_bwd": 145}
    assert cell["chips"] == 1 and cell["mesh"] == "1x1" and not cell["collectives"].get("total")


@pytest.mark.parametrize("layers,fits", [(8, True), (11, False)])
def test_recurrentgemma_9b_fits_at_8_layers_and_not_at_11(layers, fits):
    cell = _train_cell(dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=layers), 1, 4096)
    assert cell["memory_analysis"]["fits_hbm"] is fits
    assert cell["memory_analysis"]["state_bytes"] == 16 * cell["n_params"]


def _cpu_step(arch: str, B: int, S: int):
    """A smoke train step on the CPU (remat "full") -> (its device tree, the
    calls of each kernel's plain version during it)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full")
    model = Model(cfg, device="cpu")
    params = model.init(train=True)
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(3e-4), AdamWConfig())
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32),
             "loss_mask": torch.ones(B, S)}
    step(params, opt, batch)
    calls: dict[str, int] = {}
    names = {"_flash_fwd": "flash_attention", "_flash_attention_bwd": "flash_attention_bwd",
             "_rmsnorm_fwd": "fused_rmsnorm", "_fused_rmsnorm_bwd": "fused_rmsnorm_bwd",
             "_rglru_fwd": "rglru_scan", "_rglru_scan_bwd": "rglru_scan_bwd"}
    originals = {n: getattr(ops, n) for n in names}

    def spy(name):
        def call(*a, **k):
            calls[names[name]] = calls.get(names[name], 0) + 1
            return originals[name](*a, **k)
        return call

    try:
        for n in names:
            setattr(ops, n, spy(n))
        _, tree = tree_from_profile(lambda: step(params, opt, batch), device="cpu")
    finally:
        for n, f in originals.items():
            setattr(ops, n, f)
    return cfg, tree, calls


@pytest.mark.parametrize("arch", SMOKE_TRAIN)
def test_the_smoke_plan_is_a_profiled_cpu_step(arch):
    B, S = 2, 16  # two smoke chunks of the mLSTM
    cfg, tree, calls = _cpu_step(arch, B, S)
    shape = ShapeSpec(f"train_{B}x{S}", S, B, "train")
    with ops.plain_versions():  # the CPU step's matrix products: the kernels' plain versions
        plain = dryrun.run_cell(cfg, shape, mesh=ONE, verbose=False)
    assert plain["tree_metrics"]["flops"] == pytest.approx(tree.total("flops"), rel=FLOPS_REL)
    assert plain["kernel_calls"] == {}
    before = ops.launch_counts()
    planned = dryrun.run_cell(cfg, shape, mesh=ONE, verbose=False)
    assert ops.launch_counts() == before  # the meta path launches nothing
    assert planned["kernel_calls"] == calls
    assert planned["memory_analysis"]["state_bytes"] == 16 * planned["n_params"]


@functools.lru_cache(maxsize=None)
def _qwen_train_4k(strategy: str, mesh: MeshShape | None) -> dict:
    cell = dryrun.run_cell("qwen3-4b", "train_4k", False, strategy_name=strategy, mesh=mesh, verbose=False)
    assert cell["status"] == "ok", cell.get("error")
    return cell


def test_ddp_keeps_the_whole_state_on_every_device():
    cell = _qwen_train_4k("ddp", None)
    assert cell["chips"] == 256 and cell["local"]["batch"] == 16 and cell["local"]["tp"] == 16
    assert cell["memory_analysis"]["state_bytes"] == 16 * cell["n_params"]
    assert set(cell["collectives"]) == {"total", "all-reduce"}  # the gradients, over data


def test_tp_fsdp_ranks_do_the_single_devices_work_with_the_kv_heads_replicated():
    sharded, single = _qwen_train_4k("tp_fsdp", None), _qwen_train_4k("tp_fsdp", ONE)
    assert sharded["local"] == {"batch": 16, "tp": 16, "n_heads": 2, "n_kv_heads": 1, "n_experts": 0,
                                "attn_split": True, "ffn_split": True, "experts_split": False, "vocab_split": True}
    ratio = sharded["tree_metrics"]["flops"] * sharded["chips"] / single["tree_metrics"]["flops"]
    assert TP_REDUNDANCY[0] <= ratio <= TP_REDUNDANCY[1], ratio
    # every matrix is split 16 ways (FSDP over data) and most 256 (and TP); the KV weights and norms 16
    assert 16 * sharded["n_params"] / 256 < sharded["memory_analysis"]["state_bytes"] < 16 * sharded["n_params"] / 64
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(sharded["collectives"])
    assert sharded["roofline"]["t_collective_s"] > 0


def _cut(arch: str, n_layers: int, **changes):
    """A full-width config cut in depth (the plan's per-layer numbers are the full depth's)."""
    return dataclasses.replace(get_config(arch), n_layers=n_layers, **changes)


def _numbers(cell: dict) -> dict:
    """A cell without its options and its own time: what a plan computes."""
    return {k: v for k, v in cell.items() if k not in ("overrides", "trace_s")}


def test_a_shard_map_cell_plans_the_expert_parallel_exchange():
    """deepseek-moe-16b (1 dense + 2 MoE layers, remat "full") on 16 x 16:
    each rank holds 64 / 16 experts and the router whole, and its
    all-to-all is the module docstring's formula (the trace's own meta
    exchange agrees, or the cell would fail)."""
    from repro_torch.models.moe_shard_map import _local_capacity

    cfg = _cut("deepseek-moe-16b", 3)
    ep = dryrun.run_cell(cfg, "train_4k", False, moe_impl="shard_map", verbose=False)
    dense = dryrun.run_cell(cfg, "train_4k", False, verbose=False)
    assert ep["status"] == dense["status"] == "ok", ep.get("error")
    assert ep["overrides"] == {"moe_impl": "shard_map"}
    assert ep["local"]["n_experts"] == 4 and ep["local"]["experts_split"]
    assert ep["memory_analysis"]["state_bytes"] == dense["memory_analysis"]["state_bytes"]
    assert ep["kernel_calls"] == dense["kernel_calls"]
    t_loc = SHAPES["train_4k"].seq_len * ep["local"]["batch"]
    n, n_moe = 16, 2
    passes = 2 * n_moe * 2 + 2 * n_moe  # forward, backward and the remat recompute, two exchanges each
    want = 2 * cfg.n_experts * _local_capacity(t_loc, cfg) * cfg.d_model * (n - 1) / n * passes
    assert ep["collectives"]["all-to-all"] == pytest.approx(want, rel=1e-12)
    assert ep["collectives"]["all-to-all"] != dense["collectives"]["all-to-all"]


def test_a_chunk_threshold_cell_equals_the_default_one():
    cfg = _cut("gemma-2b", 2)
    cell = dryrun.run_cell(cfg, "prefill_32k", False, chunk_threshold=4096, verbose=False)
    default = dryrun.run_cell(cfg, "prefill_32k", False, verbose=False)
    assert cell["status"] == "ok" and cell["overrides"] == {"chunk_threshold": 4096}
    assert _numbers(cell) == _numbers(default)
    assert dryrun.cell_file("gemma-2b", "prefill_32k", "16x16", "tp_fsdp", chunk_threshold=4096).endswith(
        "__ct4096.json")


def test_attn_cp_at_gemma_2b_divides_the_attention_kernels_work_by_the_model_axis():
    """8 query heads do not divide 16: attention is replicated over model,
    and attn_cp gives each rank 1/16 of its rows at S = 32768 > 8192."""
    cfg = _cut("gemma-2b", 2)
    cp = dryrun.run_cell(cfg, "prefill_32k", False, attn_cp=True, verbose=False)
    base = dryrun.run_cell(cfg, "prefill_32k", False, verbose=False)
    assert cp["status"] == base["status"] == "ok", cp.get("error")
    assert not cp["local"]["attn_split"]
    assert dryrun.local_plan(dataclasses.replace(cfg, attn_cp=True), make_strategy("tp_fsdp"),
                             make_production_mesh(), 32, 32768).attn_share == 1 / 16
    meta = torch.device("meta")
    q = torch.empty((cp["local"]["batch"], 32768, cfg.n_heads, cfg.head_dim), dtype=torch.bfloat16, device=meta)
    k = torch.empty((cp["local"]["batch"], 32768, cfg.n_kv_heads, cfg.head_dim), dtype=torch.bfloat16, device=meta)
    flops, nbytes = ops.flash_work(q, k, True, cfg.window)
    assert cp["kernel_calls"]["flash_attention"] == base["kernel_calls"]["flash_attention"] == 2
    for metric, per_call in (("flops", flops), ("bytes", nbytes)):
        saved = base["tree_metrics"][metric] - cp["tree_metrics"][metric]
        assert saved == pytest.approx(2 * per_call * 15 / 16, rel=1e-9), metric
    for key in ("memory_analysis", "collectives", "kernel_calls", "n_params"):
        assert cp[key] == base[key], key


def test_attn_cp_at_qwen3_4b_changes_nothing():
    """32 query heads divide 16: attention is split by heads, as without attn_cp."""
    cfg = _cut("qwen3-4b", 2)
    cp = dryrun.run_cell(cfg, "prefill_32k", False, attn_cp=True, verbose=False)
    base = dryrun.run_cell(cfg, "prefill_32k", False, verbose=False)
    assert cp["status"] == "ok" and cp["local"]["attn_split"]
    assert _numbers(cp) == _numbers(base)


def test_the_cli_writes_jax_cells_that_roofline_reads(tmp_path, capsys):
    out = str(tmp_path / "cells")
    dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh", "both", "--out", out])
    dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--mesh", "single", "--out", out])
    files = sorted(os.listdir(out))
    assert files == ["qwen3-4b__decode_32k__16x16__tp_fsdp.json", "qwen3-4b__decode_32k__2x16x16__tp_fsdp.json",
                     "qwen3-4b__long_500k__16x16__tp_fsdp.json"]
    cells = [json.load(open(os.path.join(out, f))) for f in files]
    ok = [c for c in cells if c["status"] == "ok"]
    assert len(ok) == 2 and cells[2]["status"] == "skip"
    jax_keys = {"arch", "shape", "mesh", "strategy", "grad_accum", "overrides", "status", "chips", "lower_s",
                "compile_s", "memory_analysis", "cost_analysis", "tree_metrics", "collectives", "roofline",
                "breakdown", "n_params", "n_active_params"}
    for c in ok:
        assert jax_keys - JAX_KEYS_RENAMED <= set(c) and "trace_s" in c
        assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_per_device",
                "fits_hbm"} <= set(c["memory_analysis"])
        assert {"t_step_s", "dominant", "t_compute_s", "t_memory_s", "t_collective_s", "mfu_bound",
                "useful_flops_ratio", "fits_hbm"} <= set(c["roofline"])
    rows = roofline.main(["--dir", out])
    assert [r.split(",")[0] for r in rows] == ["roofline_qwen3-4b_decode_32k_16x16",
                                               "roofline_qwen3-4b_decode_32k_2x16x16", "roofline_summary"]
    assert rows[-1].endswith("ok=2;skip_by_rule=1;fail=0")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "train_4k", "--strategy", "no_such_strategy",
                     "--out", out])
    assert e.value.code == 1
    assert roofline.RESULT_DIRS == [dryrun.DEFAULT_OUT]
