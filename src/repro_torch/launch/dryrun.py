"""The dry-run: plan every (arch x shape x mesh) cell without the hardware
(the counterpart of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for a 256- or 512-chip mesh and
reads XLA's memory plan and cost analysis. The port has no compiler, and one
card has no peers. It plans a cell on the meta device instead: one step (a
train step, a prefill, or a decode step) runs on meta tensors of one rank's
shapes under ``core/meta_cost.py``'s tracer, which counts its flops, bytes,
hand-written kernel calls and the peak of its live bytes. The plan is a
model of what a rank would do, not a compiler's result; ``chip_smoke.py``'s
``dryrun`` phase holds it to what the card measures for one device.

**A rank's shapes.** The parameters are placed by ``sharding.rules``
(``spec_for`` as DTensor placements). The rank's work is traced on its local
shapes, Megatron-style tensor parallelism and FSDP as a rank computes them:

* the batch is split over the strategy's batch axes where it divides;
* each width the strategy shards over a non-batch (tensor-parallel) axis is
  divided by it: the query heads where they divide (then the KV heads where
  they divide, else one KV head a rank where a rank's query heads fall in one
  KV group, the Megatron GQA convention; else attention is replicated), the
  ``mlp`` and ``vocab`` widths, the routed experts (``expert``: the capacity
  a rank's experts hold stays the global one's);
* the RG-LRU block and the xLSTM cells run at full width on every rank: their
  gate products are dense over the whole width (``state_out`` shards an
  output only), so the trace counts their work on every rank;
* FSDP-sharded parameters (over the batch axes) are gathered for compute:
  the trace computes with the gathered, tensor-parallel-local parameters.

**Memory per device.** The state is the local shards' bytes from the
placements, in the port's storage dtypes (``models/modules.py``
``storage_dtype``): parameters, and for a train step their f32 gradients
(one buffer the step keeps) and the two AdamW moments (``--opt-dtype``),
plus the local batch (and a decode step's state). The peak is that state
plus the trace's transient bytes at its peak (the trace's own baseline is
its tensor-parallel-local state). On a mesh of one device the two baselines
are one, and the peak is the trace's.

**Collectives** (analytic, written under ``coll_bytes::<kind>`` in the tree;
bytes a device sends, ring algorithms, n the group's size):

* ``all-gather``: each leaf sharded over batch axes (FSDP, n ranks), its
  gathered bytes b times (n-1)/n, for the forward and, in a train step, once
  more for the backward (the remat recompute and the gradients' products);
* ``reduce-scatter``: in a train step, each such leaf's f32 gradient, b (n-1)/n;
* ``all-reduce``: in a train step, each leaf not sharded over the batch axes
  has its f32 gradient all-reduced over them, 2 b (n-1)/n; and each
  tensor-parallel sublayer (head-sharded attention, a sharded feed-forward,
  the vocab-sharded embedding) all-reduces its (B_loc, S, D) bf16 output,
  2 m (t-1)/t for t ranks, once in the forward and, in a train step, once in
  the backward and once more where remat recomputes it;
* ``all-to-all``: a MoE layer whose experts are sharded exchanges its
  (tokens x top_k, D) bf16 slots twice (dispatch and combine) in the forward,
  twice in the backward and twice more where remat recomputes it, m (t-1)/t.

The roofline is ``core/roofline.py``'s ``report_from_tree`` over the trace's
tree on the H100's rates (``PLAN_HW``; the link term's NVLink rates are the
data sheet's, not measured over a mesh). A cell JSON has the JAX package's
keys; JAX's ``lower_s`` and ``compile_s`` are one ``trace_s``.

Not ported: the explicit expert-parallel MoE (``--moe-impl shard_map``) and a
step with DTensor parameters on a process group (ROADMAP Queue 1 [15b]); the
xla-path chunked attention (``--chunk-threshold``, ``--attn-cp``; [4]). Those
cells are ``fail``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both   # into results/torch_dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import threading
import time
import traceback

import torch

from repro_torch.configs import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs, shape_applicable
from repro_torch.core import meta_cost
from repro_torch.core.roofline import H100, report_from_tree
from repro_torch.launch.mesh import MeshShape, make_production_mesh, mesh_chips
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import Model
from repro_torch.models.modules import abstract_params, storage_dtype, tree_leaves, tree_map_with_path
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.sharding import make_strategy, placements_from_spec, spec_for
from repro_torch.sharding.rules import axis_sizes, entry_axes, local_shape

DEFAULT_OUT = os.path.join("results", "torch_dryrun")
# The H100 80GB HBM3's memory as the card reports it (torch.cuda's
# total_memory: 85,030,813,696 bytes, 79.19 GiB), the capacity a plan fits in;
# the rates are the data sheet's (core/roofline.py H100).
PLAN_HW = dataclasses.replace(H100, hbm_bytes=85_030_813_696.0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Freeing a long autograd graph (xlstm-125m's sLSTM time loop: a chain of
# Python autograd nodes, one a time step) recurses once a node; with the
# tracer's storage finalizers on the way, 4,096 steps overflow the main
# thread's 8 MiB stack. A trace runs in a thread with this much stack.
TRACE_STACK_BYTES = 1 << 30


class NotPorted(NotImplementedError):
    """A dry-run option whose path the port does not have yet."""


# ---------------------------------------------------------------------------
# Input and decode-state shardings
# ---------------------------------------------------------------------------


def _axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in (axes if isinstance(axes, tuple) else (axes,)))


def batch_specs(batch_abs: dict, mesh, batch_axes: tuple[str, ...]) -> dict:
    """Inputs: dim 0 (batch) over the batch axes where it divides; the rest replicated."""

    def one(_, leaf):
        if leaf.ndim and leaf.shape[0] % _axes_size(mesh, batch_axes) == 0:
            return (batch_axes,) + (None,) * (leaf.ndim - 1)
        return ()

    return tree_map_with_path(one, batch_abs)


def batch_shardings(batch_abs: dict, mesh, batch_axes: tuple[str, ...]) -> dict:
    """:func:`batch_specs` as DTensor placements."""
    return tree_map_with_path(lambda _, s: placements_from_spec(s, mesh), batch_specs(batch_abs, mesh, batch_axes))


def state_specs(state_abs: dict, mesh, batch_axes: tuple[str, ...]) -> dict:
    """Decode-state specs: the batch dim over the batch axes; one wide dim
    (heads preferred, else feature) over 'model'. Stacked ('scan') leaves
    carry a leading layer axis, which stays unsharded."""
    model_n = axis_sizes(mesh)["model"]
    batch_n = _axes_size(mesh, batch_axes)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        dims: list = [None] * len(shape)
        bdim = 1 if "scan" in path else 0
        if len(shape) > bdim and shape[bdim] % batch_n == 0:
            dims[bdim] = batch_axes
        # prefer the head axis (rank-4 kv / mlstm-C), else the last wide axis
        for d in (bdim + 2, bdim + 3, bdim + 1):
            if d < len(shape) and dims[d] is None and shape[d] % model_n == 0 and shape[d] >= model_n:
                dims[d] = "model"
                break
        return tuple(dims)

    return tree_map_with_path(one, state_abs)


def state_shardings(state_abs: dict, mesh, batch_axes: tuple[str, ...]) -> dict:
    """:func:`state_specs` as DTensor placements."""
    return tree_map_with_path(lambda _, s: placements_from_spec(s, mesh), state_specs(state_abs, mesh, batch_axes))


# ---------------------------------------------------------------------------
# One rank's shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    """How a rank's step differs from the global one (see the module docstring)."""

    cfg: ModelConfig  # the config a rank's trace runs (heads and experts divided)
    batch: int  # the local batch
    tp: int  # the tensor-parallel group's size (the non-batch axes)
    attn_split: bool  # attention heads divided over tp
    ffn_split: bool  # a dense feed-forward's mlp width divided over tp
    experts_split: bool  # routed experts divided over tp
    vocab_split: bool


def _split(n: int, logical: str, strategy, sizes: dict, tp_axes: set) -> int:
    k = math.prod(sizes[a] for a in strategy.mesh_axes_for(logical) if a in tp_axes)
    return n // k if k > 1 and n % k == 0 else n


def local_plan(cfg: ModelConfig, strategy, mesh, global_batch: int) -> LocalPlan:
    """What one rank of ``mesh`` computes under ``strategy`` (the module docstring's rules)."""
    sizes = axis_sizes(mesh)
    batch_axes = tuple(strategy.act_rules["batch"])
    tp_axes = {a for a in sizes if a not in batch_axes}
    tp = math.prod(sizes[a] for a in tp_axes)
    n_batch = math.prod(sizes[a] for a in batch_axes)
    batch = global_batch // n_batch if global_batch % n_batch == 0 else global_batch
    changes: dict = {}
    attn_split = False
    if "attn" in cfg.pattern and not {"slstm", "mlstm"} & set(cfg.pattern):
        hq, hkv = _split(cfg.n_heads, "q_heads", strategy, sizes, tp_axes), cfg.n_kv_heads
        if hq < cfg.n_heads:
            hkv = _split(cfg.n_kv_heads, "kv_heads", strategy, sizes, tp_axes)
            group = cfg.n_heads // cfg.n_kv_heads
            if hkv == cfg.n_kv_heads:  # KV replicated: a rank keeps the KV heads its query heads read
                hkv = hq // group if hq % group == 0 else (1 if group % hq == 0 else 0)
            if hkv:
                attn_split = True
                changes.update(n_heads=hq, n_kv_heads=hkv, head_dim_=cfg.head_dim)
    experts_split = False
    if cfg.n_experts:
        e = _split(cfg.n_experts, "expert", strategy, sizes, tp_axes)
        if e < cfg.n_experts:
            experts_split = True
            k = min(cfg.top_k, e)
            # keep the global capacity a rank's experts hold: C = T K cf / E
            changes.update(n_experts=e, top_k=k,
                           capacity_factor=cfg.capacity_factor * cfg.top_k * e / (k * cfg.n_experts))
    d_ff = max(cfg.d_ff, cfg.dense_d_ff, 1)
    ffn_split = _split(d_ff, "mlp", strategy, sizes, tp_axes) < d_ff
    vocab_split = _split(cfg.vocab, "vocab", strategy, sizes, tp_axes) < cfg.vocab
    return LocalPlan(dataclasses.replace(cfg, **changes), batch, tp, attn_split, ffn_split, experts_split,
                     vocab_split)


def local_spec(global_spec: dict, plan: LocalPlan, strategy, mesh) -> dict:
    """The spec tree a rank computes with: the plan's config's spec, with each
    ``mlp`` and ``vocab`` dim that the strategy shards over a tensor-parallel
    axis divided by it."""
    sizes = axis_sizes(mesh)
    batch_axes = set(strategy.act_rules["batch"])
    flat = dict(tree_leaves(global_spec))

    def one(path, s):
        g = flat.get(path)
        if g is None or g.shape != s.shape:  # heads and experts: the plan's config has divided them
            return s
        shape = list(s.shape)
        for d, (entry, logical) in enumerate(zip(spec_for(g, strategy, mesh), s.logical)):
            tp_axes = [a for a in entry_axes(entry) if a not in batch_axes]
            if logical in ("mlp", "vocab") and tp_axes:
                shape[d] //= math.prod(sizes[a] for a in tp_axes)
        return dataclasses.replace(s, shape=tuple(shape))

    return tree_map_with_path(one, Model(plan.cfg, device="meta").spec())


# ---------------------------------------------------------------------------
# Per-device state and collectives
# ---------------------------------------------------------------------------


def _sharded_bytes(shape, spec, mesh, dtype: torch.dtype) -> int:
    return math.prod(local_shape(tuple(shape), spec, mesh)) * torch.empty((), dtype=dtype).element_size()


def collectives(spec_tree: dict, plan: LocalPlan, strategy, mesh, *, train: bool, remat: str, tokens: int,
                d_model: int, top_k: int, n_moe_layers: int, n_tp_sublayers: int, n_remat_sublayers: int,
                n_remat_moe: int) -> dict[str, float]:
    """Bytes a device sends per step, by kind (formulas in the module docstring)."""
    sizes = axis_sizes(mesh)
    batch_axes = tuple(strategy.act_rules["batch"])
    n_batch = math.prod(sizes[a] for a in batch_axes)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0, "all-to-all": 0.0}
    for path, s in tree_leaves(spec_tree):
        spec = spec_for(s, strategy, mesh)
        dtype = storage_dtype(path, len(s.shape), train=train)
        fsdp = [a for e in spec for a in entry_axes(e) if a in batch_axes]
        n = math.prod(sizes[a] for a in fsdp)
        # the leaf with its batch axes gathered: tensor-parallel axes stay sharded
        gathered = _sharded_bytes(s.shape, spec, mesh, dtype) * n
        if n > 1:
            out["all-gather"] += gathered * (n - 1) / n * (2 if train else 1)
            if train:  # the gradients are f32, as the trained parameters
                out["reduce-scatter"] += gathered * (n - 1) / n
        elif train and n_batch > 1:
            out["all-reduce"] += 2 * gathered * (n_batch - 1) / n_batch
    t = plan.tp
    if t > 1:
        msg = 2.0 * tokens * d_model  # (B_loc, S, D) in bf16
        passes = n_tp_sublayers * (2 if train else 1) + (n_remat_sublayers if train and remat != "none" else 0)
        out["all-reduce"] += 2 * msg * (t - 1) / t * passes
        if plan.experts_split:
            slots = 2.0 * tokens * top_k * d_model
            moe_passes = 2 * n_moe_layers * (2 if train else 1) + (2 * n_remat_moe if train and remat != "none" else 0)
            out["all-to-all"] += slots * (t - 1) / t * moe_passes
    return {k: v for k, v in out.items() if v}


def _layer_counts(cfg: ModelConfig, plan: LocalPlan) -> tuple[int, int, int, int]:
    """-> (MoE layers, tensor-parallel sublayers, of them in remat'd units,
    MoE layers in remat'd units)."""
    from repro_torch.models.transformer import StackLayout, _ffn_kind, layer_kind

    lay = StackLayout(cfg)
    in_units = set(range(cfg.first_dense, cfg.first_dense + lay.n_units * len(cfg.pattern)))
    moe = tp = tp_units = moe_units = 0
    for i in range(cfg.n_layers):
        ffn = _ffn_kind(cfg, i)
        subs = (layer_kind(cfg, i) == "attn" and plan.attn_split) + (
            (ffn in ("mlp", "dense_mlp") and plan.ffn_split) or (ffn == "moe" and plan.experts_split))
        moe += ffn == "moe"
        tp += subs
        if i in in_units:
            tp_units += subs
            moe_units += ffn == "moe"
    return moe, tp + plan.vocab_split, tp_units, moe_units


# ---------------------------------------------------------------------------
# The traced step
# ---------------------------------------------------------------------------


def _meta_like(batch_abs: dict, batch: int) -> dict:
    return {k: torch.empty((batch, *v.shape[1:]), dtype=v.dtype, device="meta") for k, v in batch_abs.items()}


def _on_deep_stack(fn):
    """``fn()`` in a thread of TRACE_STACK_BYTES of stack; its exception re-raised here."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - raised again in the caller's thread
            box["err"] = e

    old = threading.stack_size(TRACE_STACK_BYTES)
    try:
        t = threading.Thread(target=run, name="meta-trace")
        t.start()
        t.join()
    finally:
        threading.stack_size(old)
    if "err" in box:
        raise box["err"]
    return box["out"]


def trace_step(cfg: ModelConfig, spec: dict, shape: ShapeSpec, batch: int, *, grad_accum: int = 1,
               opt_dtype: str = "float32") -> meta_cost.MetaCost:
    """:func:`_trace_step` on a deep stack (TRACE_STACK_BYTES)."""
    return _on_deep_stack(lambda: _trace_step(cfg, spec, shape, batch, grad_accum=grad_accum, opt_dtype=opt_dtype))


def _trace_step(cfg: ModelConfig, spec: dict, shape: ShapeSpec, batch: int, *, grad_accum: int = 1,
                opt_dtype: str = "float32") -> meta_cost.MetaCost:
    """One step of ``shape``'s kind on meta tensors of ``spec``'s shapes at
    ``batch`` sequences, traced. A train step's gradient buffer is made
    first (as the card's warm-up step makes it), then the step is traced with
    the parameters, optimizer state, gradients and batch as the baseline."""
    model = Model(cfg, device="meta")
    train = shape.kind == "train"
    params = abstract_params(spec, train=train)
    inputs = _meta_like(model.input_specs(shape), batch)
    if train:
        opt = adamw_init(params, moment_dtype=DTYPES[opt_dtype])
        step = make_train_step(model, cosine_schedule(3e-4), AdamWConfig(), grad_accum=grad_accum)
        with meta_cost.tracing((params, opt, inputs, step.prime(params))) as cost:
            step(params, opt, inputs)
        return cost
    with torch.inference_mode():
        if shape.kind == "prefill":
            with meta_cost.tracing((params, inputs)) as cost:
                logits, _ = model.forward(params, inputs)
                torch.argmax(logits[:, -1], dim=-1)
            return cost
        state = model.abstract_decode_state(batch, shape.seq_len)
        step = make_serve_step(model)
        with meta_cost.tracing((params, inputs, state)) as cost:
            step(params, inputs, state, shape.seq_len - 1)
        return cost


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def cell_file(arch: str, shape: str, mesh_tag: str, strategy: str, *, grad_accum: int = 1, remat: str | None = None,
              chunk_threshold: int | None = None, moe_impl: str | None = None, opt_dtype: str = "float32",
              attn_cp: bool = False) -> str:
    """A cell's file name, as the JAX package's dry-run names it."""
    fn = f"{arch}__{shape}__{mesh_tag}__{strategy}"
    if grad_accum > 1:
        fn += f"__ga{grad_accum}"
    if remat:
        fn += f"__remat-{remat}"
    if chunk_threshold is not None:
        fn += f"__ct{chunk_threshold}"
    if moe_impl:
        fn += f"__moe-{moe_impl}"
    if opt_dtype != "float32":
        fn += f"__opt-{opt_dtype}"
    if attn_cp:
        fn += "__cp"
    return fn + ".json"


def run_cell(
    arch: str | ModelConfig,
    shape_name: str | ShapeSpec,
    multi_pod: bool = False,
    *,
    strategy_name: str = "tp_fsdp",
    grad_accum: int = 1,
    remat: str | None = None,
    chunk_threshold: int | None = None,
    chunk: int | None = None,
    moe_impl: str | None = None,
    attn_cp: bool = False,
    opt_dtype: str = "float32",
    donate: bool = True,
    verbose: bool = True,
    dump_tree: str | None = None,
    mesh=None,
) -> dict:
    """Plan one cell -> its JSON dict. ``arch`` is a registered name or a
    config; ``shape_name`` a name of ``SHAPES`` or a ``ShapeSpec``;
    ``mesh`` (a ``MeshShape`` or ``DeviceMesh``) replaces the production mesh
    ``multi_pod`` picks."""
    t0 = time.time()
    cfg = get_config(arch) if isinstance(arch, str) else arch
    overrides = {}
    if remat is not None:
        overrides["remat"] = remat
    if chunk_threshold is not None:
        overrides["chunk_threshold"] = chunk_threshold
    if chunk is not None:
        overrides["chunk"] = chunk
    if moe_impl is not None:
        overrides["moe_impl"] = moe_impl
    if attn_cp:
        overrides["attn_cp"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name if isinstance(mesh, MeshShape) else "x".join(map(str, axis_sizes(mesh).values()))
    cell = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "strategy": strategy_name,
        "grad_accum": grad_accum,
        "overrides": overrides,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skip", reason=why)
        return cell
    try:
        if cfg.moe_impl == "shard_map":
            raise NotPorted("moe_impl='shard_map' (the explicit expert-parallel MoE) is not ported: "
                            "ROADMAP Queue 1 [15b]")
        if cfg.attn_cp or chunk_threshold is not None:
            raise NotPorted("the xla-path chunked attention (chunk_threshold, attn_cp) is not ported: "
                            "ROADMAP Queue 1 [4]")
        chips = mesh_chips(mesh)
        model = Model(cfg, device="meta")
        strategy = make_strategy(strategy_name, multi_pod="pod" in axis_sizes(mesh))
        batch_axes = tuple(strategy.act_rules["batch"])
        spec_tree = model.spec()
        train = shape.kind == "train"
        plan = local_plan(cfg, strategy, mesh, shape.global_batch)
        cost = trace_step(plan.cfg, local_spec(spec_tree, plan, strategy, mesh), shape, plan.batch,
                          grad_accum=grad_accum, opt_dtype=opt_dtype)
        trace_s = time.time() - t0

        # the per-device state, from the placements
        params_b = grads_b = moments_b = 0
        for path, s in tree_leaves(spec_tree):
            spec = spec_for(s, strategy, mesh)
            params_b += _sharded_bytes(s.shape, spec, mesh, storage_dtype(path, len(s.shape), train=train))
            if train:
                grads_b += _sharded_bytes(s.shape, spec, mesh, torch.float32)
                moments_b += 2 * _sharded_bytes(s.shape, spec, mesh, DTYPES[opt_dtype])
        batch_abs = model.input_specs(shape)
        b_specs = batch_specs(batch_abs, mesh, batch_axes)
        batch_b = sum(_sharded_bytes(v.shape, b_specs[k], mesh, v.dtype) for k, v in batch_abs.items())
        state_b = 0
        if shape.kind == "decode":
            state_abs = model.abstract_decode_state(shape.global_batch, shape.seq_len)
            s_specs = dict(tree_leaves(state_specs(state_abs, mesh, batch_axes)))
            state_b = sum(_sharded_bytes(v.shape, s_specs[p], mesh, v.dtype) for p, v in tree_leaves(state_abs))
        step_b = 4 if train else 0
        argument_b = params_b + moments_b + step_b + batch_b + state_b
        resident_b = argument_b + grads_b  # the gradient buffer lives between steps
        peak_b = resident_b + cost.temp_bytes

        tree = cost.tree
        tokens = plan.batch * (1 if shape.kind == "decode" else shape.seq_len)
        n_moe, n_tp, n_tp_remat, n_moe_remat = _layer_counts(cfg, plan)
        colls = collectives(spec_tree, plan, strategy, mesh, train=train, remat=cfg.remat, tokens=tokens,
                            d_model=cfg.d_model, top_k=cfg.top_k, n_moe_layers=n_moe, n_tp_sublayers=n_tp,
                            n_remat_sublayers=n_tp_remat, n_remat_moe=n_moe_remat)
        for kind, b in colls.items():
            tree.add_stack(["collectives", kind], {"coll_bytes": b, f"coll_bytes::{kind}": b})
        if dump_tree:
            from repro_torch.core.device_tree import save_device_tree

            os.makedirs(os.path.dirname(dump_tree) or ".", exist_ok=True)
            save_device_tree(tree, dump_tree, meta={"arch": cfg.name, "shape": shape.name, "mesh": mesh_name})
        from repro_torch.core.report import breakdown

        component_breakdown = {
            metric: breakdown(tree, level=8, metric=metric, min_share=0.03)[:40]
            for metric in ("flops", "bytes", "coll_bytes")
        }
        rep = report_from_tree(arch=cfg.name, shape=shape.name, device_tree=tree, mesh=mesh_name, chips=chips,
                               hbm_peak_bytes=float(peak_b), model_flops_global=model.model_flops(shape), hw=PLAN_HW)
        cell.update(
            status="ok",
            chips=chips,
            trace_s=round(trace_s, 1),
            local={"batch": plan.batch, "tp": plan.tp, "n_heads": plan.cfg.n_heads, "n_kv_heads": plan.cfg.n_kv_heads,
                   "n_experts": plan.cfg.n_experts, "attn_split": plan.attn_split, "ffn_split": plan.ffn_split,
                   "experts_split": plan.experts_split, "vocab_split": plan.vocab_split},
            memory_analysis={
                "argument_bytes": argument_b,
                "output_bytes": 0 if donate else params_b + moments_b,
                "temp_bytes": peak_b - argument_b,
                "alias_bytes": params_b + moments_b + step_b if donate and train else 0,
                "state_bytes": params_b + grads_b + moments_b,
                "peak_bytes_per_device": peak_b,
                "fits_hbm": rep.fits_hbm(),
            },
            cost_analysis={"flops": tree.total("flops"), "bytes_accessed": tree.total("bytes")},
            tree_metrics={"flops": tree.total("flops"), "bytes": tree.total("bytes"), "ops": tree.total("ops"),
                          "kernels": tree.total("kernels")},
            kernel_calls=dict(cost.kernel_calls),
            collectives={"total": tree.total("coll_bytes"), **colls},
            roofline=rep.row(),
            breakdown=component_breakdown,
            n_params=model.n_params,
            n_active_params=model.n_active_params,
        )
        if verbose:
            print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name}: OK (trace {trace_s:.1f}s, "
                  f"dominant={rep.dominant}, t_step={rep.t_step * 1e3:.2f}ms, peak={peak_b / 2**30:.2f}GiB, "
                  f"fits={rep.fits_hbm()})")
            print(f"  collectives: { {k: f'{v:.3e}' for k, v in colls.items()} }")
    except Exception as e:  # noqa: BLE001 - cell failures are data, not crashes
        cell.update(status="fail", error=f"{type(e).__name__}: {e}", trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name}: FAIL {type(e).__name__}: {e}")
    return cell


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--chunk-threshold", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--dump-tree", default=None, help="write the traced tree's JSON here")
    ap.add_argument("--moe-impl", default=None, choices=["dense", "shard_map"])
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--attn-cp", action="store_true", help="context-parallel attention q-chunks")
    ap.add_argument("--all", action="store_true", help="run every (arch, shape) cell")
    ap.add_argument("--out", default=DEFAULT_OUT, help="output dir for per-cell JSON")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = run_cell(
                    arch, shape, mp,
                    strategy_name=args.strategy,
                    grad_accum=args.grad_accum,
                    remat=args.remat,
                    chunk_threshold=args.chunk_threshold,
                    chunk=args.chunk,
                    moe_impl=args.moe_impl,
                    attn_cp=args.attn_cp,
                    opt_dtype=args.opt_dtype,
                    dump_tree=args.dump_tree,
                )
                results.append(cell)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = cell_file(arch, shape, "2x16x16" if mp else "16x16", args.strategy,
                                   grad_accum=args.grad_accum, remat=args.remat,
                                   chunk_threshold=args.chunk_threshold, moe_impl=args.moe_impl,
                                   opt_dtype=args.opt_dtype, attn_cp=args.attn_cp)
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(cell, f, indent=1)
    n_ok = sum(1 for c in results if c["status"] == "ok")
    n_skip = sum(1 for c in results if c["status"] == "skip")
    n_fail = sum(1 for c in results if c["status"] == "fail")
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skip(by-rule), {n_fail} fail")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
