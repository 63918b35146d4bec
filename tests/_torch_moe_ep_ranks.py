"""The ranks of ``tests/test_torch_moe_ep.py``'s gloo runs, in a module of
their own so that a spawned rank imports torch and the port, not JAX; the
test process builds the same inputs with the same functions for the
one-process simulation and the dense references."""

from __future__ import annotations

import dataclasses
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.modules import init_params
from repro_torch.models.moe import moe_spec
from repro_torch.models.moe_shard_map import exchanged_bytes, moe_shard_map, reset_exchanged_bytes, simulate
from repro_torch.params import expert_slice
from repro_torch.sharding import sharding_ctx

ARCH = "deepseek-moe-16b"
N_DATA, N_MODEL = 2, 2
B, S = 4, 16  # the layer's and the model's global batch
DTYPES = (torch.float32, torch.bfloat16)
RULES = {"batch": ("data",)}
SHARED = 0.5


def layer_inputs(dtype: torch.dtype, capacity_factor: float | None = None, device: str = "cpu"):
    """(cfg, whole MoE layer params, x (B, S, D), r (B, S, D) f32) from
    seeds, drawn on the CPU and put on ``device``."""
    cfg = get_config(ARCH, smoke=True)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(0)
    params = init_params(moe_spec(cfg), g)
    params = {k: {n: a.to(dtype) for n, a in v.items()} if isinstance(v, dict) else v.to(dtype)
              for k, v in params.items()}
    # the tokens share a component, so the router favours some experts: the
    # default capacity drops (12.5 % of the slots), capacity 8 does not
    x = torch.randn((B, S, cfg.d_model), generator=g) + SHARED * torch.randn(cfg.d_model, generator=g)
    r = torch.randn((B, S, cfg.d_model), generator=g)
    x = x.to(dtype)
    on = (lambda t: t.to(device))
    params = {k: {n: on(a) for n, a in v.items()} if isinstance(v, dict) else on(v) for k, v in params.items()}
    return cfg, params, on(x), on(r)


def rank_leaves(params: dict, cfg, rank: int) -> dict:
    """Rank ``rank``'s layer params (its model index's experts) as new autograd leaves."""
    sliced = expert_slice(params, moe_spec(cfg), rank % N_MODEL, N_MODEL)
    return _leaves(sliced)


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def data_shard(t: torch.Tensor, rank: int) -> torch.Tensor:
    n = t.shape[0] // N_DATA
    d = rank // N_MODEL
    return t[d * n:(d + 1) * n]


def layer_objective(y: torch.Tensor, aux: dict, r: torch.Tensor) -> torch.Tensor:
    """A rank's share of ``(y . r).sum() + lb_loss``: its rows, and lb_loss
    over the data ranks (each holds it whole)."""
    return (y.float() * r).sum() + aux["lb_loss"] / N_DATA


def layer_grads(leaves: dict, x: torch.Tensor) -> dict:
    return {"x": x.grad, "router": leaves["router"]["w"].grad,
            **{n: leaves[n].grad for n in ("wi", "wg", "wo")}}


def simulate_layer(dtype: torch.dtype, capacity_factor: float | None = None, device: str = "cpu"):
    """The one-process simulation of the mesh on :func:`layer_inputs`: ->
    (y of each rank, aux of each rank, gradients of each rank) after the
    backward of the ranks' summed objectives."""
    cfg, params, x, r = layer_inputs(dtype, capacity_factor, device)
    n = N_DATA * N_MODEL
    leaves = [rank_leaves(params, cfg, i) for i in range(n)]
    xs = [data_shard(x, i).clone().requires_grad_(True) for i in range(n)]
    ys, aux = simulate(leaves, xs, cfg, n_data=N_DATA, n_model=N_MODEL)
    sum(layer_objective(y, a, data_shard(r, i)) for i, (y, a) in enumerate(zip(ys, aux))).backward()
    return ys, aux, [layer_grads(p, xi) for p, xi in zip(leaves, xs)]


def model_inputs():
    """(the smoke config with moe_impl="shard_map" at capacity 8 and remat
    "full", the full config's, so that the backward recomputes the exchanges;
    its parameters (f32, as trained); the global batch)."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), moe_impl="shard_map", capacity_factor=8.0,
                              remat="full")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, dtype=torch.int32)
    return cfg, params, {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}


def gloo_rank(rank: int, world: int, store_path: str, out, device: str = "cpu", model: bool = True) -> None:
    """One rank of a (2 data, 2 model) gloo mesh on ``device`` (every rank
    on the one card for "cuda"): the MoE layer's forward and backward at the
    default capacity in f32 and bf16, then, with ``model``, ``Model.loss``
    and its backward with ``moe_impl="shard_map"`` on the CPU. Puts (rank,
    results, error or None) on ``out``, the tensors as numpy."""
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(0)  # every rank on the one card
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
        mesh = make_host_mesh(model_axis=N_MODEL)
        res: dict = {"layer": {}}
        for dtype in DTYPES:
            cfg, params, x, r = layer_inputs(dtype, device=device)
            leaves = rank_leaves(params, cfg, rank)
            xl = data_shard(x, rank).clone().requires_grad_(True)
            y, aux = moe_shard_map(leaves, xl, cfg, mesh=mesh, data_axes=("data",))
            layer_objective(y, aux, data_shard(r, rank)).backward()
            res["layer"][str(dtype)] = {"y": y, **{k: v for k, v in aux.items()}, **layer_grads(leaves, xl)}
        res["imports_repro"] = any(m == "repro" or m.startswith("repro.") for m in sys.modules)
        if not model:
            out.put((rank, _numpy(res), None))
            return
        cfg, params, batch = model_inputs()
        model = Model(cfg, device="cpu")
        leaves = _leaves(expert_slice(params, model.spec(), rank % N_MODEL, N_MODEL))
        reset_exchanged_bytes()
        with sharding_ctx(mesh, RULES):
            loss, _ = model.loss(leaves, {k: data_shard(v, rank) for k, v in batch.items()})
        loss.backward()
        res["model"] = {"loss": loss, "exchanged_bytes": exchanged_bytes(),
                        "grads": _grads(leaves)}
        out.put((rank, _numpy(res), None))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out.put((rank, None, f"{type(e).__name__}: {e}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _grads(tree):
    return {k: _grads(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.grad


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()  # the bits, not rounded
    return tree
