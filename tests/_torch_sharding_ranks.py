"""The ranks of ``tests/test_torch_sharding.py``'s gloo test, in a module of
their own so that a spawned rank imports torch and the port, not JAX."""

from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.modules import tree_leaves
from repro_torch.sharding import local_shape, make_strategy, placements_for, shard_activation, sharding_ctx, spec_for


def gloo_rank(rank: int, world: int, port: int, out) -> None:
    """One of ``world`` ranks on a 2 x 2 (data, model) mesh: every smoke
    parameter of qwen3-4b distributed with its planned placements holds the
    planned local shape and gathers back whole; a replicated activation
    redistributed by ``shard_activation`` is split over data. Puts (rank,
    leaves checked, error or None) on ``out``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
        mesh = make_host_mesh(model_axis=2)
        assert tuple(mesh.shape) == (2, 2) and mesh.mesh_dim_names == ("data", "model")
        g = torch.Generator().manual_seed(0)
        checked = 0
        for preset in ("tp_fsdp", "fsdp_only"):
            strategy = make_strategy(preset)
            for path, s in tree_leaves(Model(get_config("qwen3-4b", smoke=True), device="meta").spec()):
                full = torch.randn(s.shape, generator=g)
                dt = distribute_tensor(full, mesh, placements_for(s, strategy, mesh))
                assert tuple(dt.to_local().shape) == local_shape(tuple(s.shape), spec_for(s, strategy, mesh), mesh)
                assert torch.equal(dt.full_tensor(), full)
                checked += 1
        x = distribute_tensor(torch.randn(4, 6, 8, generator=g), mesh, [Replicate(), Replicate()])
        with sharding_ctx(mesh, make_strategy("tp_fsdp").act_rules):
            y = shard_activation(x, ("batch", None, None))
        assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 6, 8) and torch.equal(y.full_tensor(), x.full_tensor())
        out.put((rank, checked, None))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out.put((rank, 0, f"{type(e).__name__}: {e}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
