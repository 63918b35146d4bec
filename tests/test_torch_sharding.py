"""The port's sharding rules (``repro_torch.sharding``, ``launch.mesh``)
against the JAX package's on the same specs and mesh shapes, on the CPU.

* ``spec_for`` equals ``repro.sharding.spec_for`` for every parameter of
  every arch (the port's spec tree beside the JAX package's), every preset
  and both production meshes, (16, 16) and (2, 16, 16); the placements
  shard exactly the mesh dims the spec names, and ``local_shape`` divides
  exactly those dims;
* the dry-run's batch and decode-state shardings equal JAX's, built on
  ``jax.sharding.AbstractMesh`` (no 256 devices are forced);
* ``activation_spec`` (the loop inside ``shard_activation``) on drawn
  shapes uses a mesh axis at most once and shards only a dim that divides;
* four gloo ranks on a 2 x 2 mesh: ``distribute_tensor`` with the planned
  placements gives each rank ``local_shape``, and ``shard_activation``
  redistributes a DTensor inside a context.
"""

from __future__ import annotations

import functools
import math
import socket

import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from _jax_dryrun import jax_dryrun  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.modules import is_spec as jax_is_spec  # noqa: E402
from repro.sharding import make_strategy as jax_make_strategy  # noqa: E402
from repro.sharding import spec_for as jax_spec_for  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_host_mesh, make_production_mesh, mesh_chips  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    activation_spec,
    local_shape,
    make_strategy,
    placements_for,
    shard_activation,
    sharding_ctx,
    spec_for,
)
from repro_torch.sharding.rules import entry_axes  # noqa: E402

ARCHS = list_archs()
PRESETS = ("tp_fsdp", "tp_only", "fsdp_only", "ddp")
MESHES = {"16x16": False, "2x16x16": True}


class _StubMesh:
    """What ``repro.sharding.spec_for`` reads of a mesh: ``.shape``."""

    def __init__(self, mesh: MeshShape):
        self.shape = mesh.shape


def _norm(spec, ndim: int) -> tuple:
    """A spec (the port's tuple or a PartitionSpec) as one tuple of mesh axes per dim."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(entry_axes(e) for e in entries)


@functools.lru_cache(maxsize=None)
def _specs(arch: str) -> tuple[dict, dict]:
    """(the JAX spec tree's leaves, the port's) by path."""
    jax_leaves = jax.tree_util.tree_flatten_with_path(JaxModel(jax_config(arch)).spec(), is_leaf=jax_is_spec)[0]
    jl = {tuple(k.key for k in path): s for path, s in jax_leaves}
    return jl, dict(tree_leaves(Model(get_config(arch), device="meta").spec()))


def test_the_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.name == "16x16" and mesh_chips(single) == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.name == "2x16x16" and mesh_chips(multi) == 512
    assert make_host_mesh() == MeshShape(("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="no process group"):
        make_host_mesh(model_axis=2)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_and_placements_match_jax(arch, preset, mesh_name):
    from torch.distributed.tensor import Replicate, Shard

    multi = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod=multi)
    jl, pl = _specs(arch)
    assert set(jl) == set(pl)
    strategy, jstrategy = make_strategy(preset, multi_pod=multi), jax_make_strategy(preset, multi_pod=multi)
    names = list(mesh.shape)
    sharded = 0
    for path, s in pl.items():
        assert (tuple(s.shape), tuple(s.logical)) == (tuple(jl[path].shape), tuple(jl[path].logical)), path
        spec = spec_for(s, strategy, mesh)
        assert _norm(spec, len(s.shape)) == _norm(jax_spec_for(jl[path], jstrategy, _StubMesh(mesh)), len(s.shape))
        placements = placements_for(s, strategy, mesh)
        assert len(placements) == len(names)
        for i, name in enumerate(names):
            dims = [d for d, e in enumerate(spec) if name in entry_axes(e)]
            assert placements[i] == (Shard(dims[0]) if dims else Replicate()), (path, name, placements)
        local = local_shape(tuple(s.shape), spec, mesh)
        for d, (n, m) in enumerate(zip(s.shape, local)):
            assert n == m * math.prod(mesh.shape[a] for a in entry_axes(spec[d]))
        sharded += local != tuple(s.shape)
    assert (sharded == 0) == (preset == "ddp")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_state_shardings_match_jax(arch, shape_name, mesh_name):
    jdr = jax_dryrun()
    multi = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod=multi)
    amesh = AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
    batch_axes = tuple(make_strategy("tp_fsdp", multi_pod=multi).act_rules["batch"])
    jm, model = JaxModel(jax_config(arch)), Model(get_config(arch), device="meta")
    jshape, shape = JAX_SHAPES[shape_name], SHAPES[shape_name]
    jbatch = jm.input_specs(jshape)
    jb = jdr.batch_shardings(jbatch, amesh, batch_axes)
    pb = dryrun.batch_specs(model.input_specs(shape), mesh, batch_axes)
    assert set(pb) == set(jb)
    for k in jb:
        n = len(jbatch[k].shape)
        assert _norm(pb[k], n) == _norm(jb[k].spec, n), k
    placements = dryrun.batch_shardings(model.input_specs(shape), mesh, batch_axes)
    assert set(placements) == set(pb)
    if shape.kind != "decode":
        return
    jstate = jm.abstract_decode_state(jshape.global_batch, jshape.seq_len)
    js = jdr.state_shardings(jstate, amesh, batch_axes)
    jflat = {tuple(k.key for k in p): (leaf, sh) for (p, leaf), sh in
             zip(jax.tree_util.tree_flatten_with_path(jstate)[0], jax.tree_util.tree_leaves(js))}
    state = model.abstract_decode_state(shape.global_batch, shape.seq_len)
    ps = dict(tree_leaves(dryrun.state_specs(state, mesh, batch_axes)))
    assert set(ps) == set(jflat)
    for path, leaf in tree_leaves(state):
        jleaf, jsh = jflat[path]
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        assert _norm(ps[path], leaf.ndim) == _norm(jsh.spec, leaf.ndim), path


def test_a_partition_spec_normalises_as_the_port_spec():
    assert _norm(PartitionSpec(("data",), None), 2) == _norm(("data", None), 2) == (("data",), ())


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_activation_spec_uses_a_mesh_axis_once_and_only_where_it_divides(data):
    ndim = data.draw(st.integers(1, 4))
    shape = [data.draw(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64])) for _ in range(ndim)]
    logical = [data.draw(st.sampled_from([None, "batch", "expert_buf", "ctx_chunk"])) for _ in range(ndim)]
    sizes = {"pod": data.draw(st.sampled_from([1, 2])), "data": data.draw(st.sampled_from([1, 2, 4, 16])),
             "model": data.draw(st.sampled_from([1, 2, 4, 16]))}
    rules = make_strategy(data.draw(st.sampled_from(PRESETS)), multi_pod=True).act_rules
    spec = activation_spec(shape, logical, sizes, rules)
    used = [a for e in spec for a in entry_axes(e)]
    assert len(used) == len(set(used))
    for dim, name, entry in zip(shape, logical, spec):
        axes = entry_axes(entry)
        assert dim % math.prod(sizes[a] for a in axes) == 0
        if axes:
            assert name is not None and set(axes) <= set(entry_axes(rules[name]))


def test_shard_activation_is_the_identity_outside_a_context_and_on_a_plain_tensor():
    x = torch.ones(4, 8, 16)
    assert shard_activation(x, ("batch", None, None)) is x
    with sharding_ctx(make_production_mesh(), make_strategy("tp_fsdp").act_rules):
        assert shard_activation(x, ("batch", None, None)) is x


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distribute_tensor_gives_each_of_four_gloo_ranks_its_local_shape():
    import torch.multiprocessing as mp

    from _torch_sharding_ranks import gloo_rank

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=gloo_rank, args=(r, 4, port, out)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert sorted(r for r, _, _ in results) == [0, 1, 2, 3]
    assert all(err is None for _, _, err in results), results
    assert all(n > 0 for _, n, _ in results)
