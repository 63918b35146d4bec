"""Logical-axis -> mesh-axis rules (MaxText-style), per parallelism strategy:
a copy of ``repro.sharding.rules`` with DTensor placements beside the specs.

A :class:`Strategy` maps each *logical* parameter axis (``"embed"``,
``"mlp"``, ``"q_heads"``, ``"expert"``, ...) to zero or more mesh axes, plus
activation rules (``"batch"`` -> ``("pod", "data")``). :func:`spec_for`
resolves an :class:`~repro_torch.models.modules.ArraySpec` into the content of
the JAX package's ``PartitionSpec``, a tuple with one entry per tensor dim
(``None``, a mesh-axis name, or a tuple of names), enforcing:

* divisibility: a dim that does not divide by its mesh axes' product stays
  replicated (8 KV heads on a 16-way model axis: the KV weights replicate
  across tensor parallelism, the Megatron GQA convention);
* uniqueness: a mesh axis is used at most once per spec (the first logical
  axis in declaration order wins).

:func:`placements_for` turns a spec into ``torch.distributed.tensor``
placements, one per mesh dim in the mesh's order (a dim sharded over
``("pod", "data")`` is ``Shard(d)`` on both, pod first, as the JAX spec splits
it), and :func:`local_shape` gives the shard a rank holds. A mesh is anything
with named axis sizes: a ``launch.mesh.MeshShape`` (``.shape`` a dict), a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, so the
rules run without a process group.

Strategies are plain data: a strategy is changed by swapping rule tables,
never by touching model code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # the models import this package's ctx: no import of them here
    from repro_torch.models.modules import ArraySpec

AxisMap = dict[str, str | tuple[str, ...] | None]
Spec = tuple  # per tensor dim: None, a mesh-axis name, or a tuple of names


def axis_sizes(mesh) -> dict[str, int]:
    """A mesh's axis sizes by name, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(mesh.shape, dict):  # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def entry_axes(entry) -> tuple[str, ...]:
    """One spec entry's mesh axes: () for None, (name,) for a name."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class Strategy:
    name: str
    param_rules: AxisMap
    act_rules: AxisMap
    # logical axes whose sharding is load-bearing (EP experts etc.), checked
    # by tests so a silent fallback cannot drop them
    required: tuple[str, ...] = ()

    def mesh_axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        m = self.param_rules.get(logical)
        if m is None:
            return ()
        return (m,) if isinstance(m, str) else tuple(m)


def spec_for(aspec: ArraySpec, strategy: Strategy, mesh) -> Spec:
    sizes = axis_sizes(mesh)
    axes: list = []
    used: set[str] = set()
    for dim, logical in zip(aspec.shape, aspec.logical, strict=True):
        mapped = tuple(m for m in strategy.mesh_axes_for(logical) if m not in used)
        size = 1
        for m in mapped:
            size *= sizes[m]
        if mapped and size > 1 and dim % size == 0:
            axes.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
        else:
            axes.append(None)
    return tuple(axes)


def placements_from_spec(spec: Spec, mesh) -> list:
    """A spec -> DTensor placements, one per mesh dim in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for name in entry_axes(entry):
            out[names.index(name)] = Shard(d)
    return out


def placements_for(aspec: ArraySpec, strategy: Strategy, mesh) -> list:
    """``spec_for`` as DTensor placements (``Shard(d)`` / ``Replicate()``)."""
    return placements_from_spec(spec_for(aspec, strategy, mesh), mesh)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shard of a tensor of ``shape`` that one rank holds under ``spec``
    (every sharded dim divides: ``spec_for`` shards no other)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for name in entry_axes(entry):
            n *= sizes[name]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry_axes(entry)} ({n})")
        out.append(dim // n)
    return tuple(out)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def params_shardings(spec_tree, strategy: Strategy, mesh):
    """The placements tree of a params spec tree (the JAX package's
    ``NamedSharding`` tree)."""
    return _tree_map(lambda s: placements_for(s, strategy, mesh), spec_tree)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def make_strategy(
    name: str,
    *,
    multi_pod: bool = False,
    fsdp_over_pod: bool = True,
) -> Strategy:
    """Build a strategy preset for the production mesh.

    Presets:
      tp_fsdp  - TP over 'model' for wide axes (vocab/mlp/heads/experts),
                 FSDP (ZeRO-3) over 'data' (+'pod' when multi_pod and
                 fsdp_over_pod) for the embed axis; batch over (pod, data).
      tp_only  - TP over 'model'; weights otherwise replicated (pure DP+TP).
      fsdp_only- ZeRO-3 without TP (all wide axes replicated).
      ddp      - pure data parallelism (all weights replicated).
    """
    fsdp: tuple[str, ...] = ("data",)
    batch: tuple[str, ...] = ("data",)
    if multi_pod:
        batch = ("pod", "data")
        if fsdp_over_pod:
            fsdp = ("pod", "data")
    common_acts: AxisMap = {"batch": batch, "expert_buf": "model", "ctx_chunk": "model"}
    if name == "tp_fsdp":
        return Strategy(
            name,
            param_rules={
                "vocab": "model",
                "mlp": "model",
                "q_heads": "model",
                "kv_heads": "model",
                "expert": "model",
                "state_out": "model",
                "embed": fsdp,
                "state": fsdp,
            },
            act_rules=common_acts,
            required=("expert",),
        )
    if name == "tp_only":
        return Strategy(
            name,
            param_rules={
                "vocab": "model",
                "mlp": "model",
                "q_heads": "model",
                "kv_heads": "model",
                "expert": "model",
                "state_out": "model",
            },
            act_rules=common_acts,
            required=("expert",),
        )
    if name == "fsdp_only":
        return Strategy(
            name,
            param_rules={"embed": fsdp, "state": fsdp, "expert": "model"},
            act_rules=common_acts,
        )
    if name == "ddp":
        return Strategy(name, param_rules={}, act_rules={"batch": batch})
    raise ValueError(f"unknown strategy {name}")
