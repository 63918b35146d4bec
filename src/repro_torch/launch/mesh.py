"""Mesh shapes (the counterpart of ``repro.launch.mesh``).

The production meshes are planned, not run: one card has no 256 peers, so
:func:`make_production_mesh` gives a :class:`MeshShape` (named axis sizes)
that the sharding rules and the dry-run read without a process group.
:func:`make_host_mesh` gives a ``DeviceMesh`` over the world the process has
where a process group is initialised, else the mesh of one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.sharding.rules import axis_sizes


@dataclass(frozen=True)
class MeshShape:
    """A mesh's named axes and their sizes, in order (``.shape`` is a dict,
    as a JAX mesh's)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def name(self) -> str:
        """'16x16', '2x16x16', '1x1': the dry-run's mesh tag."""
        return "x".join(map(str, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2x16x16 = 512 chips across two pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(model_axis: int = 1):
    """A (data, model) mesh over the ranks of the initialised process group
    (a ``DeviceMesh``, on cuda where the process has a card); a
    ``MeshShape`` of (1, 1) where none is initialised."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if model_axis != 1:
            raise ValueError(f"no process group: a host mesh of one device has no model axis of {model_axis}")
        return MeshShape(("data", "model"), (1, 1))
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of {model_axis}")
    from torch.distributed.device_mesh import init_device_mesh

    device = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device, (n // model_axis, model_axis), mesh_dim_names=("data", "model"))


def mesh_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())
