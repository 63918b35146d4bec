"""Thread-local sharding context (a copy of ``repro.sharding.ctx``).

Model code never mentions mesh axes: it annotates activations with *logical*
axes (``shard_activation(x, ("batch", None, None))``). A launcher installs a
context mapping logical -> mesh axes; outside any context the call is the
identity, and so it is on a plain tensor: only a ``DTensor`` is
redistributed, to the placements :func:`activation_spec` gives. So
single-device runs and the smoke tests are untouched.
"""

from __future__ import annotations

import threading
from collections.abc import Sequence
from contextlib import contextmanager

from .rules import Spec, axis_sizes, placements_from_spec

_tls = threading.local()


def set_sharding_ctx(mesh, act_rules: dict[str, object]) -> None:
    _tls.mesh = mesh
    _tls.act_rules = dict(act_rules)


def clear_sharding_ctx() -> None:
    _tls.mesh = None
    _tls.act_rules = None


def current_sharding_ctx():
    """-> (mesh, act_rules) or (None, None) when no context is installed."""
    return getattr(_tls, "mesh", None), getattr(_tls, "act_rules", None)


@contextmanager
def sharding_ctx(mesh, act_rules: dict[str, object]):
    prev = (getattr(_tls, "mesh", None), getattr(_tls, "act_rules", None))
    set_sharding_ctx(mesh, act_rules)
    try:
        yield
    finally:
        _tls.mesh, _tls.act_rules = prev


def activation_spec(shape: Sequence[int], logical_axes: Sequence[str | None], sizes: dict[str, int],
                    rules: dict[str, object]) -> Spec:
    """The spec the JAX package's ``shard_activation`` constrains an
    activation of ``shape`` to: each logical axis's mesh axes, less those an
    earlier dim took, where the dim divides by their product; else None."""
    axes: list = []
    used: set[str] = set()
    for name in logical_axes:
        mapped = rules.get(name) if name else None
        if mapped is None:
            axes.append(None)
            continue
        mapped_t = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        # never reuse a mesh axis within one spec; verify divisibility
        mapped_t = tuple(m for m in mapped_t if m not in used)
        dim = shape[len(axes)]
        size = 1
        for m in mapped_t:
            size *= sizes[m]
        if mapped_t and size and dim % size == 0:
            axes.append(mapped_t if len(mapped_t) > 1 else mapped_t[0])
            used.update(mapped_t)
        else:
            axes.append(None)
    return tuple(axes)


def shard_activation(x, logical_axes: Sequence[str | None]):
    """Redistribute a DTensor ``x`` to its activation placements if a context
    is installed; else (and for a plain tensor) the identity."""
    mesh, rules = current_sharding_ctx()
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = activation_spec(x.shape, logical_axes, axis_sizes(mesh), rules)
    return x.redistribute(x.device_mesh, placements_from_spec(spec, mesh))
