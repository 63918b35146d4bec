"""Expert-parallel MoE: the experts sharded over the mesh's ``model`` axis,
the tokens exchanged by an all-to-all (the JAX package's
``models/moe_shard_map.py``, its ``moe_impl="shard_map"``).

:func:`moe_shard_map` is one rank's view, as the body of the JAX package's
``shard_map`` is: ``x`` is the rank's batch shard (B / n_data, S, D), the
routed experts ``wi``, ``wg``, ``wo`` are its E / n_model experts
(``params.expert_slice``), the router and the shared experts are whole. Per
rank, JAX's ``local_moe`` under its scope names:

1. ``router``: route the T_loc local tokens (top k from a stable sort);
2. ``local_dispatch``: the slots, sorted by expert id, into a local
   (E, C_s, D) buffer, C_s = :func:`_local_capacity` slots an expert takes
   from one source rank; viewed as (n_model, E_loc, C_s, D);
3. ``a2a_dispatch``: block g goes to model rank g, so each rank receives
   the slots of its own experts from every rank of its model group;
4. ``experts``: the local experts on (E_loc, n_model * C_s, D);
5. ``a2a_combine``: the reverse exchange; ``local_combine``: each token adds
   its K outputs in sorted-slot order (ascending expert id), each add
   rounded to ``x.dtype``, as the dense MoE (``models/moe.py``) does;
6. ``aux_loss``: the expert counts and kept slots summed over the data axes
   and the mean probabilities averaged over them (JAX's ``psum`` and
   ``pmean``), so every rank holds the same aux;

then ``shared_experts`` on the rank's tokens, outside the exchange.

Where the ``batch`` rule maps to the data axes only, ``x`` is replicated
over ``model``: every model rank of a data group dispatches the same tokens,
and each expert computes n_model copies of them. The JAX package does the
same, and so does the port.

**Gradients.** The autograd of a rank's loss gives that rank's share of the
JAX package's gradient, by the transpose rules of JAX's ``shard_map``
(``check_rep=False``) at its boundary: the cotangent of an output
replicated over ``model`` (y and the load-balance loss) is divided by
n_model, that of an input replicated over ``model`` (the tokens, the router)
is summed over the model group, and ``psum``'s transpose is ``psum``. The
sum over the data axes of a parameter's gradient is data parallelism's and
is left to the caller: summed over the data ranks, the experts', router's
and every replicated weight's gradients are the JAX package's. A tiled
all-to-all is its own transpose, so the exchange's backward is the same
exchange.

**The exchange** (:func:`exchange`) is ``torch.distributed``'s
``all_to_all_single`` of the (n_model, E_loc, C_s, D) buffer over the
mesh's ``model`` group; the sums over the data axes are ``all_reduce`` over
each data axis's group (the ranks that share a model index). With one
``model`` rank the exchange is the identity. With more and no process group
it raises. On meta tensors (the dry-run, ``launch/dryrun.py``) it returns
the buffer's shape and reports the bytes a rank sends, ``nbytes * (n - 1) /
n``, to the tracer under ``coll_bytes::all-to-all``; the sums are the
identity there. :func:`exchanged_bytes` counts what this process sent.

:func:`simulate` runs all n_data x n_model ranks in one process, the same
per-rank code with the collectives done by moving blocks and summing in
rank order: the oracle the tests and ``chip_smoke.py`` hold a process group's
ranks to, to the bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import meta_cost
from repro_torch.core.scope import scope as _scope
from repro_torch.sharding.rules import axis_sizes

from .mlp import mlp
from .moe import balance, combine, dispatch, experts, route

_EXCHANGED_BYTES = 0  # bytes this process sent to other ranks through the exchange


def exchanged_bytes() -> int:
    return _EXCHANGED_BYTES


def reset_exchanged_bytes() -> None:
    global _EXCHANGED_BYTES
    _EXCHANGED_BYTES = 0


def _local_capacity(t_loc: int, cfg) -> int:
    """Slots an expert takes from one source rank of T_loc tokens: a multiple
    of 4, at least 4 (the dense path's ``_capacity`` rounds to 8)."""
    c = int(t_loc * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, (c + 3) // 4 * 4)


# ---------------------------------------------------------------------------
# The collectives of one rank, over a mesh's process groups
# ---------------------------------------------------------------------------


def exchange(buf: torch.Tensor, group, n: int) -> torch.Tensor:
    """The tiled all-to-all of ``buf`` (n, ...) over ``group`` (n ranks):
    block j goes to rank j, and block i of the result came from rank i."""
    if n == 1:
        return buf
    if buf.device.type == "meta":
        meta_cost.record_collective("all-to-all", buf.numel() * buf.element_size() * (n - 1) / n)
        return torch.empty_like(buf)
    if group is None:
        raise RuntimeError(f"an all-to-all over {n} model ranks needs a process group")
    import torch.distributed as dist

    global _EXCHANGED_BYTES
    _EXCHANGED_BYTES += buf.numel() * buf.element_size() * (n - 1) // n
    out = torch.empty_like(buf, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, buf.contiguous(), group=group)
    return out


def _all_reduce(t: torch.Tensor, groups: list) -> torch.Tensor:
    """The sum of ``t`` over each (group, size) of ``groups`` in turn (a copy)."""
    for group, n in groups:
        if n == 1 or t.device.type == "meta":
            continue
        if group is None:
            raise RuntimeError(f"a sum over {n} ranks needs a process group")
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=group)
    return t


class _Exchange(torch.autograd.Function):
    """:func:`exchange`, whose transpose is itself."""

    @staticmethod
    def forward(ctx, buf, group, n):
        ctx.group, ctx.n = group, n
        return exchange(buf, group, n)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group, ctx.n), None, None


class _Psum(torch.autograd.Function):
    """JAX's ``psum`` over the groups: the sum forward, and the sum backward."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_reduce(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _SumGrad(torch.autograd.Function):
    """An input replicated over the groups: the identity forward, its
    cotangent summed over them backward."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _DivGrad(torch.autograd.Function):
    """An output replicated over n ranks: the identity forward, its
    cotangent divided by n backward."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _div_grad(t: torch.Tensor, n: int) -> torch.Tensor:
    return t if n == 1 else _DivGrad.apply(t, n)


class _MeshComm:
    """The collectives of the one rank this process is, over ``mesh``: a
    ``DeviceMesh`` (its ``model`` group and each data axis's group), or a
    ``MeshShape``, which has no process group (meta tensors only)."""

    def __init__(self, mesh, data_axes: tuple[str, ...]):
        sizes = axis_sizes(mesh)
        self.n_model = sizes["model"]
        self.n_data = math.prod(sizes[a] for a in data_axes)
        groups = hasattr(mesh, "get_group")
        self.model = [(mesh.get_group("model") if groups and self.n_model > 1 else None, self.n_model)]
        self.data = [(mesh.get_group(a) if groups and sizes[a] > 1 else None, sizes[a]) for a in data_axes]

    def exchange(self, bufs: list) -> list:
        return [_Exchange.apply(bufs[0], self.model[0][0], self.n_model)]

    def psum_data(self, ts: list) -> list:
        return [_Psum.apply(ts[0], self.data)]

    def sum_grad_model(self, ts: list) -> list:
        return [_SumGrad.apply(ts[0], self.model)]


# ---------------------------------------------------------------------------
# One process that runs every rank (the simulation)
# ---------------------------------------------------------------------------


def _sum_in_order(ts: list) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


class _SimExchange(torch.autograd.Function):
    """The exchange over each model group of the ranks' buffers, by moving
    blocks: rank m's block j becomes block m of rank j. Its own transpose."""

    @staticmethod
    def forward(ctx, groups, *bufs):
        ctx.groups = groups
        return _SimExchange.move(groups, bufs)

    @staticmethod
    def move(groups, bufs):
        out = [None] * len(bufs)
        for g in groups:
            for i, r in enumerate(g):
                out[r] = torch.stack([bufs[s][i] for s in g])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_SimExchange.move(ctx.groups, gs))


class _SimPsum(torch.autograd.Function):
    """``psum`` over each group of the ranks' tensors, added in rank order;
    the same sum backward."""

    @staticmethod
    def forward(ctx, groups, *ts):
        ctx.groups = groups
        return _SimPsum.sum(groups, ts)

    @staticmethod
    def sum(groups, ts):
        out = [None] * len(ts)
        for g in groups:
            s = _sum_in_order([ts[r] for r in g])
            for r in g:
                out[r] = s.clone()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_SimPsum.sum(ctx.groups, gs))


class _SimSumGrad(torch.autograd.Function):
    """The identity forward; each rank's cotangent summed over its group backward."""

    @staticmethod
    def forward(ctx, groups, *ts):
        ctx.groups = groups
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_SimPsum.sum(ctx.groups, gs))


class _SimComm:
    """The collectives of all n_data x n_model ranks, rank r = d * n_model + m."""

    def __init__(self, n_data: int, n_model: int):
        self.n_data, self.n_model = n_data, n_model
        self.model_groups = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
        self.data_groups = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]

    def exchange(self, bufs: list) -> list:
        return list(_SimExchange.apply(self.model_groups, *bufs))

    def psum_data(self, ts: list) -> list:
        return list(_SimPsum.apply(self.data_groups, *ts))

    def sum_grad_model(self, ts: list) -> list:
        return list(_SimSumGrad.apply(self.model_groups, *ts))


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def _local_moe(params: list, xts: list, cfg, comm) -> tuple[list, list]:
    """JAX's ``local_moe`` for the ranks ``comm`` runs: params[r] (the router
    whole, E_loc experts) and xts[r] (T_loc, D) -> (y[r] (T_loc, D), aux[r])."""
    E, K = cfg.n_experts, cfg.top_k
    n_data, n_model = comm.n_data, comm.n_model
    E_loc = E // n_model
    T_loc, D = xts[0].shape
    C_s = _local_capacity(T_loc, cfg)
    for p in params:
        if p["wi"].shape[0] != E_loc:
            raise ValueError(f"a rank holds {p['wi'].shape[0]} experts, not {E} / {n_model} model ranks")
    xts = comm.sum_grad_model(xts)
    routers = comm.sum_grad_model([p["router"]["w"] for p in params])
    routes = [route({"router": {"w": w}}, xt, cfg) for w, xt in zip(routers, xts)]
    # each step drops its input's references: at full width a buffer is GBs
    with _scope("local_dispatch"):
        bufs, slots = zip(*(dispatch(xt, ids, E, C_s) for xt, (_, _, ids) in zip(xts, routes)))
        bufs = [b.reshape(n_model, E_loc, C_s, D) for b in bufs]
    with _scope("a2a_dispatch"):
        bufs = comm.exchange(bufs)
        # bufs[r][j]: source j's slots for rank r's experts
        bufs = [b.movedim(0, 1).reshape(E_loc, n_model * C_s, D) for b in bufs]
    with _scope("experts"):
        bufs = [experts(b, p, cfg.act) for b, p in zip(bufs, params)]
    with _scope("a2a_combine"):
        bufs = comm.exchange([b.reshape(E_loc, n_model, C_s, D).movedim(1, 0) for b in bufs])
    with _scope("local_combine"):
        ys = [combine(b.reshape(E * C_s, D), s, ids, w) for b, s, (_, w, ids) in zip(bufs, slots, routes)]
        del bufs
    with _scope("aux_loss"):
        counts = comm.psum_data([s.counts.float() for s in slots])
        kept = comm.psum_data([s.kept.sum() for s in slots])
        mean_prob = comm.psum_data([probs.mean(0) for probs, _, _ in routes])
        aux = []
        for c, k, m in zip(counts, kept, mean_prob):
            frac, lb_loss, dropped = balance(c, k, m / n_data, T_loc * n_data * K, E)
            aux.append({"lb_loss": _div_grad(lb_loss, n_model), "dropped_frac": dropped, "expert_frac": frac})
    return [_div_grad(y, n_model) for y in ys], aux


def _finish(params, x: torch.Tensor, y: torch.Tensor, cfg) -> torch.Tensor:
    B, S, D = x.shape
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x.reshape(B * S, D), act=cfg.act, scope="shared_experts")
    return y.reshape(B, S, D)


def moe_shard_map(params, x: torch.Tensor, cfg, *, mesh, data_axes: tuple[str, ...],
                  scope: str = "moe_ep") -> tuple[torch.Tensor, dict]:
    """One rank's expert-parallel MoE. x: the rank's (B / n_data, S, D);
    params: the router and shared experts whole, E / n_model routed experts.
    -> (y (B / n_data, S, D), aux {"lb_loss", "dropped_frac",
    "expert_frac"}, the same on every rank)."""
    B, S, D = x.shape
    with _scope(scope):
        (y,), (aux,) = _local_moe([params], [x.reshape(B * S, D)], cfg, _MeshComm(mesh, tuple(data_axes)))
        return _finish(params, x, y, cfg), aux


def simulate(params: list, xs: list, cfg, *, n_data: int, n_model: int) -> tuple[list, list]:
    """Every rank of an (n_data, n_model) mesh in this process: params[r] and
    xs[r] are rank r = d * n_model + m's, as :func:`moe_shard_map` takes them.
    -> ([y of each rank], [aux of each rank]). Each rank's inputs are its
    own tensors, so their gradients are each rank's."""
    if len(params) != n_data * n_model or len(xs) != n_data * n_model:
        raise ValueError(f"{n_data} x {n_model} ranks, {len(params)} params and {len(xs)} inputs")
    B, S, D = xs[0].shape
    ys, aux = _local_moe(params, [x.reshape(B * S, D) for x in xs], cfg, _SimComm(n_data, n_model))
    return [_finish(p, x, y, cfg) for p, x, y in zip(params, xs, ys)], aux
