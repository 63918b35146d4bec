"""Mixture-of-Experts: shared + routed experts, top-k, sort-based dispatch.

The JAX package's ``models/moe.py``: DeepSeekMoE-style fine-grained experts,
``n_shared`` always-on experts plus ``n_experts`` routed ones with top-k
gating (softmax -> top-k -> renorm), and dispatch with a static capacity:

1. flatten tokens, route, take the top k -> T*K slots tagged with expert ids;
2. sort the slots by expert id (stable); a slot's rank within its expert is
   its position less the expert's first position;
3. slots of rank >= capacity C are dropped; the rest fill a dense (E, C, D)
   buffer, empty rows zero;
4. one batched product per projection runs all experts, (E,C,D) x (E,D,F);
5. each token adds its K outputs, scaled by its gate weights.

Each step runs under the JAX package's scopes (``core/scope.py``): ``moe``
around the whole, and inside it ``router`` (with ``top_k``), ``dispatch``,
``experts``, ``combine``, ``shared_experts`` and ``aux_loss``, so a profile
gives each its device time.

The JAX package has no Pallas kernel here; neither has the port. The expert
products are ``torch.bmm``: under remat "dots" they are recomputed, as the
JAX package's ``dots_with_no_batch_dims_saveable`` recomputes einsums with a
batch dim, while the router's product (an ``aten.mm``) is saved.

:func:`dispatch`, :func:`experts`, :func:`combine` and :func:`balance` are
the steps the expert-parallel MoE (``models/moe_shard_map.py``) runs on a
rank's tokens too, between its exchanges.

Dispatch and combine are gathers through the slot order and its inverse, and
each token's K outputs are added one after another in a fixed order. So
neither the forward nor its autograd backward accumulates into one place from
several threads: two runs on the card give the same bits. Where the JAX
package scatters into the expert buffer, every slot that is kept has a row
of its own, so a gather computes the same values; where it scatters the
outputs back (``y.at[token].add``), it adds a token's K outputs in slot
order, ascending expert id, each add rounded to bf16: so does the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scope import scope as _scope
from repro_torch.sharding.ctx import shard_activation

from .mlp import mlp, mlp_spec
from .modules import ACTIVATIONS, ArraySpec, dtype_const


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    spec = {
        "router": {"w": ArraySpec((d, e), ("embed", "expert"), torch.float32)},
        "wi": ArraySpec((e, d, f), ("expert", "embed", "mlp")),
        "wg": ArraySpec((e, d, f), ("expert", "embed", "mlp")),
        "wo": ArraySpec((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec(d, cfg.n_shared_experts * cfg.moe_d_ff)
    return spec


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    # round up to a multiple of 8, as the JAX package does for its layouts
    return max(8, (c + 7) // 8 * 8)


def route(params, xt: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) -> (probs (T, E) f32, gate weights (T, K) f32, expert ids
    (T, K)). The logits are an f32 product, as ``jnp.einsum`` promotes the
    f32 activations against a router the scan stores in bf16. The top k are
    the first K of a stable descending sort: among equal probabilities the
    lower expert id comes first, as ``jax.lax.top_k`` gives them."""
    with _scope("router"):
        probs = torch.softmax(xt.float() @ params["router"]["w"].float(), dim=-1)
        with _scope("top_k"):
            top = torch.sort(probs, dim=-1, descending=True, stable=True)
            gate_w, gate_ids = top.values[:, : cfg.top_k], top.indices[:, : cfg.top_k]
            return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), gate_ids


def _add_in_order(contrib: torch.Tensor) -> torch.Tensor:
    """(T, K, D) -> contrib[:, 0] + contrib[:, 1] + ... + contrib[:, K-1],
    each add rounded to contrib's dtype, as the JAX package's compiled
    scatter-add of the combine rounds them."""
    y = contrib[:, 0]
    for k in range(1, contrib.shape[1]):
        y = y + contrib[:, k]
    return y


def moe(params, x: torch.Tensor, cfg, *, scope: str = "moe") -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D), aux {"lb_loss", "dropped_frac",
    "expert_frac"} as the JAX package's ``moe`` returns them."""
    with _scope(scope):
        return _moe(params, x, cfg)


class Slots(NamedTuple):
    """Where :func:`dispatch` put each slot, for :func:`combine`: the slots
    (t, k), flattened as t*K + k, in the order of a stable sort by expert id,
    each sorted slot's buffer row (expert * C + its rank within the expert),
    whether it was kept (rank < C), and the slots each expert was sent."""

    order: torch.Tensor  # sorted position -> flat slot
    row: torch.Tensor  # sorted position -> buffer row
    kept: torch.Tensor  # sorted position -> rank < C
    counts: torch.Tensor  # expert -> slots routed to it, dropped ones included


def dispatch(xt: torch.Tensor, gate_ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, Slots]:
    """xt (T, D), gate_ids (T, K) -> the (E, C, D) expert buffer, empty rows
    zero, and its :class:`Slots`. The buffer is a gather: row c of expert e
    reads sorted slot starts[e] + c where c < counts[e]."""
    T, D = xt.shape
    K = gate_ids.shape[1]
    dev = xt.device
    flat_ids = gate_ids.reshape(-1)
    order = torch.sort(flat_ids, stable=True).indices
    sorted_ids = flat_ids[order]
    bounds = torch.searchsorted(sorted_ids, torch.arange(E + 1, device=dev), side="left")
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    rank = torch.arange(T * K, device=dev) - starts[sorted_ids]
    # the other rows read a clamped position and are zeroed
    cap = torch.arange(C, device=dev)
    filled = cap < counts[:, None]  # (E, C)
    src = order[(starts[:, None] + cap).clamp_max(T * K - 1)]  # (E, C) flat slot of each row
    # indexing the K-fold view (not xt itself): each (t, k) is read once, so
    # the backward sums a token's K gradients over the K axis in order
    slot_vals = shard_activation(xt[:, None, :].expand(T, K, D), ("batch", None, None))
    buf = slot_vals[src // K, src % K].masked_fill(~filled[..., None], 0)
    return buf, Slots(order, sorted_ids * C + rank, rank < C, counts)


def combine(y_rows: torch.Tensor, slots: Slots, gate_ids: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """y_rows (E*C, D), the experts' outputs by buffer row -> y (T, D): each
    token's K outputs scaled by its gate weights and added in ascending
    expert id (the JAX scatter's order: the sorted slots), gathered back
    through the inverse of ``slots.order``; a dropped slot adds 0."""
    T, K = gate_ids.shape
    inverse = torch.empty_like(slots.order)
    inverse[slots.order] = torch.arange(T * K, device=slots.order.device)  # flat slot -> sorted position
    row, kept = slots.row[inverse].view(T, K), slots.kept[inverse].view(T, K)
    by_expert = gate_ids.argsort(dim=-1)
    row, kept = row.gather(1, by_expert), kept.gather(1, by_expert)
    w = gate_w.gather(1, by_expert).to(y_rows.dtype)
    gathered = y_rows[row.clamp_max(y_rows.shape[0] - 1)].masked_fill(~kept[..., None], 0)  # (T, K, D)
    gathered = shard_activation(gathered, ("batch", None, None))
    return shard_activation(_add_in_order(gathered * w[..., None]), ("batch", None))


def experts(buf: torch.Tensor, params, act: str) -> torch.Tensor:
    """The routed experts on their rows: (E, C, D) -> (E, C, D), one batched
    product per projection."""
    f = ACTIVATIONS[act]
    h = torch.bmm(buf, params["wi"].to(buf.dtype))
    g = torch.bmm(buf, params["wg"].to(buf.dtype))
    return torch.bmm(f(g) * h, params["wo"].to(buf.dtype))


def _moe(params, x: torch.Tensor, cfg) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, D)
    probs, gate_w, gate_ids = route(params, xt, cfg)

    with _scope("dispatch"):
        buf, slots = dispatch(xt, gate_ids, E, C)
        # EP: the expert buffer on the expert-parallel axis
        buf = shard_activation(buf, ("expert_buf", None, None))

    with _scope("experts"):
        y_e = shard_activation(experts(buf, params, cfg.act), ("expert_buf", None, None)).reshape(E * C, D)

    with _scope("combine"):
        y = combine(y_e, slots, gate_ids, gate_w)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xt, act=cfg.act, scope="shared_experts")

    with _scope("aux_loss"):
        frac, lb_loss, dropped = balance(slots.counts.float(), slots.kept.sum(), probs.mean(0), T * K, E)
    aux = {"lb_loss": lb_loss, "dropped_frac": dropped, "expert_frac": frac}
    return y.reshape(B, S, D), aux


def balance(counts: torch.Tensor, kept: torch.Tensor, mean_prob: torch.Tensor, n_slots: int, E: int):
    """-> (expert fractions, load-balance loss, dropped fraction) from the
    slots each expert was sent (f32), the slots kept and the mean router
    probabilities, over ``n_slots`` = T*K slots.

    Switch-style load balancing: E * sum_e fraction_e * prob_e; the
    fractions come from counts and carry no gradient. Compiled, the JAX
    package divides by T*K as a product with its f32 reciprocal, and computes
    1 - kept * reciprocal as one fused multiply-add (one rounding: the f64
    product and difference below are exact), so a batch that drops nothing
    reads a dropped fraction of about -2e-8 where T*K is no power of 2; the
    port gives the same values."""
    recip = dtype_const(1.0 / n_slots, torch.float32)
    frac = counts * recip
    lb_loss = E * torch.sum(frac * mean_prob)
    dropped = (1.0 - kept.double() * recip).float()
    return frac, lb_loss, dropped
