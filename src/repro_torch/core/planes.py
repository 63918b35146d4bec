"""Unified host+device planes: roofline-annotated profiles on one CallTree
(a copy of ``repro.core.planes``, with the H100 as the default spec).

The paper's claim is that the profiler's call-stack reflects the simulated
architecture; our two planes are the sampled Python host stack and the
device tree of one profiled step (``core/device_tree.py``, the port's
counterpart of the JAX package's HLO cost tree).  This module is
the bridge: it grafts the device-plane cost model onto the sampled host tree
so one profile answers both "where does host time go" and "which
architectural component is the roofline bottleneck, and why".

Three coherent views over the same profile:

* ``host``   — today's sampled tree, untouched;
* ``device`` — the device tree (``flops``/``bytes``/``coll_bytes``/``ops``
               counters, and on the card ``device_ms``, attributed to the
               paths of named ranges);
* ``merged`` — the host tree with device-plane annotations as *ordinary*
               metric keys on each matched node (see below), so they survive
               the snapshot codec, ``CallTree.diff``, folded/speedscope
               exports, and ``share_regressions`` gating with zero special
               cases.

Matching is by node *name*, flatten-view semantics: a host frame — a
module function named like its range (``attention``, ``mlp``, ``moe``), a
kernel wrapper call-site (``flash_attention``, ``fused_rmsnorm``,
``rglru_scan``), or a jit dispatch frame — matches every device node with the same normalized
name (``jit(step)`` heads normalize to ``step``), and their inclusive HLO
metrics are summed.  Unmatched host nodes inherit the sum of their children,
so thread roots and glue frames aggregate their matched descendants and the
merged root carries the full matched totals.

Annotation metric keys written onto merged-plane nodes (the ``hlo_`` prefix
is kept, though the port's device tree comes from a profile and not from
HLO: these key names are the merged plane's contract with every view, the
snapshot codec and ``share_regressions``, shared with the JAX package):

* ``hlo_flops`` / ``hlo_bytes`` / ``hlo_coll_bytes`` / ``hlo_ops`` — the HLO
  subtree cost attributed to that host node;
* ``rt_compute`` / ``rt_memory`` / ``rt_collective`` — the three roofline
  term times (seconds) those costs imply on the hardware spec;
* ``roofline_occupancy`` — the node's bound time (max of its three terms) as
  a fraction of the root's roofline step time: "this component accounts for
  X% of the step's roofline bound" (root = 1.0);
* ``dominant::compute|memory|collective`` — exactly one per annotated node,
  valued at the bound time in seconds (the flamegraph's coloring key).

Pure stdlib + :mod:`repro_torch.core.calltree` /
:mod:`repro_torch.core.roofline`: no torch import.
"""

from __future__ import annotations

import weakref
from collections.abc import Mapping

from .calltree import CallNode, CallTree
from .roofline import H100, HardwareSpec

PLANES = ("host", "device", "merged", "static")

DEVICE_TREE_FILENAME = "device_tree.json"
STATIC_TREE_FILENAME = "static_tree.json"

# Device-plane counters grafted onto merged-plane host nodes (prefixed).
HLO_KEYS = ("flops", "bytes", "coll_bytes", "ops")
HLO_PREFIX = "hlo_"

ROOFLINE_TERMS = ("compute", "memory", "collective")
TERM_PREFIX = "rt_"
OCCUPANCY = "roofline_occupancy"
DOMINANT_PREFIX = "dominant::"


class PlaneError(RuntimeError):
    """A requested plane cannot be served (typically: no device artifact)."""


def missing_device_hint(profile: str | None = None) -> str:
    where = f"beside the profile ({profile})" if profile else "beside the profile"
    return (
        f"no device plane: expected a {DEVICE_TREE_FILENAME} artifact {where}. "
        f"Generate one with `python -m repro_torch.launch.train --arch <arch> --out <profile>` "
        f"(the trainer profiles its second step and writes {DEVICE_TREE_FILENAME})."
    )


def missing_static_hint(profile: str | None = None) -> str:
    where = f"beside the profile ({profile})" if profile else "beside the profile"
    return (
        f"no static plane: expected a {STATIC_TREE_FILENAME} artifact {where}. "
        f"The port has no static-plane extractor yet; the JAX package's writes one with "
        f"`python -m repro.analysis extract --out <profile>/{STATIC_TREE_FILENAME}`."
    )


def default_metric(plane: str, metric: str | None) -> str | None:
    """Planes without ``samples`` fast-lane mass get a sensible default:
    the device tree's is ``flops``, the static call graph's is ``defs``."""
    if metric:
        return metric
    if plane == "device":
        return "flops"
    if plane == "static":
        return "defs"
    return metric


def _norm(name: str) -> str:
    """Normalize a node name for host<->device matching.

    Host frames ingested from a spool carry an origin tag (``py::attention``,
    ``native::...``) that device op paths never have; ``jit(step)`` dispatch
    heads (device plane) normalize to the jitted function's name so they match
    the host frame that called it.
    """
    _head, sep, rest = name.partition("::")
    if sep and rest:
        name = rest
    if name.startswith("jit(") and name.endswith(")"):
        return name[4:-1]
    return name


#: Cached tuple index per device tree.  Keyed by weak reference: a device
#: tree is immutable once loaded (daemon/server swap in a *new* CallTree when
#: the artifact changes), so the index is computed once per artifact, not
#: once per publish window / HTTP request.
_INDEX_CACHE: "weakref.WeakKeyDictionary[CallTree, dict[str, tuple[float, float, float, float]]]" = (
    weakref.WeakKeyDictionary()
)

_HLO_FULL_KEYS = tuple(HLO_PREFIX + k for k in HLO_KEYS)


def _device_index(device: CallTree) -> dict[str, tuple[float, float, float, float]]:
    """Flatten-view index: normalized name -> (flops, bytes, coll_bytes, ops)."""
    index = _INDEX_CACHE.get(device)
    if index is not None:
        return index
    index = {}
    for _path, node in device.root.walk():
        if node is device.root:
            continue
        key = _norm(node.name)
        m = node.metrics
        f = m.get("flops", 0.0)
        b = m.get("bytes", 0.0)
        cb = m.get("coll_bytes", 0.0)
        o = m.get("ops", 0.0)
        cur = index.get(key)
        index[key] = (f, b, cb, o) if cur is None else (cur[0] + f, cur[1] + b, cur[2] + cb, cur[3] + o)
    _INDEX_CACHE[device] = index
    return index


def device_name_index(device: CallTree) -> dict[str, dict[str, float]]:
    """Flatten-view index: normalized node name -> summed inclusive HLO metrics."""
    return {k: dict(zip(HLO_KEYS, v, strict=True)) for k, v in _device_index(device).items()}


#: Memoized ``_norm``: frame names are interned by the ingest layer, so a
#: long-lived daemon sees the same string objects window after window and
#: this degenerates to one dict hit per node.  Bounded by the number of
#: distinct frame names, like the interner itself.
_NORM_CACHE: dict[str, str] = {}


def annotate_tree(
    host: CallTree, device: CallTree, hw: HardwareSpec = H100, *, copy: bool = True
) -> CallTree:
    """The merged plane: ``host`` with device-plane annotations.

    Annotations keep inclusive-metric semantics: a matched node carries its
    matched HLO subtree cost (floored at the sum of its children, so nesting
    stays monotone); an unmatched node carries the sum of its children.  Self
    metrics get the structural residual, so folded/speedscope exports and
    ``shares(self_only=True)`` gating stay exact.

    With ``copy=True`` (default) the host tree is left untouched and an
    annotated copy is returned — what the query plane wants, since it
    annotates shared published snapshots per request.  The daemon's seal
    path already builds a private fleet tree every epoch; it passes
    ``copy=False`` to annotate that tree in place, so the device plane's
    marginal cost per publish window is one attribution walk, not an extra
    tree copy (``annotate_overhead`` in ``BENCH_ingest.json`` holds it to
    <5 % of ingest time).

    The walk is hot-path code: per-subtree costs travel as tuples, the
    device index is cached per artifact, occupancy falls out of the same
    pass (every occupancy value is ``bound / t_step``, so bounds are
    collected in a flat list and scaled once the root total is known), and
    annotation writes go straight to the node's metric dicts — ``hlo_*``
    keys never collide with the sample fast-lane.
    """
    merged = host.copy() if copy else host
    index = _device_index(device)
    inv_c = 1.0 / hw.peak_flops
    inv_m = 1.0 / hw.hbm_bw
    inv_x = 1.0 / (hw.ici_links * hw.ici_link_bw)
    k_flops, k_bytes, k_coll, k_ops = _HLO_FULL_KEYS
    rt_c, rt_m, rt_x = (TERM_PREFIX + t for t in ROOFLINE_TERMS)
    dom = tuple(DOMINANT_PREFIX + t for t in ROOFLINE_TERMS)
    norm_cache = _NORM_CACHE
    index_get = index.get
    # (metrics, self_metrics, bound, bound - sum(child bounds)) per annotated
    # node, post-order; occupancy is written in one flat scaling loop below.
    pending: list[tuple[dict, dict, float, float]] = []

    def attribute(node: CallNode, is_root: bool) -> tuple[float, float, float, float, float]:
        """Returns the node's attributed (flops, bytes, coll_bytes, ops, bound)."""
        f = b = cb = o = kb = 0.0
        for c in node.children.values():
            cf, cbt, ccb, co, cbd = attribute(c, False)
            f += cf
            b += cbt
            cb += ccb
            o += co
            kb += cbd
        if is_root:
            hit = None
        else:
            name = node.name
            normed = norm_cache.get(name)
            if normed is None:
                normed = norm_cache[name] = _norm(name)
            hit = index_get(normed)
        sf, sb, scb, so = f, b, cb, o
        if hit is not None:
            if hit[0] > f:
                f = hit[0]
            if hit[1] > b:
                b = hit[1]
            if hit[2] > cb:
                cb = hit[2]
            if hit[3] > o:
                o = hit[3]
        if f or b or cb or o:
            m = node._metrics
            sm = node._self_metrics
            if f:
                m[k_flops] = f
                if f > sf:
                    sm[k_flops] = f - sf
            if b:
                m[k_bytes] = b
                if b > sb:
                    sm[k_bytes] = b - sb
            if cb:
                m[k_coll] = cb
                if cb > scb:
                    sm[k_coll] = cb - scb
            if o:
                m[k_ops] = o
                if o > so:
                    sm[k_ops] = o - so
            tc = f * inv_c
            tm = b * inv_m
            tx = cb * inv_x
            bound, which = tc, 0
            if tm > bound:
                bound, which = tm, 1
            if tx > bound:
                bound, which = tx, 2
            if bound > 0:
                m[rt_c] = tc
                m[rt_m] = tm
                m[rt_x] = tx
                m[dom[which]] = bound
                pending.append((m, sm, bound, bound - kb))
                return f, b, cb, o, bound
        return f, b, cb, o, (kb if node.children else 0.0)

    *_vals, t_step = attribute(merged.root, True)
    if t_step > 0:
        inv_t = 1.0 / t_step
        for m, sm, bound, resid in pending:
            m[OCCUPANCY] = bound * inv_t
            if resid > 0:
                sm[OCCUPANCY] = resid * inv_t
    return merged


def dominant_term(metrics: Mapping[str, float]) -> str | None:
    """The node's dominant roofline term, read back from annotation metrics."""
    best, best_v = None, 0.0
    for t in ROOFLINE_TERMS:
        v = metrics.get(DOMINANT_PREFIX + t, 0.0)
        if v > best_v:
            best, best_v = t, v
    return best


def select_plane(
    host: CallTree,
    device: CallTree | None,
    plane: str,
    *,
    hw: HardwareSpec = H100,
    profile: str | None = None,
    static: CallTree | None = None,
) -> CallTree:
    """Resolve one of the plane views, or raise.

    ``ValueError`` for an unknown plane name (caller bug / HTTP 400);
    :class:`PlaneError` with a remedy hint when the plane's artifact
    (device tree, static tree) is missing (HTTP 404 / CLI exit 4 — never a
    vacuous empty view).
    """
    if plane not in PLANES:
        raise ValueError(f"unknown plane {plane!r} (choose from {', '.join(PLANES)})")
    if plane == "host":
        return host
    if plane == "static":
        if static is None:
            raise PlaneError(missing_static_hint(profile))
        return static
    if device is None:
        raise PlaneError(missing_device_hint(profile))
    if plane == "device":
        return device
    return annotate_tree(host, device, hw)
