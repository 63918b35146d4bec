"""Device-plane annotation overhead vs plain ingest throughput, for the
port's daemon (a copy of the JAX package's ``benchmarks/annotate_overhead.py``).

The merged plane must be effectively free for the daemon: every publish
window the daemon re-annotates the published tree with the device-plane cost
model (``repro.core.planes.annotate_tree`` — a host-tree copy, a name-index
lookup per node, and a two-pass attribute/occupy walk).  The acceptance
floor is **<5 % of ingest time** spent annotating at a realistic publish
cadence, on the same steady-state workload the ingest benchmark pinned
(depth 32, 95 % stack repetition, wire v2).

Methodology mirrors ``timeline_overhead.py``: publish windows are wall-clock
in the daemon, so the benchmark annotates at the *time-equivalent* cadence —
every ``plain_rate x window_s`` samples, i.e. the tree size a saturated
daemon would actually publish.  The device tree is built from the same
synthetic stacks (every shared-prefix frame plus a slice of the unique
tails carries HLO-shaped metrics), so the name matcher does representative
work instead of missing everything.

What is timed is the device plane's *marginal* cost, exactly as the daemon
pays it: the seal path builds a private fleet tree every epoch regardless
(that stand-in copy happens outside the timed region), then
``annotate_tree(tree, device, copy=False)`` annotates it in place.
Overhead is accounted **in-run**:

    overhead = total annotate time / (pass wall time - annotate - copy time)

i.e. annotation cost as a fraction of the pure ingest time in the same
measurement window — cross-run wall-clock subtraction on a shared runner is
noisier than the signal.

Results extend the ``--out`` file under an ``annotate_overhead`` key (the
ingest results and other sections are preserved). It writes only where
``--out`` points (default ``build/BENCH_ingest.json``, under the git-ignored
``build/``), never the JAX package's ``BENCH_ingest.json``.

Usage::

  PYTHONPATH=src python -m repro_torch.benchmarks.annotate_overhead           # full run
  PYTHONPATH=src python -m repro_torch.benchmarks.annotate_overhead --smoke   # CI smoke

Pure stdlib + repro_torch.core/profilerd (no torch).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

from .ingest_throughput import encode_all, synth_samples, synth_stacks

from repro_torch.core.calltree import CallTree
from repro_torch.core.planes import OCCUPANCY, annotate_tree
from repro_torch.profilerd.ingest import TreeIngestor
from repro_torch.profilerd.wire import Decoder, RawSample

DEFAULT_OUT = os.path.join("build", "BENCH_ingest.json")
DEPTH = 32
REPEAT = 0.95
WINDOW_S = 1.0  # time-equivalent publish cadence (stricter than the daemon default)
CHUNK = 1 << 20
MATCH_FRACTION = 0.5  # unique tails that also exist on the device plane


def synth_device_tree(n: int) -> CallTree:
    """A device tree over the same frame names the ingested stream uses.

    Every shared-prefix frame matches (like ``named_scope``-tagged module
    code), plus ``MATCH_FRACTION`` of the unique tails (like jitted
    call-sites), each with HLO-shaped metrics.
    """
    rng = random.Random(1)
    n_unique = max(1, round(n * (1.0 - REPEAT)))
    tree = CallTree()
    for u, frames in enumerate(synth_stacks(DEPTH, n_unique, rng)):
        if u % max(1, int(1 / MATCH_FRACTION)) != 0:
            continue
        path = [f.func for f in frames] + ["dot"]
        tree.add_stack(
            path,
            {
                "ops": 3.0,
                "flops": rng.uniform(1e9, 1e12),
                "bytes": rng.uniform(1e6, 1e9),
                "coll_bytes": rng.uniform(0, 1e8),
            },
        )
    return tree


def run_once(payload: bytes, replays: int, annotate_every: int | None, device: CallTree | None):
    """Replay the stream through the daemon hot loop, annotating each window.

    Returns ``(seconds, ingestor, windows, annotate_seconds, copy_seconds)``
    where ``annotate_seconds`` is the wall time spent inside ``annotate_tree``
    and ``copy_seconds`` the (untimed-in-daemon) stand-in for the private
    fleet tree the seal path builds every epoch regardless.
    """
    clock = time.perf_counter
    ing = TreeIngestor()
    n = 0
    windows = 0
    ann_s = 0.0
    copy_s = 0.0
    merged = None
    next_mark = annotate_every if annotate_every else None
    t0 = clock()
    for _ in range(replays):
        dec = Decoder()  # a fresh attach per replay; samples re-intern cheaply
        for i in range(0, len(payload), CHUNK):
            for ev in dec.feed(payload[i : i + CHUNK]):
                if type(ev) is RawSample:
                    ing.ingest(ev)
                    n += 1
                    if device is not None and n == next_mark:
                        c0 = clock()
                        sealed = ing.tree.copy()  # the seal path's private tree
                        a0 = clock()
                        merged = annotate_tree(sealed, device, copy=False)
                        a1 = clock()
                        copy_s += a0 - c0
                        ann_s += a1 - a0
                        windows += 1
                        next_mark = n + annotate_every
    if device is not None:
        c0 = clock()
        sealed = ing.tree.copy()
        a0 = clock()
        merged = annotate_tree(sealed, device, copy=False)
        a1 = clock()
        copy_s += a0 - c0
        ann_s += a1 - a0
        windows += 1
        assert merged.root.metrics.get(OCCUPANCY, 0) > 0.99, "annotation produced no matches"
    dt = clock() - t0
    return dt, ing, windows, ann_s, copy_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny iteration counts (CI)")
    ap.add_argument("--samples", type=int, default=None, help="samples per replay")
    ap.add_argument("--replays", type=int, default=None, help="stream replays per pass")
    ap.add_argument("--annotate-every", type=int, default=None,
                    help="annotate every N samples (default: measured plain rate x 1s)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n = args.samples or (800 if args.smoke else 40000)
    replays = args.replays or (2 if args.smoke else 16)
    reps = 1 if args.smoke else 3  # best-of: shared-runner wall clocks are noisy

    samples = synth_samples(DEPTH, REPEAT, n)
    payload = encode_all(samples, version=2)
    device = synth_device_tree(n)
    total = n * replays

    # Warmup pass (allocator, branch caches, interning).
    run_once(payload, 1, None, None)

    best_plain = float("inf")
    best_overhead = float("inf")
    annotated_stats = None
    annotate_every = args.annotate_every
    for _ in range(reps):
        dt, ing, _, _, _ = run_once(payload, replays, None, None)
        assert ing.tree.total() == total, "plain ingest lost samples"
        best_plain = min(best_plain, dt)
        if annotate_every is None:
            annotate_every = max(200, int(total / dt * WINDOW_S))

        dt, ing, windows, ann_s, copy_s = run_once(payload, replays, annotate_every, device)
        assert ing.tree.total() == total, "annotated ingest lost samples"
        # In-run accounting: annotation cost as a fraction of the pure
        # ingest time in the same pass (see module docstring).
        overhead = ann_s / max(dt - ann_s - copy_s, 1e-9)
        if overhead < best_overhead:
            best_overhead = overhead
            annotated_stats = (dt, windows, ann_s)
    plain_rate = total / best_plain
    annotated_dt, windows, ann_s = annotated_stats

    result = {
        "depth": DEPTH,
        "repeat": REPEAT,
        "n_samples": total,
        "window_equiv_s": WINDOW_S,
        "annotate_every": annotate_every,
        "windows": windows,
        "host_nodes": ing.tree.node_count(),
        "device_nodes": device.node_count(),
        "plain_ingest_s": round(best_plain, 6),
        "plain_per_s": round(plain_rate, 1),
        "annotated_pass_s": round(annotated_dt, 6),
        "annotate_s_total": round(ann_s, 6),
        "annotate_ms_per_window": round(ann_s / windows * 1000, 3),
        "overhead": round(best_overhead, 4),
        "smoke": args.smoke,
    }
    print(
        f"depth={DEPTH} repeat={REPEAT:.2f} n={total} "
        f"annotate_every={annotate_every} ({WINDOW_S:.0f}s-equivalent) windows={windows}\n"
        f"host nodes={result['host_nodes']} device nodes={result['device_nodes']}\n"
        f"plain ingest: {plain_rate:>12,.0f} samples/s\n"
        f"annotation  : {ann_s * 1000:.1f}ms total over {windows} windows "
        f"({result['annotate_ms_per_window']:.1f}ms/window)\n"
        f"overhead: {best_overhead:+.2%} of ingest time (floor: <5%)",
        flush=True,
    )

    # Extend the --out file in place, preserving earlier benchmark results.
    doc = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    doc["annotate_overhead"] = result
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")

    if args.smoke:
        print(f"[smoke] overhead {best_overhead:+.2%} (floor not enforced on tiny runs)")
        return 0
    ok = best_overhead < 0.05
    print(
        ("PASS " if ok else "FAIL ")
        + f"device-plane annotation overhead {best_overhead:+.2%} of ingest time (target <5%)"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
