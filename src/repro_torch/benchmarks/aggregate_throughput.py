"""Regional aggregator merge throughput at simulated fleet scale, for the
port's aggregator (a copy of the JAX package's ``benchmarks/aggregate_throughput.py``).

The fleet tier's hot loop is ``Aggregator.handle_push``: decode a CRC-framed
push body (the snapshot codec over HTTP), merge the delta into the node's
cumulative, and seal the node ring — all before the 200 goes out.  This
benchmark drives that loop directly (no sockets: the HTTP layer is
byte-shuffling around the same call) with pre-encoded bodies from simulated
node fleets, measuring:

* ``epochs_per_s``   — pushed epochs decoded + merged + sealed per second;
* ``bytes_per_epoch``— mean wire size of one epoch body (delta economy);
* ``fleet_seal_s``   — one fleet-wide merge + ring seal at that node count
  (the aggregator's per-``epoch_s`` background cost).

Each simulated node pushes a keyframe first, then deltas with a keyframe
every 16 epochs — the PushClient cadence — over stacks with a shared root
prefix and per-node tails, so merge cost scales the way a real region does.

Writes a ``fleet`` section (preserving sibling benchmarks' sections).
Writes only where ``--out`` points (default ``build/BENCH_ingest.json``, under
the git-ignored ``build/``), never the JAX package's ``BENCH_ingest.json``.
Acceptance floors (full runs only; smoke just checks the harness): >= 300
epochs/s merged at 10 nodes and >= 250 epochs/s at 100 nodes (~1/3 of what
the JAX package's CPU run measured, headroom for noisy shared runners), with
bytes_per_epoch <= 8 KiB at both scales.

Usage::

  PYTHONPATH=src python -m repro_torch.benchmarks.aggregate_throughput           # full
  PYTHONPATH=src python -m repro_torch.benchmarks.aggregate_throughput --smoke   # CI

Pure stdlib + repro_torch.core/profilerd (no torch, no numpy), so it runs
anywhere the test suite runs.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import tempfile
import time

from repro_torch.core.calltree import CallTree
from repro_torch.core.snapshot import K_DELTA, K_FULL, EpochMeta
from repro_torch.profilerd.aggregator import Aggregator, AggregatorConfig
from repro_torch.profilerd.push import H_BOOT, H_EPOCH, H_INTERVAL, H_NODE, encode_push_body

DEFAULT_OUT = os.path.join("build", "BENCH_ingest.json")
NODE_COUNTS = (10, 100)
KEYFRAME_EVERY = 16  # PushClient's default cadence
DEPTH = 12
SITES_PER_EPOCH = 24  # distinct call sites a node's epoch window touches


def _epoch_window(node_i: int, epoch: int, rng: random.Random) -> CallTree:
    """One node-epoch of samples: shared framework prefix, per-node leaves."""
    t = CallTree()
    prefix = ["main", "train_loop", "step", f"shard_{node_i % 8}"]
    for s in range(SITES_PER_EPOCH):
        tail = [f"layer_{(epoch + s) % 16}", f"fn_{node_i}_{s % 6}"]
        path = (prefix + tail)[:DEPTH]
        t.add_stack(path, {"samples": float(1 + rng.randrange(4))})
    return t


def synth_fleet(n_nodes: int, n_epochs: int, seed: int = 0):
    """Pre-encoded push bodies: ``bodies[epoch][node] = (headers, body)``."""
    rng = random.Random(seed)
    cums = [CallTree() for _ in range(n_nodes)]
    bodies = []
    for e in range(n_epochs):
        row = []
        for i in range(n_nodes):
            window = _epoch_window(i, e, rng)
            cums[i].merge(window)
            if e % KEYFRAME_EVERY == 0:
                body = encode_push_body(K_FULL, EpochMeta(e, float(e)), cums[i])
            else:
                body = encode_push_body(K_DELTA, EpochMeta(e, float(e)), window)
            headers = {
                H_NODE: f"node-{i:03d}",
                H_BOOT: f"boot-{i}",
                H_EPOCH: str(e),
                H_INTERVAL: "5",
            }
            row.append((headers, body))
        bodies.append(row)
    expected = sum(c.total() for c in cums)
    return bodies, expected


def bench_one(n_nodes: int, n_epochs: int, reps: int) -> dict:
    bodies, expected = synth_fleet(n_nodes, n_epochs)
    n_bytes = sum(len(b) for row in bodies for _h, b in row)
    best = float("inf")
    best_seal = float("inf")
    for _ in range(reps):
        out_dir = tempfile.mkdtemp(prefix="repro-aggbench-")
        agg = Aggregator(AggregatorConfig(out_dir=out_dir, epochs_per_segment=64))
        try:
            t0 = time.perf_counter()
            for row in bodies:
                for headers, body in row:
                    code, _resp = agg.handle_push(headers, body)
                    assert code == 200, f"push refused: {code}"
            best = min(best, time.perf_counter() - t0)
            t0 = time.perf_counter()
            agg.seal_fleet_epoch(force=True)
            best_seal = min(best_seal, time.perf_counter() - t0)
            got = agg.fleet_tree().total()
            assert got == expected, f"mass lost: {got} != {expected}"
        finally:
            agg.close()
            shutil.rmtree(out_dir, ignore_errors=True)
    n_pushes = n_nodes * n_epochs
    return {
        "n_nodes": n_nodes,
        "n_epochs": n_epochs,
        "n_pushes": n_pushes,
        "wire_bytes": n_bytes,
        "bytes_per_epoch": round(n_bytes / n_pushes, 1),
        "merge_s": round(best, 6),
        "epochs_per_s": round(n_pushes / best, 1),
        "fleet_seal_s": round(best_seal, 6),
        "fleet_mass": expected,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny iteration counts (CI)")
    ap.add_argument("--epochs", type=int, default=None, help="epochs per node")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n_epochs = args.epochs or (4 if args.smoke else 48)
    reps = 1 if args.smoke else 3  # best-of-3: shared-runner wall clocks are noisy

    results = []
    for n_nodes in NODE_COUNTS:
        r = bench_one(n_nodes, n_epochs, reps)
        results.append(r)
        print(
            f"nodes={n_nodes:<4d} epochs={n_epochs:<4d}  "
            f"merge={r['epochs_per_s']:>10,.0f} epochs/s  "
            f"{r['bytes_per_epoch']:>8,.0f} B/epoch  "
            f"fleet_seal={r['fleet_seal_s'] * 1e3:.1f} ms",
            flush=True,
        )

    # Sibling benchmarks write their own sections to the same file; a
    # refresh must not clobber them.
    doc = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    doc["fleet"] = {
        "bench": "aggregate_throughput",
        "smoke": args.smoke,
        "n_epochs": n_epochs,
        "keyframe_every": KEYFRAME_EVERY,
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out} (fleet section)")

    # Acceptance floors (skipped in smoke mode: tiny runs are timer-noise
    # dominated; CI smoke only checks the harness still runs end to end).
    floors = {10: 300.0, 100: 250.0}
    ok = True
    msgs = []
    for r in results:
        floor = floors[r["n_nodes"]]
        this_ok = r["epochs_per_s"] >= floor and r["bytes_per_epoch"] <= 8192
        ok = ok and this_ok
        msgs.append(
            f"{r['n_nodes']} nodes: {r['epochs_per_s']:,.0f} epochs/s "
            f"(floor {floor:,.0f}), {r['bytes_per_epoch']:,.0f} B/epoch (cap 8192)"
        )
    msg = "; ".join(msgs)
    if args.smoke:
        print(f"[smoke] {msg}")
        return 0
    print(("PASS " if ok else "FAIL ") + msg)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
