"""Epoch-sealing overhead vs plain ingest throughput, for the port's daemon
(a copy of the JAX package's ``benchmarks/timeline_overhead.py``).

The timeline ring must be effectively free for the daemon's hot loop: the
acceptance floor is **<5 % ingest-throughput overhead** for sealing epochs at
a realistic cadence, on the same workload the ingest benchmark pinned
(depth 32, 95 % stack repetition, wire v2).

What makes this hold is the counts fast path: the ingestor counts per-chain
hits as it ingests (one integer compare + add per sample), and the sealer
writes each epoch as a ``K_COUNTS`` record — two varints per *touched chain*,
never a tree walk (:class:`repro.core.snapshot.CountSealer`).  Keyframes
(segment rotation) snapshot the full tree and amortize over
``epochs_per_segment`` epochs.

Methodology: epochs are wall-clock in the daemon (default 5 s), so the
benchmark seals at the *time-equivalent* cadence — every
``plain_rate x epoch_s`` samples, i.e. what a saturated daemon would actually
ingest between two seals.  The workload replays the ingest benchmark's steady-state stream
several times so multiple epochs (and a keyframe + path-definition record)
land mid-run.  The overhead is accounted **in-run**: every
``drain_epoch + seal`` block is timed inside the sealed pass, and

    overhead = total seal time / (pass wall time - total seal time)

i.e. sealing cost as a fraction of the pure ingest time *in the same
measurement window* — cross-run wall-clock subtraction on a shared runner
swings by far more than the signal.  The plain pass is still run and
reported (and compared against the ingest benchmark's recorded rate) to confirm the
per-sample epoch bookkeeping added to ``TreeIngestor.ingest`` did not dent
base throughput.

Results extend the ``--out`` file under a ``timeline_overhead`` key (the
ingest results are preserved). It writes only where ``--out`` points
(default ``build/BENCH_ingest.json``, under the git-ignored ``build/``), never
the JAX package's ``BENCH_ingest.json``.

Usage::

  PYTHONPATH=src python -m repro_torch.benchmarks.timeline_overhead           # full run
  PYTHONPATH=src python -m repro_torch.benchmarks.timeline_overhead --smoke   # CI smoke

Pure stdlib + repro_torch.core/profilerd (no torch).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from .ingest_throughput import encode_all, synth_samples

from repro_torch.core.snapshot import CountSealer, TimelineReader, TimelineWriter
from repro_torch.profilerd.ingest import TreeIngestor
from repro_torch.profilerd.wire import Decoder, RawSample

DEFAULT_OUT = os.path.join("build", "BENCH_ingest.json")
# the key of the recorded rate, the JAX package's, so both files read alike
REF_KEY = "pr2_ref_ingest_per_s"
DEPTH = 32
REPEAT = 0.95
EPOCH_S = 1.0  # time-equivalent seal cadence (5x stricter than the daemon default)
CHUNK = 1 << 20


def run_once(payload: bytes, replays: int, epoch_every: int | None, timeline_dir: str | None):
    """Replay the stream ``replays`` times through the daemon hot loop.

    Seals every ``epoch_every`` samples when ``timeline_dir`` is set.
    Returns ``(seconds, ingestor, epochs_sealed, seal_seconds)`` where
    ``seal_seconds`` is the wall time spent inside ``drain_epoch + seal``.
    """
    clock = time.perf_counter
    ing = TreeIngestor()
    sealer = None
    writer = None
    if timeline_dir is not None:
        writer = TimelineWriter(timeline_dir)
        sealer = CountSealer(ing.tree, writer)
    n = 0
    epochs = 0
    seal_s = 0.0
    next_seal = epoch_every if epoch_every else None
    t0 = clock()
    for _ in range(replays):
        dec = Decoder()  # a fresh attach per replay; samples re-intern cheaply
        for i in range(0, len(payload), CHUNK):
            for ev in dec.feed(payload[i : i + CHUNK]):
                if type(ev) is RawSample:
                    ing.ingest(ev)
                    n += 1
                    if sealer is not None and n == next_seal:
                        s0 = clock()
                        entries, untracked = ing.drain_epoch()
                        sealer.seal(entries, wall_time=float(n), untracked=untracked)
                        seal_s += clock() - s0
                        epochs += 1
                        next_seal = n + epoch_every
    if sealer is not None:
        s0 = clock()
        entries, untracked = ing.drain_epoch()
        sealer.seal(entries, wall_time=float(n), untracked=untracked)
        writer.close()
        seal_s += clock() - s0
        epochs += 1
    dt = clock() - t0
    return dt, ing, epochs, seal_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny iteration counts (CI)")
    ap.add_argument("--samples", type=int, default=None, help="samples per replay")
    ap.add_argument("--replays", type=int, default=None, help="stream replays per pass")
    ap.add_argument("--epoch-every", type=int, default=None,
                    help="seal every N samples (default: measured plain rate x 1s)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n = args.samples or (800 if args.smoke else 40000)
    replays = args.replays or (2 if args.smoke else 16)
    reps = 1 if args.smoke else 3  # best-of: shared-runner wall clocks are noisy

    samples = synth_samples(DEPTH, REPEAT, n)
    payload = encode_all(samples, version=2)
    total = n * replays

    # Warmup pass (allocator, branch caches, interning).
    run_once(payload, 1, None, None)

    # The epoch cadence comes from a steady-state plain measurement; the
    # plain pass also guards base throughput against the ingest benchmark's recorded rate.
    best_plain = float("inf")
    best_overhead = float("inf")
    sealed_stats = None
    epoch_every = args.epoch_every
    ring_bytes = 0
    for _ in range(reps):
        dt, ing, _, _ = run_once(payload, replays, None, None)
        assert ing.tree.total() == total, "plain ingest lost samples"
        best_plain = min(best_plain, dt)
        if epoch_every is None:
            epoch_every = max(200, int(total / dt * EPOCH_S))

        tl = tempfile.mkdtemp(prefix="bench-timeline-")
        try:
            dt, ing, epochs, seal_s = run_once(payload, replays, epoch_every, tl)
            assert ing.tree.total() == total, "sealed ingest lost samples"
            last = TimelineReader(tl).last()
            assert last is not None and last[1].root == ing.tree.root, (
                "timeline reconstruction diverged from the live tree"
            )
            # In-run accounting: sealing cost as a fraction of the pure
            # ingest time in the same pass (see module docstring).
            overhead = seal_s / max(dt - seal_s, 1e-9)
            if overhead < best_overhead:
                best_overhead = overhead
                ring_bytes = sum(
                    os.path.getsize(os.path.join(tl, f)) for f in os.listdir(tl)
                )
                sealed_stats = (dt, epochs, seal_s)
        finally:
            shutil.rmtree(tl, ignore_errors=True)
    plain_rate = total / best_plain
    sealed_dt, epochs, seal_s = sealed_stats

    result = {
        "depth": DEPTH,
        "repeat": REPEAT,
        "n_samples": total,
        "epoch_equiv_s": EPOCH_S,
        "epoch_every": epoch_every,
        "epochs_sealed": epochs,
        "plain_ingest_s": round(best_plain, 6),
        "plain_per_s": round(plain_rate, 1),
        "sealed_pass_s": round(sealed_dt, 6),
        "seal_s_total": round(seal_s, 6),
        "seal_ms_per_epoch": round(seal_s / epochs * 1000, 3),
        "overhead": round(best_overhead, 4),
        "ring_bytes": ring_bytes,
        "smoke": args.smoke,
    }
    print(
        f"depth={DEPTH} repeat={REPEAT:.2f} n={total} "
        f"epoch_every={epoch_every} ({EPOCH_S:.0f}s-equivalent) epochs={epochs}\n"
        f"plain ingest: {plain_rate:>12,.0f} samples/s\n"
        f"sealing     : {seal_s * 1000:.1f}ms total over {epochs} epochs "
        f"({result['seal_ms_per_epoch']:.1f}ms/epoch, {ring_bytes:,} ring bytes)\n"
        f"overhead: {best_overhead:+.2%} of ingest time (floor: <5%)",
        flush=True,
    )

    # Extend the --out file in place, preserving the ingest results.
    doc = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    ref = None
    for r in doc.get("results", []):
        if r.get("depth") == DEPTH and r.get("repeat") == REPEAT and "v2" in r:
            ref = r["v2"].get("ingest_per_s")
    if ref:
        result[REF_KEY] = ref
        print(
            f"base throughput vs the recorded v2 ingest: "
            f"{plain_rate:,.0f} vs {ref:,.0f} samples/s ({plain_rate / ref - 1:+.1%})"
        )
    doc["timeline_overhead"] = result
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
        + f"epoch sealing overhead {best_overhead:+.2%} of ingest time (target <5%)"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
