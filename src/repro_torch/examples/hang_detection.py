"""Fig. 13 end-to-end for the port, both profiler backends (the counterpart of
the JAX package's ``examples/hang_detection.py``).

Part 1 (thread backend): a training job develops a livelock mid-run; the
in-process watchdog detects the dominance signature, takes an emergency
checkpoint, and the job restarts from it.

Part 2 (daemon backend): the scenario an in-process helper thread *cannot*
handle — the target's interpreter is fully wedged (here: SIGSTOP, the
stand-in for a GIL held forever in native code), so no helper thread inside
the process can run either.  The target only publishes raw frames to a spool;
the out-of-process ``repro_torch.profilerd`` daemon notices the spool has
gone silent while the pid is still alive and fires a ``TARGET_STALLED``
verdict — the paper's external-observer architecture earning its keep.

The JAX job compiles its step for seconds before it trains, so the JAX demo
injects its livelock 2 s in; the port's job starts at once, so the livelock
is injected when the first step's heartbeat appears, and it clears once the
watchdog has flagged it (the port's eager steps take the GIL at every op, so
the spin slows them many times over on a CPU). It asserts on its own output: exit code
0 means both parts detected their fault.

  PYTHONPATH=src python -m repro_torch.examples.hang_detection [--device cpu] [--out DIR]
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from repro_torch.core import Rule
from repro_torch.launch.train import Trainer, TrainJobConfig

SRC = str(Path(__file__).resolve().parents[2])


def injected_livelock_spin(stop):
    x = 0
    while not stop.is_set():
        x += 1


def part1_thread_backend(out_dir: str, device: str):
    """In-process watchdog: livelock -> emergency checkpoint -> restart."""
    shutil.rmtree(out_dir, ignore_errors=True)
    job = TrainJobConfig(
        arch="gemma-2b",
        smoke=True,
        device=device,
        steps=12,
        global_batch=4,
        seq_len=48,
        out_dir=out_dir,
        ckpt_every=50,  # only the watchdog will checkpoint
        sample_period_s=0.02,
        watchdog_threshold=0.35,  # the spin shares the CPU with real work
        # The generic dominance rule is timing-sensitive on a shared CPU;
        # scope a rule to the known injection signature so the demo is
        # deterministic.
        extra_rules=[Rule(pattern="injected_livelock_spin", threshold=0.2,
                          consecutive=2, min_window_total=4, self_only=False)],
    )
    trainer = Trainer(job)

    stop = threading.Event()
    spin = threading.Thread(target=injected_livelock_spin, args=(stop,), daemon=True)
    heartbeat = os.path.join(out_dir, "heartbeat")

    done = threading.Event()

    def inject_after_first_step():
        while not os.path.exists(heartbeat) and not done.is_set():
            time.sleep(0.01)
        if done.is_set():
            return
        print(">>> injecting livelock (spinning thread) <<<")
        spin.start()
        while not trainer.anomalies and not done.is_set():
            time.sleep(0.05)
        print(">>> livelock flagged: clearing it <<<")
        stop.set()

    threading.Thread(target=inject_after_first_step, daemon=True).start()
    summary = trainer.run()
    done.set()
    stop.set()

    print(f"anomalies: {summary['anomalies']}")
    steps = trainer.ckpt.list_steps()
    print(f"checkpoints on disk: {steps}")
    assert summary["anomalies"], "watchdog failed to flag the injected livelock"
    _, _, manifest = trainer.ckpt.restore_latest()
    print(f"latest checkpoint tag: {manifest['tag']}, anomaly: {manifest['extra'].get('anomaly')}")

    # restart from the emergency checkpoint
    resumed = Trainer(TrainJobConfig(
        arch="gemma-2b", smoke=True, device=device, steps=summary["steps"] + 3, global_batch=4,
        seq_len=48, out_dir=out_dir, ckpt_every=50,
    ))
    summary2 = resumed.run()
    print(f"resumed and ran to step {summary2['steps']}")


_WEDGED_TARGET = r"""
import sys, time
sys.path.insert(0, sys.argv[2])
from repro_torch.core import SamplerConfig, make_sampler

# Daemon backend, externally-drained spool: the only profiling work in this
# process is the raw-frame publisher.
sampler = make_sampler(SamplerConfig(
    backend="daemon", spool_path=sys.argv[1], spawn_daemon=False, period_s=0.05))
sampler.start()
t0 = time.monotonic()
x = 0
while time.monotonic() - t0 < 30.0:   # parent SIGSTOPs us long before this
    x += 1
sampler.stop()
"""


def part2_daemon_backend(out_dir: str):
    """Out-of-process daemon: fully wedged target -> TARGET_STALLED."""
    from repro_torch.profilerd import DaemonConfig, ProfilerDaemon

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spool = os.path.join(out_dir, "target.spool")

    target = subprocess.Popen([sys.executable, "-c", _WEDGED_TARGET, spool, SRC])
    print(f">>> target pid={target.pid} publishing raw frames to {spool} <<<")

    daemon = ProfilerDaemon(DaemonConfig(
        spool_path=spool, publish_interval_s=0.25, stall_timeout_s=1.0,
        rules=[Rule(threshold=0.9, consecutive=2)], max_seconds=30.0,
    ))
    daemon.attach()

    stalled = {"seen": False}

    def watch(d):
        for ev in d.events:
            if ev["kind"] == "TARGET_STALLED" and not stalled["seen"]:
                stalled["seen"] = True
                print(f">>> daemon verdict: {json.dumps(ev)} <<<")
        if stalled["seen"]:
            d.request_stop()  # verdict delivered: end the attach loop

    def wedge_later():
        time.sleep(2.0)
        print(">>> wedging the target's interpreter (SIGSTOP) <<<")
        os.kill(target.pid, signal.SIGSTOP)

    threading.Thread(target=wedge_later, daemon=True).start()
    tree = daemon.run(on_publish=watch)

    os.kill(target.pid, signal.SIGCONT)
    target.terminate()
    target.wait()

    print(f"daemon merged {daemon.n_stacks} stacks before the wedge; hot paths:")
    for path, share in tree.hot_paths(k=3):
        print(f"  {share:7.2%}  {'/'.join(path)}")
    assert stalled["seen"], "daemon failed to flag the wedged target"
    assert daemon.n_stacks > 0, "daemon streamed no samples before the wedge"
    print(f"artifacts: {sorted(os.listdir(daemon.out_dir))}")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_hang_demo"))
    args = ap.parse_args(argv)
    part1_thread_backend(args.out, args.device)
    print()
    part2_daemon_backend(args.out + "_daemon")


if __name__ == "__main__":
    main()
