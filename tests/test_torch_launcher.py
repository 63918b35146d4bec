"""The port's launcher (``repro_torch.launch.launcher``) on the CPU.

Copied from the JAX package's tests and pointed at the port:

* ``tests/test_train_serve.py::TestLauncher`` — a hung child is killed on
  its stale heartbeat and restarted; a clean job is not; one shared
  ``--watch`` daemon serves every attempt and rendezvous collects its fleet
  tree; the restart budget ends a job that keeps failing. The child scripts
  import ``repro_torch``, never ``repro``.
* ``tests/test_timeline.py::TestLauncherTimelineMerge`` — rendezvous merges
  per-host timeline rings on the sealed epoch number.

Then the launcher over the port's own ``Trainer`` (the smoke xlstm-125m on
``device="cpu"``, a checkpoint every 2 steps, a profile dir and an
in-process aggregator): attempt 0 is stopped with SIGSTOP after a completed
checkpoint, the launcher kills it on its stale heartbeat and restarts it,
attempt 1 resumes from that checkpoint's step, and the final parameters and
optimizer state equal an uninterrupted run's bit for bit. The aggregator's
merged tree holds both attempts: its total is the sum of the two targets'.
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np

from repro_torch.core.calltree import CallTree
from repro_torch.core.snapshot import EpochSealer, TimelineWriter, read_epochs

SRC_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class TestLauncher:
    def _script(self, tmp_path, hang: bool):
        """A child that heartbeats, then either finishes or hangs forever."""
        p = tmp_path / "child.py"
        hb = tmp_path / "heartbeat"
        marker = tmp_path / "attempts.txt"
        p.write_text(
            f"""
import os, sys, time
hb = {str(hb)!r}
marker = {str(marker)!r}
with open(marker, 'a') as f:
    f.write('x')
attempts = os.path.getsize(marker)
for i in range(3):
    open(hb, 'w').write(str(i))
    time.sleep(0.05)
if {hang!r} and attempts == 1:
    time.sleep(3600)   # first attempt hangs after heartbeats stop
open(hb, 'w').write('done')
"""
        )
        return p, hb, marker

    def test_restart_on_hang_then_success(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        script, hb, marker = self._script(tmp_path, hang=True)
        cfg = LaunchConfig(
            cmd=[sys.executable, str(script)],
            workdir=str(tmp_path),
            heartbeat_path=str(hb),
            heartbeat_timeout_s=1.0,
            poll_s=0.1,
            max_restarts=2,
            backoff_s=0.1,
        )
        rep = Launcher(cfg).run()
        assert rep.exit_code == 0
        assert rep.restarts == 1  # hung once, restarted, completed
        assert marker.read_text() == "xx"

    def test_clean_job_no_restarts(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        script, hb, _ = self._script(tmp_path, hang=False)
        cfg = LaunchConfig(
            cmd=[sys.executable, str(script)],
            workdir=str(tmp_path),
            heartbeat_path=str(hb),
            heartbeat_timeout_s=5.0,
            poll_s=0.1,
        )
        rep = Launcher(cfg).run()
        assert rep.exit_code == 0 and rep.restarts == 0

    def test_shared_profilerd_daemon_per_node(self, tmp_path):
        """profile_dir starts ONE watch daemon for the whole job; it attaches
        the child's spool as it appears and publishes the merged fleet tree
        that rendezvous then just collects."""
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        p = tmp_path / "child.py"
        hb = tmp_path / "heartbeat"
        p.write_text(
            f"""
import os, sys, time
sys.path.insert(0, {SRC_ROOT!r})
from repro_torch.core import SamplerConfig, make_sampler
s = make_sampler(SamplerConfig(backend="thread"))  # env routes to the daemon
s.start()
def launcher_child_busy_loop():
    t0 = time.monotonic(); x = 0
    while time.monotonic() - t0 < 1.0:
        x += 1
        if x % 100000 == 0:
            open({str(hb)!r}, 'w').write(str(x))
launcher_child_busy_loop()
s.stop()
"""
        )
        cfg = LaunchConfig(
            cmd=[sys.executable, str(p)],
            workdir=str(tmp_path),
            heartbeat_path=str(hb),
            heartbeat_timeout_s=20.0,
            poll_s=0.1,
            profile_dir=str(tmp_path / "prof"),
            profile_period_s=0.05,
            env={"PYTHONPATH": SRC_ROOT},
        )
        launcher = Launcher(cfg)
        rep = launcher.run()
        assert rep.exit_code == 0
        assert len(launcher._daemons) == 1  # one shared daemon, not one per spool
        fleet_tree = os.path.join(cfg.profile_dir, "fleet.d", "tree.json")
        assert os.path.exists(fleet_tree)
        # The child's DaemonBackend reads its artifacts where the shared
        # daemon publishes them (REPRO_PROFILERD_OUT -> per-target dir).
        target_dir = os.path.join(cfg.profile_dir, "fleet.d", "targets", "attempt0")
        assert os.path.exists(os.path.join(target_dir, "tree.json"))
        tstatus = json.load(open(os.path.join(target_dir, "status.json")))
        assert tstatus["done"] and tstatus["n_stacks"] > 0
        merged = os.path.join(cfg.profile_dir, "merged_tree.json")
        assert os.path.exists(merged)
        tree = json.load(open(merged))
        names = json.dumps(tree)
        assert "launcher_child_busy_loop" in names
        assert any("merged 1 host tree" in e for e in rep.events)

    def test_gives_up_after_budget(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        p = tmp_path / "bad.py"
        p.write_text("import sys; sys.exit(3)")
        cfg = LaunchConfig(
            cmd=[sys.executable, str(p)],
            workdir=str(tmp_path),
            heartbeat_path=str(tmp_path / "hb"),
            heartbeat_timeout_s=5.0,
            poll_s=0.05,
            max_restarts=2,
            backoff_s=0.01,
        )
        rep = Launcher(cfg).run()
        assert rep.exit_code == 3
        assert rep.restarts == 3  # budget exhausted


class TestLauncherTimelineMerge:
    def host_timeline(self, root, name, epochs, leaf):
        out = root / f"{name}.spool.d"
        tree = CallTree()
        w = TimelineWriter(str(out / "timeline"))
        s = EpochSealer(tree, w)
        for e in range(epochs):
            ch = tree.path_nodes(["thread::main", "serve", leaf])
            CallTree.add_stack_nodes(ch, 10.0)
            s.seal([ch], wall_time=float(e))
        w.close()
        return tree

    def test_merge_aligns_on_epoch_number_not_index(self, tmp_path):
        # Host A's ring lost its oldest segments to retention (first retained
        # epoch is 6); host B has epochs 0..3.  Alignment must join on the
        # sealed epoch number, not the list index.
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        out_a = tmp_path / "attempt0.spool.d"
        tree_a = CallTree()
        w = TimelineWriter(str(out_a / "timeline"), epochs_per_segment=2, max_segments=2)
        s = EpochSealer(tree_a, w)
        for e in range(10):
            ch = tree_a.path_nodes(["thread::m", "hostA"])
            CallTree.add_stack_nodes(ch, 1.0)
            s.seal([ch], wall_time=float(e))
        w.close()
        self.host_timeline(tmp_path, "attempt1", epochs=4, leaf="hostB")
        launcher = Launcher(
            LaunchConfig(cmd=["true"], workdir=str(tmp_path),
                         heartbeat_path=str(tmp_path / "hb"),
                         profile_dir=str(tmp_path))
        )
        out = launcher._merge_timelines()
        eps = read_epochs(out)
        # merged epochs = union of retained epoch numbers (6..9 from A, 0..3 from B)
        assert [m.epoch for m, _, _ in eps] == [0, 1, 2, 3, 6, 7, 8, 9]
        by_epoch = {m.epoch: c.total() for m, _, c in read_epochs(out, copy_cumulative=True)}
        # epoch 3: only host B's 4 epochs x 10 samples; host A not retained yet
        assert by_epoch[3] == 40.0
        # epoch 9: A's full cumulative (10) + B's final (40)
        assert by_epoch[9] == 50.0

    def test_per_epoch_fleet_merge(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        t0 = self.host_timeline(tmp_path, "attempt0", epochs=4, leaf="attention")
        t1 = self.host_timeline(tmp_path, "attempt1", epochs=2, leaf="mlp")  # died early
        launcher = Launcher(
            LaunchConfig(cmd=["true"], workdir=str(tmp_path),
                         heartbeat_path=str(tmp_path / "hb"),
                         profile_dir=str(tmp_path))
        )
        out = launcher._merge_timelines()
        assert out is not None
        eps = read_epochs(out)
        assert [m.epoch for m, _, _ in eps] == [0, 1, 2, 3]
        final = eps[-1][2]
        merged = CallTree().merge(t0.copy()).merge(t1.copy())
        # the early host contributes its last cumulative to later epochs
        assert final.root == merged.root
        # fleet total never dips across epochs
        totals = [c.total() for _, _, c in read_epochs(out, copy_cumulative=True)]
        assert totals == sorted(totals)


# -- the launcher over the port's Trainer -------------------------------------

# The launcher's job: the port's Trainer, built from a TrainJobConfig (the
# train CLI has no flag for the checkpoint interval, in either package).
TRAINER_DRIVER = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.launch.train import Trainer, TrainJobConfig
Trainer(TrainJobConfig(**{job!r})).run()
"""
LAUNCHED_JOB = dict(arch="xlstm-125m", smoke=True, device="cpu", steps=8, global_batch=4, seq_len=32,
                    lr=1e-2, ckpt_every=2, sample_period_s=0.05, seed=0)
# Over a cold start of the smoke trainer on a CPU that the rest of the suite
# loads; the attempts and the reference run on one thread each (the same
# count on both sides keeps the comparison exact).
HANG_TIMEOUT_S = 45.0
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _wait(pred, timeout_s: float, desc: str):
    deadline = time.monotonic() + timeout_s
    while True:
        value = pred()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out after {timeout_s:g}s waiting for {desc}")
        time.sleep(0.01)


def _complete_steps(ckpt_dir: str) -> list[int]:
    """The checkpoints the manager's commit rule counts: renamed from .tmp."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted(int(n[5:]) for n in names if n.startswith("step_") and not n.endswith(".tmp"))


def _state(ckpt_dir: str, step: int) -> dict:
    from repro_torch.checkpoint import CheckpointManager

    tree, _ = CheckpointManager(ckpt_dir).restore(step)
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        else:
            out[prefix] = node.numpy() if hasattr(node, "numpy") else np.asarray(node)

    walk(tree, "")
    return out


def hung_once(tmp_path, device: str, hang_timeout_s: float) -> dict:
    """The launcher over the port's Trainer on ``device``: attempt 0 stopped
    with SIGSTOP once a checkpoint is complete, then killed on its stale
    heartbeat and restarted. Checks the restart and the resume, and returns
    what the caller holds further: the launcher, its report, the work and
    profile dirs and the step attempt 1 resumed from."""
    from repro_torch.launch.launcher import LaunchConfig, Launcher

    work = tmp_path / "job"
    job = {**LAUNCHED_JOB, "device": device, "out_dir": str(work)}
    launcher = Launcher(LaunchConfig(
        cmd=[sys.executable, "-c", TRAINER_DRIVER.format(src=SRC_ROOT, job=job)],
        workdir=str(tmp_path),
        heartbeat_path=str(work / "heartbeat"),
        heartbeat_timeout_s=hang_timeout_s,
        poll_s=0.1,
        max_restarts=2,
        backoff_s=0.1,
        env=ONE_THREAD,
        profile_dir=str(tmp_path / "prof"),
        profile_period_s=0.05,
        aggregate=True,
    ))
    result = {}
    runner = threading.Thread(target=lambda: result.setdefault("report", launcher.run()), daemon=True)
    runner.start()
    try:
        spawned = _wait(lambda: [e for e in launcher.report.events if e.startswith("spawned attempt 0")],
                        hang_timeout_s, "attempt 0 to start")
        pid = int(spawned[0].rsplit("pid=", 1)[1])
        ckpt = str(work / "ckpt")
        _wait(lambda: _complete_steps(ckpt), 4 * hang_timeout_s, "attempt 0's first complete checkpoint")
        os.kill(pid, signal.SIGSTOP)  # alive but silent: the launcher's hang
        resume_step = max(_complete_steps(ckpt))  # fixed now: the writer thread is stopped too
    finally:
        runner.join(timeout=12 * hang_timeout_s)
    assert not runner.is_alive(), "the launcher did not finish"
    rep = result["report"]
    assert rep.exit_code == 0 and rep.restarts == 1, rep.events
    assert any("heartbeat stale" in e and f"pid={pid}" in e for e in rep.events)
    assert not any("file-copy" in e for e in rep.events)
    assert resume_step < LAUNCHED_JOB["steps"]
    metrics = json.loads((work / "metrics.json").read_text())  # attempt 1's: attempt 0 never finished
    assert metrics["steps"][0]["step"] - 1 == resume_step and metrics["summary"]["steps"] == LAUNCHED_JOB["steps"]
    return {"launcher": launcher, "report": rep, "work": work, "prof": tmp_path / "prof",
            "resume_step": resume_step, "summary": metrics["summary"]}


def test_launcher_restarts_a_hung_trainer_from_its_checkpoint(tmp_path):
    from repro_torch.launch.train import Trainer, TrainJobConfig

    run = hung_once(tmp_path, "cpu", HANG_TIMEOUT_S)
    launcher, rep, prof = run["launcher"], run["report"], run["prof"]

    # the same job uninterrupted: the final parameters and optimizer state, bit for bit
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        Trainer(TrainJobConfig(**{**LAUNCHED_JOB, "out_dir": str(tmp_path / "ref"), "profile": False})).run()
    finally:
        torch.set_num_threads(threads)
    want = _state(str(tmp_path / "ref" / "ckpt"), LAUNCHED_JOB["steps"])
    got = _state(str(run["work"] / "ckpt"), LAUNCHED_JOB["steps"])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # one shared daemon saw both attempts; the aggregator's merged tree holds both
    assert len(launcher._daemons) == 1
    targets = {}
    for name in ("attempt0", "attempt1"):
        status = json.loads((prof / "fleet.d" / "targets" / name / "status.json").read_text())
        targets[name] = CallTree.from_json((prof / "fleet.d" / "targets" / name / "tree.json").read_text())
        assert targets[name].total() > 0
    assert status["done"]  # attempt 1 ends done
    merged = CallTree.from_json((prof / "merged_tree.json").read_text())
    assert merged.total() == targets["attempt0"].total() + targets["attempt1"].total()
    region = json.loads((prof / "region.d" / "region.json").read_text())
    assert {t if isinstance(t, str) else t["name"] for n in region["nodes"] for t in n["targets"]} \
        == {"attempt0", "attempt1"}
    assert any("fleet tree from in-process aggregator" in e for e in rep.events)
