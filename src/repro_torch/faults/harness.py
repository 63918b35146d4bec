"""Scenario harness: spawn workload children + an attached daemon, drive the
fault window, collect the daemon's verdicts.

One run of :func:`run_scenario` is the paper's validation loop in miniature:
a workload with a *known*, timestamped failure is profiled from outside, and
the events the daemon publishes (``events.jsonl``) become the raw material
the scoreboard grades.  A ``control=True`` run is the same workload with no
fault — any scored verdict it produces is a false positive.

Ground truth reaches the daemon in-band: the harness appends inject/clear
marker lines to ``<out>/fault_markers.jsonl`` *before* flipping the child's
control sentinel, and the daemon echoes them into the event log stamped with
each target's current epoch — so detection latency is measured in the
daemon's own epoch clock, not just wall time.

A copy of ``repro.faults.harness`` for the port, with the same windows,
grace and global rule: it spawns ``python -m repro_torch.faults._target``
children and the port's daemon (which imports no torch). ``device`` and
``smoke`` place the model drivers; no variable hides a device from the
children. Beside the JAX package's result, :class:`RunResult` carries each
child's cold start (spawn to ``ready``), the daemon's ``n_stacks`` (samples
ingested) when the fault was injected and cleared, and each torch child's
exit report (``_target``).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

from repro_torch.core.detector import TrendRule
from repro_torch.profilerd.daemon import FAULT_MARKERS_FILENAME, spawn_attached_daemon

from .base import FaultScenario


class HarnessError(RuntimeError):
    pass


@dataclass
class HarnessConfig:
    epoch_s: float = 0.4
    publish_s: float = 0.2
    agent_period_s: float = 0.004
    clean_s: float = 3.4       # pre-fault baseline (~8 epochs)
    fault_s: float = 4.2       # fault window (~10 epochs)
    recovery_s: float = 2.2    # post-clear (~5 epochs)
    # Verdicts caused by the fault can land a little after clear (trailing
    # windows, recovery drift): still true positives within this many epochs.
    grace_epochs: int = 3
    stall_timeout_s: float = 8.0  # default; scenarios may override shorter
    # The global catch-all dominance rule runs hot (0.97/3): scenario rules
    # carry detection, the global rule exists to catch the pure-spin shape
    # without false-firing on legitimately hot clean loops (jit dispatch).
    global_threshold: float = 0.97
    global_consecutive: int = 3
    # A child's cold start: torch, the CUDA context, the model's init on the
    # card and the Triton JIT.
    ready_timeout_s: float = 180.0
    keep_artifacts: bool = False
    device: str = "cuda"  # the model drivers' torch device
    smoke: bool = False  # the model drivers at their configs' smoke size


@dataclass
class RunResult:
    scenario: str
    control: bool
    events: list[dict]
    status: dict
    t_start: float
    t_inject: float | None
    t_clear: float | None
    epoch_s: float
    out_dir: str | None = None  # only when keep_artifacts
    host_logs: dict[str, str] = field(default_factory=dict)
    ready_s: float | None = None  # spawn -> every child's ready file
    # the daemon's n_stacks (samples ingested) at the inject and clear markers
    n_stacks_at: dict[str, int] = field(default_factory=dict)
    # host name -> the child's exit report (torch children only; see _target)
    child_reports: dict[str, dict] = field(default_factory=dict)


def _tail(path: str, n: int = 20) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def _wait_for(predicate, timeout_s: float, what: str, on_fail=None) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    extra = on_fail() if on_fail else ""
    raise HarnessError(f"timed out waiting for {what}" + (f"\n{extra}" if extra else ""))


def _child_report(path: str) -> dict:
    """The last ``{"faults_child": ...}`` line of a child's log, or {}."""
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return {}
    for line in reversed(lines):
        if line.startswith('{"faults_child"'):
            try:
                return json.loads(line)
            except ValueError:
                return {}
    return {}


def _append_marker(out_dir: str, scenario: str, op: str) -> float:
    """Write one ground-truth marker line; returns its wall timestamp."""
    wall = time.time()
    line = json.dumps({"op": op, "scenario": scenario, "wall_time": wall})
    with open(os.path.join(out_dir, FAULT_MARKERS_FILENAME), "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    return wall


def run_scenario(
    scenario: FaultScenario,
    cfg: HarnessConfig | None = None,
    *,
    control: bool = False,
) -> RunResult:
    cfg = cfg or HarnessConfig()
    ok, why = scenario.available()
    if not ok:
        raise HarnessError(f"scenario {scenario.name} unavailable: {why}")

    root = tempfile.mkdtemp(prefix=f"faults-{scenario.name}-")
    ctl = os.path.join(root, "ctl")
    work = os.path.join(root, "work")
    out = os.path.join(root, "out")
    for d in (ctl, work, out):
        os.makedirs(d)

    src_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(scenario.extra_child_env)

    children: list[subprocess.Popen] = []
    logs: dict[str, str] = {}
    daemon = None
    spools = [os.path.join(root, f"host{i}.spool") for i in range(scenario.n_hosts)]
    status_path = os.path.join(out, "status.json")
    t_inject = t_clear = None

    def _read_status() -> dict:
        try:
            with open(status_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _children_dead_tail() -> str:
        parts = []
        for i, p in enumerate(children):
            if p.poll() is not None:
                parts.append(f"host{i} exited rc={p.returncode}:\n{_tail(logs[f'host{i}'])}")
        return "\n".join(parts)

    try:
        t_spawn = time.monotonic()
        for i in range(scenario.n_hosts):
            log = os.path.join(root, f"host{i}.log")
            logs[f"host{i}"] = log
            with open(log, "w") as lf:
                children.append(
                    subprocess.Popen(
                        [
                            sys.executable, "-m", "repro_torch.faults._target",
                            "--scenario", scenario.name,
                            "--spool", spools[i],
                            "--ctl", ctl,
                            "--workdir", work,
                            "--host-index", str(i),
                            "--n-hosts", str(scenario.n_hosts),
                            "--period", str(cfg.agent_period_s),
                            "--device", cfg.device,
                            *(["--smoke"] if cfg.smoke else []),
                        ],
                        env=env, stdout=lf, stderr=subprocess.STDOUT,
                    )
                )

        _wait_for(
            lambda: all(
                os.path.exists(os.path.join(ctl, f"ready.{i}"))
                for i in range(scenario.n_hosts)
            )
            and all(p.poll() is None for p in children),
            cfg.ready_timeout_s,
            f"{scenario.name} children ready",
            on_fail=_children_dead_tail,
        )
        ready_s = time.monotonic() - t_spawn
        if any(p.poll() is not None for p in children):
            raise HarnessError(
                f"{scenario.name}: child died during warmup\n" + _children_dead_tail()
            )

        daemon = spawn_attached_daemon(
            targets=spools,
            out_dir=out,
            interval_s=cfg.publish_s,
            epoch_s=cfg.epoch_s,
            stall_timeout_s=scenario.stall_timeout_s or cfg.stall_timeout_s,
            rules=scenario.rules,
            trend_rule=TrendRule(),  # enable epoch-trend verdicts (LIVELOCK/DRIFT)
            threshold=cfg.global_threshold,
            consecutive=cfg.global_consecutive,
        )
        _wait_for(
            lambda: _read_status().get("n_targets") == scenario.n_hosts,
            30.0,
            f"{scenario.name} daemon attach ({scenario.n_hosts} targets)",
        )

        t_start = time.time()
        time.sleep(cfg.clean_s)

        n_stacks_at = {}
        if not control:
            t_inject = _append_marker(out, scenario.name, "inject")
            n_stacks_at["inject"] = _read_status().get("n_stacks", 0)
            if scenario.harness_side:
                for p in children:
                    os.kill(p.pid, signal.SIGSTOP)
            else:
                with open(os.path.join(ctl, "inject"), "w"):
                    pass
            time.sleep(cfg.fault_s)
            t_clear = _append_marker(out, scenario.name, "clear")
            n_stacks_at["clear"] = _read_status().get("n_stacks", 0)
            if scenario.harness_side:
                for p in children:
                    os.kill(p.pid, signal.SIGCONT)
            else:
                with open(os.path.join(ctl, "clear"), "w"):
                    pass
            time.sleep(cfg.recovery_s)
        else:
            time.sleep(cfg.fault_s + cfg.recovery_s)

        with open(os.path.join(ctl, "stop"), "w"):
            pass
        for p in children:
            try:
                p.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

        # All targets sent BYE -> the daemon drains, publishes, and exits.
        try:
            daemon.wait(timeout=45.0)
        except subprocess.TimeoutExpired:
            daemon.terminate()
            try:
                daemon.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                daemon.kill()
                daemon.wait()

        events = []
        ev_path = os.path.join(out, "events.jsonl")
        if os.path.exists(ev_path):
            with open(ev_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
        status = _read_status()
        return RunResult(
            scenario=scenario.name,
            control=control,
            events=events,
            status=status,
            t_start=t_start,
            t_inject=t_inject,
            t_clear=t_clear,
            epoch_s=cfg.epoch_s,
            out_dir=root if cfg.keep_artifacts else None,
            host_logs={k: _tail(v, 10) for k, v in logs.items()},
            ready_s=ready_s,
            n_stacks_at=n_stacks_at,
            child_reports={k: r for k, v in logs.items() if (r := _child_report(v))},
        )
    finally:
        for p in children:
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)  # in case we left it stopped
                except OSError:
                    pass
                p.kill()
                p.wait()
        if daemon is not None and daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        if not cfg.keep_artifacts:
            shutil.rmtree(root, ignore_errors=True)
