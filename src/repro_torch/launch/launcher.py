"""Process-level launcher with restart policy (fault tolerance at job scope).

The in-process watchdog (sampler + dominance detector) handles anomalies the
process can see; the launcher handles the ones it cannot — a hung or killed
trainer. Mechanism (the paper's external-observer stance, one level up):

* the trainer touches a **heartbeat file** every step;
* the launcher polls it; a stale heartbeat (or a dead process) triggers
  kill -> restart from the latest checkpoint (restore is exact: params,
  optimizer, data position);
* restarts are budgeted (``max_restarts``) with exponential backoff;
* **elastic**: each restart re-reads the host inventory (``n_hosts``) so a
  shrunk fleet resumes with re-partitioned data shards — checkpoints store
  logical state only, never device layouts.

**Shared per-node profiling daemon** (``profile_dir``): the launcher starts
ONE ``python -m repro_torch.profilerd attach --watch <profile_dir>`` per node — the
children only publish raw frames to per-attempt spools (they pick the daemon
backend up from ``REPRO_PROFILERD_SPOOL``, no config change needed), and the
single daemon discovers each spool as it appears, aggregates every target
out-of-process into per-target trees plus a continuously merged fleet tree
(``fleet.d/tree.json``), and re-attaches across child restarts.

**Multi-node merge** goes through the regional aggregator: the shared daemon
is spawned with ``--push`` at an aggregator URL (``aggregator_url`` for an
external ``profilerd aggregate``, or ``aggregate=True`` to run one in-process
under ``profile_dir/region.d``), every sealed epoch streams there as a
CRC-framed delta, and rendezvous just collects the aggregator's continuously
merged fleet tree — no file copying between nodes.  The legacy file-copy
rendezvous (``CallTree.merge`` across ``*.d`` dirs under a shared
``profile_dir``) remains as the documented fallback when no aggregator is
configured, and as the recovery path when an external aggregator is
unreachable at rendezvous.  This is the paper's single-external-observer
design at node scope, with zero profiling work inside any trainer.

On a multi-node deployment this wraps the per-host ``torch.distributed``
bring-up; here it supervises local subprocesses, and the tests exercise
hang-detection + restart with a deliberately stalling child.

A copy of ``repro.launch.launcher`` that imports no torch: the supervisor,
its shared daemon, the in-process aggregator and the merged-tree server map
neither torch nor CUDA, whatever job they supervise.  The port's trainer
writes ``device_tree.json`` into its own out dir and, where set, into
``$REPRO_PROFILERD_OUT``, which ``make_sampler`` pops first in both packages:
under the launcher the artifact never reaches ``fleet.d``, and
``_surface_device_tree`` finds none (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass, field


@dataclass
class LaunchConfig:
    cmd: list[str]
    workdir: str
    heartbeat_path: str
    heartbeat_timeout_s: float = 30.0
    poll_s: float = 0.5
    max_restarts: int = 3
    backoff_s: float = 1.0
    env: dict = field(default_factory=dict)
    # When set, one shared repro_torch.profilerd daemon per node watches this dir;
    # per-attempt spools land here and the fleet tree merges at rendezvous.
    profile_dir: str | None = None
    profile_period_s: float = 0.2
    # Push every sealed epoch to this regional aggregator (an external
    # ``profilerd aggregate`` endpoint); rendezvous collects the merged
    # fleet tree from it instead of copying files between nodes.
    aggregator_url: str | None = None
    # Run the regional aggregator in-process (under profile_dir/region.d)
    # when no external URL is given — single-supervisor deployments get the
    # push plane without operating a second service.
    aggregate: bool = False
    # Node name reported to the aggregator (defaults to the short hostname).
    node_name: str | None = None
    region: str = "region"
    # When set (with profile_dir), serve the rendezvous-merged fleet tree
    # over the profilerd HTTP query plane on this port (0 = ephemeral) once
    # the job ends; the server runs on a daemon thread (see Launcher.server).
    serve_port: int | None = None


@dataclass
class LaunchReport:
    restarts: int = 0
    exit_code: int | None = None
    events: list[str] = field(default_factory=list)

    def log(self, msg: str) -> None:
        self.events.append(msg)
        print(f"[launcher] {msg}")


class Launcher:
    def __init__(self, cfg: LaunchConfig):
        self.cfg = cfg
        self.report = LaunchReport()
        self.server = None  # ProfileServer over the merged profile (serve_port)
        self.aggregator = None  # in-process regional Aggregator (aggregate=True)
        self._agg_url: str | None = None  # effective push endpoint
        self._daemons: list[subprocess.Popen] = []
        if cfg.profile_dir and not os.path.isabs(cfg.profile_dir):
            # The launcher, the daemon (cwd=workdir), and the child all touch
            # this path; resolve it once, against the job's workdir.
            cfg.profile_dir = os.path.abspath(os.path.join(cfg.workdir, cfg.profile_dir))

    def _heartbeat_age(self) -> float:
        try:
            return time.time() - os.path.getmtime(self.cfg.heartbeat_path)
        except OSError:
            return float("inf")

    def _spawn(self, attempt: int = 0) -> subprocess.Popen:
        env = {**os.environ, **self.cfg.env}
        if self.cfg.profile_dir:
            spool = os.path.join(self.cfg.profile_dir, f"attempt{attempt}.spool")
            env["REPRO_PROFILERD_SPOOL"] = spool
            env["REPRO_PROFILERD_PERIOD"] = str(self.cfg.profile_period_s)
            # The shared daemon publishes this attempt's artifacts under its
            # per-target dir, not <spool>.d — point the child's DaemonBackend
            # (snapshot()/depth_trace()/wait-for-done) at the right place.
            env["REPRO_PROFILERD_OUT"] = os.path.join(
                self.cfg.profile_dir, "fleet.d", "targets", f"attempt{attempt}"
            )
            self._ensure_shared_daemon()
        return subprocess.Popen(
            self.cfg.cmd, cwd=self.cfg.workdir, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    # -- shared per-node profiling daemon ------------------------------------

    def _ensure_shared_daemon(self) -> None:
        """Start the node's ONE profilerd daemon (idempotent).

        It watches ``profile_dir`` and attaches every ``attempt*.spool`` as
        the supervised processes create them — restarts included, without
        multiplying daemon processes or resolver/ingest state.
        """
        if self._daemons:
            return
        from repro_torch.profilerd.daemon import spawn_attached_daemon

        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        self._ensure_aggregator()
        proc = spawn_attached_daemon(
            watch_dir=self.cfg.profile_dir,
            out_dir=os.path.join(self.cfg.profile_dir, "fleet.d"),
            stall_timeout_s=self.cfg.heartbeat_timeout_s,
            # Die with the launcher: a crashed supervisor must not leak a
            # watch daemon that has no BYE to exit on.
            exit_with_pid=os.getpid(),
            cwd=self.cfg.workdir,
            push=self._agg_url,
            push_node=self.cfg.node_name,
        )
        self._daemons.append(proc)
        self.report.log(f"profilerd daemon watching {self.cfg.profile_dir} (one per node)")
        if self._agg_url:
            self.report.log(f"daemon pushes sealed epochs to {self._agg_url}")

    def _ensure_aggregator(self) -> None:
        """Resolve the push endpoint: external URL, or an in-process one.

        ``aggregate=True`` without an ``aggregator_url`` starts the regional
        aggregator inside the launcher (ephemeral port, artifacts under
        ``profile_dir/region.d``) so a single supervisor gets the push plane
        without running ``profilerd aggregate`` as a separate service.
        """
        cfg = self.cfg
        if self._agg_url is not None or (not cfg.aggregator_url and not cfg.aggregate):
            return
        if cfg.aggregator_url:
            self._agg_url = cfg.aggregator_url
            return
        from repro_torch.profilerd.aggregator import Aggregator, AggregatorConfig

        try:
            self.aggregator = Aggregator(
                AggregatorConfig(
                    out_dir=os.path.join(cfg.profile_dir, "region.d"),
                    region=cfg.region,
                    stall_floor_s=max(cfg.heartbeat_timeout_s, 1.0),
                )
            )
            self._agg_url = self.aggregator.enable_serving().url
        except OSError as e:  # no listening socket: fall back to file copy
            self.report.log(f"in-process aggregator failed ({e}); file-copy rendezvous")
            self.aggregator = None
            return
        self.report.log(f"in-process aggregator ({cfg.region}) at {self._agg_url}")

    def _rendezvous_merge(self) -> str | None:
        """Collect the fleet tree at job end.

        With an aggregator configured (external or in-process) the merged
        tree is *already there* — every node's daemon pushed its sealed
        epochs — so rendezvous is one collect call.  Without one, fall back
        to the legacy file-copy merge across ``*.d`` dirs under the shared
        ``profile_dir`` (and use the same fallback if an external aggregator
        is unreachable: the job result must still land).
        """
        if not self.cfg.profile_dir:
            return None
        for d in self._daemons:
            # A --watch daemon has no BYE to exit on: SIGTERM asks it for a
            # clean final drain + seal + publish (and, with --push, a forced
            # final flush of the spill queue to the aggregator).
            d.terminate()
            try:
                d.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                d.kill()
                d.wait()
        out = self._collect_from_aggregator() if self._agg_url else None
        if out is None:
            out = self._merge_host_trees()
        if out is None:
            return None
        self._surface_device_tree()
        self._merge_timelines()
        self._serve_merged()
        return out

    def _collect_from_aggregator(self) -> str | None:
        """The aggregator's continuously merged fleet tree -> merged_tree.json.

        In-process: seal + publish + read directly.  External: one GET of
        ``/tree?fmt=json`` (the export schema round-trips through
        ``CallTree.from_json``).  Returns None on failure so the caller can
        fall back to the file-copy merge.
        """
        from repro_torch.core.calltree import CallTree

        merged = None
        if self.aggregator is not None:
            self.aggregator.seal_fleet_epoch(force=True)
            self.aggregator.publish()
            merged = self.aggregator.fleet_tree()
            self.aggregator.close()
            src = "in-process aggregator"
        else:
            import urllib.request

            url = self._agg_url.rstrip("/") + "/tree?fmt=json"
            try:
                with urllib.request.urlopen(url, timeout=10.0) as resp:
                    merged = CallTree.from_json(resp.read().decode())
            except (OSError, ValueError, KeyError) as e:
                self.report.log(f"rendezvous: aggregator fetch failed ({e}); file-copy fallback")
                return None
            src = self._agg_url
        if merged is None or not merged.root.children:
            self.report.log("rendezvous: aggregator holds no epochs; file-copy fallback")
            return None
        out = os.path.join(self.cfg.profile_dir, "merged_tree.json")
        with open(out, "w") as f:
            f.write(merged.to_json())
        self.report.log(f"rendezvous: fleet tree from {src} -> {out}")
        return out

    def _merge_host_trees(self) -> str | None:
        """Legacy file-copy rendezvous: merge ``*.d/tree.json`` dumps.

        The documented fallback for deployments without an aggregator — all
        nodes' daemons must share (or rsync into) ``profile_dir``.  With one
        node this loop is a pass-through of ``fleet.d/tree.json``.
        """
        from repro_torch.core.calltree import CallNode, CallTree

        merged = CallTree()
        n = 0
        for entry in sorted(os.listdir(self.cfg.profile_dir)):
            path = os.path.join(self.cfg.profile_dir, entry, "tree.json")
            if not entry.endswith(".d") or entry == "region.d" or not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    merged.merge(CallTree(CallNode.from_dict(json.load(f))))
                n += 1
            except (OSError, ValueError) as e:
                self.report.log(f"skipping unreadable tree {path}: {e}")
        if n == 0:
            return None
        out = os.path.join(self.cfg.profile_dir, "merged_tree.json")
        with open(out, "w") as f:
            f.write(merged.to_json())
        self.report.log(f"rendezvous: merged {n} host tree(s) -> {out}")
        return out

    def _surface_device_tree(self) -> None:
        """Copy a target-dropped ``device_tree.json`` beside the merged tree.

        Trainers drop the artifact into their daemon target dir (all
        co-located attempts run the same compiled program, so any one copy
        serves the fleet); surfacing it at the profile-dir root lets the
        rendezvous server answer ``/tree?plane=device|merged`` and
        ``profilerd check --plane`` gate the merged profile.
        """
        import glob

        dst = os.path.join(self.cfg.profile_dir, "device_tree.json")
        if os.path.exists(dst):
            return
        candidates = sorted(
            glob.glob(os.path.join(self.cfg.profile_dir, "*.d", "device_tree.json"))
            + glob.glob(os.path.join(self.cfg.profile_dir, "*.d", "targets", "*", "device_tree.json"))
        )
        if not candidates:
            return
        try:
            with open(candidates[0]) as f:
                payload = f.read()
            tmp = f"{dst}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, dst)
            self.report.log(f"rendezvous: device plane {candidates[0]} -> {dst}")
        except OSError as e:
            self.report.log(f"rendezvous: device plane copy failed: {e}")

    def _serve_merged(self) -> None:
        """Expose the fleet-merged profile over the HTTP query plane.

        The paper's cross-host aggregation becomes queryable the moment the
        job ends: ``/tree?fmt=html`` is the fleet flamegraph, ``/timeline``
        replays the merged epoch ring, ``/diff?baseline=`` compares against
        any earlier run.  The server thread is a daemon thread — callers that
        want it to outlive ``run()`` keep the process alive (or use
        ``python -m repro_torch.profilerd serve --profile <profile_dir>``).
        """
        if self.cfg.serve_port is None or self.server is not None:
            return
        from repro_torch.profilerd.server import OfflineSource, ProfileServer

        try:
            self.server = ProfileServer(
                OfflineSource(self.cfg.profile_dir, label="fleet-merged"),
                port=self.cfg.serve_port,
            ).start()
        except OSError as e:  # port taken: the job result must still land
            self.report.log(f"rendezvous: serve failed ({e})")
            return
        self.report.log(f"rendezvous: merged profile served at {self.server.url}")

    def _merge_timelines(self) -> str | None:
        """Merge per-host timeline rings epoch-by-epoch at rendezvous.

        Epochs join on their sealed epoch *number*, not list position — ring
        retention may have dropped a long-running host's oldest segments, so
        its first retained epoch can be far from 0.  At each merged epoch a
        host contributes its latest cumulative tree at-or-before that epoch
        (a host that stopped early keeps contributing its final tree), so the
        fleet total never dips.  The merged ring lives beside
        ``merged_tree.json`` and feeds ``profilerd timeline``/``diff``/
        ``check`` at fleet scope.
        """
        from repro_torch.core.calltree import CallTree
        from repro_torch.core.snapshot import EpochMeta, TimelineReader, TimelineWriter, is_timeline_dir

        # Streamed lock-step merge: each host holds one retained cumulative
        # copy, never its whole epoch history (a long ring can span 1000+
        # epochs of 10k-node trees — materializing every cumulative per host
        # would OOM the launcher at rendezvous).
        hosts = []  # per host: {"it": epoch iterator, "peek", "meta", "cum"}
        for entry in sorted(os.listdir(self.cfg.profile_dir)):
            tdir = os.path.join(self.cfg.profile_dir, entry, "timeline")
            # region.d is the aggregator's out dir: its ring already IS the
            # fleet sum, so folding it in would double-count every node.
            if entry.endswith(".d") and entry != "region.d" and is_timeline_dir(tdir):
                it = TimelineReader(tdir).epochs()
                peek = next(it, None)
                if peek is not None:
                    hosts.append({"it": it, "peek": peek, "meta": None, "cum": None})
        if not hosts:
            return None
        out_dir = os.path.join(self.cfg.profile_dir, "merged_timeline")
        writer = TimelineWriter(out_dir)
        prev = CallTree()
        n_merged = 0
        while any(h["peek"] is not None for h in hosts):
            epoch = min(h["peek"][0].epoch for h in hosts if h["peek"] is not None)
            fleet = CallTree()
            wall = 0.0
            progress = 0.0
            for h in hosts:
                while h["peek"] is not None and h["peek"][0].epoch <= epoch:
                    meta, _window, cum = h["peek"]
                    # Copy before advancing: the reader mutates `cum` in place.
                    h["meta"], h["cum"] = meta, cum.copy()
                    h["peek"] = next(h["it"], None)
                if h["cum"] is None:
                    continue  # host's retained history starts later
                fleet.merge(h["cum"])
                wall = max(wall, h["meta"].wall_time)
                progress += h["meta"].progress
            meta_out = EpochMeta(epoch, wall, progress)
            if writer.needs_keyframe():
                writer.append_full(fleet, meta_out)
            else:
                writer.append_delta(fleet.diff(prev), meta_out)
            prev = fleet
            n_merged += 1
        writer.close()
        self.report.log(
            f"rendezvous: merged {len(hosts)} host timeline(s) x {n_merged} epoch(s) -> {out_dir}"
        )
        return out_dir

    def run(self) -> LaunchReport:
        cfg, rep = self.cfg, self.report
        attempt = 0
        while True:
            start = time.time()
            proc = self._spawn(attempt)
            rep.log(f"spawned attempt {attempt} pid={proc.pid}")
            hung = False
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                age = self._heartbeat_age()
                alive_for = time.time() - start
                if alive_for > cfg.heartbeat_timeout_s and age > cfg.heartbeat_timeout_s:
                    hung = True
                    rep.log(f"heartbeat stale ({age:.1f}s) -> SIGKILL pid={proc.pid}")
                    proc.kill()
                    proc.wait()
                    break
                time.sleep(cfg.poll_s)
            out = proc.stdout.read() if proc.stdout else ""
            if not hung and proc.returncode == 0:
                rep.exit_code = 0
                rep.log("job completed")
                self._rendezvous_merge()
                return rep
            reason = "hang" if hung else f"exit={proc.returncode}"
            attempt += 1
            rep.restarts = attempt
            if attempt > cfg.max_restarts:
                rep.exit_code = proc.returncode if not hung else -9
                rep.log(f"giving up after {attempt - 1} restarts ({reason}); last output tail:\n"
                        + "\n".join(out.splitlines()[-5:]))
                self._rendezvous_merge()
                return rep
            rep.log(f"restarting ({reason}); resume comes from the latest checkpoint")
            time.sleep(cfg.backoff_s * attempt)
