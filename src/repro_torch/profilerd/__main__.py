"""``python -m repro_torch.profilerd`` — attach the profiling daemon to a running job.

Typical flow (the paper's workflow, one process over):

  # terminal 1: run a job that publishes raw frames to a spool
  PYTHONPATH=src python -m repro_torch.launch.train --backend daemon \\
      --spool /tmp/train.spool

  # terminal 2: attach, watch live hot paths, get a report at the end
  PYTHONPATH=src python -m repro_torch.profilerd attach --spool /tmp/train.spool --follow

Subcommands (a copy of ``repro.profilerd``'s, imports no torch):

  attach   — drain one or more spools until every target says BYE (or dies),
             publishing status.json / tree.json / events.jsonl / report.html
             / timeline/ under --out (default <spool>.d); one daemon attaches
             a whole fleet: --targets a.spool,b.spool names explicit spools,
             --watch DIR discovers spools created after the daemon starts
             (per-target artifacts land under <out>/targets/<name>/, the
             merged fleet tree stays at <out>/tree.json; a --watch daemon
             runs until SIGTERM, which triggers a clean final drain+publish);
             --follow prints live hot paths; --device-tree PATH names the
             device-plane artifact (the trainer's device_tree.json), which
             may appear after the daemon starts.
  status   — print the latest status.json published by a running daemon.
  report   — render an HTML report from a previously dumped tree.json.

Not ported yet (ROADMAP Queue 1 item 18): ``attach --serve`` and ``--push``
(they raise), and the ``aggregate``, ``serve``, ``top``, ``export``,
``timeline``, ``diff`` and ``check`` subcommands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.detector import Rule, TrendRule

from .daemon import DaemonConfig, ProfilerDaemon, rule_from_spec
from .spool import SpoolError


def _print_status(d: ProfilerDaemon) -> None:
    s = d.status()
    state = "STALLED" if s["stalled"] else ("done" if s["done"] else "live")
    who = f"targets={s['n_targets']}" if s["n_targets"] > 1 else f"pid={s['pid']}"
    print(
        f"[profilerd] {who} {state} stacks={s['n_stacks']} "
        f"dropped={s['dropped_batches']} events={len(d.events)}"
    )
    for hp in s["hot_paths"][:5]:
        print(f"  {hp['share']:7.2%}  {'/'.join(hp['path'])}")


def cmd_attach(args) -> int:
    targets = tuple(t.strip() for t in (args.targets or "").split(",") if t.strip())
    if not (args.spool or targets or args.watch):
        print("[profilerd] attach needs --spool, --targets and/or --watch",
              file=sys.stderr)
        return 2
    rules = [Rule(threshold=args.threshold, consecutive=args.consecutive)]
    for spec in args.rule or ():
        try:
            rules.append(rule_from_spec(spec))
        except ValueError as e:
            print(f"[profilerd] {e}", file=sys.stderr)
            return 2
    trend_rule = None
    if args.trend_threshold is not None or args.trend_epochs is not None or args.trend_drift is not None:
        trend_rule = TrendRule()
        if args.trend_threshold is not None:
            trend_rule.threshold = args.trend_threshold
        if args.trend_epochs is not None:
            trend_rule.epochs = args.trend_epochs
        if args.trend_drift is not None:
            trend_rule.drift_threshold = args.trend_drift
    cfg = DaemonConfig(
        spool_path=args.spool,
        spool_paths=targets,
        watch_dir=args.watch,
        out_dir=args.out,
        publish_interval_s=args.interval,
        collapse_origins=tuple(o for o in (args.collapse or "").split(",") if o),
        rules=rules,
        trend_rule=trend_rule,
        stall_timeout_s=args.stall_timeout,
        attach_timeout_s=args.attach_timeout,
        max_seconds=args.max_seconds,
        epoch_s=args.epoch,
        serve_port=args.serve,
        exit_with_pid=args.exit_with,
        device_tree=args.device_tree,
        push_url=args.push,
        push_node=args.push_node,
    )
    try:
        daemon = ProfilerDaemon(cfg)
    except NotImplementedError as e:  # --serve / --push: not ported yet
        print(f"[profilerd] {e}", file=sys.stderr)
        return 2
    # SIGTERM = finish cleanly: final drain + seal + publish + report.  This
    # is how a supervisor (the launcher's shared per-node daemon, CI) ends a
    # --watch run, which has no natural BYE to exit on.
    try:
        import signal

        signal.signal(signal.SIGTERM, lambda *_: daemon.request_stop())
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        daemon.attach()
        tree = daemon.run(on_publish=_print_status if args.follow else None)
    except SpoolError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return 1
    out = cfg.resolved_out_dir()
    print(f"[profilerd] merged {daemon.n_stacks} stacks -> {os.path.join(out, 'tree.json')}")
    if len(daemon.sources) > 1 or args.watch:
        for s in daemon.sources:
            print(f"[profilerd] target {s.name}: stacks={s.n_stacks} "
                  f"dropped={s.dropped_batches} restarts={s.restarts} "
                  f"-> {os.path.join(out, 'targets', s.name, 'tree.json')}")
    print(f"[profilerd] report: {os.path.join(out, 'report.html')}")
    for ev in daemon.events:
        print(f"[profilerd] event: {json.dumps(ev)}")
    if tree.total() > 0:
        print(tree.render(min_share=0.02, max_depth=4))
    return 0


def cmd_status(args) -> int:
    path = os.path.join(args.out, "status.json")
    try:
        with open(path) as f:
            print(json.dumps(json.load(f), indent=1))
    except OSError as e:
        print(f"no status at {path}: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_report(args) -> int:
    from repro_torch.core.calltree import CallTree
    from repro_torch.core.report import render_html

    with open(args.tree) as f:
        tree = CallTree.from_json(f.read())
    out = args.html or (os.path.splitext(args.tree)[0] + ".html")
    with open(out, "w") as f:
        f.write(render_html(tree, title=os.path.basename(args.tree)))
    print(out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profilerd", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    at = sub.add_parser("attach", help="attach to one or more spools and stream until the targets exit")
    at.add_argument("--spool", default=None, help="spool file the target publishes to")
    at.add_argument("--targets", default=None, metavar="SPOOL[,SPOOL...]",
                    help="explicit multi-target attach: comma-separated spool paths")
    at.add_argument("--watch", default=None, metavar="DIR",
                    help="attach every *.spool in DIR, incl. ones created later "
                         "(runs until SIGTERM; clean final drain+publish)")
    at.add_argument("--out", default=None,
                    help="artifact dir (default: <spool>.d, or <watch>/fleet.d)")
    at.add_argument("--interval", type=float, default=1.0, help="publish/analysis window seconds")
    at.add_argument("--collapse", default="", help="comma-separated origins to fold (e.g. py,jax)")
    at.add_argument("--threshold", type=float, default=0.9, help="dominance-rule threshold")
    at.add_argument("--consecutive", type=int, default=2, help="windows before a rule fires")
    at.add_argument("--rule", action="append", default=[], metavar="SPEC",
                    help="extra dominance rule, repeatable: "
                         "pattern=P,threshold=T,consecutive=N,kind=K,self_only=0|1")
    at.add_argument("--trend-threshold", type=float, default=None,
                    help="epoch-trend dominance threshold (default 0.9)")
    at.add_argument("--trend-epochs", type=int, default=None,
                    help="stalled-dominance epochs before LIVELOCK (default 3)")
    at.add_argument("--trend-drift", type=float, default=None,
                    help="SHARE_DRIFT TV-distance threshold (default 0.35)")
    at.add_argument("--stall-timeout", type=float, default=5.0,
                    help="seconds of silence from a live target before TARGET_STALLED")
    at.add_argument("--attach-timeout", type=float, default=30.0)
    at.add_argument("--max-seconds", type=float, default=None, help="bound the attach run")
    at.add_argument("--follow", action="store_true", help="print live hot paths every window")
    at.add_argument("--epoch", type=float, default=5.0,
                    help="timeline epoch seconds (0 disables the timeline ring)")
    at.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="the live HTTP query plane: not ported yet (exits 2)")
    at.add_argument("--exit-with", type=int, default=None, metavar="PID",
                    help="finish cleanly when PID dies (supervisors pass their own "
                         "pid so a --watch daemon can never be leaked)")
    at.add_argument("--device-tree", default=None, metavar="PATH",
                    help="device-plane artifact (the trainer's device_tree.json), read "
                         "once it appears; seals roofline-annotated (H100) timeline "
                         "epochs (default: discover device_tree.json dropped into the "
                         "out/target dirs)")
    at.add_argument("--push", default=None, metavar="URL",
                    help="push sealed epochs to a regional aggregator: not ported yet (exits 2)")
    at.add_argument("--push-node", default=None, metavar="NAME",
                    help="node name announced to the aggregator (with --push)")
    at.set_defaults(fn=cmd_attach)

    st = sub.add_parser("status", help="print the latest published status.json")
    st.add_argument("--out", required=True, help="daemon artifact dir")
    st.set_defaults(fn=cmd_status)

    rp = sub.add_parser("report", help="render HTML from a dumped tree.json")
    rp.add_argument("--tree", required=True)
    rp.add_argument("--html", default=None)
    rp.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # `profilerd status ... | head` is routine; die quietly.  Point
        # stdout at devnull so the interpreter's shutdown flush of the
        # broken pipe can't raise a second traceback.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        rc = 0
    raise SystemExit(rc)
