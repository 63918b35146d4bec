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
             --follow prints live hot paths; --serve PORT exposes the live
             HTTP query plane while attached; --push URL ships each sealed
             epoch to a regional aggregator; --device-tree PATH names the
             device-plane artifact (the trainer's device_tree.json), which
             may appear after the daemon starts.
  aggregate— regional fleet tier: ingest epochs POSTed by node daemons
             (attach --push) into per-node timeline rings + a merged fleet
             tree with downsampled long-term retention, serving the same
             query plane (/targets goes region -> node -> target).
  serve    — HTTP API (/status /targets /tree /timeline /diff) over an
             *offline* profile artifact (daemon out dir — multi-target dirs
             serve /tree?target=NAME too — timeline ring, tree.json, .snap);
             pointing it at a dir a daemon is still writing works too.
  top      — refreshing terminal view of the hottest paths + verdicts,
             polling a serve/attach --serve endpoint.
  export   — render a profile as folded stacks, speedscope JSON, flamegraph
             HTML, or a view CSV (exit 4 when --view/--root matches nothing).
  status   — print the latest status.json published by a running daemon.
  report   — render an HTML report from a previously dumped tree.json.
  timeline — phase segmentation + per-epoch table over a sealed timeline ring.
  diff     — cross-run tree diff with per-node share deltas; --html writes the
             share-delta flamegraph (red = candidate grew).
  check    — gate a profile against a baseline snapshot (CI): exit 0 on pass,
             2 on share regression beyond --tolerance, 3 on unreadable input.

``serve``/``export``/``timeline``/``diff``/``check`` accept profiles in any
of these shapes: a daemon --out dir (uses its ``timeline/`` ring, falling
back to ``tree.json``), a timeline ring dir, a ``tree.json`` dump, or a
binary ``.snap`` snapshot (``repro_torch.core.snapshot.save_snapshot``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.detector import Rule, TrendRule
from repro_torch.core.planes import PLANES, PlaneError, default_metric, select_plane

from .daemon import DaemonConfig, ProfilerDaemon, rule_from_spec
from .profiles import (
    TIMELINE_DIRNAME,
    ProfileLoadError,
    load_device_plane,
    load_profile,
    load_static_plane,
)
from .spool import SpoolError

EXIT_REGRESSION = 2
EXIT_UNREADABLE = 3
EXIT_NO_MATCH = 4  # a --view/--root selector (or --plane artifact) matched nothing


def _resolve_plane(tree, profile_path: str, plane: str):
    """Apply ``--plane`` to a loaded profile via its own device artifact.

    Raises :class:`PlaneError` (caller exits ``EXIT_NO_MATCH`` with the remedy
    hint — a missing artifact is "selector matched nothing", not corruption)
    or :class:`ProfileLoadError` for a present-but-garbage artifact."""
    if plane == "host":
        return tree
    if plane == "static":
        return select_plane(
            tree, None, plane, profile=profile_path, static=load_static_plane(profile_path)
        )
    return select_plane(tree, load_device_plane(profile_path), plane, profile=profile_path)


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
    daemon = ProfilerDaemon(cfg)
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
        if args.serve is not None:
            try:
                print(f"[profilerd] live query plane: {daemon.enable_serving().url}", flush=True)
            except OSError as e:
                # A busy/privileged port must not cost the profiling run:
                # attach continues unserved, like the launcher's fallback.
                print(f"[profilerd] serve on port {args.serve} failed ({e}); "
                      "continuing without the query plane", file=sys.stderr)
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


def cmd_aggregate(args) -> int:
    from .aggregator import Aggregator, AggregatorConfig

    cfg = AggregatorConfig(
        out_dir=args.out,
        region=args.region,
        host=args.host,
        port=args.port,
        epoch_s=args.epoch,
        coarse_every=args.coarse_every,
        stall_factor=args.stall_factor,
        max_seconds=args.max_seconds,
    )
    agg = Aggregator(cfg)
    try:
        agg.install_signal_handlers()
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        server = agg.enable_serving()
    except OSError as e:
        print(f"[profilerd] cannot bind {args.host}:{args.port}: {e}", file=sys.stderr)
        return 1
    print(f"[profilerd] aggregating region {cfg.region!r} at {server.url} "
          f"(push endpoint {server.url}/push) -> {args.out}", flush=True)
    try:
        tree = agg.run()
    except KeyboardInterrupt:
        agg.request_stop()
        tree = agg.fleet_tree()
        agg.close()
    status = agg.status()
    print(f"[profilerd] fleet: nodes={status['n_nodes']} "
          f"epochs={status['fleet']['epochs']} mass={tree.total():.6g} "
          f"-> {os.path.join(args.out, 'tree.json')}")
    return 0


def cmd_serve(args) -> int:
    from .server import OfflineSource, ProfileServer

    source = OfflineSource(args.profile)
    try:
        source.tree()  # fail fast on an unreadable profile
    except ProfileLoadError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    try:
        server = ProfileServer(
            source, host=args.host, port=args.port, baseline=args.baseline, verbose=args.verbose
        )
    except OSError as e:  # busy/privileged port: message, not a traceback
        print(f"[profilerd] cannot bind {args.host}:{args.port}: {e}", file=sys.stderr)
        return 1
    print(f"[profilerd] serving {args.profile} at {server.url}")
    print(f"[profilerd] endpoints: {server.url}/status /targets /tree /timeline /diff (see /help)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[profilerd] bye")
    return 0


def cmd_top(args) -> int:
    from .server import top_loop

    try:
        return top_loop(args.url, interval_s=args.interval, k=args.k, once=args.once,
                        plane=args.plane)
    except KeyboardInterrupt:
        return 0


def cmd_export(args) -> int:
    from repro_torch.core.export import EXPORT_FORMATS, diff_flamegraph_html, export_tree, prepare_view
    from repro_torch.core.report import ViewConfig

    try:
        tree = _resolve_plane(load_profile(args.profile), args.profile, args.plane)
    except PlaneError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_NO_MATCH
    except ProfileLoadError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    metric_arg = default_metric(args.plane, args.metric)
    fmt = args.fmt or ("html" if args.baseline else "folded")
    view = None
    if args.view:
        from repro_torch.core.views_library import VIEWS

        if args.view not in VIEWS:
            print(f"[profilerd] unknown view {args.view!r}; views: {', '.join(sorted(VIEWS))}",
                  file=sys.stderr)
            return EXIT_UNREADABLE
        view = VIEWS[args.view]
    # Ad-hoc selectors refine the named view (or stand alone without one).
    overrides = {k: v for k, v in
                 [("root", args.root), ("level", args.level), ("min_share", args.min_share)]
                 if v is not None}
    if view is not None and overrides:
        from dataclasses import replace

        view = replace(view, **overrides)
    elif view is None and overrides:
        view = ViewConfig(name=args.root or "adhoc", **overrides)
    # A selector that matches nothing must fail loudly, not ship an empty
    # artifact that reads as "this code path costs nothing".  prepare_view
    # applies zoom/filters/level/min_share exactly once and owns every
    # emptiness verdict (incl. fmt stacklessness, e.g. a level=0 fold).
    applied, metric, marker = prepare_view(tree, view, metric_arg, fmt=fmt)
    if marker is not None:
        print(f"[profilerd] {marker}", file=sys.stderr)
        if fmt == "csv":
            print(export_tree(tree, "csv", view=view, metric=metric_arg, title=args.profile))
        return EXIT_NO_MATCH
    if args.baseline:
        if fmt != "html":  # usage error, not an unreadable profile: exit 2
            print(f"[profilerd] --baseline renders a diff flamegraph; it requires "
                  f"--fmt html (got --fmt {fmt})", file=sys.stderr)
            return 2
        try:
            baseline = _resolve_plane(load_profile(args.baseline), args.baseline, args.plane)
        except PlaneError as e:
            print(f"[profilerd] baseline: {e}", file=sys.stderr)
            return EXIT_NO_MATCH
        except ProfileLoadError as e:
            print(f"[profilerd] {e}", file=sys.stderr)
            return EXIT_UNREADABLE
        # The baseline goes through the SAME prepare_view pipeline as the
        # candidate (incl. min_share pruning) — asymmetric filtering would
        # paint sub-threshold call-sites as phantom share deltas.
        baseline, _, _ = prepare_view(baseline, view, metric_arg)
        payload = diff_flamegraph_html(baseline, applied, metric,
                                       title=f"{args.baseline} vs {args.profile}")
    else:
        assert fmt in EXPORT_FORMATS
        title = os.path.basename(args.profile.rstrip("/")) or args.profile
        if args.plane != "host":
            title = f"{title} [{args.plane} plane]"
        if fmt == "csv":
            payload = export_tree(tree, "csv", view=view, metric=metric_arg, title=title)
        else:
            if view is not None:
                title = f"{title} [{view.name}]"
            payload = export_tree(applied, fmt, metric=metric, title=title,
                                  roofline=args.plane == "merged")
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"[profilerd] wrote {args.out} ({len(payload)} bytes, fmt={fmt})")
    else:
        print(payload)
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


def cmd_timeline(args) -> int:
    from repro_torch.core.snapshot import SnapshotError, TimelineReader, is_timeline_dir
    from repro_torch.core.views_library import phase_table, timeline_table

    store = args.store
    nested = os.path.join(store, TIMELINE_DIRNAME)
    if not is_timeline_dir(store) and is_timeline_dir(nested):
        store = nested
    if not is_timeline_dir(store):
        print(f"no timeline ring at {args.store}", file=sys.stderr)
        return EXIT_UNREADABLE
    reader = TimelineReader(store)
    epochs = []  # (meta, window, None): the reader's cumulative is a live
    final = None  # accumulator, so only the final state is retained here
    try:
        for meta, window, cum in reader.epochs():
            epochs.append((meta, window, None))
            final = cum
    except SnapshotError as e:  # e.g. version skew from a newer build
        print(f"[profilerd] {store}: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    if not epochs:
        print(f"{store}: timeline ring holds no decodable epochs", file=sys.stderr)
        return EXIT_UNREADABLE
    if reader.truncated:
        print("# note: torn/corrupt record(s) skipped (crash-safe append)", file=sys.stderr)
    print(phase_table(epochs, boundary=args.boundary, metric=args.metric))
    print()
    print(timeline_table(epochs, metric=args.metric))
    print(f"\ncumulative: {final.total(args.metric):.6g} {args.metric} over {final.node_count()} call sites")
    return 0


def cmd_diff(args) -> int:
    from repro_torch.core.report import render_diff

    try:
        a = _resolve_plane(load_profile(args.a), args.a, args.plane)
        b = _resolve_plane(load_profile(args.b), args.b, args.plane)
    except PlaneError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_NO_MATCH
    except ProfileLoadError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    metric = default_metric(args.plane, args.metric) or "samples"
    print(
        render_diff(
            a,
            b,
            metric=metric,
            label_a=os.path.basename(args.a.rstrip("/")) or args.a,
            label_b=os.path.basename(args.b.rstrip("/")) or args.b,
            min_delta=args.min_delta,
            max_rows=args.top,
            self_only=args.self_only,
        )
    )
    if args.html:
        from repro_torch.core.export import diff_flamegraph_html

        with open(args.html, "w") as f:
            f.write(
                diff_flamegraph_html(
                    a, b, metric,
                    title=f"{os.path.basename(args.a.rstrip('/')) or args.a} vs "
                          f"{os.path.basename(args.b.rstrip('/')) or args.b}",
                )
            )
        print(f"# diff flamegraph: {args.html}")
    return 0


def cmd_check(args) -> int:
    from repro_torch.core.detector import share_distance
    from repro_torch.core.report import name_shares, share_regressions

    try:
        baseline = _resolve_plane(load_profile(args.baseline), args.baseline, args.plane)
    except PlaneError as e:
        print(f"[profilerd] baseline: {e}", file=sys.stderr)
        return EXIT_NO_MATCH
    except ProfileLoadError as e:
        print(f"[profilerd] missing/unreadable baseline: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    try:
        current = _resolve_plane(load_profile(args.profile), args.profile, args.plane)
    except PlaneError as e:
        print(f"[profilerd] {e}", file=sys.stderr)
        return EXIT_NO_MATCH
    except ProfileLoadError as e:
        print(f"[profilerd] missing/unreadable profile: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    metric = default_metric(args.plane, args.metric) or "samples"
    # An empty profile must not pass vacuously (every baseline function
    # "lost share"): a gate that stops gating when profiling broke is worse
    # than a red build.
    if current.total(metric) <= 0:
        print(f"[profilerd] profile {args.profile} holds no '{metric}' data", file=sys.stderr)
        return EXIT_UNREADABLE
    if baseline.total(metric) <= 0:
        print(f"[profilerd] baseline {args.baseline} holds no '{metric}' data", file=sys.stderr)
        return EXIT_UNREADABLE
    self_only = not args.inclusive
    regs = share_regressions(
        baseline, current, metric=metric, tolerance=args.tolerance, self_only=self_only
    )
    dist = share_distance(
        name_shares(baseline, metric, self_only=self_only),
        name_shares(current, metric, self_only=self_only),
    )
    verdict = "REGRESSION" if regs else "PASS"
    print(
        f"[check] {verdict} tolerance={args.tolerance:.2%} share_distance={dist:.4f} "
        f"profile={args.profile} baseline={args.baseline}"
    )
    for name, b, c, d in regs[: args.top]:
        print(f"  {d:+7.2%}  {b:7.2%} -> {c:7.2%}  {name}")
    return EXIT_REGRESSION if regs else 0


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
                    help="serve the live HTTP query plane on this port while attached (0 = ephemeral)")
    at.add_argument("--exit-with", type=int, default=None, metavar="PID",
                    help="finish cleanly when PID dies (supervisors pass their own "
                         "pid so a --watch daemon can never be leaked)")
    at.add_argument("--device-tree", default=None, metavar="PATH",
                    help="device-plane artifact (the trainer's device_tree.json), read "
                         "once it appears; enables plane=device|merged on the query "
                         "plane and seals roofline-annotated (H100) timeline epochs "
                         "(default: discover device_tree.json dropped into the "
                         "out/target dirs)")
    at.add_argument("--push", default=None, metavar="URL",
                    help="POST each sealed epoch to a regional aggregator "
                         "(profilerd aggregate) at this URL; outages spill "
                         "locally and resync — ingest never blocks")
    at.add_argument("--push-node", default=None, metavar="NAME",
                    help="node name announced to the aggregator (default: hostname)")
    at.set_defaults(fn=cmd_attach)

    ag = sub.add_parser("aggregate",
                        help="regional aggregator: ingest epochs pushed by node "
                             "daemons (attach --push) into a merged fleet profile")
    ag.add_argument("--out", required=True, help="aggregator artifact dir")
    ag.add_argument("--port", type=int, default=0,
                    help="bind the ingest + query plane here (0 = ephemeral; "
                         "the bound URL is printed on start)")
    ag.add_argument("--host", default="127.0.0.1")
    ag.add_argument("--region", default="region", help="region label for /targets and top")
    ag.add_argument("--epoch", type=float, default=2.0,
                    help="fleet seal + publish cadence seconds")
    ag.add_argument("--coarse-every", type=int, default=8,
                    help="long-horizon ring keeps one keyframe every N fleet epochs")
    ag.add_argument("--stall-factor", type=float, default=1.5,
                    help="NODE_STALLED after this many push intervals of silence")
    ag.add_argument("--max-seconds", type=float, default=None, help="bound the run (tests)")
    ag.set_defaults(fn=cmd_aggregate)

    sv = sub.add_parser("serve", help="HTTP API over an offline profile artifact")
    sv.add_argument("--profile", required=True,
                    help="profile to serve (out dir / timeline ring / tree.json / .snap)")
    sv.add_argument("--port", type=int, default=8787)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--baseline", default=None, help="default baseline for /diff")
    sv.add_argument("--verbose", action="store_true", help="log every request")
    sv.set_defaults(fn=cmd_serve)

    tp = sub.add_parser("top", help="refreshing terminal view of a serve endpoint")
    tp.add_argument("--url", default="http://127.0.0.1:8787", help="serve endpoint base URL")
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("-k", type=int, default=10, help="hot paths shown")
    tp.add_argument("--once", action="store_true", help="print one frame and exit (CI/tests)")
    tp.add_argument("--plane", default="host", choices=list(PLANES),
                    help="also show the plane's hottest paths with roofline occupancy "
                         "+ dominant-term columns (exit 4 if the server has no device plane)")
    tp.set_defaults(fn=cmd_top)

    ex = sub.add_parser("export", help="render a profile as folded/speedscope/html/csv/json")
    ex.add_argument("profile", help="profile (out dir / timeline / tree.json / .snap)")
    ex.add_argument("--fmt", default=None, choices=["csv", "folded", "speedscope", "html", "json"],
                    help="output format (default: folded; html when --baseline is given)")
    ex.add_argument("--view", default=None, help="library view name (views_library.list_views())")
    ex.add_argument("--root", default=None, help="zoom selector (substring); refines --view")
    ex.add_argument("--level", type=int, default=None, help="fold level (-1 = expand to leaves)")
    ex.add_argument("--min-share", type=float, default=None, help="prune below this share")
    ex.add_argument("--metric", default=None)
    ex.add_argument("--plane", default="host", choices=list(PLANES),
                    help="profile plane: sampled host tree, the profiled step's device tree, or the "
                         "roofline-annotated merge (exit 4 when device_tree.json is absent)")
    ex.add_argument("--baseline", default=None,
                    help="render a share-delta diff flamegraph against this profile (--fmt html)")
    ex.add_argument("--out", default=None, help="write here instead of stdout")
    ex.set_defaults(fn=cmd_export)

    st = sub.add_parser("status", help="print the latest published status.json")
    st.add_argument("--out", required=True, help="daemon artifact dir")
    st.set_defaults(fn=cmd_status)

    rp = sub.add_parser("report", help="render HTML from a dumped tree.json")
    rp.add_argument("--tree", required=True)
    rp.add_argument("--html", default=None)
    rp.set_defaults(fn=cmd_report)

    tl = sub.add_parser("timeline", help="phase segmentation + epoch table over a timeline ring")
    tl.add_argument("--store", required=True, help="timeline ring dir (or a daemon --out dir)")
    tl.add_argument("--boundary", type=float, default=0.25,
                    help="TV-distance jump that starts a new phase")
    tl.add_argument("--metric", default="samples")
    tl.set_defaults(fn=cmd_timeline)

    df = sub.add_parser("diff", help="cross-run tree diff (per-node share deltas)")
    df.add_argument("a", help="baseline profile (out dir / timeline / tree.json / .snap)")
    df.add_argument("b", help="candidate profile")
    df.add_argument("--metric", default=None, help="default: samples (flops on --plane device)")
    df.add_argument("--plane", default="host", choices=list(PLANES),
                    help="diff this plane on both sides (each via its own device_tree.json)")
    df.add_argument("--min-delta", type=float, default=0.002, help="hide smaller share deltas")
    df.add_argument("--top", type=int, default=40, help="max rows")
    df.add_argument("--self-only", action="store_true", help="diff self shares instead of inclusive")
    df.add_argument("--html", default=None, metavar="FILE",
                    help="also write a share-delta diff flamegraph (red = b grew)")
    df.set_defaults(fn=cmd_diff)

    ck = sub.add_parser("check", help="gate a profile against a baseline (CI; exit 2 on regression)")
    ck.add_argument("profile", help="profile to check (out dir / timeline / tree.json / .snap)")
    ck.add_argument("--baseline", required=True, help="reference profile")
    ck.add_argument("--tolerance", type=float, default=0.05,
                    help="max allowed per-function share increase")
    ck.add_argument("--metric", default=None, help="default: samples (flops on --plane device)")
    ck.add_argument("--plane", default="host", choices=list(PLANES),
                    help="gate this plane (e.g. --plane merged --metric roofline_occupancy "
                         "to fail on device-plane share regressions)")
    ck.add_argument("--inclusive", action="store_true",
                    help="compare inclusive shares instead of self shares")
    ck.add_argument("--top", type=int, default=20, help="max regression rows printed")
    ck.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # `profilerd timeline ... | head` is routine; die quietly.  Point
        # stdout at devnull so the interpreter's shutdown flush of the
        # broken pipe can't raise a second traceback.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        rc = 0
    raise SystemExit(rc)
