"""CLI for the static-analysis plane: ``python -m repro_torch.analysis <cmd>``,
the JAX package's commands over the port's tree.

Commands::

    extract   build static_tree.json (the /tree?plane=static artifact)
    lint      run the repro-lint passes and print findings
    check     gate findings against a committed baseline (CI entrypoint)
    coverage  cross-join a static tree with a sampled profile
    fixtures  score every pass against its seeded-violation fixture

Exit codes follow the ``profilerd check`` contract: 0 pass, 2 regression /
findings, 3 unreadable input.  Everything here is pure stdlib (plus the
port's own core modules) so CI runs it without torch or numpy.

A static tree dropped into a running daemon's out dir is picked up within
one publish window: ``extract --out <daemon out dir>`` while it runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .baseline import EXIT_PASS, EXIT_REGRESSION, EXIT_UNREADABLE, check
from .coverage import coverage_report, coverage_tree, render_coverage
from .extract import default_package_root, extract_to_file
from .lint import PASS_IDS, RepoIndex, run_passes
from .score import render_score, score_fixtures
from .static_tree import STATIC_TREE_FILENAME


def _root_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--root",
        default=None,
        help="package source root to analyze (default: the installed repro_torch package)",
    )


def cmd_extract(args) -> int:
    out = args.out
    if os.path.isdir(out):
        out = os.path.join(out, STATIC_TREE_FILENAME)
    try:
        graph = extract_to_file(out, root=args.root, package=args.package)
    except (OSError, SyntaxError) as e:
        print(f"UNREADABLE: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    print(
        f"static tree: {graph.n_modules} modules, {len(graph.defs)} defs, "
        f"{graph.n_edges} resolved call edges -> {out}"
    )
    return EXIT_PASS


def cmd_lint(args) -> int:
    root = args.root or default_package_root()
    try:
        index = RepoIndex.load(root)
        if not index.files:
            raise OSError(f"{root}: no python files to analyze")
        findings = run_passes(index, only=getattr(args, "pass_id", None))
    except (OSError, SyntaxError, ValueError) as e:
        print(f"UNREADABLE: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s) across {len(index.files)} files")
    return EXIT_REGRESSION if findings else EXIT_PASS


def cmd_check(args) -> int:
    root = args.root or default_package_root()
    code, report = check(root, args.baseline, update=args.update)
    print(report)
    return code


def cmd_coverage(args) -> int:
    from repro_torch.profilerd.profiles import ProfileLoadError, load_profile, load_static_plane

    try:
        dynamic = load_profile(args.profile)
    except ProfileLoadError as e:
        print(f"UNREADABLE: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    static = None
    if args.static:
        from .static_tree import load_static_tree

        try:
            static = load_static_tree(args.static)
        except (OSError, ValueError) as e:
            print(f"UNREADABLE: {e}", file=sys.stderr)
            return EXIT_UNREADABLE
    else:
        try:
            static = load_static_plane(args.profile)
        except ProfileLoadError as e:
            print(f"UNREADABLE: {e}", file=sys.stderr)
            return EXIT_UNREADABLE
        if static is None:
            # No artifact beside the profile: extract the installed package
            # live so `coverage` works out of the box on any profile.
            from .extract import extract_static_graph

            static = extract_static_graph(default_package_root())
    report = coverage_report(static, dynamic, metric=args.metric)
    if args.tree:
        out = args.tree
        if os.path.isdir(out):
            out = os.path.join(out, "coverage_tree.json")
        with open(out, "w") as f:
            f.write(coverage_tree(report).to_json())
        print(f"coverage tree -> {out}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_coverage(report, limit=args.limit))
    return EXIT_PASS


def cmd_fixtures(args) -> int:
    clean_root = args.root or default_package_root()
    try:
        score = score_fixtures(args.dir, clean_root)
    except (OSError, SyntaxError) as e:
        print(f"UNREADABLE: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    if args.json:
        print(json.dumps(score, indent=2))
    else:
        print(render_score(score))
    return EXIT_PASS if score["ok"] else EXIT_REGRESSION


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static call-graph plane + repro-lint invariant checks",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extract", help="emit the static_tree.json plane artifact")
    _root_arg(p)
    p.add_argument("--package", default="repro_torch", help="package name prefix for module nodes")
    p.add_argument("--out", required=True, help="output file, or a profile dir to drop the artifact into")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("lint", help="run the invariant passes and print findings")
    _root_arg(p)
    p.add_argument("--pass", dest="pass_id", choices=list(PASS_IDS), help="run a single pass")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("check", help="gate findings against a committed baseline")
    _root_arg(p)
    p.add_argument("--baseline", required=True, help="baseline JSON path")
    p.add_argument("--update", action="store_true", help="accept current findings as the new baseline")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("coverage", help="cross-join static defs with a sampled profile")
    p.add_argument("--profile", required=True, help="profile artifact (dir, tree.json, or .snap)")
    p.add_argument("--static", default=None, help="static_tree.json (default: beside the profile, else live extract)")
    p.add_argument("--metric", default="samples")
    p.add_argument("--limit", type=int, default=20)
    p.add_argument("--json", action="store_true")
    p.add_argument("--tree", default=None, help="also write the report as a tree.json for the exporters")
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser("fixtures", help="score each pass against its seeded-violation fixture")
    _root_arg(p)
    p.add_argument("--dir", required=True, help="fixtures dir (one subdir per pass id)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_fixtures)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
