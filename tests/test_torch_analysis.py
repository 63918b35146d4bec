"""The static plane of the port (``repro_torch.analysis``) held to the JAX
package's (``repro.analysis``).

Pure Python on both sides, so the tolerance is equality: the extractors
give the same tree, def sites and edge counts on both packages' trees and on
a synthetic one, and differ only in ``meta()["generator"]``; an artifact
written by either package loads in the other; the coverage reports agree on
the same inputs; the six lint passes the port carries unchanged give the JAX
package's findings, line for line, on both packages' fixtures and trees.
Then what is the port's own: ``scope-coverage`` for ``scope(...)`` ranges
and ``kernel_launch`` keys, the committed baseline and fixtures behind the
CLI's gates, and the plane wired through the profiles loader, the offline
server, ``export`` and a running daemon that picks the artifact up mid-run.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import repro.analysis as jax_analysis
import repro.analysis.coverage as jax_coverage
import repro.analysis.extract as jax_extract
import repro.analysis.lint as jax_lint
import repro.analysis.static_tree as jax_static
import repro.core.calltree as jax_calltree
import repro.profilerd.server as jax_server
import repro_torch.analysis as analysis
from repro_torch.analysis import coverage, extract, lint, static_tree
from repro_torch.analysis.baseline import EXIT_PASS, EXIT_REGRESSION, EXIT_UNREADABLE, check, load_baseline
from repro_torch.analysis.score import score_fixtures
from repro_torch.core.calltree import CallTree
from repro_torch.profilerd.__main__ import EXIT_NO_MATCH, main as profilerd_main
from repro_torch.profilerd.daemon import DaemonConfig, ProfilerDaemon
from repro_torch.profilerd.profiles import ProfileLoadError, load_static_plane, static_tree_path
from repro_torch.profilerd.server import OfflineSource, ProfileServer
from repro_torch.profilerd.spool import SpoolWriter
from repro_torch.profilerd.wire import Encoder, RawFrame, RawSample

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS_DIR), "src")
TREES = {"repro": os.path.join(SRC, "repro"), "repro_torch": os.path.join(SRC, "repro_torch")}
JAX_FIXTURES = os.path.join(TESTS_DIR, "data", "analysis_fixtures")
FIXTURES = os.path.join(TESTS_DIR, "data", "analysis_fixtures_torch")
BASELINE = os.path.join(TESTS_DIR, "data", "analysis_baseline_torch.json")
CARRIED = ("agent-hot-path", "wire-slots", "numpy-module-scope", "lock-io", "lock-order", "event-kinds")
KERNEL_KEYS = {"flash_attention", "flash_attention_bwd", "fused_rmsnorm", "fused_rmsnorm_bwd", "rglru_scan",
               "rglru_scan_bwd"}
# Public helpers of the port's kernels/ops.py that launch no kernel.
OPS_HELPERS = ("plain_versions", "launch_counts", "reset_launch_counts", "add_launches", "causal_pairs",
               "flash_work", "rmsnorm_work", "rglru_work")

# tests/test_analysis.py's synthetic package, copied.
SYNTH_PKG = {
    "alpha.py": (
        "def outer():\n"
        "    inner()\n"
        "    inner()\n"
        "    print('x')\n"
        "\n"
        "def inner():\n"
        "    return 1\n"
    ),
    "sub/beta.py": (
        "class Widget:\n"
        "    def render(self):\n"
        "        return self.helper()\n"
        "    def helper(self):\n"
        "        return 0\n"
    ),
}


def write_pkg(root, files: dict) -> str:
    for rel, src in files.items():
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as f:
            f.write(src)
    return str(root)


_INDEXES: dict = {}


def indexes(root: str):
    """(JAX's RepoIndex, the port's) over ``root``, parsed once per module."""
    if root not in _INDEXES:
        _INDEXES[root] = (jax_lint.RepoIndex.load(root), lint.RepoIndex.load(root))
    return _INDEXES[root]


def _http_get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _run(module: str, *argv: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", module, *argv], env=env, capture_output=True, text=True,
                          timeout=120)


# -- the extractor and its envelope ------------------------------------------


@pytest.mark.parametrize("which", ["repro", "repro_torch", "synthetic"])
def test_extractor_gives_the_jax_packages_tree(which, tmp_path):
    if which == "synthetic":
        root, package = write_pkg(tmp_path / "pkg", SYNTH_PKG), "pkg"
    else:
        root, package = TREES[which], which
    want = jax_extract.extract_static_graph(root, package=package)
    got = extract.extract_static_graph(root, package=package)
    assert got.tree.root.to_dict() == want.tree.root.to_dict()
    assert [(d.qualname, d.relpath, d.line) for d in got.defs] == [(d.qualname, d.relpath, d.line) for d in want.defs]
    assert [d.frames for d in got.defs] == [d.frames for d in want.defs]
    assert (got.n_modules, got.n_edges) == (want.n_modules, want.n_edges)
    assert got.meta() == {**want.meta(), "generator": "repro_torch.analysis.extract"}
    if which == "synthetic":
        assert got.n_modules == 2 and got.def_names == {"outer", "inner", "render", "helper"}


def test_extractor_defaults_to_the_port():
    g = extract.extract_static_graph(extract.default_package_root())
    assert os.path.samefile(extract.default_package_root(), TREES["repro_torch"])
    mods = {name for name in g.tree.root.children}
    assert "mod::repro_torch.analysis.extract" in mods and not any(m.startswith("mod::repro.") for m in mods)
    flat = g.tree.flatten(extract.DEFS)
    assert flat["repro::train_step"] >= 1.0 and flat["repro::_slstm"] >= 1.0
    assert extract.SYNTHETIC_NAMES == jax_extract.SYNTHETIC_NAMES


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_artifact_loads_in_both_packages(writer, tmp_path):
    root = write_pkg(tmp_path / "pkg", SYNTH_PKG)
    save, load, meta = {
        "port": (static_tree.save_static_tree, jax_static.load_static_tree, jax_static.static_meta),
        "jax": (jax_static.save_static_tree, static_tree.load_static_tree, static_tree.static_meta),
    }[writer]
    g = (extract if writer == "port" else jax_extract).extract_static_graph(root, package="pkg")
    p = str(tmp_path / static_tree.STATIC_TREE_FILENAME)
    save(g.tree, p, meta=g.meta())
    assert json.load(open(p))["schema"] == static_tree.STATIC_TREE_SCHEMA == jax_static.STATIC_TREE_SCHEMA
    assert load(p).root.to_dict() == g.tree.root.to_dict()
    assert meta(p) == g.meta()


def test_a_legacy_bare_root_loads(tmp_path):
    t = CallTree()
    t.add_stack(["mod::pkg.alpha", "repro::outer"], {"defs": 1.0, "samples": 1.0})
    p = tmp_path / "legacy.json"
    p.write_text(t.to_json())
    assert static_tree.load_static_tree(str(p)).flatten("defs")["repro::outer"] == 1.0
    assert static_tree.static_meta(str(p)) == {}


@pytest.mark.parametrize("body", [
    json.dumps({"schema": "bogus/v9", "root": {"name": "<root>"}}),
    "[1, 2]",
    json.dumps({"schema": "repro-static-tree/v1", "root": {}}),
    "{}",
], ids=["schema", "list", "rootless", "empty"])
def test_a_bad_document_raises_in_both_packages(body, tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(body)
    for load in (static_tree.load_static_tree, jax_static.load_static_tree):
        with pytest.raises(ValueError):
            load(str(p))


# -- coverage -----------------------------------------------------------------

COV_PKG = {
    "mod.py": (
        "def hot_fn():\n"
        "    return cold_fn\n"
        "\n"
        "def cold_fn():\n"
        "    return 0\n"
        "\n"
        "def warm_fn():\n"
        "    return hot_fn()\n"
    ),
}
COV_STACKS = (
    [["thread::MainThread", "repro::<module>", "repro::hot_fn"]] * 5
    + [["thread::MainThread", "repro::warm_fn"]] * 2
    + [["thread::MainThread", "repro::<lambda>"], ["thread::MainThread", "repro::*"],
       ["thread::MainThread", "py::hot_fn"]]
    + [["thread::worker", "repro::renamed_fn"]] * 3
)


@pytest.mark.parametrize("static_input", ["graph", "bare_tree"])
def test_coverage_report_is_the_jax_packages(static_input, tmp_path):
    root = write_pkg(tmp_path / "covpkg", COV_PKG)
    reports, folded, texts = {}, {}, {}
    for name, ex, cov, calltree in (("port", extract, coverage, CallTree),
                                    ("jax", jax_extract, jax_coverage, jax_calltree.CallTree)):
        g = ex.extract_static_graph(root, package="covpkg")
        dynamic = calltree()
        for stack in COV_STACKS:
            dynamic.add_stack(stack)
        reports[name] = cov.coverage_report(g if static_input == "graph" else g.tree, dynamic)
        folded[name] = sorted(cov.coverage_tree(reports[name]).to_json())
        texts[name] = cov.render_coverage(reports[name])
    assert reports["port"] == reports["jax"]
    assert folded["port"] == folded["jax"] and texts["port"] == texts["jax"]
    r = reports["port"]
    assert r["schema"] == "repro-coverage-report/v1"
    assert [e["name"] for e in r["cold"]] == ["cold_fn"]
    assert {e["name"]: e["mass"] for e in r["hot"]} == {"hot_fn": 5.0, "warm_fn": 2.0}
    assert r["drift"] == [{"name": "renamed_fn", "mass": 3.0}]  # <module>, <lambda>, * and py:: never drift


# -- lint: the six carried passes ----------------------------------------------


def test_pass_registry_is_the_jax_packages_order():
    assert lint.PASS_IDS == jax_lint.PASS_IDS
    assert lint.PASS_IDS[:6] == CARRIED and lint.PASS_IDS[6] == "scope-coverage"
    assert lint.HOT_PATH_BANNED == jax_lint.HOT_PATH_BANNED and lint.LOCK_IO_BANNED == jax_lint.LOCK_IO_BANNED
    assert lint.NUMPY_OPTIONAL_MODULES == jax_lint.NUMPY_OPTIONAL_MODULES
    assert sorted(analysis.__all__) == sorted(jax_analysis.__all__)
    for name in analysis.__all__:
        assert getattr(analysis, name) is not None


@pytest.mark.parametrize("root", ["jax_fixture", "port_fixture", "repro", "repro_torch"])
@pytest.mark.parametrize("pass_id", CARRIED)
def test_a_carried_pass_gives_the_jax_packages_findings(pass_id, root):
    path = {"jax_fixture": os.path.join(JAX_FIXTURES, pass_id), "port_fixture": os.path.join(FIXTURES, pass_id),
            **TREES}[root]
    jax_index, port_index = indexes(path)
    want = [(f.key(), f.line, f.message) for f in jax_lint.run_passes(jax_index, only=pass_id)]
    got = [(f.key(), f.line, f.message) for f in lint.run_passes(port_index, only=pass_id)]
    if pass_id == "event-kinds":  # the message names each package's table
        got = [(k, line, m.replace("repro_torch.profilerd.events", "repro.profilerd.events")) for k, line, m in got]
    assert got == want
    assert bool(got) == root.endswith("fixture")


# -- lint: the port's scope-coverage ------------------------------------------

OPS_WRAPPED = (
    "from repro_torch.core.scope import kernel_launch, scope\n\n\n"
    "def rglru_scan(a):\n    with scope('rglru_scan'):\n        return _fwd(a)\n\n\n"
    "def _fwd(a):\n    with kernel_launch('rglru_scan', lambda: (0.0, 0.0)):\n        return a\n"
)
SCOPE_CASES = {
    "key_without_wrapper": (
        {"kernels/ops.py": OPS_WRAPPED + "\n\ndef _bwd(a):\n    with kernel_launch('rglru_scan_bwd', None):\n"
                                          "        return a\n"},
        [("kernels/ops.py", "rglru_scan_bwd", 15)],
    ),
    "wrapper_without_scope": (
        {"kernels/ops.py": OPS_WRAPPED.replace("    with scope('rglru_scan'):\n        return _fwd(a)",
                                               "    return _fwd(a)")},
        [("kernels/ops.py", "rglru_scan", 4)],
    ),
    "private_wrapper": (
        {"kernels/ops.py": OPS_WRAPPED.replace("def rglru_scan(", "def _rglru_scan(")},
        [("kernels/ops.py", "rglru_scan", 10)],
    ),
    "forward_without_scope": (
        {"models/toy.py": "from repro_torch.core.scope import scope as _scope\n\n\n"
                          "def block(x, *, scope='block'):\n    return x\n\n\n"
                          "def covered(x, *, scope='covered'):\n    with _scope(scope):\n        return x\n"},
        [("models/toy.py", "block", 4)],
    ),
    "forward_that_forwards_scope": (
        {"models/toy.py": "def step(x, *, scope='step'):\n    return block(x, scope=scope)\n"},
        [],
    ),
    "wrapped_kernel_and_a_helper": (
        {"kernels/ops.py": OPS_WRAPPED + "\n\ndef launch_counts():\n    return {}\n"},
        [],
    ),
}


@pytest.mark.parametrize("case", list(SCOPE_CASES))
def test_scope_coverage_reads_the_ports_ranges(case, tmp_path):
    files, want = SCOPE_CASES[case]
    index = lint.RepoIndex.load(write_pkg(tmp_path / "pkg", files))
    got = [(f.path, f.symbol, f.line) for f in lint.run_passes(index, only="scope-coverage")]
    assert got == want


def test_scope_coverage_fixture_flags_its_seeded_sites_only():
    index = lint.RepoIndex.load(os.path.join(FIXTURES, "scope-coverage"))
    got = {(f.path, f.symbol) for f in lint.run_passes(index, only="scope-coverage")}
    assert got == {("kernels/ops.py", "fused_rmsnorm"), ("kernels/ops.py", "orphan_scan"),
                   ("models/toy.py", "forward")}


def test_the_ports_tree_is_clean_and_its_kernels_are_all_wrapped():
    _, index = indexes(TREES["repro_torch"])
    assert lint.run_passes(index) == []
    ((_, ops),) = index.matching("kernels/ops.py")
    assert set(lint._launched_keys(ops)) == KERNEL_KEYS
    public = {fn.name for fn in lint._top_level_functions(ops) if not fn.name.startswith("_")}
    assert set(OPS_HELPERS) <= public and KERNEL_KEYS <= public
    # the JAX package's pass, blind to scope(...), flags the port's wrappers and forwards
    jax_flagged = {f.symbol for f in jax_lint.run_passes(indexes(TREES["repro_torch"])[0], only="scope-coverage")}
    assert set(OPS_HELPERS) | KERNEL_KEYS <= jax_flagged


# -- the gates ------------------------------------------------------------------


def test_the_committed_baseline_is_empty_and_passes():
    assert load_baseline(BASELINE) == frozenset()
    assert json.load(open(BASELINE))["root"] == "repro_torch"
    code, report = check(TREES["repro_torch"], BASELINE)
    assert code == EXIT_PASS and report.endswith("PASS"), report


def test_the_fixtures_score_one_for_every_pass():
    score = score_fixtures(FIXTURES, TREES["repro_torch"])
    assert score["ok"], json.dumps(score, indent=2)
    assert list(score["passes"]) == list(lint.PASS_IDS)
    for pid, row in score["passes"].items():
        assert (row["recall"], row["precision"], row["clean_findings"]) == (1.0, 1.0, 0), (pid, row)


@pytest.mark.parametrize("case", ["clean", "fixture", "missing_baseline", "empty_root"])
def test_check_cli_exit_codes(case, tmp_path):
    root, baseline, want = {
        "clean": (TREES["repro_torch"], BASELINE, EXIT_PASS),
        "fixture": (os.path.join(FIXTURES, "scope-coverage"), BASELINE, EXIT_REGRESSION),
        "missing_baseline": (TREES["repro_torch"], str(tmp_path / "missing.json"), EXIT_UNREADABLE),
        "empty_root": (str(tmp_path), BASELINE, EXIT_UNREADABLE),
    }[case]
    r = _run("repro_torch.analysis", "check", "--root", root, "--baseline", baseline)
    assert r.returncode == want, (r.stdout, r.stderr)


def test_fixtures_and_lint_cli():
    r = _run("repro_torch.analysis", "fixtures", "--dir", FIXTURES, "--json")
    assert r.returncode == 0, (r.stdout, r.stderr)
    score = json.loads(r.stdout)
    assert score["ok"] and score["clean_root"] == "repro_torch"
    assert {pid: (row["recall"], row["precision"]) for pid, row in score["passes"].items()} == {
        pid: (1.0, 1.0) for pid in lint.PASS_IDS}
    r = _run("repro_torch.analysis", "lint")
    assert r.returncode == 0 and "0 finding(s)" in r.stdout, (r.stdout, r.stderr)
    r = _run("repro_torch.analysis", "lint", "--root", os.path.join(FIXTURES, "lock-io"), "--json")
    assert r.returncode == EXIT_REGRESSION and {f["pass_id"] for f in json.loads(r.stdout)} == {"lock-io"}


# -- the plane wired through -----------------------------------------------------


@pytest.fixture
def profile(tmp_path):
    """A host profile dir with the port's static tree of SYNTH_PKG beside it,
    extracted through the CLI into the dir."""
    d = tmp_path / "prof"
    d.mkdir()
    host = CallTree()
    host.add_stack(["thread::MainThread", "repro::outer"])
    (d / "tree.json").write_text(host.to_json())
    root = write_pkg(tmp_path / "pkg", SYNTH_PKG)
    r = _run("repro_torch.analysis", "extract", "--root", root, "--package", "pkg", "--out", str(d))
    assert r.returncode == 0 and "2 modules, 4 defs" in r.stdout, (r.stdout, r.stderr)
    return d


def test_profiles_loader_reads_the_artifact(profile):
    assert static_tree_path(str(profile), "t0") == str(profile / "static_tree.json")
    tree = load_static_plane(str(profile))
    assert tree.flatten("defs")["mod::pkg.sub.beta"] == 2.0
    assert static_tree.static_meta(str(profile / "static_tree.json"))["generator"] == "repro_torch.analysis.extract"
    (profile / "static_tree.json").write_text("{}")
    with pytest.raises(ProfileLoadError, match="unreadable static tree"):
        load_static_plane(str(profile))


def test_offline_servers_of_both_packages_answer_the_static_plane_alike(profile):
    servers = {"port": ProfileServer(OfflineSource(str(profile))).start(),
               "jax": jax_server.ProfileServer(jax_server.OfflineSource(str(profile))).start()}
    try:
        got = {}
        for q in ("/tree?plane=static&fmt=folded", "/tree?plane=static&fmt=json", "/tree?plane=static&fmt=html",
                  "/tree?plane=static", f"/diff?plane=static&baseline={profile}&metric=defs"):
            got = {name: _http_get(s.url + q) for name, s in servers.items()}
            assert got["port"][0] == 200, (q, got["port"])
            if "html" not in q:
                assert got["port"] == got["jax"], q
        folded = _http_get(servers["port"].url + "/tree?plane=static&fmt=folded")[1]
        assert "mod::pkg.alpha;repro::outer" in folded
        assert "static plane" in _http_get(servers["port"].url + "/tree?plane=static&fmt=html")[1]
    finally:
        for s in servers.values():
            s.stop()


def test_a_missing_artifact_is_404_naming_the_ports_extractor(profile):
    (profile / "static_tree.json").unlink()
    server = ProfileServer(OfflineSource(str(profile))).start()
    try:
        code, body = _http_get(server.url + "/tree?plane=static")
        assert code == 404 and "static_tree.json" in body and "python -m repro_torch.analysis extract" in body
    finally:
        server.stop()
    assert profilerd_main(["export", str(profile), "--plane", "static"]) == EXIT_NO_MATCH


def test_export_static_plane_round_trips(profile, tmp_path):
    out = tmp_path / "static.json"
    assert profilerd_main(["export", str(profile), "--plane", "static", "--fmt", "json", "--out", str(out)]) == 0
    assert CallTree.from_json(out.read_text()).root.to_dict() == load_static_plane(str(profile)).root.to_dict()


def test_coverage_cli_joins_a_profile_with_its_artifact_or_a_live_extract(profile, tmp_path):
    r = _run("repro_torch.analysis", "coverage", "--profile", str(profile), "--json")
    assert r.returncode == 0, (r.stdout, r.stderr)
    report = json.loads(r.stdout)
    assert report["defs"] == 4 and [e["name"] for e in report["hot"]] == ["outer"]
    (profile / "static_tree.json").unlink()  # no artifact: the port is extracted live
    r = _run("repro_torch.analysis", "coverage", "--profile", str(profile), "--json",
             "--tree", str(tmp_path / "cov.json"))
    assert r.returncode == 0, (r.stdout, r.stderr)
    live = json.loads(r.stdout)
    # the port defines no ``outer``: the profile's one frame is drift against it
    assert live["defs"] > 500 and live["covered"] == 0 and live["drift"] == [{"name": "outer", "mass": 1.0}]
    assert "coverage::drift" in (tmp_path / "cov.json").read_text()


# -- the daemon picks the artifact up mid-run --------------------------------------


def _wait(pred, desc: str, timeout_s: float = 15.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {desc}")
        time.sleep(0.01)


class _Target:
    """A spool publisher whose every sample is ``main -> step``."""

    def __init__(self, path):
        self.writer = SpoolWriter(str(path), capacity=1 << 20)
        self.enc = Encoder()
        self.n = 0
        self.writer.write(self.enc.encode_hello(os.getpid(), 0.01))

    def emit(self, k: int):
        frames = [RawFrame("/fake/app.py", "main", 1), RawFrame("/fake/app.py", "step", 2)]
        for _ in range(k):
            payload, _fresh = self.enc.encode_tick([RawSample(self.n * 0.01, 1, "w", frames)])
            assert self.writer.write(payload)
            self.n += 1
        return self

    def bye(self):
        self.writer.write_bye(self.enc.encode_bye(self.n))
        self.writer.close()


def _daemon(tmp_path):
    spool, out = tmp_path / "job.spool", tmp_path / "out"
    target = _Target(spool).emit(3)
    daemon = ProfilerDaemon(DaemonConfig(spool_path=str(spool), out_dir=str(out), publish_interval_s=0.05,
                                         drain_interval_s=0.01, epoch_s=0.1, max_seconds=30, serve_port=0))
    th = threading.Thread(target=daemon.run, daemon=True)
    th.start()
    _wait(lambda: (out / "status.json").exists() and daemon.server is not None, "the first publish")
    return daemon, th, target, out


def _status(out) -> dict:
    return json.loads((out / "status.json").read_text())


def test_daemon_picks_up_a_static_tree_dropped_mid_run(tmp_path):
    daemon, th, target, out = _daemon(tmp_path)
    try:
        assert _status(out)["static_plane"] is False
        assert _http_get(daemon.server.url + "/tree?plane=static")[0] == 404
        graph = extract.extract_to_file(str(out / "static_tree.json"),
                                        root=write_pkg(tmp_path / "pkg", SYNTH_PKG), package="pkg")
        _wait(lambda: _status(out)["static_plane"], "static_plane in status.json")
        loaded = [e for e in daemon.events if e["kind"] == "STATIC_TREE_LOADED"]
        assert len(loaded) == 1 and loaded[0]["call_sites"] == graph.tree.node_count()
        code, folded = _http_get(daemon.server.url + "/tree?plane=static&fmt=folded")
        assert code == 200 and "mod::pkg.alpha;repro::outer" in folded
        target.emit(2).bye()
        th.join(timeout=20)
        assert not th.is_alive()
    finally:
        daemon.request_stop()
        th.join(timeout=20)
    assert _status(out)["static_plane"] is True
    assert sum(e["kind"] == "STATIC_TREE_LOADED" for e in daemon.events) == 1


def test_daemon_records_an_unreadable_static_tree_once(tmp_path):
    daemon, th, target, out = _daemon(tmp_path)
    try:
        (out / "static_tree.json").write_text("{}")
        _wait(lambda: any(e["kind"] == "STATIC_TREE_UNREADABLE" for e in daemon.events), "STATIC_TREE_UNREADABLE")
        time.sleep(0.3)  # six more publish windows, each probing the artifact again
        assert sum(e["kind"] == "STATIC_TREE_UNREADABLE" for e in daemon.events) == 1
        assert _status(out)["static_plane"] is False
        code, body = _http_get(daemon.server.url + "/tree?plane=static")
        assert code == 404 and "repro_torch.analysis extract" in body
        target.emit(1).bye()
        th.join(timeout=20)
        assert not th.is_alive()
    finally:
        daemon.request_stop()
        th.join(timeout=20)
    events = [json.loads(x) for x in (out / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events].count("STATIC_TREE_UNREADABLE") == 1
