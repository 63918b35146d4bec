"""Export-layer + query-plane tests.

The invariants:

* folded roundtrip — fold -> re-ingest yields a tree with identical inclusive
  metrics at every node (and therefore identical shares);
* speedscope — frame/event invariants of the file-format schema shape;
* diff export — sign conventions: positive share delta == candidate grew;
* HTML — one self-contained file: no external (http/https) references, names
  escaped, the embedded data island survives hostile frame names;
* server — /status /tree /timeline /diff answer against both a live daemon
  and an offline artifact dir, with bounded responses and sane error codes;
* CLI — export/no-match exit codes, top --once, diff --html.

The tests of ``tests/test_export.py`` pointed at the port, then the port
held to the JAX package exactly (the parity section at the end).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.core import CallTree
from repro_torch.core.export import (
    DIFF_SHARE_DELTA,
    EXPORT_FORMATS,
    build_diff_tree,
    diff_flamegraph_html,
    export_tree,
    flamegraph_html,
    from_folded,
    iter_folded,
    to_folded,
    to_speedscope,
)
from repro_torch.core.report import ViewConfig, save_views
from repro_torch.core.snapshot import EpochSealer, TimelineWriter, save_snapshot
from repro_torch.core.views_library import export_view
from repro_torch.profilerd.__main__ import EXIT_NO_MATCH, EXIT_UNREADABLE, main
from repro_torch.profilerd.server import OfflineSource, ProfileServer, render_top


def sample_tree():
    t = CallTree()
    for _ in range(6):
        t.add_stack(["serve_step", "model", "attention", "scores"])
    for _ in range(3):
        t.add_stack(["serve_step", "model", "mlp", "gate_proj"])
    t.add_stack(["serve_step", "sampler", "top_p"])
    for _ in range(2):
        t.add_stack(["data", "pipeline", "next_batch"])
    return t


def device_tree():
    """Metrics-dict plane: inclusive values not expressible as leaf counts."""
    t = CallTree()
    t.add_stack(["model", "attention", "scores"], {"flops": 100.0, "bytes": 7.0})
    t.add_stack(["model", "attention"], {"flops": 20.0})
    t.add_stack(["model", "mlp"], {"flops": 300.0})
    return t


def profile_dir(tmp_path, tree=None, epochs=3):
    """A daemon-out-dir-shaped artifact: tree.json + sealed timeline ring."""
    d = str(tmp_path)
    t = CallTree()
    writer = TimelineWriter(os.path.join(d, "timeline"), epochs_per_segment=4)
    sealer = EpochSealer(t, writer)
    for epoch in range(epochs):
        for _ in range(10):
            for stack, n in [
                (["thread::Main", "serve_step", "model", "attention"], 3.0),
                (["thread::Main", "serve_step", "sampler"], 1.0),
            ]:
                chain = t.path_nodes(stack)
                CallTree.add_stack_nodes(chain, n)
        sealer.seal(wall_time=float(epoch))
    writer.close()
    with open(os.path.join(d, "tree.json"), "w") as f:
        f.write(t.to_json())
    return d, t


class TestFoldedRoundtrip:
    def test_fold_reingest_is_exact(self):
        t = sample_tree()
        t2 = from_folded(to_folded(t))
        assert t2.root == t.root  # identical inclusive + self metrics everywhere
        assert t2.shares() == t.shares()

    def test_device_plane_residuals_roundtrip_inclusive_metrics(self):
        t = device_tree()
        t2 = from_folded(to_folded(t, metric="flops"), metric="flops")
        for path, node in t.root.walk():
            n2 = t2.root
            for name in path[1:]:
                n2 = n2.children[name]
            assert n2.metrics.get("flops", 0.0) == pytest.approx(node.metrics.get("flops", 0.0))

    def test_folded_lines_are_sorted_and_parseable(self):
        lines = to_folded(sample_tree()).splitlines()
        assert lines == sorted(lines)
        for line in lines:
            stack, _, v = line.rpartition(" ")
            float(v)
            assert stack

    def test_windowed_delta_trees_fold_with_negatives(self):
        a = sample_tree()
        b = a.copy()
        b.add_stack(["serve_step", "sampler", "top_p"])
        delta = a.diff(b)  # a minus b => the extra sample shows as -1
        folded = to_folded(delta)
        assert any(v < 0 for _p, v in iter_folded(delta))
        t2 = from_folded(folded)
        assert t2.root.children["serve_step"].metrics["samples"] == -1.0

    def test_comment_and_blank_lines_ignored(self):
        t = from_folded("# header\n\na;b 2\n")
        assert t.total() == 2.0

    def test_hostile_frame_names_roundtrip(self):
        # ';' is the folded separator, '#' starts a comment line, '\n' ends a
        # record: frame names containing any of them must survive the fold.
        t = CallTree()
        t.add_stack(["a;b", "with\nnewline"], {"samples": 2.0})
        t.add_stack(["#looks_like_comment", "leaf"], {"samples": 1.0})
        t.add_stack(["back\\slash"], {"samples": 1.0})
        t.add_stack([" leading_space", "x"], {"samples": 1.0})
        t.add_stack(["<root>"], {"samples": 1.0})  # collides with the root token
        t.add_stack(["cr\rlf", "v\x0bt sep"], {"samples": 1.0})  # splitlines() bait
        t.add_stack([""], {"samples": 5.0})  # empty frame name
        t2 = from_folded(to_folded(t))
        assert t2.root == t.root
        assert "a;b" in t2.root.children and "#looks_like_comment" in t2.root.children
        assert " leading_space" in t2.root.children and "<root>" in t2.root.children
        assert "cr\rlf" in t2.root.children

    def test_root_residual_mass_is_not_dropped(self):
        # Samples ingested with an empty stack land on the synthetic root;
        # the fold must carry that mass or totals silently shrink.
        t = CallTree()
        t.add_stack([], {"flops": 5.0})
        t.add_stack(["a"], {"flops": 1.0})
        t2 = from_folded(to_folded(t, metric="flops"), metric="flops")
        assert t2.total("flops") == 6.0
        assert t2.root == t.root

    def test_full_float_precision_roundtrips(self):
        # Values needing >12 significant digits (the old %.12g formatting
        # truncated these) and classic non-representable sums must survive
        # the text roundtrip bit-for-bit.
        t = CallTree()
        t.add_stack(["model", "mlp"], {"flops": 123456789.0123456})
        t.add_stack(["data", "pipeline"], {"flops": 0.1 + 0.2})
        t2 = from_folded(to_folded(t, metric="flops"), metric="flops")
        assert t2.root == t.root  # bit-exact, not N-significant-digits


class TestSpeedscope:
    def test_schema_shape_invariants(self):
        ss = to_speedscope(sample_tree(), name="unit")
        assert ss["$schema"].endswith("file-format-schema.json")
        assert ss["activeProfileIndex"] == 0
        frames = ss["shared"]["frames"]
        assert frames and all(isinstance(f["name"], str) for f in frames)
        (prof,) = ss["profiles"]
        assert prof["type"] == "sampled" and prof["name"] == "unit"
        assert len(prof["samples"]) == len(prof["weights"])
        assert all(w > 0 for w in prof["weights"])
        assert prof["startValue"] == 0.0
        assert sum(prof["weights"]) == pytest.approx(prof["endValue"])
        nf = len(frames)
        assert all(0 <= i < nf for stack in prof["samples"] for i in stack)

    def test_weights_total_matches_tree_total(self):
        t = sample_tree()
        ss = to_speedscope(t)
        assert ss["profiles"][0]["endValue"] == pytest.approx(t.total())

    def test_json_serializable(self):
        json.dumps(to_speedscope(sample_tree()))


class TestDiffExport:
    def baseline_and_candidate(self):
        base = sample_tree()
        cand = sample_tree()
        for _ in range(6):
            cand.add_stack(["serve_step", "spin_retry_loop"])
        return base, cand

    def test_sign_convention_positive_means_candidate_grew(self):
        base, cand = self.baseline_and_candidate()
        diff = build_diff_tree(base, cand)
        spin = diff.root.children["serve_step"].children["spin_retry_loop"]
        assert spin.metrics[DIFF_SHARE_DELTA] > 0  # regression: red
        model = diff.root.children["serve_step"].children["model"]
        assert model.metrics[DIFF_SHARE_DELTA] < 0  # relative improvement: blue

    def test_share_deltas_are_run_length_invariant(self):
        base, cand = self.baseline_and_candidate()
        twice = CallTree().merge(cand).merge(cand)  # same shape, double the mass
        d1 = build_diff_tree(base, cand)
        d2 = build_diff_tree(base, twice)
        n1 = d1.root.children["serve_step"].children["spin_retry_loop"]
        n2 = d2.root.children["serve_step"].children["spin_retry_loop"]
        assert n1.metrics[DIFF_SHARE_DELTA] == pytest.approx(n2.metrics[DIFF_SHARE_DELTA])

    def test_baseline_only_nodes_survive_in_the_union(self):
        base, cand = self.baseline_and_candidate()
        base.add_stack(["serve_step", "legacy_path"])
        diff = build_diff_tree(base, cand)
        legacy = diff.root.children["serve_step"].children["legacy_path"]
        assert legacy.metrics["baseline"] == 1.0 and legacy.metrics["samples"] == 0.0
        assert legacy.metrics[DIFF_SHARE_DELTA] < 0

    def test_diff_flamegraph_html_is_self_contained_and_marked(self):
        base, cand = self.baseline_and_candidate()
        html = diff_flamegraph_html(base, cand)
        assert "http://" not in html and "https://" not in html
        data = json.loads(html.split('id="fgdata" type="application/json">')[1].split("</script>")[0])
        assert data["diff"] is True
        step = next(c for c in data["c"] if c["n"] == "serve_step")
        spin = next(c for c in step["c"] if c["n"] == "spin_retry_loop")
        assert spin["d"] > 0 and spin["b"] == 0


class TestFlamegraphHtml:
    def test_single_self_contained_file(self):
        html = flamegraph_html(sample_tree(), title="t")
        assert html.startswith("<!DOCTYPE html>")
        assert "http://" not in html and "https://" not in html
        assert "function" in html and "zoom" in html  # interactive, not static

    def test_hostile_frame_names_cannot_break_the_data_island(self):
        t = CallTree()
        t.add_stack(["<module>", "</script><script>alert(1)</script>"])
        html = flamegraph_html(t)
        blob = html.split('id="fgdata" type="application/json">')[1].split("</script>")[0]
        data = json.loads(blob)  # the first real </script> is the island's own close tag
        assert data["c"][0]["n"] == "<module>"
        assert data["c"][0]["c"][0]["n"] == "</script><script>alert(1)</script>"

    def test_title_and_metric_escaped(self):
        html = flamegraph_html(sample_tree(), title="<b>x</b>", metric="samples")
        assert "<b>x</b>" not in html and "&lt;b&gt;x&lt;/b&gt;" in html


class TestExportRouter:
    def test_every_format_renders(self):
        t = sample_tree()
        for fmt in EXPORT_FORMATS:
            out = export_tree(t, fmt)
            assert isinstance(out, str) and out

    def test_view_routing_applies_zoom(self):
        folded = export_tree(sample_tree(), "folded", view=ViewConfig(name="v", root="model"))
        assert folded and all(line.startswith("model") for line in folded.splitlines())

    def test_min_share_honored_by_non_csv_formats(self):
        # min_share is the advertised way to shrink an oversized response;
        # it must prune folded/speedscope/html too, not only to_csv rows.
        view = ViewConfig(name="v", min_share=0.5)
        folded = export_tree(sample_tree(), "folded", view=view)
        assert "scores" in folded  # 6/12 of total keeps the hot stack
        assert "top_p" not in folded and "next_batch" not in folded
        ss = json.loads(export_tree(sample_tree(), "speedscope", view=view))
        names = {f["name"] for f in ss["shared"]["frames"]}
        assert "top_p" not in names

    def test_library_views_export_uniformly(self):
        t = sample_tree()
        for fmt in ("folded", "speedscope", "html"):
            assert export_view(t, "top_level", fmt)

    def test_unknown_format_and_view_raise(self):
        with pytest.raises(ValueError):
            export_tree(sample_tree(), "gif")
        with pytest.raises(KeyError):
            export_tree(sample_tree(), "csv", view="not_a_view")

    def test_save_views_multi_format(self, tmp_path):
        written = save_views(
            sample_tree(), [ViewConfig(name="all")], str(tmp_path), formats=("csv", "folded", "html")
        )
        assert {os.path.basename(p) for p in written} == {"all.csv", "all.folded", "all.html"}
        for p in written:
            assert os.path.getsize(p) > 0
        html = open([p for p in written if p.endswith(".html")][0]).read()
        assert "all [all]" not in html  # view name not duplicated in the title

    def test_save_views_empty_view_writes_marker_not_empty_file(self, tmp_path):
        written = save_views(
            sample_tree(), [ViewConfig(name="ghost", root="typo")], str(tmp_path),
            formats=("csv", "folded"),
        )
        for p in written:
            body = open(p).read()
            assert "# no match for root=typo" in body, p  # never a vacuous empty file


@pytest.fixture
def offline_server(tmp_path):
    d, tree = profile_dir(tmp_path)
    server = ProfileServer(OfflineSource(d), port=0).start()
    yield server, d, tree
    server.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


class TestServerOffline:
    def test_status_tree_timeline_diff(self, offline_server, tmp_path):
        server, d, tree = offline_server
        code, body = _get(server.url + "/status")
        status = json.loads(body)
        assert code == 200 and status["offline"] and status["hot_paths"]

        for fmt in EXPORT_FORMATS:
            code, body = _get(server.url + f"/tree?fmt={fmt}")
            assert code == 200 and body, fmt
        code, folded = _get(server.url + "/tree?fmt=folded")
        assert from_folded(folded).total() == pytest.approx(tree.total())
        code, ss = _get(server.url + "/tree?fmt=speedscope")
        prof = json.loads(ss)["profiles"][0]
        assert len(prof["samples"]) == len(prof["weights"]) > 0

        code, body = _get(server.url + "/timeline")
        assert code == 200 and "epoch" in body
        code, body = _get(server.url + "/timeline?fmt=json")
        epochs = json.loads(body)
        assert epochs[0]["epoch"] == 0 and epochs[0]["window_total"] > 0

        snap = str(tmp_path / "base.snap")
        save_snapshot(tree, snap)
        code, body = _get(server.url + f"/diff?baseline={snap}")
        assert code == 200 and body.startswith("# diff")
        code, body = _get(server.url + f"/diff?baseline={snap}&fmt=html")
        assert code == 200 and "fgdata" in body

    def test_view_and_adhoc_params(self, offline_server):
        server, _d, _t = offline_server
        code, body = _get(server.url + "/tree?view=host_threads")
        assert code == 200 and body.startswith("# view=host_threads")
        code, body = _get(server.url + "/tree?root=attention&fmt=folded")
        assert code == 200 and body.startswith("attention")

    def test_adhoc_params_refine_a_named_view(self, offline_server):
        # level=/min_share= are the advertised 413 remedies; they must
        # compose with view= instead of being silently dropped.
        server, _d, _t = offline_server
        _code, folded1 = _get(server.url + "/tree?view=host_threads&fmt=folded")
        _code, deep = _get(server.url + "/tree?view=host_threads&fmt=folded&level=-1")
        assert len(deep) > len(folded1)  # level=1 fold replaced by full stacks
        _code, pruned = _get(
            server.url + "/tree?view=host_threads&fmt=folded&level=-1&min_share=0.5"
        )
        assert "sampler" in deep and "sampler" not in pruned  # 25% share pruned
        assert len(pruned) < len(deep)

    def test_no_match_view_is_404_for_stack_formats_not_empty_200(self, offline_server):
        server, _d, _t = offline_server
        for q in ("/tree?root=typo&fmt=folded", "/tree?root=typo&fmt=speedscope",
                  "/tree?root=typo&fmt=html", "/tree?level=0&fmt=folded",
                  "/tree?min_share=1.5&fmt=folded"):  # min_share prunes everything
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + q)
            assert e.value.code == 404, q
        # csv still answers 200 with its own marker rows
        code, body = _get(server.url + "/tree?root=typo&fmt=csv")
        assert code == 200 and "# no match for root=typo" in body
        code, body = _get(server.url + "/tree?min_share=1.5&fmt=csv")
        assert code == 200 and "min_share" in body and "pruned every row" in body

    def test_error_codes(self, offline_server):
        server, _d, _t = offline_server
        for path, want in [
            ("/nope", 404),
            ("/tree?fmt=bogus", 400),
            ("/tree?view=bogus", 404),
            ("/tree?level=abc", 400),
            ("/timeline?fmt=jsn", 400),
            ("/diff", 400),
            ("/diff?fmt=bogus&baseline=tests/data/ci_baseline.snap", 400),
            ("/diff?baseline=/does/not/exist", 404),
        ]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + path)
            assert e.value.code == want, path

    def test_timeline_cache_refreshes_when_ring_grows(self, tmp_path):
        d = str(tmp_path)
        t = CallTree()
        writer = TimelineWriter(os.path.join(d, "timeline"), epochs_per_segment=2)
        sealer = EpochSealer(t, writer)
        chain = t.path_nodes(["thread::Main", "step"])
        CallTree.add_stack_nodes(chain, 5.0)
        sealer.seal(wall_time=0.0)
        server = ProfileServer(OfflineSource(d), port=0).start()
        try:
            first = json.loads(_get(server.url + "/timeline?fmt=json")[1])
            assert len(first) == 1
            cached = json.loads(_get(server.url + "/timeline?fmt=json")[1])
            assert cached == first  # served from the segment-mtime cache
            CallTree.add_stack_nodes(chain, 3.0)
            sealer.seal(wall_time=1.0)
            seg = os.path.join(d, "timeline")
            newest = max(os.path.join(seg, p) for p in os.listdir(seg))
            os.utime(newest, (time.time() + 2, time.time() + 2))
            grown = json.loads(_get(server.url + "/timeline?fmt=json")[1])
            assert len(grown) == 2  # cache invalidated by the mtime change
        finally:
            server.stop()
            writer.close()

    def test_diff_baseline_query_param_rejected_off_loopback(self, tmp_path):
        # ?baseline= is a server-side file read: on a non-loopback bind only
        # the operator-configured --baseline may be diffed (403 otherwise).
        d, tree = profile_dir(tmp_path)
        snap = str(tmp_path / "base.snap")
        save_snapshot(tree, snap)
        server = ProfileServer(OfflineSource(d), host="0.0.0.0", port=0, baseline=snap).start()
        url = f"http://127.0.0.1:{server.port}"
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(url + "/diff?baseline=/etc/hostname")
            assert e.value.code == 403
            code, body = _get(url + "/diff")  # configured default: allowed
            assert code == 200 and body.startswith("# diff")
            code, body = _get(url + f"/diff?baseline={snap}")  # == configured
            assert code == 200
        finally:
            server.stop()

    def test_response_size_cap(self, tmp_path):
        d, _t = profile_dir(tmp_path)
        server = ProfileServer(OfflineSource(d), port=0, max_bytes=64).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + "/tree?fmt=html")
            assert e.value.code == 413
        finally:
            server.stop()

    def test_mtime_cache_picks_up_new_writes(self, tmp_path):
        # tree.json-only profile (no ring): rewrites must be re-served.
        tree = sample_tree()
        path = str(tmp_path / "tree.json")
        with open(path, "w") as f:
            f.write(tree.to_json())
        server = ProfileServer(OfflineSource(path), port=0).start()
        try:
            _code, before = _get(server.url + "/tree?fmt=folded")
            assert "fresh_path" not in before
            tree.add_stack(["fresh_path"])
            with open(path, "w") as f:
                f.write(tree.to_json())
            os.utime(path, (time.time() + 2, time.time() + 2))  # force mtime forward
            _code, after = _get(server.url + "/tree?fmt=folded")
            assert "fresh_path" in after
        finally:
            server.stop()


class TestServerLive:
    def test_live_daemon_answers_all_endpoints(self, tmp_path):
        from repro_torch.profilerd.agent import Agent
        from repro_torch.profilerd.daemon import DaemonConfig, ProfilerDaemon

        evt = threading.Event()

        def parked():
            evt.wait()

        worker = threading.Thread(target=parked, name="served-worker", daemon=True)
        worker.start()
        time.sleep(0.05)
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10)
        for _ in range(12):
            agent.tick()

        cfg = DaemonConfig(
            spool_path=spool,
            out_dir=str(tmp_path / "out"),
            publish_interval_s=0.05,
            epoch_s=0.2,
            max_seconds=30,
            serve_port=0,
        )
        daemon = ProfilerDaemon(cfg)
        daemon.attach()
        server = daemon.enable_serving()
        runner = threading.Thread(target=daemon.run, daemon=True)
        runner.start()
        try:
            deadline = time.time() + 15
            status = {}
            while time.time() < deadline:
                status = json.loads(_get(server.url + "/status")[1])
                if status.get("n_stacks", 0) >= 12:
                    break
                time.sleep(0.05)
            assert status.get("n_stacks", 0) >= 12, status
            assert not status.get("offline")

            _code, folded = _get(server.url + "/tree?fmt=folded")
            assert "thread::served-worker" in folded
            _code, html = _get(server.url + "/tree?fmt=html")
            assert "http://" not in html and "https://" not in html

            deadline = time.time() + 10  # wait for the first sealed epoch
            while time.time() < deadline:
                try:
                    _code, tl = _get(server.url + "/timeline")
                    break
                except urllib.error.HTTPError:
                    time.sleep(0.1)
            assert "epoch" in tl
        finally:
            agent.stop()
            evt.set()
            runner.join(timeout=20)
        assert not runner.is_alive()
        # run() stops the server: the port must be closed afterwards.
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(server.url + "/status", timeout=1)

    def test_serving_reads_do_not_touch_live_tree(self, tmp_path):
        """Handlers only see published copies: mutating the live tree between
        publishes must not change what /tree serves."""
        from repro_torch.profilerd.server import LiveSource, SharedProfileState

        shared = SharedProfileState()
        live = CallTree()
        live.add_stack(["a", "b"])
        shared.update({"n_stacks": 1}, live.copy())
        source = LiveSource(shared)
        live.add_stack(["a", "c"])  # ingest happens after the publish
        assert source.tree().total() == 1.0  # the snapshot, not the live tree


class TestLauncherServe:
    def host_dir(self, tmp_path, name, leaf):
        out = tmp_path / f"{name}.spool.d"
        out.mkdir()
        t = CallTree()
        for _ in range(4):
            t.add_stack(["thread::m", "serve_step", leaf])
        (out / "tree.json").write_text(t.to_json())
        return t

    def test_fleet_merge_is_served(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        a = self.host_dir(tmp_path, "attempt0", "attention")
        b = self.host_dir(tmp_path, "attempt1", "mlp")
        launcher = Launcher(
            LaunchConfig(
                cmd=["true"],
                workdir=str(tmp_path),
                heartbeat_path=str(tmp_path / "hb"),
                profile_dir=str(tmp_path),
                serve_port=0,
            )
        )
        merged_path = launcher._rendezvous_merge()
        assert merged_path is not None and launcher.server is not None
        try:
            _code, body = _get(launcher.server.url + "/status")
            assert json.loads(body)["offline"]
            _code, folded = _get(launcher.server.url + "/tree?fmt=folded")
            merged = from_folded(folded)
            assert merged.total() == pytest.approx(a.total() + b.total())
            assert "attention" in folded and "mlp" in folded
        finally:
            launcher.server.stop()

    def test_no_serving_without_port(self, tmp_path):
        from repro_torch.launch.launcher import LaunchConfig, Launcher

        self.host_dir(tmp_path, "attempt0", "attention")
        launcher = Launcher(
            LaunchConfig(
                cmd=["true"],
                workdir=str(tmp_path),
                heartbeat_path=str(tmp_path / "hb"),
                profile_dir=str(tmp_path),
            )
        )
        assert launcher._rendezvous_merge() is not None
        assert launcher.server is None


class TestCli:
    def test_export_folded_and_html(self, tmp_path, capsys):
        d, tree = profile_dir(tmp_path)
        assert main(["export", d, "--fmt", "folded"]) == 0
        out = capsys.readouterr().out
        assert from_folded(out).total() == pytest.approx(tree.total())
        html_path = str(tmp_path / "f.html")
        assert main(["export", d, "--fmt", "html", "--out", html_path]) == 0
        html = open(html_path).read()
        assert "http://" not in html and "https://" not in html

    def test_export_no_match_exits_4_with_marker(self, tmp_path, capsys):
        d, _tree = profile_dir(tmp_path)
        rc = main(["export", d, "--fmt", "csv", "--root", "does_not_exist"])
        captured = capsys.readouterr()
        assert rc == EXIT_NO_MATCH
        assert "# no match for root=does_not_exist" in captured.out + captured.err

    def test_export_filter_emptied_view_exits_4_not_silently_empty(self, tmp_path, capsys):
        # attention_scores_only: root="attention" matches nothing here, but
        # craft a profile where the root *does* match and only the whitelist
        # empties the view — the no-match exit must still fire, with the
        # empty-view marker (not a misleading "no match for root=").
        d = str(tmp_path / "p")
        os.makedirs(d)
        t = CallTree()
        t.add_stack(["thread::Main", "model", "attention", "context"])  # no "scores"
        with open(os.path.join(d, "tree.json"), "w") as f:
            f.write(t.to_json())
        rc = main(["export", d, "--fmt", "folded", "--view", "attention_scores_only"])
        captured = capsys.readouterr()
        assert rc == EXIT_NO_MATCH
        assert "# empty view" in captured.err
        assert "no match for root=" not in captured.err

    def test_export_unreadable_profile_exits_3(self, tmp_path):
        assert main(["export", str(tmp_path / "nope")]) == EXIT_UNREADABLE

    def test_export_level0_folded_exits_4_not_empty_file(self, tmp_path, capsys):
        # levels(0) folds everything into the root: no stacks exist for the
        # stack-shaped formats, which must fail loudly instead of writing an
        # empty artifact with exit 0 (csv keeps its header total and passes).
        d, _tree = profile_dir(tmp_path)
        out = str(tmp_path / "empty.folded")
        rc = main(["export", d, "--fmt", "folded", "--level", "0", "--out", out])
        captured = capsys.readouterr()
        assert rc == EXIT_NO_MATCH
        assert "empty export" in captured.err
        assert not os.path.exists(out)
        assert main(["export", d, "--fmt", "csv", "--level", "0"]) == 0
        capsys.readouterr()
        # min_share pruning everything must also fail loudly, not write ""
        rc = main(["export", d, "--fmt", "folded", "--min-share", "1.5", "--out", out])
        captured = capsys.readouterr()
        assert rc == EXIT_NO_MATCH and "min_share" in captured.err
        assert not os.path.exists(out)

    def test_export_baseline_defaults_to_html(self, tmp_path, capsys):
        d, tree = profile_dir(tmp_path)
        snap = str(tmp_path / "base.snap")
        save_snapshot(tree, snap)
        out = str(tmp_path / "d.html")
        # no --fmt: --baseline implies html
        assert main(["export", d, "--baseline", snap, "--out", out]) == 0
        assert "fgdata" in open(out).read()
        # an explicit conflicting fmt is a usage error (2), not "unreadable" (3)
        assert main(["export", d, "--baseline", snap, "--fmt", "folded"]) == 2

    def test_export_view_composes_with_min_share(self, tmp_path, capsys):
        d, _tree = profile_dir(tmp_path)
        assert main(["export", d, "--fmt", "folded", "--view", "host_threads",
                     "--level", "-1"]) == 0
        full = capsys.readouterr().out
        assert main(["export", d, "--fmt", "folded", "--view", "host_threads",
                     "--level", "-1", "--min-share", "0.5"]) == 0
        pruned = capsys.readouterr().out
        assert "sampler" in full and "sampler" not in pruned
        assert len(pruned) < len(full)

    def test_diff_html_writes_flamegraph(self, tmp_path, capsys):
        d, tree = profile_dir(tmp_path)
        snap = str(tmp_path / "base.snap")
        save_snapshot(tree, snap)
        html_path = str(tmp_path / "diff.html")
        assert main(["diff", snap, d, "--html", html_path]) == 0
        assert "fgdata" in open(html_path).read()

    def test_top_once_against_offline_server(self, tmp_path, capsys):
        d, _tree = profile_dir(tmp_path)
        server = ProfileServer(OfflineSource(d), port=0).start()
        try:
            assert main(["top", "--url", server.url, "--once"]) == 0
            out = capsys.readouterr().out
            assert "profilerd top" in out and "serve_step" in out
        finally:
            server.stop()

    def test_top_unreachable_exits_1(self):
        assert main(["top", "--url", "http://127.0.0.1:9", "--once"]) == 1

    def test_render_top_live_shape(self):
        out = render_top(
            {
                "pid": 7,
                "stalled": True,
                "n_stacks": 5,
                "wire_version": 2,
                "hot_paths": [{"path": ["a", "b"], "share": 0.5}],
                "events": [{"kind": "TARGET_STALLED", "path": [], "share": 1.0}],
            },
            "http://x",
        )
        assert "STALLED" in out and "a/b" in out and "TARGET_STALLED" in out


# -- cross-package parity: the JAX package's exporters, views and server -----
#
# Pure Python on both sides, so the tolerance is equality: the same bytes, or
# the same values. The trees are drawn with hostile frame names (the folded
# separator, spaces, newlines, HTML and JSON metacharacters, non-ASCII).

import dataclasses  # noqa: E402

import repro.core.calltree as jax_calltree  # noqa: E402
import repro.core.export as jax_export  # noqa: E402
import repro.core.report as jax_report  # noqa: E402
import repro.core.views_library as jax_views  # noqa: E402
import repro.profilerd.server as jax_server  # noqa: E402
from repro_torch.core import report as port_report  # noqa: E402
from repro_torch.core import views_library as port_views  # noqa: E402
from repro_torch.core.export import to_speedscope_json  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # keep property tests running where hypothesis is absent
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

HOSTILE = ["thread::Main", "serve_step", "model", "attention", "scores", "mlp", "a;b", "semi;colon ; x",
           "sp ace", "new\nline", "tab\tname", "<script>alert(1)</script>", "&amp;", '"quoted"', "'single'",
           "back\\slash", "</details>", "ünïcødé ☃", "emoji 🔥", "py::f (file.py:12)", "", " ", "42",
           "repro-ckpt-writer", "torch::mm", "jax::jit", "_prefetch_worker", "optimizer", "loss"]
_name_st = st.sampled_from(HOSTILE)
_stack_st = st.lists(_name_st, min_size=1, max_size=7)


def _both_trees(stacks, weights, extra: bool):
    """The same tree in each package: one stack each, with its weight, and
    (``extra``) device-plane counters on a few stacks."""
    port, jax = CallTree(), jax_calltree.CallTree()
    for i, (stack, w) in enumerate(zip(stacks, weights)):
        metrics = {"samples": float(w)}
        if extra and i % 3 == 0:
            metrics.update({"flops": float(w * 1000 + i), "bytes": float(w * 7)})
        port.add_stack(stack, dict(metrics))
        jax.add_stack(stack, dict(metrics))
    return port, jax


def _port_view(name: str):
    """The port's library view, and the JAX package's as the port defines it:
    ``host_dispatch_noise`` keeps ``torch::`` frames where the JAX package
    keeps ``jax::`` (the one view whose definition differs, by design)."""
    jax_view = jax_views.VIEWS[name]
    port_view = port_views.VIEWS[name]
    if name == "host_dispatch_noise":
        assert jax_view.whitelist == ["jax::"] and port_view.whitelist == ["torch::"]
        jax_view = dataclasses.replace(jax_view, whitelist=port_view.whitelist)
    assert dataclasses.asdict(port_view) == dataclasses.asdict(jax_view), name
    return port_view, jax_view


def test_the_view_library_is_the_jax_packages():
    assert sorted(port_views.VIEWS) == sorted(jax_views.VIEWS)
    for name in port_views.VIEWS:
        _port_view(name)


@settings(max_examples=40, deadline=None)
@given(st.lists(_stack_st, min_size=1, max_size=30), st.lists(st.integers(1, 50), min_size=30, max_size=30),
       st.sampled_from([False, True]))
def test_prop_exports_equal_the_jax_packages(stacks, weights, extra):
    port, jax = _both_trees(stacks, weights, extra)
    assert port.to_json() == jax.to_json()
    for metric in ("samples", "flops") if extra else ("samples",):
        assert to_folded(port, metric) == jax_export.to_folded(jax, metric)
        assert to_speedscope_json(port, metric, name="t") == jax_export.to_speedscope_json(jax, metric, name="t")
        assert flamegraph_html(port, metric, title="t <&>") == jax_export.flamegraph_html(jax, metric, title="t <&>")
    for fmt in EXPORT_FORMATS:
        assert export_tree(port, fmt, title="p") == jax_export.export_tree(jax, fmt, title="p"), fmt
    assert port_report.breakdown(port) == jax_report.breakdown(jax)
    assert port_report.breakdown(port, level=3, min_share=0.0) == jax_report.breakdown(jax, level=3, min_share=0.0)


@settings(max_examples=15, deadline=None)
@given(st.lists(_stack_st, min_size=1, max_size=20), st.lists(st.integers(1, 50), min_size=20, max_size=20))
def test_prop_every_library_view_exports_the_jax_packages_bytes(stacks, weights):
    port, jax = _both_trees(stacks, weights, extra=True)
    for name in sorted(port_views.VIEWS):
        port_view, jax_view = _port_view(name)
        for fmt in EXPORT_FORMATS:
            got = export_tree(port, fmt, view=port_view, title=name)
            want = jax_export.export_tree(jax, fmt, view=jax_view, title=name)
            assert got == want, (name, fmt)
        assert port_view.to_csv(port) == jax_view.to_csv(jax), name


@settings(max_examples=30, deadline=None)
@given(st.lists(_stack_st, min_size=1, max_size=20), st.lists(_stack_st, min_size=1, max_size=20),
       st.lists(st.integers(1, 50), min_size=20, max_size=20), st.sampled_from([0.0, 0.01, 0.05]))
def test_prop_diffs_equal_the_jax_packages(stacks_a, stacks_b, weights, tolerance):
    port_a, jax_a = _both_trees(stacks_a, weights, extra=False)
    port_b, jax_b = _both_trees(stacks_b, weights[::-1], extra=False)
    assert diff_flamegraph_html(port_a, port_b, "samples", title="a vs b") == \
        jax_export.diff_flamegraph_html(jax_a, jax_b, "samples", title="a vs b")
    assert build_diff_tree(port_a, port_b).to_json() == jax_export.build_diff_tree(jax_a, jax_b).to_json()
    for self_only in (False, True):
        assert port_report.render_diff(port_a, port_b, label_a="a", label_b="b", self_only=self_only) == \
            jax_report.render_diff(jax_a, jax_b, label_a="a", label_b="b", self_only=self_only)
        assert port_report.share_regressions(port_a, port_b, tolerance=tolerance, self_only=self_only) == \
            jax_report.share_regressions(jax_a, jax_b, tolerance=tolerance, self_only=self_only)
        assert port_report.diff_rows(port_a, port_b, self_only=self_only) == \
            jax_report.diff_rows(jax_a, jax_b, self_only=self_only)


@settings(max_examples=30, deadline=None)
@given(st.lists(_stack_st, min_size=1, max_size=30), st.lists(st.integers(1, 50), min_size=30, max_size=30))
def test_prop_each_from_folded_reads_the_others_output(stacks, weights):
    port, jax = _both_trees(stacks, weights, extra=False)
    from_jax = from_folded(jax_export.to_folded(jax))
    from_port = jax_export.from_folded(to_folded(port))
    assert from_jax.to_json() == jax_export.from_folded(jax_export.to_folded(jax)).to_json()
    assert from_port.to_json() == from_folded(to_folded(port)).to_json()
    assert from_jax.total() == port.total() and from_port.total() == jax.total()


def _fleet_dir(root) -> str:
    """An offline fleet profile both servers read: the fleet's tree.json and
    timeline ring, two targets with theirs, and a device_tree.json (the
    port's saver writes the JAX package's schema)."""
    from repro_torch.core.device_tree import save_device_tree

    d = root / "fleet"
    stacks = {
        "alpha": [(["thread::Main", "train_step", "model", "attention", "scores"], 3.0),
                  (["thread::Main", "train_step", "model", "mlp"], 2.0)],
        "beta": [(["thread::Main", "train_step", "optimizer", "adamw"], 1.0),
                 (["thread::repro-data-prefetch", "_prefetch_worker", "next_batch"], 1.0)],
    }
    fleet = CallTree()
    fleet_writer = TimelineWriter(str(d / "timeline"), epochs_per_segment=4)
    fleet_sealer = EpochSealer(fleet, fleet_writer)
    for name, rows in stacks.items():
        t = CallTree()
        w = TimelineWriter(str(d / "targets" / name / "timeline"), epochs_per_segment=4)
        s = EpochSealer(t, w)
        for epoch in range(5):
            for stack, n in rows:
                CallTree.add_stack_nodes(t.path_nodes(stack), n * (epoch + 1))
            s.seal(wall_time=100.0 + epoch)
        w.close()
        (d / "targets" / name / "tree.json").write_text(t.to_json())
    for epoch in range(5):
        for rows in stacks.values():
            for stack, n in rows:
                CallTree.add_stack_nodes(fleet.path_nodes(stack), n * (epoch + 1))
        fleet_sealer.seal(wall_time=100.0 + epoch)
    fleet_writer.close()
    (d / "tree.json").write_text(fleet.to_json())
    device = CallTree()
    device.add_stack(["train_step", "model", "attention", "scores"], {"flops": 4e12, "bytes": 2e9, "ops": 3.0})
    device.add_stack(["train_step", "model", "mlp"], {"flops": 9e12, "bytes": 1e9, "ops": 2.0})
    device.add_stack(["train_step", "optimizer", "adamw"], {"flops": 1e9, "bytes": 5e9, "ops": 4.0})
    save_device_tree(device, str(d / "device_tree.json"))
    base = root / "base"  # a baseline run with its own device plane
    base.mkdir()
    base_tree = CallTree()
    base_tree.add_stack(["thread::Main", "train_step", "model", "mlp"], {"samples": 9.0})
    base_tree.add_stack(["thread::Main", "train_step", "optimizer", "adamw"], {"samples": 1.0})
    (base / "tree.json").write_text(base_tree.to_json())
    device.add_stack(["train_step", "model", "mlp"], {"flops": 1e12})
    save_device_tree(device, str(base / "device_tree.json"))
    return str(d)


# The served queries: (path, fields masked in a JSON body). Each answers the
# same status code and body from both packages' servers.
SERVER_QUERIES = [
    "/", "/help", "/status", "/targets",
    *[f"/tree?fmt={fmt}" for fmt in ("csv", "folded", "speedscope", "html", "json")],
    *[f"/tree?fmt={fmt}&target=alpha" for fmt in ("csv", "folded", "json")],
    "/tree?fmt=folded&target=beta", "/tree?view=top_level", "/tree?fmt=folded&view=train_step_phases",
    "/tree?fmt=html&view=model_components", "/tree?fmt=csv&view=optimizer&level=3",
    "/tree?fmt=folded&root=model&level=2", "/tree?fmt=csv&root=attention&min_share=0.1",
    "/tree?fmt=speedscope&root=train_step",
    *[f"/tree?plane=device&fmt={fmt}" for fmt in ("csv", "folded", "json", "html")],
    "/tree?plane=device&metric=bytes&fmt=folded", "/tree?plane=device&target=alpha&fmt=folded",
    "/tree?plane=merged&fmt=folded", "/tree?plane=merged&fmt=csv", "/tree?plane=merged&fmt=csv&metric=hlo_flops",
    "/timeline", "/timeline?fmt=json", "/timeline?target=alpha", "/timeline?fmt=json&target=beta",
    "/diff?baseline={base}", "/diff?baseline={base}&fmt=html", "/diff?baseline={base}&plane=device",
    # the error cases
    "/nope", "/tree?fmt=bogus", "/tree?view=no_such_view", "/tree?level=x", "/tree?plane=bogus",
    "/tree?target=missing", "/tree?fmt=folded&root=does_not_exist", "/tree?fmt=folded&min_share=1.5",
    "/tree?fmt=folded&level=0", "/timeline?fmt=bogus", "/timeline?target=missing", "/diff",
    "/diff?baseline={base}&fmt=bogus", "/diff?baseline={root}/missing.json", "/diff?baseline={base}&plane=bogus",
]


def test_both_servers_answer_the_same_over_one_offline_profile(tmp_path):
    """Masked: URLs (no body here holds one) and wall times (the ring's are
    fixed, the status's ``updated`` is the artifacts' own mtime), and in the
    merged plane's JSON the roofline keys (``rt_*``, ``roofline_occupancy``,
    ``dominant::*``), which each package computes against its own card: the
    merged plane is compared as folded and CSV samples, and as its device
    counters (``hlo_*``)."""
    d = _fleet_dir(tmp_path)
    servers = {"port": ProfileServer(OfflineSource(d)).start(),
               "jax": jax_server.ProfileServer(jax_server.OfflineSource(d)).start()}
    try:
        for q in SERVER_QUERIES:
            q = q.format(base=tmp_path / "base", root=tmp_path)
            got = {name: _get_any(s.url + q) for name, s in servers.items()}
            assert got["port"] == got["jax"], q
        assert _get_any(servers["port"].url + "/tree?plane=device&fmt=folded")[0] == 200
        # the merged plane's device counters, both sides, with the card-bound keys masked
        merged = {name: json.loads(_get_any(s.url + "/tree?plane=merged&fmt=json")[1]) for name, s in servers.items()}
        assert _mask_roofline(merged["port"]) == _mask_roofline(merged["jax"])
        assert any(k.startswith("hlo_") for k in json.dumps(merged["port"]).split('"'))
        # a static plane with no artifact: the same 404, the remedy hints name each package's extractor
        codes = {name: _get_any(s.url + "/tree?plane=static")[0] for name, s in servers.items()}
        assert codes == {"port": 404, "jax": 404}
    finally:
        for s in servers.values():
            s.stop()


def test_the_port_answers_404_naming_the_roadmap_where_a_static_tree_exists(tmp_path):
    """A static tree the port's extractor wrote beside a fleet profile is
    served (``/tree`` and ``/diff`` with ``plane=static``) and exported; a
    garbage one (``{}``) is unreadable: 404 "profile unreadable" from the
    server and ``EXIT_UNREADABLE`` from ``export``, as the JAX package
    answers."""
    from repro_torch.analysis.extract import extract_to_file

    d = _fleet_dir(tmp_path)
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "alpha.py").write_text("def outer():\n    return inner()\n\n\ndef inner():\n    return 1\n")
    static = os.path.join(d, "static_tree.json")
    extract_to_file(static, root=str(pkg), package="pkg")
    queries = ("/tree?plane=static", "/tree?plane=static&fmt=folded", f"/diff?plane=static&baseline={d}")
    server = ProfileServer(OfflineSource(d)).start()
    try:
        for q in queries:
            code, body = _get_any(server.url + q)
            assert code == 200, (q, code, body)
        assert "mod::pkg.alpha;repro::outer" in _get_any(server.url + "/tree?plane=static&fmt=folded")[1]
    finally:
        server.stop()
    out = tmp_path / "static.folded"
    assert main(["export", d, "--plane", "static", "--fmt", "folded", "--out", str(out)]) == 0
    assert "mod::pkg.alpha;repro::outer 1.0" in out.read_text()

    with open(static, "w") as f:
        f.write("{}")
    server = ProfileServer(OfflineSource(d)).start()
    try:
        for q in queries:
            code, body = _get_any(server.url + q)
            assert code == 404 and body.startswith("profile unreadable") and "unreadable static tree" in body, (
                q, code, body)
    finally:
        server.stop()
    assert main(["export", d, "--plane", "static"]) == EXIT_UNREADABLE


def _get_any(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _mask_roofline(node: dict) -> dict:
    out = dict(node)
    for key in ("metrics", "self"):
        if key in out:
            out[key] = {k: v for k, v in out[key].items()
                        if not (k.startswith(("rt_", "dominant::")) or k == "roofline_occupancy")}
    if "children" in out:
        out["children"] = [_mask_roofline(c) for c in out["children"]] if isinstance(out["children"], list) \
            else {k: _mask_roofline(c) for k, c in out["children"].items()}
    return out
