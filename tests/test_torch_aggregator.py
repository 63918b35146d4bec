"""Fleet tier tests: push wire format, aggregator replay, liveness, retention
(``tests/test_aggregator.py`` pointed at the port, then the port held to the
JAX package: push bodies, and daemons of either package pushing to
aggregators of either).

The invariants:

* push bodies are self-contained snapshot-codec segments — torn or
  multi-record bodies are rejected, never half-applied;
* replay is idempotent (client retries after a lost 200 don't double-count)
  and order-tolerant (deltas commute within a keyframe era; a stale keyframe
  can't erase later-applied mass);
* node churn folds dead incarnations into a retained base — a crash-looping
  node keeps contributing everything it ever reported;
* retention is two-ring: recent epochs exact in a bounded ring, old epochs
  at coarser grain (one keyframe every N fleet epochs), both bounded by
  whole-segment drops;
* a dead aggregator never blocks the client and never loses epoch *mass*:
  spill + bounded backoff + keyframe resync (PUSH_FAILED/PUSH_RECOVERED);
* the aggregator restarts crash-safe from its own rings and sidecars.
"""

import json
import os
import urllib.error
import urllib.request

import pytest

from repro_torch.core.calltree import CallTree
from repro_torch.core.snapshot import (
    K_DELTA,
    K_FULL,
    EpochMeta,
    SnapshotCorrupt,
    TimelineReader,
    list_segments,
)
from repro_torch.profilerd.aggregator import (
    NODE_RECOVERED,
    NODE_STALLED,
    Aggregator,
    AggregatorConfig,
)
from repro_torch.profilerd.push import (
    H_BOOT,
    H_DONE,
    H_EPOCH,
    H_INTERVAL,
    H_NODE,
    H_TARGETS,
    PushClient,
    decode_push_body,
    encode_push_body,
    push_url_for,
)


def tree_of(*stacks, w=1.0):
    t = CallTree()
    for s in stacks:
        t.add_stack(list(s), {"samples": float(w)})
    return t


def headers_for(node, boot="boot0", epoch=0, **extra):
    h = {H_NODE: node, H_BOOT: boot, H_EPOCH: str(epoch), H_INTERVAL: "5"}
    h.update(extra)
    return h


def mkagg(tmp_path, **kw):
    kw.setdefault("out_dir", str(tmp_path / "region.d"))
    return Aggregator(AggregatorConfig(**kw))


class TestPushWire:
    def test_body_roundtrip_full_and_delta(self):
        t = tree_of(("main", "step", "loss"), ("main", "io"))
        for kind in (K_FULL, K_DELTA):
            meta, got = decode_push_body(
                encode_push_body(kind, EpochMeta(7, 123.0, 3.0), t)
            )
            assert meta.epoch == 7 and meta.kind == kind
            assert got.total() == t.total()

    def test_torn_body_rejected(self):
        body = encode_push_body(K_FULL, EpochMeta(0), tree_of(("a", "b")))
        with pytest.raises(SnapshotCorrupt):
            decode_push_body(body[:-3])

    def test_garbage_and_empty_bodies_rejected(self):
        for bad in (b"", b"not a segment at all", b"RTL1\x00\x00"):
            with pytest.raises(SnapshotCorrupt):
                decode_push_body(bad)

    def test_multi_record_body_rejected(self):
        one = encode_push_body(K_FULL, EpochMeta(0), tree_of(("a",)))
        two = one + one[6:]  # second framed record appended after the header
        with pytest.raises(SnapshotCorrupt):
            decode_push_body(two)

    def test_push_url_normalization(self):
        assert push_url_for("localhost:9000") == "http://localhost:9000/push"
        assert push_url_for("http://h:1/") == "http://h:1/push"
        assert push_url_for("http://h:1/push") == "http://h:1/push"


class TestReplay:
    def test_duplicate_epoch_not_double_counted(self, tmp_path):
        agg = mkagg(tmp_path)
        body = encode_push_body(K_DELTA, EpochMeta(0), tree_of(("main", "f")))
        code, resp = agg.handle_push(headers_for("n1", epoch=0), body)
        assert code == 200 and resp["applied"]
        # The client retries the identical POST (it never saw the 200).
        code, resp = agg.handle_push(headers_for("n1", epoch=0), body)
        assert code == 200 and not resp["applied"] and resp["duplicate"]
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == 1.0
        agg.close()

    def test_out_of_order_deltas_converge(self, tmp_path):
        agg = mkagg(tmp_path)
        bodies = {
            e: encode_push_body(K_DELTA, EpochMeta(e), tree_of(("main", f"f{e}")))
            for e in range(4)
        }
        for e in (2, 0, 3, 1):  # arbitrary arrival order
            code, resp = agg.handle_push(headers_for("n1", epoch=e), bodies[e])
            assert code == 200 and resp["applied"]
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == 4.0
        assert agg.nodes["n1"].floor == 3  # contiguous floor caught up
        assert not agg.nodes["n1"].applied  # sparse set fully absorbed
        agg.close()

    def test_stale_keyframe_cannot_erase_later_mass(self, tmp_path):
        agg = mkagg(tmp_path)
        agg.handle_push(
            headers_for("n1", epoch=0),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "a"))),
        )
        agg.handle_push(
            headers_for("n1", epoch=2),
            encode_push_body(K_DELTA, EpochMeta(2), tree_of(("main", "b"))),
        )
        # A delayed keyframe for epoch 1 arrives after epoch 2 was applied:
        # replacement would erase epoch 2's mass, so it must be refused.
        code, resp = agg.handle_push(
            headers_for("n1", epoch=1),
            encode_push_body(K_FULL, EpochMeta(1), tree_of(("main", "a"), w=2.0)),
        )
        assert code == 200 and not resp["applied"]
        assert agg.nodes["n1"].stale == 1
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == 2.0  # a + b, untouched
        agg.close()

    def test_keyframe_replacement_resyncs_exactly(self, tmp_path):
        agg = mkagg(tmp_path)
        agg.handle_push(
            headers_for("n1", epoch=0),
            encode_push_body(K_DELTA, EpochMeta(0), tree_of(("main", "a"))),
        )
        # Epochs 1..3 were lost client-side (spill overflow); the resync
        # keyframe carries the exact cumulative and supersedes everything.
        cum = tree_of(("main", "a"), ("main", "b"), w=5.0)
        code, resp = agg.handle_push(
            headers_for("n1", epoch=4), encode_push_body(K_FULL, EpochMeta(4), cum)
        )
        assert code == 200 and resp["applied"]
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == cum.total()
        agg.close()

    def test_fleet_mass_is_sum_of_node_masses(self, tmp_path):
        agg = mkagg(tmp_path)
        for name, w in (("n1", 2.0), ("n2", 3.0), ("n3", 5.0)):
            agg.handle_push(
                headers_for(name, epoch=0),
                encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", name), w=w)),
            )
        agg.seal_fleet_epoch(force=True)
        status = agg.status()
        node_mass = sum(r["mass"] for r in status["nodes"].values())
        assert status["fleet"]["mass"] == node_mass == 10.0
        agg.close()


class TestNodeChurn:
    def test_reboot_folds_incarnation_into_base(self, tmp_path):
        agg = mkagg(tmp_path)
        agg.handle_push(
            headers_for("n1", boot="boot-a", epoch=0),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "a"), w=4.0)),
        )
        # Crash + restart: fresh boot id, epoch numbering restarts at 0.
        agg.handle_push(
            headers_for("n1", boot="boot-b", epoch=0),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "b"), w=6.0)),
        )
        node = agg.nodes["n1"]
        assert node.incarnations == 1 and node.boot == "boot-b"
        assert node.effective().total() == 10.0  # nothing lost across the reboot
        assert any(e["kind"] == "NODE_REBOOTED" for e in agg.events)
        assert os.path.exists(
            os.path.join(agg.out_dir, "targets", "n1", "base.json")
        )
        agg.close()

    def test_invalid_node_names_rejected(self, tmp_path):
        agg = mkagg(tmp_path)
        body = encode_push_body(K_FULL, EpochMeta(0), tree_of(("a",)))
        for bad in ("", "../escape", "a/b", ".hidden", "x" * 80):
            code, resp = agg.handle_push(headers_for(bad), body)
            assert code == 400, bad
        assert not agg.nodes
        agg.close()


class TestRetention:
    def test_recent_and_coarse_rings_are_bounded(self, tmp_path):
        agg = mkagg(
            tmp_path,
            epochs_per_segment=2,
            max_segments=3,
            coarse_every=2,
            coarse_segments=4,
        )
        for e in range(40):
            agg.handle_push(
                headers_for("n1", epoch=e),
                encode_push_body(
                    K_DELTA, EpochMeta(e, float(e)), tree_of(("main", "f"))
                ),
            )
            agg.seal_fleet_epoch(force=True)
        recent = list_segments(agg.cfg.timeline_dir())
        coarse = list_segments(agg.cfg.coarse_dir())
        assert 0 < len(recent) <= 3
        assert 0 < len(coarse) <= 4
        # Recent ring: exact consecutive epochs at the tail of history.
        epochs = [m.epoch for m, _w, _c in TimelineReader(agg.cfg.timeline_dir()).epochs()]
        assert epochs == list(range(epochs[0], 40))
        # Coarse ring: one keyframe every coarse_every fleet epochs, each
        # decodable standalone, spanning an older horizon than the exact ring.
        coarse_epochs = [
            m.epoch for m, _w, _c in TimelineReader(agg.cfg.coarse_dir()).epochs()
        ]
        assert all(e % 2 == 0 for e in coarse_epochs)
        assert coarse_epochs[0] <= epochs[0]
        # Dropped coarse epochs are whole-segment drops; retained tail is
        # still the cumulative truth.
        last = TimelineReader(agg.cfg.coarse_dir()).last()
        assert last[1].total() == pytest.approx(agg.fleet_tree().total(), abs=1.0)
        agg.close()


class TestHTTPIngest:
    def test_oversized_body_413_and_torn_body_400_over_http(self, tmp_path):
        agg = mkagg(tmp_path, max_body_bytes=4096)
        url = agg.enable_serving().url
        good = encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "f")))

        def post(body, headers):
            req = urllib.request.Request(
                url + "/push", data=body, headers=headers, method="POST"
            )
            try:
                with urllib.request.urlopen(req, timeout=5) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode("utf-8", "replace")

        code, resp = post(good, headers_for("n1"))
        assert code == 200 and resp["applied"]
        assert post(good[:-5], headers_for("n1", epoch=1))[0] == 400
        assert post(b"\x00" * 8192, headers_for("n1", epoch=2))[0] == 413
        assert post(good, {})[0] == 400  # missing node header
        # Clean rejects leave the applied state untouched.
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == 1.0
        agg.close()

    def test_get_surfaces_fleet_hierarchy_and_node_trees(self, tmp_path):
        agg = mkagg(tmp_path, region="eu-west")
        url = agg.enable_serving().url
        for name in ("n1", "n2"):
            agg.handle_push(
                headers_for(name, **{H_TARGETS: f"{name}-t0,{name}-t1"}),
                encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", name))),
            )
        agg.seal_fleet_epoch(force=True)
        h = json.loads(urllib.request.urlopen(url + "/targets", timeout=5).read())
        assert h["region"] == "eu-west"
        assert [n["name"] for n in h["nodes"]] == ["n1", "n2"]
        assert [t["name"] for t in h["nodes"][0]["targets"]] == ["n1-t0", "n1-t1"]
        # Flat rows stay for pre-fleet consumers.
        assert {r["node"] for r in h["targets"]} == {"n1", "n2"}
        per_node = urllib.request.urlopen(
            url + "/tree?fmt=folded&target=n2", timeout=5
        ).read().decode()
        assert "n2" in per_node and "n1" not in per_node
        status = json.loads(urllib.request.urlopen(url + "/status", timeout=5).read())
        assert status["aggregator"] and status["fleet"]["mass"] == 2.0
        agg.close()

    def test_offline_targets_hierarchy_from_published_region_map(self, tmp_path):
        from repro_torch.profilerd.server import OfflineSource, ProfileServer

        agg = mkagg(tmp_path, region="eu-west")
        agg.handle_push(
            headers_for("n1", **{H_TARGETS: "t0"}),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "f"))),
        )
        agg.seal_fleet_epoch(force=True)
        agg.publish()
        agg.close()
        srv = ProfileServer(OfflineSource(agg.out_dir), port=0).start()
        try:
            h = json.loads(
                urllib.request.urlopen(srv.url + "/targets", timeout=5).read()
            )
            assert h["region"] == "eu-west"
            assert [n["name"] for n in h["nodes"]] == ["n1"]
        finally:
            srv.stop()


class TestLiveness:
    def test_stall_and_recovery_events(self, tmp_path):
        agg = mkagg(tmp_path, stall_floor_s=0.0, stall_factor=0.0)
        agg.handle_push(
            headers_for("n1"), encode_push_body(K_FULL, EpochMeta(0), tree_of(("a",)))
        )
        agg.nodes["n1"].last_push_mono -= 10.0  # silence without sleeping
        agg.check_liveness()
        assert any(e["kind"] == NODE_STALLED for e in agg.events)
        assert agg.nodes["n1"].stalled
        agg.handle_push(
            headers_for("n1", epoch=1),
            encode_push_body(K_DELTA, EpochMeta(1), tree_of(("a",))),
        )
        assert not agg.nodes["n1"].stalled
        assert any(e["kind"] == NODE_RECOVERED for e in agg.events)
        agg.close()

    def test_done_nodes_never_stall(self, tmp_path):
        agg = mkagg(tmp_path, stall_floor_s=0.0, stall_factor=0.0)
        agg.handle_push(
            headers_for("n1", **{H_DONE: "1"}),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("a",))),
        )
        agg.nodes["n1"].last_push_mono -= 10.0
        agg.check_liveness()
        assert not any(e["kind"] == NODE_STALLED for e in agg.events)
        assert agg.status()["nodes"]["n1"]["state"] == "done"
        agg.close()


class TestPushClient:
    def _direct_post(self, agg, fail=None):
        """In-process delivery: the aggregator IS the endpoint (no sockets)."""

        def post(url, body, headers, timeout_s):
            if fail is not None and fail["on"]:
                raise OSError("connection refused")
            return agg.handle_push(headers, body)[0]

        return post

    def test_outage_spills_then_recovers_losslessly(self, tmp_path):
        agg = mkagg(tmp_path)
        fail = {"on": False}
        events = []
        client = PushClient(
            "127.0.0.1:1", "n1",
            post=self._direct_post(agg, fail), on_event=events.append,
            retry_base_s=0.0, retry_cap_s=0.0,
        )
        cum = CallTree()
        for e in range(3):
            cum.merge(tree_of(("main", f"f{e}")))
            client.push_epoch(cum.copy(), wall_time=float(e))
        fail["on"] = True
        for e in range(3, 6):
            cum.merge(tree_of(("main", f"f{e}")))
            client.push_epoch(cum.copy(), wall_time=float(e))
        assert [ev["kind"] for ev in events] == ["PUSH_FAILED"]  # one edge, not 3
        assert client.stats()["queue_epochs"] == 3
        fail["on"] = False
        cum.merge(tree_of(("main", "f6")))
        client.push_epoch(cum.copy(), wall_time=6.0)
        assert [ev["kind"] for ev in events] == ["PUSH_FAILED", "PUSH_RECOVERED"]
        assert client.stats()["queue_epochs"] == 0
        agg.seal_fleet_epoch(force=True)
        assert agg.fleet_tree().total() == cum.total()  # zero lost mass
        agg.close()

    def test_spill_overflow_drops_oldest_and_resyncs_by_keyframe(self, tmp_path):
        agg = mkagg(tmp_path)
        fail = {"on": True}
        client = PushClient(
            "127.0.0.1:1", "n1",
            post=self._direct_post(agg, fail),
            max_spill_bytes=256,  # tiny: a couple of bodies at most
            retry_base_s=0.0, retry_cap_s=0.0,
        )
        cum = CallTree()
        for e in range(20):
            cum.merge(tree_of(("main", f"fn_{e}")))
            client.push_epoch(cum.copy(), wall_time=float(e))
        stats = client.stats()
        # Bounded: drops happened and at most one body (the forced resync
        # keyframe, which may alone exceed the budget) rides over the limit.
        assert stats["dropped"] > 0
        assert stats["queue_epochs"] <= 2 or stats["queue_bytes"] <= 256
        fail["on"] = False
        cum.merge(tree_of(("main", "final")))
        client.push_epoch(cum.copy(), wall_time=99.0)  # forced K_FULL resync
        agg.seal_fleet_epoch(force=True)
        # Dropped deltas are subsumed by the replacement keyframe: the fleet
        # converges to the exact cumulative despite the losses.
        assert agg.fleet_tree().total() == cum.total()
        agg.close()

    def test_rejected_body_dropped_not_retried_forever(self, tmp_path):
        agg = mkagg(tmp_path, max_body_bytes=1)  # everything is oversized
        events = []
        client = PushClient(
            "127.0.0.1:1", "n1",
            post=self._direct_post(agg), on_event=events.append,
            retry_base_s=0.0, retry_cap_s=0.0,
        )
        client.push_epoch(tree_of(("main", "f")), wall_time=0.0)
        stats = client.stats()
        assert stats["rejected"] == 1 and stats["queue_epochs"] == 0
        assert [ev["kind"] for ev in events] == ["PUSH_REJECTED"]
        agg.close()

    def test_done_push_forces_flush_through_backoff(self, tmp_path):
        agg = mkagg(tmp_path)
        fail = {"on": True}
        client = PushClient(
            "127.0.0.1:1", "n1",
            post=self._direct_post(agg, fail),
            retry_base_s=3600.0, retry_cap_s=3600.0,  # backoff parks the queue
        )
        client.push_epoch(tree_of(("a",)), wall_time=0.0)
        fail["on"] = False
        client.push_epoch(tree_of(("a",), ("b",)), wall_time=1.0, done=True)
        assert client.stats()["queue_epochs"] == 0  # force bypassed the window
        assert agg.nodes["n1"].done
        agg.close()


class TestRestart:
    def test_restart_restores_mass_floor_and_ring_numbering(self, tmp_path):
        out = str(tmp_path / "region.d")
        agg = Aggregator(AggregatorConfig(out_dir=out))
        boot = "boot-a"
        cum = CallTree()
        for e in range(5):
            w = tree_of(("main", f"f{e}"))
            cum.merge(w)
            kind = K_FULL if e == 0 else K_DELTA
            body = encode_push_body(kind, EpochMeta(e), cum if e == 0 else w)
            assert agg.handle_push(headers_for("n1", boot=boot, epoch=e), body)[0] == 200
        agg.seal_fleet_epoch(force=True)
        mass = agg.fleet_tree().total()
        ring_epoch = agg.nodes["n1"].ring_epoch
        agg.close()  # simulated crash: no extra finalization beyond the 200s

        agg2 = Aggregator(AggregatorConfig(out_dir=out))
        assert any(e["kind"] == "AGGREGATOR_RESTORED" for e in agg2.events)
        node = agg2.nodes["n1"]
        assert node.boot == boot and node.floor == 4
        assert node.effective().total() == mass
        assert node.ring_epoch == ring_epoch  # monotonic, no reuse
        # The client (same boot) re-delivers an unacked epoch + a fresh one.
        dup = encode_push_body(K_DELTA, EpochMeta(4), tree_of(("main", "f4")))
        code, resp = agg2.handle_push(headers_for("n1", boot=boot, epoch=4), dup)
        assert code == 200 and resp["duplicate"]
        nxt = encode_push_body(K_DELTA, EpochMeta(5), tree_of(("main", "f5")))
        assert agg2.handle_push(headers_for("n1", boot=boot, epoch=5), nxt)[0] == 200
        agg2.seal_fleet_epoch(force=True)
        assert agg2.fleet_tree().total() == mass + 1.0
        # Fleet ring numbering also continued across the restart.
        epochs = [m.epoch for m, _w, _c in TimelineReader(agg2.cfg.timeline_dir()).epochs()]
        assert epochs == sorted(set(epochs)) and len(epochs) == 2
        agg2.close()

    def test_restart_without_sidecar_treats_history_as_base(self, tmp_path):
        out = str(tmp_path / "region.d")
        agg = Aggregator(AggregatorConfig(out_dir=out))
        agg.handle_push(
            headers_for("n1", boot="boot-a"),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "a"), w=3.0)),
        )
        agg.close()
        os.remove(os.path.join(out, "targets", "n1", "node.json"))
        agg2 = Aggregator(AggregatorConfig(out_dir=out))
        node = agg2.nodes["n1"]
        assert node.boot is None and node.effective().total() == 3.0
        # A known-boot client pushing now is a new incarnation on top.
        agg2.handle_push(
            headers_for("n1", boot="boot-a", epoch=0),
            encode_push_body(K_FULL, EpochMeta(0), tree_of(("main", "b"), w=2.0)),
        )
        assert agg2.nodes["n1"].effective().total() == 5.0
        agg2.seal_fleet_epoch(force=True)
        assert agg2.fleet_tree().total() == 5.0
        agg2.close()


@pytest.mark.slow
class TestFleetSoak:
    def test_three_nodes_thirty_epochs_with_mid_run_restart(self, tmp_path):
        """Nightly gate: zero lost epoch mass across a node restart.

        Three nodes push 30 epochs each through the real HTTP plane; node
        ``n1`` is "killed" at epoch 15 (its client vanishes, un-acked queue
        and all) and replaced by a fresh incarnation that re-reports its
        recovered local history as a keyframe — exactly what a restarted
        daemon's first push is.  The fleet total must equal the sum of every
        node's final cumulative: nothing lost, nothing double-counted.
        """
        agg = mkagg(tmp_path, epoch_s=0.05)
        url = agg.enable_serving().url
        cums = {f"n{i}": CallTree() for i in range(3)}
        clients = {name: PushClient(url, name, interval_hint_s=0.05) for name in cums}
        expected = {}
        for e in range(30):
            if e == 15:
                # n1 dies and restarts: new boot, epoch numbering from 0.
                # Its recovered state re-ships as the new client's first
                # keyframe; the dead incarnation's mass is already folded.
                expected["n1-inc0"] = cums["n1"].total()
                clients["n1"] = PushClient(url, "n1", interval_hint_s=0.05)
                cums["n1"] = CallTree()
            for name, cum in cums.items():
                cum.merge(tree_of(("main", name, f"e{e % 7}")))
                clients[name].push_epoch(
                    cum.copy(), wall_time=float(e), targets=[f"{name}-t0"],
                    done=(e == 29),
                )
            agg.seal_fleet_epoch(force=True)
        for name, cum in cums.items():
            expected[name] = cum.total()
        agg.seal_fleet_epoch(force=True)
        agg.publish()
        status = agg.status()
        assert status["fleet"]["mass"] == sum(expected.values())
        assert status["nodes"]["n1"]["incarnations"] == 1
        assert status["done"]  # every node's last push was done=1
        assert status["fleet"]["duplicates"] == 0
        # The published artifact agrees with the live status.
        disk = json.load(open(os.path.join(agg.out_dir, "status.json")))
        assert disk["fleet"]["mass"] == status["fleet"]["mass"]
        agg.close()


# -- cross-package parity: push bodies, and daemons pushing across packages ---

import shutil  # noqa: E402

import repro.core.calltree as jax_calltree  # noqa: E402
import repro.core.snapshot as jax_snapshot  # noqa: E402
import repro.profilerd.aggregator as jax_aggregator  # noqa: E402
import repro.profilerd.daemon as jax_daemon  # noqa: E402
import repro.profilerd.push as jax_push  # noqa: E402
import repro_torch.profilerd.aggregator as port_aggregator  # noqa: E402
import repro_torch.profilerd.daemon as port_daemon  # noqa: E402
from repro_torch.profilerd.spool import SpoolWriter  # noqa: E402
from repro_torch.profilerd.wire import Encoder, RawFrame, RawSample  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # keep property tests running where hypothesis is absent
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

_frame_st = st.sampled_from(["thread::Main", "train_step", "model", "a;b", "new\nline", "ünï ☃", "<&>", "", "x" * 40])


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(_frame_st, min_size=1, max_size=6), min_size=0, max_size=20),
       st.lists(st.integers(1, 1000), min_size=20, max_size=20), st.sampled_from([K_FULL, K_DELTA]),
       st.integers(0, 1 << 20))
def test_prop_push_bodies_equal_the_jax_packages(stacks, weights, kind, epoch):
    port, jax = CallTree(), jax_calltree.CallTree()
    for stack, w in zip(stacks, weights):
        port.add_stack(stack, {"samples": float(w), "flops": w * 1.5})
        jax.add_stack(stack, {"samples": float(w), "flops": w * 1.5})
    body = encode_push_body(kind, EpochMeta(epoch, 1234.5 + epoch, float(len(stacks))), port)
    assert body == jax_push.encode_push_body(kind, jax_snapshot.EpochMeta(epoch, 1234.5 + epoch, float(len(stacks))),
                                             jax)
    meta, tree = decode_push_body(body)  # the JAX package's bytes, read by the port, and back
    jax_meta, jax_tree = jax_push.decode_push_body(body)
    assert (meta.epoch, meta.wall_time, meta.progress, meta.kind) == \
        (jax_meta.epoch, jax_meta.wall_time, jax_meta.progress, jax_meta.kind) == \
        (epoch, 1234.5 + epoch, float(len(stacks)), kind)
    assert tree.to_json() == jax_tree.to_json() == port.to_json()


def _write_spool(path, n: int) -> None:
    """A finished target's spool: ``n`` ticks over three stacks, then BYE."""
    writer = SpoolWriter(str(path), capacity=1 << 20)
    enc = Encoder()
    writer.write(enc.encode_hello(4242, 0.01))
    leaves = ["attention", "mlp", "adamw"]
    for i in range(n):
        frames = [RawFrame("/fake/train.py", "main", 1), RawFrame("/fake/train.py", "train_step", 2),
                  RawFrame("/fake/model.py", leaves[i % 3], 3 + i % 3)]
        payload, _fresh = enc.encode_tick([RawSample(i * 0.01, 1, "MainThread", frames)])
        assert writer.write(payload)
    writer.write_bye(enc.encode_bye(n))
    writer.close()


def test_daemons_push_to_either_packages_aggregator_alike(tmp_path):
    """Each package's daemon drains a copy of one finished spool and pushes
    its sealed epochs to each package's aggregator: the four region trees,
    and the node's target lists, are equal. Masked: the boot id and the
    retry jitter, which reach no tree."""
    spool = tmp_path / "job.spool"
    _write_spool(spool, 60)
    trees, targets = {}, {}
    for dname, dmod in (("port", port_daemon), ("jax", jax_daemon)):
        for aname, amod in (("port", port_aggregator), ("jax", jax_aggregator)):
            case = tmp_path / f"{dname}-to-{aname}"
            case.mkdir()
            shutil.copy(spool, case / "job.spool")
            agg = amod.Aggregator(amod.AggregatorConfig(out_dir=str(case / "region.d"), region="r"))
            try:
                url = agg.enable_serving().url
                daemon = dmod.ProfilerDaemon(dmod.DaemonConfig(
                    spool_path=str(case / "job.spool"), out_dir=str(case / "job.d"), push_url=url,
                    push_node="n0", epoch_s=0.05, publish_interval_s=0.05, drain_interval_s=0.01,
                    max_seconds=20.0))
                assert daemon.run().total() == 60.0
                agg.seal_fleet_epoch(force=True)
                agg.publish()
                trees[dname, aname] = agg.fleet_tree().to_json()
                targets[dname, aname] = agg.status()["nodes"]["n0"]["targets"]
            finally:
                agg.close()
    assert trees[("port", "jax")] == trees[("jax", "jax")]
    assert trees[("jax", "port")] == trees[("port", "port")]
    assert trees[("port", "port")] == trees[("jax", "jax")]
    assert json.loads(trees[("port", "port")])["metrics"]["samples"] == 60.0
    assert set(map(tuple, targets.values())) == {("job",)}
