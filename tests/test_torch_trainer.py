"""The port's Trainer and its substrate on the CPU: tests/test_train_serve.py's
TestTrainer cases on ``--device cpu``, tests/test_substrate.py's TestData and
TestCheckpoint cases against the port's copies (plus the bf16 round trip and
the data the JAX package's pipeline makes), the CLI, the host plane, and the
device plane the trainer writes (``device_tree.json``) with the gated scopes
that key it."""

import json
import os
import threading

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # keep property tests running where hypothesis is absent
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import AnomalyEvent, Rule, SamplerConfig, load_device_tree, make_sampler
from repro_torch.core import scope as scope_module
from repro_torch.data import DataConfig, Pipeline, SyntheticLM
from repro_torch.launch import steps as steps_module
from repro_torch.launch.train import Trainer, TrainJobConfig, main


def job(tmp_path, **kw):
    base = dict(
        arch="qwen3-4b",
        smoke=True,
        device="cpu",
        steps=6,
        global_batch=4,
        seq_len=32,
        lr=1e-2,
        out_dir=str(tmp_path),
        ckpt_every=3,
        profile=True,
        sample_period_s=0.05,
        resume=True,
    )
    base.update(kw)
    return TrainJobConfig(**base)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


class TestTrainer:
    def test_loss_decreases_and_artifacts_written(self, tmp_path):
        summary = Trainer(job(tmp_path, steps=8)).run()
        assert summary["steps"] == 8 and summary["device"] == "cpu"
        assert summary["final_loss"] < summary["first_loss"]
        assert os.path.exists(tmp_path / "metrics.json")
        assert os.path.exists(tmp_path / "heartbeat")
        # host-plane profile written (the always-on toolchain)
        assert os.path.exists(tmp_path / "host_profile.html")

    def test_profile_writes_a_loadable_device_tree(self, tmp_path, monkeypatch):
        """With ``profile`` on, the run's second step is profiled and its tree
        written to out_dir and to ``$REPRO_PROFILERD_OUT``, in the JAX
        package's schema with its meta; with it off, nothing is written."""
        daemon_dir = tmp_path / "daemon"
        monkeypatch.setenv("REPRO_PROFILERD_OUT", str(daemon_dir))
        Trainer(job(tmp_path / "on", steps=3)).run()
        for path in (tmp_path / "on" / "device_tree.json", daemon_dir / "device_tree.json"):
            with open(path) as f:
                doc = json.load(f)
            assert doc["schema"] == "repro-device-tree/v1"
            assert doc["meta"] == {"arch": "qwen3-4b-smoke", "source": "train"}
            tree = load_device_tree(str(path))
            assert tree.total("flops") > 0 and tree.total("bytes") > 0
            assert set(tree.root.children["train_step"].children) >= {"fwd_bwd", "optimizer"}
            assert set(tree.root.children["train_step"].children["fwd_bwd"].children) >= {
                "jvp(loss)", "transpose(jvp(loss))"}
        monkeypatch.delenv("REPRO_PROFILERD_OUT")
        Trainer(job(tmp_path / "off", steps=3, profile=False)).run()
        assert not (tmp_path / "off" / "device_tree.json").exists()

    def test_a_one_step_run_profiles_its_step(self, tmp_path):
        Trainer(job(tmp_path, steps=1)).run()
        assert load_device_tree(str(tmp_path / "device_tree.json")).total("flops") > 0

    @pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-125m"])
    def test_the_profiled_step_is_a_step_of_the_run(self, tmp_path, arch):
        """The device-plane dump adds no step and keeps the profiled step's
        result: a job with it and one without reach the same parameters,
        optimizer state and data position, bit for bit, and the same losses."""
        a, b = tmp_path / "a", tmp_path / "b"
        ta = Trainer(job(a, arch=arch, steps=4, ckpt_every=100, profile=True))
        ta.run()
        tb = Trainer(job(b, arch=arch, steps=4, ckpt_every=100, profile=False))
        tb.run()
        assert (a / "device_tree.json").exists() and not (b / "device_tree.json").exists()
        assert ta.step == tb.step == 4 and ta.data.next_step == tb.data.next_step == 4
        for (pa, x), (pb, y) in zip(_flat(ta._state_tree()), _flat(tb._state_tree())):
            assert pa == pb and np.array_equal(np.asarray(x), np.asarray(y)), pa
        assert [m["loss"] for m in ta.metrics_log] == [m["loss"] for m in tb.metrics_log]

    def test_checkpoint_resume_exact(self, tmp_path):
        t1 = Trainer(job(tmp_path, steps=6))
        t1.run()
        # second run continues from the step 6 checkpoint, runs to 9
        t2 = Trainer(job(tmp_path, steps=9))
        t2.run()
        assert t2.step == 9
        with open(tmp_path / "metrics.json") as f:
            log = json.load(f)
        assert [m["step"] for m in log["steps"]] == [7, 8, 9]

    @pytest.mark.parametrize("arch,k,n", [("qwen3-4b", 5, 10), ("recurrentgemma-9b", 3, 6), ("deepseek-moe-16b", 3, 6)])
    def test_resume_reproduces_uninterrupted_run(self, tmp_path, arch, k, n):
        """train(k) + resume(n - k) == train(n): the loss curve, and the
        parameters and optimizer state at the end, bit for bit."""
        a, b = tmp_path / "a", tmp_path / "b"
        Trainer(job(a, arch=arch, steps=k, ckpt_every=k, profile=False)).run()
        ta = Trainer(job(a, arch=arch, steps=n, ckpt_every=k, profile=False))
        ta.run()
        tb = Trainer(job(b, arch=arch, steps=n, ckpt_every=n, profile=False))
        tb.run()
        with open(a / "metrics.json") as f:
            la = {m["step"]: m["loss"] for m in json.load(f)["steps"]}
        with open(b / "metrics.json") as f:
            lb = {m["step"]: m["loss"] for m in json.load(f)["steps"]}
        assert sorted(la) == list(range(k + 1, n + 1))
        for s in la:
            assert la[s] == pytest.approx(lb[s], rel=1e-4), f"divergence at step {s}"
        for (pa, x), (pb, y) in zip(_flat(ta._state_tree()), _flat(tb._state_tree())):
            assert pa == pb and np.array_equal(np.asarray(x), np.asarray(y)), pa

    def test_watchdog_takes_an_emergency_checkpoint(self, tmp_path):
        """An extra rule that every window meets fires the warn -> emergency
        checkpoint flow."""
        rule = Rule(pattern="thread::", threshold=0.0, consecutive=1, min_window_total=1, self_only=False,
                    kind="TEST_RULE")
        trainer = Trainer(job(tmp_path, steps=40, ckpt_every=100, extra_rules=[rule], sample_period_s=0.02))
        summary = trainer.run()
        assert any("TEST_RULE" in a for a in summary["anomalies"])
        tags = [json.load(open(tmp_path / "ckpt" / d / "manifest.json"))["tag"]
                for d in os.listdir(tmp_path / "ckpt") if d.startswith("step_") and not d.endswith(".tmp")]
        assert "emergency" in tags

    def test_emergency_checkpoint_fired_mid_step_holds_a_whole_step(self, tmp_path, monkeypatch):
        """The detector fires on the watchdog's thread while a step is running,
        after AdamW has updated the parameters and moments in place but before
        the Trainer counts the step: the emergency checkpoint holds one whole
        step, equal to the state of an uninterrupted run at that step."""
        a, b = tmp_path / "a", tmp_path / "b"
        trainer = Trainer(job(a, steps=3, ckpt_every=100, profile=False))
        real_update = steps_module.adamw_update

        def update_then_fire(grads, opt_state, params, **kw):
            out = real_update(grads, opt_state, params, **kw)
            if int(opt_state["step"]) == 2:  # the second step, its update applied
                event = AnomalyEvent("TEST_RULE", ("thread::x",), 1.0, Rule(), 0)
                watchdog = threading.Thread(target=trainer._on_anomaly, args=(event,))
                watchdog.start()
                watchdog.join()
            return out

        monkeypatch.setattr(steps_module, "adamw_update", update_then_fire)
        trainer.run()
        ckpt = CheckpointManager(str(a / "ckpt"))
        emergency = [s for s in ckpt.list_steps() if ckpt.restore(s)[1]["tag"] == "emergency"]
        assert emergency == [2]
        tree, _ = ckpt.restore(2)
        monkeypatch.setattr(steps_module, "adamw_update", real_update)
        whole = Trainer(job(b, steps=2, ckpt_every=100, profile=False))
        whole.run()
        assert int(tree["opt"]["step"]) == 2
        for (pa, x), (pb, y) in zip(_flat(tree), _flat(whole._state_tree())):
            assert pa == pb and np.array_equal(np.asarray(x), np.asarray(y)), pa

    def test_emergency_checkpoint_is_taken_during_a_data_stall(self, tmp_path):
        """The training thread stalls in the data pipeline before step 3 while
        the detector fires (the INPUT_STARVATION case): the checkpoint of step
        2 is on disk during the stall, not after it, and resumes exactly."""
        a, b = tmp_path / "a", tmp_path / "b"
        trainer = Trainer(job(a, steps=3, ckpt_every=100, profile=False))
        real_next, seen = type(trainer.data).__next__, []

        class StallingPipeline(type(trainer.data)):
            def __next__(self):
                if self.next_step == 2:  # the third batch: steps 1 and 2 are done
                    event = AnomalyEvent("INPUT_STARVATION", ("thread::_prefetch_worker",), 0.9, Rule(), 0)
                    watchdog = threading.Thread(target=trainer._on_anomaly, args=(event,))
                    watchdog.start()
                    watchdog.join(timeout=60)
                    assert not watchdog.is_alive()
                    ckpt = CheckpointManager(str(a / "ckpt"))
                    seen.append([(s, ckpt.restore(s)[1]["tag"]) for s in ckpt.list_steps()])
                return real_next(self)

        trainer.data.__class__ = StallingPipeline
        trainer.run()
        assert seen == [[(2, "emergency")]]
        tree, _ = CheckpointManager(str(a / "ckpt")).restore(2)
        whole = Trainer(job(b, steps=2, ckpt_every=100, profile=False))
        whole.run()
        assert int(tree["data"]["next_step"]) == 2
        for (pa, x), (pb, y) in zip(_flat(tree), _flat(whole._state_tree())):
            assert pa == pb and np.array_equal(np.asarray(x), np.asarray(y)), pa

    def test_a_stall_saves_its_step_once(self, tmp_path):
        """The detector fires about once a window while the data stalls: the
        first firing saves the step, the later ones find it saved and write
        nothing (the state has not moved); the next step is saved again."""
        trainer = Trainer(job(tmp_path, steps=3, ckpt_every=100, profile=False))
        real_next, saved = type(trainer.data).__next__, []
        real_save = trainer.ckpt.save_emergency
        trainer.ckpt.save_emergency = lambda step_fn, event: saved.append(step_fn()[0]) or real_save(step_fn, event)

        class StallingPipeline(type(trainer.data)):
            def __next__(self):
                if self.next_step in (1, 2):
                    for _ in range(3):
                        event = AnomalyEvent("INPUT_STARVATION", ("thread::_prefetch_worker",), 0.9, Rule(), 0)
                        watchdog = threading.Thread(target=trainer._on_anomaly, args=(event,))
                        watchdog.start()
                        watchdog.join(timeout=60)
                        assert not watchdog.is_alive()
                return real_next(self)

        trainer.data.__class__ = StallingPipeline
        trainer.run()
        assert saved == [1, 2] and len(trainer.anomalies) == 6
        assert CheckpointManager(str(tmp_path / "ckpt")).list_steps() == [1, 2, 3]

    @pytest.mark.parametrize("arch,steps", [("qwen3-4b", 5), ("recurrentgemma-9b", 20), ("deepseek-moe-16b", 20),
                                            ("xlstm-125m", 20)])
    def test_cli_on_the_cpu(self, tmp_path, arch, steps):
        """``python -m repro_torch.launch.train --arch <arch> --device cpu --steps <steps>``.
        The hybrid's smoke model starts at the uniform loss (ln 256, its tied
        embedding's logits are ~0.6 at most) and falls slowly under the CLI's
        warm-up: 5.544 to 5.548 after 5 steps, 5.529 after 20. The MoE smoke
        model's loss (with 1e-2 x its load-balance term) moves by 0.08 from step
        to step on fresh batches: 5.326 to 5.324 after 10 steps, 5.156 after 20.
        xlstm-125m, the CLI's default arch: 5.375 to 5.063 after 20 steps."""
        main(["--arch", arch, "--device", "cpu", "--steps", str(steps), "--out", str(tmp_path), "--no-resume"])
        with open(tmp_path / "metrics.json") as f:
            summary = json.load(f)["summary"]
        assert summary["steps"] == steps and summary["final_loss"] < summary["first_loss"]

    def test_cli_defaults_to_the_jax_trainers_arch(self, tmp_path):
        """``TrainJobConfig`` and the CLI default to xlstm-125m's smoke config,
        as ``repro.launch.train`` does."""
        assert TrainJobConfig().arch == "xlstm-125m"
        main(["--device", "cpu", "--steps", "2", "--out", str(tmp_path), "--no-resume"])
        with open(tmp_path / "metrics.json") as f:
            assert json.load(f)["summary"]["arch"] == "xlstm-125m-smoke"

    def test_daemon_backend_is_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(job(tmp_path, profile_backend="daemon"))


class TestData:
    def cfg(self, **kw):
        return DataConfig(vocab=97, seq_len=32, global_batch=8, **kw)

    def test_deterministic_and_resumable(self):
        ds = SyntheticLM(self.cfg())
        b1, b2 = ds.batch(7), ds.batch(7)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(ds.batch(8)["tokens"], b1["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = SyntheticLM(self.cfg()).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_batch(self):
        shards = [SyntheticLM(self.cfg(n_hosts=4, host_id=h)).batch(3)["tokens"] for h in range(4)]
        assert all(s.shape[0] == 2 for s in shards)
        assert not np.array_equal(shards[0], shards[1])

    def test_tokens_in_vocab(self):
        b = SyntheticLM(self.cfg()).batch(1)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 97

    def test_pipeline_prefetch_and_state(self):
        pipe = Pipeline(SyntheticLM(self.cfg()), prefetch=2)
        next(pipe)
        b = next(pipe)
        assert pipe.state_dict()["next_step"] == 2
        pipe.load_state_dict({"next_step": 1})
        np.testing.assert_array_equal(b["tokens"], next(pipe)["tokens"])
        pipe.close()

    @settings(max_examples=20, deadline=None)
    @given(st.integers(min_value=0, max_value=1000), st.integers(min_value=0, max_value=1000))
    def test_prop_distinct_steps_distinct_batches(self, s1, s2):
        ds = SyntheticLM(self.cfg())
        t1, t2 = ds.batch(s1)["tokens"], ds.batch(s2)["tokens"]
        assert np.array_equal(t1, t2) == (s1 == s2)

    @pytest.mark.parametrize("step", [0, 5])
    def test_batches_equal_the_jax_packages(self, step):
        jdata = pytest.importorskip("repro.data")
        kw = dict(vocab=151_936, seq_len=64, global_batch=2, seed=3)
        want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step)
        got = SyntheticLM(DataConfig(**kw)).batch(step)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


class TestCheckpoint:
    def tree(self, scale=1.0):
        return {
            "params": {"w": torch.full((4, 4), scale), "b": torch.arange(3, dtype=torch.int32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "data": {"next_step": np.asarray(12)},
        }

    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, self.tree(), blocking=True)
        step, tree, manifest = mgr.restore_latest()
        assert step == 5 and manifest["tag"] == "periodic"
        assert torch.equal(tree["params"]["w"], self.tree()["params"]["w"])
        assert torch.equal(tree["params"]["b"], self.tree()["params"]["b"])
        assert tree["opt"]["step"].dtype == torch.int32 and int(tree["opt"]["step"]) == 7
        assert int(tree["data"]["next_step"]) == 12

    def test_bf16_roundtrips_bit_for_bit(self, tmp_path):
        x = torch.randn(5, 7).bfloat16()
        x[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])  # inf, signed zero, a subnormal
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": x, "m": x.float()}, blocking=True)
        _, tree, manifest = mgr.restore_latest()
        assert manifest["leaves"]["x"]["dtype"] == "bfloat16" and manifest["leaves"]["m"]["dtype"] == "float32"
        assert tree["x"].dtype == torch.bfloat16
        assert torch.equal(tree["x"].view(torch.int16), x.view(torch.int16))
        assert torch.equal(tree["m"], x.float())

    def test_save_copies_before_returning(self, tmp_path):
        """The train loop may update its tensors in place as soon as an async
        save returns."""
        mgr = CheckpointManager(str(tmp_path))
        t = self.tree()
        mgr.save(1, t)
        t["params"]["w"].add_(100.0)
        mgr.wait()
        _, tree, _ = mgr.restore_latest()
        assert torch.equal(tree["params"]["w"], self.tree()["params"]["w"])

    def test_async_save_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self.tree(1.0))
        mgr.wait()
        assert mgr.list_steps() == [1]

    def test_keep_policy_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self.tree(s), blocking=True)
        assert mgr.list_steps() == [3, 4]

    @pytest.mark.parametrize("saves,want", [
        ([(2, "emergency")] * 4, [2]),
        ([(4, "periodic"), (4, "emergency"), (6, "periodic"), (8, "periodic")], [4, 6, 8]),
    ])
    def test_keep_counts_steps_not_saves(self, tmp_path, saves, want):
        """A step saved more than once counts once: its directory is never
        deleted while the manager still keeps it."""
        mgr = CheckpointManager(str(tmp_path), keep=3)
        ev = AnomalyEvent("LIVELOCK_SUSPECT", ("a",), 0.97, Rule(), 0)
        for step, tag in saves:
            if tag == "emergency":
                mgr.save_emergency(lambda step=step: (step, self.tree(step)), ev)
            else:
                mgr.save(step, self.tree(step), blocking=True)
        assert mgr.list_steps() == want and mgr.saved_steps == want
        assert mgr.restore_latest()[0] == want[-1]

    def test_crash_safe_tmp_never_restored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self.tree(), blocking=True)
        os.makedirs(tmp_path / "step_0000000002.tmp")  # simulated crashed save
        step, _, _ = mgr.restore_latest()
        assert step == 1

    def test_emergency_tagging(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        ev = AnomalyEvent("LIVELOCK_SUSPECT", ("a", "b"), 0.97, Rule(), 3)
        mgr.save_emergency(lambda: (9, self.tree()), ev)
        _, _, manifest = mgr.restore_latest()
        assert manifest["tag"] == "emergency"
        assert manifest["extra"]["anomaly"]["share"] == pytest.approx(0.97)


def test_sampler_records_this_thread():
    sampler = make_sampler(SamplerConfig(period_s=0.01))
    sampler.sample_now()
    tree = sampler.stop()
    assert tree.total() >= 1
    assert any("test_sampler_records_this_thread" in "/".join(p) for p in tree.shares())


def test_scope_enters_no_range_while_no_profiler_records(monkeypatch):
    """``scope`` is the counterpart of ``jax.named_scope``: a profiler range
    only while a profiler records, else a shared no-op context; a model's
    forward enters none without a profiler and one per scope site under one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    entered = []
    real = scope_module.record_function
    monkeypatch.setattr(scope_module, "record_function", lambda name: entered.append(name) or real(name))
    assert not scope_module.recording()
    assert scope_module.scope("a") is scope_module.scope("b")
    model = Model(get_config("qwen3-4b", smoke=True), device="cpu")
    params = model.init()
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        model.forward(params, {"tokens": tokens})
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert scope_module.recording()
        with torch.no_grad():
            model.forward(params, {"tokens": tokens})
    assert {"model", "layers", "attention", "qkv_proj", "flash_attention", "mlp", "up_proj", "fused_rmsnorm",
            "final_norm", "lm_head", "embed"} <= set(entered)
