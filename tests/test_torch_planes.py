"""The port's merge layer (``repro_torch.core.planes``) with the H100 spec:
the core-plane tests of ``tests/test_planes.py`` (annotation, plane
selection) pointed at the port, and the merged plane of a real run: a host
tree sampled from the port's ``Trainer`` annotated with the device tree the
same job wrote.

The device tree of the core tests is the JAX package's, built from the same
hand-written HLO as ``tests/test_planes.py`` and read into the port's
``CallTree`` through its JSON: the two packages' trees share one format. The
server and export tests wait for the port's query plane.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")  # the card's machine has no JAX (the core tests read the JAX package's HLO tree)

from repro.core.hlo_tree import build_device_tree as jax_build_device_tree  # noqa: E402
from repro_torch.core.calltree import CallTree  # noqa: E402
from repro_torch.core.device_tree import load_device_tree  # noqa: E402
from repro_torch.core.planes import (  # noqa: E402
    DOMINANT_PREFIX,
    HLO_PREFIX,
    OCCUPANCY,
    PLANES,
    PlaneError,
    annotate_tree,
    default_metric,
    dominant_term,
    missing_device_hint,
    select_plane,
)
from repro_torch.core.roofline import H100, report_from_tree  # noqa: E402
from repro_torch.launch.train import Trainer, TrainJobConfig  # noqa: E402

# tests/test_planes.py's HLO: scores/gate_proj are compute-heavy dots, top_p
# a pure-traffic slice, lm_head carries an all-reduce -> three dominant terms
HLO_TEXT = """HloModule m
ENTRY %main (p0: f32[4096,4096], p1: f32[4096,4096], p2: f32[4096,4096]) -> f32[4096,4096] {
  %p0 = f32[4096,4096]{1,0} parameter(0)
  %p1 = f32[4096,4096]{1,0} parameter(1)
  %p2 = f32[4096,4096]{1,0} parameter(2)
  %scores = f32[4096,4096]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(serve_step)/model/attention/scores"}
  %context = f32[4096,4096]{1,0} dot(%scores, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(serve_step)/model/attention/context"}
  %gate = f32[4096,4096]{1,0} dot(%scores, %context), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(serve_step)/model/mlp/gate_proj"}
  %hs = f32[64,64]{1,0} dynamic-slice(%gate, %p0), dynamic_slice_sizes={64,64}, metadata={op_name="jit(serve_step)/model/lm_head"}
  %head = f32[64,64]{1,0} dot(%hs, %hs), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(serve_step)/model/lm_head"}
  %ar = f32[4096,4096]{1,0} all-reduce(%p2), metadata={op_name="jit(serve_step)/model/lm_head"}
  %tp = f32[1,64]{1,0} dynamic-slice(%gate, %p0), dynamic_slice_sizes={1,64}, metadata={op_name="jit(serve_step)/sampler/top_p"}
  ROOT %out = f32[4096,4096]{1,0} copy(%ar), metadata={op_name="jit(serve_step)/out"}
}
"""


def device_tree() -> CallTree:
    return CallTree.from_json(jax_build_device_tree(HLO_TEXT).to_json())


def host_tree() -> CallTree:
    """A daemon-shaped host tree: frames carry spool origin prefixes."""
    t = CallTree()
    stacks = [
        (["thread::MainThread", "py::serve_step", "py::model", "py::attention", "py::scores"], 40),
        (["thread::MainThread", "py::serve_step", "py::model", "py::attention", "py::context"], 10),
        (["thread::MainThread", "py::serve_step", "py::model", "py::mlp", "py::gate_proj"], 30),
        (["thread::MainThread", "py::serve_step", "py::model", "py::lm_head"], 15),
        (["thread::MainThread", "py::serve_step", "py::sampler", "py::top_p"], 5),
    ]
    for frames, n in stacks:
        for _ in range(n):
            t.add_stack(frames)
    return t


def _descend(tree: CallTree, *names):
    node = tree.root
    for n in names:
        node = node.children[n]
    return node


class TestAnnotate:
    def test_default_spec_is_the_h100(self):
        merged = annotate_tree(host_tree(), device_tree())
        scores = _descend(merged, "thread::MainThread", "py::serve_step", "py::model", "py::attention", "py::scores")
        assert scores.metrics["rt_compute"] == pytest.approx(scores.metrics[HLO_PREFIX + "flops"] / 989e12)
        assert scores.metrics["rt_memory"] == pytest.approx(scores.metrics[HLO_PREFIX + "bytes"] / 3.35e12)
        assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == (989e12, 3.35e12, 80e9)

    def test_origin_prefixes_match_device_paths(self):
        merged = annotate_tree(host_tree(), device_tree())
        scores = _descend(
            merged, "thread::MainThread", "py::serve_step", "py::model", "py::attention", "py::scores"
        )
        dev_scores = _descend(device_tree(), "jit(serve_step)", "model", "attention", "scores")
        assert scores.metrics[HLO_PREFIX + "flops"] == dev_scores.total("flops")
        assert scores.metrics[OCCUPANCY] > 0

    def test_root_occupancy_is_one(self):
        merged = annotate_tree(host_tree(), device_tree())
        assert merged.root.metrics[OCCUPANCY] == pytest.approx(1.0)

    def test_unmatched_glue_frames_inherit_child_sums(self):
        merged = annotate_tree(host_tree(), device_tree())
        main = _descend(merged, "thread::MainThread")
        child_flops = sum(c.metrics.get(HLO_PREFIX + "flops", 0) for c in main.children.values())
        assert main.metrics[HLO_PREFIX + "flops"] == pytest.approx(child_flops)
        assert main.metrics[HLO_PREFIX + "flops"] > 0

    def test_dominant_terms_by_workload_shape(self):
        merged = annotate_tree(host_tree(), device_tree())
        pre = ("thread::MainThread", "py::serve_step")
        scores = _descend(merged, *pre, "py::model", "py::attention", "py::scores")
        top_p = _descend(merged, *pre, "py::sampler", "py::top_p")
        lm_head = _descend(merged, *pre, "py::model", "py::lm_head")
        assert dominant_term(scores.metrics) == "compute"  # dot-only node
        assert dominant_term(top_p.metrics) == "memory"  # pure-slice node
        assert dominant_term(lm_head.metrics) == "collective"  # all-reduce over NVLink's 18 links
        for node in (scores, top_p, lm_head):
            assert sum(1 for k in node.metrics if k.startswith(DOMINANT_PREFIX)) == 1

    def test_annotations_survive_json_roundtrip(self):
        merged = annotate_tree(host_tree(), device_tree())
        back = CallTree.from_json(merged.to_json())
        for (path, node), (bpath, bnode) in zip(merged.root.walk(), back.root.walk(), strict=True):
            assert tuple(path) == tuple(bpath)
            assert dict(node.metrics) == dict(bnode.metrics)

    def test_host_tree_not_mutated(self):
        host = host_tree()
        before = host.to_json()
        annotate_tree(host, device_tree())
        assert host.to_json() == before


class TestSelectPlane:
    def test_planes(self):
        assert PLANES == ("host", "device", "merged", "static")

    def test_host_passthrough(self):
        host = host_tree()
        assert select_plane(host, None, "host") is host

    def test_device_passthrough_and_merged(self):
        host, device = host_tree(), device_tree()
        assert select_plane(host, device, "device") is device
        merged = select_plane(host, device, "merged")
        assert merged.root.metrics[OCCUPANCY] == pytest.approx(1.0)

    def test_unknown_plane_is_value_error(self):
        with pytest.raises(ValueError, match="unknown plane"):
            select_plane(host_tree(), None, "bogus")

    def test_missing_device_artifact_raises_with_remedy(self):
        for plane in ("device", "merged"):
            with pytest.raises(PlaneError, match="device_tree.json"):
                select_plane(host_tree(), None, plane, profile="/some/profile")
        hint = missing_device_hint("/some/profile")
        assert "repro_torch.launch.train" in hint and "/some/profile" in hint

    def test_missing_static_artifact_raises(self):
        with pytest.raises(PlaneError, match="static_tree.json"):
            select_plane(host_tree(), None, "static")

    def test_device_default_metric_is_flops(self):
        assert default_metric("device", None) == "flops"
        assert default_metric("device", "bytes") == "bytes"
        assert default_metric("merged", None) is None
        assert default_metric("host", None) is None


def test_roofline_report_of_a_tree():
    tree = device_tree()
    rep = report_from_tree(arch="a", shape="s", device_tree=tree, measured_step_s=1e-3, model_flops_global=1e9)
    assert rep.flops_per_device == tree.total("flops")
    assert rep.t_compute == pytest.approx(tree.total("flops") / 989e12)
    assert rep.t_step == max(rep.t_compute, rep.t_memory, rep.t_collective)
    assert rep.bound_share == pytest.approx(rep.t_step / 1e-3)
    row = rep.row()
    assert row["measured_step_s"] == 1e-3 and row["dominant"] == rep.dominant


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's Trainer at qwen3-4b smoke on the CPU, its sampler fast: ->
    (the sampled host tree, the device tree the job wrote)."""
    out = tmp_path_factory.mktemp("job")
    job = TrainJobConfig(arch="qwen3-4b", device="cpu", steps=6, global_batch=2, seq_len=64, out_dir=str(out),
                         sample_period_s=0.001, resume=False, ckpt_every=100)
    trainer = Trainer(job)
    host = None
    orig_stop = trainer.sampler.stop

    def stop():  # keep the sampled tree the trainer reports from
        nonlocal host
        host = orig_stop()
        return host

    trainer.sampler.stop = stop
    trainer.run()
    return host, load_device_tree(str(out / "device_tree.json"))


def test_merged_plane_of_a_trainer_run(trained):
    """The host frames named after the port's functions carry the device
    plane's cost: ``attention`` and ``mlp`` (the model's modules),
    ``flash_attention`` and ``fused_rmsnorm`` (the kernel wrappers), whichever
    the sampler caught; the modules and the attention kernel do dots."""
    host, device = trained
    merged = annotate_tree(host, device)
    frames = {}
    for _, node in merged.root.walk():
        name = node.name.partition("::")[2]
        if name in ("attention", "mlp", "flash_attention", "fused_rmsnorm"):
            frames.setdefault(name, []).append(node.metrics)
    assert {"attention", "mlp"} <= set(frames), sorted(frames)
    for name, metrics in frames.items():
        assert all(m.get(HLO_PREFIX + "bytes", 0) > 0 for m in metrics), name
        if name != "fused_rmsnorm":
            assert all(m.get(HLO_PREFIX + "flops", 0) > 0 for m in metrics), name
    assert merged.root.metrics[OCCUPANCY] == pytest.approx(1.0)
