"""The port's examples (``repro_torch.examples``) run end to end on the CPU
at smoke size, each in a subprocess as a user runs it (``--device cpu``
where it runs a model; ``live_flamegraph`` runs none), every artifact
under the test's temporary directory. ``hang_detection`` and
``serve_batched`` assert on their own output, as the JAX package's do;
``train_100m`` asserts that its loss fell (a short segment: 6 steps of
B 2 x S 32)."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

CASES = {
    "quickstart": ["--device", "cpu", "--out", "{tmp}/qs"],
    "serve_batched": ["--device", "cpu"],
    "train_100m": ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "32", "--out", "{tmp}/t"],
    "hang_detection": ["--device", "cpu", "--out", "{tmp}/hang"],
    "live_flamegraph": [],
}
# what each prints when it has done its work
MARKERS = {
    "quickstart": ["=== device-plane FLOPs breakdown", "step 7: loss=", "device_profile.html"],
    "serve_batched": ['"requests_done": 12', "host-plane breakdown of the serving loop"],
    "train_100m": ['"final_loss"', '"device": "cpu"'],
    "hang_detection": [">>> injecting livelock", "resumed and ran to step", "TARGET_STALLED"],
    "live_flamegraph": ["live query plane: http://", "flamegraph.html"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = [a.format(tmp=tmp_path) for a in CASES[name]]
    # one intra-op thread: the smoke models are small, and the suite's other
    # workers share the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for marker in MARKERS[name]:
        assert marker in out.stdout, (marker, out.stdout[-3000:])
    if name == "quickstart":
        assert (tmp_path / "qs" / "host_profile.html").exists() and (tmp_path / "qs" / "device_profile.html").exists()
