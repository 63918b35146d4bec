"""The port's figure benchmarks (``repro_torch.benchmarks``) on the CPU, at
smoke size: their rows carry the JAX package's names and keys
(``benchmarks/*.py``), and the four host-only benchmarks write the JAX
package's JSON sections, key for key, only where ``--out`` points.

overhead's rows are held to rows the JAX module prints in this test (the
workload cut to 0.1 s in both packages); fig01's, fig02's and fig10_12's to
the names and keys the JAX modules write (their JAX runs compile the smoke
models for tens of seconds).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
HOST_ONLY = ["ingest_throughput", "aggregate_throughput", "annotate_overhead", "timeline_overhead"]


def _parse(row: str) -> tuple[str, float, dict]:
    name, us, derived = row.split(",", 2)
    return name, float(us), dict(kv.split("=", 1) for kv in derived.split(";")) if "=" in derived else {}


def test_fig01_rows_have_the_jax_names():
    pytest.importorskip("jax")
    from repro.core import engines as jax_engines
    from repro_torch.benchmarks import fig01_engines

    rows = [_parse(r) for r in fig01_engines.main(["--device", "cpu"])]
    # the JAX benchmark's engines, in its order; its derived keys are
    # tokens_per_s and jax_frame_share
    names = [f"fig01_engine_{e.name}" for e in (jax_engines.EagerEngine, jax_engines.BlockwiseEngine,
                                                 jax_engines.CompiledEngine)]
    assert [r[0] for r in rows] == names
    for _, us, derived in rows:
        assert us > 0 and set(derived) == {"tokens_per_s", "torch_frame_share"}
        assert 0 <= float(derived["torch_frame_share"]) <= 1 and float(derived["tokens_per_s"]) > 0


def test_fig02_row():
    from repro_torch.benchmarks import fig02_stack_depth

    (name, n_samples, derived), = [_parse(r) for r in fig02_stack_depth.main(["--device", "cpu"])]
    assert name == "fig02_stack_depth" and n_samples > 0
    assert set(derived) == {"min", "max", "mean", "swing"}
    assert int(derived["swing"]) == int(derived["max"]) - int(derived["min"]) >= 0


def test_fig10_12_rows():
    from repro_torch.benchmarks import fig10_12_zoom

    attn, moe = (_parse(r) for r in fig10_12_zoom.main(["--device", "cpu"]))
    assert attn[0] == "fig10_zoom_attention_qwen3" and moe[0] == "fig12_zoom_moe_deepseek"
    # the flash kernel's range stands where the JAX xla path has scores and pv
    assert set(attn[2]) == {"qkv_proj", "flash_attention", "out_proj"}
    assert set(moe[2]) == set(fig10_12_zoom.MOE_PARTS)
    for _, _, shares in (attn, moe):
        assert sum(float(v) for v in shares.values()) == pytest.approx(1.0, abs=0.03)


def test_overhead_rows_match_the_jax_rows(monkeypatch):
    jax_overhead = pytest.importorskip("benchmarks.overhead")
    from repro_torch.benchmarks import overhead

    for mod in (jax_overhead, overhead):
        short = mod.workload
        monkeypatch.setattr(mod, "workload", lambda seconds=0.1, f=short: f(seconds))
    rows = [_parse(r) for r in overhead.main()]
    want = [_parse(r) for r in jax_overhead.main()]
    assert [(n, us) for n, us, _ in rows] == [(n, us) for n, us, _ in want]
    for (_, _, derived), (_, _, jax_derived) in zip(rows, want):
        assert set(derived) == set(jax_derived)
        assert int(derived["thread_samples"]) >= 0 and int(derived["daemon_samples"]) >= 0


def _sections(doc: dict) -> dict:
    """Each top-level key, with the keys of its section where it is one (of
    its first result where it is a list of them)."""
    def keys(v):
        if isinstance(v, dict):
            return sorted(v)
        if isinstance(v, list) and v and isinstance(v[0], dict):
            return sorted(v[0])
        return type(v).__name__
    return {k: keys(v) for k, v in doc.items()}


def test_host_only_benchmarks_write_the_jax_sections(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    for name in HOST_ONLY:
        for cmd, out in (([sys.executable, "-m", f"repro_torch.benchmarks.{name}"], port_out),
                         ([sys.executable, str(ROOT / "benchmarks" / f"{name}.py")], jax_out)):
            r = subprocess.run([*cmd, "--smoke", "--out", str(out)], capture_output=True, text=True, env=env,
                               cwd=tmp_path, timeout=300)
            assert r.returncode == 0, r.stderr
    port, jax_doc = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert set(port) == {"bench", "smoke", "n_samples", "tick_size", "numpy", "results", "fleet",
                         "annotate_overhead", "timeline_overhead"}
    assert _sections(port) == _sections(jax_doc)
    assert not (tmp_path / "BENCH_ingest.json").exists() and not (tmp_path / "build").exists()


def test_host_only_benchmarks_default_under_build():
    from repro_torch.benchmarks import aggregate_throughput, annotate_overhead, ingest_throughput, timeline_overhead

    for mod in (ingest_throughput, aggregate_throughput, annotate_overhead, timeline_overhead):
        assert mod.DEFAULT_OUT == os.path.join("build", "BENCH_ingest.json")


def test_run_prints_the_rows_of_the_filtered_benchmarks(capsys):
    from repro_torch.benchmarks import run

    assert [b[0] for b in run.BENCHES] == ["fig01_engines", "fig02_stack_depth", "fig08_11_breakdown",
                                          "fig10_12_zoom", "fig13_detect", "overhead", "roofline"]
    run.main(["fig02", "--device", "cpu"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in lines[1:]] == ["fig02_stack_depth"]


def test_timeit_is_the_median_of_the_timed_calls(monkeypatch):
    from repro_torch.benchmarks import common

    clock = iter([0.0, 0.003, 1.0, 1.001, 2.0, 2.002])  # calls of 3, 1 and 2 ms
    monkeypatch.setattr(common.time, "perf_counter", lambda: next(clock))
    calls = []
    assert common.timeit(lambda: calls.append(1), warmup=2, iters=3) == pytest.approx(2000.0)
    assert len(calls) == 5
    assert common.row("x", 12.34, "a=1") == "x,12.3,a=1"
