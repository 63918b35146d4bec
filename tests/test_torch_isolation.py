"""The port imports neither JAX nor the JAX package, statically or at run time."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    mods = [
        "repro_torch." + str(p.relative_to(ROOT / "src" / "repro_torch").with_suffix("")).replace("/", ".")
        for p in PORT_FILES[:-1]
    ]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "run",
    [
        "import repro_torch.profilerd.daemon",
        "import repro_torch.profilerd, repro_torch.profilerd.agent, repro_torch.profilerd.profiles; "
        "import repro_torch.core.device_tree, repro_torch.core.planes, repro_torch.core.snapshot",
        "import runpy; sys.argv = ['profilerd', 'attach', '--help']\n"
        "try: runpy.run_module('repro_torch.profilerd', run_name='__main__')\n"
        "except SystemExit as e: assert e.code == 0, e.code",
        "import repro_torch.launch.launcher",
        "import repro_torch.profilerd.server",
        "import repro_torch.profilerd.aggregator",
        "import repro_torch.profilerd.push, repro_torch.core.export, repro_torch.core.views_library, "
        "repro_torch.core.report",
        *[
            f"import runpy; sys.argv = ['profilerd', {sub!r}, '--help']\n"
            "try: runpy.run_module('repro_torch.profilerd', run_name='__main__')\n"
            "except SystemExit as e: assert e.code == 0, e.code"
            for sub in ("serve", "aggregate", "export")
        ],
        "import repro_torch.faults, repro_torch.faults.__main__, repro_torch.faults._target, "
        "repro_torch.checkpoint",
        "import repro_torch.benchmarks.run, repro_torch.benchmarks.common, repro_torch.benchmarks.overhead, "
        "repro_torch.benchmarks.ingest_throughput, repro_torch.benchmarks.aggregate_throughput, "
        "repro_torch.benchmarks.annotate_overhead, repro_torch.benchmarks.timeline_overhead",
        "import repro_torch.examples, repro_torch.examples.live_flamegraph",
        "import repro_torch.benchmarks.roofline",
    ],
    ids=["import-daemon", "import-daemon-side", "attach-help", "import-launcher", "import-server",
         "import-aggregator", "import-push-export-views", "serve-help", "aggregate-help", "export-help",
         "import-faults", "import-host-benchmarks", "import-live-flamegraph", "import-roofline"],
)
def test_the_profiling_daemon_loads_no_torch(run):
    """The daemon process (its modules, the agent's, the device tree's loader
    and ``python -m repro_torch.profilerd attach --help``) loads no torch in a
    fresh interpreter, so it maps neither torch nor CUDA; nor do the launcher,
    the query server, the aggregator, push, the exporters and the ``serve``,
    ``aggregate`` and ``export`` subcommands; nor do the fault corpus's
    registry, harness, CLI and child entry point, and the checkpoint manager
    (the ``ckpt_wedge`` child's), before a model driver's warm-up; nor do
    the benchmark harness, the host-only benchmarks (``overhead`` and the
    four that write ``BENCH_ingest.json``'s sections, ``roofline``) and the
    ``live_flamegraph`` example."""
    code = f"import sys\n{run}\nprint(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')))\n"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_dry_run_plan_loads_no_jax():
    """The sharding rules, the meshes, the dry-run and its cost tracer plan a
    smoke cell on the meta device (and on the (16, 16) mesh) in a fresh
    interpreter that loads neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch.sharding, repro_torch.launch.mesh, repro_torch.core.meta_cost\n"
        "from repro_torch.configs import ShapeSpec, get_config\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import MeshShape\n"
        "cfg = get_config('qwen3-4b', smoke=True)\n"
        "one = dryrun.run_cell(cfg, ShapeSpec('t', 16, 2, 'train'), mesh=MeshShape(('data', 'model'), (1, 1)),"
        " verbose=False)\n"
        "big = dryrun.run_cell(cfg, 'decode_32k', False, verbose=False)\n"
        "assert one['status'] == big['status'] == 'ok', (one.get('error'), big.get('error'))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize(
    "run",
    [
        "import runpy; sys.argv = ['analysis', 'lint', '--root', 'src/repro_torch']\n"
        "try: runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e: assert e.code == 0, e.code",
        "import repro_torch.analysis.coverage",
        "import repro_torch.analysis, repro_torch.analysis.extract, repro_torch.analysis.lint, "
        "repro_torch.analysis.baseline, repro_torch.analysis.score, repro_torch.analysis.static_tree",
    ],
    ids=["lint-cli", "import-coverage", "import-analysis"],
)
def test_the_static_plane_loads_no_torch_numpy_or_jax(run):
    """``python -m repro_torch.analysis lint`` over the port and the analysis
    modules load no torch, no numpy, no JAX and nothing of the JAX package:
    the static plane runs on a bare interpreter."""
    code = (f"import sys\n{run}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax', 'repro')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_daemon_with_a_static_tree_loaded_loads_no_torch(tmp_path):
    """``profilerd attach`` over a finished spool, with the port's static
    tree in its out dir: status.json reads ``static_plane`` true, and the
    daemon's interpreter holds no torch, JAX or JAX package."""
    code = (
        "import json, os, runpy, sys\n"
        "from repro_torch.analysis.extract import extract_to_file\n"
        "from repro_torch.profilerd.spool import SpoolWriter\n"
        "from repro_torch.profilerd.wire import Encoder, RawFrame, RawSample\n"
        "os.makedirs('s.spool.d')\n"
        "extract_to_file('s.spool.d/static_tree.json')\n"
        "w, enc = SpoolWriter('s.spool', capacity=1 << 16), Encoder()\n"
        "w.write(enc.encode_hello(os.getpid(), 0.01))\n"
        "w.write(enc.encode_tick([RawSample(0.0, 1, 'w', [RawFrame('/fake/app.py', 'main', 1)])])[0])\n"
        "w.write_bye(enc.encode_bye(1))\n"
        "w.close()\n"
        "sys.argv = ['profilerd', 'attach', '--spool', 's.spool', '--max-seconds', '30']\n"
        "try: runpy.run_module('repro_torch.profilerd', run_name='__main__')\n"
        "except SystemExit as e: assert e.code == 0, e.code\n"
        "assert json.load(open('s.spool.d/status.json'))['static_plane'] is True\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
