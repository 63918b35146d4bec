"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles, at first use, into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, where the
hash covers the source files and the compiler flags, so a stale library is
never loaded. The libraries expose plain C entry points; nothing here
includes PyTorch's headers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")  # the toolkit's default prefix
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by a hash of the sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out


def build(names: list[str]) -> None:
    """Compile every missing library, one nvcc per source, all at once."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    failed = []
    for proc, tmp, out in jobs:
        if proc.wait() != 0:
            failed.append(f"{out.name}: see {out.with_suffix('.log')}:\n{out.with_suffix('.log').read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if missing. The caller
    keeps the handle (``flash_attention._fn``)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
