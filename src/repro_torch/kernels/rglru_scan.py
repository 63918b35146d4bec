"""ctypes binding of the CUDA RG-LRU scan kernels (``csrc/rglru_scan.cu``).

They replace the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``_rglru_kernel``); the source's header says what bounds them on the H100
and how each design answers that. Both compute ``h_t = a_t * h_{t-1} + b_t``
over contiguous (B, S, W) arrays, h in f32, output in the inputs' dtype:

- ``launch``: the chunked kernel, parallel in time (sub-chunks of
  ``SUB_CHUNK`` steps, ``WARPS`` of them a block, blocks joined by a
  thread-block cluster of ``cluster_size(S)``); ``ops.rglru_scan`` runs it;
- ``launch_sequential``: the kernel it replaced, one thread per (batch,
  feature) walking all of S; kept only to be timed and checked beside it.

Their plain version is ``ref.rglru_ref``; ``ref.rglru_chunked_ref`` repeats
the chunked kernel's order of arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# The chunked kernel's tiling, as csrc/rglru_scan.cu fixes it by default; the
# library's own (rglru_scan_tiling) is checked against it at load.
SUB_CHUNK = 8  # steps a thread scans
WARPS = 4  # sub-chunks a block scans side by side
MAX_CLUSTER = 8  # blocks along time in a cluster: the portable maximum
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS = {}  # extra nvcc flags -> (library, its tiling)
SEQUENTIAL_LAUNCHES = 0  # launches of the sequential kernel; ops.launch_counts reports it


def cluster_size(S: int, block_steps: int = SUB_CHUNK * WARPS) -> int:
    """Blocks along time in one cluster: the least power of two whose blocks
    of ``block_steps`` steps cover S in one round, at most ``MAX_CLUSTER``."""
    blocks = -(-S // block_steps)
    c = 1
    while c < min(blocks, MAX_CLUSTER):
        c *= 2
    return c


def library(flags: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, tuple[int, int, int]]:
    """-> (the library built from csrc/rglru_scan.cu with the extra nvcc
    ``flags``, its entry points typed; its tiling (steps a thread, warps a
    block, largest cluster)). ``-DRGLRU_SUB=n`` and ``-DRGLRU_WARPS=n`` build
    another tiling; without flags the tiling must be this module's."""
    if flags not in _LIBS:
        lib = build.load("rglru_scan", flags)
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, argtypes in (("rglru_scan_fwd", [p, p, p, i, i, i, i, i, p]),
                               ("rglru_scan_sequential_fwd", [p, p, p, i, i, i, i, p]),
                               ("rglru_scan_max_active_clusters", [i, i, i, i])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        tiling = (ctypes.c_int * 3)()
        lib.rglru_scan_tiling(tiling)
        tiling = tuple(tiling)
        if not flags and tiling != (SUB_CHUNK, WARPS, MAX_CLUSTER):
            raise RuntimeError(f"csrc/rglru_scan.cu's tiling {tiling} is not rglru_scan.py's "
                               f"(SUB_CHUNK, WARPS, MAX_CLUSTER) = {(SUB_CHUNK, WARPS, MAX_CLUSTER)}")
        _LIBS[flags] = lib, tiling
    return _LIBS[flags]


def _run(fn, a: torch.Tensor, b: torch.Tensor, *extra: int) -> torch.Tensor:
    B, S, W = a.shape
    h = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPE_CODE[a.dtype], B, S, W, *extra,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err == -1:
        raise RuntimeError(f"rglru_scan: the card cannot hold a cluster of {extra[0]} blocks of the chunked kernel")
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError {err}")
    return h


def launch(a: torch.Tensor, b: torch.Tensor, *, flags: tuple[str, ...] = ()) -> torch.Tensor:
    """The chunked kernel (built with the extra nvcc ``flags``, see
    ``library``). a, b: contiguous (B, S, W) CUDA tensors of one dtype; the
    caller (``ops.rglru_scan``) has checked devices, types and shapes.
    Launches on the current stream and returns h: (B, S, W) in a's dtype."""
    lib, (sub, warps, _) = library(flags)
    return _run(lib.rglru_scan_fwd, a, b, cluster_size(a.shape[1], sub * warps))


def launch_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sequential kernel, on the same terms as ``launch``."""
    global SEQUENTIAL_LAUNCHES
    h = _run(library()[0].rglru_scan_sequential_fwd, a, b)
    SEQUENTIAL_LAUNCHES += 1
    return h


def max_active_clusters(dtype: torch.dtype, W: int, cluster: int, *, flags: tuple[str, ...] = ()) -> int:
    """Clusters of ``cluster`` blocks the card holds at once for the chunked
    kernel at width W (16-byte aligned pointers, as ``torch.empty`` gives)."""
    return library(flags)[0].rglru_scan_max_active_clusters(_DTYPE_CODE[dtype], W, 1, cluster)
