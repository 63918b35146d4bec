"""Checkpointing: atomic, async, anomaly-triggered (a copy of
``repro.checkpoint.manager`` without JAX).

Layout: ``<dir>/step_<n>/`` with one ``.npy`` per leaf (flattened key path)
plus ``manifest.json`` (tree structure, dtypes, extra state like the data
pipeline position). Writes go to ``step_<n>.tmp`` and are renamed only when
complete, so a crash mid-save can never corrupt the restore point.

* ``save``: every leaf (a torch tensor on any device, a numpy array or a
  number) is moved to host numpy first, so the train loop may update its
  tensors in place as soon as ``save`` returns; the files are then written by
  a background thread (``wait()`` blocks). numpy has no bf16, so a bf16
  tensor is stored as its raw 16 bits (uint16) with ``bfloat16`` as its dtype
  in the manifest, and restores bit for bit.
* ``save_emergency``: the detector callback (threshold violation ->
  checkpoint + warning), tagged in the manifest with the triggering event.
* ``keep``: the newest ``keep`` steps stay on disk. A step saved again
  (periodic and emergency, or several emergencies in one stall) counts once,
  where the reference's list counts saves and deletes a step it still lists.
* ``restore_latest``: the restart path; tolerant of a trailing ``.tmp`` from a
  crashed save. Leaves come back as CPU torch tensors in their saved dtypes.

Saving loads no torch: a leaf can be a torch tensor only in a process that
has imported torch, so a host-only job (the fault corpus's ``ckpt_wedge``
child) checkpoints numpy state without it. Restoring imports torch.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
from collections.abc import Callable
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    import torch

_SEP = "."


def _sync_path(path: str) -> None:
    """fsync one written file to stable storage.

    Module-level indirection on purpose: durability is where checkpoint
    writes wedge in production (hung NFS/fuse mounts), and a fault harness
    shims this symbol to reproduce a blocked-fsync save.
    """
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree, prefix=()) -> dict[tuple, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _unflatten(flat: dict[tuple, Any]) -> Any:
    if list(flat.keys()) == [()]:
        return flat[()]
    root: dict = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


def _to_host(v) -> tuple[np.ndarray, str]:
    """-> (a host numpy copy of the leaf, its dtype's name). A copy even of a
    CPU tensor: the caller may update the leaf in place while the writer
    thread saves it. A bf16 tensor becomes its raw bits as uint16."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of :func:`_to_host`, as a CPU tensor."""
    import torch

    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, fsync: bool = False):
        self.directory = directory
        self.keep = keep
        # fsync=True forces every leaf + manifest to stable storage before
        # the rename (see _sync_path).
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self.saved_steps: list[int] = []

    # -- save --------------------------------------------------------------------

    def save(
        self, step: int, tree: Any, *, extra: dict | None = None, blocking: bool = False, tag: str = "periodic"
    ) -> None:
        # Materialize on host *before* handing to the writer thread so the
        # train loop can overwrite its tensors in place immediately.
        flat, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            flat[k], dtypes[k] = _to_host(v)
        manifest = {
            "step": int(step),
            "tag": tag,
            "extra": extra or {},
            "leaves": {_SEP.join(k): {"dtype": dtypes[k], "shape": list(v.shape)} for k, v in flat.items()},
        }

        def write():
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for k, v in flat.items():
                leaf = os.path.join(tmp, _SEP.join(k) + ".npy")
                np.save(leaf, v)
                if self.fsync:
                    _sync_path(leaf)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if self.fsync:
                _sync_path(os.path.join(tmp, "manifest.json"))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with self._lock:
                if step in self.saved_steps:  # saved again: one entry a step, at its newest place
                    self.saved_steps.remove(step)
                self.saved_steps.append(step)
                self._gc()

        self.wait()
        if blocking:
            write()
        else:
            t = threading.Thread(target=write, name="repro-ckpt-writer", daemon=True)
            t.start()
            self._pending = t

    def save_emergency(self, step_fn: Callable[[], tuple[int, Any]], event) -> str:
        """Detector hook: checkpoint NOW, tagged with the anomaly."""
        step, tree = step_fn()
        self.save(
            step,
            tree,
            extra={"anomaly": {"kind": event.kind, "path": list(event.path), "share": event.share}},
            blocking=True,
            tag="emergency",
        )
        return os.path.join(self.directory, f"step_{step:010d}")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        while len(self.saved_steps) > self.keep:
            victim = self.saved_steps.pop(0)
            path = os.path.join(self.directory, f"step_{victim:010d}")
            if os.path.exists(path):
                shutil.rmtree(path)

    # -- restore --------------------------------------------------------------------

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int) -> tuple[Any, dict]:
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for key, meta in manifest["leaves"].items():
            flat[tuple(key.split(_SEP))] = _from_host(np.load(os.path.join(path, key + ".npy")), meta["dtype"])
        return _unflatten(flat), manifest

    def restore_latest(self) -> tuple[int, Any, dict] | None:
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        tree, manifest = self.restore(step)
        return step, tree, manifest
