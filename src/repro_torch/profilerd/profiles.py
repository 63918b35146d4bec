"""Loading profile artifacts, in every shape this repo produces them.

One loader serves the CLI (``timeline``/``diff``/``check``/``export``) and the
HTTP server's offline mode.  A "profile" is any of:

* a daemon ``--out`` dir (uses its ``timeline/`` ring, falling back to
  ``tree.json``);
* a timeline ring dir (``seg-*.tl`` segments);
* a ``tree.json`` dump (``CallTree.to_json`` schema);
* a binary ``.snap`` snapshot (``repro_torch.core.snapshot.save_snapshot``).

A copy of ``repro.profilerd.profiles``. Beside a profile it finds the
device-plane artifact (``device_tree.json``, read by
``repro_torch.core.device_tree.load_device_tree``) and the static call-graph
artifact (``static_tree.json``, read by
``repro_torch.analysis.static_tree.load_static_tree``); neither loads torch.
"""

from __future__ import annotations

import json
import os

TIMELINE_DIRNAME = "timeline"
TARGETS_DIRNAME = "targets"  # multi-target daemon: per-target artifact dirs
DEVICE_TREE_FILENAME = "device_tree.json"  # device-plane artifact beside a profile
STATIC_TREE_FILENAME = "static_tree.json"  # static call-graph artifact beside a profile
REGION_FILENAME = "region.json"  # aggregator out dir: region -> node -> target map


class ProfileLoadError(RuntimeError):
    pass


def load_profile(path: str):
    """Load a CallTree from any profile artifact shape (see module docstring)."""
    from repro_torch.core.calltree import CallTree
    from repro_torch.core.snapshot import SnapshotError, TimelineReader, is_timeline_dir, load_snapshot

    if os.path.isdir(path):
        tdir = os.path.join(path, TIMELINE_DIRNAME)
        tree_json = _tree_json_inside(path)
        ring = path if is_timeline_dir(path) else tdir if is_timeline_dir(tdir) else None
        if ring is not None:
            try:
                last = TimelineReader(ring).last()
            except SnapshotError as e:  # e.g. version skew from a newer build
                raise ProfileLoadError(f"{ring}: {e}") from None
            if last is not None:
                return last[1]
            # A ring that never got a decodable epoch (e.g. daemon killed
            # mid-keyframe) must not mask a valid tree.json beside it.
            if tree_json is None:
                raise ProfileLoadError(f"{ring}: timeline ring holds no decodable epochs")
        if tree_json is not None:
            return load_profile(tree_json)
        raise ProfileLoadError(f"{path}: no timeline ring or tree.json inside")
    if not os.path.exists(path):
        raise ProfileLoadError(f"{path}: no such profile")
    if path.endswith(".json"):
        try:
            with open(path) as f:
                return CallTree.from_json(f.read())
        except (OSError, ValueError, KeyError) as e:
            raise ProfileLoadError(f"{path}: unreadable tree.json: {e}") from None
    try:
        return load_snapshot(path)[1]
    except (OSError, SnapshotError) as e:
        raise ProfileLoadError(f"{path}: unreadable snapshot: {e}") from None


def profile_mtime(path: str) -> float:
    """Newest mtime across the artifacts ``load_profile`` would read.

    The server's offline source caches the loaded tree and re-reads only when
    this changes, so serving a directory a daemon is *still writing into*
    stays fresh without re-decoding the ring on every request.
    """
    from repro_torch.core.snapshot import list_segments

    candidates = [path]
    if os.path.isdir(path):
        tj = _tree_json_inside(path)
        if tj:
            candidates.append(tj)
        for d in (path, os.path.join(path, TIMELINE_DIRNAME)):
            candidates.extend(list_segments(d))
    newest = 0.0
    for p in candidates:
        try:
            newest = max(newest, os.path.getmtime(p))
        except OSError:
            pass
    return newest


def list_profile_targets(path: str) -> list[str]:
    """Target names under a multi-target daemon out dir (sorted; [] if none).

    A target is any ``targets/<name>/`` subdir holding a ``tree.json`` or a
    timeline ring — the shapes :func:`load_profile` can read.
    """
    from repro_torch.core.snapshot import is_timeline_dir

    d = os.path.join(path, TARGETS_DIRNAME)
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        sub = os.path.join(d, name)
        if not os.path.isdir(sub):
            continue
        if os.path.exists(os.path.join(sub, "tree.json")) or is_timeline_dir(
            os.path.join(sub, TIMELINE_DIRNAME)
        ):
            out.append(name)
    return out


def target_profile_dir(path: str, name: str):
    """The per-target profile dir behind a fleet out dir, or None."""
    sub = os.path.join(path, TARGETS_DIRNAME, name)
    return sub if name in list_profile_targets(path) else None


def _tree_json_inside(dir_path: str):
    """A dir's tree dump: ``tree.json`` or the launcher's ``merged_tree.json``."""
    for name in ("tree.json", "merged_tree.json"):
        p = os.path.join(dir_path, name)
        if os.path.exists(p):
            return p
    return None


def device_tree_path(path: str, target: str | None = None):
    """Resolve the ``device_tree.json`` artifact beside a profile, or None.

    A profile dir holds it directly; a per-target dir under ``targets/<name>/``
    holds a target-specific one, falling back to the fleet-level artifact (all
    co-located targets run the same compiled program); a ``tree.json``/
    ``.snap`` file has it as a sibling.
    """
    if os.path.isdir(path):
        if target:
            p = os.path.join(path, TARGETS_DIRNAME, target, DEVICE_TREE_FILENAME)
            if os.path.exists(p):
                return p
        p = os.path.join(path, DEVICE_TREE_FILENAME)
        return p if os.path.exists(p) else None
    p = os.path.join(os.path.dirname(path) or ".", DEVICE_TREE_FILENAME)
    return p if os.path.exists(p) else None


def load_device_plane(path: str, target: str | None = None):
    """The device-plane CallTree beside a profile: None when absent, raises
    :class:`ProfileLoadError` when present but unreadable (never a vacuous
    empty tree — the plane contract mirrors the no-match marker contract)."""
    from repro_torch.core.device_tree import load_device_tree

    p = device_tree_path(path, target)
    if p is None:
        return None
    try:
        return load_device_tree(p)
    except (OSError, ValueError, KeyError) as e:
        raise ProfileLoadError(f"{p}: unreadable device tree: {e}") from None


def static_tree_path(path: str, target: str | None = None):
    """Resolve the ``static_tree.json`` artifact beside a profile, or None.

    Same resolution as :func:`device_tree_path`: a profile dir holds it
    directly, a per-target dir may hold a target-specific one falling back
    to the fleet-level artifact (all targets run the same source tree), and
    a ``tree.json``/``.snap`` file has it as a sibling.
    """
    if os.path.isdir(path):
        if target:
            p = os.path.join(path, TARGETS_DIRNAME, target, STATIC_TREE_FILENAME)
            if os.path.exists(p):
                return p
        p = os.path.join(path, STATIC_TREE_FILENAME)
        return p if os.path.exists(p) else None
    p = os.path.join(os.path.dirname(path) or ".", STATIC_TREE_FILENAME)
    return p if os.path.exists(p) else None


def load_static_plane(path: str, target: str | None = None):
    """The static call-graph CallTree beside a profile: None when absent,
    raises :class:`ProfileLoadError` when present but unreadable (never a
    vacuous empty tree — same contract as the device plane)."""
    from repro_torch.analysis.static_tree import load_static_tree

    p = static_tree_path(path, target)
    if p is None:
        return None
    try:
        return load_static_tree(p)
    except (OSError, ValueError, KeyError) as e:
        raise ProfileLoadError(f"{p}: unreadable static tree: {e}") from None


def load_region(path: str):
    """The aggregator's ``region.json`` hierarchy beside a profile, or None.

    Shape: ``{"region": <name>, "nodes": [{"name": ..., "targets": [...]},
    ...]}`` — written by ``profilerd aggregate`` every publish window so the
    offline query plane can serve hierarchical ``/targets`` from the same
    artifact dir.
    """
    if not os.path.isdir(path):
        return None
    p = os.path.join(path, REGION_FILENAME)
    try:
        with open(p) as f:
            data = json.load(f)
    except OSError:
        return None
    except ValueError as e:
        raise ProfileLoadError(f"{p}: unreadable region map: {e}") from None
    return data if isinstance(data, dict) else None


def timeline_dir_of(path: str):
    """The timeline ring dir behind a profile path, if it has one."""
    from repro_torch.core.snapshot import is_timeline_dir

    if not os.path.isdir(path):
        return None
    if is_timeline_dir(path):
        return path
    for name in (TIMELINE_DIRNAME, "merged_timeline"):
        tdir = os.path.join(path, name)
        if is_timeline_dir(tdir):
            return tdir
    return None
