"""Versioned on-disk envelope for the static call-graph plane.

A copy of ``repro.analysis.static_tree``, the same schema and file name, so
an artifact written by either package loads in both.  Like the device-plane
artifact (:mod:`repro_torch.core.device_tree`) it is a
``static_tree.json`` file carrying a schema tag and a serialized
:class:`~repro_torch.core.calltree.CallTree` root, written atomically so a reader
polling the profile dir never sees a torn document.  The profiler's loaders
(:func:`repro_torch.profilerd.profiles.load_static_plane`) and the query plane's
``/tree?plane=static`` both consume this format.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any

from repro_torch.core.calltree import CallNode, CallTree

STATIC_TREE_SCHEMA = "repro-static-tree/v1"

# Canonical artifact filename — a static tree saved under this name beside a
# profile's tree.json is discovered by the daemon, the offline server, and
# the CLI --plane static paths, exactly like device_tree.json.
STATIC_TREE_FILENAME = "static_tree.json"


def save_static_tree(tree: CallTree, path: str, *, meta: Mapping[str, Any] | None = None) -> None:
    """Write ``tree`` as a versioned static-plane artifact (atomic rename)."""
    doc: dict[str, Any] = {"schema": STATIC_TREE_SCHEMA, "root": tree.root.to_dict()}
    if meta:
        doc["meta"] = dict(meta)
    tmp = f"{path}.tmp.{id(doc)}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def load_static_tree(path: str) -> CallTree:
    """Load a static-plane artifact; raises ``ValueError`` on a bad document.

    Accepts the versioned envelope or a legacy bare serialized root (the
    same tolerance the device-plane loader extends), so a tree dumped with
    ``CallTree.to_json`` still loads.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"static tree {path}: expected a JSON object")
    if "schema" in doc:
        if doc["schema"] != STATIC_TREE_SCHEMA:
            raise ValueError(
                f"static tree {path}: unknown schema {doc['schema']!r} (expected {STATIC_TREE_SCHEMA!r})"
            )
        root = doc.get("root")
    else:
        root = doc  # legacy bare root
    if not isinstance(root, dict) or "name" not in root:
        raise ValueError(f"static tree {path}: missing root node")
    return CallTree(CallNode.from_dict(root))


def static_meta(path: str) -> dict[str, Any]:
    """Return the envelope's ``meta`` block ({} for legacy documents)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and isinstance(doc.get("meta"), dict):
        return doc["meta"]
    return {}
