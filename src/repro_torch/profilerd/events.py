"""Canonical registry of every event ``kind`` the profiling plane emits: a
copy of ``repro.profilerd.events``, the same kinds, so one reader takes both
packages' ``events.jsonl``.

Events land in ``events.jsonl`` / ``status.json`` and are consumed by the
faults scoreboard, the CI gates, and operators grepping a fleet's logs.  An
emitter minting a kind that is not registered here is invisible to all of
them, so new kinds earn their place by being added here.  The kinds of the
modules still to port (the aggregator, push, the fault scenarios) stay
registered, so the table stays the JAX package's.

Constants are grouped by emitter; :data:`EVENT_KINDS` is the flat set the
tests consume.
"""

from __future__ import annotations

# -- daemon lifecycle (profilerd/daemon.py) ---------------------------------
TARGET_ATTACHED = "TARGET_ATTACHED"
TARGET_RESTARTED = "TARGET_RESTARTED"
TARGET_NEVER_APPEARED = "TARGET_NEVER_APPEARED"
SOURCE_ATTACH_FAILED = "SOURCE_ATTACH_FAILED"
SOURCE_GAVE_UP = "SOURCE_GAVE_UP"
INGEST_SCALAR_FALLBACK = "INGEST_SCALAR_FALLBACK"
TIMELINE_WRITE_FAILED = "TIMELINE_WRITE_FAILED"
CALLBACK_FAILED = "CALLBACK_FAILED"
SERVING = "SERVING"
SERVE_FAILED = "SERVE_FAILED"
SUPERVISOR_GONE = "SUPERVISOR_GONE"
DEVICE_TREE_LOADED = "DEVICE_TREE_LOADED"
DEVICE_TREE_UNREADABLE = "DEVICE_TREE_UNREADABLE"
STATIC_TREE_LOADED = "STATIC_TREE_LOADED"
STATIC_TREE_UNREADABLE = "STATIC_TREE_UNREADABLE"
FAULT_INJECT = "FAULT_INJECT"
FAULT_CLEAR = "FAULT_CLEAR"
FAULT_MARKER_INVALID = "FAULT_MARKER_INVALID"

# -- per-target liveness (profilerd/sources.py) -----------------------------
TARGET_STALLED = "TARGET_STALLED"
TARGET_RESUMED = "TARGET_RESUMED"

# -- detector verdicts (core/detector.py + daemon straggler loop) -----------
DOMINANT = "DOMINANT"
LIVELOCK = "LIVELOCK"
LIVELOCK_CLEARED = "LIVELOCK_CLEARED"
LIVELOCK_SUSPECT = "LIVELOCK_SUSPECT"
SHARE_DRIFT = "SHARE_DRIFT"
STRAGGLER = "STRAGGLER"

# -- fleet aggregator (profilerd/aggregator.py) -----------------------------
AGGREGATOR_RESTORED = "AGGREGATOR_RESTORED"
NODE_ATTACHED = "NODE_ATTACHED"
NODE_REBOOTED = "NODE_REBOOTED"
NODE_STALLED = "NODE_STALLED"
NODE_RECOVERED = "NODE_RECOVERED"

# -- epoch push client (profilerd/push.py) ----------------------------------
PUSH_FAILED = "PUSH_FAILED"
PUSH_RECOVERED = "PUSH_RECOVERED"
PUSH_REJECTED = "PUSH_REJECTED"

# -- scenario detector rules (faults/scenarios.py, launch/train.py) ---------
INPUT_STARVED = "INPUT_STARVED"
INPUT_STARVATION = "INPUT_STARVATION"
COLLECTIVE_STALL = "COLLECTIVE_STALL"
MOE_IMBALANCE = "MOE_IMBALANCE"
CKPT_WEDGE = "CKPT_WEDGE"
LOCK_CONVOY = "LOCK_CONVOY"

EVENT_KINDS = frozenset(
    {
        TARGET_ATTACHED,
        TARGET_RESTARTED,
        TARGET_NEVER_APPEARED,
        SOURCE_ATTACH_FAILED,
        SOURCE_GAVE_UP,
        INGEST_SCALAR_FALLBACK,
        TIMELINE_WRITE_FAILED,
        CALLBACK_FAILED,
        SERVING,
        SERVE_FAILED,
        SUPERVISOR_GONE,
        DEVICE_TREE_LOADED,
        DEVICE_TREE_UNREADABLE,
        STATIC_TREE_LOADED,
        STATIC_TREE_UNREADABLE,
        FAULT_INJECT,
        FAULT_CLEAR,
        FAULT_MARKER_INVALID,
        TARGET_STALLED,
        TARGET_RESUMED,
        DOMINANT,
        LIVELOCK,
        LIVELOCK_CLEARED,
        LIVELOCK_SUSPECT,
        SHARE_DRIFT,
        STRAGGLER,
        AGGREGATOR_RESTORED,
        NODE_ATTACHED,
        NODE_REBOOTED,
        NODE_STALLED,
        NODE_RECOVERED,
        PUSH_FAILED,
        PUSH_RECOVERED,
        PUSH_REJECTED,
        INPUT_STARVED,
        INPUT_STARVATION,
        COLLECTIVE_STALL,
        MOE_IMBALANCE,
        CKPT_WEDGE,
        LOCK_CONVOY,
    }
)

__all__ = ["EVENT_KINDS"] + sorted(k for k in EVENT_KINDS)
