"""repro_torch.profilerd — the out-of-process profiling daemon (paper §III
"profiler"), a copy of ``repro.profilerd`` for the port's jobs.

The paper's headline design point: *all* profiling runs in a separate process
alongside the target, so the target pays only for raw frame capture and is
never instrumented.  No module of this package imports torch (the agent's
sampler config included), so the daemon maps neither torch nor CUDA:

* :mod:`repro_torch.profilerd.wire`     — self-delimiting binary codec for
  raw, *unresolved* frame records (v1 per-frame, v2 stack-interned);
* :mod:`repro_torch.profilerd.spool`    — single-writer/single-reader byte
  ring over an mmap'd file (a full spool drops whole batches and counts them);
* :mod:`repro_torch.profilerd.agent`    — the only code that runs inside the
  target: snapshot ``sys._current_frames()`` each tick and append raw records;
  :class:`~repro_torch.profilerd.agent.DaemonBackend` is the sampler backend;
* :mod:`repro_torch.profilerd.resolver` — interned-symbol cache turning raw
  frames into ``origin::name`` symbols through the port's
  ``classify_frame``/``collapse_stack``, identical to the thread sampler's;
* :mod:`repro_torch.profilerd.ingest`   — cached-path call-tree ingestion;
* :mod:`repro_torch.profilerd.pipeline` — reader + decoder + ingestor +
  sealer + stats in one object;
* :mod:`repro_torch.profilerd.sources`  — one attached spool each, with its
  detectors, liveness and re-attach, and the set of them;
* :mod:`repro_torch.profilerd.daemon`   — drains the spools, merges, runs the
  detectors, seals the timeline (annotated with the device tree on the H100
  spec) and publishes ``status.json``/``tree.json``/``events.jsonl``/
  ``report.html``/``timeline/``;
* :mod:`repro_torch.profilerd.server`   — live HTTP query plane (``/status``,
  ``/targets``, ``/tree``, ``/timeline``, ``/diff``) over a running daemon's
  published snapshots or any offline profile artifact, plus ``top``;
* :mod:`repro_torch.profilerd.push`     — a daemon's client that POSTs each
  sealed epoch to a regional aggregator (spill and keyframe resync);
* :mod:`repro_torch.profilerd.aggregator` — that aggregator: per-node rings,
  the merged fleet tree, the same query plane;
* :mod:`repro_torch.profilerd.profiles` — the loader of those artifacts;
* :mod:`repro_torch.profilerd.events`   — the registry of event kinds;
* ``python -m repro_torch.profilerd``   — ``attach``, ``aggregate``,
  ``serve``, ``top``, ``export``, ``status``, ``report``, ``timeline``,
  ``diff``, ``check``.

The wire format, spool layout, snapshot codec, push frames, HTTP endpoints,
file names and environment seam are the JAX package's, so one reader takes
both packages' spools and artifacts.
"""

from importlib import import_module

# Lazy exports (PEP 562, the pattern of repro_torch.core): the daemon imports
# this package on every attach and must stay importable in milliseconds and
# free of torch, while the serving plane (http.server machinery) is only paid
# for on first use.
_EXPORTS = {
    "Agent": ".agent",
    "DaemonBackend": ".agent",
    "DaemonConfig": ".daemon",
    "ProfilerDaemon": ".daemon",
    "TreeIngestor": ".ingest",
    "IngestPipeline": ".pipeline",
    "ProfileLoadError": ".profiles",
    "load_profile": ".profiles",
    "SymbolResolver": ".resolver",
    "LiveSource": ".server",
    "OfflineSource": ".server",
    "ProfileServer": ".server",
    "SharedProfileState": ".server",
    "SpoolSet": ".sources",
    "SpoolSource": ".sources",
    "SpoolReader": ".spool",
    "SpoolWriter": ".spool",
    "WIRE_VERSION": ".wire",
    "Decoder": ".wire",
    "Encoder": ".wire",
    "RawFrame": ".wire",
    "RawSample": ".wire",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(import_module(module, __name__), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
