"""The profiling plane: copies of the parts of ``repro.core`` the port needs.

The host plane (call tree, sampler backends, detectors and watchdog, the
snapshot codec and timeline ring, HTML report, views, cross-run diffs and the
exporters: folded, speedscope, flamegraph HTML) is pure Python; the device
plane (``engines``: the paper's Fig. 1 engines, eager and in CUDA graphs;
``scope``: the named ranges, ``scope.scope`` entered at the JAX package's
scope sites; ``device_tree``: the call tree of one profiled step;
``roofline``: the H100 spec and the three-term bound; ``planes``: the host
tree annotated with the device tree) runs on torch and ``torch.profiler``.

Exports resolve lazily (PEP 562), as ``repro.core``'s do: the
out-of-process ``repro_torch.profilerd`` daemon imports the host plane on
every attach and must load neither torch nor CUDA, while ``engines``,
``scope`` and the builders of ``device_tree`` import torch on first use.
"""

from importlib import import_module

_EXPORTS = {
    # host plane (no torch)
    "SAMPLES": ".calltree",
    "CallNode": ".calltree",
    "CallTree": ".calltree",
    "AnomalyEvent": ".detector",
    "DominanceDetector": ".detector",
    "LIVELOCK_CLEARED": ".detector",
    "Rule": ".detector",
    "StragglerDetector": ".detector",
    "TrendDetector": ".detector",
    "TrendRule": ".detector",
    "TrendVerdict": ".detector",
    "WatchdogLoop": ".detector",
    "segment_phases": ".detector",
    "CountSealer": ".snapshot",
    "EpochMeta": ".snapshot",
    "EpochSealer": ".snapshot",
    "SnapshotError": ".snapshot",
    "TimelineReader": ".snapshot",
    "TimelineWriter": ".snapshot",
    "load_snapshot": ".snapshot",
    "save_snapshot": ".snapshot",
    "DEFAULT_PERIOD_S": ".sampler",
    "SamplerBackend": ".sampler",
    "SamplerConfig": ".sampler",
    "StackSampler": ".sampler",
    "classify_frame": ".sampler",
    "collapse_stack": ".sampler",
    "frame_symbol": ".sampler",
    "make_sampler": ".sampler",
    "ViewConfig": ".report",
    "NO_MATCH_MARKER": ".report",
    "breakdown": ".report",
    "diff_rows": ".report",
    "name_shares": ".report",
    "render_diff": ".report",
    "render_html": ".report",
    "save_views": ".report",
    "share_regressions": ".report",
    "write_report": ".report",
    "EXPORT_FORMATS": ".export",
    "build_diff_tree": ".export",
    "diff_flamegraph_html": ".export",
    "export_tree": ".export",
    "flamegraph_html": ".export",
    "from_folded": ".export",
    "to_folded": ".export",
    "to_speedscope": ".export",
    # device plane (torch on first use of a builder; the artifact's loader
    # and saver import none; the engines import torch)
    "BlockwiseEngine": ".engines",
    "CompiledEngine": ".engines",
    "EagerEngine": ".engines",
    "compare_engines": ".engines",
    "DEVICE_TREE_SCHEMA": ".device_tree",
    "build_device_tree": ".device_tree",
    "load_device_tree": ".device_tree",
    "save_device_tree": ".device_tree",
    "tree_from_profile": ".device_tree",
    "DEVICE_TREE_FILENAME": ".planes",
    "PLANES": ".planes",
    "PlaneError": ".planes",
    "annotate_tree": ".planes",
    "default_metric": ".planes",
    "dominant_term": ".planes",
    "select_plane": ".planes",
    "H100": ".roofline",
    "HardwareSpec": ".roofline",
    "RooflineReport": ".roofline",
    "report_from_tree": ".roofline",
    "kernel_launch": ".scope",
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
