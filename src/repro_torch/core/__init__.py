"""The profiling plane: copies of the parts of ``repro.core`` the port needs.

The host plane (call tree, thread sampler, dominance detector and watchdog,
HTML report) is pure Python; the device plane (``scope``: the named ranges,
``scope.scope`` entered at the JAX package's scope sites;
``device_tree``: the call tree of one profiled step; ``roofline``: the H100
spec and the three-term bound; ``planes``: the host tree annotated with the
device tree) reads ``torch.profiler``.
"""

from .calltree import SAMPLES, CallNode, CallTree
from .detector import AnomalyEvent, DominanceDetector, Rule, WatchdogLoop
from .device_tree import (
    DEVICE_TREE_SCHEMA,
    build_device_tree,
    load_device_tree,
    save_device_tree,
    tree_from_profile,
)
from .planes import PLANES, PlaneError, annotate_tree, default_metric, dominant_term, select_plane
from .report import render_html, write_report
from .roofline import H100, HardwareSpec, RooflineReport, report_from_tree
from .sampler import SamplerConfig, StackSampler, make_sampler
from .scope import kernel_launch

__all__ = [
    "SAMPLES", "CallNode", "CallTree", "AnomalyEvent", "DominanceDetector", "Rule", "WatchdogLoop",
    "DEVICE_TREE_SCHEMA", "build_device_tree", "load_device_tree", "save_device_tree",
    "tree_from_profile", "PLANES", "PlaneError", "annotate_tree", "default_metric", "dominant_term",
    "select_plane", "render_html", "write_report", "H100", "HardwareSpec", "RooflineReport", "report_from_tree",
    "SamplerConfig", "StackSampler", "make_sampler", "kernel_launch",
]
