"""The host plane the trainer runs for the whole job: copies of the parts of
``repro.core`` it needs (call tree, thread sampler, dominance detector and
watchdog, HTML report). Pure Python; imports no torch."""

from .calltree import SAMPLES, CallNode, CallTree
from .detector import AnomalyEvent, DominanceDetector, Rule, WatchdogLoop
from .report import render_html, write_report
from .sampler import SamplerConfig, StackSampler, make_sampler

__all__ = [
    "SAMPLES", "CallNode", "CallTree", "AnomalyEvent", "DominanceDetector", "Rule", "WatchdogLoop",
    "render_html", "write_report", "SamplerConfig", "StackSampler", "make_sampler",
]
