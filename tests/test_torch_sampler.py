"""The port's two sampler backends keep no sampled frame alive.

``sys._current_frames()`` returns the sampling thread's own frame among the
others, and that frame's locals hold the snapshot: unless the capture drops
it, the cycle keeps every frame of the sample, and the tensors in their
locals, alive until the garbage collector runs. On the card that is device
memory: a harness that ran qwen3-4b's forward under the thread sampler
still held its 8.8 GB of weights when the next benchmark asked for the
card. Checked here with the collector off, so only reference counts free
anything.
"""

import gc
import threading
import weakref

import pytest
import torch

from repro_torch.core import SamplerConfig, StackSampler
from repro_torch.profilerd.agent import Agent


def _sample_a_parked_frame(capture) -> weakref.ref:
    """A thread parks with a tensor in its locals; ``capture()`` samples it;
    the thread returns. -> a weak reference to the tensor."""
    ref, parked, release = [], threading.Event(), threading.Event()

    def work():
        t = torch.ones(16)
        ref.append(weakref.ref(t))
        parked.set()
        release.wait(10)

    th = threading.Thread(target=work)
    th.start()
    assert parked.wait(10)
    capture()
    release.set()
    th.join(10)
    return ref[0]


@pytest.mark.parametrize("backend", ["thread", "daemon"])
def test_a_sample_keeps_no_frame_alive(backend, tmp_path):
    if backend == "thread":
        sampler = StackSampler(SamplerConfig(period_s=60))
        capture = sampler.sample_now
    else:
        agent = Agent(str(tmp_path / "t.spool"), period_s=60)
        capture = agent.tick
    gc.collect()
    gc.disable()
    try:
        ref = _sample_a_parked_frame(capture)
        assert ref() is None, "the sampled frame's tensor outlived its thread"
    finally:
        gc.enable()
    if backend == "thread":
        assert sampler.n_samples == 1 and any("work" in k for k in sampler.snapshot().flatten())
    else:
        assert agent.n_ticks == 1 and agent.n_stacks >= 2
