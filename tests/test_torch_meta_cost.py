"""The meta-device cost tracer (``repro_torch.core.meta_cost``) and the
kernel wrappers' meta path (``kernels/ops.py``), on the CPU.

* the trace's peak follows the storages' lifetimes: a tensor counts until
  its last reference drops, a tensor autograd saves until the backward
  frees it, a view and an in-place op allocate nothing;
* its counters follow the device tree's rules: 2 M N K a product, operand
  plus result bytes, views and allocations free, an in-place op writing its
  first operand;
* on the meta device each kernel wrapper (and its backward) returns empty
  meta tensors of its kernel's outputs (flash attention's ``lse`` where the
  card's kernel writes it), reports a call with its kernel's work, and moves
  no launch counter; outside a trace it reports nothing;
* a traced train step is keyed by the port's scope names, the forward as
  ``jvp(loss)`` and the backward as ``transpose(jvp(loss))``;
* a trace counts its own thread only: another thread's scopes and kernel
  calls, made while it traces, stay out of it.
"""

from __future__ import annotations

import dataclasses
import threading

import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core import meta_cost
from repro_torch.core import scope as scope_mod
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import Model


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_the_peak_follows_the_storages_lifetimes():
    base = meta(1000)  # 4,000 bytes made before the trace
    with meta_cost.tracing(base) as cost:
        a = base * 2  # 4,000
        b = a + 1  # 4,000: 12,000 live
        del a  # 8,000
        c = b * 3  # 12,000 again, not 16,000
        v = c.view(10, 100)  # a view allocates nothing
        c.add_(1)  # nor does an in-place op
        del b, c, v
        d = base.sum()  # 4 bytes
    assert cost.baseline_bytes == 4000 and cost.peak_bytes == 12000 and cost.temp_bytes == 8000
    assert d.shape == ()


def test_a_saved_tensor_stays_live_until_the_backward_frees_it():
    x = meta(1000, grad=True)
    with meta_cost.tracing(x) as cost:
        y = x * 2  # saved by sin: stays after its name is gone
        z = y.sin()
        del y
        live = cost.peak_bytes
        z.sum().backward()
    assert live == 3 * 4000  # x, y, z
    assert cost.peak_bytes >= live and x.grad is not None


def test_products_bytes_and_in_place_ops_follow_the_device_trees_rules():
    a, b = meta(8, 16), meta(16, 32)
    with meta_cost.tracing((a, b)) as cost:
        c = a @ b
        d = torch.bmm(meta(4, 8, 16), meta(4, 16, 2))
        c.mul_(2.0)
        c.t()
        c.zero_()
    flat = cost.tree.flatten("flops")
    assert flat["aten::mm"] == 2 * 8 * 16 * 32 and flat["aten::bmm"] == 2 * 4 * 8 * 16 * 2
    nbytes = cost.tree.flatten("bytes")
    assert nbytes["aten::mm"] == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    assert nbytes["aten::mul_"] == 2 * 4 * 8 * 32  # read c, write c
    assert nbytes["aten::zero_"] == 4 * 8 * 32  # written, not read
    assert "aten::t" not in nbytes and "aten::empty" not in cost.tree.flatten("ops")
    assert d.shape == (4, 8, 2)


def test_the_kernel_wrappers_on_meta_return_their_outputs_and_report_their_work():
    q, k, v = meta(2, 128, 8, 64, dtype=torch.bfloat16), meta(2, 128, 2, 64, dtype=torch.bfloat16), \
        meta(2, 128, 2, 64, dtype=torch.bfloat16)
    x, scale = meta(4, 32, 64, dtype=torch.bfloat16), meta(64)
    a = meta(2, 64, 32)
    before = ops.launch_counts()
    with meta_cost.tracing() as cost:
        o = ops.flash_attention(q, k, v, causal=True)
        o2, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o2, o2, causal=True, lse=lse)
        y = ops.fused_rmsnorm(x, scale)
        dx, dscale = ops.fused_rmsnorm_bwd(x, scale, y)
        h = ops.rglru_scan(a, a)
        da, db = ops.rglru_scan_bwd(a, h, h)
    assert ops.launch_counts() == before  # nothing launched
    assert all(t.device.type == "meta" for t in (o, o2, lse, dq, dk, dv, y, dx, dscale, h, da, db))
    assert o.shape == o2.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (2, 8, 128) and lse.dtype == torch.float32 and lse.stride()[1] == flash.lse_stride(128)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert y.shape == dx.shape == x.shape and dscale.shape == (64,)
    assert h.shape == da.shape == db.shape == a.shape
    assert dict(cost.kernel_calls) == {"flash_attention": 2, "flash_attention_bwd": 1, "fused_rmsnorm": 1,
                                       "fused_rmsnorm_bwd": 1, "rglru_scan": 1, "rglru_scan_bwd": 1}
    flops = cost.tree.flatten("flops")
    assert flops["kernel:flash_attention"] == 2 * ops.flash_work(q, k, True, None)[0]
    assert flops["kernel:flash_attention_bwd"] == ops.flash_work(q, k, True, None, backward=True)[0]
    assert cost.tree.flatten("bytes")["kernel:fused_rmsnorm"] == ops.rmsnorm_work(x)[1]
    ops.fused_rmsnorm(x, scale)  # outside a trace: no tracer, no count
    assert ops.launch_counts() == before


def test_flash_attention_under_autograd_on_meta_keeps_the_lse_for_its_backward():
    q = meta(1, 64, 4, 128, dtype=torch.bfloat16, grad=True)
    k = meta(1, 64, 2, 128, dtype=torch.bfloat16, grad=True)
    v = meta(1, 64, 2, 128, dtype=torch.bfloat16, grad=True)
    with meta_cost.tracing() as cost:
        ops.flash_attention(q, k, v).sum().backward()
    assert dict(cost.kernel_calls) == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_a_traced_train_step_is_keyed_by_the_port_scopes():
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), remat="full")
    cost = dryrun.trace_step(cfg, Model(cfg, device="meta").spec(), ShapeSpec("t", 16, 2, "train"), 2)
    paths = {path for path, _ in cost.tree.root.walk()}
    head = ("<root>", "train_step", "fwd_bwd")
    assert head + ("jvp(loss)", "model", "layers") in paths
    assert head + ("transpose(jvp(loss))",) in paths
    assert ("<root>", "train_step", "optimizer") in paths
    assert any(p[-1] == "kernel:flash_attention" and "attention" in p for p in paths)
    assert cost.tree.total("kernels") == sum(cost.kernel_calls.values())


def test_a_trace_counts_only_its_own_thread():
    x, scale = meta(4, 32, 64, dtype=torch.bfloat16), meta(64)
    seen = {}

    def elsewhere():
        with scope_mod.scope("elsewhere") as entered:
            seen["scope"] = entered
            ops.fused_rmsnorm(x, scale)

    with meta_cost.tracing() as cost:
        with scope_mod.scope("here"):
            worker = threading.Thread(target=elsewhere)
            worker.start()
            worker.join()
            ops.rglru_scan(meta(2, 8, 16), meta(2, 8, 16))
    assert seen["scope"] is None  # the worker's scope is the no-op
    assert dict(cost.kernel_calls) == {"rglru_scan": 1}
    paths = {path for path, _ in cost.tree.root.walk()}
    assert ("<root>", "here", "rglru_scan", "kernel:rglru_scan") in paths
    assert not any("elsewhere" in p or "kernel:fused_rmsnorm" in p for p in paths)


def test_the_wrappers_still_refuse_another_device():
    with pytest.raises(ValueError, match="different devices"):
        ops.fused_rmsnorm(meta(4, 8), torch.zeros(8))
