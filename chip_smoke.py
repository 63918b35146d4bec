#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and exits non-zero:

1. device  -- the card, torch/CUDA versions, ``nvidia-smi`` name and power limit;
2. build   -- nvcc build of the CUDA kernels from ``src/repro_torch/csrc`` (one
              nvcc per source, all at once), then the first Triton compile, each
              timed;
3. kernels -- every hand-written kernel against its plain PyTorch version on the
              card over the sweep of the CPU tests plus the main paths' shapes
              (f32 2e-5, bf16 2e-2), both flash kernels (wgmma for bf16 at head
              dim 16-256, FMA for f32 and D = 8, and the FMA kernel on the bf16
              cases too), then timed at the main paths' shapes beside its plain
              version, one PyTorch library call (where one exists) and its
              bound; flash also beside the FMA kernel it replaced, the RG-LRU
              scan (chunked, parallel in time) beside the sequential kernel it
              replaced, at B = 2 and 1;

then two paths, each through the entry points a user calls, with random weights
drawn from seed 0, the first freed before the second:

  qwen3-4b (dense decoder; flash attention and RMSNorm):
4. prefill -- ``Model.forward`` at full width on 2 x 2048 tokens, asserting 36
              flash-attention launches, all on the wgmma kernel, and 145 RMSNorm
              launches;
5. serve   -- ``BatchedServer``, batch 4, max_len 128, 8 requests of 3-9 prompt
              tokens and 12 new tokens, asserting 8/8 done and 145 RMSNorm
              launches per decode step;
6. profile -- torch.profiler over one prefill and 3 decode steps: device busy
              time, idle share and the kernels that take the most device time;
7. check   -- the model's output against a reference on a small input: the smoke
              config's prefill and decode through the kernels on the card
              against its plain path on the CPU, and the card's decode-vs-
              prefill gap against the CPU's; the card's smoke prefill runs every
              flash launch on the wgmma kernel (head dim 16);

  recurrentgemma-9b (hybrid: RG-LRU scan, windowed MQA at head dim 256):
4-7 again, prefill on 2 x 4096 tokens (the window of 2048 binds) asserting 12
flash-attention (all wgmma), 77 RMSNorm and 26 RG-LRU scan launches, serve
asserting 77 RMSNorm launches per decode step, and the check over 12 tokens,
past the smoke window of 8.

Then the card's ``nvidia-smi`` line, the kernels summary and, last,
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX package
``repro``.

  python3 chip_smoke.py --scan-tilings

instead builds the chunked RG-LRU scan at each tiling of ``SCAN_TILINGS`` and
prints one ``scan_tiling`` line for each (registers and spills, clusters the
card holds, time at the hybrid prefill's scan shapes), then the card's
``nvidia-smi`` line: how the port's tiling was chosen.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Each path: its prefill shape and the kernel launches its prefill and each
# decode step must make.
PATHS = {
    "qwen3-4b": dict(B=2, S=2048, check_tokens=8,
                     prefill={"flash_attention": 36, "flash_attention_wgmma": 36, "fused_rmsnorm": 145,
                              "rglru_scan": 0, "rglru_scan_sequential": 0},
                     per_step={"flash_attention": 0, "flash_attention_wgmma": 0, "fused_rmsnorm": 145,
                               "rglru_scan": 0, "rglru_scan_sequential": 0}),
    "recurrentgemma-9b": dict(B=2, S=4096, check_tokens=12,
                              prefill={"flash_attention": 12, "flash_attention_wgmma": 12, "fused_rmsnorm": 77,
                                       "rglru_scan": 26, "rglru_scan_sequential": 0},
                              per_step={"flash_attention": 0, "flash_attention_wgmma": 0, "fused_rmsnorm": 77,
                                        "rglru_scan": 0, "rglru_scan_sequential": 0}),
}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_kernels.py
# At the prefill's flash shape a late row's output is ~0.04 (softmax over ~2048
# random keys), below the bf16 atol: the error must also be small beside the
# output's RMS, so that a kernel that drops a kv tile for late rows fails.
FLASH_MAIN_MAX_ERR_OVER_RMS = 0.1
# The wgmma kernel feeds P to the PV product as two bf16 terms, hi = bf16(p) and
# lo = bf16(p - hi); so does attention_ref(p_bf16=2). Both sum in f32 and round
# the output once to bf16, so they part only where the f32 values straddle a
# rounding boundary: |err| <= 2^-7 |want| (one bf16 step) + TWO_TERM_ATOL, the
# atol for outputs near 0, where f32 summation order alone moves ~1e-6.
TWO_TERM_ATOL = 1e-4
DECODE_CARD_VS_CPU = 2e-2  # the kernels' bf16 atol: decode's logits, card against the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
SOURCES = {  # name -> (route, source, the TPU kernel it replaces)
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:35"),
    "fused_rmsnorm": ("triton", "src/repro_torch/kernels/fused_rmsnorm.py", "src/repro/kernels/fused_rmsnorm.py:21"),
    "rglru_scan": ("cuda", "src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan.py:33"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_events(prof):
    """The profiler's device-side events (kernels, copies), not the host ops
    that launched them: summing both would count device time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def time_ms(fn, iters: int = 10, warmup: int = 2, sessions: int = 5) -> tuple[float, float]:
    """-> (device ms, events ms) per call of ``fn`` over ``iters`` back-to-back calls.

    Device ms sums the profiler's kernel times: the card's own time for the
    work. Events ms is CUDA events around the loop; it is larger where the
    host cannot launch as fast as the card runs (a small Triton launch costs
    tens of microseconds of Python). The profiler on the card's machine now
    and then records no device events for a session, or fewer kernels than
    ``fn`` was called (every call launches at least one); the loop is then
    profiled again, and after ``sessions`` such sessions this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
        kernels = _kernel_events(prof)
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
        if device_ms > 0 and sum(e.count for e in kernels) >= iters:
            return device_ms, start.elapsed_time(end) / iters
    raise RuntimeError(f"the profiler recorded too few kernels in {sessions} sessions of {iters} calls")


def timed(prefix: str, fn, iters: int) -> dict:
    device_ms, events_ms = time_ms(fn, iters=iters)
    return {f"{prefix}ms": device_ms, f"{prefix}events_ms": events_ms}


def check_close(name: str, got, want, **case) -> float:
    """Raise unless ``got`` is within the dtype's tolerance of ``want``; -> max abs error."""
    tol = TOL[str(got.dtype).removeprefix("torch.")]
    err = (got.float() - want.float()).abs()
    bad = int((err > tol["atol"] + tol["rtol"] * want.float().abs()).sum())
    max_err = float(err.max())
    if bad or not math.isfinite(max_err):
        raise AssertionError(f"{name} {case}: {bad} elements out of tolerance {tol}, max abs error {max_err}")
    return max_err


def ptxas_report(log: str) -> dict:
    """nvcc's ``-Xptxas=-v`` log -> {kernel: {registers, smem_bytes, spill_stores, spill_loads}},
    each kernel named by its mangled name, plus any warnings."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            fn = m.group(1)
            out[fn] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
            out.setdefault(fn, {})
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out[fn]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                out[fn]["smem_bytes"] = int(m.group(1))
        elif "warning" in line.lower():
            out.setdefault("warnings", []).append(line.strip())
    return out


def bound_ms(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# (B, S, T, Hq, Hkv, D, window): tests/test_kernels.py's flash sweep plus gemma's
# D=256 MQA, recurrentgemma's windowed D=256 MQA, the smoke head dims, and the
# wgmma kernel's tile edges (tests/test_torch_gpu.py's FLASH_CASES)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, None), (2, 256, 256, 4, 1, 64, None), (1, 384, 384, 4, 2, 128, None),
    (1, 100, 100, 2, 2, 64, None), (1, 128, 256, 2, 2, 64, None), (1, 256, 256, 2, 2, 64, 16),
    (1, 256, 256, 2, 2, 64, 64), (1, 256, 256, 2, 2, 64, 1024), (1, 128, 128, 8, 1, 256, None),
    (1, 384, 384, 4, 1, 256, 128), (2, 64, 64, 4, 2, 16, None), (2, 40, 40, 6, 2, 8, None),
    (1, 200, 200, 4, 2, 128, None), (1, 300, 300, 4, 1, 256, None),  # ragged S and T across 128
    (1, 100, 300, 4, 2, 128, None), (1, 260, 130, 2, 1, 256, None),  # S < T, S > T
    (1, 512, 512, 4, 4, 128, 200), (1, 512, 512, 2, 1, 256, 100),  # windows off the tile grid
    (2, 256, 256, 4, 4, 128, None), (2, 256, 256, 16, 4, 128, None), (2, 320, 320, 16, 1, 256, 96),  # G 1/4/16
]


def two_term_excess(got, want) -> float:
    """max(|got - want| - 2^-7 |want|): at most TWO_TERM_ATOL when got is within
    one bf16 rounding of want."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - 2.0**-7 * want.abs()).max())


def flash_sweep(torch, ops, ref, dev) -> tuple[dict, int]:
    """FLASH_CASES in f32 and bf16, causal and not, through ``ops`` (the wgmma
    kernel for bf16 at D >= 16, the FMA kernel otherwise), each against the
    plain version at the dtype's tolerance; the bf16 cases at D >= 16 also
    through the FMA kernel, and the wgmma kernel also against the two-term
    plain version within one bf16 rounding. -> (worst error by check, cases)."""
    from repro_torch.kernels import flash_attention as flash

    g = torch.Generator(device=dev).manual_seed(1)
    worst = {"wgmma": 0.0, "fma": 0.0, "wgmma_two_term_excess": -1.0}
    n = 0
    for B, S, T, Hq, Hkv, D, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(dtype) for _ in range(2))
            name = flash.variant(dtype, D)
            for causal in (True, False):
                case = dict(B=B, S=S, T=T, Hq=Hq, Hkv=Hkv, D=D, window=window, causal=causal, dtype=str(dtype))
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                want = ref.attention_ref(qt, kt, vt, causal=causal, window=window).transpose(1, 2)
                before = ops.launch_counts()["flash_attention_wgmma"]
                got = ops.flash_attention(q, k, v, causal=causal, window=window)
                if ops.launch_counts()["flash_attention_wgmma"] != before + (name == "wgmma"):
                    raise AssertionError(f"flash_attention {case}: expected the {name} kernel")
                worst[name] = max(worst[name], check_close(f"flash_attention ({name})", got, want, **case))
                n += 1
                if name == "wgmma":
                    fma = flash.launch_fma(q, k, v, causal=causal, window=window)
                    worst["fma"] = max(worst["fma"], check_close("flash_attention (fma)", fma, want, **case))
                    two = ref.attention_ref(qt, kt, vt, causal=causal, window=window, p_bf16=2).transpose(1, 2)
                    excess = two_term_excess(got, two)
                    if not excess <= TWO_TERM_ATOL:
                        raise AssertionError(f"flash_attention (wgmma) {case}: {excess} beyond one bf16 rounding "
                                             "of attention_ref(p_bf16=2)")
                    worst["wgmma_two_term_excess"] = max(worst["wgmma_two_term_excess"], excess)
                    n += 1
    return worst, n


def rmsnorm_sweep(torch, ops, ref, dev) -> tuple[float, int]:
    g = torch.Generator(device=dev).manual_seed(2)
    worst, n = 0.0, 0
    for shape in [(4, 128), (2, 7, 256), (1, 1000, 512), (4, 2560), (128, 128), (32, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            s = torch.randn(shape[-1], generator=g, device=dev) * 0.1
            worst = max(worst, check_close("fused_rmsnorm", ops.fused_rmsnorm(x, s), ref.rmsnorm_ref(x, s),
                                           shape=shape, dtype=str(dtype)))
            n += 1
    return worst, n


# (B, S, W): tests/test_torch_gpu.py's SCAN_CASES (tests/test_kernels.py's sweep,
# the chunked kernel's tiling edges, several rounds, one long request, the
# largest batch, ragged widths)
SCAN_CASES = [(1, 128, 512), (2, 256, 512), (1, 200, 300), (1, 512, 128), (3, 37, 70),
              (1, 7, 512), (1, 8, 300), (1, 9, 70), (2, 31, 300), (1, 32, 512), (1, 33, 70),
              (1, 255, 300), (1, 256, 70), (1, 257, 256), (2, 1500, 300), (1, 2049, 70),
              (1, 8192, 256), (65535, 3, 4)]


def rglru_sweep(torch, ops, ref, dev) -> tuple[dict, int]:
    """SCAN_CASES in f32 and bf16 through ``ops`` (the chunked kernel) and
    through the sequential kernel it replaced, each against the plain version;
    then exact cases: the running count (a = b = 1: h_t = t + 1 in f32), the
    bf16 running sum (a = 1, b = 205/2048: h_t = bf16((t+1)·b), which a carry
    rounded to bf16 misses), two launches with equal bits; and f32 at 2e-5 on
    slow decays (a in [0.99, 1), 4096 steps), where the sequential kernel's
    distance from the plain version, in units of the tolerance, is reported
    (not bounded). -> (worst error by kernel, cases)."""
    import numpy as np

    from repro_torch.kernels import rglru_scan as rgk

    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"chunked": 0.0, "sequential": 0.0}
    n = 0
    for shape in SCAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.sigmoid(torch.randn(shape, generator=g, device=dev)).to(dtype)
            b = torch.randn(shape, generator=g, device=dev).to(dtype)
            want = ref.rglru_ref(a, b)
            case = dict(shape=shape, dtype=str(dtype))
            worst["chunked"] = max(worst["chunked"], check_close("rglru_scan", ops.rglru_scan(a, b), want, **case))
            worst["sequential"] = max(worst["sequential"], check_close("rglru_scan (sequential)",
                                                                       rgk.launch_sequential(a, b), want, **case))
            n += 2
    ones = torch.ones((1, 256, 128), device=dev)
    count = torch.arange(1, 257, dtype=torch.float32, device=dev)[None, :, None].expand(1, 256, 128)
    if not torch.equal(ops.rglru_scan(ones, ones), count):
        raise AssertionError("rglru_scan: the running count a = b = 1 is not exact")
    for W in (256, 70):
        a = torch.ones((1, 3000, W), dtype=torch.bfloat16, device=dev)
        b = torch.full((1, 3000, W), 205 / 2048, dtype=torch.bfloat16, device=dev)
        want = (torch.arange(1, 3001, dtype=torch.float32, device=dev) * (205 / 2048)).bfloat16()
        if not torch.equal(ops.rglru_scan(a, b), want[None, :, None].expand(1, 3000, W)):
            raise AssertionError(f"rglru_scan: the bf16 running sum at W = {W} is not exact")
    a = torch.sigmoid(torch.randn((2, 4096, 512), generator=g, device=dev))
    b = torch.randn((2, 4096, 512), generator=g, device=dev)
    if not torch.equal(ops.rglru_scan(a, b), ops.rglru_scan(a, b)):
        raise AssertionError("rglru_scan: two launches on the same inputs differ")
    rng = np.random.default_rng(7)  # tests/test_torch_gpu.py's slow-decay inputs
    a = torch.from_numpy(rng.uniform(0.99, 1.0, (1, 4096, 256)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((1, 4096, 256)).astype(np.float32)).to(dev)
    want = ref.rglru_ref(a, b)
    worst["chunked"] = max(worst["chunked"], check_close("rglru_scan (slow decays)", ops.rglru_scan(a, b), want))
    tol = TOL["float32"]
    excess = (rgk.launch_sequential(a, b) - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
    worst["sequential_slow_decays_over_tol"] = float(excess.max())
    return worst, n + 5


def time_flash(torch, F, ops, ref, dev, cfg, B: int, S: int) -> dict:
    """The prefill's attention call: B x S tokens, causal, the config's window,
    bf16, through ``ops`` (the wgmma kernel), held to the plain version three
    ways, and timed beside the FMA kernel it replaced, the plain version and
    SDPA. ``one_term_err_over_rms`` is how far one bf16 term of P alone
    (``attention_ref(p_bf16=1)``) would put the output from f32 P, against the
    output's RMS: the reason the kernel feeds P as two terms."""
    from repro_torch.kernels import flash_attention as flash

    g = torch.Generator(device=dev).manual_seed(3)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16() for _ in range(2))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    want = ref.attention_ref(qt, kt, vt, window=window).transpose(1, 2)
    before = ops.launch_counts()["flash_attention_wgmma"]
    got = ops.flash_attention(q, k, v, window=window)
    if ops.launch_counts()["flash_attention_wgmma"] != before + 1:
        raise AssertionError("flash_attention at the prefill shape did not take the wgmma kernel")
    err = check_close("flash_attention", got, want, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window)
    rms = float(want.float().square().mean().sqrt())
    if not err < FLASH_MAIN_MAX_ERR_OVER_RMS * rms:
        raise AssertionError(f"flash_attention at the prefill shape: max abs error {err} against output RMS {rms}")
    excess = two_term_excess(got, ref.attention_ref(qt, kt, vt, window=window, p_bf16=2).transpose(1, 2))
    if not excess <= TWO_TERM_ATOL:
        raise AssertionError(f"flash_attention at the prefill shape: {excess} beyond one bf16 rounding of p_bf16=2")
    one_term = ref.attention_ref(qt, kt, vt, window=window, p_bf16=1).transpose(1, 2)
    one_term_err = float((one_term.float() - want.float()).abs().max())
    fma = flash.launch_fma(q, k, v, causal=True, window=window)
    fma_err = check_close("flash_attention (fma)", fma, want, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window)
    del got, one_term, fma
    w = window or S
    pairs = sum(min(i + 1, w) for i in range(S))  # causal (windowed) (q, k) pairs each (b, head) computes
    flops = 4 * B * Hq * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)  # q, o + k, v in bf16
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    if window is None:
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
        library_call = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    else:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        kr, vr = kt.repeat_interleave(Hq // Hkv, dim=1), vt.repeat_interleave(Hq // Hkv, dim=1)
        library = lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask)  # noqa: E731
        library_call = f"F.scaled_dot_product_attention(attn_mask=causal window {window}), k/v repeated to {Hq} heads"
    return {
        "shape": f"q {B}x{S}x{Hq}x{D}, k/v {B}x{S}x{Hkv}x{D}, bf16, causal"
                 + (f", window {window}" if window else ""),
        "variant": "wgmma", "max_abs_err": err, "output_rms": rms, "two_term_excess": excess,
        "one_term_err_over_rms": one_term_err / rms, "fma_max_abs_err": fma_err,
        **timed("", lambda: ops.flash_attention(q, k, v, window=window), 20),
        **timed("fma_", lambda: flash.launch_fma(q, k, v, causal=True, window=window), 3),
        **timed("plain_", lambda: ref.attention_ref(qt, kt, vt, window=window), 3),
        **timed("library_", library, 10),
        "library_call": library_call,
        "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
    }


def time_rglru(torch, ops, ref, dev, shapes: list[tuple[int, int, int]]) -> list[dict]:
    """The prefill's scan at each (B, S, W) of ``shapes``: a and b from the
    gates, f32, through ``ops`` (the chunked kernel), timed beside the
    sequential kernel it replaced and the plain version. The plain version, a
    Python loop over S, is profiled last for every shape: after a session of
    its tens of thousands of kernels, the profiler on the card's machine drops
    the first kernel record of each later session, which ``time_ms`` takes for
    a lost launch. ``resident_clusters``: how many of the chunked kernel's
    clusters the card holds at once."""
    from functools import partial

    from repro_torch.kernels import rglru_scan as rgk

    g = torch.Generator(device=dev).manual_seed(6)
    rows, inputs = [], []
    for B, S, W in shapes:
        a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        b = torch.randn((B, S, W), generator=g, device=dev)
        want = ref.rglru_ref(a, b)
        err = check_close("rglru_scan", ops.rglru_scan(a, b), want, B=B, S=S, W=W)
        seq_err = check_close("rglru_scan (sequential)", rgk.launch_sequential(a, b), want, B=B, S=S, W=W)
        del want
        nbytes = 3 * B * S * W * a.element_size()  # a, b read, h written
        bms, by = bound_ms(nbytes, 2 * B * S * W, "float32")  # one FMA per element
        cluster = rgk.cluster_size(S)
        rows.append({
            "shape": f"{B}x{S}x{W} f32",
            "max_abs_err": err, "sequential_max_abs_err": seq_err,
            "cluster": cluster, "rounds": -(-S // (cluster * rgk.SUB_CHUNK * rgk.WARPS)),
            "resident_clusters": rgk.max_active_clusters(a.dtype, W, cluster),
            **timed("", partial(ops.rglru_scan, a, b), 20),
            **timed("sequential_", partial(rgk.launch_sequential, a, b), 20),
            "library_ms": None, "library_call": "none: no single PyTorch call computes a first-order linear recurrence",
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
        })
        inputs.append((a, b))
    for row, (a, b) in zip(rows, inputs):
        row.update(timed("plain_", partial(ref.rglru_ref, a, b), 2))
    return rows


def time_rmsnorm(torch, F, ops, ref, dev, rows: int, D: int, dtype) -> dict:
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((rows, D), generator=g, device=dev).to(dtype)
    s = torch.randn(D, generator=g, device=dev) * 0.1
    w = (1.0 + s).to(dtype)
    err = check_close("fused_rmsnorm", ops.fused_rmsnorm(x, s), ref.rmsnorm_ref(x, s), rows=rows, D=D)
    name = str(dtype).removeprefix("torch.")
    nbytes = 2 * rows * D * x.element_size() + 4 * D  # x read, y written, scale read
    bms, by = bound_ms(nbytes, 4 * rows * D, "float32")  # x*x, sum, *rsqrt, *(1+scale) in f32
    return {
        "shape": f"{rows}x{D} {name}",
        "max_abs_err": err,
        **timed("", lambda: ops.fused_rmsnorm(x, s), 50),
        **timed("plain_", lambda: ref.rmsnorm_ref(x, s), 50),
        **timed("library_", lambda: F.rms_norm(x, (D,), weight=w, eps=1e-6), 50),
        "library_call": "F.rms_norm(weight=1+scale)",
        "bound_ms": bms, "bound_by": by, "bytes": nbytes,
    }


# (steps a thread, warps a block) that --scan-tilings builds and times; the
# port runs the first, csrc/rglru_scan.cu's default
SCAN_TILINGS = [(8, 4), (8, 8), (6, 4), (12, 4), (4, 4), (8, 2)]


def scan_tilings(torch, ref, dev, W: int) -> None:
    """The chunked scan built at each tiling of SCAN_TILINGS (nvcc with
    ``-DRGLRU_SUB``, ``-DRGLRU_WARPS``; all at once), one line each: its
    registers, shared memory and spills, the clusters of 8 blocks the card
    holds at width W, and at (2, 4096, W) and (1, 4096, W) in f32 and
    (2, 4096, W) in bf16 its time, share of the bound and distance from the
    plain version (within the kernels' tolerance, or this raises)."""
    from concurrent.futures import ThreadPoolExecutor
    from functools import partial

    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rgk

    flag_sets = [(f"-DRGLRU_SUB={sub}", f"-DRGLRU_WARPS={warps}") for sub, warps in SCAN_TILINGS]
    with ThreadPoolExecutor(len(flag_sets)) as pool:
        list(pool.map(partial(build.build, ["rglru_scan"]), flag_sets))
    g = torch.Generator(device=dev).manual_seed(6)
    inputs = []
    for B, dtype in ((2, torch.float32), (1, torch.float32), (2, torch.bfloat16)):
        a = torch.sigmoid(torch.randn((B, 4096, W), generator=g, device=dev)).to(dtype)
        b = torch.randn((B, 4096, W), generator=g, device=dev).to(dtype)
        inputs.append((f"{B}x4096x{W} {str(dtype).removeprefix('torch.')}", a, b, ref.rglru_ref(a, b)))
    for (sub, warps), flags in zip(SCAN_TILINGS, flag_sets):
        if rgk.library(flags)[1][:2] != (sub, warps):
            raise AssertionError(f"the scan built with {flags} reports the tiling {rgk.library(flags)[1]}")
        log = build.library_path("rglru_scan", flags).with_suffix(".log").read_text()
        row = {"steps_a_thread": sub, "warps_a_block": warps,
               "ptxas": {k: r for k, r in ptxas_report(log).items() if "rglru_chunked" in k},
               "resident_clusters_of_8": {str(dt): rgk.max_active_clusters(dt, W, 8, flags=flags)
                                          for dt in (torch.float32, torch.bfloat16)}}
        for name, a, b, want in inputs:
            fn = partial(rgk.launch, a, b, flags=flags)
            err = check_close(f"rglru_scan {sub}x{warps}", fn(), want, case=name)
            device_ms, events_ms = time_ms(fn, iters=20)
            bms, _ = bound_ms(3 * a.numel() * a.element_size(), 2 * a.numel(), "float32")
            row[name] = {"ms": device_ms, "events_ms": events_ms, "share_of_bound": bms / device_ms,
                         "max_abs_err": err}
        emit("scan_tiling", **row)


def main() -> int:
    import torch

    if sys.argv[1:] not in ([], ["--scan-tilings"]):
        print(f"usage: {sys.argv[0]} [--scan-tilings]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvidia_smi=smi)
    if sys.argv[1:] == ["--scan-tilings"]:
        scan_tilings(torch, ref, dev, get_config("recurrentgemma-9b").lru_width)
        print(smi, flush=True)
        return 0

    # -- build: nvcc (one process per source, all at once), then the first Triton compile ----
    cuda_kernels = [k for k, (route, _, _) in SOURCES.items() if route == "cuda"]
    t0 = time.perf_counter()
    build.build(cuda_kernels)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops.fused_rmsnorm(torch.ones((4, 2560), device=dev, dtype=torch.bfloat16), torch.zeros(2560, device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(build.library_path(name).with_suffix(".log").read_text()) for name in cuda_kernels}
    emit("build", nvcc_s=nvcc_s, first_triton_compile_s=triton_s, ptxas=ptxas)
    for lib, kernel in (("flash_attention", "wgmma"), ("rglru_scan", "rglru_chunked")):
        spills = {k: r for k, r in ptxas[lib].items()
                  if kernel in k and (r.get("spill_stores", 0) or r.get("spill_loads", 0))}
        if spills:
            raise AssertionError(f"the {kernel} kernels spill registers: {spills}")

    # -- kernels against their plain versions, then timed at the main paths' shapes ---------
    qwen, hyb = get_config("qwen3-4b"), get_config("recurrentgemma-9b")
    sweep_err, sweep_cases = {}, {}
    sweeps = {"flash_attention": flash_sweep, "fused_rmsnorm": rmsnorm_sweep, "rglru_scan": rglru_sweep}
    for name, sweep in sweeps.items():
        sweep_err[name], sweep_cases[name] = sweep(torch, ops, ref, dev)
    emit("kernels_sweep", cases=sweep_cases, max_abs_err=sweep_err)
    qB, qS = PATHS["qwen3-4b"]["B"], PATHS["qwen3-4b"]["S"]
    hB, hS = PATHS["recurrentgemma-9b"]["B"], PATHS["recurrentgemma-9b"]["S"]
    timing = {  # the first row of each kernel is its summary row
        "flash_attention": [time_flash(torch, F, ops, ref, dev, qwen, qB, qS),
                            time_flash(torch, F, ops, ref, dev, hyb, hB, hS)],
        "fused_rmsnorm": [
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS, qwen.d_model, torch.bfloat16),  # norm1, final_norm
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS, qwen.d_model, torch.float32),  # norm2 on the f32 sum
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS * qwen.n_heads, qwen.head_dim, torch.bfloat16),  # q_norm
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS * qwen.n_kv_heads, qwen.head_dim, torch.bfloat16),  # k_norm
            time_rmsnorm(torch, F, ops, ref, dev, hB * hS, hyb.d_model, torch.bfloat16),  # hybrid norm1 after a carry
            time_rmsnorm(torch, F, ops, ref, dev, hB * hS, hyb.d_model, torch.float32),  # hybrid norms on f32 sums
        ],
        # the hybrid prefill's, and one prompt through Model.forward
        "rglru_scan": time_rglru(torch, ops, ref, dev, [(hB, hS, hyb.lru_width), (1, hS, hyb.lru_width)]),
    }
    for name, rows in timing.items():
        for row in rows:
            emit("kernel_timing", name=name, **row)
    torch.cuda.empty_cache()

    # -- the two paths: prefill, serve, profile, check -------------------------------------------
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch in PATHS:
        for counts in drive_path(torch, get_config, ops, dev, arch):
            for name, n in counts.items():
                launches[name] += n
        torch.cuda.empty_cache()

    summary = []
    for name, rows in timing.items():
        main_row = rows[0]
        route, src, replaces = SOURCES[name]
        main_kernel = {"flash_attention": "wgmma", "rglru_scan": "chunked"}.get(name)
        worst = sweep_err[name][main_kernel] if main_kernel else sweep_err[name]
        row = {
            "name": name, "route": route, "source": src, "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(worst, *(r["max_abs_err"] for r in rows)),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            "events_ms": main_row["events_ms"],
        }
        if name == "flash_attention":  # the main path's kernel, and the one it replaced
            n_wgmma = launches["flash_attention_wgmma"]
            row["variants"] = {
                "wgmma": {"launches": n_wgmma, "ms": [r["ms"] for r in rows], "max_abs_err": row["max_abs_err"]},
                "fma": {"launches": launches[name] - n_wgmma, "ms": [r["fma_ms"] for r in rows],
                        "max_abs_err": max(sweep_err[name]["fma"], *(r["fma_max_abs_err"] for r in rows))},
            }
            if n_wgmma != launches[name]:
                raise AssertionError(f"flash launches on the main paths: {n_wgmma} of {launches[name]} on wgmma")
        if name == "rglru_scan":  # ops launches only the chunked kernel; the sequential one is timed beside it
            row["variants"] = {
                "chunked": {"launches": launches[name], "shapes": [r["shape"] for r in rows],
                            "ms": [r["ms"] for r in rows], "max_abs_err": row["max_abs_err"]},
                "sequential": {"launches": launches["rglru_scan_sequential"], "ms": [r["sequential_ms"] for r in rows],
                               "max_abs_err": max(sweep_err[name]["sequential"],
                                                  *(r["sequential_max_abs_err"] for r in rows))},
            }
        summary.append(row)
    missing = [k["name"] for k in summary if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def drive_path(torch, get_config, ops, dev, arch: str) -> tuple[dict, dict]:
    """Prefill, serve, profile and check one architecture at full width through
    ``Model`` and ``BatchedServer``. -> the kernel launches of the prefill and
    of the serve run, each counted from 0 just before it."""
    import numpy as np

    from repro_torch.launch.serve import BatchedServer, make_requests
    from repro_torch.models import Model

    path = PATHS[arch]
    B, S = path["B"], path["S"]
    cfg = get_config(arch)

    # -- prefill: Model.forward at full width ------------------------------------
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    server = BatchedServer(model, batch=4, max_len=128, seed=0)  # draws the weights once for both phases
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = server.params
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))).to(dev)
    t0 = time.perf_counter()
    model.forward(params, {"tokens": tokens})  # compiles the Triton kernel for the prefill's shapes
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(logits.float()).all())
    emit("prefill", arch=arch, n_params=cfg.n_params(), batch=B, seq=S, logits_shape=list(logits.shape),
         finite=finite, init_s=init_s, first_call_ms=first_ms, wall_ms=prefill_ms,
         tokens_per_s=B * S / (prefill_ms / 1e3), peak_memory_gb=peak_gb, launches=prefill_counts)
    if not finite or tuple(logits.shape) != (B, S, cfg.vocab):
        raise AssertionError(f"{arch} prefill logits: shape {tuple(logits.shape)}, finite {finite}")
    if prefill_counts != path["prefill"]:
        raise AssertionError(f"{arch} prefill launches {prefill_counts}, expected {path['prefill']}")
    del logits
    torch.cuda.empty_cache()

    # -- serve: BatchedServer at full width -------------------------------------------
    warm_state = model.init_decode_state(4, 128)  # compiles the decode shapes' Triton kernels
    model.decode_step(params, {"tokens": torch.zeros((4, 1), dtype=torch.int64, device=dev)}, warm_state, 0)
    del warm_state
    torch.cuda.synchronize()
    reqs = make_requests(cfg.vocab, 8, 12)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats = server.run(reqs)
    serve_counts = ops.launch_counts()
    new_tokens = sum(len(r.out) for r in reqs)
    emit("serve", arch=arch, batch=4, max_len=128, requests=len(reqs), requests_done=stats["requests_done"],
         decode_steps=stats["decode_steps"], wall_s=stats["wall_s"], new_tokens=new_tokens,
         tokens_per_s=new_tokens / stats["wall_s"], mean_step_ms=stats["metrics"]["mean_step_s"] * 1e3,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=serve_counts)
    if stats["requests_done"] != len(reqs):
        raise AssertionError(f"{arch}: served {stats['requests_done']} of {len(reqs)} requests")
    want = {k: n * stats["decode_steps"] for k, n in path["per_step"].items()}
    if serve_counts != want:
        raise AssertionError(f"{arch} serve launches {serve_counts}, expected {path['per_step']} per decode step")
    emit("profile", arch=arch, **profile_phase(torch, model, params, tokens, dev))
    del server, params, tokens
    torch.cuda.empty_cache()

    # -- check: kernel path vs plain path, and decode vs prefill, at smoke size -------------
    emit("check", **smoke_check(torch, get_config, Model, ops, dev, arch, path["check_tokens"]))
    return prefill_counts, serve_counts


def profile_phase(torch, model, params, tokens, dev) -> dict:
    """torch.profiler over one prefill forward and over 3 decode steps at batch
    4: device busy time (sum of kernel self times; one stream, so no overlap),
    the idle share of the synchronised wall time, and the kernels that take
    the most device time. The profiler's own host cost inflates the wall time,
    so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    state = model.init_decode_state(4, 128)
    step_tokens = torch.zeros((4, 1), dtype=torch.int64, device=dev)

    def decode_steps():
        for i in range(3):
            model.decode_step(params, {"tokens": step_tokens}, state, i)

    out = {}
    for name, fn in (("prefill", lambda: model.forward(params, {"tokens": tokens})), ("decode_3_steps", decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_events(prof)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3} for e in top],
        }
    return out


def smoke_check(torch, get_config, Model, ops, dev, arch: str, n_tokens: int) -> dict:
    """The smoke config on the card (the kernels) and on the CPU (their plain
    versions), with the same weights and tokens, for prefill and for decode.

    - prefill, card vs CPU: bound 0.1, as the ``-m gpu`` test of the same
      (matrix products sum in another order on the card);
    - decode, card vs CPU, step by step: bound ``DECODE_CARD_VS_CPU``, the
      kernels' bf16 tolerance. Decode runs the same matrix-vector products
      and the RMSNorm kernel, so this holds the card to the plain path;
    - decode vs prefill on the card against the same gap on the CPU: bound
      0.1. The gap itself is the reference's own (prefill keeps softmax
      probabilities in f32 and scans, decode rounds them to bf16 and steps
      ``h``) and at recurrentgemma-9b smoke is 0.041-0.084 for the JAX
      package over three token seeds (tests/test_torch_rglru.py), so it is
      reported, not bounded."""
    import numpy as np

    from repro_torch.models.modules import tree_map_with_path

    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(0))
    params = tree_map_with_path(lambda _, a: a.to(dev), params_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, n_tokens)))
    ops.reset_launch_counts()
    fwd, _ = gpu.forward(params, {"tokens": toks.to(dev)})
    flash_counts = {k: ops.launch_counts()[k] for k in ("flash_attention", "flash_attention_wgmma")}
    if not flash_counts["flash_attention"] == flash_counts["flash_attention_wgmma"] > 0:
        raise AssertionError(f"{arch} smoke prefill: flash launches {flash_counts}, all expected on wgmma")
    fwd_cpu, _ = cpu.forward(params_cpu, {"tokens": toks})
    fwd = fwd.cpu().float()
    fwd_cpu = fwd_cpu.float()
    state, state_cpu = gpu.init_decode_state(1, 32), cpu.init_decode_state(1, 32)
    decode_err, gap, gap_cpu = [], [], []
    for t in range(n_tokens):
        logits, state = gpu.decode_step(params, {"tokens": toks[:, t : t + 1].to(dev)}, state, t)
        logits_cpu, state_cpu = cpu.decode_step(params_cpu, {"tokens": toks[:, t : t + 1]}, state_cpu, t)
        logits, logits_cpu = logits.cpu().float(), logits_cpu.float()
        decode_err.append(float((logits - logits_cpu).abs().max()))
        gap.append(float((logits[0] - fwd[0, t]).abs().max()))
        gap_cpu.append(float((logits_cpu[0] - fwd_cpu[0, t]).abs().max()))
    out = {
        "arch": cfg.name, "tokens": n_tokens, "prefill_flash_launches": flash_counts,
        "prefill_card_vs_cpu_max_abs": float((fwd - fwd_cpu).abs().max()), "prefill_bound": 0.1,
        "decode_card_vs_cpu_max_abs": max(decode_err), "decode_bound": DECODE_CARD_VS_CPU,
        "decode_vs_prefill_card": max(gap), "decode_vs_prefill_cpu": max(gap_cpu),
        "gap_card_vs_cpu": max(abs(x - y) for x, y in zip(gap, gap_cpu)), "gap_bound": 0.1,
    }
    if not (out["prefill_card_vs_cpu_max_abs"] < 0.1 and out["decode_card_vs_cpu_max_abs"] < DECODE_CARD_VS_CPU
            and out["gap_card_vs_cpu"] < 0.1):
        raise AssertionError(f"smoke check out of bound: {out}")
    return out


if __name__ == "__main__":
    sys.exit(main())
