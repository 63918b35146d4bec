#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and exits non-zero:

1. device  -- the card, torch/CUDA versions, ``nvidia-smi`` name and power limit;
2. build   -- nvcc build of the CUDA kernels from ``src/repro_torch/csrc`` (one
              nvcc per source, all at once), then the first Triton compile, each
              timed; no kernel of the flash backward library, the wgmma forward
              or the chunked scan may spill registers;
3. kernels -- every hand-written kernel against its plain PyTorch version on the
              card over the sweep of the CPU tests plus the main paths' shapes
              (f32 2e-5, bf16 2e-2), both flash kernels (wgmma for bf16 at head
              dim 16-256, FMA for f32 and D = 8, and the FMA kernel on the bf16
              cases too), then timed at the main paths' shapes beside its plain
              version, one PyTorch library call (where one exists) and its
              bound; flash also beside the FMA kernel it replaced, the RG-LRU
              scan (chunked, parallel in time) beside the sequential kernel it
              replaced, at B = 2 and 1;

   and the three backward kernels (flash attention's and the RG-LRU scan's
              in CUDA, RMSNorm's in Triton) against their plain backward versions
              over the forward sweep, then timed at the training shapes beside
              the plain backward, the library call's backward through autograd
              (where one exists) and the bound; the flash backward as the wgmma
              pair (from the forward's lse, held to the plain lse) beside the mma
              and FMA pairs it replaced at qwen3-4b's shape, and beside the FMA
              pair at the hybrid's (windowed MQA at head dim 256, with its dQ,
              dK/dV and partial-sum kernels apart); the scan backward
              at 1 and 2 x 4096 x 4096 f32, also held to its own order of
              arithmetic, its two launches equal to the bit;

then five serving paths and two paths from embeddings, each through the
entry points a user calls, with random weights drawn from seed 0, each freed
before the next (every line carries ``t_s``, the seconds since the start):

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
              flash launch on the wgmma kernel (head dim 16; the MoE smoke
              configs' head dim 8 takes the FMA kernel);

  recurrentgemma-9b (hybrid: RG-LRU scan, windowed MQA at head dim 256):
4-7 again, prefill on 2 x 4096 tokens (the window of 2048 binds) asserting 12
flash-attention (all wgmma), 77 RMSNorm and 26 RG-LRU scan launches, serve
asserting 77 RMSNorm launches per decode step, and the check over 12 tokens,
past the smoke window of 8.

  deepseek-moe-16b (MoE: 2 shared + 64 routed experts, top 6, a dense layer 0;
  MHA, 16 q-heads on 16 kv-heads), at full size (16.4 B parameters, 32.9 GB):
4-7 again, prefill on 2 x 2048 tokens asserting 28 flash (all wgmma) and 57
RMSNorm launches, its line also giving the MoE's capacity (488) and dropped
fraction per layer, serve asserting 57 RMSNorm launches per decode step, the
profile also giving the device time of each MoE scope (router, dispatch,
experts, combine, shared experts), and the check with the routes of both
devices counted (a route flip limits the logit comparisons to the tokens
before it) and each MoE layer held layer by layer;

  qwen3-moe-235b-a22b (128 routed experts, top 8, GQA 64 / 4, qk-norms) at
  full width cut to 4 layers (94 need 470 GB): 4-7 again, prefill on 2 x 2048
  tokens asserting 4 flash and 17 RMSNorm launches, serve asserting 17 a step.

  xlstm-125m (attention-free: (sLSTM, mLSTM x 3) x 3), uncut: 4-7 again,
  prefill on 2 x 2048 tokens asserting 25 RMSNorm launches and no flash,
  serve asserting 25 a step, the profile also giving the device and host
  time of the sLSTM's time loop and the mLSTM's chunks (``xlstm_scopes``),
  the check over 16 tokens (two smoke chunks).

  qwen2-vl-2b (GQA 12 / 2: a group of 6, M-RoPE) and musicgen-medium (MHA 24
  heads at head dim 64), uncut, from random bf16 embeddings: 4 and 6-7 again,
  prefill on 2 x 2048 (qwen2-vl at image positions whose three M-RoPE streams
  differ, MROPE_TEXT and MROPE_GRID) asserting 28 and 48 flash launches (all
  wgmma) and 57 and 97 RMSNorm launches; in place of the server (the JAX
  server takes token prompts) 8 ``Model.decode_step`` calls at batch 4 from
  embeddings (phase ``decode``), 57 and 97 RMSNorm launches a step; the check
  also holds qwen2-vl's smoke prefill at image positions, card vs CPU.

then the training paths:

8. train   -- ``make_train_step`` (``Model.loss``, autograd through the backward
              kernels, in-place AdamW with f32 moments), each after its memory
              reckoning line: on full qwen3-4b (36 layers, the config's remat
              "full") at B = 1, S = 2048, then on recurrentgemma-9b at full width
              cut to 8 layers (2 stacked units + the 2 remainder rec layers; 11
              do not fit, see TRAIN_HYBRID) at B = 1, S = 4096, then on
              deepseek-moe-16b at full width cut to 6 layers (TRAIN_MOE) at
              B = 1, S = 2048, then on xlstm-125m uncut at B = 8, S = 512
              (TRAIN_XLSTM: whole chunks of 256), from
              ``SyntheticLM``: one warm-up step whose loss and gradients must
              be finite, three timed steps (step ms,
              tokens/s, peak GB, loss / grad_norm / lr, launches of every kernel
              per step, each asserted against ``train_launches``), and
              torch.profiler over a fourth step;
   device_plane -- after each train line, one more step profiled into the
              device tree (``repro_torch.core.device_tree``, keyed by the JAX
              package's scope names): the device ms under the forward
              (``jvp(loss)``), the backward (``transpose(jvp(loss))``), the
              optimizer and the rest (and the bytes each moves), the idle
              share, the top components by
              device ms, the tree's flops against 6 N D, the tree's roofline
              bound on the H100 against the measured step, and the hand-written
              kernels the tree holds against ``ops.launch_counts()``; it fails
              when the tree is empty, when the backward holds no kernel, or
              when a ``flash_attention`` / ``fused_rmsnorm`` / ``rglru_scan``
              kernel of the path is missing from either branch;
9. trainer -- ``Trainer`` at qwen3-4b smoke on the card with the sampler and the
              watchdog on: 3 steps and a checkpoint, a second Trainer that resumes
              to 6, a third that runs 6 in one go; parameters and optimizer state
              equal to the bit; heartbeat, metrics.json and host_profile.html;
10. train_check -- one train step at the smoke config of qwen3-4b,
              recurrentgemma-9b, deepseek-moe-16b and xlstm-125m through the kernels on the
              card, and the same step through the plain versions on the card and
              on the CPU, from the same weights and batch: loss, moments and each
              leaf's update within ``TRAIN_CARD_VS_CPU`` of the references
              ``TRAIN_CHECKS`` names (the card's plain path for all, the CPU's
              for qwen3-4b and deepseek-moe-16b too), with the MoE's route flips
              between the runs and the plain path's response to a 1e-6 nudge
              of the norm scales reported;
11. grads_check -- at each of those smoke configs and at qwen2-vl-2b's and
              musicgen-medium's (from an embeddings batch), ``Model.loss`` and its
              gradient (the initial weights, each stacked matrix at the std of
              its unstacked spec: see GRADS_CARD_VS_CPU) on the card (flash attention
              through its plain f32 version, the other kernels launched) and on
              the CPU: the loss and each leaf's gradient within
              ``GRADS_CARD_VS_CPU`` (the loss within ``GRADS_LOSS_BOUND`` where
              it names the arch), the same pass through the plain versions on
              the card and the CPU loss's nudge response reported beside them;
              for musicgen-medium (BF16_REDUCTION_PROBE) also the card pass
              with cuBLAS's reduced-precision bf16 reduction switched the
              other way, both gaps printed.

Then the card's ``nvidia-smi`` line, the kernels summary (six kernels, each
launched on the main paths) and, last, ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package ``repro``.

  python3 chip_smoke.py --scan-tilings

instead builds the chunked RG-LRU scan at each tiling of ``SCAN_TILINGS`` and
prints one ``scan_tiling`` line for each (registers and spills, clusters the
card holds, time at the hybrid prefill's scan shapes), then the card's
``nvidia-smi`` line: how the port's tiling was chosen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Each path: its prefill shape and the kernel launches its prefill and each
# decode step must make (every counter of ops.launch_counts(), 0 unless named).
NO_LAUNCHES = dict.fromkeys(("flash_attention", "flash_attention_wgmma", "fused_rmsnorm", "rglru_scan",
                             "rglru_scan_sequential", "flash_attention_bwd", "flash_attention_bwd_wgmma",
                             "flash_attention_bwd_mma", "fused_rmsnorm_bwd", "rglru_scan_bwd"), 0)
PATHS = {
    "qwen3-4b": dict(B=2, S=2048, check_tokens=8,
                     prefill={**NO_LAUNCHES, "flash_attention": 36, "flash_attention_wgmma": 36, "fused_rmsnorm": 145},
                     per_step={**NO_LAUNCHES, "fused_rmsnorm": 145}),
    "recurrentgemma-9b": dict(B=2, S=4096, check_tokens=12,
                              prefill={**NO_LAUNCHES, "flash_attention": 12, "flash_attention_wgmma": 12,
                                       "fused_rmsnorm": 77, "rglru_scan": 26},
                              per_step={**NO_LAUNCHES, "fused_rmsnorm": 77}),
    # MoE: 16,375,728,128 parameters, 32.9 GB in bf16 storage (the dense layer 0
    # stays f32); the init draws the (27, 64, 2048, 1408) expert leaves one at
    # a time in f32, 19.9 GB transient beside the bf16 copy
    "deepseek-moe-16b": dict(B=2, S=2048, check_tokens=8,
                             prefill={**NO_LAUNCHES, "flash_attention": 28, "flash_attention_wgmma": 28,
                                      "fused_rmsnorm": 57},
                             per_step={**NO_LAUNCHES, "fused_rmsnorm": 57}),
    # full width cut in depth: 94 layers need 470 GB in bf16; 4 layers have
    # 11,195,683,840 parameters, 22.4 GB (the expert leaf drawn in f32: 12.9 GB)
    "qwen3-moe-235b-a22b": dict(B=2, S=2048, check_tokens=8, n_layers=4,
                                depth_why="94 layers need 470 GB in bf16, beyond one 80 GB card; 4 layers "
                                          "(22.4 GB) fit",
                                prefill={**NO_LAUNCHES, "flash_attention": 4, "flash_attention_wgmma": 4,
                                         "fused_rmsnorm": 17},
                                per_step={**NO_LAUNCHES, "fused_rmsnorm": 17}),
    # attention-free, uncut (114,509,568 parameters): per layer norm1 and the
    # cell's out_norm, plus the final norm; the prefill's 2048 tokens are 8
    # mLSTM chunks of 256 and 2048 sLSTM steps; the check runs 16 tokens, two
    # smoke chunks of 8 (a prefill takes whole chunks)
    "xlstm-125m": dict(B=2, S=2048, check_tokens=16,
                       prefill={**NO_LAUNCHES, "fused_rmsnorm": 25},
                       per_step={**NO_LAUNCHES, "fused_rmsnorm": 25}),
    # the embeddings-input families, uncut: no server (the JAX server takes
    # token prompts), decode_steps Model.decode_step calls at batch 4 instead;
    # qwen2-vl-2b: GQA 12 / 2 (a group of 6) at head dim 128, M-RoPE over an
    # image's (t, h, w) positions; musicgen-medium: MHA 24 heads at head dim 64
    "qwen2-vl-2b": dict(B=2, S=2048, check_tokens=8, decode_steps=8,
                        prefill={**NO_LAUNCHES, "flash_attention": 28, "flash_attention_wgmma": 28,
                                 "fused_rmsnorm": 57},
                        per_step={**NO_LAUNCHES, "fused_rmsnorm": 57}),
    "musicgen-medium": dict(B=2, S=2048, check_tokens=8, decode_steps=8,
                            prefill={**NO_LAUNCHES, "flash_attention": 48, "flash_attention_wgmma": 48,
                                     "fused_rmsnorm": 97},
                            per_step={**NO_LAUNCHES, "fused_rmsnorm": 97}),
}
# qwen2-vl-2b's prefill positions: 64 text tokens, an image of 2 x 30 x 32
# (t, h, w) patches (1,920), then 64 text tokens, as Qwen2-VL lays them out
MROPE_TEXT, MROPE_GRID = 64, (2, 30, 32)
# The training paths, at B x S tokens a step. Parameters, gradients and the
# two f32 AdamW moments take 16 bytes a parameter.
# - full qwen3-4b, uncut (36 layers): 70.6 GB of the card's 85 GB; the step's
#   peak is 78.1 GB;
# - recurrentgemma-9b at full width, cut in depth: 38 layers need 150 GB of
#   state. At 11 layers (3 stacked units + the 2 remainder rec layers, 55.8 GB)
#   the step ran out of memory on an H100 (76.5 GB in use when the loss's
#   backward asked for 3.9 GB more: the f32 logits of 4096 x 256,000 are
#   4.2 GB and the loss keeps several); at 8 layers (2 units + 2 remainder,
#   45.3 GB) its peak is 75.0 GB. S = 4096, so that the window of 2048 binds
#   in the backward too.
# ``flash`` names the flash kernels each step must take (forward, backward):
# the wgmma kernel and pair for both (bf16 at D = 128 and 256).
TRAIN = dict(arch="qwen3-4b", B=1, S=2048, timed_steps=3, flash=("wgmma", "wgmma"))
TRAIN_HYBRID = dict(arch="recurrentgemma-9b", B=1, S=4096, timed_steps=3, n_layers=8, flash=("wgmma", "wgmma"),
                    depth_why="38 layers need 150 GB of state; 11 ran out of memory on an H100; 8 fit")
# deepseek-moe-16b at full width, cut in depth: 28 layers need 262 GB of f32
# state; 6 (the dense layer 0 and 5 MoE units, 3,442,763,776 parameters) need
# 55.1 GB, and the f32 logits of 2048 x 102,400 are 0.84 GB.
TRAIN_MOE = dict(arch="deepseek-moe-16b", B=1, S=2048, timed_steps=3, n_layers=6, flash=("wgmma", "wgmma"),
                 depth_why="28 layers need 262 GB of f32 state; 6 (the dense layer and 5 MoE units) need 55.1 GB")
# xlstm-125m uncut (1.8 GB of f32 state), remat "full": 8 x 512 tokens a
# step, so each mLSTM layer differentiates two whole chunks of 256 (where the
# JAX package's gradient is NaN) and each sLSTM layer a loop of 512 steps
TRAIN_XLSTM = dict(arch="xlstm-125m", B=8, S=512, timed_steps=3)
# One train step at qwen3-4b smoke, card against CPU, from the same weights and
# batch: the loss within 0.01; each moment leaf within 5 % relative L2 (the
# matrix products sum in another order on the card, and bf16 activations round
# the difference up); each leaf's update (parameters after minus before)
# within 20 % relative L2 of the CPU's (measured 0.088 on an H100). Adam's
# first update is lr * sign(g) wherever |g| >> eps, so an entry whose gradient
# lies within the two runs' gap of 0 may move the other way (2 lr); the
# update's error is about twice the root of the share of such flips. An update
# of the wrong sign, one not applied or one at twice the lr gives 1 or more.
TRAIN_CARD_VS_CPU = dict(loss=1e-2, moment_rel_l2=5e-2, update_rel_l2=0.2)
# What train_check holds the kernels' step to, by arch: the same step through
# the plain versions on the card ("card_plain": the same matrix products, so
# only the kernels differ) and on the CPU ("cpu"). The hybrid smoke model is
# held to the card's plain path only: its stacked unit's matrices have std 1
# (fan_in = n_units = 1, a reference behaviour), which saturates its attention
# (84 % of the rows have a largest P above 0.999, scores up to 272), where the
# gradients of wq and wk are the rounding residue of dP - Dr. So the card's
# plain path itself parts from the CPU's by 0.48 on the moments and 0.61 on
# the updates, as far as the kernels do (0.48, 0.63), while the kernels
# against the card's plain path read 0.017 and 0.16 (on an H100). Its
# gradients are held to the CPU's where that is well-posed: GRADS_CARD_VS_CPU.
TRAIN_CHECKS = {"qwen3-4b": ("card_plain", "cpu"), "recurrentgemma-9b": ("card_plain",),
                "deepseek-moe-16b": ("card_plain", "cpu"), "xlstm-125m": ("card_plain",)}
# The smoke configs grads_check holds, beside TRAIN_CHECKS': the
# embeddings-input families through Model.loss with an embeds batch
GRADS_CHECKS = (*TRAIN_CHECKS, "qwen2-vl-2b", "musicgen-medium")
# The loss and each leaf's gradient of a smoke config, the card against the
# CPU, with the plain (f32) attention on both sides and the other kernels on
# the card: the hybrid's own code on the card (f32 gate products, conv, scan
# and its backward kernel, the rec block's glue) held to the CPU where the
# comparison is well-posed. At the initial weights it is not, on one device
# already: a 1e-6 nudge of the norm scales moves the hybrid's gradients by up
# to 0.43 per leaf on the CPU (the RG-LRU gates' wa, ba; qwen3-4b's 0.02), and
# the card read 0.32 against the CPU (on an H100). The stacked unit's matrices
# have std 1 there (fan_in = n_units = 1). So the check draws each stacked
# matrix at the std of its unstacked spec (``modules.at_unstacked_std``),
# where the nudge moves the hybrid's gradients by 0.017 and qwen3-4b's by
# 0.008 (tests/test_torch_train.py test_port_smoke_gradients_under_a_nudge).
# The bounds are those the CPU tests hold the port to against JAX with f32
# attention (tests/test_torch_train.py LOSS_TOL_KERNEL_PATH and
# GRAD_REL_F32_ATTENTION), where the two sides also differ only in the order
# of summation.
GRADS_CARD_VS_CPU = dict(loss=1e-4, grad_rel_l2=0.05)
# musicgen-medium's smoke loss is less well-posed than 1e-4 at these weights
# and its embeddings batch: a 1e-6 nudge of the norm scales moves the CPU's
# own loss by up to 2.5e-4 (2.465e-4), and the card's bf16 GEMMs, which
# round in another order, perturb it more: 3.32e-4 card vs CPU on an H100,
# its gradients 0.0078 per leaf, the kernels against the card's plain path
# 0.0. cuBLAS's reduced-precision bf16 reduction does not explain it: with
# torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction True
# (PyTorch's default) and False the card's loss and gradients were the same
# to the bit, the gap 3.32e-4 both times (BF16_REDUCTION_PROBE). grads_check
# prints the nudge's response and both gaps beside it.
GRADS_LOSS_BOUND = {"musicgen-medium": 1e-3}
# The archs whose grads_check also runs the card pass with
# torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction switched
# the other way, both card-vs-CPU gaps printed: does cuBLAS's bf16 reduction
# explain musicgen-medium's loss gap? (The JAX package's bf16 dots sum in f32.)
BF16_REDUCTION_PROBE = ("musicgen-medium",)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_kernels.py
# At the prefill's flash shape a late row's output is ~0.04 (softmax over ~2048
# random keys), below the bf16 atol: the error must also be small beside the
# output's RMS, so that a kernel that drops a kv tile for late rows fails.
FLASH_MAIN_MAX_ERR_OVER_RMS = 0.1
# grad_close's atol scales with a gradient's largest entry, which under a
# causal mask comes from the first keys (P ~ 1 from every row of the group):
# at the training shape it is as large as a late key's whole gradient. So each
# flash gradient is also held block by block: the relative L2 error of every
# (batch, head, 64 rows) block within FLASH_BWD_BLOCK_REL_L2 of its dtype.
# Measured on an H100: bf16 0.0028-0.0030 at the training shape and at most
# 0.0033 over the sweep (mma pair; FMA pair 0.0003), f32 1.1e-6; a kernel
# that drops the diagonal q tile, one q-head of a group or the diagonal key
# tile of dQ reads 0.54-1.0.
FLASH_BWD_BLOCK_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}
FLASH_BWD_BLOCK_ROWS = 64
# The wgmma kernel feeds P to the PV product as two bf16 terms, hi = bf16(p) and
# lo = bf16(p - hi); so does attention_ref(p_bf16=2). Both sum in f32 and round
# the output once to bf16, so they part only where the f32 values straddle a
# rounding boundary: |err| <= 2^-7 |want| (one bf16 step) + TWO_TERM_ATOL, the
# atol for outputs near 0, where f32 summation order alone moves ~1e-6.
TWO_TERM_ATOL = 1e-4
DECODE_CARD_VS_CPU = 2e-2  # the kernels' bf16 atol: decode's logits, card against the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
SOURCES = {  # name -> (route, source, the TPU kernel it replaces, or whose gradient it computes)
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:35"),
    "fused_rmsnorm": ("triton", "src/repro_torch/kernels/fused_rmsnorm.py", "src/repro/kernels/fused_rmsnorm.py:21"),
    "rglru_scan": ("cuda", "src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan.py:33"),
    "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:35"),
    "fused_rmsnorm_bwd": ("triton", "src/repro_torch/kernels/fused_rmsnorm.py",
                          "src/repro/kernels/fused_rmsnorm.py:21"),
    "rglru_scan_bwd": ("cuda", "src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan.py:33"),
}


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - T0, 1), **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_events(prof):
    """The profiler's device-side events (kernels, copies), not the host ops
    that launched them, nor the device-side spans of ``record_function``
    ranges (the model's scopes, named as the host-side ranges of the same
    profile): summing those would count device time twice."""
    from torch.autograd import DeviceType

    ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in ranges]


def time_ms(fn, iters: int = 10, warmup: int = 2, sessions: int = 5) -> tuple[float, float, dict]:
    """-> (device ms, events ms, device ms by kernel name) per call of ``fn``
    over ``iters`` back-to-back calls.

    Device ms sums the profiler's kernel times: the card's own time for the
    work. Events ms is CUDA events around the loop; it is larger where the
    host cannot launch as fast as the card runs (a small Triton launch costs
    tens of microseconds of Python). The profiler on the card's machine now
    and then records no device events for a session, or fewer kernels than
    ``fn`` was called (every call launches at least one); the loop is then
    profiled again, and after ``sessions`` such sessions this raises. It may
    drop a record and still pass that check where a call launches several
    kernels, so device ms can read low there: events ms is the ruler for
    such a call (the flash backward pairs)."""
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
        by_kernel = {e.key[:80]: e.self_device_time_total / 1e3 / iters for e in kernels}
        device_ms = sum(by_kernel.values())
        if device_ms > 0 and sum(e.count for e in kernels) >= iters:
            return device_ms, start.elapsed_time(end) / iters, by_kernel
    raise RuntimeError(f"the profiler recorded too few kernels in {sessions} sessions of {iters} calls")


def events_ms(fn, iters: int, warmup: int = 1) -> float:
    """CUDA events around ``iters`` back-to-back calls of ``fn``, per call,
    with no profiler: for a plain version whose Python loop launches tens of
    thousands of kernels a call, more than the profiler records whole."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(prefix: str, fn, iters: int, by_kernel: bool = False) -> dict:
    """``time_ms`` as a row's fields; ``by_kernel`` adds the device ms by kernel name."""
    device_ms, events, kernels = time_ms(fn, iters=iters)
    out = {f"{prefix}ms": device_ms, f"{prefix}events_ms": events}
    if by_kernel:
        out[f"{prefix}by_kernel_ms"] = kernels
    return out


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
# D=256 MQA, recurrentgemma's windowed D=256 MQA, the smoke head dims (and the
# hybrid smoke's window), and the wgmma kernel's tile edges
# (tests/test_torch_gpu.py's FLASH_CASES)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, None), (2, 256, 256, 4, 1, 64, None), (1, 384, 384, 4, 2, 128, None),
    (1, 100, 100, 2, 2, 64, None), (1, 128, 256, 2, 2, 64, None), (1, 256, 256, 2, 2, 64, 16),
    (1, 256, 256, 2, 2, 64, 64), (1, 256, 256, 2, 2, 64, 1024), (1, 128, 128, 8, 1, 256, None),
    (1, 384, 384, 4, 1, 256, 128), (2, 64, 64, 4, 2, 16, None), (2, 40, 40, 6, 2, 8, None),
    (1, 200, 200, 4, 2, 128, None), (1, 300, 300, 4, 1, 256, None),  # ragged S and T across 128
    (1, 100, 300, 4, 2, 128, None), (1, 260, 130, 2, 1, 256, None),  # S < T, S > T
    (1, 512, 512, 4, 4, 128, 200), (1, 512, 512, 2, 1, 256, 100),  # windows off the tile grid
    (2, 256, 256, 4, 4, 128, None), (2, 256, 256, 16, 4, 128, None), (2, 320, 320, 16, 1, 256, 96),  # G 1/4/16
    (2, 192, 192, 4, 2, 256, None), (1, 256, 256, 2, 2, 256, 64),  # D = 256: head groups of Hkv > 1; Hq = Hkv
    (4, 64, 64, 4, 1, 16, 8),  # recurrentgemma smoke: windowed MQA at head dim 16
    (2, 256, 256, 12, 2, 128, None), (1, 200, 200, 12, 2, 128, None),  # qwen2-vl: a group of 6
    (2, 192, 192, 24, 24, 64, None), (1, 300, 300, 24, 24, 64, None),  # musicgen: MHA, 24 heads at D = 64
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
    for shape in [(4, 128), (2, 7, 256), (1, 1000, 512), (4, 2560), (128, 128), (32, 128), (64, 768), (2, 9, 1536)]:
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


def rglru_bwd_sweep(torch, ops, ref, dev) -> tuple[dict, int]:
    """SCAN_CASES in f32 and bf16 through ``ops.rglru_scan_bwd`` (the chunked
    kernel backward in time) from the forward kernel's h: da and db against
    the plain backward (f32 2e-5, bf16 2e-2) and within a few f32 roundings
    of their own order of arithmetic (``ref.rglru_bwd_chunked_ref``; one bf16
    rounding for bf16 outputs); two launches on the same inputs give equal
    bits. Then the exact case a = 1, dh = 1: db_t = S - t, da_0 = 0.
    -> (worst error against the plain backward, cases)."""
    from repro_torch.kernels import rglru_scan as rgk

    g = torch.Generator(device=dev).manual_seed(21)
    worst, n = {"chunked": 0.0, "chunked_model_max_abs_err": 0.0}, 0
    for B, S, W in SCAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev)).to(dtype)
            h = ops.rglru_scan(a, torch.randn((B, S, W), generator=g, device=dev).to(dtype))
            dh = torch.randn((B, S, W), generator=g, device=dev).to(dtype)
            case = dict(shape=(B, S, W), dtype=str(dtype))
            got = ops.rglru_scan_bwd(a, h, dh)
            model = ref.rglru_bwd_chunked_ref(a, h, dh, rgk.SUB_CHUNK, warps=rgk.WARPS, cluster=rgk.cluster_size(S))
            rtol = 1e-6 if dtype == torch.float32 else 2.0**-8
            for name, x, want, m in zip(("da", "db"), got, ref.rglru_bwd_ref(a, h, dh), model):
                worst["chunked"] = max(worst["chunked"], check_close(f"rglru_scan_bwd {name}", x, want, **case))
                err = (x.float() - m.float()).abs()
                if not bool((err <= 1e-6 + rtol * m.float().abs()).all()):
                    raise AssertionError(f"rglru_scan_bwd {name} {case}: {float(err.max())} from its chunked model")
                worst["chunked_model_max_abs_err"] = max(worst["chunked_model_max_abs_err"], float(err.max()))
            again = ops.rglru_scan_bwd(a, h, dh)
            if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
                raise AssertionError(f"rglru_scan_bwd {case}: two launches on the same inputs differ")
            n += 1
    for W in (256, 70):
        one = torch.ones((1, 3000, W), device=dev)
        h = torch.arange(1, 3001, dtype=torch.float32, device=dev)[None, :, None].expand(1, 3000, W).contiguous()
        da, db = ops.rglru_scan_bwd(one, h, one)
        want = torch.arange(3000, 0, -1, dtype=torch.float32, device=dev)[None, :, None].expand(1, 3000, W)
        if not (torch.equal(db, want) and not bool(da[:, 0].any()) and torch.equal(da[:, 1:], db[:, 1:] * h[:, :-1])):
            raise AssertionError(f"rglru_scan_bwd: the suffix sums of a = dh = 1 at W = {W} are not exact")
    return worst, n + 2


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
    with_lse, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)  # the training instance
    if not torch.equal(with_lse, got):
        raise AssertionError("flash_attention at the prefill shape: the output with lse differs from the one without")
    lse_rel = lse_close("flash lse", lse, ref.attention_ref(qt, kt, vt, window=window, return_lse=True)[1], B=B, S=S)
    del with_lse, lse
    one_term = ref.attention_ref(qt, kt, vt, window=window, p_bf16=1).transpose(1, 2)
    one_term_err = float((one_term.float() - want.float()).abs().max())
    fma = flash.launch_fma(q, k, v, causal=True, window=window)
    fma_err = check_close("flash_attention (fma)", fma, want, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window)
    del got, one_term, fma
    # two S x T x D products a head over the causal (windowed) pairs; q, o + k, v in bf16
    flops, nbytes = ops.flash_work(q, k, True, window)
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
        "one_term_err_over_rms": one_term_err / rms, "fma_max_abs_err": fma_err, "lse_rel_err": lse_rel,
        "output_with_lse_equal": True,
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
    Python loop over S, is timed on CUDA events alone (``events_ms``): the
    profiler loses records of its tens of thousands of kernels a call, and
    of the sessions after it. ``resident_clusters``: how many of the chunked
    kernel's clusters the card holds at once."""
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
        nbytes = ops.rglru_work(a)[1]  # a, b read, h written
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
    for row, (a, b) in zip(rows, inputs):  # after every profiled session, as a precaution
        row.update(plain_ms=events_ms(partial(ref.rglru_ref, a, b), 2), plain_timed_by="cuda events")
    return rows


def time_rglru_bwd(torch, ops, ref, dev, shapes: list[tuple[int, int, int]]) -> list[dict]:
    """The training step's scan backward at each (B, S, W) of ``shapes``, f32:
    a from the gates' range, h from the forward kernel, through ``ops`` (the
    chunked kernel backward in time), held to the plain backward and timed
    beside it; the plain version (a Python loop over S) on CUDA events alone,
    after every profiled session, as in ``time_rglru``. Bound: bytes, a, h,
    dh read and da, db written."""
    from functools import partial

    from repro_torch.kernels import rglru_scan as rgk

    g = torch.Generator(device=dev).manual_seed(22)
    rows, inputs = [], []
    for B, S, W in shapes:
        a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        h = ops.rglru_scan(a, torch.randn((B, S, W), generator=g, device=dev))
        dh = torch.randn((B, S, W), generator=g, device=dev)
        got = ops.rglru_scan_bwd(a, h, dh)
        err = max(check_close(f"rglru_scan_bwd {n}", x, w, B=B, S=S, W=W)
                  for n, x, w in zip(("da", "db"), got, ref.rglru_bwd_ref(a, h, dh)))
        del got
        nbytes = ops.rglru_work(a, backward=True)[1]  # a, h, dh read, da, db written
        bms, by = bound_ms(nbytes, 3 * B * S * W, "float32")  # one FMA and one multiply per element
        cluster = rgk.cluster_size(S)
        rows.append({
            "shape": f"{B}x{S}x{W} f32", "max_abs_err": err, "cluster": cluster,
            "resident_clusters": rgk.max_active_clusters(a.dtype, W, cluster, backward=True),
            **timed("", partial(ops.rglru_scan_bwd, a, h, dh), 20),
            "library_ms": None, "library_call": "none: no single PyTorch call computes a first-order linear recurrence",
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
        })
        inputs.append((a, h, dh))
    for row, (a, h, dh) in zip(rows, inputs):
        row.update(plain_ms=events_ms(partial(ref.rglru_bwd_ref, a, h, dh), 2), plain_timed_by="cuda events")
    return rows


def time_rmsnorm(torch, F, ops, ref, dev, rows: int, D: int, dtype) -> dict:
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((rows, D), generator=g, device=dev).to(dtype)
    s = torch.randn(D, generator=g, device=dev) * 0.1
    w = (1.0 + s).to(dtype)
    err = check_close("fused_rmsnorm", ops.fused_rmsnorm(x, s), ref.rmsnorm_ref(x, s), rows=rows, D=D)
    name = str(dtype).removeprefix("torch.")
    nbytes = ops.rmsnorm_work(x)[1]  # x read, y written, scale read
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


def grad_close(name: str, got, want, **case) -> float:
    """As ``check_close``, with the atol scaled by the gradient's largest
    magnitude (at least 1): a gradient sums many products (dk and dv over every
    query row of a kv group, dscale over every row), and the kernel sums them
    in another f32 order than the plain version, so near-zero entries carry an
    error of the order of the terms, not of the result. -> max abs error."""
    tol = TOL[str(got.dtype).removeprefix("torch.")]
    want = want.float()
    scale = max(1.0, float(want.abs().max()))
    err = (got.float() - want).abs()
    bad = int((err > tol["atol"] * scale + tol["rtol"] * want.abs()).sum())
    max_err = float(err.max())
    if bad or not math.isfinite(max_err):
        raise AssertionError(f"{name} {case}: {bad} elements out of tolerance {tol} (atol x {scale}), "
                             f"max abs error {max_err}")
    return max_err


def block_rel_l2(got, want, rows: int = FLASH_BWD_BLOCK_ROWS) -> float:
    """The largest relative L2 error over the (batch, head, ``rows`` rows)
    blocks of two (B, N, H, D) tensors (a block whose ``want`` is 0 passes
    only where ``got`` is 0 too)."""
    B, N, H, _ = want.shape
    sums = []
    for x in (got.float() - want.float(), want.float()):
        sq = x.new_zeros((B, -(-N // rows) * rows, H))
        sq[:, :N] = x.square().sum(dim=3)
        sums.append(sq.unflatten(1, (-1, rows)).sum(dim=2))
    e, w = sums
    return float((e / w.clamp_min(1e-30)).sqrt().max())


def flash_grad_close(name: str, got, want, **case) -> tuple[float, float]:
    """``grad_close``, then each (batch, head, 64 rows) block of the gradient
    within FLASH_BWD_BLOCK_REL_L2. -> (max abs error, largest block error)."""
    err = grad_close(name, got, want, **case)
    dtype = str(got.dtype).removeprefix("torch.")
    rel = block_rel_l2(got, want)
    if not rel <= FLASH_BWD_BLOCK_REL_L2[dtype]:
        raise AssertionError(f"{name} {case}: a block's relative L2 error {rel} exceeds "
                             f"{FLASH_BWD_BLOCK_REL_L2[dtype]}")
    return err, rel


# The wgmma forward's lse against the plain version's (attention_ref with
# return_lse): both sum exp over the same bf16 inputs in f32, in other orders
# (and the kernel in the log2 domain), so they part by a few f32 roundings of
# the row sum and of the scaled scores, ~1e-6 relative; LSE_REL bounds
# |got - want| / (|want| + 1) with room for long rows. Rows that see no key
# are +inf on both sides.
LSE_REL = 1e-4


def lse_close(name: str, got, want, **case) -> float:
    """Raise unless the kernel's lse is within LSE_REL of the plain one (+inf
    exactly where the plain one is); -> the largest relative error."""
    inf = want == math.inf
    if not bool(((got == math.inf) == inf).all()):
        raise AssertionError(f"{name} {case}: lse is +inf on other rows than the plain version's")
    rel = float(((got - want).abs() / (want.abs() + 1))[~inf].max()) if bool((~inf).any()) else 0.0
    if not rel <= LSE_REL:
        raise AssertionError(f"{name} {case}: lse relative error {rel} exceeds {LSE_REL}")
    return rel


def flash_bwd_sweep(torch, ops, ref, dev) -> tuple[dict, int]:
    """The backward kernels over FLASH_CASES in f32 and bf16, causal and not,
    from the forward kernel's own output (and its lse where the wgmma pair
    reads it, held to the plain lse), through ``ops`` (the wgmma pair for bf16
    at D 16/64/128/256, the FMA pair otherwise; one launch counted per call),
    and on the wgmma pair's cases the pairs ops does not pick too: the mma
    pair where it is built (D 16/64/128), and the FMA pair where it is built
    (not bf16 at D = 16); each gradient against the plain backward
    (``flash_grad_close``). The wgmma pair runs twice on each case: equal
    bits. -> (worst error by pair, worst block error by pair and dtype, worst
    lse error; cases)."""
    from repro_torch.kernels import flash_attention as flash

    g = torch.Generator(device=dev).manual_seed(16)
    worst, n = {"wgmma": 0.0, "mma": 0.0, "fma": 0.0, "wgmma_lse_rel": 0.0}, 0
    for B, S, T, Hq, Hkv, D, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(dtype) for _ in range(2))
            name = flash.bwd_variant(dtype, D)
            for causal in (True, False):
                case = dict(B=B, S=S, T=T, Hq=Hq, Hkv=Hkv, D=D, window=window, causal=causal, dtype=str(dtype))
                t = [x.transpose(1, 2) for x in (q, k, v)]
                lse = None
                if name == "wgmma":
                    o, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
                    _, want_lse = ref.attention_ref(*t, causal=causal, window=window, return_lse=True)
                    worst["wgmma_lse_rel"] = max(worst["wgmma_lse_rel"], lse_close("flash lse", lse, want_lse, **case))
                else:
                    o = ops.flash_attention(q, k, v, causal=causal, window=window)
                do = torch.randn(o.shape, generator=g, device=dev).to(dtype)
                before = ops.launch_counts()
                got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
                after = ops.launch_counts()
                wgmma = name == "wgmma"
                if (after["flash_attention_bwd"] != before["flash_attention_bwd"] + 1
                        or after["flash_attention_bwd_wgmma"] != before["flash_attention_bwd_wgmma"] + wgmma):
                    raise AssertionError(f"flash_attention_bwd {case}: expected one launch of the {name} pair")
                want = ref.attention_bwd_ref(*(x.transpose(1, 2) for x in (q, k, v, o, do)), causal=causal,
                                             window=window)
                runs = [(name, got)]
                if name == "wgmma":
                    again = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise AssertionError(f"flash_attention_bwd (wgmma) {case}: two launches differ")
                    if D in flash.MMA_BWD_HEAD_DIMS:
                        runs.append(("mma", flash.launch_bwd_mma(q, k, v, o, do, causal=causal, window=window)))
                    if D in flash.FMA_BWD_BF16_HEAD_DIMS:
                        runs.append(("fma", flash.launch_bwd_fma(q, k, v, o, do, causal=causal, window=window)))
                for pair, grads in runs:
                    for gname, x, w in zip(("dq", "dk", "dv"), grads, want):
                        err, rel = flash_grad_close(f"flash_attention_bwd ({pair}) {gname}", x, w.transpose(1, 2),
                                                    **case)
                        worst[pair] = max(worst[pair], err)
                        key = f"{pair}_block_rel_l2_{str(dtype).removeprefix('torch.')}"
                        worst[key] = max(worst.get(key, 0.0), rel)
                    n += 1
    return worst, n


# (rows..., D): rmsnorm_sweep's shapes plus the training path's (norm1, norm2
# on the f32 sum, final norm; q-norm and k-norm rows)
RMSNORM_BWD_SHAPES = [(4, 128), (2, 7, 256), (1, 1000, 512), (4, 2560), (128, 128), (32, 128), (5, 3000),
                      (2048, 2560), (2048 * 32, 128), (2048 * 8, 128), (4096, 768)]


def rmsnorm_bwd_sweep(torch, ops, ref, dev) -> tuple[float, int]:
    """The RMSNorm backward kernel over RMSNORM_BWD_SHAPES in f32 and bf16, dx
    and dscale against the plain backward (``grad_close``), and two launches
    on the same inputs equal to the bit (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(17)
    worst, n = 0.0, 0
    for shape in RMSNORM_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            s = torch.randn(shape[-1], generator=g, device=dev) * 0.1
            dy = torch.randn(shape, generator=g, device=dev).to(dtype)
            dx, ds = ops.fused_rmsnorm_bwd(x, s, dy)
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
            case = dict(shape=shape, dtype=str(dtype))
            worst = max(worst, grad_close("fused_rmsnorm_bwd dx", dx, want_dx, **case),
                        grad_close("fused_rmsnorm_bwd dscale", ds, want_ds, **case))
            again = ops.fused_rmsnorm_bwd(x, s, dy)
            if not (torch.equal(again[0], dx) and torch.equal(again[1], ds)):
                raise AssertionError(f"fused_rmsnorm_bwd {case}: two launches on the same inputs differ")
            n += 1
    return worst, n


def time_flash_bwd(torch, F, ops, ref, dev, cfg, B: int, S: int) -> dict:
    """The training step's attention backward: B x S tokens, causal, bf16,
    through ``ops`` (the wgmma pair) from the wgmma forward's output and lse,
    held to the plain backward, and timed beside the pairs it replaced (the
    mma pair, the FMA pair), the plain backward and SDPA's backward through
    autograd. Bound: 2.5 x the forward's operations (five S x T x D products
    per head against two) at the bf16 tensor-core peak."""
    from repro_torch.kernels import flash_attention as flash

    g = torch.Generator(device=dev).manual_seed(18)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=dev).bfloat16()
    t = [a.transpose(1, 2) for a in (q, k, v, o, do)]
    lse_rel = lse_close("flash lse", lse, ref.attention_ref(*t[:3], return_lse=True)[1], B=B, S=S)
    before = ops.launch_counts()["flash_attention_bwd_wgmma"]
    got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    if ops.launch_counts()["flash_attention_bwd_wgmma"] != before + 1:
        raise AssertionError("flash_attention_bwd at the training shape did not take the wgmma pair")
    if not all(torch.equal(x, y) for x, y in zip(got, ops.flash_attention_bwd(q, k, v, o, do, lse=lse))):
        raise AssertionError("flash_attention_bwd (wgmma) at the training shape: two launches differ")
    want = ref.attention_bwd_ref(*t)
    checks = {}
    for pair, grads in (("wgmma", got), ("mma", flash.launch_bwd_mma(q, k, v, o, do, causal=True, window=None)),
                        ("fma", flash.launch_bwd_fma(q, k, v, o, do, causal=True, window=None))):
        checks[pair] = {n: flash_grad_close(f"flash_attention_bwd ({pair}) {n}", x, w.transpose(1, 2), B=B, S=S)
                        for n, x, w in zip(("dq", "dk", "dv"), grads, want)}
    del got, want
    # 2.5 x the forward's products; q, o, do read, dq written; k, v read, dk, dv written
    flops, nbytes = ops.flash_work(q, k, True, None, backward=True)
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    leaves = [a.detach().requires_grad_() for a in t[:3]]
    lo = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    library = lambda: torch.autograd.grad(lo, leaves, t[4], retain_graph=True)  # noqa: E731
    return {
        "shape": f"q {B}x{S}x{Hq}x{D}, k/v {B}x{S}x{Hkv}x{D}, bf16, causal",
        "variant": "wgmma", "max_abs_err": max(e for e, _ in checks["wgmma"].values()), "lse_rel_err": lse_rel,
        **{f"{p}_max_abs_err": max(e for e, _ in c.values()) for p, c in checks.items() if p != "wgmma"},
        **{f"{p}_block_rel_l2": {n: r for n, (_, r) in c.items()} for p, c in checks.items()},
        **timed("", lambda: ops.flash_attention_bwd(q, k, v, o, do, lse=lse), 20, by_kernel=True),
        **timed("mma_", lambda: flash.launch_bwd_mma(q, k, v, o, do, causal=True, window=None), 10, by_kernel=True),
        **timed("fma_", lambda: flash.launch_bwd_fma(q, k, v, o, do, causal=True, window=None), 3, by_kernel=True),
        **timed("plain_", lambda: ref.attention_bwd_ref(*t), 3),
        **timed("library_", library, 10),
        "library_call": "torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
    }


def bwd_kernel_ms(by_kernel: dict) -> dict:
    """A backward pair's device ms by kernel name -> ms of its dQ kernel, its
    dK/dV kernel and the sum of the dK/dV partials (0 where it did not run)."""
    out = {"dq_ms": 0.0, "dkdv_ms": 0.0, "dkdv_sum_ms": 0.0}
    for name, ms in by_kernel.items():
        key = "dkdv_sum_ms" if "dkdv_sum" in name else "dkdv_ms" if "dkdv" in name else "dq_ms"
        out[key] += ms
    return out


def time_flash_bwd_windowed(torch, F, ops, ref, dev, cfg, B: int, S: int) -> dict:
    """The hybrid training step's attention backward: B x S tokens, causal,
    the config's window, MQA at head dim 256, bf16, through ``ops`` (the
    wgmma pair) from the wgmma forward's output and lse (held to the plain
    lse), held to the plain backward (``flash_grad_close``), its two launches
    equal to the bit, and timed (per kernel: dQ, dK/dV, the partial sum; and
    on CUDA events) beside the FMA pair it replaced, the plain backward and
    SDPA's backward through ``torch.autograd.grad`` with the window as
    ``attn_mask`` and k/v repeated to every q head, as the forward's hybrid
    row. Bound: 2.5 x the forward's operations over the windowed pairs at the
    bf16 tensor-core peak."""
    from repro_torch.kernels import flash_attention as flash

    g = torch.Generator(device=dev).manual_seed(23)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=dev).bfloat16()
    t = [a.transpose(1, 2) for a in (q, k, v, o, do)]
    lse_rel = lse_close("flash lse", lse, ref.attention_ref(*t[:3], window=window, return_lse=True)[1], B=B, S=S)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
    after = ops.launch_counts()
    if (after["flash_attention_bwd"] != before["flash_attention_bwd"] + 1
            or after["flash_attention_bwd_wgmma"] != before["flash_attention_bwd_wgmma"] + 1):
        raise AssertionError("flash_attention_bwd at the hybrid training shape did not take the wgmma pair")
    if not all(torch.equal(x, y) for x, y in zip(got, ops.flash_attention_bwd(q, k, v, o, do, window=window,
                                                                              lse=lse))):
        raise AssertionError("flash_attention_bwd (wgmma) at the hybrid training shape: two launches differ")
    want = ref.attention_bwd_ref(*t, window=window)
    checks = {}
    for pair, grads in (("wgmma", got), ("fma", flash.launch_bwd_fma(q, k, v, o, do, causal=True, window=window))):
        checks[pair] = {n: flash_grad_close(f"flash_attention_bwd ({pair}) {n}", x, w.transpose(1, 2), B=B, S=S, D=D)
                        for n, x, w in zip(("dq", "dk", "dv"), grads, want)}
    del got, want
    flops, nbytes = ops.flash_work(q, k, True, window, backward=True)
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    leaves = [t[0].detach().requires_grad_()] + [x.repeat_interleave(Hq // Hkv, dim=1).detach().requires_grad_()
                                                 for x in t[1:3]]
    lo = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    library = lambda: torch.autograd.grad(lo, leaves, t[4], retain_graph=True)  # noqa: E731
    row = {
        "shape": f"q {B}x{S}x{Hq}x{D}, k/v {B}x{S}x{Hkv}x{D}, bf16, causal, window {window}",
        "variant": "wgmma", "max_abs_err": max(e for e, _ in checks["wgmma"].values()), "lse_rel_err": lse_rel,
        "fma_max_abs_err": max(e for e, _ in checks["fma"].values()),
        **{f"{p}_block_rel_l2": {n: r for n, (_, r) in c.items()} for p, c in checks.items()},
        "dkdv_splits": flash.dkdv_splits(B, Hkv, Hq // Hkv, S,
                                         torch.cuda.get_device_properties(dev).multi_processor_count),
        **timed("", lambda: ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse), 20, by_kernel=True),
        **timed("fma_", lambda: flash.launch_bwd_fma(q, k, v, o, do, causal=True, window=window), 3, by_kernel=True),
        **timed("plain_", lambda: ref.attention_bwd_ref(*t, window=window), 2),
        **timed("library_", library, 10),
        "library_call": f"torch.autograd.grad of F.scaled_dot_product_attention(attn_mask=causal window {window}), "
                        f"k/v repeated to {Hq} heads",
        "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
    }
    return {**row, **bwd_kernel_ms(row["by_kernel_ms"])}


def time_rmsnorm_bwd(torch, F, ops, ref, dev, rows: int, D: int, dtype) -> dict:
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((rows, D), generator=g, device=dev).to(dtype)
    s = torch.randn(D, generator=g, device=dev) * 0.1
    dy = torch.randn((rows, D), generator=g, device=dev).to(dtype)
    dx, ds = ops.fused_rmsnorm_bwd(x, s, dy)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
    err = max(grad_close("fused_rmsnorm_bwd dx", dx, want_dx, rows=rows, D=D),
              grad_close("fused_rmsnorm_bwd dscale", ds, want_ds, rows=rows, D=D))
    name = str(dtype).removeprefix("torch.")
    nbytes = ops.rmsnorm_work(x, dy)[1]  # x, dy read, dx written; scale read, dscale written
    bms, by = bound_ms(nbytes, 10 * rows * D, "float32")  # ~10 f32 operations an element
    xl = x.detach().requires_grad_()
    wl = (1.0 + s).to(dtype).requires_grad_()
    y = F.rms_norm(xl, (D,), weight=wl, eps=1e-6)
    library = lambda: torch.autograd.grad(y, (xl, wl), dy, retain_graph=True)  # noqa: E731
    return {
        "shape": f"{rows}x{D} {name}",
        "max_abs_err": err,
        **timed("", lambda: ops.fused_rmsnorm_bwd(x, s, dy), 50, by_kernel=True),
        **timed("plain_", lambda: ref.rmsnorm_bwd_ref(x, s, dy), 20),
        **timed("library_", library, 50),
        "library_call": "torch.autograd.grad of F.rms_norm(weight=1+scale)",
        "bound_ms": bms, "bound_by": by, "bytes": nbytes,
    }


def train_launches(cfg, flash: tuple[str, str]) -> dict:
    """The kernel launches of one train step of ``cfg`` (bf16 activations), as
    the model code makes them: each layer's norms (norm1 and, with a
    feed-forward, dense or MoE, norm2; q- and k-norm where the config has
    them; an xLSTM cell's out_norm) and the final norm, one
    flash per attn layer, one scan per rec layer; under remat "full" or "dots"
    the stacked units' forward runs again in the backward pass (the prefix
    and remainder layers are not checkpointed); one backward per forward op.
    qwen3-4b (36 layers, all in units): flash 72, flash backward 36, RMSNorm
    289 and 145. recurrentgemma-9b at 8 layers (2 units + 2 remainder rec
    layers): scan 10 and 6, flash 4 and 2, RMSNorm 29 and 17; at 11 layers
    scan 14 and 8, flash 6 and 3, RMSNorm 41 and 23. deepseek-moe-16b at 6
    layers (the dense prefix layer 0 + 5 MoE units): flash 11 and 6, RMSNorm
    23 and 13. xlstm-125m (12 layers in 3 units, no attention): RMSNorm 49
    and 25. ``flash`` names the
    forward kernel and the backward pair every flash launch takes: "wgmma"
    counts it under ``flash_attention_wgmma`` or ``flash_attention_bwd_wgmma``
    too."""
    from repro_torch.models.transformer import StackLayout, _ffn_kind, layer_kind

    lay = StackLayout(cfg)
    in_units = set(range(cfg.first_dense, cfg.first_dense + lay.n_units * len(cfg.pattern)))
    out = dict(NO_LAUNCHES)
    for i in range(cfg.n_layers):
        runs = 2 if (i in in_units and cfg.remat != "none") else 1
        kind = layer_kind(cfg, i)
        norms = (1 + (_ffn_kind(cfg, i) != "none") + 2 * (kind == "attn" and cfg.qk_norm)
                 + (kind in ("slstm", "mlstm")))
        out["fused_rmsnorm"] += runs * norms
        out["fused_rmsnorm_bwd"] += norms
        if kind == "attn":
            out["flash_attention"] += runs
            out["flash_attention_bwd"] += 1
        elif kind == "rec":
            out["rglru_scan"] += runs
            out["rglru_scan_bwd"] += 1
    out["fused_rmsnorm"] += 1
    out["fused_rmsnorm_bwd"] += 1
    if flash[0] == "wgmma":
        out["flash_attention_wgmma"] = out["flash_attention"]
    if flash[1] == "wgmma":
        out["flash_attention_bwd_wgmma"] = out["flash_attention_bwd"]
    return out


def train_phase(torch, get_config, ops, dev, spec: dict) -> dict:
    """``make_train_step`` on ``spec``'s arch at full width (cut to
    ``spec["n_layers"]`` layers where given) at its B x S, after printing the
    memory reckoning: a warm-up step, ``spec["timed_steps"]`` timed steps on
    the synchronised host clock with the launches of every kernel counted
    from 0 just before them (each asserted against ``train_launches``), then
    torch.profiler over one more step. The warm-up step, the first, must give
    a finite loss and gradient norm (every gradient entry finite). -> the
    timed steps' launches."""
    import dataclasses

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule

    B, S, n = spec["B"], spec["S"], spec["timed_steps"]
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec.get("n_layers", full.n_layers))
    n_params = cfg.n_params()
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    reckoning = {
        "arch": cfg.name, "layers": cfg.n_layers, "full_layers": full.n_layers, "n_params": n_params,
        "params_grads_moments_gb": 16 * n_params / 1e9, "full_depth_gb": 16 * full.n_params() / 1e9,
        "card_gb": card_gb, "logits_f32_gb": 4 * B * S * cfg.vocab / 1e9, "remat": cfg.remat,
        "depth_why": spec.get("depth_why", "uncut"),
    }
    emit("train_reckoning", **reckoning)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), train=True)
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(3e-4, warmup_steps=1, total_steps=100), AdamWConfig())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()} for i in range(n + 3)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batches[0])  # warm-up: Triton compiles, the gradient buffer
    warm = {k: float(v) for k, v in met.items()}
    warmup_ms = (time.perf_counter() - t0) * 1e3
    # the global norm of the f32 gradients is finite only where every entry is
    if not all(math.isfinite(warm[k]) for k in ("loss", "grad_norm")):
        raise AssertionError(f"train {cfg.name}: the first step's loss or gradients are not finite: {warm}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    steps = []
    for i in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batches[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"step": i + 1, "ms": ms, **{k: float(v) for k, v in met.items()}})
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / n for k, v in counts.items()}
    want = train_launches(cfg, spec.get("flash", ("wgmma", "wgmma")))
    mean_ms = sum(st["ms"] for st in steps) / n
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S, "remat": cfg.remat, "moments": "float32",
        "init_s": init_s, "warmup_step_ms": warmup_ms, "warmup_metrics": warm, "first_step_finite": True,
        "steps": steps,
        "mean_step_ms": mean_ms, "tokens_per_s": B * S / (mean_ms / 1e3), "peak_memory_gb": peak_gb,
        "launches_per_step": per_step,
    }
    finite = all(math.isfinite(st[k]) for st in steps for k in ("loss", "grad_norm", "lr"))
    if not finite or per_step != want:
        emit("train", **out)
        raise AssertionError(f"train {cfg.name}: finite {finite}, launches per step {per_step}, expected {want}")
    out["profile"] = profile_step(torch, lambda: step(params, opt, batches[n + 1]))
    emit("train", **out)
    device_plane(torch, ops, dev, cfg, spec, lambda: step(params, opt, batches[n + 2]), mean_ms)
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return counts


# The hand-written kernels the device plane must find in a train step's tree,
# by the layer kinds that launch them: forward under jvp(loss), backward under
# transpose(jvp(loss)) (where a checkpoint's recompute launches forwards too).
DEVICE_PLANE_KERNELS = {"attn": "flash_attention", "rec": "rglru_scan"}
DEVICE_PLANE_ATTEMPTS = 3  # profiles of one more step, where the profiler dropped a kernel's records


def device_plane(torch, ops, dev, cfg, spec: dict, run_step, timed_ms: float) -> dict:
    """The ``device_plane`` line of one train setup: ``run_step`` (one more
    train step, after the timed ones) profiled into the device tree, read as
    ``repro_torch.benchmarks.fig08_11_breakdown`` reads it. Fails (after
    DEVICE_PLANE_ATTEMPTS profiles) if the tree is empty, the backward holds
    no kernel, or a hand-written kernel of the path holds none in either
    branch; the launches the tree's ``kernel:`` nodes count must equal
    ``ops.launch_counts()`` for the step."""
    from repro_torch.benchmarks.fig08_11_breakdown import FORWARD, BACKWARD, component_shares, step_split
    from repro_torch.core.device_tree import UNATTRIBUTED, build_device_tree, profiling
    from repro_torch.core.roofline import H100, report_from_tree
    from repro_torch.models import Model

    families = ["fused_rmsnorm"] + sorted({DEVICE_PLANE_KERNELS[k] for k in cfg.pattern if k in DEVICE_PLANE_KERNELS})
    B, S = spec["B"], spec["S"]
    for attempt in range(1, DEVICE_PLANE_ATTEMPTS + 1):
        ops.reset_launch_counts()
        with profiling(dev) as prof:
            t0 = time.perf_counter()
            run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        tree = build_device_tree(prof)
        del prof
        branch = {side: tree.zoom(lambda n, s=side: n == s) for side in (FORWARD, BACKWARD)}
        found = {f"{side}/{fam}": branch[side].flatten("kernels").get(f"kernel:{fam}{sfx}", 0.0)
                 for side, sfx in ((FORWARD, ""), (BACKWARD, "_bwd")) for fam in families}
        missing = [k for k, v in found.items() if not v]
        if tree.total("device_ms") > 0 and branch[BACKWARD].total("kernels") > 0 and not missing:
            break
    flat_ops, flat_kernels = tree.flatten("ops"), tree.flatten("kernels")
    kernels = {key: {"launches": counts[key], "in_tree": flat_ops.get(f"kernel:{key}", 0.0),
                     "device_kernels": flat_kernels.get(f"kernel:{key}", 0.0)}
               for key in ("flash_attention", "flash_attention_bwd", "fused_rmsnorm", "fused_rmsnorm_bwd",
                           "rglru_scan", "rglru_scan_bwd")}
    device_ms = tree.total("device_ms")
    model_flops = 6.0 * Model(cfg, device="meta").n_active_params * B * S
    report = report_from_tree(arch=cfg.name, shape=f"train {B}x{S}", device_tree=tree, measured_step_s=timed_ms / 1e3,
                              model_flops_global=model_flops, hw=H100)
    top = [("/".join(p).removeprefix("train_step/fwd_bwd/"), share * device_ms)
           for p, share in tree.hot_paths("device_ms", k=10, self_only=True)]
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S, "remat": cfg.remat, "attempts": attempt,
        "profiled_wall_ms": wall_ms, "timed_step_ms": timed_ms, "device_ms": device_ms,
        "split_ms": step_split(tree), "split_bytes": step_split(tree, "bytes"),
        "idle_share_profiled": 1 - device_ms / wall_ms,
        "idle_share_timed": 1 - device_ms / timed_ms,
        "unattributed_device_ms": tree.flatten("device_ms").get(UNATTRIBUTED, 0.0),
        "components_device_share": component_shares(tree, "device_ms"),
        "components_flops_share": component_shares(tree, "flops"),
        "top_device_ms": top,
        "tree_flops": tree.total("flops"), "model_flops_6nd": model_flops,
        "tree_flops_over_6nd": tree.total("flops") / model_flops,
        "tree_bytes": tree.total("bytes"), "call_sites": tree.node_count(),
        "roofline": {"t_compute_ms": report.t_compute * 1e3, "t_memory_ms": report.t_memory * 1e3,
                     "bound_ms": report.t_step * 1e3, "dominant": report.dominant,
                     "bound_over_timed_step": report.bound_share, "spec": H100.name},
        "kernels": kernels, "kernel_nodes": found,
        "profiler_dropped_records": any(k["device_kernels"] < k["in_tree"] for k in kernels.values()),
    }
    emit("device_plane", **out)
    bad_counts = {k: v for k, v in kernels.items() if v["in_tree"] != v["launches"]}
    if not device_ms or not branch[BACKWARD].total("kernels") or missing or bad_counts:
        raise AssertionError(f"device plane of {cfg.name}: device ms {device_ms}, kernels missing {missing}, "
                             f"launch counts apart {bad_counts}")
    return out


def profile_step(torch, fn) -> dict:
    """torch.profiler over one call of ``fn`` that ends in a synchronise: wall
    ms, device busy ms, idle share, the device ops that take the most time (as
    ``profile_phase``), and the host ops that take the most host time of their
    own (self CPU time: where a checkpoint's recompute runs inside the first
    backward node of its unit, that node's self time holds it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3} for e in top],
        "host_top": [{"name": e.key[:80], "count": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in host_top],
        **moe_scopes(prof, busy_ms), **xlstm_scopes(prof, busy_ms, wall_ms),
    }


def trainer_phase(torch, ops, dev) -> dict:
    """``Trainer`` at qwen3-4b smoke on the card, sampler and watchdog on:
    run A trains 3 steps and checkpoints, a second Trainer in A resumes to 6,
    run B trains 6 in one go; A's parameters and optimizer state must equal
    B's to the bit, and A's heartbeat, metrics.json and host_profile.html
    exist. -> the launches of the three runs."""
    from repro_torch.launch.train import Trainer, TrainJobConfig
    from repro_torch.models.modules import tree_leaves

    k, n = 3, 6
    base = dict(arch=TRAIN["arch"], smoke=True, device=str(dev), global_batch=4, seq_len=64, lr=1e-2,
                sample_period_s=0.05)

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        first = Trainer(TrainJobConfig(**base, steps=k, ckpt_every=k, out_dir=str(a))).run()
        ta = Trainer(TrainJobConfig(**base, steps=n, ckpt_every=k, out_dir=str(a)))
        resumed = ta.run()
        tb = Trainer(TrainJobConfig(**base, steps=n, ckpt_every=n, out_dir=str(b)))
        whole = tb.run()
        counts = ops.launch_counts()
        pairs = zip(tree_leaves(ta._state_tree()), tree_leaves(tb._state_tree()))
        mismatched = [".".join(p) for (p, x), (_, y) in pairs
                      if not torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())]
        with open(a / "metrics.json") as f:
            resumed_steps = [m["step"] for m in json.load(f)["steps"]]
        files = {name: (a / name).exists() for name in ("heartbeat", "metrics.json", "host_profile.html")}
    out = {
        "arch": ta.cfg.name, "steps": n, "checkpoint_at": k, "first_run": first, "resumed_run": resumed,
        "whole_run": whole, "resumed_steps": resumed_steps, "leaves_differing": mismatched, "files": files,
        "launches": counts,
    }
    emit("trainer", **out)
    if mismatched or resumed_steps != list(range(k + 1, n + 1)) or not all(files.values()):
        raise AssertionError("trainer: the resumed run is not the uninterrupted one, or an artifact is missing")
    return counts


def smoke_batch(torch, cfg) -> dict:
    """A smoke config's train batch on the CPU: 4 x 64 ``SyntheticLM``
    tokens and labels (seed 0); where the config takes embeddings, bf16
    embeddings from seed 0 in place of the tokens, and with M-RoPE image
    positions (8 text tokens, 2 x 4 x 4 patches, text)."""
    from repro_torch.data import DataConfig, SyntheticLM

    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0)).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    if cfg.input_mode != "tokens":
        del batch["tokens"]
        batch.update(path_batch(torch, cfg, 4, 64, image=(8, (2, 4, 4))))
    return batch


def train_check(torch, get_config, ops, dev, arch: str) -> dict:
    """One train step at ``arch``'s smoke config through the kernels on the
    card, the same step through the plain versions on the card and on the
    CPU, from the same weights and batch; the kernels' step held to
    TRAIN_CARD_VS_CPU against each reference TRAIN_CHECKS names for ``arch``,
    every comparison printed, with the plain path's own response to a 1e-6
    nudge of the norm scales beside them (``card_plain_nudged``): how far
    the step is well-posed at this init."""
    from contextlib import nullcontext

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.modules import tree_leaves, tree_map_with_path
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = get_config(arch, smoke=True)
    params_cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True)
    before = tree_map_with_path(lambda _, x: x.clone(), params_cpu)
    batch = smoke_batch(torch, cfg)
    lr_fn = cosine_schedule(1e-2, warmup_steps=0, total_steps=10)
    runs, routes = {}, {}
    for name, device, plain in (("card", dev, False), ("card_plain", dev, True), ("cpu", torch.device("cpu"), False),
                                ("card_plain_nudged", dev, True)):
        p = tree_map_with_path(lambda _, x: x.to(device, copy=True), params_cpu)  # each step updates its own copy
        if name == "card_plain_nudged":  # the step's own sensitivity: the norm scales moved by 1e-6
            p = tree_map_with_path(lambda path, x: x + 1e-6 if path[-1] == "scale" else x, p)
        with ops.plain_versions() if plain else nullcontext(), recording_moe() as routes[name]:
            p, st, met = make_train_step(Model(cfg, device=device), lr_fn)(p, adamw_init(p), on(batch, device))
        runs[name] = (p, st, {k: float(v) for k, v in met.items()})

    def compare(got, want) -> dict:
        (pg, sg, mg), (pw, sw, mw) = runs[got], runs[want]
        moment = max(float((x.cpu().float() - y.cpu().float()).norm() / y.cpu().float().norm().clamp_min(1e-30))
                     for part in ("m", "v") for (_, x), (_, y) in zip(tree_leaves(sg[part]), tree_leaves(sw[part])))
        update = max(float((x.cpu() - y.cpu()).norm() / (y.cpu() - p0).norm().clamp_min(1e-30))
                     for (_, x), (_, y), (_, p0) in zip(tree_leaves(pg), tree_leaves(pw), tree_leaves(before)))
        return {"loss_diff": abs(mg["loss"] - mw["loss"]), "moment_max_rel_l2": moment, "update_max_rel_l2": update}

    res = {
        "arch": cfg.name, **{f"loss_{n}": r[2]["loss"] for n, r in runs.items()},
        **{f"grad_norm_{n}": r[2]["grad_norm"] for n, r in runs.items()}, "lr": runs["cpu"][2]["lr"],
        "card_vs_card_plain": compare("card", "card_plain"), "card_vs_cpu": compare("card", "cpu"),
        "card_plain_vs_cpu": compare("card_plain", "cpu"),
        "card_plain_nudged_vs_card_plain": compare("card_plain_nudged", "card_plain"),
        "held_against": TRAIN_CHECKS[arch],
        "bounds": TRAIN_CARD_VS_CPU,
    }
    if routes["card"]:  # MoE: the first token routed otherwise than on the card (None: no route flip)
        res["moe_first_route_flip"] = {ref: first_flip(routes["card"], routes[ref]) for ref in ("card_plain", "cpu")}
    emit("train_check", **res)
    for ref_name in TRAIN_CHECKS[arch]:
        c = res[f"card_vs_{ref_name}"]
        if not (c["loss_diff"] < TRAIN_CARD_VS_CPU["loss"] and c["moment_max_rel_l2"] < TRAIN_CARD_VS_CPU["moment_rel_l2"]
                and c["update_max_rel_l2"] < TRAIN_CARD_VS_CPU["update_rel_l2"]):
            raise AssertionError(f"train step of {cfg.name}, the kernels against {ref_name}, out of bound: {c}")
    return res


def grads_check(torch, get_config, ops, dev, arch: str) -> dict:
    """``Model.loss`` and its gradient at ``arch``'s smoke config, the initial
    weights through ``modules.at_unstacked_std``, on the card (flash attention
    through its plain version, the other kernels launched) and on the CPU,
    from the same weights and batch: the loss and each leaf's gradient held
    to GRADS_CARD_VS_CPU (the loss to GRADS_LOSS_BOUND where it names the
    arch). Reported beside them: the same pass through every kernel's plain
    version on the card (``card_plain``: only the kernels differ from
    ``card``), and the CPU loss's own response to a +-1e-6 nudge of the norm
    scales (``cpu_loss_nudge``: how far the loss is well-posed)."""
    from repro_torch.models import Model
    from repro_torch.models.modules import at_unstacked_std, tree_leaves, tree_map_with_path

    cfg = get_config(arch, smoke=True)
    params_cpu = at_unstacked_std(Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), train=True))
    batch = smoke_batch(torch, cfg)
    runs, routes = {}, {}
    matmul = torch.backends.cuda.matmul
    as_run = matmul.allow_bf16_reduced_precision_reduction
    passes = [("card", dev, ("flash_attention",)), ("card_plain", dev, ()),
              ("cpu", torch.device("cpu"), ("flash_attention",))]
    if arch in BF16_REDUCTION_PROBE:
        passes.append(("card_bf16_reduction_flipped", dev, ("flash_attention",)))
    for name, device, plain in passes:
        model = Model(cfg, device=device)
        p = tree_map_with_path(lambda _, x: x.to(device, copy=True), params_cpu)
        grads = tree_map_with_path(lambda _, x: torch.zeros_like(x, dtype=torch.float32), p)
        ops.reset_launch_counts()
        matmul.allow_bf16_reduced_precision_reduction = (not as_run) if name.endswith("_flipped") else as_run
        try:
            with ops.plain_versions(*plain), recording_moe() as routes[name]:
                loss, _ = model.loss(model.grad_leaves(p, grads), on(batch, device))
                loss.backward()
        finally:
            matmul.allow_bf16_reduced_precision_reduction = as_run
        runs[name] = (float(loss.detach()), grads, ops.launch_counts())
    with torch.no_grad():
        nudged = [float(Model(cfg, device="cpu").loss(tree_map_with_path(
            lambda path, x, e=e: x + e if path[-1] == "scale" else x, params_cpu), batch)[0]) for e in (1e-6, -1e-6)]

    def rel(g, w) -> dict:
        return {".".join(path): float((x.cpu() - y.cpu()).norm() / y.cpu().norm().clamp_min(1e-30))
                for (path, x), (_, y) in zip(tree_leaves(g), tree_leaves(w))}

    def worst_of(errs: dict) -> dict:
        worst = max(errs, key=errs.get)
        return {"grad_max_rel_l2": errs[worst], "worst_leaf": worst}

    (lc, gc, counts), (lp, gp, _), (lw, gw, _) = runs["card"], runs["card_plain"], runs["cpu"]
    errs = rel(gc, gw)
    worst = max(errs, key=errs.get)
    loss_bound = GRADS_LOSS_BOUND.get(arch, GRADS_CARD_VS_CPU["loss"])
    res = {"arch": cfg.name, "weights": "init, stacked matrices at their unstacked std",
           "attention": "plain f32 on both", "loss_card": lc, "loss_cpu": lw,
           "loss_diff": abs(lc - lw), "grad_max_rel_l2": errs[worst], "worst_leaf": worst, "launches_card": counts,
           "loss_card_plain": lp, "card_vs_card_plain": {"loss_diff": abs(lc - lp), **worst_of(rel(gc, gp))},
           "cpu_loss_nudge": max(abs(x - lw) for x in nudged),
           "bounds": {**GRADS_CARD_VS_CPU, "loss": loss_bound}}
    if routes["card"]:  # MoE: the first token routed otherwise on the two devices (None: no route flip)
        res["moe_first_route_flip"] = first_flip(routes["card"], routes["cpu"])
    if "card_bf16_reduction_flipped" in runs:  # the card-vs-CPU gap with cuBLAS's bf16 reduction on and off
        lf, gf, _ = runs["card_bf16_reduction_flipped"]
        gaps = {as_run: (lc, errs), not as_run: (lf, rel(gf, gw))}
        res["bf16_reduced_precision_reduction"] = {
            "as_run": as_run,
            **{str(flag).lower(): {"loss_card": loss, "loss_diff": abs(loss - lw), **worst_of(e)}
               for flag, (loss, e) in gaps.items()}}
    emit("grads_check", **res)
    want = {**train_launches(cfg, ("fma", "fma")), "flash_attention": 0, "flash_attention_bwd": 0}
    if not (counts == want and res["loss_diff"] < loss_bound
            and res["grad_max_rel_l2"] < GRADS_CARD_VS_CPU["grad_rel_l2"]):
        raise AssertionError(f"gradients of {cfg.name}, card against the CPU: {res}; launches expected {want}")
    return res


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
            device_ms, events_ms, _ = time_ms(fn, iters=20)
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
    cuda_kernels = sorted({Path(src).stem for route, src, _ in SOURCES.values() if route == "cuda"})  # libraries
    t0 = time.perf_counter()
    build.build(cuda_kernels)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops.fused_rmsnorm(torch.ones((4, 2560), device=dev, dtype=torch.bfloat16), torch.zeros(2560, device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(build.library_path(name).with_suffix(".log").read_text()) for name in cuda_kernels}
    emit("build", nvcc_s=nvcc_s, first_triton_compile_s=triton_s, ptxas=ptxas)
    # no kernel of the flash backward library spills, nor the wgmma forward
    # (with and without the lse output) or the chunked scan
    for lib, kernel in (("flash_attention", "wgmma"), ("rglru_scan", "rglru_chunked"), ("flash_attention_bwd", "")):
        spills = {k: r for k, r in ptxas[lib].items()
                  if kernel in k and k != "warnings" and (r.get("spill_stores", 0) or r.get("spill_loads", 0))}
        if spills:
            raise AssertionError(f"{lib} kernels spill registers: {spills}")

    # -- kernels against their plain versions, then timed at the main paths' shapes ---------
    qwen, hyb = get_config("qwen3-4b"), get_config("recurrentgemma-9b")
    sweep_err, sweep_cases = {}, {}
    sweeps = {"flash_attention": flash_sweep, "fused_rmsnorm": rmsnorm_sweep, "rglru_scan": rglru_sweep,
              "flash_attention_bwd": flash_bwd_sweep, "fused_rmsnorm_bwd": rmsnorm_bwd_sweep,
              "rglru_scan_bwd": rglru_bwd_sweep}
    for name, sweep in sweeps.items():
        sweep_err[name], sweep_cases[name] = sweep(torch, ops, ref, dev)
    emit("kernels_sweep", cases=sweep_cases, max_abs_err=sweep_err)
    qB, qS = PATHS["qwen3-4b"]["B"], PATHS["qwen3-4b"]["S"]
    hB, hS = PATHS["recurrentgemma-9b"]["B"], PATHS["recurrentgemma-9b"]["S"]
    tB, tS = TRAIN["B"], TRAIN["S"]
    yB, yS = TRAIN_HYBRID["B"], TRAIN_HYBRID["S"]
    ds, qm = get_config("deepseek-moe-16b"), get_config("qwen3-moe-235b-a22b")
    dB, dS = PATHS["deepseek-moe-16b"]["B"], PATHS["deepseek-moe-16b"]["S"]
    mB, mS = TRAIN_MOE["B"], TRAIN_MOE["S"]
    xl, vl, mg = get_config("xlstm-125m"), get_config("qwen2-vl-2b"), get_config("musicgen-medium")
    xB, xS = PATHS["xlstm-125m"]["B"], PATHS["xlstm-125m"]["S"]
    eB, eS = PATHS["qwen2-vl-2b"]["B"], PATHS["qwen2-vl-2b"]["S"]
    xtB, xtS = TRAIN_XLSTM["B"], TRAIN_XLSTM["S"]
    timing = {  # the first row of each kernel is its summary row
        "flash_attention": [time_flash(torch, F, ops, ref, dev, qwen, qB, qS),
                            time_flash(torch, F, ops, ref, dev, hyb, hB, hS),
                            time_flash(torch, F, ops, ref, dev, ds, dB, dS),  # MHA: 16 q-heads on 16 kv-heads
                            time_flash(torch, F, ops, ref, dev, qm, dB, dS),  # GQA 64 / 4
                            time_flash(torch, F, ops, ref, dev, vl, eB, eS),  # GQA 12 / 2: a group of 6
                            time_flash(torch, F, ops, ref, dev, mg, eB, eS)],  # MHA 24 heads at D = 64
        "fused_rmsnorm": [
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS, qwen.d_model, torch.bfloat16),  # norm1, final_norm
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS, qwen.d_model, torch.float32),  # norm2 on the f32 sum
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS * qwen.n_heads, qwen.head_dim, torch.bfloat16),  # q_norm
            time_rmsnorm(torch, F, ops, ref, dev, qB * qS * qwen.n_kv_heads, qwen.head_dim, torch.bfloat16),  # k_norm
            time_rmsnorm(torch, F, ops, ref, dev, hB * hS, hyb.d_model, torch.bfloat16),  # hybrid norm1 after a carry
            time_rmsnorm(torch, F, ops, ref, dev, hB * hS, hyb.d_model, torch.float32),  # hybrid norms on f32 sums
            time_rmsnorm(torch, F, ops, ref, dev, dB * dS, ds.d_model, torch.bfloat16),  # deepseek norm1, final
            time_rmsnorm(torch, F, ops, ref, dev, dB * dS, ds.d_model, torch.float32),  # deepseek pre-MoE norm
            time_rmsnorm(torch, F, ops, ref, dev, xB * xS, xl.d_model, torch.bfloat16),  # xLSTM out_norm, final
            time_rmsnorm(torch, F, ops, ref, dev, xB * xS, xl.d_model, torch.float32),  # xLSTM norm1 on f32 sums
            time_rmsnorm(torch, F, ops, ref, dev, eB * eS, vl.d_model, torch.bfloat16),  # qwen2-vl, musicgen norm1
            time_rmsnorm(torch, F, ops, ref, dev, eB * eS, vl.d_model, torch.float32),  # their norm2 on f32 sums
        ],
        # the hybrid prefill's, and one prompt through Model.forward
        "rglru_scan": time_rglru(torch, ops, ref, dev, [(hB, hS, hyb.lru_width), (1, hS, hyb.lru_width)]),
        # the training steps' (TRAIN: B x S tokens of qwen3-4b; TRAIN_HYBRID's)
        "flash_attention_bwd": [time_flash_bwd(torch, F, ops, ref, dev, qwen, tB, tS),
                                time_flash_bwd_windowed(torch, F, ops, ref, dev, hyb, yB, yS),
                                time_flash_bwd(torch, F, ops, ref, dev, ds, mB, mS),  # TRAIN_MOE's
                                time_flash_bwd(torch, F, ops, ref, dev, vl, 1, eS),  # a group of 6 at D = 128
                                time_flash_bwd(torch, F, ops, ref, dev, mg, 1, eS)],  # MHA at D = 64
        "fused_rmsnorm_bwd": [
            time_rmsnorm_bwd(torch, F, ops, ref, dev, tB * tS, qwen.d_model, torch.bfloat16),  # norm1, final_norm
            time_rmsnorm_bwd(torch, F, ops, ref, dev, tB * tS, qwen.d_model, torch.float32),  # norm2 on the f32 sum
            time_rmsnorm_bwd(torch, F, ops, ref, dev, tB * tS * qwen.n_heads, qwen.head_dim, torch.bfloat16),
            time_rmsnorm_bwd(torch, F, ops, ref, dev, tB * tS * qwen.n_kv_heads, qwen.head_dim, torch.bfloat16),
            time_rmsnorm_bwd(torch, F, ops, ref, dev, mB * mS, ds.d_model, torch.bfloat16),  # TRAIN_MOE's norms
            time_rmsnorm_bwd(torch, F, ops, ref, dev, mB * mS, ds.d_model, torch.float32),
            time_rmsnorm_bwd(torch, F, ops, ref, dev, xtB * xtS, xl.d_model, torch.bfloat16),  # TRAIN_XLSTM's
            time_rmsnorm_bwd(torch, F, ops, ref, dev, xtB * xtS, xl.d_model, torch.float32),
        ],
        # the hybrid training step's (B = 1), and at the prefill's B = 2
        "rglru_scan_bwd": time_rglru_bwd(torch, ops, ref, dev, [(yB, yS, hyb.lru_width), (2, yS, hyb.lru_width)]),
    }
    for name, rows in timing.items():
        for row in rows:
            emit("kernel_timing", name=name, **row)
    torch.cuda.empty_cache()

    # -- the serving paths: prefill, serve, profile, check ---------------------------------------
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch in PATHS:
        for counts in drive_path(torch, get_config, ops, dev, arch):
            for name, n in counts.items():
                launches[name] += n
        torch.cuda.empty_cache()

    # -- the training paths: train at full width, the Trainer at smoke size, card vs CPU -----------
    for run in (lambda: train_phase(torch, get_config, ops, dev, TRAIN),
                lambda: train_phase(torch, get_config, ops, dev, TRAIN_HYBRID),
                lambda: train_phase(torch, get_config, ops, dev, TRAIN_MOE),
                lambda: train_phase(torch, get_config, ops, dev, TRAIN_XLSTM),
                lambda: trainer_phase(torch, ops, dev)):
        for name, n in run().items():
            launches[name] += n
        torch.cuda.empty_cache()
    for arch in TRAIN_CHECKS:
        train_check(torch, get_config, ops, dev, arch)
    for arch in GRADS_CHECKS:
        grads_check(torch, get_config, ops, dev, arch)

    summary = []
    for name, rows in timing.items():
        main_row = rows[0]
        route, src, replaces = SOURCES[name]
        main_kernel = {"flash_attention": "wgmma", "rglru_scan": "chunked", "flash_attention_bwd": "wgmma",
                       "rglru_scan_bwd": "chunked"}.get(name)
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
        if name == "flash_attention_bwd":  # the main paths' pair (wgmma), and the mma and FMA pairs it replaced
            n_wgmma, n_mma = launches["flash_attention_bwd_wgmma"], launches["flash_attention_bwd_mma"]
            row["variants"] = {
                "wgmma": {"launches": n_wgmma, "shapes": [r["shape"] for r in rows], "ms": [r["ms"] for r in rows],
                          "events_ms": [r["events_ms"] for r in rows],
                          "kernels_ms": [bwd_kernel_ms(r["by_kernel_ms"]) for r in rows],
                          "bound_ms": [r["bound_ms"] for r in rows], "library_ms": [r["library_ms"] for r in rows],
                          "max_abs_err": max(sweep_err[name]["wgmma"], *(r["max_abs_err"] for r in rows)),
                          "block_rel_l2": max(sweep_err[name]["wgmma_block_rel_l2_bfloat16"],
                                              *(x for r in rows for x in r["wgmma_block_rel_l2"].values()))},
                "mma": {"launches": n_mma, "ms": [main_row["mma_ms"]], "events_ms": [main_row["mma_events_ms"]],
                        "max_abs_err": max(sweep_err[name]["mma"], main_row["mma_max_abs_err"])},
                "fma": {"launches": launches[name] - n_wgmma, "ms": [r["fma_ms"] for r in rows],
                        "events_ms": [r["fma_events_ms"] for r in rows],
                        "max_abs_err": max(sweep_err[name]["fma"], *(r["fma_max_abs_err"] for r in rows))},
            }
            if n_mma or n_wgmma != launches[name]:
                raise AssertionError(f"flash backward launches on the main paths: {n_wgmma} of {launches[name]} on "
                                     f"the wgmma pair, {n_mma} on the mma pair")
        if name == "rglru_scan_bwd":
            row["shapes_ms"] = {r["shape"]: r["ms"] for r in rows}
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


def memory_reckoning(cfg, full) -> dict:
    """The serving path's weights in their storage dtypes and the largest
    f32 draw of the init (each leaf is drawn in f32, then stored)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.models.modules import storage_dtype, tree_leaves

    leaves = list(tree_leaves(Model(cfg, device="meta").spec()))
    stored = sum(math.prod(s.shape) * storage_dtype(p, len(s.shape)).itemsize for p, s in leaves)
    largest = max(math.prod(s.shape) for _, s in leaves)
    return {"n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(), "weights_gb": stored / 1e9,
            "largest_leaf_f32_draw_gb": 4 * largest / 1e9, "full_layers": full.n_layers,
            "full_depth_weights_gb": stored / 1e9 * full.n_params() / cfg.n_params(),
            "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}


@contextlib.contextmanager
def recording_moe(keep_io: bool = False):
    """Within: each MoE call (``transformer.moe``) appends {"aux", "ids",
    "top": its router's top K+1 probabilities} to the yielded list, and with
    ``keep_io`` its input, output and weights; nothing is recorded for a
    model without MoE. Reads no value on the host while recording."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    calls, moe, route = [], tfm.moe, moe_mod.route

    def recording_route(params, xt, cfg):
        out = route(params, xt, cfg)
        calls.append({"ids": out[2], "top": out[0].topk(cfg.top_k + 1, dim=-1).values})
        return out

    def recording_moe_call(params, x, cfg):
        y, aux = moe(params, x, cfg)
        calls[-1]["aux"] = aux
        if keep_io:
            calls[-1].update(x=x, y=y, params=params)
        return y, aux

    tfm.moe, moe_mod.route = recording_moe_call, recording_route
    try:
        yield calls
    finally:
        tfm.moe, moe_mod.route = moe, route


def moe_prefill_stats(cfg, n_tokens: int, calls: list) -> dict:
    """The MoE's own numbers of one prefill: capacity, dropped fraction per
    layer (its mean and max), the experts' largest and smallest share of the
    slots, and the smallest top-k margin. Empty without MoE."""
    if not calls:
        return {}
    from repro_torch.models.moe import _capacity

    dropped = [float(c["aux"]["dropped_frac"]) for c in calls]
    frac = [c["aux"]["expert_frac"] for c in calls]
    return {"moe": {
        "capacity": _capacity(n_tokens, cfg), "tokens": n_tokens, "experts": cfg.n_experts, "top_k": cfg.top_k,
        "dropped_frac_per_layer": dropped, "dropped_frac_mean": sum(dropped) / len(dropped),
        "dropped_frac_max": max(dropped), "expert_frac_max": max(float(f.max()) for f in frac),
        "expert_frac_min": min(float(f.min()) for f in frac),
        "min_top_k_margin": min(float((c["top"][:, -2] - c["top"][:, -1]).min()) for c in calls),
    }}


def first_flip(got: list, want: list) -> int | None:
    """The first token (flat index over the batch) whose set of experts
    differs between two recordings of the same MoE calls, or None. Tokens
    before it saw the same routes in every layer: attention is causal and a
    slot's rank (its drop) depends only on the slots before it."""
    if len(got) != len(want):
        raise AssertionError(f"MoE calls differ in number: {len(got)} against {len(want)}")
    firsts = []
    for g, w in zip(got, want):
        differ = (g["ids"].cpu().sort(-1).values != w["ids"].cpu().sort(-1).values).any(-1)
        if bool(differ.any()):
            firsts.append(int(differ.nonzero()[0]))
    return min(firsts, default=None)


def mrope_image_positions(torch, B: int, S: int, text: int, grid: tuple[int, int, int]):
    """(B, S, 3) int32 M-RoPE positions: ``text`` text tokens (one position
    in all three streams), an image of (t, h, w) = ``grid`` patches (each
    stream its own index, from the text's end), then text again from the
    largest position + 1, as Qwen2-VL lays them out: the three streams
    differ over the image."""
    t, h, w = torch.meshgrid(*(torch.arange(n) for n in grid), indexing="ij")
    img = (torch.stack([t.flatten(), h.flatten(), w.flatten()], -1) + text)[: S - text]
    tail = torch.arange(S - text - len(img))[:, None].expand(-1, 3) + int(img.max()) + 1
    pos = torch.cat([torch.arange(text)[:, None].expand(-1, 3), img, tail])
    return pos.to(torch.int32)[None].expand(B, S, 3).contiguous()


def path_batch(torch, cfg, B: int, S: int, seed: int = 0, image: tuple[int, tuple] | None = None) -> dict:
    """A prefill's inputs on the CPU, from ``seed``: tokens, or where the
    config takes embeddings, N(0, 1) embeddings in bf16 and, with M-RoPE and
    ``image`` = (text tokens, grid), image positions
    (``mrope_image_positions``; the default positions otherwise)."""
    import numpy as np

    if cfg.input_mode == "tokens":
        return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)))}
    g = torch.Generator().manual_seed(seed)
    batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=g).bfloat16()}
    if cfg.mrope and image:
        batch["positions"] = mrope_image_positions(torch, B, S, *image)
    return batch


def step_batch(cfg, batch: dict, t: int) -> dict:
    """Decode's input at position t: that column of the prefill's inputs."""
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    return {key: batch[key][:, t : t + 1]}


def on(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def drive_path(torch, get_config, ops, dev, arch: str) -> tuple[dict, dict]:
    """Prefill, serve (or decode), profile and check one architecture at
    full width (cut to ``n_layers`` where PATHS names it, with its
    ``depth_why``) through ``Model`` and ``BatchedServer``, after reckoning
    its memory. A config that takes embeddings prefills from random bf16
    embeddings (qwen2-vl-2b at image positions, MROPE_TEXT and MROPE_GRID)
    and, in place of the server, runs ``decode_steps`` decode steps from
    embeddings (``embeds_decode``). -> the kernel launches of the prefill and
    of the serve (decode) run, each counted from 0 just before it."""
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import Model

    path = PATHS[arch]
    B, S = path["B"], path["S"]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=path.get("n_layers", full.n_layers))
    reckoning = memory_reckoning(cfg, full)
    tokens_in = cfg.input_mode == "tokens"

    # -- prefill: Model.forward at full width ------------------------------------
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    if tokens_in:
        server = BatchedServer(model, batch=4, max_len=128, seed=0)  # draws the weights once for both phases
        params = server.params
    else:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = on(path_batch(torch, cfg, B, S, image=(MROPE_TEXT, MROPE_GRID)), dev)
    t0 = time.perf_counter()
    with torch.inference_mode(), recording_moe() as moe_calls:  # compiles the Triton kernel for the prefill's shapes
        model.forward(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    moe_stats = moe_prefill_stats(cfg, B * S, moe_calls)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(logits.float()).all())
    inputs = "tokens" if tokens_in else "bf16 embeddings" + (
        f", M-RoPE image positions ({MROPE_TEXT} text, {'x'.join(map(str, MROPE_GRID))} patches, text)"
        if cfg.mrope else "")
    emit("prefill", arch=arch, layers=cfg.n_layers, n_params=cfg.n_params(), batch=B, seq=S, inputs=inputs,
         logits_shape=list(logits.shape), finite=finite, init_s=init_s, init_peak_memory_gb=init_peak_gb,
         first_call_ms=first_ms, wall_ms=prefill_ms, tokens_per_s=B * S / (prefill_ms / 1e3), peak_memory_gb=peak_gb,
         launches=prefill_counts, depth_why=path.get("depth_why", "uncut"), memory=reckoning, **moe_stats)
    if not finite or tuple(logits.shape) != (B, S, cfg.vocab):
        raise AssertionError(f"{arch} prefill logits: shape {tuple(logits.shape)}, finite {finite}")
    if prefill_counts != path["prefill"]:
        raise AssertionError(f"{arch} prefill launches {prefill_counts}, expected {path['prefill']}")
    del logits
    torch.cuda.empty_cache()

    # -- serve: BatchedServer at full width (decode steps from embeddings) -----------
    step_in = {"tokens": torch.zeros((4, 1), dtype=torch.int64, device=dev)} if tokens_in else {
        "embeds": torch.zeros((4, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)}
    model.decode_step(params, step_in, model.init_decode_state(4, 128), 0)  # compiles the decode shapes' Triton kernels
    torch.cuda.synchronize()
    if tokens_in:
        serve_counts = serve_phase(torch, ops, server, cfg, path, arch)
        del server
    else:
        serve_counts = embeds_decode(torch, ops, model, params, cfg, dev, path, arch)
    emit("profile", arch=arch, layers=cfg.n_layers, **profile_phase(torch, model, params, batch, step_in))
    del params, batch
    torch.cuda.empty_cache()

    # -- check: kernel path vs plain path, and decode vs prefill, at smoke size -------------
    emit("check", **smoke_check(torch, get_config, Model, ops, dev, arch, path["check_tokens"]))
    return prefill_counts, serve_counts


def serve_phase(torch, ops, server, cfg, path: dict, arch: str) -> dict:
    """``BatchedServer.run``: batch 4, max_len 128, 8 requests of 3-9 prompt
    tokens and 12 new tokens; all done, ``path["per_step"]`` launches a
    decode step. -> its launches."""
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(cfg.vocab, 8, 12)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats = server.run(reqs)
    counts = ops.launch_counts()
    new_tokens = sum(len(r.out) for r in reqs)
    emit("serve", arch=arch, batch=4, max_len=128, requests=len(reqs), requests_done=stats["requests_done"],
         decode_steps=stats["decode_steps"], wall_s=stats["wall_s"], new_tokens=new_tokens,
         tokens_per_s=new_tokens / stats["wall_s"], mean_step_ms=stats["metrics"]["mean_step_s"] * 1e3,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    if stats["requests_done"] != len(reqs):
        raise AssertionError(f"{arch}: served {stats['requests_done']} of {len(reqs)} requests")
    want = {k: n * stats["decode_steps"] for k, n in path["per_step"].items()}
    if counts != want:
        raise AssertionError(f"{arch} serve launches {counts}, expected {path['per_step']} per decode step")
    return counts


def embeds_decode(torch, ops, model, params, cfg, dev, path: dict, arch: str) -> dict:
    """``Model.decode_step`` at batch 4, max_len 128, ``path["decode_steps"]``
    steps from random bf16 embeddings (seed 1), each timed on the
    synchronised host clock: finite logits of (4, vocab), ``path["per_step"]``
    launches a step. -> its launches."""
    B, n = 4, path["decode_steps"]
    embeds = torch.randn((B, n, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16().to(dev)
    state = model.init_decode_state(B, 128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, finite = [], True
    for t in range(n):
        t0 = time.perf_counter()
        logits, state = model.decode_step(params, {"embeds": embeds[:, t : t + 1]}, state, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(logits.float()).all()) and tuple(logits.shape) == (B, cfg.vocab)
    counts = ops.launch_counts()
    emit("decode", arch=arch, batch=B, max_len=128, steps=n, inputs="bf16 embeddings", step_ms=step_ms,
         mean_step_ms=sum(step_ms) / n, tokens_per_s=B * n / (sum(step_ms) / 1e3), finite=finite,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    want = {k: v * n for k, v in path["per_step"].items()}
    if not finite or counts != want:
        raise AssertionError(f"{arch} decode: finite {finite}, launches {counts}, expected {path['per_step']} a step")
    return counts


def profile_phase(torch, model, params, batch: dict, step_in: dict) -> dict:
    """torch.profiler over one prefill forward and over 3 decode steps at batch
    4 (inputs ``step_in``): device busy time (sum of kernel self times; one
    stream, so no overlap), the idle share of the synchronised wall time, the
    kernels that take the most device time, and the launches a decode step.
    The profiler's own host cost inflates the wall time, so the idle share is
    an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    state = model.init_decode_state(4, 128)

    def decode_steps():
        for i in range(3):
            model.decode_step(params, step_in, state, i)

    out = {}
    for name, fn in (("prefill", lambda: model.forward(params, batch)), ("decode_3_steps", decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, torch.inference_mode():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_events(prof)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        launches = sum(e.count for e in kernels)
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else "not measured",
            "kernel_launches": launches,
            **({"launches_per_step": launches / 3} if name == "decode_3_steps" else {}),
            "top": [{"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3} for e in top],
            **moe_scopes(prof, busy_ms), **xlstm_scopes(prof, busy_ms, wall_ms),
        }
    return out


# the MoE's scopes inside ``moe`` (``router`` holds ``top_k``), and the xLSTM
# cells' loops (the sLSTM's time loop, the mLSTM's chunks), by the JAX
# package's scope names: no other module enters a range of these names
MOE_SCOPES = ("router", "dispatch", "experts", "combine", "shared_experts", "aux_loss")
XLSTM_SCOPES = ("time_scan", "chunk_scan")


def range_times(prof, names) -> dict:
    """{name: (device ms, host ms, calls)} of the ``record_function`` ranges
    named: the device time of the kernels launched inside each range (its
    host-side range events: a kernel counts where its launch lies) and the
    host time the ranges span; only the ranges that ran."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            dev_ms, host_ms, n = out.get(e.name, (0.0, 0.0, 0))
            out[e.name] = (dev_ms + e.device_time_total / 1e3, host_ms + e.cpu_time_total / 1e3, n + 1)
    return out


def moe_scopes(prof, busy_ms: float) -> dict:
    """Device ms of the kernels launched inside each of the MoE module's
    scopes, and each one's share of the device busy time. Empty without MoE.
    In a train step the backward's kernels lie outside the ranges (the
    ``device_plane`` line attributes them); a checkpoint's recompute lies
    inside them."""
    times = range_times(prof, MOE_SCOPES)
    if not times:
        return {}
    ms = {k: times.get(k, (0.0,))[0] for k in MOE_SCOPES}
    return {"moe_scopes_ms": ms, "moe_scopes_share": {k: v / busy_ms for k, v in ms.items()},
            "moe_share": sum(ms.values()) / busy_ms}


def xlstm_scopes(prof, busy_ms: float, wall_ms: float) -> dict:
    """The xLSTM cells' loops (``time_scan``, the sLSTM's; ``chunk_scan``,
    the mLSTM's): the device ms of their kernels and its share of the device
    busy time, the host ms they span and its share of the wall. Empty without
    xLSTM. In a train step the backward's kernels lie outside the ranges (the
    ``device_plane`` line attributes them); a checkpoint's recompute lies
    inside them."""
    times = range_times(prof, XLSTM_SCOPES)
    return {"xlstm_scopes": {k: {"device_ms": d, "device_share": d / busy_ms if busy_ms else "not measured",
                                 "host_ms": h, "wall_share": h / wall_ms, "ranges": n}
                             for k, (d, h, n) in times.items()}} if times else {}


def smoke_check(torch, get_config, Model, ops, dev, arch: str, n_tokens: int) -> dict:
    """The smoke config on the card (the kernels) and on the CPU (their plain
    versions), with the same weights and inputs (tokens, or bf16 embeddings),
    for prefill and for decode, every attn layer's flash launch on the
    kernel its head dim takes.

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
      reported, not bounded;
    - with M-RoPE, a second prefill at image positions whose three streams
      differ (``mrope_image_positions``), card vs CPU: bound 0.1.

    With MoE, a token whose k-th and (k+1)-th router probabilities lie closer
    than the two sides' rounding may take another expert on one side (a route
    flip, an O(1) change of its output). The routes of the four runs (card
    and CPU, prefill and decode) are recorded, and the three comparisons
    cover the tokens before the first one any two runs route differently
    (all when none; attention is causal, and at these sizes nothing drops).
    Each MoE layer is also held layer by layer: the card's layer from the
    CPU prefill's input of that layer, its routes equal to the CPU's and its
    output within the bf16 tolerance (``check_close``)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models.moe import moe
    from repro_torch.models.modules import tree_map_with_path
    from repro_torch.models.transformer import layer_kind

    cfg = get_config(arch, smoke=True)
    gpu, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(0))
    params = tree_map_with_path(lambda _, a: a.to(dev), params_cpu)
    batch = path_batch(torch, cfg, 1, n_tokens)
    ops.reset_launch_counts()
    with torch.inference_mode(), recording_moe() as card_pre:
        fwd, _ = gpu.forward(params, on(batch, dev))
    with torch.inference_mode(), recording_moe(keep_io=True) as cpu_pre:
        fwd_cpu, _ = cpu.forward(params_cpu, batch)
    flash_counts = {k: ops.launch_counts()[k] for k in ("flash_attention", "flash_attention_wgmma")}
    variant = flash.variant(torch.bfloat16, cfg.head_dim)  # wgmma, or FMA at the smoke configs' head dim 8
    n_attn = sum(layer_kind(cfg, i) == "attn" for i in range(cfg.n_layers))
    if not (flash_counts["flash_attention"] == n_attn
            and flash_counts["flash_attention_wgmma"] == n_attn * (variant == "wgmma")):
        raise AssertionError(f"{arch} smoke prefill: flash launches {flash_counts}, {n_attn} expected on the "
                             f"{variant} kernel")
    fwd = fwd.cpu().float()
    fwd_cpu = fwd_cpu.float()
    state, state_cpu = gpu.init_decode_state(1, 32), cpu.init_decode_state(1, 32)
    decode_err, gap, gap_cpu = [], [], []
    card_dec, cpu_dec = [], []  # the MoE calls of each decode step
    for t in range(n_tokens):
        with recording_moe() as card_calls:
            logits, state = gpu.decode_step(params, on(step_batch(cfg, batch, t), dev), state, t)
        with recording_moe() as cpu_calls:
            logits_cpu, state_cpu = cpu.decode_step(params_cpu, step_batch(cfg, batch, t), state_cpu, t)
        card_dec.append(card_calls)
        cpu_dec.append(cpu_calls)
        logits, logits_cpu = logits.cpu().float(), logits_cpu.float()
        decode_err.append(float((logits - logits_cpu).abs().max()))
        gap.append(float((logits[0] - fwd[0, t]).abs().max()))
        gap_cpu.append(float((logits_cpu[0] - fwd_cpu[0, t]).abs().max()))
    out = {"arch": cfg.name, "tokens": n_tokens, "inputs": cfg.input_mode, "prefill_flash_launches": flash_counts}
    if cfg.mrope:
        image = on(path_batch(torch, cfg, 2, 16, seed=1, image=(4, (1, 2, 3))), dev)
        with torch.inference_mode():
            got = gpu.forward(params, image)[0].cpu().float()
            want = cpu.forward(params_cpu, on(image, "cpu"))[0].float()
        out["prefill_image_positions_card_vs_cpu_max_abs"] = float((got - want).abs().max())
        if not out["prefill_image_positions_card_vs_cpu_max_abs"] < 0.1:
            raise AssertionError(f"smoke check at image positions out of bound: {out}")
    n = n_tokens  # the tokens the comparisons cover
    if cpu_pre:
        n, moe_out = moe_smoke_routes(torch, moe, cfg, dev, card_pre, cpu_pre, card_dec, cpu_dec, n_tokens)
        out.update(moe_out)
    if n:
        out.update({
            "prefill_card_vs_cpu_max_abs": float((fwd - fwd_cpu)[0, :n].abs().max()), "prefill_bound": 0.1,
            "decode_card_vs_cpu_max_abs": max(decode_err[:n]), "decode_bound": DECODE_CARD_VS_CPU,
            "decode_vs_prefill_card": max(gap[:n]), "decode_vs_prefill_cpu": max(gap_cpu[:n]),
            "gap_card_vs_cpu": max(abs(x - y) for x, y in zip(gap[:n], gap_cpu[:n])), "gap_bound": 0.1,
        })
        if not (out["prefill_card_vs_cpu_max_abs"] < 0.1 and out["decode_card_vs_cpu_max_abs"] < DECODE_CARD_VS_CPU
                and out["gap_card_vs_cpu"] < 0.1):
            raise AssertionError(f"smoke check out of bound: {out}")
    return out


def moe_smoke_routes(torch, moe, cfg, dev, card_pre, cpu_pre, card_dec, cpu_dec, n_tokens) -> tuple[int, dict]:
    """``smoke_check``'s MoE part: the first token any two of its four runs
    route differently (-> the tokens the logit comparisons cover), and each
    MoE layer of the CPU prefill run again on the card from the same input:
    routes equal, output within the bf16 tolerance."""
    from repro_torch.models.modules import tree_map_with_path

    def at_token(calls, t):  # one token's routes in each MoE call of a prefill
        return [{"ids": c["ids"][t : t + 1]} for c in calls]

    first = n_tokens
    for t in range(n_tokens):
        runs = [at_token(card_pre, t), at_token(cpu_pre, t), card_dec[t], cpu_dec[t]]
        if any(first_flip(a, b) is not None for a in runs for b in runs):
            first = t
            break
    worst, n_layers = 0.0, 0
    for c in cpu_pre:
        layer = tree_map_with_path(lambda _, a: a.to(dev), c["params"])
        with torch.inference_mode(), recording_moe() as again:
            y, _ = moe(layer, c["x"].to(dev), cfg)
        if not torch.equal(again[0]["ids"].cpu(), c["ids"]):
            raise AssertionError(f"{cfg.name} MoE layer {n_layers}: the card routes the CPU's input otherwise")
        worst = max(worst, check_close(f"{cfg.name} MoE layer {n_layers}, card from the CPU's input", y.cpu(), c["y"]))
        n_layers += 1
    margins = [float((c["top"][:, -2] - c["top"][:, -1]).min()) for c in cpu_pre + [d for s in cpu_dec for d in s]]
    return first, {"moe_first_route_flip": None if first == n_tokens else first, "tokens_compared": first,
                   "moe_min_top_k_margin": min(margins), "moe_layers_checked": n_layers,
                   "moe_layer_max_abs_err": worst}


if __name__ == "__main__":
    sys.exit(main())
