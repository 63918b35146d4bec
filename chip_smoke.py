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

   long_attention -- the flash forward and backward at B 1 x S 32768 for
              qwen3-4b (GQA 32 / 8, D 128, causal) and recurrentgemma-9b (MQA
              16 / 1, D 256, window 2048), bf16, held to the JAX package's
              xla-path ``_attend_chunked`` (512-row query chunks; the (window +
              512)-key strip) run on f32 copies of the inputs, and to its
              autograd gradient, at the bf16 tolerance and block by block
              (64 rows, relative L2 within 1e-2), then
              timed beside the plain version (``_attend_chunked`` on the bf16
              inputs) and SDPA, each row with its bound
              (``long_attention_phase``); ~30 s;

then the paper's Fig. 1 engines (``core/engines.py``), first of the paths:

   engines -- ``repro_torch.benchmarks.fig01_engines`` at qwen3-4b's full width
              and depth (36 layers, B 2 x S 64): eager, blockwise (one CUDA
              graph a stage: embed, 36 layers, the head with cross-entropy; a
              sync after each) and compiled (one graph of ``Model.loss``), each
              3 steps under the thread sampler at 0.02 s with the capture inside
              the timed window (cold), then 3 more (warm: replays only): ms a
              step, tokens/s, the torch frame share, launches a step; fails
              unless both graph engines captured, every engine's warm step
              launches flash 36 and RMSNorm 145 times, the compiled loss equals
              the eager loss to the bit and every loss is finite; one eager
              step and one replay under torch.profiler (device ms, kernels,
              idle share); then the eager engine's steps (ENGINES_AGENT_STEPS,
              ENGINES_AGENT_ROUNDS rounds) bare, under the thread sampler and
              under the daemon backend, at 0.02 s: what the agent costs a job
              on the card (``engines_phase``);

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

  xlstm-125m (attention-free: (sLSTM, mLSTM x 3) x 3) at full width cut to
  one unit of its three (for the script's time): 4-7 again,
  prefill on 2 x 2048 tokens asserting 9 RMSNorm launches and no flash,
  serve asserting 9 a step, the profile also giving the device and host
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
              B = 1, S = 2048, then on xlstm-125m at full width cut to 4
              layers, one (slstm, mlstm x 3) unit of 12, at B = 8, S = 512
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
              kernels the tree holds against ``ops.launch_counts()``, and for
              qwen3-4b and deepseek-moe-16b ``fig10_12_zoom``'s row from the
              same tree (attention by flops, the MoE by ops); it fails
              when the tree is empty, when the backward holds no kernel, or
              when a ``flash_attention`` / ``fused_rmsnorm`` / ``rglru_scan``
              kernel of the path is missing from either branch;
   dryrun -- after the four train setups, the port's dry-run
              (``repro_torch.launch.dryrun.run_cell``, a shape-only trace on
              the meta device) plans each of them on the host mesh of one
              device at its cut depth and B x S, and recurrentgemma-9b at 11
              layers too: one line each with the planned state, peak, kernel
              calls a step, flops, roofline step bound and fit beside what the
              same run's train and device_plane lines measured; fails unless
              the state is 16 bytes a parameter, the kernel calls equal
              ``train_launches`` (its ``_wgmma`` keys aside), the flops are
              within DRYRUN_FLOPS_REL of the device tree's, the peak within
              DRYRUN_PEAK_REL of the card's, the bound within DRYRUN_BOUND_REL
              of the device tree's, and the plan fits where the card held the
              step (recurrentgemma-9b at 11 layers, which ran out of memory on
              an H100, must not fit);
9. trainer -- ``Trainer`` at qwen3-4b smoke on the card with the sampler and the
              watchdog on: 3 steps and a checkpoint, a second Trainer that resumes
              to 6, a third that runs 6 in one go; parameters and optimizer state
              equal to the bit; heartbeat, metrics.json and host_profile.html;
   profilerd -- the out-of-process profiling daemon (``profilerd_phase``):
              ``python -m repro_torch.profilerd attach`` as its own process,
              then the train CLI at full width (its own job: xlstm-125m, B 8 x
              S 64, 4 steps) with ``--backend daemon --spool``: both exit 0,
              status.json done with 0 dropped batches, tree.json's total its
              ``n_stacks``, the last sealed epoch equal to tree.json and
              annotated on the H100 from the trainer's device_tree.json
              (DEVICE_TREE_LOADED), the main thread holding the train step's
              and the sLSTM loop's frames, no torch or CUDA library mapped in
              the daemon (its /proc/<pid>/maps read while it runs), every stall
              resolved; the sLSTM share of the main thread's samples beside its
              share of the device tree's ms, the roots and their shares, bytes
              a stack, drain lag; the daemon's live query plane (``--serve 0``)
              polled while the job runs, then ``profilerd serve`` over its out
              dir (the device plane with the RMSNorm kernel's leaves, the
              merged plane, a folded tree that re-parses to tree.json's),
              ``export`` as folded, speedscope and html, ``check`` against
              itself; then the serve CLI at qwen3-4b, full, with a daemon it
              spawns; ~80 s;
   launcher -- the port's ``Launcher`` over xlstm-125m at full width (a
              ``TrainJobConfig`` with a checkpoint every 2 steps, B 8 x S 64, 4
              steps), one shared daemon, the in-process aggregator, the merged
              profile served: attempt 0 stopped (SIGSTOP) after a complete
              checkpoint, killed on its stale heartbeat, attempt 1 resumed from
              that step to the last; one daemon with no torch or CUDA mapped,
              both attempts in the merged tree (its total their sum), the
              served endpoints and ``top --once`` answering, no file-copy
              fallback, the RMSNorm kernel and its backward in both attempts;
              prints the heartbeats, the time to recover, push bytes, the
              rendezvous collect's ms and the stall events (``launcher_phase``);
   faults -- the port's fault corpus (``repro_torch.faults``): the two model
              scenarios at full width on the card, each through
              ``run_scenario`` with the default ``HarnessConfig`` (the windows
              of ``BENCH_detect.json``), one fault run and one control run,
              each child profiled by the port's daemon from outside:
              ``moe_imbalance`` (one deepseek-moe-16b MoE layer, 2 x 64
              tokens, collapsed inputs drop 0.875 and the retry loop
              livelocks) and ``serve_convoy`` (gemma-2b through the batched
              server, decode parked on the metrics lock); fails unless each is
              detected by an expected kind inside the fault window, its best
              time-to-detect is at most 10 epochs, its control run has no
              scored verdict, the markers reached the daemon, every child ran
              on the card and the serve children launched the RMSNorm kernel;
              prints each run's detector row, the agent's ticks and the
              daemon's samples in the fault window, the dropped fractions, the
              decode rounds a second clean and faulted, each child's cold start
              and the phase's wall (``faults_phase``);
   ep_moe -- the expert-parallel MoE (``moe_impl="shard_map"``,
              ``models/moe_shard_map.py``) run by four spawned ranks on this
              one card, a (2 data, 2 model) mesh over a gloo group (every
              rank on cuda:0): (a) ``Model.loss`` and its backward through
              the kernels at deepseek-moe-16b's full width, 3 layers (layer 0
              dense, 2 MoE), B 2 x S 2048, bf16, capacity 8: the mean loss
              over the data ranks within EP_LOSS_REL of one process's dense
              model at the same weights, each rank's expert gradients,
              summed over the data ranks, within EP_GRAD_REL_L2 of the dense
              slice; (b) the layer alone in f32 at full width for
              deepseek-moe-16b and qwen3-moe-235b-a22b on 4096 tokens: at
              capacity 8 within EP_LAYER_REL of the dense layer, at the
              default capacity equal to the bit (output, aux, gradients) to
              the one-process simulation of the four ranks on the card; per
              rank the bytes it sent through the exchange, its peak memory,
              the layer's ms beside the dense layer's, the dropped fractions
              (``ep_moe_phase``); ~60 s;
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
import gc
import json
import math
import os
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
    # attention-free, at full width cut to one (slstm, mlstm x 3) unit of its
    # three, as TRAIN_XLSTM: per layer norm1 and the cell's out_norm, plus the
    # final norm; the prefill's 2048 tokens are 8 mLSTM chunks of 256 and 2048
    # sLSTM steps; the check runs 16 tokens, two smoke chunks of 8 (a prefill
    # takes whole chunks)
    "xlstm-125m": dict(B=2, S=2048, check_tokens=16, n_layers=4,
                       depth_why="time, not memory: uncut, the prefill's profile (169,941 kernel launches, "
                                 "three sLSTM time loops of 2048 steps) took 142 s and the script 1,122 s on an "
                                 "H100, over its 1,050 s budget; at 4 layers the profile takes ~37 s; one unit "
                                 "of the three runs every layer kind",
                       prefill={**NO_LAUNCHES, "fused_rmsnorm": 9},
                       per_step={**NO_LAUNCHES, "fused_rmsnorm": 9}),
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
# xlstm-125m at full width cut to one (slstm, mlstm, mlstm, mlstm) unit of its
# 12 layers, remat "full": 8 x 512 tokens a step, so each mLSTM layer
# differentiates two whole chunks of 256 (where the JAX package's gradient is
# NaN) and the sLSTM layer a loop of 512 steps. Cut for time, not memory (12
# layers take 1.8 GB of f32 state): the profiled step of the device plane held
# ~700 K events at 12 layers, 125-175 s of the script; the prefill, the serve
# path and the launcher phase keep all 12 layers.
TRAIN_XLSTM = dict(arch="xlstm-125m", B=8, S=512, timed_steps=3, n_layers=4,
                   depth_why="for the script's time limit: one of the 3 (slstm, mlstm x 3) units, so the device "
                             "plane's profile holds one sLSTM loop of 512 steps, not three")
# The dry-run phase: each train setup planned on the meta device, held to the
# card's measurements of the same run (train_phase and device_plane keep them
# in TRAIN_MEASURED): the flops to the device tree's, the peak to
# torch.cuda.max_memory_allocated, the roofline step bound to the device
# tree's. The planned peak is the trace's live bytes (the same Python and
# autograd lifetimes as the eager step), so only the allocator's own
# rounding, the libraries' workspaces and what earlier phases left allocated
# part it from the card's. DRYRUN_UNFIT: a setup the card could not hold
# (TRAIN_HYBRID's 11 layers ran out of memory on an H100), which the plan
# must not fit.
DRYRUN_FLOPS_REL = 0.03
DRYRUN_PEAK_REL = 0.10
DRYRUN_BOUND_REL = 0.15
DRYRUN_UNFIT = dict(TRAIN_HYBRID, n_layers=11)
TRAIN_MEASURED: dict[str, dict] = {}  # arch -> what its train and device_plane lines measured
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
    plane = device_plane(torch, ops, dev, cfg, spec, lambda: step(params, opt, batches[n + 2]), mean_ms)
    TRAIN_MEASURED[cfg.name] = {"peak_memory_gb": peak_gb, "launches_per_step": per_step, "n_params": n_params,
                                "tree_flops": plane["tree_flops"], "tree_bytes": plane["tree_bytes"],
                                "bound_ms": plane["roofline"]["bound_ms"]}
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return counts


# The engines phase: fig01_engines at qwen3-4b's full width and depth; the
# eager engine's warm steps again without a sampler and under each backend
ENGINES_AGENT_STEPS = 20  # eager steps a run of the agent's cost (~1 s at ~60 ms a step)
# rounds of (bare, thread, daemon); the host spreads a bare run by ~40 % on the card, so one round
# reads the agent's cost, it does not resolve it: one, so that the ep_moe and long_attention
# phases fit in the script's time (within 1,050 s of its 1,200)
ENGINES_AGENT_ROUNDS = 1
ENGINES_LAUNCHES = {"flash_attention": 36, "flash_attention_wgmma": 36, "fused_rmsnorm": 145}  # a forward


def engines_phase(torch, ops, dev) -> dict:
    """``repro_torch.benchmarks.fig01_engines`` on the card at qwen3-4b's full
    width and depth (36 layers, 8.8 GB of bf16 weights): each engine (eager;
    blockwise, one CUDA graph a stage; compiled, one graph) runs fig01's 3
    steps under the thread sampler at 0.02 s with the capture inside the
    timed window (cold), then 3 more (warm: replays only). Fails unless the
    graph engines captured, every engine's warm steps launch flash 36 and
    RMSNorm 145 times a step, the compiled loss equals the eager loss to the
    bit and every loss is finite. Then one eager step and one compiled replay
    under torch.profiler (device ms, idle share, kernels a step; the replay
    also on CUDA events), and the agent's cost on the card: the eager
    engine's steps bare, under the thread sampler and under the daemon
    backend (a spawned ``repro_torch.profilerd``), each at 0.02 s, in
    ``ENGINES_AGENT_ROUNDS`` rounds. -> the phase's counted launches."""
    import statistics

    from repro_torch.benchmarks import fig01_engines as fig01
    from repro_torch.core import SamplerConfig, make_sampler
    from repro_torch.core.engines import EagerEngine

    t0 = time.perf_counter()
    model, params, batch = fig01.setup(dev, smoke=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    full_loss, stages = fig01.make_fns(model, params, batch)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    engines, rows = fig01.make_engines(full_loss, stages), {}
    for eng in engines:
        row = {}
        for run in ("cold", "warm"):
            ops.reset_launch_counts()
            r = fig01.run_engine(eng, params)
            counts = ops.launch_counts()
            for k, n in counts.items():
                launches[k] += n
            row[run] = {"ms_per_step": r["wall_s"] / fig01.STEPS * 1e3, "tokens_per_s": r["tokens_per_s"],
                        "torch_frame_share": r["torch_frame_share"], "loss": r["loss"],
                        "launches_per_step": {k: n / fig01.STEPS for k, n in counts.items() if n}}
        rows[eng.name] = {"captured": eng.captured, "loss_hex": row["warm"]["loss"].hex(), **row}
    eager, _, compiled = engines
    profiles = {"eager": profile_step(torch, lambda: eager.run_step(params)),
                "compiled": profile_step(torch, lambda: compiled.run_step(params))}
    profiles["compiled"]["events_ms"] = events_ms(lambda: compiled.run_step(params), iters=10)
    with torch.no_grad():
        ce = float(model.loss(params, batch)[1]["ce"])
    agent = {label: {"ms_per_step": [], "samples": []} for label in ("none", "thread", "daemon")}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(ENGINES_AGENT_ROUNDS):
            for label in agent:
                cfg = {"thread": SamplerConfig(period_s=fig01.PERIOD_S),
                       "daemon": SamplerConfig(period_s=fig01.PERIOD_S, backend="daemon", spawn_daemon=True,
                                               spool_path=str(Path(tmp) / f"engines{i}.spool"))}.get(label)
                sampler = make_sampler(cfg) if cfg else None
                if sampler:
                    sampler.start()
                    if hasattr(sampler, "wait_ready"):
                        sampler.wait_ready()  # the daemon's start-up stays out of the timed steps
                res = EagerEngine(full_loss).run(ENGINES_AGENT_STEPS, lambda i: (params,))
                if sampler:
                    sampler.stop()
                agent[label]["ms_per_step"].append(res.wall_s / ENGINES_AGENT_STEPS * 1e3)
                agent[label]["samples"].append(sampler.n_samples if sampler else 0)
    for a in agent.values():
        a["median_ms"] = statistics.median(a["ms_per_step"])
    for label in ("thread", "daemon"):
        agent[label]["overhead"] = agent[label]["median_ms"] / agent["none"]["median_ms"] - 1
    out = {
        "arch": model.cfg.name, "layers": model.cfg.n_layers, "batch": fig01.B, "seq": fig01.S,
        "steps": fig01.STEPS, "init_s": init_s, "engines": rows, "profiles": profiles, "eager_ce": ce,
        "blockwise_minus_eager_ce": rows["blockwise"]["warm"]["loss"] - ce,
        "compiled_equals_eager_bits": rows["compiled"]["warm"]["loss"] == rows["eager"]["warm"]["loss"],
        "agent_steps": ENGINES_AGENT_STEPS, "agent_period_s": fig01.PERIOD_S, "agent": agent,
        "phase_s": time.perf_counter() - t0,
    }
    emit("engines", **out)
    bad_launches = {name: e["warm"]["launches_per_step"] for name, e in rows.items()
                    if e["warm"]["launches_per_step"] != ENGINES_LAUNCHES}
    finite = all(math.isfinite(e[run]["loss"]) for e in rows.values() for run in ("cold", "warm"))
    if (not rows["blockwise"]["captured"] or not rows["compiled"]["captured"] or bad_launches or not finite
            or not out["compiled_equals_eager_bits"]):
        raise AssertionError(f"engines: captured {[e['captured'] for e in rows.values()]}, launches per step "
                             f"apart from {ENGINES_LAUNCHES}: {bad_launches}, finite {finite}, compiled loss "
                             f"{rows['compiled']['warm']['loss']!r} against eager {rows['eager']['warm']['loss']!r}")
    del model, params, batch, full_loss, stages, engines, eager, compiled
    gc.collect()  # the graphs' memory pools go with the engines
    torch.cuda.empty_cache()
    return launches


# The hand-written kernels the device plane must find in a train step's tree,
# by the layer kinds that launch them: forward under jvp(loss), backward under
# transpose(jvp(loss)) (where a checkpoint's recompute launches forwards too).
DEVICE_PLANE_KERNELS = {"attn": "flash_attention", "rec": "rglru_scan"}
DEVICE_PLANE_ATTEMPTS = 3  # profiles of one more step, where the profiler dropped a kernel's records


def device_plane(torch, ops, dev, cfg, spec: dict, run_step, timed_ms: float) -> dict:
    """The ``device_plane`` line of one train setup: ``run_step`` (one more
    train step, after the timed ones) profiled into the device tree, read as
    ``repro_torch.benchmarks.fig08_11_breakdown`` reads it, with
    ``fig10_12_zoom``'s row where the arch is one it zooms. Fails (after
    DEVICE_PLANE_ATTEMPTS profiles) if the tree is empty, the backward holds
    no kernel, or a hand-written kernel of the path holds none in either
    branch; the launches the tree's ``kernel:`` nodes count must equal
    ``ops.launch_counts()`` for the step."""
    from repro_torch.benchmarks.fig08_11_breakdown import FORWARD, BACKWARD, component_shares, step_split
    from repro_torch.benchmarks.fig10_12_zoom import attention_row, moe_row
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
    zoom = {"qwen3-4b": attention_row, "deepseek-moe-16b": moe_row}.get(cfg.name)
    if zoom:  # fig10_12_zoom's row, from this tree
        out["zoom_row"] = zoom(tree)
    emit("device_plane", **out)
    bad_counts = {k: v for k, v in kernels.items() if v["in_tree"] != v["launches"]}
    if not device_ms or not branch[BACKWARD].total("kernels") or missing or bad_counts:
        raise AssertionError(f"device plane of {cfg.name}: device ms {device_ms}, kernels missing {missing}, "
                             f"launch counts apart {bad_counts}")
    return out


def dryrun_phase(torch) -> dict:
    """The ``dryrun`` lines: each train setup (and DRYRUN_UNFIT) planned by
    ``repro_torch.launch.dryrun.run_cell`` on the host mesh of one device,
    beside TRAIN_MEASURED; fails as the module docstring says. -> no launches
    (the plan runs on the meta device)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    mesh = make_host_mesh()
    failures = []
    for spec in (TRAIN, TRAIN_HYBRID, TRAIN_MOE, TRAIN_XLSTM, DRYRUN_UNFIT):
        B, S = spec["B"], spec["S"]
        full = get_config(spec["arch"])
        cfg = dataclasses.replace(full, n_layers=spec.get("n_layers", full.n_layers))
        t0 = time.perf_counter()
        cell = run_cell(cfg, ShapeSpec(f"train_{B}x{S}", S, B, "train"), mesh=mesh, verbose=False)
        plan_s = time.perf_counter() - t0
        if cell["status"] != "ok":
            emit("dryrun", arch=cfg.name, layers=cfg.n_layers, status=cell["status"], error=cell.get("error"))
            failures.append(f"{cfg.name} at {cfg.n_layers} layers: {cell['status']}")
            continue
        ma, r = cell["memory_analysis"], cell["roofline"]
        want_calls = {k: v for k, v in train_launches(cfg, spec.get("flash", ("wgmma", "wgmma"))).items()
                      if v and not k.endswith("_wgmma")}
        measured = TRAIN_MEASURED.get(cfg.name) if spec is not DRYRUN_UNFIT else None
        line = {
            "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S, "mesh": cell["mesh"], "plan_s": plan_s,
            "state_bytes": ma["state_bytes"], "state_bytes_16n": 16 * cell["n_params"],
            "peak_gb": ma["peak_bytes_per_device"] / 1e9, "fits_hbm": ma["fits_hbm"],
            "kernel_calls": cell["kernel_calls"], "train_launches": want_calls,
            "flops": cell["tree_metrics"]["flops"], "bytes": cell["tree_metrics"]["bytes"],
            "flops_over_6nd": cell["tree_metrics"]["flops"] / (6.0 * cell["n_active_params"] * B * S),
            "t_step_ms": r["t_step_s"] * 1e3, "dominant": r["dominant"],
        }
        bad = []
        if ma["state_bytes"] != 16 * cell["n_params"]:
            bad.append("state")
        if cell["kernel_calls"] != want_calls:
            bad.append("kernel calls")
        if measured is None:
            if ma["fits_hbm"]:
                bad.append("fits where the card ran out of memory")
        else:
            line["measured"] = {k: measured[k] for k in ("peak_memory_gb", "tree_flops", "tree_bytes", "bound_ms")}
            line["flops_rel"] = line["flops"] / measured["tree_flops"] - 1
            line["peak_rel"] = line["peak_gb"] / measured["peak_memory_gb"] - 1
            line["bound_rel"] = line["t_step_ms"] / measured["bound_ms"] - 1
            line["bytes_rel"] = line["bytes"] / measured["tree_bytes"] - 1
            if not ma["fits_hbm"]:
                bad.append("does not fit where the card held the step")
            for key, tol in (("flops_rel", DRYRUN_FLOPS_REL), ("peak_rel", DRYRUN_PEAK_REL),
                             ("bound_rel", DRYRUN_BOUND_REL)):
                if abs(line[key]) > tol:
                    bad.append(f"{key} {line[key]:+.4f}")
        line["failed"] = bad
        emit("dryrun", **line)
        if bad:
            failures.append(f"{cfg.name} at {cfg.n_layers} layers: {bad}")
    emit("dryrun_phase", s=time.perf_counter() - t_phase, failures=failures)
    if failures:
        raise AssertionError(f"dry-run plans apart from the card: {failures}")
    return {}


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


# The profilerd phase: the train CLI's own job (xlstm-125m at its B 8 x S 64)
# at full width, profiled by an attached daemon; the serve CLI at qwen3-4b
# with a daemon it spawns.
PROFILERD_TRAIN = ("--full", "--steps", "4", "--no-resume")
PROFILERD_SERVE = ("--arch", "qwen3-4b", "--full", "--profile", "--backend", "daemon")
PROFILERD_TIMEOUT_S = 600
# Libraries the daemon must never map: it imports no torch and touches no card.
DAEMON_FORBIDDEN_LIBS = ("libtorch", "libc10", "libcuda", "libcudart")


def cli_json(stdout: str) -> dict:
    """The JSON object a train or serve CLI prints last (indented: it starts
    on a line of its own)."""
    i = stdout.rfind("\n{\n")
    return json.loads(stdout[i + 1:] if i >= 0 else stdout)


def mapped_files(pid: int) -> set[str]:
    """The files mapped into process ``pid`` (empty once it has exited)."""
    try:
        text = Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return set()
    return {fields[-1] for fields in (line.split() for line in text.splitlines()) if len(fields) >= 6}


def outer_sum(node, name: str, metric: str) -> float:
    """``metric`` summed over the outermost nodes called ``name`` under ``node``."""
    if node.name == name:
        return node.metrics.get(metric, 0.0)
    return sum(outer_sum(c, name, metric) for c in node.children.values())


def run_cli(args: list[str], env: dict, log: Path) -> tuple[int, dict, str]:
    """``python -m <args>`` to its end: (exit code, the JSON it printed last
    or {}, its standard output); its standard error goes to ``log``."""
    with open(log, "w") as err:
        proc = subprocess.run([sys.executable, "-m", *args], env=env, stdout=subprocess.PIPE, stderr=err,
                              text=True, timeout=PROFILERD_TIMEOUT_S)
    try:
        return proc.returncode, cli_json(proc.stdout), proc.stdout
    except ValueError:
        return proc.returncode, {}, proc.stdout


def http_get(url: str, timeout: float = 10.0) -> tuple[int, str, float]:
    """One GET: (status, body, ms); an HTTP error gives its code and body."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            code, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode("utf-8", errors="replace")
    return code, body, (time.perf_counter() - t0) * 1e3


def served_url(log: Path, marker: str) -> str | None:
    """The first ``http://host:port`` on a line of a profilerd process's log
    that holds ``marker``."""
    import re

    with contextlib.suppress(OSError):
        for line in log.read_text().splitlines():
            m = re.search(r"http://[\w.\-]+:\d+", line) if marker in line else None
            if m:
                return m.group(0)
    return None


def ms_summary(times: list[float]) -> dict:
    return {"n": len(times), "median_ms": sorted(times)[len(times) // 2] if times else None,
            "max_ms": max(times, default=None)}


def profilerd_cli(args: list[str], env: dict) -> int:
    """``python -m repro_torch.profilerd <args>`` to its end: its exit code."""
    return subprocess.run([sys.executable, "-m", "repro_torch.profilerd", *args], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, timeout=120).returncode


def offline_queries(d: Path, env: dict, tmp: Path, tree) -> tuple[dict, dict]:
    """After the daemon of (a) ended: ``python -m repro_torch.profilerd serve``
    over its out dir (the live server stops with its daemon), the device and
    merged planes and the folded tree fetched from it; then ``export`` as
    folded, speedscope and html, and ``check`` of the profile against itself.
    -> (numbers, checks)."""
    from repro_torch.core.calltree import CallTree
    from repro_torch.core.export import from_folded

    with open(tmp / "serve.log", "w") as log:
        server = subprocess.Popen([sys.executable, "-m", "repro_torch.profilerd", "serve", "--profile", str(d),
                                   "--port", "0"], env={**env, "PYTHONUNBUFFERED": "1"}, stdout=log,
                                  stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while (url := served_url(tmp / "serve.log", "serving ")) is None:
            if server.poll() is not None or time.perf_counter() - t0 > 60:
                raise AssertionError(f"profilerd serve did not start: {(tmp / 'serve.log').read_text()[-2000:]}")
            time.sleep(0.1)
        got = {q: http_get(url + q) for q in ("/tree?fmt=folded", "/tree?plane=device&fmt=folded",
                                              "/tree?plane=device&fmt=json", "/tree?plane=merged&fmt=folded",
                                              "/tree?plane=merged&fmt=json")}
    finally:
        server.terminate()
        server.wait(timeout=30)
    folded = got["/tree?fmt=folded"]
    reparsed = from_folded(folded[1]) if folded[0] == 200 else None
    device = CallTree.from_json(got["/tree?plane=device&fmt=json"][1]) \
        if got["/tree?plane=device&fmt=json"][0] == 200 else CallTree()
    # the kernels' leaves (their flops folded by the device plane's default
    # metric can round to nothing beside the products'), with their launches
    kernel_leaves: dict[str, float] = {}
    for _, n in device.root.walk():
        if n.name.startswith("kernel:"):
            kernel_leaves[n.name] = kernel_leaves.get(n.name, 0.0) + n.metrics.get("kernels", n.metrics.get("ops", 0.0))
    exports = {}
    for fmt in ("folded", "speedscope", "html"):
        out = tmp / f"export.{fmt}"
        rc = profilerd_cli(["export", str(d), "--fmt", fmt, "--out", str(out)], env)
        exports[fmt] = {"rc": rc, "bytes": out.stat().st_size if out.exists() else 0}
    check_rc = profilerd_cli(["check", str(d), "--baseline", str(d)], env)

    def samples(t) -> dict:
        return {p: n.metrics["samples"] for p, n in t.root.walk() if n.metrics.get("samples")}

    numbers = {"offline": {q: {"code": c, "ms": ms, "bytes": len(b)} for q, (c, b, ms) in got.items()},
               "device_plane_kernel_leaves": kernel_leaves, "exports": exports, "check_rc": check_rc}
    checks = {
        "served_device_and_merged": all(got[q][0] == 200 for q in got),
        "device_plane_holds_rmsnorm": {"kernel:fused_rmsnorm", "kernel:fused_rmsnorm_bwd"} <= set(kernel_leaves),
        "folded_reparses_to_tree_json": reparsed is not None and samples(reparsed) == samples(tree),
        "exports": all(e["rc"] == 0 and e["bytes"] > 0 for e in exports.values()),
        "check_against_itself": check_rc == 0,
    }
    return numbers, checks


def profilerd_phase() -> dict:
    """The out-of-process profiling daemon on the card: (a) ``python -m
    repro_torch.profilerd attach`` started first as its own process, then the
    train CLI at full width (xlstm-125m, B 8 x S 64, 4 steps) with
    ``--backend daemon --spool``; the daemon's ``/proc/<pid>/maps`` read and
    its live query plane (``--serve 0``) polled (``/status``,
    ``/tree?fmt=folded``) while it runs; after it, ``profilerd serve`` over
    the out dir, ``export`` and ``check`` (``offline_queries``); (b) the
    serve CLI at qwen3-4b, full, with a daemon it spawns. Fails unless both processes of (a) exit 0, status.json
    reads done with 0 dropped batches, tree.json's total equals ``n_stacks``,
    the last sealed epoch's samples equal tree.json's and carry the H100
    roofline annotation, events.jsonl holds DEVICE_TREE_LOADED, the main
    thread holds the train step's frames and the sLSTM loop's, no torch or
    CUDA library is mapped in the daemon, every stall is followed by a resume
    or the BYE, no Python ``backward`` frame of the port sits under the main
    thread, the live server answered both queries, the offline server the
    device plane (with the RMSNorm kernel's leaves) and the merged plane, its
    folded tree re-parses to tree.json's, the exports and the self-check exit
    0, and (b) exits 0 with samples and a daemon that finished.
    -> the kernel launches of the two runs (their CLIs' ``kernel_launches``)."""
    from repro_torch.core.calltree import CallTree
    from repro_torch.core.device_tree import load_device_tree
    from repro_torch.core.snapshot import TimelineReader

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    launches: dict[str, int] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spool, train_out = tmp / "train.spool", tmp / "train"
        d = Path(f"{spool}.d")  # the DaemonBackend's default: the trainer reads the daemon's tree back
        attach = ["repro_torch.profilerd", "attach", "--spool", str(spool), "--out", str(d),
                  "--device-tree", str(train_out / "device_tree.json"), "--epoch", "1",
                  "--max-seconds", str(PROFILERD_TIMEOUT_S), "--serve", "0"]
        train = ["repro_torch.launch.train", *PROFILERD_TRAIN, "--backend", "daemon", "--spool", str(spool),
                 "--out", str(train_out)]
        t0, wall0 = time.perf_counter(), time.time()
        mapped: set[str] = set()
        maps_reads = 0
        backlog = []  # the daemon's drain lag: bytes in the spool not yet drained, at each poll
        live = {"/status": [], "/tree?fmt=folded": []}  # the live query plane: (code, ms) a poll
        live_url = None
        with open(tmp / "daemon.log", "w") as dlog, open(tmp / "train.out", "w") as tlog, \
                open(tmp / "train.err", "w") as terr:
            daemon = subprocess.Popen([sys.executable, "-m", *attach], env=env, stdout=dlog,
                                      stderr=subprocess.STDOUT)
            trainer = subprocess.Popen([sys.executable, "-m", *train], env=env, stdout=tlog, stderr=terr)
            try:
                while trainer.poll() is None:
                    if time.perf_counter() - t0 > PROFILERD_TIMEOUT_S:
                        raise AssertionError("profilerd: the train CLI did not finish in time")
                    files = mapped_files(daemon.pid)
                    maps_reads += bool(files)
                    mapped |= files
                    with contextlib.suppress(OSError, ValueError):
                        backlog += [t["backlog_bytes"] for t in
                                    json.loads((d / "status.json").read_text())["targets"].values()]
                    live_url = live_url or served_url(tmp / "daemon.log", "live query plane: ")
                    if live_url is not None:
                        for q, polls in live.items():
                            with contextlib.suppress(OSError):
                                code, _, ms = http_get(live_url + q, timeout=5.0)
                                polls.append((code, ms))
                    time.sleep(0.5)
                daemon_rc = daemon.wait(timeout=120)
            finally:
                for proc in (trainer, daemon):
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        train_s = time.perf_counter() - t0
        train_rc = trainer.returncode
        try:
            summary = cli_json((tmp / "train.out").read_text())
        except ValueError:
            summary = {}
        status = json.loads((d / "status.json").read_text())
        tree = CallTree.from_json((d / "tree.json").read_text())
        events_path = d / "events.jsonl"
        events = [json.loads(x) for x in events_path.read_text().splitlines() if x.strip()] \
            if events_path.exists() else []
        last = TimelineReader(str(d / "timeline")).last()
        sealed = last[1] if last is not None else CallTree()
        device = load_device_tree(str(train_out / "device_tree.json"))

        def samples(t) -> dict:
            return {p: n.metrics["samples"] for p, n in t.root.walk() if n.metrics.get("samples")}

        main = tree.root.children.get("thread::MainThread")
        main_names = {n.name for _, n in main.walk()} if main is not None else set()
        main_total = main.metrics.get("samples", 0.0) if main is not None else 0.0
        stall_events = [{"kind": e["kind"], "at_s": round(e["wall_time"] - wall0, 1)} for e in events
                        if e["kind"] in ("TARGET_STALLED", "TARGET_RESUMED")]
        unresolved_stall = bool(stall_events) and stall_events[-1]["kind"] == "TARGET_STALLED" and not status["done"]
        forbidden = sorted({Path(f).name for f in mapped if any(k in Path(f).name for k in DAEMON_FORBIDDEN_LIBS)})
        backward = {name: outer_sum(node, "repro::backward", "samples") for name, node in tree.root.children.items()}
        (target,) = status["targets"].values()
        a = {
            "train_rc": train_rc, "daemon_rc": daemon_rc, "seconds": round(train_s, 1),
            "wall_s": summary.get("wall_s"), "tokens_per_s": summary.get("tokens_per_s"),
            "profile_daemon": summary.get("profile_daemon"),
            "status": {k: status.get(k) for k in ("done", "n_stacks", "n_ticks", "dropped_batches", "wire_version",
                                                   "device_plane", "unknown_stack_refs", "ingest", "timeline")},
            "bytes_per_stack": target["drained_bytes"] / max(status["n_stacks"], 1),
            "max_backlog_bytes": max(backlog, default=None), "backlog_polls": len(backlog),
            "tree_total": tree.total(), "sealed_epoch": last[0].epoch if last is not None else None,
            "sealed_annotated": any(k.startswith("hlo_") or k == "roofline_occupancy"
                                    for _, n in sealed.root.walk() for k in n.metrics),
            "device_tree_loaded": any(e["kind"] == "DEVICE_TREE_LOADED" for e in events),
            "event_kinds": sorted({e["kind"] for e in events}), "stalls": stall_events,
            "roots": {name: round(node.metrics.get("samples", 0.0) / max(tree.total(), 1.0), 4)
                      for name, node in sorted(tree.root.children.items())},
            "backward_samples_by_root": backward,
            "slstm_share_of_main_samples": outer_sum(main, "repro::_slstm", "samples") / max(main_total, 1.0)
            if main is not None else None,
            "slstm_share_of_device_ms": outer_sum(device.root, "slstm", "device_ms")
            / max(device.total("device_ms"), 1e-9),
            "daemon_maps_reads": maps_reads, "daemon_mapped_files": len(mapped), "daemon_forbidden_libs": forbidden,
            "live_server": {"url_seen": live_url is not None,
                            **{q: {"ok": sum(c == 200 for c, _ in polls), **ms_summary([ms for _, ms in polls])}
                               for q, polls in live.items()}},
        }
        checks_a = {
            "exit_codes": train_rc == 0 and daemon_rc == 0,
            "done_no_drops": bool(status["done"]) and status["dropped_batches"] == 0,
            "tree_total_is_n_stacks": tree.total() == status["n_stacks"] > 0,
            "last_epoch_is_tree": last is not None and samples(sealed) == samples(tree),
            "device_tree_loaded": a["device_tree_loaded"], "epochs_annotated": a["sealed_annotated"],
            "main_thread_frames": {"repro::train_step", "repro::_slstm"} <= main_names,
            "no_torch_or_cuda_in_daemon": maps_reads > 0 and not forbidden,
            "stalls_resolved": not unresolved_stall,
            "no_backward_frames_under_main": backward.get("thread::MainThread", 0.0) == 0.0,
            "live_server_answered": all(polls and all(c == 200 for c, _ in polls) for polls in live.values()),
        }
        served, served_checks = offline_queries(d, env, tmp, tree)
        a["served"] = served
        checks_a.update(served_checks)
        for name, n in summary.get("kernel_launches", {}).items():
            launches[name] = launches.get(name, 0) + n

        # (b) the serve CLI, its daemon spawned by the server
        rc, stats, _ = run_cli(["repro_torch.launch.serve", *PROFILERD_SERVE], env, tmp / "serve.err")
        pd = stats.get("profile_daemon") or {}
        b = {"rc": rc, "profile_samples": stats.get("profile_samples"), "requests_done": stats.get("requests_done"),
             "steps_per_s": stats.get("steps_per_s"), "profile_daemon": pd}
        checks_b = {"serve": rc == 0 and (stats.get("profile_samples") or 0) > 0 and pd.get("exit_code") == 0
                    and bool(pd.get("done"))}
        for name, n in stats.get("kernel_launches", {}).items():
            launches[name] = launches.get(name, 0) + n
        checks = {**checks_a, **checks_b}
        emit("profilerd", train_daemon=a, serve_daemon=b, checks=checks, launches=launches)
        if not all(checks.values()):
            for name in ("daemon.log", "train.err", "serve.err", "serve.log"):
                print(f"--- {name} (last 3000 bytes) ---\n{(tmp / name).read_text()[-3000:]}", file=sys.stderr)
            raise AssertionError(f"profilerd: checks failed: {sorted(k for k, v in checks.items() if not v)}")
    return launches


# The launcher phase: the port's Launcher over the JAX train CLI's default
# job, xlstm-125m at full width (B 8 x S 64, as the profilerd phase's train
# CLI), built from a TrainJobConfig because the train CLI has no flag for the
# checkpoint interval: a checkpoint every 2 steps, 4 steps (attempt 1 runs
# steps 3 and 4: the second of them is the one it profiles).
LAUNCHER_JOB = dict(arch="xlstm-125m", smoke=False, device="cuda", steps=4, global_batch=8, seq_len=64,
                    ckpt_every=2, seed=0)
# Over the trainer's cold start on the card and its longest step (the second
# of each attempt runs under torch.profiler and builds the device tree), with
# a margin; the phase prints both. Measured with a timeout of 150 s on "NVIDIA
# H100 80GB HBM3, 700.00 W": first heartbeat 16.1 s (attempt 0) and 21.3 s
# (attempt 1, which also reads the checkpoint back), longest gap 23.7 and
# 25.9 s. Attempt 1 inherits attempt 0's stale heartbeat, so its first one
# must come within the timeout too.
LAUNCHER_HANG_TIMEOUT_S = 60.0
LAUNCHER_PHASE_TIMEOUT_S = 600
# The launcher's job: the port's Trainer, each heartbeat also writing the
# process's kernel launches so far (a killed attempt writes no summary), and
# the summary of the attempt that finishes, with the card's free memory
# before the model was built (what the killed attempt's SIGKILL gave back).
LAUNCHER_DRIVER = """
import json, os, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import ops
from repro_torch.launch.train import Trainer, TrainJobConfig
free_before_model = torch.cuda.mem_get_info() if torch.cuda.is_available() else None
trainer = Trainer(TrainJobConfig(**{job!r}))
touch, pid = trainer._touch_heartbeat, os.getpid()
def heartbeat():
    with open(os.path.join({out!r}, f"launches.{{pid}}.json"), "w") as f:
        json.dump(ops.launch_counts(), f)
    touch()
trainer._touch_heartbeat = heartbeat
summary = trainer.run()
summary.update(pid=pid, mem_get_info_before_model=free_before_model,
               max_memory_allocated=torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None,
               mem_get_info_at_end=torch.cuda.mem_get_info() if torch.cuda.is_available() else None)
with open(os.path.join({out!r}, "driver_summary.json"), "w") as f:
    json.dump(summary, f)
"""


def complete_checkpoints(ckpt_dir: Path) -> list[int]:
    """The steps whose checkpoint the manager's commit rule counts: renamed
    from ``step_<n>.tmp`` to ``step_<n>``."""
    with contextlib.suppress(OSError):
        return sorted(int(p.name[5:]) for p in ckpt_dir.iterdir() if p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))
    return []


def profilerd_pids() -> set[int]:
    """Every process of this machine running ``repro_torch.profilerd``."""
    pids = set()
    for proc in Path("/proc").iterdir():
        if proc.name.isdigit():
            with contextlib.suppress(OSError):
                if b"repro_torch.profilerd" in (proc / "cmdline").read_bytes():
                    pids.add(int(proc.name))
    return pids


def tree_names(tree, root: str) -> set[str]:
    node = tree.root.children.get(root)
    return {n.name for _, n in node.walk()} if node is not None else set()


def launcher_phase(hang_timeout_s: float = LAUNCHER_HANG_TIMEOUT_S) -> dict:
    """The port's ``Launcher`` (``repro_torch.launch.launcher``) supervising
    the xlstm-125m trainer at full width on the card (``LAUNCHER_JOB``), with
    a profile dir (one shared ``--watch`` daemon), the in-process aggregator
    (``aggregate=True``), the merged profile served (``serve_port=0``) and
    ``max_restarts=2``. Attempt 0 gets SIGSTOP once a checkpoint is complete:
    alive but silent, as a real hang. Fails unless the launcher reports exit
    0 with one restart, attempt 1 resumed from that checkpoint's step and
    reached the last, one profilerd process ran and mapped no torch or CUDA
    library, both attempts have a target dir and attempt 1's ends done, the
    aggregator's merged tree holds both attempts' main-thread frames and
    equals their sum (each attempt's main thread holds the train step, the
    merged one the train step and the sLSTM loop), the launcher's server answers ``/status``,
    ``/targets`` and ``/tree?fmt=folded``, ``profilerd top --once`` against it
    exits 0, no file-copy fallback was logged and both attempts launched the
    RMSNorm kernel and its backward. Prints the first heartbeat and the
    longest gap between heartbeats of each attempt, the time to recover,
    push frames and bytes, the rendezvous collect's ms, the served
    endpoints' ms, the stall and resume events and what the rendezvous found
    of the device plane. -> the kernel launches of both attempts."""
    import glob
    import signal
    import threading

    from repro_torch.core.calltree import CallTree
    from repro_torch.core.snapshot import TimelineReader
    from repro_torch.launch.launcher import LaunchConfig, Launcher

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        work, prof = tmp / "job", tmp / "prof"
        job = {**LAUNCHER_JOB, "out_dir": str(work)}
        launcher = Launcher(LaunchConfig(
            cmd=[sys.executable, "-c", LAUNCHER_DRIVER.format(src=str(ROOT / "src"), job=job, out=str(tmp))],
            workdir=str(tmp), heartbeat_path=str(work / "heartbeat"), heartbeat_timeout_s=hang_timeout_s,
            poll_s=0.2, max_restarts=2, backoff_s=1.0, env={"PYTHONPATH": env["PYTHONPATH"]},
            profile_dir=str(prof), aggregate=True, serve_port=0,
        ))
        collect = {}
        collect_fn = launcher._collect_from_aggregator

        def timed_collect():
            t0 = time.perf_counter()
            try:
                return collect_fn()
            finally:
                collect["ms"] = (time.perf_counter() - t0) * 1e3

        launcher._collect_from_aggregator = timed_collect
        result = {}
        runner = threading.Thread(target=lambda: result.setdefault("report", launcher.run()), daemon=True)
        t0, wall0 = time.perf_counter(), time.time()
        seen_events: list[tuple[float, str]] = []  # (wall time seen, the launcher's event)
        attempts: dict[int, dict] = {}  # attempt -> pid, spawn wall time, heartbeats [(step, wall)]
        hb_mtime, stopped, mapped, maps_reads, daemons_seen, push_polls = None, None, set(), 0, set(), []
        next_slow_poll = 0.0
        runner.start()
        try:
            while runner.is_alive():
                if time.perf_counter() - t0 > LAUNCHER_PHASE_TIMEOUT_S:
                    raise AssertionError("launcher: the job did not finish in time")
                now = time.time()
                for msg in launcher.report.events[len(seen_events):]:
                    seen_events.append((now, msg))
                    if msg.startswith("spawned attempt "):
                        k = int(msg.split()[2])
                        attempts[k] = {"pid": int(msg.rsplit("pid=", 1)[1]), "spawned": now, "heartbeats": []}
                with contextlib.suppress(OSError, ValueError, IndexError):
                    mtime = os.path.getmtime(work / "heartbeat")
                    if mtime != hb_mtime and attempts:
                        step, written = (work / "heartbeat").read_text().split()
                        hb_mtime = mtime
                        attempts[max(attempts)]["heartbeats"].append((int(step), float(written)))
                if stopped is None and 0 in attempts and len(attempts) == 1 and complete_checkpoints(work / "ckpt"):
                    os.kill(attempts[0]["pid"], signal.SIGSTOP)  # alive but silent: the hang
                    stopped = {"wall": time.time(), "resume_expected": max(complete_checkpoints(work / "ckpt")),
                               "heartbeat_step": attempts[0]["heartbeats"][-1][0] if attempts[0]["heartbeats"]
                               else None}
                if time.perf_counter() >= next_slow_poll:
                    next_slow_poll = time.perf_counter() + 0.5
                    daemons_seen |= profilerd_pids()
                    for d in launcher._daemons:
                        files = mapped_files(d.pid)
                        maps_reads += bool(files)
                        mapped |= files
                    if launcher.aggregator is not None:
                        with contextlib.suppress(Exception):
                            fleet = launcher.aggregator.status()["fleet"]
                            push_polls.append((fleet["epochs_applied"], fleet["bytes"]))
                time.sleep(0.05)
            rep = result["report"]
            seconds = time.perf_counter() - t0
            url = launcher.server.url if launcher.server is not None else None
            served = {q: http_get(url + q) for q in ("/status", "/targets", "/tree?fmt=folded")} if url else {}
            top_rc = subprocess.run([sys.executable, "-m", "repro_torch.profilerd", "top", "--once", "--url", url],
                                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                                    timeout=60).returncode if url else None
        finally:
            if runner.is_alive():  # a failed check: no restart, no attempt left running
                launcher.cfg.max_restarts = -1
                for a in attempts.values():
                    with contextlib.suppress(OSError):
                        os.kill(a["pid"], signal.SIGKILL)
                runner.join(timeout=120)
            for d in launcher._daemons:
                if d.poll() is None:
                    d.kill()
                    d.wait()
            if launcher.aggregator is not None:
                launcher.aggregator.close()
            if launcher.server is not None:
                launcher.server.stop()

        fleet_d = prof / "fleet.d"
        fleet_status = json.loads((fleet_d / "status.json").read_text())
        events = [json.loads(x) for x in (fleet_d / "events.jsonl").read_text().splitlines() if x.strip()]
        targets, sealed = {}, {}
        for name in ("attempt0", "attempt1"):
            tdir = fleet_d / "targets" / name
            targets[name] = {
                "exists": tdir.is_dir(),
                "status": json.loads((tdir / "status.json").read_text()) if (tdir / "status.json").exists() else {},
                "tree": CallTree.from_json((tdir / "tree.json").read_text()) if (tdir / "tree.json").exists()
                else CallTree(),
            }
            last = TimelineReader(str(tdir / "timeline")).last() if (tdir / "timeline").is_dir() else None
            sealed[name] = last[1].total() if last is not None else 0.0
        merged = CallTree.from_json((prof / "merged_tree.json").read_text()) \
            if (prof / "merged_tree.json").exists() else CallTree()
        summary = json.loads((tmp / "driver_summary.json").read_text()) \
            if (tmp / "driver_summary.json").exists() else {}
        metrics = json.loads((work / "metrics.json").read_text()) if (work / "metrics.json").exists() else {}
        resumed_from = metrics["steps"][0]["step"] - 1 if metrics.get("steps") else None
        pid0 = attempts.get(0, {}).get("pid")
        launches0 = json.loads((tmp / f"launches.{pid0}.json").read_text()) \
            if pid0 and (tmp / f"launches.{pid0}.json").exists() else {}
        launches1 = summary.get("kernel_launches", {})
        killed = next((w for w, m in seen_events if m.startswith("heartbeat stale")), None)
        hb = {k: [w for _, w in a["heartbeats"]] for k, a in attempts.items()}

        def gaps(k: int) -> dict:
            walls = hb.get(k, [])
            return {"first_heartbeat_s": walls[0] - attempts[k]["spawned"] if walls else None,
                    "max_gap_s": max((b - a for a, b in zip(walls, walls[1:])), default=None),
                    "heartbeats": len(walls), "steps": [s for s, _ in attempts[k]["heartbeats"]]}

        recover = None
        if hb.get(0) and hb.get(1) and killed is not None:
            recover = {"last_heartbeat_to_kill_s": killed - hb[0][-1], "kill_to_first_heartbeat_s": hb[1][0] - killed,
                       "total_s": hb[1][0] - hb[0][-1]}
        push = fleet_status.get("push") or {}
        main_frames = {"repro::train_step", "repro::_slstm"}
        forbidden = sorted({Path(f).name for f in mapped if any(k in Path(f).name for k in DAEMON_FORBIDDEN_LIBS)})
        agg_status = json.loads((prof / "region.d" / "status.json").read_text()) \
            if (prof / "region.d" / "status.json").exists() else {}
        numbers = {
            "seconds": round(seconds, 1), "hang_timeout_s": hang_timeout_s, "exit_code": rep.exit_code,
            "restarts": rep.restarts, "attempts": {k: gaps(k) for k in sorted(attempts)},
            "stopped_at_heartbeat_step": (stopped or {}).get("heartbeat_step"),
            "resume_expected": (stopped or {}).get("resume_expected"), "resumed_from": resumed_from,
            "last_step": metrics.get("summary", {}).get("steps"),
            "time_to_recover": recover,
            "attempt1": {k: summary.get(k) for k in ("wall_s", "tokens_per_s", "final_loss", "mem_get_info_before_model",
                                                     "max_memory_allocated", "mem_get_info_at_end")},
            "daemon": {"profilerd_pids": sorted(daemons_seen), "maps_reads": maps_reads, "mapped_files": len(mapped),
                       "forbidden_libs": forbidden},
            "push": {"pushed_epochs": push.get("pushed_epochs"), "pushed_bytes": push.get("pushed_bytes"),
                     "bytes_per_epoch": push["pushed_bytes"] / max(push["pushed_epochs"], 1) if push else None,
                     "failures": push.get("failures"), "spilled": push.get("spilled"),
                     "daemon_epochs": (fleet_status.get("timeline") or {}).get("epochs"),
                     "aggregator": agg_status.get("fleet"), "polls": len(push_polls)},
            "merged_total": merged.total(), "targets_sealed_totals": sealed,
            "targets_tree_totals": {k: t["tree"].total() for k, t in targets.items()},
            "targets_main_frames": {k: sorted(main_frames & tree_names(t["tree"], "thread::MainThread"))
                                    for k, t in targets.items()},
            "rendezvous_collect_ms": collect.get("ms"),
            "served": {q: {"code": c, "ms": ms, "bytes": len(b)} for q, (c, b, ms) in served.items()},
            "top_once_rc": top_rc,
            "events": [{"at_s": round(w - wall0, 2), "event": m} for w, m in seen_events],
            "stall_events": [{"kind": e["kind"], "target": e.get("target"), "at_s": round(e["wall_time"] - wall0, 1)}
                             for e in events if e["kind"] in ("TARGET_STALLED", "TARGET_RESUMED", "TARGET_ATTACHED",
                                                               "TARGET_RESTARTED")],
            "device_plane_surfaced": (prof / "device_tree.json").exists(),
            "device_tree_candidates": sorted(glob.glob(str(prof / "*.d" / "device_tree.json"))
                                             + glob.glob(str(prof / "*.d" / "targets" / "*" / "device_tree.json"))),
            "trainer_device_tree": (work / "device_tree.json").exists(),
            "launches": {"attempt0": launches0, "attempt1": launches1},
        }
        checks = {
            "one_restart_exit_0": rep.exit_code == 0 and rep.restarts == 1,
            "resumed_from_the_checkpoint": stopped is not None and resumed_from == stopped["resume_expected"],
            "reached_the_last_step": numbers["last_step"] == LAUNCHER_JOB["steps"],
            "one_daemon": len(launcher._daemons) == 1 and len(daemons_seen) == 1,
            "no_torch_or_cuda_in_daemon": maps_reads > 0 and not forbidden,
            "both_attempts_targets": all(t["exists"] for t in targets.values()),
            "attempt1_done": bool(targets["attempt1"]["status"].get("done")),
            "merged_holds_both_attempts": all("repro::train_step" in tree_names(t["tree"], "thread::MainThread")
                                              for t in targets.values())
            and main_frames <= tree_names(merged, "thread::MainThread")
            and merged.total() == sum(sealed.values()) > 0,
            "served": bool(served) and all(c == 200 for c, _, _ in served.values()),
            "top_once": top_rc == 0,
            "no_file_copy_fallback": not any("file-copy" in m for m in rep.events),
            "rmsnorm_in_both_attempts": all(n.get("fused_rmsnorm", 0) > 0 and n.get("fused_rmsnorm_bwd", 0) > 0
                                            for n in (launches0, launches1)),
        }
        emit("launcher", **numbers, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"launcher: checks failed: {sorted(k for k, v in checks.items() if not v)}")
    launches = dict(launches1)
    for name, n in launches0.items():
        launches[name] = launches.get(name, 0) + n
    return launches


# The fault corpus's model scenarios, each run as BENCH_detect.json's cells are
# (the default HarnessConfig), at full width on the card.
FAULTS_SCENARIOS = ("moe_imbalance", "serve_convoy")


def faults_phase(torch, kind: str) -> dict:
    """``repro_torch.faults.run_scenario`` over ``FAULTS_SCENARIOS`` on the
    card at full width (``device="cuda"``, ``smoke=False``), a fault run and a
    control run each, after freeing the parent's cached blocks (the children
    are processes of their own). Fails unless, for both scenarios: a kind of
    the scenario's ``expected_kinds`` fires inside the fault window; the best
    time-to-detect (``floor_report``) is at most its floor of 10 epochs; the
    control run has no scored verdict; ``FAULT_INJECT`` and ``FAULT_CLEAR``
    reached the daemon's events; every child ran on this card (``kind``); and
    the serve children launched ``fused_rmsnorm``. Prints each run's detector
    row, the agent's ticks (the child's own count) and the daemon's
    ``n_stacks`` (samples ingested) inside the fault window, the MoE child's
    dropped fractions clean and collapsed, the serve child's decode rounds a
    second clean and faulted, each child's cold start (spawn to ready) and
    the phase's wall. -> the children's kernel launches (their stepped loops,
    after each child's warm-up)."""
    from repro_torch.faults import SCENARIOS, HarnessConfig, floor_report, run_scenario, score_runs
    from repro_torch.faults.scoreboard import detector_of

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = HarnessConfig(device="cuda", smoke=False)
    launches: dict[str, int] = {}
    numbers, checks = {}, {}
    for name in FAULTS_SCENARIOS:
        scen = SCENARIOS[name]
        runs = {"fault": run_scenario(scen, cfg, control=False), "control": run_scenario(scen, cfg, control=True)}
        fault, control = runs["fault"], runs["control"]
        cells = score_runs(fault.events, control.events, t_inject=fault.t_inject, t_clear=fault.t_clear,
                           epoch_s=cfg.epoch_s, grace_epochs=cfg.grace_epochs)
        floors = floor_report({name: cells})
        best = floors["per_scenario"][name]["best_ttd_epochs"]
        tp_kinds = sorted({k for c in cells.values() for k in c.kinds})
        reports = {run: r.child_reports.get("host0", {}) for run, r in runs.items()}
        for rep in reports.values():
            for k, n in rep.get("kernel_launches", {}).items():
                launches[k] = launches.get(k, 0) + n
        fault_kinds = {e["kind"] for e in fault.events}
        ticks = reports["fault"].get("agent_ticks", {})
        row = {
            "matrix": {col: cell.to_json() for col, cell in cells.items()},
            "best_ttd_epochs": best, "floors_pass": floors["pass"], "problems": floors["problems"],
            "expected_kinds": list(scen.expected_kinds), "true_positive_kinds": tp_kinds,
            "control_scored": [e["kind"] for e in control.events if detector_of(e) is not None],
            "fault_window_s": fault.t_clear - fault.t_inject,
            "agent_ticks_in_fault": ticks.get("at_clear", 0) - ticks.get("at_inject", 0),
            "agent_ticks": {run: rep.get("agent_ticks") for run, rep in reports.items()},
            "daemon_samples_in_fault": fault.n_stacks_at.get("clear", 0) - fault.n_stacks_at.get("inject", 0),
            "cold_start_s": {run: r.ready_s for run, r in runs.items()},
            "devices": {run: rep.get("device") for run, rep in reports.items()},
            "launches": {run: {k: n for k, n in rep.get("kernel_launches", {}).items() if n}
                         for run, rep in reports.items()},
        }
        if name == "moe_imbalance":
            row["dropped_frac"] = {run: rep.get("dropped_frac") for run, rep in reports.items()}
            row["capacity"] = reports["fault"].get("capacity")
            row["retry_passes"] = reports["fault"].get("retry_passes")
        if name == "serve_convoy":
            row["rounds_per_s"] = {run: rep.get("rounds_per_s") for run, rep in reports.items()}
            row["decode_steps"] = {run: rep.get("decode_steps") for run, rep in reports.items()}
        numbers[name] = row
        checks[name] = {
            "expected_kind_in_window": bool(set(tp_kinds) & set(scen.expected_kinds)),
            "best_ttd_within_floor": best is not None and best <= floors["ttd_floor_epochs"],
            "control_silent": sum(c.control_fps for c in cells.values()) == 0,
            "markers_ingested": {"FAULT_INJECT", "FAULT_CLEAR"} <= fault_kinds,
            "children_on_the_card": all(rep.get("device") == kind for rep in reports.values()),
        }
        if name == "serve_convoy":
            checks[name]["rmsnorm_launched"] = all(rep.get("kernel_launches", {}).get("fused_rmsnorm", 0) > 0
                                                   for rep in reports.values())
        if not all(checks[name].values()):  # the children's last log lines, to read the failure by
            row["host_logs"] = {run: r.host_logs for run, r in runs.items()}
    emit("faults", scenarios=numbers, launches=launches, wall_s=time.perf_counter() - t0, checks=checks)
    failed = sorted(f"{n}.{k}" for n, c in checks.items() for k, v in c.items() if not v)
    if failed:
        raise AssertionError(f"faults: checks failed: {failed}")
    return launches


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


# -- the expert-parallel MoE: four ranks on one card, over gloo -------------------------------
EP_DATA, EP_MODEL = 2, 2  # the mesh: (data, model)
EP_RULES = {"batch": ("data",)}
# (a) Model.loss at deepseek-moe-16b's full width, 3 layers (layer 0 dense, 2 MoE), global B x S, bf16
EP_TRAIN = dict(arch="deepseek-moe-16b", n_layers=3, B=2, S=2048)
# (b) the layer alone in f32 at full width, 4096 tokens (B 2 x S 2048), each arch
EP_LAYER = dict(archs=("deepseek-moe-16b", "qwen3-moe-235b-a22b"), B=2, S=2048)
EP_CAPACITY = 8.0  # where the expert-parallel layer drops nothing: it equals the dense one
EP_LOSS_REL = 1e-3  # (a): the mean loss over the data ranks against the dense model's
# (a): each expert-gradient slice against the dense one's; on the CPU the smoke model reads <= 1.07e-2
# (tests/test_torch_moe_ep.py): each data rank's bf16 weight gradient is rounded on its own
EP_GRAD_REL_L2 = 2e-2
EP_LAYER_REL = 2e-5  # (b): max |y - dense| / max |dense| in f32, as tests/test_moe_shard_map.py holds JAX's
# (b) at the default capacity: a random router drops nothing at 4096 tokens (C_s = 244 for
# deepseek-moe-16b, 3.7 sigma over the mean load), so the router's columns of the first 1/8 of the
# experts are scaled by EP_HOT_SCALE: those experts overflow each source's capacity, and the
# per-source drop (`_local_capacity`) runs. Estimated from the CPU's draw of the same router:
# ~3.4 % of slots dropped at deepseek-moe-16b, ~5.9 % at qwen3-moe-235b-a22b
EP_HOT_SCALE = 1.3
EP_TIMEOUT_S = 300
DIGEST_CHUNK = 1 << 26


def digest(torch, t) -> list[int]:
    """Two sums over the bits of ``t``, plain and weighted by position (mod
    2^64): equal tensors give equal digests, and tensors that differ in a bit
    give different ones but for a ~2^-64 collision. Holds two processes'
    tensors equal to the bit without moving them."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()])
    sums = [0, 0]
    for i in range(0, bits.numel(), DIGEST_CHUNK):
        v = bits[i:i + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + v.numel(), device=v.device, dtype=torch.int64) * 2654435761 % 2147483647 + 1
        sums[0] += int(v.sum())
        sums[1] += int((v * w).sum())
    return [s % (1 << 64) for s in sums]


def ep_generator(torch, dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed)


def ep_train_cfg(get_config, moe_impl: str):
    full = get_config(EP_TRAIN["arch"])
    return dataclasses.replace(full, n_layers=EP_TRAIN["n_layers"], capacity_factor=EP_CAPACITY, moe_impl=moe_impl)


def ep_train_batch(torch, cfg, dev) -> dict:
    tokens = torch.randint(0, cfg.vocab, (EP_TRAIN["B"], EP_TRAIN["S"] + 1), generator=ep_generator(torch, dev, 7),
                           device=dev, dtype=torch.int32)
    return {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}


def expert_axis(logical: tuple) -> int | None:
    """The axis of a routed-expert leaf (its first axis past ``layers`` is
    ``expert``; not the router's), else None."""
    d = 1 if logical[0] == "layers" else 0
    return d if logical[d] == "expert" else None


def ep_layer_inputs(torch, cfg, dev, m: int | None = None):
    """(the MoE layer's params in f32, x (B, S, D), r (B, S, D)) from seed 11;
    with ``m``, model rank m's params, each routed-expert leaf cut as it is
    drawn (the whole qwen3-moe layer is 9.7 GB in f32)."""
    from repro_torch.models.moe import moe_spec
    from repro_torch.models.modules import tree_map_with_path

    g = ep_generator(torch, dev, 11)

    def draw(_, s):
        a = s.initializer(g, torch.float32)
        d = expert_axis(s.logical)
        if m is None or d is None:
            return a
        n = a.shape[d] // EP_MODEL
        return a.narrow(d, m * n, n).clone()

    params = tree_map_with_path(draw, moe_spec(cfg))
    B, S = EP_LAYER["B"], EP_LAYER["S"]
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    r = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    return params, x, r


def ep_skewed(params: dict) -> dict:
    """``params`` with the router's columns of the first 1/8 of the experts
    scaled by EP_HOT_SCALE (a skewed router whose hot experts overflow)."""
    w = params["router"]["w"].clone()
    w[:, :w.shape[1] // 8] *= EP_HOT_SCALE
    return {**params, "router": {**params["router"], "w": w}}


def ep_leaves(tree):
    if isinstance(tree, dict):
        return {k: ep_leaves(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def ep_tensors(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(ep_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def ep_layer_outputs(y, aux: dict, leaves: dict, x) -> dict:
    """The layer's output, aux values and gradients, by name."""
    grads = {f"grad/{k}": v.grad for k, v in ep_tensors(leaves).items()}
    return {"y": y, **{f"aux/{k}": v for k, v in aux.items()}, "grad/x": x.grad, **grads}


def ep_objective(y, aux: dict, r):
    """A rank's share of ``(y . r).sum() + lb_loss`` (tests/test_torch_moe_ep.py's)."""
    return (y.float() * r).sum() + aux["lb_loss"] / EP_DATA


def ep_references(torch, get_config, dev, out_dir: Path) -> dict:
    """What the ranks' layers (b) are held to, computed first in this
    process and freed before they start: for each arch, the dense layer's
    output at capacity 8 (written to a file in ``out_dir``), its forward and
    backward timed at the default capacity with the skewed router
    (:func:`ep_skewed`), and the one-process simulation of the four ranks
    there: each rank's digests and the dropped fraction."""
    from repro_torch.models import moe_shard_map as ep
    from repro_torch.models.moe import moe, moe_spec
    from repro_torch.params import expert_slice

    refs: dict = {"layer": {}}
    for arch in EP_LAYER["archs"]:
        base = get_config(arch)
        cfg8 = dataclasses.replace(base, capacity_factor=EP_CAPACITY)
        params, x, r = ep_layer_inputs(torch, base, dev)
        with torch.no_grad():
            y8, _ = moe(params, x, cfg8)
        torch.save(y8, out_dir / f"dense_y_{arch}.pt")
        del y8
        params = ep_skewed(params)
        leaves, xl = ep_leaves(params), x.detach().requires_grad_(True)
        ms = []
        for _ in range(2):  # the first is a warm-up
            for leaf in [xl, *ep_tensors(leaves).values()]:
                leaf.grad = None
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y, aux = moe(leaves, xl, base)
            ((y.float() * r).sum() + aux["lb_loss"]).backward()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        del leaves, xl, y, aux
        torch.cuda.empty_cache()
        spec = moe_spec(base)
        ranks = range(EP_DATA * EP_MODEL)
        sim_leaves = [ep_leaves(expert_slice(params, spec, i % EP_MODEL, EP_MODEL)) for i in ranks]
        del params
        B = EP_LAYER["B"] // EP_DATA
        xs = [x[(i // EP_MODEL) * B:(i // EP_MODEL + 1) * B].clone().requires_grad_(True) for i in ranks]
        ys, auxs = ep.simulate(sim_leaves, xs, base, n_data=EP_DATA, n_model=EP_MODEL)
        sum(ep_objective(y, a, r[(i // EP_MODEL) * B:(i // EP_MODEL + 1) * B])
            for i, (y, a) in enumerate(zip(ys, auxs))).backward()
        torch.cuda.synchronize()
        refs["layer"][arch] = {
            "dense_y8": str(out_dir / f"dense_y_{arch}.pt"), "dense_layer_ms": ms[-1],
            "sim_digests": [{k: digest(torch, v) for k, v in ep_layer_outputs(y, a, lv, xi).items()}
                            for y, a, lv, xi in zip(ys, auxs, sim_leaves, xs)],
            "sim_dropped_frac": float(auxs[0]["dropped_frac"]),
        }
        del sim_leaves, xs, ys, auxs, x, r
        torch.cuda.empty_cache()
    return refs


def _zeros_like_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(torch, v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def ep_rank(rank: int, world: int, store_path: str, refs: dict, out) -> None:
    """One rank of the (EP_DATA, EP_MODEL) mesh, spawned: a gloo process
    group over a FileStore, the mesh on cuda:0 (every rank shares the one
    card), then :func:`ep_rank_checks`. Puts (rank, results, error) on ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)  # every rank on the one card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
        out.put((rank, ep_rank_checks(torch, rank, refs), None))
    except Exception:  # noqa: BLE001 - reported to the parent, which fails the phase
        out.put((rank, None, traceback.format_exc()[-4000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def ep_rank_checks(torch, rank: int, refs: dict) -> dict:
    """(a) ``Model.loss`` and its backward with ``moe_impl="shard_map"``
    through the kernels, the kernels' launches counted from 0 just before;
    the expert gradients summed over the data ranks; then, on the ranks of
    data index 0, one process's dense model at the same weights on the whole
    batch (its loss, its expert gradients' slice of this rank's model index
    held to the summed ones). (b) each arch's layer in f32: at capacity 8
    the forward against the dense output; at the default capacity with the
    skewed router the forward and backward, timed on CUDA events, digested
    against the simulation."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models import moe_shard_map as ep
    from repro_torch.models.modules import tree_leaves
    from repro_torch.params import expert_slice
    from repro_torch.sharding import sharding_ctx

    dev = torch.device("cuda")
    mesh = make_host_mesh(model_axis=EP_MODEL)
    d, m = rank // EP_MODEL, rank % EP_MODEL
    res: dict = {"rank": rank, "data": d, "model": m}

    # (a) the model
    cfg = ep_train_cfg(get_config, "shard_map")
    model = Model(cfg, device=dev)
    params = expert_slice(model.init(ep_generator(torch, dev, 0), train=True), model.spec(), m, EP_MODEL)
    torch.cuda.empty_cache()
    grads = _zeros_like_tree(torch, params)
    B = EP_TRAIN["B"] // EP_DATA
    batch = {k: v[d * B:(d + 1) * B] for k, v in ep_train_batch(torch, cfg, dev).items()}
    leaves = Model.grad_leaves(params, grads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ep.reset_exchanged_bytes()
    t0 = time.perf_counter()
    with sharding_ctx(mesh, EP_RULES):
        loss, parts = model.loss(leaves, batch)
    loss.backward()
    torch.cuda.synchronize()
    res["train"] = {"loss": float(loss.detach()), "lb_loss": float(parts["lb_loss"].detach()),
                    "step_s": time.perf_counter() - t0, "exchanged_bytes": ep.exchanged_bytes(),
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": ops.launch_counts()}
    spec = dict(tree_leaves(model.spec()))
    data_group = mesh.get_group("data")
    expert_grads = {path: g for path, g in tree_leaves(grads) if expert_axis(spec[path].logical) is not None}
    for g in expert_grads.values():
        dist.all_reduce(g, group=data_group)
    del model, params, grads, leaves, loss, parts
    torch.cuda.empty_cache()
    if d == 0:
        cfg = ep_train_cfg(get_config, "dense")
        model = Model(cfg, device=dev)
        params = model.init(ep_generator(torch, dev, 0), train=True)
        grads = _zeros_like_tree(torch, params)
        loss, parts = model.loss(Model.grad_leaves(params, grads), ep_train_batch(torch, cfg, dev))
        loss.backward()
        res["train"]["dense_loss"] = float(loss.detach())
        dense = dict(tree_leaves(grads))
        rel = {}
        for path, g in expert_grads.items():
            a = expert_axis(spec[path].logical)
            want = dense[path].narrow(a, m * g.shape[a], g.shape[a])
            rel["/".join(path)] = float((g / EP_DATA - want).norm() / want.norm())
        res["train"]["expert_grad_rel_l2"] = rel
        # parts holds the graph, whose leaves hold the parameters and, as .grad, the gradients
        del dense, model, params, grads, loss, parts
    del expert_grads
    torch.cuda.empty_cache()
    dist.barrier()  # (b) starts once the dense models of data index 0 are freed

    # (b) the layer alone, f32
    res["layer"] = {}
    for arch in EP_LAYER["archs"]:
        base = get_config(arch)
        ref = refs["layer"][arch]
        params, x, r = ep_layer_inputs(torch, base, dev, m)
        B = EP_LAYER["B"] // EP_DATA
        x, r = x[d * B:(d + 1) * B], r[d * B:(d + 1) * B]
        row: dict = {}
        ep.reset_exchanged_bytes()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            y8, aux8 = ep.moe_shard_map(params, x, dataclasses.replace(base, capacity_factor=EP_CAPACITY), mesh=mesh,
                                        data_axes=("data",))
        want = torch.load(ref["dense_y8"], map_location=dev)[d * B:(d + 1) * B]
        row["cf8"] = {"rel_err": float((y8 - want).abs().max() / want.abs().max()),
                      "dropped_frac": float(aux8["dropped_frac"]), "exchanged_bytes": ep.exchanged_bytes()}
        del y8, aux8, want
        leaves, xl = ep_leaves(ep_skewed(params)), x.detach().requires_grad_(True)
        ep.reset_exchanged_bytes()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y, aux = ep.moe_shard_map(leaves, xl, base, mesh=mesh, data_axes=("data",))
        ep_objective(y, aux, r).backward()
        end.record()
        end.synchronize()
        got = {k: digest(torch, v) for k, v in ep_layer_outputs(y, aux, leaves, xl).items()}
        want = ref["sim_digests"][rank]
        row["default"] = {"layer_ms": start.elapsed_time(end), "dropped_frac": float(aux["dropped_frac"]),
                          "exchanged_bytes": ep.exchanged_bytes(),
                          "unequal_to_simulation": sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["layer"][arch] = row
        del params, leaves, xl, y, aux
        torch.cuda.empty_cache()
    return res


def ep_moe_phase(torch, get_config, dev, card: str) -> dict:
    """The ``ep_moe`` lines: the expert-parallel MoE (``moe_impl="shard_map"``)
    run by EP_DATA x EP_MODEL ranks on this one card, each a spawned process
    on cuda:0 in a gloo group (NCCL puts no two ranks of a communicator on
    one device; gloo stages CUDA tensors through the host), after the build
    (the ranks load the built kernels). The references first
    (:func:`ep_references`), then the ranks (:func:`ep_rank_checks`). Fails
    unless every rank finished; (a) the mean loss over the data ranks is
    within EP_LOSS_REL of the dense model's and every expert-gradient slice
    within EP_GRAD_REL_L2 relative L2 of the dense one; (b) at capacity 8
    every rank's output is within EP_LAYER_REL of the dense layer's, and at
    the default capacity with the skewed router (:func:`ep_skewed`) slots
    are dropped and every rank equals the simulation to the bit, output,
    aux and gradients. Prints, per rank, the bytes it sent through the exchange, its
    peak memory and the layer's ms (CUDA events around forward and backward,
    the exchanges included, four ranks sharing the card) beside the dense
    layer's on one process, and the dropped fractions. -> the ranks' kernel
    launches in (a)'s expert-parallel run, summed."""
    import torch.multiprocessing as mp

    gc.collect()  # the ranks share the card: this process keeps no cached blocks
    torch.cuda.empty_cache()
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    world = EP_DATA * EP_MODEL
    with tempfile.TemporaryDirectory(prefix="ep_moe_") as tmp:
        refs = ep_references(torch, get_config, dev, Path(tmp))
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t0
        ctx = mp.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=ep_rank, args=(r, world, str(Path(tmp) / "store"), refs, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            results = [out.get(timeout=EP_TIMEOUT_S) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    errors = {r: err for r, _, err in results if err}
    if errors:
        raise AssertionError(f"ep_moe ranks failed: {errors}")
    res = {r: x for r, x, _ in results}
    failures = []
    losses = [res[d * EP_MODEL]["train"]["loss"] for d in range(EP_DATA)]
    dense_loss = res[0]["train"]["dense_loss"]
    loss_rel = abs(sum(losses) / EP_DATA - dense_loss) / abs(dense_loss)
    grad_rel = {f"model{m}/{k}": v for m in range(EP_MODEL) for k, v in res[m]["train"]["expert_grad_rel_l2"].items()}
    if not loss_rel <= EP_LOSS_REL:
        failures.append(f"(a) loss {loss_rel}")
    if not grad_rel or max(grad_rel.values()) > EP_GRAD_REL_L2:
        failures.append(f"(a) expert gradients {grad_rel}")
    emit("ep_moe", check="a", arch=EP_TRAIN["arch"], layers=EP_TRAIN["n_layers"], batch=EP_TRAIN["B"],
         seq=EP_TRAIN["S"], mesh=[EP_DATA, EP_MODEL], capacity_factor=EP_CAPACITY, card=card,
         dense_loss=dense_loss, rank_losses=losses, loss_rel=loss_rel, expert_grad_rel_l2=grad_rel,
         ranks={r: {k: res[r]["train"][k] for k in ("step_s", "exchanged_bytes", "peak_memory_gb", "lb_loss")}
                for r in res})
    for arch in EP_LAYER["archs"]:
        rows = {r: res[r]["layer"][arch] for r in res}
        cf8 = max(row["cf8"]["rel_err"] for row in rows.values())
        unequal = {r: row["default"]["unequal_to_simulation"] for r, row in rows.items()
                   if row["default"]["unequal_to_simulation"]}
        if not cf8 <= EP_LAYER_REL:
            failures.append(f"(b) {arch} capacity 8: {cf8}")
        if unequal:
            failures.append(f"(b) {arch} default capacity apart from the simulation: {unequal}")
        dropped = {r: row["default"]["dropped_frac"] for r, row in rows.items()}
        if not min(dropped.values()) > 0:
            failures.append(f"(b) {arch} default capacity, skewed router: nothing dropped {dropped}")
        emit("ep_moe", check="b", arch=arch, tokens=EP_LAYER["B"] * EP_LAYER["S"], dtype="float32",
             mesh=[EP_DATA, EP_MODEL], card=card, cf8_rel_err=cf8, default_equal_to_simulation=not unequal,
             router_hot_scale=EP_HOT_SCALE,
             dropped_frac=rows[0]["default"]["dropped_frac"], sim_dropped_frac=refs["layer"][arch]["sim_dropped_frac"],
             dense_layer_ms=refs["layer"][arch]["dense_layer_ms"],
             ranks={r: {"layer_ms": row["default"]["layer_ms"], "exchanged_bytes": row["default"]["exchanged_bytes"],
                        "exchanged_bytes_cf8": row["cf8"]["exchanged_bytes"],
                        "peak_memory_gb": row["peak_memory_gb"]} for r, row in rows.items()})
    launches: dict[str, int] = {}
    for r in res.values():
        for k, n in r["train"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    emit("ep_moe_phase", s=time.perf_counter() - t0, references_s=refs_s, launches=launches, failures=failures,
         main_reserved_gb=reserved_gb)
    if failures:
        raise AssertionError(f"ep_moe: {failures}")
    return launches


# -- the flash kernels at 32k tokens against the chunked oracle ------------------------------
LONG_ATTENTION = (("qwen3-4b", 1, 32768), ("recurrentgemma-9b", 1, 32768))


def long_attention_phase(torch, F, ops, get_config, dev, card: str) -> dict:
    """The ``long_attention`` lines: the flash forward (the wgmma kernel) and
    backward (the wgmma pair) at B 1 x S 32768 for each of LONG_ATTENTION,
    causal with the config's window, bf16, held to ``_attend_chunked`` (the
    JAX package's xla path: 512-row query chunks, the (window + 512)-key
    strip under a window) run on f32 copies of the same inputs, and its
    autograd gradient, at the bf16 tolerance, and every (batch, head, 64
    rows) block of the output and of each gradient within
    FLASH_BWD_BLOCK_REL_L2 (a kernel that dropped one of the 256 key tiles
    of a late row would read ~6 % there). Each row: the kernel's ms, its
    bound, the plain version's ms (``_attend_chunked`` on the bf16 inputs;
    its autograd backward) and SDPA's (its backward through autograd), all
    on CUDA events: calls of 2.5-66 ms hide the launch, and the profiler on
    the card's machine drops one record of such a kernel in most profiled runs
    (``time_ms`` then fails). -> {"flash_attention": rows, "flash_attention_bwd": rows}."""
    from repro_torch.models.attention import _attend_chunked

    rows: dict = {"flash_attention": [], "flash_attention_bwd": []}
    for arch, B, S in LONG_ATTENTION:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
        g = torch.Generator(device=dev).manual_seed(29)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16() for _ in range(2))
        do = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
        leaves = [a.float().requires_grad_(True) for a in (q, k, v)]
        want = _attend_chunked(*leaves, cfg, window=window)
        want.backward(do.float())
        want = want.detach()
        want_grads = [a.grad for a in leaves]
        del leaves
        shape = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window)
        counts0 = before = ops.launch_counts()
        o, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)
        grads = ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
        after = ops.launch_counts()
        wgmma = (after["flash_attention_wgmma"] - before["flash_attention_wgmma"],
                 after["flash_attention_bwd_wgmma"] - before["flash_attention_bwd_wgmma"])
        if wgmma != (1, 1):
            raise AssertionError(f"flash at 32k ({arch}): wgmma launches {wgmma}, expected one forward and one pair")
        err = check_close("flash_attention at 32k", o, want, **shape)
        # late rows read ~0.006, under the bf16 atol, and the largest error is
        # the bf16 rounding of an early row's output (|o| ~ 2-4): each block
        # of 64 rows is held to the f32 oracle relative to its own size
        block = block_rel_l2(o, want)
        if not block <= FLASH_BWD_BLOCK_REL_L2["bfloat16"]:
            raise AssertionError(f"flash_attention at 32k ({arch}): a block's relative L2 error {block}")
        checks = {n: flash_grad_close(f"flash_attention_bwd at 32k {n}", x, w, **shape)
                  for n, x, w in zip(("dq", "dk", "dv"), grads, want_grads)}
        del want, want_grads, grads
        torch.cuda.empty_cache()
        flops, nbytes = ops.flash_work(q, k, True, window)
        bflops, bbytes = ops.flash_work(q, k, True, window, backward=True)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            def sdpa(*t):
                return F.scaled_dot_product_attention(*t, is_causal=True, enable_gqa=True)

            sdpa_args = (qt, kt, vt)
            library_call = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
        else:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

            def sdpa(*t):  # the memory-efficient kernel: the math one would hold 16 x S x S scores
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(*t, attn_mask=mask)

            sdpa_args = (qt, kt.repeat_interleave(Hq // Hkv, dim=1), vt.repeat_interleave(Hq // Hkv, dim=1))
            library_call = (f"F.scaled_dot_product_attention(attn_mask=causal window {window}, memory-efficient "
                            f"kernel), k/v repeated to {Hq} heads")
        sdpa_leaves = [a.detach().requires_grad_(True) for a in sdpa_args]
        sdpa_out = sdpa(*sdpa_leaves)
        plain_leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        plain_out = _attend_chunked(*plain_leaves, cfg, window=window)
        fwd_bound, fwd_by = bound_ms(nbytes, flops, "bfloat16")
        bwd_bound, bwd_by = bound_ms(bbytes, bflops, "bfloat16")
        common = {"arch": arch, "card": card, "timed_by": "cuda events", "shape": f"q {B}x{S}x{Hq}x{D}, k/v {B}x{S}x{Hkv}x{D}, bf16, causal"
                  + (f", window {window}" if window else ""), "oracle": "_attend_chunked on f32 copies"}
        fwd = {**common, "max_abs_err": err, "block_rel_l2": block,
               "ms": events_ms(lambda: ops.flash_attention(q, k, v, window=window), 5),
               "plain_ms": events_ms(lambda: _attend_chunked(q, k, v, cfg, window=window), 1),
               "library_ms": events_ms(lambda: sdpa(*sdpa_args), 5), "library_call": library_call,
               "bound_ms": fwd_bound, "bound_by": fwd_by, "flops": flops, "bytes": nbytes}
        bwd = {**common, "max_abs_err": max(e for e, _ in checks.values()),
               "block_rel_l2": {n: b for n, (_, b) in checks.items()},
               "ms": events_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse), 5),
               "plain_ms": events_ms(lambda: torch.autograd.grad(plain_out, plain_leaves, do, retain_graph=True), 1),
               "library_ms": events_ms(lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, do.transpose(1, 2),
                                                                   retain_graph=True), 5),
               "library_call": f"torch.autograd.grad of {library_call}",
               "bound_ms": bwd_bound, "bound_by": bwd_by, "flops": bflops, "bytes": bbytes}
        counts = ops.launch_counts()  # the row's launches: the checked one and the timed ones
        fwd["launches"] = counts["flash_attention"] - counts0["flash_attention"]
        bwd["launches"] = counts["flash_attention_bwd"] - counts0["flash_attention_bwd"]
        del sdpa_out, sdpa_leaves, plain_out, plain_leaves, o, lse
        torch.cuda.empty_cache()
        fwd["s"] = bwd["s"] = time.perf_counter() - t0
        rows["flash_attention"].append(fwd)
        rows["flash_attention_bwd"].append(bwd)
    return rows


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
    long_rows = long_attention_phase(torch, F, ops, get_config, dev, smi)
    for name, rows in long_rows.items():
        for row in rows:
            emit("long_attention", name=name, **row)
    torch.cuda.empty_cache()

    # -- the paper's Fig. 1 engines: eager, and in CUDA graphs; first of the paths, in a process
    # whose host is still quiet (the eager step ran 3x slower after the serving paths) ------------
    launches = engines_phase(torch, ops, dev)

    # -- the serving paths: prefill, serve, profile, check ---------------------------------------
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
                lambda: dryrun_phase(torch),
                lambda: trainer_phase(torch, ops, dev),
                lambda: profilerd_phase(),
                lambda: launcher_phase(),
                lambda: faults_phase(torch, kind),
                lambda: ep_moe_phase(torch, get_config, dev, smi)):
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
        if name in long_rows:  # at 32k tokens, held to the chunked oracle (long_attention)
            row["s32k"] = [{k: r[k] for k in ("arch", "shape", "launches", "ms", "bound_ms", "bound_by", "plain_ms",
                                              "library_ms", "max_abs_err")} for r in long_rows[name]]
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
