#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card (nvidia-smi name and power limit); build the FDP kernels from
     ``src/repro_torch/kernels/csrc/`` (one nvcc per source, in parallel)
     and print the seconds; beside the build, ``kernels.sass_report``
     compiles the three tiled kernels (dense, sorted-segment forward and
     weight gradient) with ``-Xptxas -v`` and prints each instantiation's
     registers, spills and SASS instructions a product;
  2. the dense FDP GEMM kernel against its plain PyTorch version on the
     card, torch.equal, over formats, round/overflow modes, register
     capacities 2, 4, 6, 12 and 32 (1, 3, 6, 12 and 26 limbs; a saturating
     3-limb register fed products past its top limb), thread tiles of 1, 2
     and 4 rows (calls of 1, 2 and more rows), tiles ragged in M, N and K,
     transposed operands, a broadcast weight that folds into the rows and
     one that does not, one register fed more than SAFE_CHUNK positive
     products whatever the K split, the full-width decode shapes of
     qwen3-0.6b, the full-width dbrx-132b training LM head forward (on its
     first 64 columns), and the 2-D router shape of dbrx-132b through
     ``ops.fdp_gemm``; the dense kernel timed at the main path's shapes
     (qwen3-0.6b's and dbrx-132b's attention at decode among them) at 91
     bits and at <9,6,-20> on the same inputs, beside its bound; then the
     sorted-segment kernel against its plain version over formats, modes,
     register capacities 2, 4, 6, 12 and 32 (a saturating 3-limb register
     fed products past its top limb), zero-size groups (leading and
     trailing), one group holding every row, rows past the total, groups
     longer than a row tile with partial last tiles, 1- and 2-row groups,
     RNE where every product rounds, one-row tiles (T = E: their own
     register path) in posit, with RNE rounding and with a saturating
     3-limb register, a transposed weight, the three full-width expert
     shapes of a dbrx-132b
     decode step and the 256 rows of its prefill, and the 1024 rows of a
     training step's moe_in forward and its dX against the transposed
     weights (whole, checked on the first 64 output columns); the decode
     sites and the training calls timed at 91 bits and at <9,6,-20> on the
     same inputs, beside their bounds;
  3. first the init check: ``init(cfg, 0)`` of reduced qwen3-0.6b and
     reduced dbrx-132b on the card torch.equal the same on the CPU moved to
     the card (weights are drawn on the host for every device); then
     qwen3-0.6b at full width, its depth cut from 28 to 14 layers
     (``QWEN_LAYERS``; every later qwen3-0.6b phase runs this cut), served
     (4 prompts x 16 tokens, 16 generated)
     under the 91-bit FDP kernel policy, with the kernel's launch count
     set to 0 just before the first run and read just after it, and held
     against the FDP dispatches; then timing repeats in turns with the same
     serve under native fp32, the cost yardstick; then one serve of each
     policy under torch.profiler, for the device's busy and idle time and
     the kernels' summed time;
  4. a 2-layer cut of the same model: forward logits in ``pallas`` mode
     (kernel) torch.equal to ``simulate`` mode (plain);
  5. dbrx-132b (MoE, 16 experts top-4) at full width, depth cut to 1 layer,
     served the same way as phase 3: both kernels' launch counts set to 0
     just before the first run and read just after, each held against its
     sites' dispatches (dense: attention, router, lm_head; sorted-segment:
     moe_in, moe_gate, moe_out);
  6. a 1-layer cut of dbrx-132b at full width, batch 1, prompt 4: forward
     logits in ``pallas`` mode torch.equal to ``simulate`` mode;
  7. the bounds of phase 2's kernel times (the sorted-segment kernel's at
     decode and at the training calls);
  8. the sorted-segment weight-gradient kernel (the MoE ``@bwd.dB``)
     against its plain version on the card, torch.equal, over formats,
     round/overflow modes, zero-size groups (leading, inner, trailing, all),
     one group holding every row, rows past the total, one group longer
     than SAFE_CHUNK rows, groups of 1, 31, 33 and 65 rows (the last chunk
     cut short), register capacities 2, 4, 6, 12 and 32 (a saturating
     3-limb register fed products past its top limb), RNE where every
     product rounds, and the three full-width expert shapes of a dbrx-132b
     training step (4 x 64 tokens, 1024 routed rows) on 64 columns of g,
     timed on the whole shape at 91 bits and at <9,6,-20> on the same
     inputs, beside their bounds, and at moe_in's shape with no rows routed
     (the read-out and store floor) and one row a group; then the dense and
     sorted-segment kernels at that step's backward shapes, on slices: the
     LM head's dA and dB, the router's dB (the dense kernel timed there at
     both specs), and moe_in's dX against the transposed expert weights;
  9. dbrx-132b at full width, depth cut to 1 layer, trained: three steps of
     ``make_train_step`` (AdamW, cosine schedule, clip 1.0, both moments
     8x64) under the FDP kernel policy, with every kernel's launch count set
     to 0 just before the first step and read just after it, each held
     against its sites' forward and backward dispatches; a second run from
     the same seed must give the same parameters; three steps under native
     fp32 as the yardstick; one traced step per policy;
 10. the same model at batch 1 x seq 4: loss and every gradient in
     ``pallas`` mode torch.equal to ``simulate`` mode;
 11. the fault-tolerant ``Trainer`` on reduced dbrx-132b with checkpoints
     in a temporary directory: an injected failure at step 3 is recovered,
     and the final parameters equal those of a run without it, which must
     not restart; the registry's ``repro_train_step_seconds`` counts each
     executed step, ``repro_train_restarts_total`` the one restore, and a
     ``train.step`` span a step;
 12. the seed-order kernel (``ops.fdp_gemm(impl="loop")``, one thread per
     output walking k in order, carries normalized every ``plan.bk``
     products) torch.equal to its plain version and to the vector kernel over
     formats, rne and saturate, the 91-bit and the paper's <9,6,-20> spec,
     ragged and strided operands, K past bk and past SAFE_CHUNK, the
     benchmark's hot shape (256,1024,256) at the seed tile (32,32,128) and
     qwen3-0.6b's lm_head decode and mlp_in prefill shapes, where it is timed
     beside the vector kernel; its launch count is set to 0 before the first
     call and read after the last;
 13. the generator: ``generate_gemm`` for the native, simulate and pallas
     targets (a given tile and plan_gemm's) at the quickstart's shape and at
     mlp_in's, for both specs; pallas torch.equal simulate; each report's
     ``describe()`` and the correct bits against an f64 product;
 14. qwen3-0.6b at full width served under a PrecisionPlan written to JSON
     and loaded back (``policy_from_plan``): FDP91 in pallas mode by default,
     <9,6,-20> at mlp_in/mlp_gate/mlp_out, lm_head native fp32; the dense
     kernel's launches equal the dispatches at the pallas sites (a trace
     hook attributes them by site: lm_head none), no backward site, tokens
     repeat, median of three serves; then at 2 layers the plan's logits
     torch.equal its simulate twin's, and their top-1 agreement with fp32;
 15. the checked-in zoo plan ``examples/plans/qwen3_0p6b.json`` (all native),
     unchanged, serving qwen3-0.6b at full width once with no FDP launch,
     and its Adam moments through ``state_quant_from_policy`` (8x64);
 16. the paper's tailoring loop at full width: calibrate qwen3-0.6b (weights
     from seed 0) under native fp32 on 2 x 8 tokens with targets, one
     forward and one backward of the LM loss; its forward sites must be
     phase 3's FDP sites, each with its @bwd.dA/dB pair, one record a
     dispatch and a sample at every site; the trace saved and loaded back
     equal; searched on the card over the FDP-only grid (fp32 and bf16,
     widths 24, 40, 64, budget 10 bits) in ``pallas`` mode, with the dense
     kernel's launches held to the pallas dispatches, and in ``simulate``
     mode: the plans equal site for site and every frontier equal; searched
     again with the card's latency column (each pallas candidate's plan
     autotuned first, its launches not counted as dispatches; each pick
     printed beside the 91-bit candidate's latency at the same shape), saved with
     ``PrecisionPlan.save`` and loaded back; the default grid's picks; TF32
     asserted off before each search; the searched plan served at full
     width as in phase 3 (launches == FDP dispatches, tok/s beside phase
     3's) and, at 2 layers, its logits torch.equal its simulate twin's;
 17. the workload zoo at full width (qwen3-0.6b, weights from seed 0, the
     workloads' 2 x 8 probe batch): (a) grad, logits, repro, solve and
     quant_opt under FDP91_KERNEL, MXU_FP32, the zoo plan and phase 16's
     searched plan (quant_opt under the zoo plan alone, the one with
     quantized moments), each run's dense-kernel launches equal to its pallas
     dispatches (the chunked loss's recomputed head included), grad and
     logits 24.0 under FDP91_KERNEL, repro 53.0 at every wrapping pallas
     site of the searched plan, a finite quant_opt curve with the zoo
     plan's 8x64 moments, the context's parameters unchanged after every
     run; (b) ``search(validators=grad,logits,repro)`` over phase 16's
     loaded trace and FDP-only grid in ``pallas``, its upgrades capped only
     by the frontiers (every site at its last point), every search call's
     kernel output checked against ``simulate`` as in phase 16, the loop's
     stop named, the plan saved, loaded and its recorded reports
     reproduced, its forward picks beside phase 16's; (c) at 2 layers, the
     grad and logits reports of the searched plan equal whether their FDP91
     references run in ``pallas`` or ``simulate``; (d) Fig. 2 on the card:
     fp64 FMA, double-double and the 91-bit FDP with a 53-bit read-out on
     ill-conditioned dots (cond 1e14, 12-fraction-bit grid, n 128 to 8192,
     3 trials) against the exact value, FDP91 at 53 bits for every n; (e)
     ``python -m repro_torch.workloads --plan paper_mlp.json --tolerance 2``
     in process, its drift beside the JAX package's on the CPU;
 18. the continuous engine (``launch.batching.ContinuousBatcher``): (a)
     qwen3-0.6b at full width (phase 3's weights) under the 91-bit kernel
     policy, 4 slots, max_len 160, 8 requests from torch.Generator(1) (phase
     3's 4 prompts, then prompts of 4, 8, 12 and 16 tokens generating 8-16),
     through one CUDA graph captured at warmup and through its eager twin
     (``graph=False``): one capture, a step's dense launches equal to its
     FDP dispatches at capture, the wrappers' counts over the build and the
     first run equal to two eager warm-up steps and one captured step (a
     replay goes through no wrapper), the profiler's kernel events a
     replayed step equal to the captured step's launches, graph tokens
     equal to eager tokens and the first four requests' to phase 3's;
     tok/s (median of 3) and traced idle share beside phase 3's; (b)
     dbrx-132b at 1 layer (phase 5's weights), 4 requests through 2 slots,
     the same checks for both kernels; (c) the phase's spans exported with
     ``obs.save_chrome_trace`` and read back (one ``serving.batcher_run``
     an engine run), one registry snapshot printed;
 19. the routed serving tier (``repro_torch.serving``) and the monitor:
     (a) qwen3-0.6b at full width (phase 3's weights) behind a
     ``PlanRouter`` of the MANIFEST's qwen3 plan and two plans built with
     the router's API, ``fdp91_kernel`` (FDP91_KERNEL, with the evidence of
     the derived ``/fdp91`` variant) and ``searched`` (phase 16's plan, its
     scores and passes measured by phase 17); buckets 4x40 and 4x96, 2 live
     batches, an engine cap of 3; 16 requests (phase 3's 4 prompts sent to
     ``fdp91_kernel``, then chat, solve, ``searched`` with a stream, a
     score, one request no plan satisfies and one no bucket fits; prompts
     of 4-60 tokens from torch.Generator(1)), then phase 3's prompts again
     to the evicted ``fdp91_kernel`` engine: the tokens sent to
     ``fdp91_kernel`` equal phase 3's in both waves, every other generated
     request equals a dedicated graph engine of its plan, the stream its
     tokens, the score an eager forward's within a relative 1e-5; one
     capture an engine, each engine's dense launches a step at capture equal
     to its FDP dispatches (the chat engine: 0), the wrappers' counts equal
     to two warm-up calls and one capture an engine, an evicted engine freed,
     the closed sum of ``metrics()``; 8 replays of the recaptured engine
     profiled; tok/s beside phase 18, capture seconds, the pool's stats and
     memory; (b) the monitor inside the captured graph: a
     ``ContinuousBatcher`` under ``searched`` (4 slots, max_len 40, phase
     3's four prompts) captured under the monitor once, its launches a step
     equal to the unmonitored engine's and its tokens too, no fold until a
     reader asks, its snapshot equal to an eager twin's under a second
     monitor, ``repro_monitor_calls_total`` a site equal to its dispatches
     a step times the replays; a ``ScoreEngine`` captured under a monitor
     equal to its eager twin (scores and snapshot); a calibration hook
     refuses a capture; 8 profiled replays beside the unmonitored engine's;
     one eager dispatch at 2^70 at a ``pallas`` site flips exactly that
     site to ``violated``; tok/s (median of 3) of the monitored and the
     bare graph engine and the monitored eager twin, and of one run of a
     bare eager engine;
     (c) ``python -m repro_torch.serving --arch paper-mlp --requests 3
     --max-new 3`` as a subprocess with ``--metrics-dump --inject-violation
     attn_qk --trace-out`` (graph engines under the monitor, at least one
     captured; three requests, not the default nine, since the derived
     variants' ``simulate`` captures dominate the phase), which prints the
     number of schedules it preloaded from the checked-in cuda zoo;
 20. autotune and the schedule zoo: (a) the plan cache cleared, the plan
     keys of phase 3's serve and phase 18's engine gathered
     (``core.schedules.serve_keys``) and each autotuned, with the mlp_in
     prefill and the dbrx-132b router shapes (every candidate launch
     torch.equal to the cost model's pick), each key's pick and winner
     printed with their times, the winner's cost rank and the seconds; (b)
     the zoo saved, the cache cleared, the zoo preloaded: every key a hit,
     no miss, ``persisted_loads`` the number of keys; the checked-in
     ``src/repro_torch/schedules/cuda.json`` loads with its fingerprint
     checked and covers the keys (how many of its winners this run agrees
     with, printed, not gated); (c) with the checked-in zoo preloaded,
     phase 3's serve and phase 18's graph engine give their tokens with no
     miss and every dense launch on a persisted launch (``dense_plan``
     watched), tok/s beside phases 3 and 18; (d) a ``simulate`` dbrx-132b
     graph engine at reduced widths captures and gives its eager twin's
     tokens;
 21. data parallelism on the one card: a world of four ranks sharing it
     over gloo (``launch.mesh.spawn``; NCCL refuses ranks that share a
     device), its meshes 1x4, 2x2 and 4x1 built in that one world: (a)
     ``fdp_psum`` of mlp_in's prefill (64, 1024) @ (1024, 3072) K-sharded
     over the four ranks, for the identity and two permuted shard
     assignments, torch.equal the dense kernel's unsharded output on every
     rank; ``reproducible_psum``, ``quantized_psum`` with three
     error-feedback steps and ``CompressedGradReducer`` on CUDA tensors
     torch.equal the same collectives on host tensors; ``validate_overflow()``
     silent on a benign payload and raising on every rank at a spillover on
     one; the backend of every group printed; (b) qwen3-0.6b at full width
     under FDP91_KERNEL (a seed-0 draw on every rank, checksums equal):
     ``MeshReshapeStability`` reads 53.0 logits and gradient bits on
     "1x4,2x2,4x1"; one ``make_mesh_train_step`` (AdamW, the gradient mean
     on the ⟨10,10,-20⟩ grid) on 1x4 and on 2x2 from the same weights gives
     torch.equal parameters; each rank's dense launches in the 1x4 step
     equal its FDP dispatches; the same two steps with a float gradient sum
     print their largest |difference| (reported); one process's
     ``make_train_step(microbatches=4)`` with the same fixed-point grid on
     the same batch torch.equal the 1x4 step (the check of the mesh step's
     gradient mean against a path held on its own); every all-reduce past
     1 MB timed;
 22. the sharded forward, in phase 21's world (its ranks go on, from the
     same qwen3-0.6b weights, restored): (a) ``all_gather``,
     ``psum_scatter``, ``all_to_all`` and ``axis_index`` over both axes of
     the 1x4 and 2x2 meshes on CUDA tensors torch.equal the same on host
     tensors, the ops gloo stages through the host printed; (b) qwen3-0.6b
     at full width under FDP91_KERNEL: the sequence-parallel ``forward``
     of 4 x 64 tokens on 1x4 and on 2x2, gathered, within 1e-4 x max
     |logit| of the main process's single-device forward (max |diff|, the
     rows bit-equal and top-1 agreement printed); ``serve(..., dist=)`` on
     2x2 (the Megatron MLP at decode) of phase 3's prompts gives phase 3's
     tokens; the Megatron ``mlp_block`` on a decode input torch.equal the
     local block; (c) dbrx-132b at full width cut to 1 layer, each rank
     drawing seed 0 on its host and keeping its slices (the TP f/4 slices
     and the expert-parallel E/4 experts): TP ``serve`` on 1x4 and the
     ``decode_tp`` profile's on 2x2 of phase 5's prompts give phase 5's
     tokens (each step's largest |diff| of logits against phase 5's
     printed); on the main process's 4 x 16 prefill input to layer 0's MoE
     (its full weights, before the spawn) the sequence-sharded TP
     ``moe_block`` within rtol 2e-4 / atol 2e-5 and ``moe_block_ep``
     torch.equal, with no row dropped; the sorted-segment kernel torch.equal
     its plain version at the f/4 shapes; a rank's launches of each kernel
     in each serve equal its FDP dispatches (less the Megatron MLP's
     K-split, which sums plain limbs with ``fdp_psum``); each rank's
     seconds by part, peak memory, every collective by op, size and dtype,
     and the serves' tok/s;
 23. the Mamba-2 families at published widths (``ssm_phase``): (a)
     mamba2-1.3b cut from 48 to 12 layers, (b) zamba2-2.7b cut to 12
     layers (two groups, the shared attention + MLP block after each;
     head_dim 80),
     each drawn from seed 0 on the host: the dense kernel torch.equal its
     plain version at each decode shape of a serve (the six SSM sites, the
     shared block's, the LM head), timed beside its bound; a serve of phase
     3's request shape under FDP91_KERNEL with the launch count set to 0
     just before and read just after, equal to the FDP dispatches and to
     the steps times the sites a step; the same serve again under
     torch.profiler (tokens and last logits bit-equal to the first; device
     busy, idle share, the dense kernel's seconds); a serve under MXU_FP32
     (the yardstick) and under the checked-in zoo plan
     (``examples/plans/mamba2_1p3b.json``, ``zamba2_2p7b.json``, unchanged:
     every site native, no FDP launch); ``forward`` of 4 x 72 tokens (the chunked SSD: two chunks of
     64, the second padded) within 1e-3 x max |logit| of ``prefill``'s
     per-token logits (the step recurrence);
     ``pallas`` == ``simulate`` logits at 2 layers (mamba2) and 6 (zamba2,
     one group; draws of that depth) on 1 x 8 tokens; the weights freed
     after each model (no host copy is kept); the
     seconds and the peak memory by part;
 24. the encoder-decoder and VLM families at published widths
     (``family_phase``): (a) whisper-large-v3 (d 1280, 20 heads x 64, d_ff
     5120, vocab 51866, 1500 encoder frames) cut from 32 + 32 to 4 + 4
     layers, (b) paligemma-3b (d 2048, 8 query heads on 1 KV head x 256, d_ff
     16384, vocab 257216, 256 patches) cut from 18 to 2 layers, each drawn
     from seed 0 on the host: the dense kernel torch.equal its plain version
     at each new shape (whisper's encoder prefill over 4 x 1500 frames, its
     cross K/V, the non-causal attention over two chunks of 1024 keys, the
     cross-attention and the self-attention at decode, the decoder's
     projections and LM head; paligemma's decode sites, its MQA attention
     at head_dim 256, the forward's attention and MLP over 256 patches and
     16 tokens), the plain version on 64 rows and 4096 columns of each
     output where the shape is larger, the kernel timed on the whole shape
     beside its bound; a serve of phase 3's request shape under
     FDP91_KERNEL (whisper: ``prefill`` + greedy ``decode_step`` with 0.5 x
     normal frames; paligemma: ``launch.serve.serve``) with the launch
     count set to 0 just before and read just after, equal to the FDP
     dispatches and to the prefill's plus the steps times a step's; the
     same again under torch.profiler (tokens and every step's logits
     bit-equal; device busy, idle share, the dense kernel's seconds); under
     MXU_FP32 and under the checked-in zoo plan (``whisper_large_v3.json``,
     ``paligemma_3b.json``, unchanged: no FDP launch); whisper: the
     reference-shaped ``serve`` with zero frames, run once, the cached cross
     K/V torch.equal a fresh ``cross_k``/``cross_v`` dispatch of the encoder
     output, ``forward`` of 4 x 16 tokens within 1e-3 x max |logit| of
     prefill's step logits; paligemma: ``forward`` of 4 x (256 patches + 16
     tokens) repeats bit for bit and the patches + 1.0 move the text
     logits, a ``ContinuousBatcher`` graph engine of 4 slots gives the
     serve's tokens (one capture, launches a step == FDP dispatches);
     ``pallas`` == ``simulate`` logits on 1 x 8 tokens at whisper 1 + 1
     layers over 32 frames and paligemma 1 layer over 8 patches (draws of
     that depth); the weights freed after each model; the seconds and the
     peak memory by part;
 25. placed parameters and ``launch.serve --mesh`` (``place_phase``): (a)
     qwen3-0.6b at full width cut to 2 layers, served in the main process
     (4 prompts of 4 tokens, 4 generated, FDP91_KERNEL; its peak memory),
     then on a 2x2 world of four
     ranks sharing the card over gloo under ``fsdp`` and ``decode_tp``: each
     rank draws seed 0 on its host unit by unit, keeps its block of every
     weight (``launch.sharding.param_specs``) on the card and gathers each
     unit's leaves on use; on every rank the tokens equal the one-process
     serve's, the dense kernel's launches (set to 0 just before the serve,
     read just after) equal the FDP dispatches (less the Megatron MLP's
     K-split), and the placed bytes on the card equal ``param_shardings``';
     each rank's placed bytes beside the replicated figure, peak memory,
     gathered bytes a forward, seconds in gathers and in all printed; (b)
     ``python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced
     --policy fdp91_kernel --mesh 2x2 --profile fsdp`` as a subprocess: rc 0
     and the tokens of the same command without ``--mesh``;
 26. one JSON line of per-kernel numbers, then the ``ok`` line.

The weights of each config are drawn once (``init``, seconds printed) and a
host copy is kept; later phases of the same config and seed copy it back.

The bound of a kernel time is the larger of its bytes (inputs read once,
output written once) over 3.35 TB/s (H100 SXM HBM3, NVIDIA data sheet) and
the int32 operations the function needs (``fdp_gemm.int32_ops``: one decode
per distinct operand element, 20 operations per product, for the seed-order
kernel as for the vector kernel, since they compute one function; for the
sorted-segment forward kernel, the rows in a group and the weights of the
non-empty groups; for the weight-gradient kernel, the rows in a group of x
and of g, and one product per (row in a group, d, f)) over the card's int32
rate: 132 SMs x 64 INT32 lanes (Hopper white paper) x 1.98 GHz (max SM
clock) = 16.73e12 op/s. The count leaves out the read-out of each output
(one per dW element, E*d*f of them), which with a few dozen rows per group
is a real share of the weight-gradient kernel's work (phase 8 times it
apart).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH, PROMPT, GEN = 4, 16, 16
# qwen3-0.6b, the main path of phases 3-4 and 14-22: full width, depth cut
# from 28 to 14 layers for the script's time (phases 1-24 took 1179.44 s of
# its 1200 s with all 28 on an H100 80GB HBM3 at 700 W with a slow host;
# the host-bound serves, the tailoring, the workloads and the four-rank
# world scale with the depth)
QWEN_LAYERS = 14
SERVE_RUNS = 3
TRACED_STEPS = 8        # engine steps traced for kernel events and idle share
MOE_LAYERS = 1          # dbrx-132b depth cut: 17.97 GB of f32 parameters, one draw
                        # for its serve and its training step
# Training dbrx-132b: depth cut to 1 layer (17.97 GB of f32 parameters, as
# much again of gradients, 9.1 GB of 8x64 Adam moments), 4 x 64 tokens
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 1, 4, 64, 3, 1e-4
# Tailoring qwen3-0.6b: the search's error budget (the calibration shape is
# the workloads' PROBE_BATCH x PROBE_SEQ)
TAILOR_BUDGET, TAILOR_MARGIN = 10.0, 2.0
# output columns of each of the search's dense-kernel calls held against the
# plain version (an output column depends only on the same column of b)
CHECK_COLS = 64
# Phase 19, the routed serving tier: buckets, live decode batches, the pool's
# engine cap (below the trace's engines: evictions and a recapture), prompt
# lengths (short fit 4x40 with 16 new tokens, long 4x96), the trace after
# phase 3's four prompts (workload, method, prompt, extra, rejection
# expected) and the score's tolerance against an eager forward
ROUTED_BUCKETS, ROUTED_LIVE, ROUTED_ENGINES = "4x40,4x96", 2, 3
ROUTED_LENGTHS = {"short": (4, 24), "long": (32, 61)}
ROUTED_TRACE = (
    ("chat", "generate", "short", {}, None),
    ("chat", "generate", "long", {}, None),
    ("solve", "generate", "long", {}, None),
    ("searched", "generate", "short", {}, None),
    ("chat", "generate", "short", {}, None),
    ("searched", "stream", "short", {}, None),
    ("solve", "generate", "long", {}, None),
    ("chat", "generate", "long", {}, None),
    ("searched", "generate", "long", {}, None),
    ("solve", "score", "short", {}, None),
    ("chat", "generate", "short", {"min_bits": 99.0}, "RoutingError"),
    ("chat", "generate", "too_long", {}, "AdmissionError"),
)
ROUTED_SCORE_RTOL = 1e-5
# Phase 21, data parallelism on one card: a world of four ranks sharing
# cuda:0 over gloo, qwen3-0.6b's mesh step on a global batch of 4 x 64
# tokens (1 x 64 a rank), the fixed-point grid of its gradient mean (the
# train CLI's --fdp-grad spec), the phase's timeouts (a rank's collectives
# wait for the slowest rank's forward and backward, four ranks sharing the
# card), and the collectives' payloads: mlp_in's prefill (64, 1024) @ (1024,
# 3072), K-sharded, and 2^20 elements a rank for the psums
MESH_WORLD, MESH_SEQ, MESH_GRAD = 4, 64, (10, 10, -20)
MESH_TIMEOUT, MESH_COLLECTIVE_TIMEOUT = 600, 300
MESH_GEMM, MESH_PSUM = (64, 1024, 3072), 1 << 20
# Phase 22, the sharded forward in phase 21's world: qwen3-0.6b's sequence-
# parallel forward of 4 x SHARD_SEQ tokens and its tolerance (times the
# largest |logit|), the TP MoE's tolerance (the reference's moe_tp_parity),
# and EP's capacity factor (tp: a destination can take every row a rank
# sends, so none is dropped)
SHARD_SEQ, SHARD_TOL, SHARD_MOE_TOL, SHARD_EP_CF = 64, 1e-4, (2e-4, 2e-5), 4.0
# Phase 23, the Mamba-2 families at published widths: (architecture, depth
# served, depth of the pallas == simulate check, its zoo plan), each cut for
# the script's time: mamba2-1.3b from 48 to 12 layers (a run of the whole
# script with all 48 took 1111.21 s of phases on a slow host, one with 24
# and phase 24 1179.44 s), zamba2-2.7b
# from 54 to 12 (two groups of six SSM layers, each followed by the shared
# block), whose pallas == simulate check runs one group. That check runs
# SSM_EQ_SHAPE tokens (the plain version's cost grows with the rows); the
# chunked forward of SSM_FWD_SHAPE tokens (two chunks of 64, the second
# padded) is held to prefill's step recurrence within SSM_FWD_TOL x max
# |logit| (the two SSD forms sum in other orders in f32, through every
# layer)
SSM_ARCHS = (("mamba2-1.3b", 12, 2, "mamba2_1p3b.json"),
             ("zamba2-2.7b", 12, 6, "zamba2_2p7b.json"))
SSM_EQ_SHAPE, SSM_FWD_SHAPE, SSM_FWD_TOL = (1, 8), (4, 72), 1e-3
# Phase 24, the encoder-decoder and VLM families at published widths:
# (architecture, the depth cut of the served model, the cut of the pallas ==
# simulate check's draw, its zoo plan). whisper-large-v3 is cut from 32 + 32
# to 4 + 4 layers (0.37 G f32 parameters) and paligemma-3b from 18 to 2
# (1.27 G: its embedding and LM head alone are 1.05 G), both for the
# script's time; the check runs 1 + 1 layers over 32 frames and 1 layer
# over 8 patches, on FAMILY_EQ_SHAPE tokens (the plain version's cost grows
# with the rows). The plain version of the dense kernel runs on
# FAMILY_CHECK_ROWS rows and FAMILY_CHECK_COLS columns of each new shape
# (on whisper's 6000 encoder rows it would take ~50 s); whisper's forward is
# held to prefill's steps within FAMILY_FWD_TOL x max |logit|
FAMILY_ARCHS = (("whisper-large-v3", {"n_enc_layers": 4, "n_layers": 4},
                 {"n_enc_layers": 1, "n_layers": 1, "enc_seq": 32}, "whisper_large_v3.json"),
                ("paligemma-3b", {"n_layers": 2}, {"n_layers": 1, "n_patches": 8},
                 "paligemma_3b.json"))
FAMILY_EQ_SHAPE, FAMILY_FWD_TOL = (1, 8), 1e-3
FAMILY_CHECK_ROWS, FAMILY_CHECK_COLS = 64, 4096
# Phase 25, placed parameters and ``launch.serve --mesh``: qwen3-0.6b at full
# width cut to PLACE_LAYERS layers serves four prompts of PLACE_PROMPT
# tokens, PLACE_GEN tokens generated, on a 2x2 world of four ranks sharing
# the card over gloo, under each of PLACE_PROFILES. Depth, prompt and
# generation are cut for the gathers: every decode step, each prompt token's
# included, gathers every placed leaf over gloo (at 2 layers 1.37 GB a step,
# the embedding and the head 1.24 GB of it; ~0.37 GB/s received a rank). With
# 16-token prompts the phase took 189.24 s alone on an H100 80GB HBM3 at
# 700 W, beside 795.49 s for phases 1-24. Then the CLI (PLACE_CLI, reduced
# widths) with and without ``--mesh 2x2 --profile fsdp``
PLACE_LAYERS, PLACE_PROMPT, PLACE_GEN, PLACE_PROFILES = 2, 4, 4, ("fsdp", "decode_tp")
PLACE_TIMEOUT, PLACE_COLLECTIVE_TIMEOUT = 600, 300
PLACE_CLI = ("--arch", "qwen3-0.6b", "--reduced", "--policy", "fdp91_kernel")
# kernel name -> the substring of its device symbol in a profiler trace
TRACE_NAMES = {"fdp_gemm": "fdp_gemm_kernel", "fdp_ragged_gemm": "fdp_ragged_gemm_kernel",
               "fdp_ragged_dw": "fdp_ragged_dw_kernel"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


PHASE_S: dict = {}                 # phase -> seconds, host clock
_PHASE = ["", 0.0]                 # the running phase and its start


def phase(name: str) -> None:
    """End the running phase (its seconds logged and kept in ``PHASE_S``)
    and start ``name`` ("" starts none)."""
    now = time.perf_counter()
    if _PHASE[0]:
        PHASE_S[_PHASE[0]] = now - _PHASE[1]
        log(f"phase {_PHASE[0]} took {PHASE_S[_PHASE[0]]:.2f} s")
    _PHASE[:] = [name, now]


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def device_timeline(prof):
    """(device events, busy µs, span µs) of a finished torch.profiler
    session, read from its raw kineto events (building the session's
    ``events()`` costs some twenty times as long, minutes for a traced
    serve): device events as (name, start ns, end ns); busy the union of
    them (a user annotation left out, such as a schedule's ProfilerStep
    range, which the profiler also shows on the device: it is no device
    work); span from the first event to the last, host events included
    (the profiler's own bookkeeping events left out, as ``events()``
    leaves them). None when there is no device event."""
    from torch.autograd import DeviceType
    raw = [e for e in prof.profiler.kineto_results.events()
           if not e.name().startswith(("[memory]", "[OutOfMemory]", "profiler::_record_function"))]
    dev_events = [(e.name(), e.start_ns(), e.end_ns()) for e in raw
                  if e.device_type() == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", lambda: False)()
                  and not e.name().startswith("ProfilerStep")]
    if not dev_events:
        return None
    spans = sorted((start, end) for _, start, end in dev_events)
    busy_ns, (lo, hi) = 0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_ns, lo, hi = busy_ns + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy_ns += hi - lo
    span_ns = max(e.end_ns() for e in raw) - min(e.start_ns() for e in raw)
    return dev_events, busy_ns / 1e3, span_ns / 1e3


def trace_serve(torch, serve_once) -> dict:
    """Run one serve under torch.profiler and read its device timeline:
    busy seconds (union of all device events), idle share of the trace's
    span, and the summed seconds and count of each FDP kernel; None when
    the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = serve_once()
    timeline = device_timeline(prof)
    if timeline is None:
        return None
    dev_events, busy_us, span_us = timeline
    by_name: dict = {}
    for name, start, end in dev_events:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    kernels = {}
    for label, symbol in TRACE_NAMES.items():
        # "fdp_gemm_kernel" is not a substring of "fdp_ragged_gemm_kernel"
        evs = [(start, end) for name, start, end in dev_events if symbol in name]
        kernels[label] = {"count": len(evs),
                          "s": sum(end - start for start, end in evs) / 1e9}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "span_s": span_us / 1e6, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / span_us, "device_events": len(dev_events),
            "fdp_kernels": sum(k["count"] for k in kernels.values()),
            "fdp_kernel_s": sum(k["s"] for k in kernels.values()),
            "kernels": kernels, "top": [(name[:60], us / 1e6) for name, us in top]}


@contextlib.contextmanager
def pallas_dispatches(D):
    """Count every ``pallas`` dispatch (a checkpointed recompute's included,
    which reaches no trace hook) by wrapping ``dispatch._execute``; nests.
    Yields the one-element count."""
    n = [0]
    execute = D._execute

    def counting(cfg_, a_, b_, **kw):
        if cfg_.mode == "pallas":
            n[0] += 1
        return execute(cfg_, a_, b_, **kw)

    D._execute = counting
    try:
        yield n
    finally:
        D._execute = execute


@contextlib.contextmanager
def autotune_launches(D, K):
    """Count the plans the autotuner measures (``dispatch._measure_plan``)
    and the dense-kernel launches it makes timing their candidates, which
    are not dispatches. Yields the counts."""
    n = {"keys": 0, "launches": 0, "seconds": 0.0}
    measure = D._measure_plan

    def counting(*args, **kw):
        before, t = K.fdp_gemm.launches, time.perf_counter()
        try:
            return measure(*args, **kw)
        finally:
            n["keys"] += 1
            n["launches"] += K.fdp_gemm.launches - before
            n["seconds"] += time.perf_counter() - t

    D._measure_plan = counting
    try:
        yield n
    finally:
        D._measure_plan = measure


# CPU numbers of the JAX package's `python -m repro.workloads --plan
# examples/plans/paper_mlp.json` at seed 0 (drift in bits from the recorded
# scores), printed beside the port's on the card
REFERENCE_CLI_DRIFT = {"grad": 0.11, "logits": 0.06, "repro": 0.51}
# Fig. 2: the SSH recipe of benchmarks/bench_ssh.py
FIG2_NS, FIG2_COND, FIG2_TRIALS = (128, 512, 2048, 8192), 1e14, 3


def worst_leaves(report) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in report.details["worst_leaves"].items())


def workloads_phase(torch, dev, cfg, cfg2, searched_policy, legacy_plan, zoo_policy,
                    fdp_grid, first_search, card_search, validating) -> dict:
    """Phase 17: the workload zoo and the validated search at full width
    (the module docstring lists its steps). ``card_search(label, **kw)``
    is phase 16's search with its kernel-against-plain checks, and
    ``validating[0]`` switches those checks off (the validators' forwards
    and backwards run the model's own calls). ``first_search`` is phase
    16's search of the same trace and grid, whose frontiers bound the
    upgrades the validated search can make. Returns the phase's numbers
    and the dense kernel's launches in it."""
    import io

    import numpy as np

    from repro_torch.core import dispatch as D
    from repro_torch.core import metrics
    from repro_torch.core.accumulator import AccumulatorSpec
    from repro_torch.core.fdp import dd_dot, fdp_dot64, fma_dot
    from repro_torch.data.conditioned import gen_dot
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.numerics import load_plan
    from repro_torch.workloads import (DEFAULT_VALIDATORS, LogitFidelity, LossGradient,
                                       WorkloadContext, build_validators, validation_summary)
    from repro_torch.workloads import __main__ as workloads_cli

    t17 = time.perf_counter()
    launches = {"total": 0}

    @contextlib.contextmanager
    def counted(label):
        """Count dense-kernel launches from 0 and pallas dispatches around a
        step; fail unless they are equal."""
        K.fdp_gemm.launches = 0
        with pallas_dispatches(D) as executed:
            yield
        torch.cuda.synchronize()
        if K.fdp_gemm.launches != executed[0]:
            fail(f"{label}: dense kernel launches {K.fdp_gemm.launches} != pallas "
                 f"dispatches {executed[0]}")
        launches[label] = K.fdp_gemm.launches
        launches["total"] += K.fdp_gemm.launches

    # (a) the zoo at full width against four policies
    ctx = WorkloadContext.for_model(cfg, budget_bits=TAILOR_BUDGET, seed=0, device=dev)
    before = {k: p.detach().clone() for k, p in ctx.params.named_parameters()}
    validators = build_validators(["grad", "logits", "repro", "solve", "quant_opt"], ctx)
    policies = {"fdp91_kernel": FDP91_KERNEL, "mxu_fp32": D.MXU_FP32,
                "zoo plan": zoo_policy, "searched plan": searched_policy}
    zoo_runs = {}
    for pname, policy in policies.items():
        for v in validators:
            if v.name == "quant_opt" and pname != "zoo plan":
                continue        # the one plan with quantized moments (the others read 24.0)
            t = time.perf_counter()
            with counted(f"{v.name} under {pname}"):
                rep = v.run(policy)
            dt = time.perf_counter() - t
            zoo_runs[f"{v.name} under {pname}"] = {"score": rep.score, "passed": rep.passed,
                                                   "s": dt, "launches": K.fdp_gemm.launches}
            log(f"  {pname:14s} {rep.describe()}  {dt:.3f} s, {K.fdp_gemm.launches} "
                f"launches == pallas dispatches"
                + (f"; worst leaves {worst_leaves(rep)}" if v.name == "grad" else ""))
            if any(not torch.equal(p, before[k]) for k, p in ctx.params.named_parameters()):
                fail(f"{v.name} under {pname} changed the context's parameters")
            if pname == "fdp91_kernel" and v.name in ("grad", "logits") and rep.score != 24.0:
                fail(f"{v.name} under {FDP91_KERNEL.name} reads {rep.score}, not 24.0 "
                     f"(the oracle against itself)")
            if v.name == "repro" and pname == "searched plan":
                saturating = sorted(s for s in rep.site_attribution
                                    if searched_policy.lookup(s).mode == "pallas"
                                    and searched_policy.lookup(s).acc.overflow_mode != "wrap")
                off = {s: b for s, b in rep.site_attribution.items()
                       if s not in saturating and searched_policy.lookup(s).mode == "pallas"
                       and b != 53.0}
                if off:
                    fail(f"repro under the searched plan: wrapping pallas sites not "
                         f"bit-stable under reordering: {off}")
                log(f"  repro: {len(rep.site_attribution) - len(saturating)} wrapping pallas "
                    f"sites at 53.0 bits; saturating picks: {saturating or 'none'}")
            if v.name == "quant_opt" and pname == "zoo plan":
                curve, formats = rep.details["loss_curve"], rep.details["state_formats"]
                if {formats.get(k) for k in ("opt.m@state", "opt.v@state")} != {"q8b64"} \
                        or not all(math.isfinite(x) for x in curve):
                    fail(f"quant_opt under the zoo plan: formats "
                         f"{rep.details['state_formats']}, curve {curve}")
    log(f"(a) the zoo at full width ({cfg.n_layers} layers, weights from seed 0, "
        f"{TAILOR_BUDGET}-bit thresholds): grad and logits 24.0 under "
        f"{FDP91_KERNEL.name}; the context's parameters unchanged after every run")

    # (b) the validated search: the workloads drive the upgrades, with no cap
    # short of the frontiers' own (every site at its last point)
    zoo_validators = build_validators(DEFAULT_VALIDATORS, ctx)
    rounds = []
    for v in zoo_validators:
        def unchecked(policy, _run=v.run, _name=v.name):
            validating[0] = True
            try:
                rep = _run(policy)
            finally:
                validating[0] = False
            rounds.append((_name, rep.score))
            return rep
        v.run = unchecked
    max_upgrades = sum(len(d.frontier) - 1 - d.chosen for d in first_search.decisions.values())
    with counted("validated search"):
        res, _, search_s = card_search("pallas, validators " + ",".join(DEFAULT_VALIDATORS),
                                       validators=zoo_validators, fdp_mode="pallas",
                                       max_upgrades=max_upgrades, **fdp_grid)
    reports, upgrades = res.reports, res.plan.meta["validation_upgrades"]
    n_rounds = len(rounds) // len(zoo_validators)
    log(f"(b) validated search in {search_s:.3f} s, {n_rounds} "
        f"rounds, {len(upgrades)} upgrades (at most {max_upgrades}): "
        f"{', '.join(upgrades) or 'none'}")
    for name in sorted(reports):
        log("  workload " + reports[name].describe()
            + (f"; worst leaves {worst_leaves(reports[name])}" if name == "grad" else ""))
    log("  scores by round: " + "; ".join(
        f"{v.name} " + " ".join(f"{b:.2f}" for n, b in rounds if n == v.name)
        for v in zoo_validators))
    left = [(v.name, d.site) for v in zoo_validators if not reports[v.name].passed
            for d in res.decisions.values()
            if d.can_upgrade() and v.eligible_site(d.site, reports[v.name])]
    if all(r.passed for r in reports.values()):
        stop = "every report passed"
    elif not left:
        stop = "nothing left to widen"
    elif len(upgrades) >= max_upgrades:
        stop = "max_upgrades"
    else:
        fail(f"the validated search stopped with failing reports and sites to widen {left}")
    log(f"  the loop stopped: {stop}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "qwen3_0p6b.validated.json")
        res.plan.save(path)
        reloaded = load_plan(path)
    with counted("reloaded plan's evidence"):
        for v in zoo_validators:
            again = v.run(reloaded.to_policy()).to_json()
            if again != reloaded.meta["validation"][v.name]:
                fail(f"{v.name} on the reloaded plan: {again} != recorded "
                     f"{reloaded.meta['validation'][v.name]}")
    legacy = {s.site: s.cfg.tag() for s in legacy_plan.sites}
    picks = {s.site: s.cfg.tag() for s in res.plan.sites}
    log(f"  saved, loaded back, the recorded evidence reproduced; forward picks "
        f"(validators | phase 16's validate=):")
    for site in sorted(s for s in picks if "@" not in s):
        log(f"    {site:10s} {picks[site]:34s} {legacy[site]}")
    bwd_moved = sorted(s for s in upgrades if "@bwd" in s)

    # (c) the FDP references in pallas and in simulate give the same reports
    ctx2 = WorkloadContext.for_model(cfg2, budget_bits=TAILOR_BUDGET, seed=0, device=dev)
    twin = {}
    for mode in ("pallas", "simulate"):
        t = time.perf_counter()
        with counted(f"2-layer references in {mode}"):
            twin[mode] = [cls(cfg2, ctx2.params, batch, device=dev, fdp_mode=mode,
                              threshold=TAILOR_BUDGET).run(searched_policy).to_json()
                          for cls, batch in ((LossGradient, ctx2.grad_batch),
                                             (LogitFidelity, ctx2.batch))]
        log(f"(c) 2-layer grad and logits with their FDP91 references in {mode}: "
            f"{time.perf_counter() - t:.3f} s")
    if twin["pallas"] != twin["simulate"]:
        fail(f"2-layer reports differ between pallas and simulate references: {twin}")
    log(f"  equal, score for score and leaf for leaf: grad {twin['pallas'][0]['score']:.3f}, "
        f"logits {twin['pallas'][1]['score']:.3f}")
    del ctx2

    # (d) Fig. 2 on the card: fp64 FMA, double-double, 91-bit FDP (53-bit read-out)
    spec = AccumulatorSpec.paper_91bit()
    fig2 = {}
    for n in FIG2_NS:
        row = {"fp64_fma": [], "dd": [], "fdp91": [], "s": {"fp64_fma": 0.0, "dd": 0.0,
                                                           "fdp91": 0.0}}
        for trial in range(FIG2_TRIALS):
            a, b, _ = gen_dot(n, FIG2_COND, seed=17 * trial + 1)
            a, b = (np.asarray(np.rint(x.astype(np.float64) * 4096) / 4096, np.float32)
                    for x in (a, b))
            exact = float(metrics.exact_dot_fraction(a, b))
            if exact == 0.0:
                continue
            ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
            for key, fn in (("fp64_fma", lambda: fma_dot(ta, tb, torch.float64)),
                            ("dd", lambda: dd_dot(ta, tb, torch.float64)),
                            ("fdp91", lambda: fdp_dot64(ta, tb, spec))):
                torch.cuda.synchronize()
                t = time.perf_counter()
                v = float(fn())
                row["s"][key] += time.perf_counter() - t
                row[key].append(float(metrics.correct_bits(v, exact)))
        if any(bits != 53.0 for bits in row["fdp91"]) or not row["fdp91"]:
            fail(f"Fig. 2, n={n}: FDP91 correct bits {row['fdp91']}, not 53 in every trial")
        fig2[n] = row
        log(f"(d) Fig. 2 n={n}: correct bits fp64 FMA "
            f"{', '.join(f'{x:.2f}' for x in row['fp64_fma'])}; double-double "
            f"{', '.join(f'{x:.2f}' for x in row['dd'])}; FDP91 "
            f"{', '.join(f'{x:.2f}' for x in row['fdp91'])}; seconds "
            + ", ".join(f"{k} {s:.3f}" for k, s in row["s"].items()))

    # (e) the plan zoo's evidence: the reference's CLI drift gate on paper-mlp
    out = io.StringIO()
    t = time.perf_counter()
    with counted("paper-mlp CLI"), contextlib.redirect_stdout(out):
        try:
            workloads_cli.main(["--plan", os.path.join(ROOT, "examples", "plans",
                                                       "paper_mlp.json"),
                                "--tolerance", "2", "--device", str(dev)])
        except SystemExit as e:
            fail(f"python -m repro_torch.workloads --plan paper_mlp.json --tolerance 2 "
                 f"exited {e.code}:\n{out.getvalue()}")
    cli_s = time.perf_counter() - t
    drift = {}
    for line in out.getvalue().splitlines():
        log("  " + line.strip())
        name = line.split()[0] if line.startswith("  ") else None
        if name in REFERENCE_CLI_DRIFT and "drift" in line:
            drift[name] = float(line.rsplit("drift ", 1)[1].rstrip("]"))
    log(f"(e) paper-mlp CLI in {cli_s:.3f} s, inside --tolerance 2: drift "
        + ", ".join(f"{k} {v:.2f} (JAX package on the CPU, seed 0: {REFERENCE_CLI_DRIFT[k]})"
                    for k, v in drift.items()))
    del ctx, before, validators, zoo_validators
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t17
    log(f"Phase 17 took {phase_s:.2f} s; dense kernel launches {launches['total']}")
    return {"zoo": zoo_runs,
            "validated_search": {"s": search_s, "upgrades": upgrades, "stop": stop,
                                 "max_upgrades": max_upgrades,
                                 "rounds": n_rounds,
                                 "bwd_upgrades": bwd_moved,
                                 "reports": validation_summary(res.plan.meta),
                                 "picks": picks, "legacy_picks": legacy,
                                 "energy_vs_baseline": res.plan.meta["energy_vs_baseline"]},
            "twin_2layer": {m: [r["score"] for r in reps] for m, reps in twin.items()},
            "fig2": fig2, "cli_drift": drift, "cli_s": cli_s,
            "launches": launches, "phase_s": phase_s}


def traced_steps(torch, eng, make_requests, steps: int):
    """``steps`` steps of the engine ``eng`` over ``make_requests()`` under
    torch.profiler, after one untraced step inside the same session (a
    schedule's warm-up window: the first kernels of a trace can go missing
    while the profiler starts), then the run finished and the cache reset.
    Returns the window's FDP kernel events by kernel, device busy seconds
    (union of its device events), span (first to last event) and idle
    share; None when the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for r in make_requests():
        eng.submit(r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        eng.step()
        prof.step()
        for _ in range(steps):
            if not eng.step():
                fail(f"the engine drained before {steps} traced steps")
        prof.step()
    eng.run()
    eng.reset_cache()
    timeline = device_timeline(prof)
    if timeline is None:
        return None
    dev_events, busy_us, span_us = timeline
    by_name: dict = {}
    for name, start, end in dev_events:
        n, ns = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, ns + end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"steps": steps, "device_events": len(dev_events), "span_s": span_us / 1e6,
            "device_busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / span_us,
            "kernels": {label: sum(symbol in name for name, _, _ in dev_events)
                        for label, symbol in TRACE_NAMES.items()},
            "top": [(name[:70], n, ns / 1e9) for name, (n, ns) in top]}


_HOST_WEIGHTS: dict = {}


def weights(torch, cfg, dev):
    """The parameters of ``cfg`` from seed 0 on ``dev``. The first call for
    a config runs ``init(cfg, 0, dev)``, prints its seconds, and keeps a host
    copy; a later call copies that copy back to the card instead of drawing
    again (the same weights: ``init`` draws every tensor on the host
    whatever the device). A config that is a kept one cut to fewer layers
    takes the kept one's first layers: ``init`` draws the embedding and the
    head, then layer after layer, so those are the cut model's own draws
    (the init check in phase 3 holds a reduced config to this)."""
    from repro_torch.models import init
    from repro_torch.models.transformer import Transformer
    t = time.perf_counter()
    host = _HOST_WEIGHTS.get(cfg)
    deeper = [c for c in _HOST_WEIGHTS if c.n_layers > cfg.n_layers
              and dataclasses.replace(c, n_layers=cfg.n_layers) == cfg]
    if host is None and deeper:
        host = _HOST_WEIGHTS[deeper[0]]
    if host is None:
        params = init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.parameters())
        log(f"init {cfg.name} at {cfg.n_layers} layers, full width: {n / 1e9:.3f} G f32 "
            f"parameters = {4 * n / 1e9:.2f} GB drawn in {time.perf_counter() - t:.2f} s")
        _HOST_WEIGHTS[cfg] = {k: p.detach().cpu() for k, p in params.named_parameters()}
        return params
    params = Transformer(cfg, None, getattr(torch, cfg.param_dtype), dev)
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(host[k])
    torch.cuda.synchronize()
    log(f"{cfg.name} at {cfg.n_layers} layers: the seed-0 weights copied back to the card "
        f"in {time.perf_counter() - t:.2f} s"
        + (f" (the first layers of the kept {deeper[0].n_layers}-layer draw)"
           if deeper and cfg not in _HOST_WEIGHTS else ""))
    return params


def drop_weights(cfg) -> None:
    _HOST_WEIGHTS.pop(cfg, None)


def engine_phase(torch, dev, cfg, params, make_requests, *, n_slots: int, max_len: int,
                 policy, label: str) -> dict:
    """Phase 18 on one model: a graph engine and its eager twin
    (``graph=False``), each built once under ``policy`` and driven
    ``SERVE_RUNS`` times over ``make_requests()`` (``reset_cache`` between
    runs), then once more with ``TRACED_STEPS`` of its steps under
    torch.profiler (kernel events, busy time and idle share of those steps:
    a whole run traces too many events to read back in the script's time).
    Every kernel count is set to 0 just before each engine is built and
    read just after its first run. The wrappers count what ran (the graph
    engine's two eager warm-up steps, the eager twin's run) in
    ``launches`` and what the capture recorded in ``captured``; a replay
    goes through no wrapper, so the replays' launches are the profiler's
    kernel events. Checks one capture; a step's captured launches equal to
    its FDP dispatches at capture (the dense kernel: every site but the
    experts'); the graph engine's counts equal to two warm-up steps and one
    captured step, with no dispatch in its runs; the eager twin's equal to
    its dispatches; the traced replays' kernel events equal to the
    captured step's launches a step; equal tokens across engines and runs.
    Returns the numbers, the tokens and the count of engine runs (each
    records one ``serving.batcher_run`` span)."""
    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.batching import ContinuousBatcher
    ragged_sites = {"moe_in", "moe_gate", "moe_out"}
    res, tokens, n_runs = {}, {}, 0
    for graph in (True, False):
        name = "graph" if graph else "eager"
        D.reset_sites_seen()
        for w in K.KERNELS.values():
            w.launches = w.captured = 0
        t = time.perf_counter()
        eng = ContinuousBatcher(cfg, params, n_slots=n_slots, max_len=max_len,
                                warmup=policy, graph=graph)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        if graph:
            if eng.capture_count != 1:
                fail(f"{label}: {eng.capture_count} captures at warmup, not 1")
            per_step = eng.step_launches
            dense = sum(n for s, n in eng.step_dispatches.items() if s not in ragged_sites)
            ragged = sum(n for s, n in eng.step_dispatches.items() if s in ragged_sites)
            want = {"fdp_gemm": dense, **({"fdp_ragged_gemm": ragged} if ragged else {})}
            if per_step != want:
                fail(f"{label}: launches a step at capture {per_step} != FDP dispatches "
                     f"a step {want}")
        secs, outs, n_tok = [], [], 0

        def run_once():
            reqs = make_requests()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not all(r.done for r in reqs):
                fail(f"{label}: a request did not finish")
            eng.reset_cache()
            return [r.out for r in reqs], wall

        for i in range(SERVE_RUNS):
            out, wall = run_once()
            if i == 0:
                counts = {n: w.launches for n, w in K.KERNELS.items() if w.launches}
                captured = {n: w.captured for n, w in K.KERNELS.items() if w.captured}
                calls = D.site_calls()
                if graph:
                    replayed = eng.replays
                    made = {n: 2 * k for n, k in per_step.items()}
                    if (counts != made or captured != per_step
                            or sum(calls.values()) != 3 * sum(eng.step_dispatches.values())):
                        fail(f"{label}: the graph engine's build and first run counted "
                             f"launches {counts} (two warm-up steps: {made}), captured "
                             f"{captured} (a step: {per_step}) and {sum(calls.values())} "
                             f"dispatches (three steps': "
                             f"{3 * sum(eng.step_dispatches.values())})")
                else:
                    dense = sum(n for s, n in calls.items() if s not in ragged_sites)
                    ragged = sum(n for s, n in calls.items() if s in ragged_sites)
                    made = {"fdp_gemm": dense, **({"fdp_ragged_gemm": ragged} if ragged
                                                  else {})}
                    if counts != made or captured:
                        fail(f"{label}: the eager engine's launches {counts} != its FDP "
                             f"dispatches {made}, or it captured {captured}")
                first_counts = counts
            secs.append(wall)
            outs.append(out)
            n_tok = sum(len(o) for o in out)
        if any(o != outs[0] for o in outs):
            fail(f"{label}: the {name} engine's tokens differ between runs")
        trace = traced_steps(torch, eng, make_requests, TRACED_STEPS)
        n_runs += SERVE_RUNS + 1
        if trace is None:
            log(f"{label}: torch.profiler recorded no device events in the {name} engine's "
                f"traced steps: their kernel events and idle share are not measured")
        elif graph:
            stepped = {n: trace["kernels"][n] for n in per_step}
            if stepped != {n: k * TRACED_STEPS for n, k in per_step.items()}:
                fail(f"{label}: {TRACED_STEPS} traced replays hold kernel events {stepped}, "
                     f"not {per_step} a step")
            log(f"{label}: {TRACED_STEPS} replayed steps under torch.profiler hold "
                f"{stepped} kernel events = {per_step} a step")
        med = sorted(secs)[len(secs) // 2]
        tokens[name] = outs[0]
        res[name] = {"build_s": build_s, "serve_s": secs, "tokens": n_tok,
                     "tok_s": n_tok / med, "launches_built_and_first_run": first_counts,
                     **({"replays_first_run": replayed} if graph else {}),
                     "capture_count": eng.capture_count,
                     "step_launches": dict(eng.step_launches),
                     "step_dispatches": sum(eng.step_dispatches.values()),
                     "traced_steps": trace}
        idle = ("not measured (the profiler recorded no device events)" if trace is None
                else f"{100 * trace['idle_share']:.1f}% over {TRACED_STEPS} steps")
        log(f"{label}, {name} engine ({n_slots} slots, max_len {max_len}, {cfg.n_layers} "
            f"layers): built in {build_s:.2f} s; {SERVE_RUNS} runs of {n_tok} generated "
            f"tokens: {', '.join(f'{x:.3f}' for x in secs)} s; median {med:.3f} s = "
            f"{n_tok / med:.2f} tok/s; "
            + (f"launches counted by the wrappers over the build and the first run "
               f"{first_counts} (two warm-up steps), captured {per_step} a step, "
               f"{replayed} replays in the first run (through no wrapper); captures "
               f"{eng.capture_count}" if graph
               else f"first run's launches {first_counts}")
            + f"; traced idle share {idle}")
        if trace is not None:
            log(f"  traced {name} steps: span {trace['span_s']:.4f} s, device busy "
                f"{trace['device_busy_s']:.4f} s, {trace['device_events']} device events, "
                f"FDP kernel events {trace['kernels']}")
        del eng
    if tokens["graph"] != tokens["eager"]:
        fail(f"{label}: graph tokens != eager tokens")
    log(f"{label}: graph engine tokens == eager engine tokens for every request")
    return {"result": res, "tokens": tokens["graph"], "runs": n_runs}


def routed_phase(torch, dev, cfg, params, phase3_tokens, searched, searched_policy, zoo_runs,
                 graph_tok_s) -> dict:
    """Phase 19: the routed serving tier at full width (the module docstring
    lists its steps). ``phase3_tokens`` are phase 3's tokens under
    FDP91_KERNEL, ``searched`` and ``searched_policy`` phase 16's plan,
    ``zoo_runs`` phase 17's workload reports, ``graph_tok_s`` phase 18's
    graph engine. Every kernel count is set to 0 just before the routed
    trace and read just after it. Returns the phase's numbers."""
    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.batching import CacheExhausted, ContinuousBatcher, Request
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import forward
    from repro_torch.obs import recorder
    from repro_torch.serving import (FDP_CAP_BITS, BucketedEnginePool, PlanRouter,
                                     RoutedFrontend, RoutedPlan, ServeRequest,
                                     parse_buckets, routed_plan_from_entry)

    t19 = time.perf_counter()
    part_s = {}
    tmpdir = tempfile.TemporaryDirectory(prefix="phase19_")
    tmp = tmpdir.name
    plans_dir = os.path.join(ROOT, "examples", "plans")

    # -- (a) the routed tier -------------------------------------------------
    t = time.perf_counter()
    searched.save(os.path.join(tmp, "searched.json"))
    validation = {w: {k: zoo_runs[f"{w} under searched plan"][k] for k in ("score", "passed")}
                  for w in ("grad", "logits", "repro", "solve")}
    searched_rp = routed_plan_from_entry("searched", {
        "arch": cfg.name, "file": "searched.json", "validation": validation,
        "energy_vs_baseline": searched.meta["energy_vs_baseline"],
        "validated_bits": searched.meta.get("validated_bits")}, tmp)
    # the evidence the reference's derived <name>/fdp91 variant records
    kernel_rp = RoutedPlan(
        name="fdp91_kernel", arch=cfg.name,
        scores={w: FDP_CAP_BITS for w in ("solve", "repro", "logits")},
        passed={w: True for w in ("solve", "repro", "logits")}, energy=1.0,
        validated_bits=FDP_CAP_BITS, repro_certified=True, loader=lambda: FDP91_KERNEL)
    zoo = PlanRouter.from_manifest(plans_dir, arch=cfg.name, derive=False).plans
    router = PlanRouter([*zoo, kernel_rp, searched_rp])
    routes = {wl: router.route(wl).name for wl in ("chat", "solve", "repro")}
    log("(a) routable plans: " + "; ".join(
        f"{p.name} (energy {p.energy:.4f}, validated {p.validated_bits}, scores "
        + ", ".join(f"{w} {s:.2f}" for w, s in sorted(p.scores.items()))
        + f", certified {p.repro_certified})" for p in router.plans))
    log("    routes: " + ", ".join(f"{wl} -> {name}" for wl, name in routes.items()))

    g = torch.Generator().manual_seed(1)
    first = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g).tolist()

    def draw(kind):
        n = int(torch.randint(*ROUTED_LENGTHS[kind], (1,), generator=g))
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    streamed: list = []
    trace = [ServeRequest(uid=i, prompt=p, max_new=GEN, workload="fdp91_kernel")
             for i, p in enumerate(first)]
    for workload, method, kind, extra, _ in ROUTED_TRACE:
        uid = len(trace)
        if kind == "too_long":            # past the largest bucket's capacity
            prompt = torch.randint(0, cfg.vocab_size, (96,), generator=g).tolist()
        else:
            prompt = draw(kind)
        max_new = 0 if method == "score" else int(torch.randint(8, GEN + 1, (1,), generator=g))
        trace.append(ServeRequest(uid=uid, prompt=prompt, max_new=max_new, workload=workload,
                                  method=method, on_token=streamed.append
                                  if method == "stream" else None, **extra))
    if len(trace) != 16:
        fail(f"the routed trace holds {len(trace)} requests, not 16")

    # every engine the pool builds, in build order: its key, its numbers at
    # capture and a weak reference (an evicted engine must be freed)
    built: list = []
    pool = BucketedEnginePool(cfg, params, ROUTED_BUCKETS, max_live=ROUTED_ENGINES)
    pool_get = pool.get

    def recording_get(plan, bucket, method):
        before = pool.live().get((plan.name, bucket, method))
        eng = pool_get(plan, bucket, method)
        if eng is not before:
            built.append(((plan.name, bucket.label, method), eng.capture_count,
                          dict(eng.step_launches), dict(eng.step_dispatches),
                          weakref.ref(eng)))
        return eng
    pool.get = recording_get
    front = RoutedFrontend(pool, router, max_live_batches=ROUTED_LIVE)
    recorder().clear()
    gc.collect()                          # earlier phases' garbage out of the baseline
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    D.reset_sites_seen()
    for w in K.KERNELS.values():
        w.launches = w.captured = 0
    comps = [front.submit(r) for r in trace]
    t1 = time.perf_counter()
    front.run()
    torch.cuda.synchronize()
    wave1_s = time.perf_counter() - t1
    wave1_built = len(built)
    wave1_capture_s = sum(e["dur_us"] for e in recorder().events()
                          if e["name"] == "serving.aot_compile") / 1e6
    gc.collect()
    evicted = [b[0] for b in built if b[4]() is None]       # built, then freed
    # a second wave: phase 3's prompts again to fdp91_kernel, whose engine
    # the LRU cap has evicted by now, so it is captured again
    wave2 = [front.submit(ServeRequest(uid=100 + i, prompt=p, max_new=GEN,
                                       workload="fdp91_kernel"))
             for i, p in enumerate(first)]
    t1 = time.perf_counter()
    front.run()
    torch.cuda.synchronize()
    wave2_s = time.perf_counter() - t1
    launched = {n: w.launches for n, w in K.KERNELS.items() if w.launches}
    captured = {n: w.captured for n, w in K.KERNELS.items() if w.captured}
    mem_peak = torch.cuda.max_memory_allocated(dev)
    mem_after = torch.cuda.memory_allocated(dev)
    m = front.metrics()
    pool_stats = pool.stats()
    stats = front.stats()
    capture_s = [(f"{e['args']['plan']} {e['args']['bucket']} {e['args']['method']}",
                  e["dur_us"] / 1e6) for e in recorder().events()
                 if e["name"] == "serving.aot_compile"]

    # checks
    by_uid = {c.request.uid: c for c in comps}
    rejected = {uid: type(c.error).__name__ for uid, c in by_uid.items() if not c.ok}
    want_rejected = {BATCH + i: spec[4] for i, spec in enumerate(ROUTED_TRACE) if spec[4]}
    if rejected != want_rejected:
        fail(f"rejections {rejected} != {want_rejected}")
    if not all(c.ok for c in wave2):
        fail("a second-wave request did not complete")
    for reqs in (comps[:BATCH], wave2):
        if [c.tokens for c in reqs] != phase3_tokens:
            fail("the requests sent to fdp91_kernel != phase 3's tokens")
    stream_uid = next(r.uid for r in trace if r.method == "stream")
    if streamed != by_uid[stream_uid].tokens:
        fail("the stream != its request's tokens")
    if m["submitted"] != m["routed"] + m["parked"] + m["rejected"] or m["parked"] \
            or m["completed"] != m["routed"] or m["submitted"] != len(trace) + len(wave2):
        fail(f"metrics() breaks its closed sum: {m}")
    keys = {b[0] for b in built}
    wave2_key = ("fdp91_kernel", "4x40", "generate")
    if pool_stats["evictions"] < 1 or wave2_key not in evicted or \
            wave2_key not in [b[0] for b in built[wave1_built:]]:
        fail(f"no eviction and recapture: {pool_stats}, freed in wave 1 {evicted}, built "
             f"{[b[0] for b in built]}")
    if pool_stats["compiles"] != len(built) or \
            len(evicted) < len(built[:wave1_built]) - ROUTED_ENGINES:
        fail(f"the pool built {len(built)} engines, counted {pool_stats['compiles']}; "
             f"only {evicted} were freed in wave 1")
    per_engine = {}
    for key, captures, step_launches, step_dispatches, ref in built:
        pol = router[key[0]].policy()
        fdp = sum(n for s, n in step_dispatches.items() if pol.lookup(s).mode == "pallas")
        launches_step = step_launches.get("fdp_gemm", 0)
        resident = ref()
        if captures != 1 or (resident is not None and resident.capture_count != 1) \
                or launches_step != fdp or set(step_launches) - {"fdp_gemm"}:
            fail(f"engine {key}: captures {captures}, dense launches a step at capture "
                 f"{step_launches} != its {fdp} FDP dispatches")
        per_engine[" ".join(key)] = {"launches_a_step": launches_step,
                                     "dispatches_a_step": sum(step_dispatches.values())}
        del resident
    chat_key = next(k for k in keys if k[0] == routes["chat"])
    if router[routes["chat"]].policy().default.mode == "native" and \
            per_engine[" ".join(chat_key)]["launches_a_step"]:
        fail(f"the chat engine {chat_key} captured dense launches")
    want_captured = sum(b[2].get("fdp_gemm", 0) for b in built)
    want_launches = 2 * want_captured
    if launched.get("fdp_gemm", 0) != want_launches or \
            captured.get("fdp_gemm", 0) != want_captured or set(launched) - {"fdp_gemm"}:
        fail(f"the routed run's wrapper counts: launched {launched} (two warm-up calls a "
             f"capture: {want_launches}), captured {captured} (one a capture: "
             f"{want_captured})")
    # the replays' kernel events, profiled over a window of the recaptured engine
    k_eng = pool.live().get(("fdp91_kernel", parse_buckets("4x40")[0], "generate"))
    k_eng.batcher.reset_cache()           # the frontend recycles on the next admission
    replays = traced_steps(torch, k_eng.batcher, lambda: [
        Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(first)], TRACED_STEPS)
    if replays is not None and replays["kernels"]["fdp_gemm"] != \
            TRACED_STEPS * k_eng.step_launches["fdp_gemm"]:
        fail(f"{TRACED_STEPS} profiled replays of fdp91_kernel hold "
             f"{replays['kernels']['fdp_gemm']} dense kernel events, not "
             f"{k_eng.step_launches['fdp_gemm']} a step")
    decode = sum(c.decode_tokens for c in comps if c.ok)
    served = {c.request.uid: {"plan": c.plan, "bucket": c.bucket, "tokens": c.tokens,
                              "score": c.score} for c in comps if c.ok}
    # a rejected request's error holds its traceback, whose frames hold the
    # pool: the completions go with the pool
    del front, pool, pool_get, recording_get, k_eng, wave2, comps, by_uid
    gc.collect()
    torch.cuda.synchronize()
    mem_freed = torch.cuda.memory_allocated(dev)
    alive = [b[0] for b in built if b[4]() is not None]
    if alive:
        fail(f"engines still alive after the pool was dropped: {alive}")
    # every other generated request == a dedicated graph engine of its plan
    # at its bucket, fed its group in order (recycled as the frontend does)
    dedicated = {}
    groups: dict = {}
    for r in trace[BATCH:]:
        c = served.get(r.uid)
        if c is not None and r.method != "score":
            groups.setdefault((c["plan"], c["bucket"]), []).append(r)
    for (plan_name, label), reqs in groups.items():
        bucket = parse_buckets(label)[0]
        eng = ContinuousBatcher(cfg, params, n_slots=bucket.n_slots, max_len=bucket.max_len,
                                warmup=router[plan_name].policy())
        raws = [Request(uid=r.uid, prompt=list(r.prompt), max_new=r.max_new) for r in reqs]
        for raw in raws:
            eng.submit(raw)
        while True:
            try:
                eng.run()
                break
            except CacheExhausted:             # recycle, as the frontend does
                eng.reset_cache()
        for raw in raws:
            if served[raw.uid]["tokens"] != raw.out:
                fail(f"routed request {raw.uid} ({plan_name}, {label}) != its dedicated "
                     f"graph engine's tokens")
        dedicated[f"{plan_name} {label}"] = [raw.uid for raw in raws]
        del eng
    # the score against an eager forward under its routed policy
    score_req = next(r for r in trace if r.method == "score")
    sc = served[score_req.uid]
    bucket = parse_buckets(sc["bucket"])[0]
    toks = torch.zeros((bucket.n_slots, bucket.max_len), dtype=torch.int64)
    toks[0, :len(score_req.prompt)] = torch.tensor(score_req.prompt)
    with torch.no_grad(), D.use_policy(router[sc["plan"]].policy()):
        logits = forward(params, cfg, {"tokens": toks.to(dev)}, remat="none")
    logp = torch.log_softmax(logits[0, :, :cfg.vocab_size].double(), -1)
    n = len(score_req.prompt)
    want = float(logp[torch.arange(n - 1), torch.tensor(score_req.prompt[1:])].sum())
    del logits, logp
    score = sc["score"]
    if not math.isfinite(score) or abs(score - want) > ROUTED_SCORE_RTOL * abs(want):
        fail(f"score {score} != eager forward's {want} within {ROUTED_SCORE_RTOL}")
    part_s["a"] = time.perf_counter() - t
    log(f"(a) {len(trace)} requests ({len(rejected)} rejected: {rejected}), then phase 3's 4 "
        f"prompts again: all others completed; fdp91_kernel's tokens == phase 3's in both "
        f"waves; {sum(len(v) for v in dedicated.values())} other generated requests == "
        f"dedicated graph engines {dedicated}; the stream == its tokens; score "
        f"{score:.6f} == eager forward's {want:.6f} (rel {ROUTED_SCORE_RTOL}); every "
        f"engine captured once; metrics {m}")
    log(f"    engines, a step's dense launches and dispatches at capture: {per_engine}; "
        f"evicted and freed in wave 1: {evicted}")
    log(f"    wrappers over both waves: launched {launched} (the captures' warm-up calls), "
        f"captured {captured}; profiled replays: "
        + ("not measured (no device events)" if replays is None else
           f"{replays['kernels']['fdp_gemm']} dense kernel events in {TRACED_STEPS} replays, "
           f"idle {100 * replays['idle_share']:.1f}%"))
    log(f"    wave 1: {decode} decode tokens in {wave1_s:.3f} s = {decode / wave1_s:.2f} tok/s "
        f"({decode / (wave1_s - wave1_capture_s):.2f} without its captures' "
        f"{wave1_capture_s:.3f} s); wave 2 {wave2_s:.3f} s; phase 18's graph engine "
        f"{graph_tok_s:.2f} tok/s (this run)")
    log("    captures (s): " + ", ".join(f"{k} {v:.3f}" for k, v in capture_s))
    log(f"    pool: {pool_stats}")
    log(f"    classes: " + json.dumps({wl: {k: v for k, v in st.items() if k != 'tokens_per_s'}
                                      for wl, st in stats["classes"].items()}, sort_keys=True))
    log(f"    torch.cuda.memory_allocated: before {mem_before / 1e9:.3f} GB, peak "
        f"{mem_peak / 1e9:.3f} GB, after the run {mem_after / 1e9:.3f} GB (engines resident), "
        f"after the pool is dropped {mem_freed / 1e9:.3f} GB (every engine freed)")
    routed = {"routes": routes, "rejected": rejected, "metrics": m, "pool": pool_stats,
              "wave1_s": wave1_s, "wave2_s": wave2_s, "decode_tokens": decode,
              "tok_s": decode / wave1_s,
              "tok_s_without_captures": decode / (wave1_s - wave1_capture_s),
              "capture_s": capture_s,
              "graph_engine_tok_s": graph_tok_s, "engines": per_engine,
              "freed_in_wave1": [" ".join(k) for k in evicted], "launched": launched,
              "captured": captured, "replays_traced": replays, "score": score,
              "score_eager": want, "memory_gb": {
                  "before": mem_before / 1e9, "peak": mem_peak / 1e9,
                  "after": mem_after / 1e9, "pool_dropped": mem_freed / 1e9}}

    # -- (b) the monitor inside the captured graph -----------------------------
    t = time.perf_counter()
    monitor = monitor_part(torch, dev, cfg, params, first, searched, searched_policy)
    part_s["b"] = time.perf_counter() - t

    # -- (c) the CLI ------------------------------------------------------------
    t = time.perf_counter()
    dump, trace_out = os.path.join(tmp, "dump.json"), os.path.join(tmp, "trace.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving", "--arch", "paper-mlp",
         "--requests", "3", "--max-new", "3", "--require-complete", "--plans", plans_dir,
         "--metrics-dump", dump, "--inject-violation", "attn_qk", "--trace-out", trace_out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"python -m repro_torch.serving exited {proc.returncode}:\n{proc.stdout}\n"
             f"{proc.stderr[-4000:]}")
    # the CLI preloads the checked-in cuda zoo and prints how many schedules
    from repro_torch.core import schedules as S
    n_zoo = len(S.ScheduleZoo.load(S.zoo_path(backend="cuda")).entries)
    if f"  plans: {n_zoo} preloaded from zoo;" not in proc.stdout:
        fail(f"python -m repro_torch.serving did not print {n_zoo} schedules preloaded:\n"
             f"{proc.stdout}")
    with open(dump) as fh:
        doc = json.load(fh)
    with open(trace_out) as fh:
        n_events = len(json.load(fh)["traceEvents"])
    sm = doc["serving"]
    graphs = re.search(r"engines captured with the monitor's reductions inside \((\d+) CUDA "
                       r"graphs resident", proc.stdout)
    if graphs is None or int(graphs.group(1)) < 1:
        fail(f"python -m repro_torch.serving under the monitor captured no graph:\n"
             f"{proc.stdout}")
    if doc["kind"] != "repro.obs.ServingMetricsDump" or \
            sm["submitted"] != sm["routed"] + sm["parked"] + sm["rejected"] or \
            doc["monitor"]["sites"]["attn_qk"]["status"] != "violated" or not n_events:
        fail(f"the CLI's dump or trace: kind {doc['kind']}, serving {sm}, attn_qk "
             f"{doc['monitor']['sites']['attn_qk']['status']}, {n_events} trace events")
    part_s["c"] = time.perf_counter() - t
    log(f"(c) python -m repro_torch.serving --arch paper-mlp --requests 3 --max-new 3 "
        f"--require-complete --metrics-dump --inject-violation attn_qk --trace-out, a "
        f"subprocess ({graphs.group(1)} graph engines captured under the monitor: a chat "
        f"request, a solve stream and "
        f"a repro score, the last two on the derived simulate variants): rc 0, dump kind "
        f"{doc['kind']}, serving {sm}, attn_qk violated, {n_events} trace events, "
        f"{n_zoo} schedules preloaded from the cuda zoo:")
    for line in proc.stdout.splitlines():
        log("    " + line)
    tmpdir.cleanup()
    phase_s = time.perf_counter() - t19
    log(f"Phase 19 took {phase_s:.2f} s: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in part_s.items()))
    return {"routed": routed, "monitor": monitor,
            "cli": {"serving": sm, "events": n_events, "schedules_preloaded": n_zoo},
            "part_s": part_s, "phase_s": phase_s}


def monitor_part(torch, dev, cfg, params, first, searched, searched_policy) -> dict:
    """Phase 19 (b): the numerics monitor inside the captured graph (the
    module docstring lists its checks). Four engines on phase 3's four
    prompts under ``searched``, median of 3 runs each (one run of the bare
    eager engine, for the script's time): the bare graph engine, a bare
    eager one, an eager twin under a second monitor and the graph engine
    captured under the monitor. Only the monitor of an
    engine's runs is installed while they run. Returns the part's numbers."""
    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.numerics.trace import calibrate
    from repro_torch.obs.monitor import NumericsMonitor
    from repro_torch.obs.registry import Registry
    from repro_torch.serving import ScoreEngine, parse_buckets
    envelope = searched.meta["envelope"]
    bucket = parse_buckets("4x40")[0]

    def timed_runs(eng, n=3):
        """``n`` runs of the four requests: each run's tokens and seconds."""
        outs, secs = [], []
        for _ in range(n):
            raws = [Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(first)]
            for raw in raws:
                eng.submit(raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            outs.append([raw.out for raw in raws])
            eng.reset_cache()
        if any(o != outs[0] for o in outs):
            fail("an engine's runs on the same requests gave other tokens")
        return outs[0], secs

    def engine(graph):
        return ContinuousBatcher(cfg, params, n_slots=BATCH, max_len=40,
                                 warmup=searched_policy, graph=graph)

    n_tok = BATCH * GEN
    ref = engine(None)
    graph_tokens, secs_bare_graph = timed_runs(ref)
    bare_eager = engine(False)
    bare_tokens, secs_bare_eager = timed_runs(bare_eager, n=1)     # the script's time
    del bare_eager
    twin = NumericsMonitor(envelope, registry=Registry())
    with twin:
        twin_tokens, secs_mon_eager = timed_runs(engine(False))
    score_twin = NumericsMonitor(envelope, registry=Registry())
    with score_twin:
        eager_scores = ScoreEngine(cfg, params, bucket, searched_policy,
                                   graph=False).score_batch(first)
    score_mon = NumericsMonitor(envelope, registry=Registry())
    with score_mon:
        scorer = ScoreEngine(cfg, params, bucket, searched_policy)
        graph_scores = scorer.score_batch(first)
    if scorer.capture_count != 1 or graph_scores != eager_scores or \
            json.dumps(score_mon.snapshot(), sort_keys=True) != \
            json.dumps(score_twin.snapshot(), sort_keys=True):
        fail(f"the score engine under the monitor: {scorer.capture_count} captures, scores "
             f"{graph_scores} (eager twin {eager_scores}), or its snapshot != its eager "
             f"twin's")
    score_captured = dict(scorer.step_launches)
    del scorer
    mon = NumericsMonitor(envelope, registry=Registry()).install()
    for w in K.KERNELS.values():
        w.launches = w.captured = 0
    eng = engine(None)
    mon_tokens, secs_mon_graph = timed_runs(eng)
    mon_launched = {n: w.launches for n, w in K.KERNELS.items() if w.launches}
    mon_captured = {n: w.captured for n, w in K.KERNELS.items() if w.captured}
    folds_before_reader = mon.folds
    snap, twin_snap = mon.snapshot(), twin.snapshot()
    calls = mon.registry.counter("repro_monitor_calls_total", "", ("site",))
    replays = eng.replays
    counted = {s: calls.value(site=s) for s in eng.step_dispatches}
    want_counted = {s: n * replays for s, n in eng.step_dispatches.items()}
    if eng.capture_count != 1 or mon_tokens != graph_tokens or twin_tokens != graph_tokens \
            or bare_tokens != graph_tokens:
        fail(f"the monitored graph engine: {eng.capture_count} captures; its tokens, the "
             f"eager twin's or the bare eager engine's != the unmonitored graph engine's")
    if eng.step_launches != ref.step_launches or mon_captured != eng.step_launches or \
            mon_launched != {n: 2 * k for n, k in eng.step_launches.items()} or \
            not eng.step_launches.get("fdp_gemm") or eng.step_launches["fdp_gemm"] != sum(
                n for s, n in eng.step_dispatches.items()
                if searched_policy.lookup(s).mode == "pallas"):
        fail(f"the monitored graph engine's launches a step {eng.step_launches} (the "
             f"unmonitored engine's {ref.step_launches}); wrappers: launched {mon_launched}, "
             f"captured {mon_captured}")
    if folds_before_reader != 0 or json.dumps(snap, sort_keys=True) != \
            json.dumps(twin_snap, sort_keys=True) or counted != want_counted or \
            calls.total() != sum(want_counted.values()):
        fail(f"the monitored graph engine: {folds_before_reader} folds before a reader, "
             f"calls by site {counted} (want {want_counted}), or its snapshot != its eager "
             f"twin's")
    try:
        with calibrate():
            engine(None)
    except RuntimeError as e:
        if "trace hook" not in str(e):
            raise
    else:
        fail("a graph engine was captured under a calibration hook")
    make = lambda: [Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(first)]
    traced = {"monitored": traced_steps(torch, eng, make, TRACED_STEPS),
              "bare": traced_steps(torch, ref, make, TRACED_STEPS)}
    for name, tr in traced.items():
        if tr is not None and tr["kernels"]["fdp_gemm"] != \
                TRACED_STEPS * eng.step_launches["fdp_gemm"]:
            fail(f"{TRACED_STEPS} profiled replays of the {name} graph engine hold "
                 f"{tr['kernels']['fdp_gemm']} dense kernel events, not "
                 f"{eng.step_launches['fdp_gemm']} a step")
    overflow = mon.registry.counter("repro_overflow_events_total", "", ("site", "source"))
    before = {s: i["status"] for s, i in mon.statuses().items()}
    worst = mon.worst_status()
    events0, counted0 = mon.overflow_events(), overflow.total()
    site = next(s for s in sorted(envelope["sites"])
                if searched_policy.lookup(s).mode == "pallas")
    D.gemm(torch.full((8, 16), 2.0 ** 70, device=dev),
           torch.full((16, 8), 2.0 ** 70, device=dev), site=site, policy=searched_policy)
    after = {s: i["status"] for s, i in mon.statuses().items()}
    mon.uninstall()
    folds = mon.folds
    changed = {s for s in after if after[s] != before.get(s)}
    if changed != {site} or after[site] != "violated" or overflow.total() <= counted0:
        fail(f"the injection at {site}: statuses changed at {changed} ({after.get(site)}), "
             f"repro_overflow_events_total {counted0} -> {overflow.total()}")
    step_launches = dict(eng.step_launches)
    del eng, ref
    med = lambda secs: sorted(secs)[len(secs) // 2]
    tok_s = {name: n_tok / med(secs) for name, secs in (
        ("monitored graph", secs_mon_graph), ("bare graph", secs_bare_graph),
        ("monitored eager", secs_mon_eager), ("bare eager", secs_bare_eager))}
    by_status = collections.Counter(before.values())
    off = {s: st for s, st in sorted(before.items()) if st != "inside"}
    log(f"(b) monitoring(searched) inside the captured graph: a ContinuousBatcher (4 slots, "
        f"max_len 40) captured once under the monitor, {step_launches} launches a step == "
        f"the unmonitored engine's (wrappers: {mon_launched} in the two warm-up calls, "
        f"{mon_captured} captured); tokens == the unmonitored graph engine's; "
        f"{folds_before_reader} folds over 3 runs until the first reader; its snapshot == "
        f"an eager twin's under a second monitor, field for field; "
        f"repro_monitor_calls_total == dispatches a step x {replays} replays at each of "
        f"{len(counted)} sites; a ScoreEngine captured under the monitor "
        f"({score_captured} a call): scores and snapshot == its eager twin's; a calibration "
        f"hook refused the capture")
    for name, tr in traced.items():
        log(f"    {TRACED_STEPS} profiled replays of the {name} graph engine: " + (
            "not measured (no device events)" if tr is None else
            f"{tr['device_events'] / TRACED_STEPS:.1f} device events a step, "
            f"{tr['kernels']['fdp_gemm']} dense kernel events, busy "
            f"{tr['device_busy_s']:.4f} s, idle {100 * tr['idle_share']:.1f}%; top device "
            f"time (name, events, s): {tr['top']}"))
    log(f"    before the injection worst {worst}, sites by status {dict(by_status)}, not "
        f"inside: {off or 'none'}; overflow events {events0}; one eager dispatch at "
        f"{site!r} with operands at 2^70 flipped exactly it to violated, "
        f"repro_overflow_events_total {counted0:.0f} -> {overflow.total():.0f}; {folds} folds")
    log(f"    {n_tok} tokens, 4 requests, tok/s median of 3 (one bare eager run; seconds of "
        f"each run): " + "; ".join(
        f"{name} {v:.2f} ({', '.join(f'{x:.3f}' for x in secs)})" for (name, v), secs in zip(
            tok_s.items(), (secs_mon_graph, secs_bare_graph, secs_mon_eager,
                            secs_bare_eager)))
        + f"; monitored graph / bare graph {tok_s['monitored graph'] / tok_s['bare graph']:.3f}"
        f", / monitored eager {tok_s['monitored graph'] / tok_s['monitored eager']:.2f}x")
    monitor = {"site": site, "worst_before": worst, "statuses_before": dict(by_status),
               "not_inside_before": off, "overflow_events_before": events0,
               "folds": folds, "folds_before_reader": folds_before_reader,
               "step_launches": step_launches, "launched": mon_launched,
               "captured": mon_captured, "replays": replays,
               "score_step_launches": score_captured, "traced": traced, "tok_s": tok_s,
               "seconds": {"monitored graph": secs_mon_graph, "bare graph": secs_bare_graph,
                           "monitored eager": secs_mon_eager,
                           "bare eager": secs_bare_eager}}
    return monitor


def schedules_phase(torch, dev, cfg, params, phase3_tokens, phase18_tokens, make_requests,
                    phase3_tok_s, phase18_tok_s) -> dict:
    """Phase 20: the autotuner and the schedule zoo at full width (the
    module docstring lists its steps). ``phase3_tokens``/``phase18_tokens``
    are phase 3's simple serve's and phase 18's graph engine's tokens under
    FDP91_KERNEL, ``make_requests`` phase 18's requests. Every kernel count
    is set to 0 just before each preloaded run and read just after it.
    Returns the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core import schedules as S
    from repro_torch.core.accumulator import AccumulatorSpec
    from repro_torch.core.formats import FP32
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.models import init

    t20 = time.perf_counter()
    part_s = {}
    P91 = AccumulatorSpec.paper_91bit()
    backend = dev.type                                     # "cuda" on the card

    # (a) the keys of phase 3's serve and phase 18's engine, each autotuned
    t = time.perf_counter()
    keys = S.serve_keys(cfg, params, dev)
    gather_s = time.perf_counter() - t
    # beside them, two shapes of the kernel table (PERF.md): the mlp_in
    # prefill and dbrx-132b's 2-D router, not served here
    extra = [(1, 64, 3072, 1024, FP32.name, P91, backend),
             (1, 4, 16, 6144, FP32.name, P91, backend)]
    log(f"(a) {len(keys)} plan keys from a {cfg.name} serve ({BATCH} x {PROMPT}, {GEN} "
        f"generated) and a continuous engine ({BATCH} slots, max_len 160) under "
        f"{FDP91_KERNEL.name}, gathered in {gather_s:.2f} s; each autotuned over "
        f"{D.AUTOTUNE_TOP} launches ranked by the cost model (every candidate torch.equal "
        f"to the model pick), and {len(extra)} more shapes:")
    with autotune_launches(D, K) as tuned:
        try:
            rows = S.autotune_keys(keys + extra, log=log)
        except RuntimeError as e:
            fail(f"(a) autotuning: {e}")
    part_s["a"] = time.perf_counter() - t
    measured = {row["key"]: row for row in rows}
    faster = [r for r in rows if r["rank"] != 0]
    log(f"(a) {len(rows)} keys autotuned in {tuned['seconds']:.2f} s ({tuned['launches']} "
        f"launches); {len(faster)} winners are not the model pick, their gain "
        + (", ".join(f"{1 - r['win_ms'] / r['pick_ms']:.2%} at {r['key']}" for r in faster)
           or "none"))

    # (b) save, clear, preload: a warm cache takes no miss; the checked-in zoo
    t = time.perf_counter()
    zoo = S.ScheduleZoo.from_cache(backend, meta=S.card_meta(dev))
    with tempfile.TemporaryDirectory(prefix="phase20_") as tmp:
        zoo.save(S.zoo_path(tmp, backend))
        D.clear_plan_cache()
        n = S.preload_schedules(tmp, backend)
    st0 = D.plan_cache_stats()
    again = {key: D.plan_gemm(*key[1:4], fmt=FP32, spec=key[5], batch=key[0], backend=backend)
             for key in keys + extra}
    st = D.plan_cache_stats()
    if n != len(zoo.entries) or n != len(keys) + len(extra) or st0.persisted_loads != n \
            or st.misses != 0 or st.hits != n or any(
                p.source != "persisted" or p.launch != zoo.entries[k[:6]].launch
                for k, p in again.items()):
        fail(f"(b) preloaded {n} of {len(zoo.entries)} schedules, stats {st}")
    checked_in = S.ScheduleZoo.load(S.zoo_path(backend=backend))     # fingerprint checked
    missing = [k[:6] for k in keys if k[:6] not in checked_in.entries]
    if missing or checked_in.backend != backend:
        fail(f"(b) the checked-in cuda zoo lacks {missing} (backend {checked_in.backend})")
    agree = sum(checked_in.entries[k[:6]].launch == zoo.entries[k[:6]].launch for k in keys)
    part_s["b"] = time.perf_counter() - t
    log(f"(b) saved {len(zoo.entries)} schedules, cleared, preloaded {n}: lookups of every "
        f"key {st.hits} hits, {st.misses} misses, persisted_loads {st0.persisted_loads}. The "
        f"checked-in zoo ({S.zoo_path(backend=backend)}, measured on {checked_in.meta.get('device')}"
        f" at {checked_in.meta.get('power_limit')}) loads with its fingerprint checked and "
        f"covers all {len(keys)} keys; this run's winner is its launch at {agree} of "
        f"{len(keys)} (not gated: timer noise)")

    # (c) phase 3's serve and phase 18's engine on the checked-in zoo
    t = time.perf_counter()
    D.clear_plan_cache()
    n_loaded = S.preload_schedules(backend=backend)
    launched = {"named": 0, "none": 0}
    dense_plan = K.dense_plan

    def recording(a, b, num_limbs, sms, launch=None):
        launched["none" if launch is None else "named"] += 1
        return dense_plan(a, b, num_limbs, sms, launch)

    K.dense_plan = recording
    try:
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(1))
        K.fdp_gemm.launches = 0
        D.reset_sites_seen()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with D.use_policy(FDP91_KERNEL):
            toks = serve(cfg, params, prompts, GEN, device=dev).tolist()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - ts
        serve_launches, serve_calls = K.fdp_gemm.launches, sum(D.site_calls().values())
        st_serve = D.plan_cache_stats()
        K.fdp_gemm.launches = K.fdp_gemm.captured = 0
        eng = ContinuousBatcher(cfg, params, n_slots=BATCH, max_len=160, warmup=FDP91_KERNEL)
        engine_runs = []
        for _ in range(2):
            reqs = make_requests()
            for r in reqs:
                eng.submit(r)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            engine_runs.append((time.perf_counter() - ts, sum(len(r.out) for r in reqs)))
            eng_tokens = [r.out for r in reqs]
            eng.reset_cache()
        eng_counts = (K.fdp_gemm.launches, K.fdp_gemm.captured, dict(eng.step_launches))
    finally:
        K.dense_plan = dense_plan
    st = D.plan_cache_stats()
    if toks != phase3_tokens:
        fail("(c) the serve on the preloaded zoo != phase 3's tokens")
    if eng_tokens != phase18_tokens or eng_tokens[:BATCH] != phase3_tokens:
        fail("(c) the graph engine on the preloaded zoo != phase 18's (and phase 3's) tokens")
    if n_loaded != len(checked_in.entries) or st.misses != 0 or launched["none"] != 0 \
            or launched["named"] != serve_launches + eng_counts[0] + eng_counts[1] \
            or serve_launches != serve_calls or st_serve.hits != serve_calls:
        fail(f"(c) preloaded {n_loaded}, stats {st} (after the serve {st_serve}), launches "
             f"{launched}, serve launches {serve_launches} of {serve_calls} dispatches, "
             f"engine {eng_counts}")
    del eng
    serve_tok_s = BATCH * GEN / serve_s
    engine_tok_s = [n_tok / s for s, n_tok in engine_runs]
    part_s["c"] = time.perf_counter() - t
    log(f"(c) the checked-in zoo preloaded ({n_loaded} schedules): phase 3's serve gives "
        f"phase 3's tokens, {serve_launches} launches == FDP dispatches, {st_serve.hits} plan "
        f"hits; phase 18's graph engine gives phase 18's tokens, {eng_counts[0]} warm-up "
        f"launches and {eng_counts[1]} captured ({eng_counts[2]} a step); {st.misses} "
        f"misses over both, all {launched['named']} dense launches on a persisted launch, "
        f"none on the cost model's. Serve {serve_tok_s:.2f} tok/s (one run; phase 3's "
        f"median {phase3_tok_s:.2f}); graph engine "
        f"{', '.join(f'{x:.2f}' for x in engine_tok_s)} tok/s (two runs; phase 18's median "
        f"{phase18_tok_s:.2f})")

    # (d) a simulate MoE engine captures and equals its eager twin
    t = time.perf_counter()
    mcfg = get_config("dbrx-132b").reduced(n_kv_heads=2)
    mparams = init(mcfg, seed=0, device=dev)

    def moe_requests():
        g = torch.Generator().manual_seed(1)
        return [Request(uid=i, prompt=torch.randint(0, mcfg.vocab_size, (n,),
                                                    generator=g).tolist(), max_new=m)
                for i, (n, m) in enumerate(((4, 3), (2, 5), (5, 2), (3, 4), (1, 3)))]

    outs = {}
    for graph in (False, None):
        eng = ContinuousBatcher(mcfg, mparams, n_slots=2, max_len=40, warmup=D.FDP91,
                                graph=graph)
        reqs = moe_requests()
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[graph] = ([r.out for r in reqs], eng.graphed, eng.capture_count, eng.replays)
    if outs[None][0] != outs[False][0] or not outs[None][1] or outs[None][2] != 1 \
            or outs[None][3] <= 0:
        fail(f"(d) the simulate dbrx-132b graph engine: {outs}")
    del eng, mparams
    part_s["d"] = time.perf_counter() - t
    log(f"(d) dbrx-132b reduced (n_kv_heads 2) under {D.FDP91.name} (simulate): the graph "
        f"engine captured once, {outs[None][3]} replays, tokens == its eager twin's "
        f"({sum(len(o) for o in outs[None][0])} tokens)")
    phase_s = time.perf_counter() - t20
    log(f"Phase 20 took {phase_s:.2f} s: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in part_s.items()))
    ms = lambda lay: dataclasses.asdict(lay)
    return {"keys": [{"key": list(r["key"]), "pick_ms": r["pick_ms"], "pick": ms(r["pick"]),
                      "win_ms": r["win_ms"], "win": ms(r["win"]), "rank": r["rank"],
                      "seconds": r["seconds"]} for r in rows],
            "autotune_launches": tuned["launches"], "checked_in_agree": agree,
            "checked_in_meta": checked_in.meta, "preloaded": n_loaded,
            "serve_tok_s": serve_tok_s, "engine_tok_s": engine_tok_s,
            "dense_launches_on_persisted": launched["named"],
            "part_s": part_s, "phase_s": phase_s}


def mesh_rank(dev, arch: str, refs: dict) -> dict:
    """Phases 21 and 22 on one rank of a world of ``MESH_WORLD`` ranks
    sharing the card (``launch.mesh.spawn`` runs it on every rank; module
    docstring). Returns the rank's checks, counts and seconds by part, phase
    22's under "p22" (``shard_rank``, on ``refs``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import accumulator as acc
    from repro_torch.core import dispatch as D
    from repro_torch.core import fdp
    from repro_torch.core.accumulator import AccumulatorSpec
    from repro_torch.core.formats import FP32
    from repro_torch.core.qformat import QuantConfig
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.launch.sharding import distribution_for, make_mesh
    from repro_torch.models import init
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.axes import use_mesh
    from repro_torch.train.loop import make_mesh_train_step, make_train_step
    from repro_torch.train.optimizer import adamw
    from repro_torch.workloads import MeshReshapeStability

    r, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": r, "seconds": {}, "reduces": []}

    def host(t):
        return t.detach().to("cpu", copy=True)
    spec30, grad_spec = AccumulatorSpec(30, 30, -30), AccumulatorSpec(*MESH_GRAD)

    # every all-reduce past 1 MB timed on the host clock around synchronize
    # (gloo stages a CUDA tensor through host memory)
    all_reduce = dist.all_reduce

    def timed_all_reduce(t, *args, **kw):
        nbytes = t.numel() * t.element_size()
        if nbytes < 1 << 20:
            return all_reduce(t, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = all_reduce(t, *args, **kw)
        torch.cuda.synchronize()
        out["reduces"].append((nbytes, str(t.dtype).replace("torch.", ""),
                               time.perf_counter() - t0))
        return res

    dist.all_reduce = timed_all_reduce
    clock = [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now

    # -- (a) the collectives on CUDA tensors ----------------------------------
    M_, K_, N_ = MESH_GEMM
    gen = torch.Generator().manual_seed(21)
    a = torch.randn(M_, K_, generator=gen).to(dev)
    b = (torch.randn(K_, N_, generator=gen) * K_ ** -0.5).to(dev)
    want = K.fdp_gemm(a[None], b[None], spec=spec30, fmt=FP32)[0]   # unsharded
    line = DeviceMesh((n,), ("x",))
    out["backends"] = line.backends()
    kb = K_ // n
    perms = [list(range(n)), list(range(n))[::-1], [1, 3, 0, 2][:n]]
    out["fdp_psum"] = []
    with use_mesh(line):
        for perm in perms:
            idx = torch.cat([torch.arange(p * kb, (p + 1) * kb) for p in perm]).to(dev)
            al, bl = a[:, idx][:, r * kb:(r + 1) * kb], b[idx][r * kb:(r + 1) * kb]
            got = acc.to_float(spec30, C.fdp_psum(fdp.fdp_gemm_limbs(al, bl, spec30),
                                                  "x", spec30))
            out["fdp_psum"].append({"perm": perm, "equal": torch.equal(got, want),
                                    "max_abs_err": float((got - want).abs().max())})
        part("a: fdp_psum")
        # each collective on the card against the same collective on host
        # tensors (the CPU path is held to the JAX package in the CPU tests)
        x = torch.randn(n, MESH_PSUM, generator=gen)[r]
        g = (torch.randn(n, MESH_PSUM, generator=gen) * 1e-2)[r]
        on = {}
        for where in ("cuda", "cpu"):
            xd, gd = (x.to(dev), g.to(dev)) if where == "cuda" else (x, g)
            res = {"reproducible": C.reproducible_psum(xd, "x", AccumulatorSpec(8, 8, -16))}
            resid = torch.zeros_like(gd)
            for _ in range(3):
                q, resid = C.quantized_psum(gd, "x", QuantConfig(4, 32), mean=True,
                                            residual=resid)
            res["quantized"], res["residual"] = q, resid
            red = C.CompressedGradReducer(AccumulatorSpec(4, 2, -8), "x")
            c_out, c_res = red.reduce({"g": gd}, red.init({"g": gd}))
            res["compressed"], res["compressed_residual"] = c_out["g"], c_res["g"]
            on[where] = {k: v.cpu() for k, v in res.items()}
        out["collectives_equal"] = {k: torch.equal(on["cuda"][k], on["cpu"][k])
                                    for k in on["cuda"]}
        gd = g.to(dev)
        with C.validate_overflow():
            C.quantized_psum(gd, "x", QuantConfig(4, 32), residual=torch.zeros_like(gd))
        try:
            with C.validate_overflow():
                C.quantized_psum(gd, "x", QuantConfig(4, 32),
                                 residual=torch.full_like(gd, 100.0 if r == 0 else 0.0))
            out["spillover_raised"] = False
        except OverflowError:
            out["spillover_raised"] = True
    part("a: the other collectives")

    # -- (b) qwen3-0.6b at full width, data-parallel --------------------------
    cfg = dataclasses.replace(get_config(arch), n_layers=QWEN_LAYERS)
    # every rank draws seed 0 on its host at once (init draws on the host for
    # every device), which takes no longer than one draw and a 3 GB
    # broadcast through gloo would; a checksum a parameter, maximized and
    # minimized over the world, shows that the ranks hold the same weights
    params = init(cfg, 0, device=dev)
    sums = torch.stack([p.detach().reshape(-1).view(torch.int32).sum(dtype=torch.int64)
                        for p in params.parameters()])
    hi, lo = sums.clone(), -sums
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX)
    out["same_weights"] = torch.equal(hi, -lo)
    init_host = {k: host(p) for k, p in params.named_parameters()}
    out["n_params"] = sum(p.numel() for p in init_host.values())
    part("b: weights (a seed-0 draw a rank)")
    rep = MeshReshapeStability(cfg=cfg, params=params, seed=0, device=dev).run(FDP91_KERNEL)
    out["report"] = rep.to_json()
    part("b: MeshReshapeStability")

    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, MESH_SEQ), generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (n, MESH_SEQ), generator=gen)}
    batch = {k: v.to(dev) for k, v in batch.items()}

    def restore():
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(init_host[k])

    meshes = {}     # one mesh (and its gloo groups) a shape, built in one order

    def mesh_step(shape, spec, count=False):
        restore()
        opt = adamw(lr=TRAIN_LR)
        state = opt.init(params)
        if shape not in meshes:
            meshes[shape] = make_mesh(shape)
        mesh = meshes[shape]
        step = make_mesh_train_step(cfg, opt, distribution_for(mesh, "ddp", FDP91_KERNEL),
                                    fdp_grad_spec=spec)
        if count:
            D.reset_sites_seen()
            K.fdp_gemm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step((params, state), batch)
        torch.cuda.synchronize()
        res = {"mesh": mesh.describe(), "seconds": time.perf_counter() - t0,
               "loss": float(metrics["loss"]), "backends": mesh.backends()}
        if count:
            res["launches"] = K.fdp_gemm.launches
            res["dispatches"] = sum(D.site_calls().values())
        return res

    out["steps"] = {}
    out["steps"]["fixed 1x4"] = mesh_step((1, n), grad_spec, count=True)
    fixed = {k: host(p) for k, p in params.named_parameters()}
    out["steps"]["fixed 2x2"] = mesh_step((2, n // 2), grad_spec)
    out["fixed_equal"] = all(torch.equal(p, fixed[k].to(dev))
                             for k, p in params.named_parameters())
    part("b: fixed-point steps 1x4, 2x2")
    out["steps"]["float 1x4"] = mesh_step((1, n), None)
    flt = {k: host(p) for k, p in params.named_parameters()}
    out["steps"]["float 2x2"] = mesh_step((2, n // 2), None)
    with torch.no_grad():
        out["float_drift"] = max(float((p - flt[k].to(dev)).abs().max())
                                 for k, p in params.named_parameters())
        out["float_vs_fixed"] = max(float((flt[k].to(dev) - fixed[k].to(dev)).abs().max())
                                    for k in fixed)
    del flt
    part("b: float-sum steps 1x4, 2x2")
    # one process's microbatched step on the same global batch, rank 0 alone
    if r == 0:
        restore()
        opt = adamw(lr=TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat="none", microbatches=n, fdp_grad_spec=grad_spec,
                               numerics_policy=FDP91_KERNEL)
        step((params, state), batch)
        del state
        out["microbatched_equal"] = all(torch.equal(p, fixed[k].to(dev))
                                        for k, p in params.named_parameters())
    restore()                          # phase 22 runs the seed-0 weights
    del fixed, init_host
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    dist.barrier()
    part("b: microbatched step (rank 0)")
    dist.all_reduce = all_reduce
    out["t_end"] = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held = [params]                    # shard_rank frees qwen before dbrx's draw
    del params
    out["p22"] = shard_rank(dev, cfg, held, refs)
    return out


def shard_refs_qwen(torch, dev, cfg, params) -> dict:
    """Phase 22's single-device qwen3-0.6b reference, in the main process:
    the forward logits of 4 x ``SHARD_SEQ`` tokens under FDP91_KERNEL."""
    from repro_torch.core import dispatch as D
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import forward
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SHARD_SEQ),
                           generator=torch.Generator().manual_seed(22))
    with D.use_policy(FDP91_KERNEL), torch.no_grad():
        logits = forward(params, cfg, {"tokens": tokens.to(dev)}, remat="none")
    return {"qwen_tokens": tokens, "qwen_logits": logits[..., :cfg.vocab_size].cpu()}


def recording_serve(torch, serve_mod):
    """A context manager under which ``serve_mod.decode_step``'s calls
    append their logits (on the host) to the list it yields: the decode
    steps of ``launch.serve.serve`` (``serve_mod`` that module), or every
    step of ``prefill`` (``models.transformer``)."""
    steps, step = [], serve_mod.decode_step

    def recorded(*args, **kw):
        logits, cache = step(*args, **kw)
        steps.append(logits.to("cpu", copy=True))
        return logits, cache

    @contextlib.contextmanager
    def ctx():
        serve_mod.decode_step = recorded
        try:
            yield steps
        finally:
            serve_mod.decode_step = step
    return ctx()


def shard_refs_dbrx(torch, dev, mcfg, params, phase5_tokens) -> dict:
    """Phase 22's single-device dbrx-132b references, in the main process
    while it holds phase 5's weights (phase 18): phase 5's serve again with
    each decode step's logits, and layer 0's MoE input on phase 5's prompts
    (4 x 16 tokens, the prefill) with the local block's output, under
    FDP91_KERNEL."""
    from repro_torch.core import dispatch as D
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    t = time.perf_counter()
    prompts = torch.randint(0, mcfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    with D.use_policy(FDP91_KERNEL), recording_serve(torch, serve_mod) as steps:
        toks = serve_mod.serve(mcfg, params, prompts, GEN, device=dev)
    if toks.tolist() != phase5_tokens:
        fail("dbrx-132b's serve for phase 22's references != phase 5's tokens")
    blk = params.layers[0]
    with D.use_policy(FDP91_KERNEL), torch.no_grad():
        x = params.embed[prompts.to(dev)]
        h, _ = L.attention_block(L.rms_norm(x, blk.attn_norm, mcfg.norm_eps), blk.attn, mcfg,
                                 positions=torch.arange(PROMPT, device=dev))
        x = x + h
        moe_x = L.rms_norm(x, blk.mlp_norm, mcfg.norm_eps)
        moe_y = M.moe_block(moe_x, blk.moe, mcfg)
    torch.cuda.synchronize()
    log(f"phase 22's dbrx-132b references (phase 5's serve again, {len(steps)} decode "
        f"steps' logits; layer 0's MoE on the 4 x {PROMPT} prefill) in "
        f"{time.perf_counter() - t:.2f} s")
    return {"dbrx_prompts": prompts, "dbrx_tokens": phase5_tokens,
            "dbrx_step_logits": [l[..., :mcfg.vocab_size] for l in steps],
            "moe_x": moe_x.cpu(), "moe_y": moe_y.cpu()}


def shard_rank(dev, cfg, held: list, refs: dict) -> dict:
    """Phase 22 on one rank (module docstring), after phase 21 in the same
    world: ``held`` holds qwen3-0.6b's seed-0 weights (taken out, so that
    they are freed before dbrx's draw); ``refs`` the main process's
    single-device references and phases 3 and 5's tokens. Returns the
    rank's checks, numbers and seconds by part."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.formats import FP32
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.launch.sharding import distribution_for, expert_take, make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import Transformer, block_of, forward, gather_block
    from repro_torch.parallel import axes as A

    r, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": r, "seconds": {}, "collectives": {}}
    clock = [time.perf_counter()]
    P91 = FDP91_KERNEL.default.acc
    params = held.pop()

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now

    # every collective of the phase timed on the host clock around
    # synchronize, by op, bytes and dtype: [calls, seconds]
    originals = {op: getattr(LM.DeviceMesh, op)
                 for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")}

    def timed(op, fn):
        def call(self, x, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(self, x, *args, **kw)
            torch.cuda.synchronize()
            key = f"{op} {x.numel() * x.element_size()} {str(x.dtype).replace('torch.', '')}"
            rec = out["collectives"].setdefault(key, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t0
            return y
        return call

    for op, fn in originals.items():
        setattr(LM.DeviceMesh, op, timed(op, fn))

    # the Megatron MLP's K-split is a reduce dispatch: plain limbs + fdp_psum,
    # no kernel launch
    reduce_calls = [0]
    dispatch_reduce = D._dispatch_reduce

    def counted_reduce(*args, **kw):
        reduce_calls[0] += 1
        return dispatch_reduce(*args, **kw)

    D._dispatch_reduce = counted_reduce

    def counted(fn, kernels):
        D.reset_sites_seen()
        reduce_calls[0] = 0
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls = D.site_calls()
        ragged = sum(v for s, v in calls.items() if s.startswith("moe_")
                     and s != "moe_router")
        counts = {"fdp_gemm": (K.fdp_gemm.launches,
                               sum(calls.values()) - ragged - reduce_calls[0]),
                  "fdp_ragged_gemm": (K.fdp_ragged_gemm.launches, ragged),
                  "reduce_dispatches": reduce_calls[0]}
        return res, dt, counts

    meshes = {"1x4": make_mesh((1, n)), "2x2": make_mesh((2, n // 2))}

    # -- (a) the collectives on CUDA tensors against host tensors --------------
    gen = torch.Generator().manual_seed(220 + r)
    x = torch.randn(4, 8, 12, generator=gen)
    out["collectives_equal"] = {}
    for name, mesh in meshes.items():
        with A.use_mesh(mesh):
            for axis in mesh.axis_names:
                if mesh.axis_size(axis) == 1:
                    continue
                res = {}
                for where in ("cuda", "cpu"):
                    xd = x.to(dev) if where == "cuda" else x
                    res[where] = {
                        "all_gather": A.all_gather(xd, axis, axis=1, tiled=True),
                        "psum_scatter": A.psum_scatter(xd, axis, scatter_dimension=0,
                                                       tiled=True),
                        "all_to_all": A.all_to_all(xd, axis, 0, 2, tiled=True),
                        "axis_index": torch.tensor(A.axis_index(axis))}
                for op in res["cuda"]:
                    out["collectives_equal"][f"{name} {axis} {op}"] = torch.equal(
                        res["cuda"][op].cpu(), res["cpu"][op])
    out["staged"] = LM.staged_ops()
    part("a: collectives on CUDA vs host")

    # -- (b) qwen3-0.6b at full width ------------------------------------------
    tokens = refs["qwen_tokens"].to(dev)
    want = refs["qwen_logits"].to(dev)
    bound = SHARD_TOL * float(want.abs().max())
    out["sp_forward"] = {}
    for name, mesh in meshes.items():
        d_ = distribution_for(mesh, "fsdp")
        with D.use_policy(FDP91_KERNEL), torch.no_grad():
            y, dt, counts = counted(lambda: forward(params, cfg, {"tokens": tokens}, d_,
                                                    remat="none"), [K.fdp_gemm])
        with torch.no_grad():
            got = gather_block(y, d_, SHARD_SEQ)[..., :cfg.vocab_size]
            diff = (got - want).abs()
            out["sp_forward"][name] = {
                "seconds": dt, "max_abs_diff": float(diff.max()), "bound": bound,
                "rows_equal": int((diff == 0).all(-1).sum()), "rows": BATCH * SHARD_SEQ,
                "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "launches": counts}
        del y, got, diff
        part(f"b: SP forward {name}")
    del want
    d22 = distribution_for(meshes["2x2"], "fsdp")
    prompts = refs["qwen_prompts"].to(dev)
    with D.use_policy(FDP91_KERNEL):
        toks, dt, counts = counted(lambda: serve_mod.serve(cfg, params, prompts, GEN,
                                                           device=dev, dist=d22), [K.fdp_gemm])
    out["qwen_serve"] = {"equal": toks.tolist() == refs["qwen_serve_tokens"],
                         "seconds": dt, "tok_s": BATCH * GEN / dt, "launches": counts}
    part("b: serve 2x2")
    xd = torch.randn(BATCH, 1, cfg.d_model, generator=torch.Generator().manual_seed(221)).to(dev)
    mlp = params.layers[0].mlp
    rows = block_of(d22, BATCH, 1)[0]
    with D.use_policy(FDP91_KERNEL), torch.no_grad():
        local = L.mlp_block(xd, mlp, cfg)
        meg = L.mlp_block(xd[rows], mlp, cfg, d22)
    out["megatron_equal"] = torch.equal(meg, local[rows])
    del params, local, meg
    torch.cuda.empty_cache()
    part("b: Megatron block")

    # -- (c) dbrx-132b at full width, 1 layer, the rank's slices ---------------
    mcfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    tp = distribution_for(meshes["1x4"], "fsdp")
    tp_take, ep_take = expert_take(mcfg, tp, "tp"), expert_take(mcfg, tp, "ep")
    ep_host = []

    def take(name, t):            # the TP slices kept, the EP slices set aside
        ep_host.append((name, ep_take(name, t).clone()))
        return tp_take(name, t)

    mp = Transformer(mcfg, torch.Generator().manual_seed(0), torch.float32, dev, take)
    d, f = mcfg.d_model, mcfg.d_ff
    ep = M.MoE(d, f, mcfg.n_experts, device=dev, take=ep_take)
    with torch.no_grad():
        for name, host in ep_host:      # init's move then scale, in place
            getattr(ep, name).copy_(host).mul_((f if name == "w_out" else d) ** -0.5)
        ep.router = mp.layers[0].moe.router
    del ep_host
    out["n_params"] = sum(p.numel() for p in mp.parameters()) + sum(
        getattr(ep, w).numel() for w in ("w_in", "w_gate", "w_out"))
    part("c: dbrx draw (TP and EP slices)")
    dprompts = refs["dbrx_prompts"].to(dev)
    out["dbrx_serve"] = {}
    for name, d_ in (("1x4 tp", tp), ("2x2 decode_tp", distribution_for(meshes["2x2"],
                                                                          "decode_tp"))):
        with D.use_policy(FDP91_KERNEL), recording_serve(torch, serve_mod) as steps:
            toks, dt, counts = counted(lambda: serve_mod.serve(mcfg, mp, dprompts, GEN,
                                                               device=dev, dist=d_),
                                       [K.fdp_gemm, K.fdp_ragged_gemm])
        rows = block_of(d_, BATCH, 1)[0]
        step_diff = [float((got[..., :mcfg.vocab_size] - ref[rows]).abs().max())
                     for got, ref in zip(steps, refs["dbrx_step_logits"])]
        out["dbrx_serve"][name] = {"equal": toks.tolist() == refs["dbrx_tokens"],
                                   "seconds": dt, "tok_s": BATCH * GEN / dt,
                                   "step_max_abs_diff": step_diff, "launches": counts}
        part(f"c: serve {name}")
    moe_x, moe_y = refs["moe_x"].to(dev), refs["moe_y"].to(dev)
    rows, pos = block_of(tp, BATCH, PROMPT)
    with D.use_policy(FDP91_KERNEL), torch.no_grad():
        y = gather_block(M.moe_block(moe_x[rows, pos], mp.layers[0].moe, mcfg, tp,
                                     seq_sharded=True), tp, PROMPT)
        ye, dropped = M.moe_block_ep(moe_x[rows, pos], ep, mcfg, tp,
                                     capacity_factor=SHARD_EP_CF, return_dropped=True)
        ye = gather_block(ye, tp, PROMPT)
    rtol, atol = SHARD_MOE_TOL
    out["moe_tp"] = {"close": bool(torch.allclose(y, moe_y, rtol=rtol, atol=atol)),
                     "max_abs_diff": float((y - moe_y).abs().max())}
    out["moe_ep"] = {"equal": torch.equal(ye, moe_y),
                     "dropped": int(meshes["1x4"].all_reduce(dropped, "model")),
                     "max_abs_diff": float((ye - moe_y).abs().max())}
    part("c: MoE blocks (TP, EP)")
    out["peak_path_bytes"] = torch.cuda.max_memory_allocated()
    # the sorted-segment kernel at the f/4 shapes against its plain version
    # (not counted: this compares, the serves above are the path)
    g = torch.Generator().manual_seed(222 + r)
    # about a decode step's rows (4 tokens x top-4 over 16 experts), with
    # empty groups, in another order on each rank
    sizes = ((torch.arange(mcfg.n_experts) + r) % 3).to(torch.int32)
    T = int(sizes.sum())
    xs = torch.randn(T, d, generator=g).to(dev)
    hs = torch.randn(T, f // n, generator=g).to(dev)
    sizes = sizes.to(dev)
    blk = mp.layers[0].moe
    out["ragged_equal"] = {}
    for site, (a, w) in {"moe_in": (xs, blk.w_in), "moe_out": (hs, blk.w_out)}.items():
        got = K.fdp_ragged_gemm(a, w, sizes, spec=P91, fmt=FP32)
        plain = K.fdp_ragged_gemm_plain(a, w, sizes, spec=P91, fmt=FP32)
        out["ragged_equal"][f"{site} {tuple(a.shape)} x {tuple(w.shape)}"] = torch.equal(
            got, plain)
    part("c: sorted-segment kernel == plain at f/4")
    for op, fn in originals.items():
        setattr(LM.DeviceMesh, op, fn)
    D._dispatch_reduce = dispatch_reduce
    del mp, ep
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    dist.barrier()
    out["t_end"] = time.perf_counter()
    return out


def mesh_phase(torch, arch: str, refs: dict) -> dict:
    """Phases 21 and 22: spawn the world, gate every rank's results, print
    them. Returns what the kernels line needs."""
    from repro_torch.launch.mesh import spawn
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = spawn(mesh_rank, MESH_WORLD, device="cuda:0", args=(arch, refs),
                  timeout=MESH_TIMEOUT, collective_timeout=MESH_COLLECTIVE_TIMEOUT)
    t_end = time.perf_counter()
    p22_wall = t_end - max(r["t_end"] for r in ranks)
    wall = t_end - t - p22_wall
    r0 = ranks[0]
    for r in ranks:
        tag = f"rank {r['rank']}"
        if not r["same_weights"]:
            fail(f"{tag}: the ranks' seed-0 weights differ")
        if set(r["backends"].values()) != {"gloo"}:
            fail(f"{tag}: the line mesh's groups run {r['backends']}, not gloo")
        for case in r["fdp_psum"]:
            if not case["equal"]:
                fail(f"{tag}: fdp_psum over shard assignment {case['perm']} != the dense "
                     f"kernel's unsharded mlp_in output (max |diff| {case['max_abs_err']})")
        bad = [k for k, ok in r["collectives_equal"].items() if not ok]
        if bad:
            fail(f"{tag}: on CUDA tensors != on host tensors: {bad}")
        if not r["spillover_raised"]:
            fail(f"{tag}: validate_overflow() silent on a spillover")
        rep = r["report"]
        if (rep["mesh"], rep["details"]["logits_bits"], rep["details"]["grad_bits"]) != \
                ("1x4,2x2,4x1", 53.0, 53.0):
            fail(f"{tag}: MeshReshapeStability under FDP91_KERNEL read mesh {rep['mesh']}, "
                 f"logits {rep['details'].get('logits_bits')} and grad "
                 f"{rep['details'].get('grad_bits')} bits, not 1x4,2x2,4x1 at 53.0 and 53.0")
        if not r["fixed_equal"]:
            fail(f"{tag}: the fixed-point mesh step's parameters differ on 1x4 and 2x2")
        step = r["steps"]["fixed 1x4"]
        if step["launches"] <= 0 or step["launches"] != step["dispatches"]:
            fail(f"{tag}: the 1x4 mesh step launched the dense kernel {step['launches']} "
                 f"times, its FDP dispatches were {step['dispatches']}")
        if not all(math.isfinite(s["loss"]) for s in r["steps"].values()):
            fail(f"{tag}: a mesh step's loss is not finite: {r['steps']}")
    # the one check that ties the mesh step's gradient mean to a path held
    # on its own: one process's microbatched fixed-point mean of the same
    # four 1 x 64 gradients
    if not r0["microbatched_equal"]:
        fail(f"one process's make_train_step(microbatches={MESH_WORLD}, fdp_grad_spec) "
             "ended on other parameters than the fixed-point 1x4 mesh step")
    if any(r["report"] != r0["report"] for r in ranks):
        fail("the ranks' mesh reports differ")
    log(f"world of {MESH_WORLD} ranks on one card ({', '.join(f'{a} {b}' for a, b in r0['backends'].items())}): "
        f"spawned, ran and ended in {wall:.2f} s")
    log(f"(a) fdp_psum of mlp_in's prefill {MESH_GEMM} K-sharded over {MESH_WORLD} ranks "
        f"torch.equal the dense kernel's unsharded output on every rank, for shard "
        f"assignments {[c['perm'] for c in r0['fdp_psum']]}; reproducible_psum, "
        f"quantized_psum (3 error-feedback steps) and CompressedGradReducer on CUDA "
        f"tensors torch.equal the same on host tensors; validate_overflow() silent on a "
        f"benign payload and raising on every rank at a spillover on rank 0")
    rep = r0["report"]
    log(f"(b) {arch} at full width ({r0['n_params'] / 1e6:.1f} M parameters) under "
        f"FDP91_KERNEL: MeshReshapeStability mesh {rep['mesh']}, logits_bits "
        f"{rep['details']['logits_bits']}, grad_bits {rep['details']['grad_bits']}, "
        f"site bits {rep['site_attribution']}")
    for r in ranks:
        log(f"  rank {r['rank']}: " + "; ".join(
            f"{name} {s['seconds']:.2f} s loss {s['loss']:.6f}"
            + (f" launches {s['launches']} == dispatches {s['dispatches']}"
               if "launches" in s else "") + f" (groups {s['backends']})"
            for name, s in r["steps"].items())
            + f"; peak {r['peak_bytes'] / 1e9:.2f} GB")
    log(f"  the fixed-point step's parameters on 1x4 torch.equal 2x2 on every rank; the "
        f"float-sum steps' largest |1x4 - 2x2| {r0['float_drift']:.3e} (the drift the exact "
        f"mean takes away; float 1x4 vs fixed 1x4 {r0['float_vs_fixed']:.3e}); one "
        f"process's make_train_step(microbatches={MESH_WORLD}, fdp_grad_spec) "
        f"torch.equal the 1x4 step")
    by = collections.defaultdict(list)
    for r in ranks:
        for nbytes, dtype, s in r["reduces"]:
            by[(nbytes, dtype)].append(s)
    for (nbytes, dtype), ss in sorted(by.items()):
        log(f"  all-reduce of {nbytes / 1e9:.3f} GB {dtype} (gloo, CUDA tensors): "
            f"{len(ss)} calls over the ranks, {min(ss):.3f}-{max(ss):.3f} s a call")
    for name in r0["seconds"]:
        log(f"  {name}: " + ", ".join(f"{r['seconds'][name]:.2f}" for r in ranks) + " s by rank")
    p22 = shard_report([r["p22"] for r in ranks], p22_wall)
    return {"launches": sum(r["steps"]["fixed 1x4"]["launches"] for r in ranks),
            "wall_s": wall, "ranks": [{k: v for k, v in r.items() if k != "p22"}
                                      for r in ranks],
            "p22_wall_s": p22_wall, "p22": p22}


def shard_report(ranks: list, wall: float) -> dict:
    """Phase 22: gate every rank's results (module docstring), print them.
    Returns the phase's launches by kernel and its numbers."""
    r0 = ranks[0]
    launches = collections.Counter()
    for r in ranks:
        tag = f"rank {r['rank']}"
        bad = [k for k, ok in r["collectives_equal"].items() if not ok]
        if bad:
            fail(f"{tag}: collectives on CUDA tensors != on host tensors: {bad}")
        runs = {f"SP forward {k}": v["launches"] for k, v in r["sp_forward"].items()}
        runs["qwen3-0.6b serve 2x2"] = r["qwen_serve"]["launches"]
        runs.update({f"dbrx-132b serve {k}": v["launches"]
                     for k, v in r["dbrx_serve"].items()})
        for run, counts in runs.items():
            for kernel in ("fdp_gemm", "fdp_ragged_gemm"):
                n, want = counts[kernel]
                if n != want or (n == 0 and (kernel == "fdp_gemm" or "dbrx" in run)):
                    fail(f"{tag}: {run} launched {kernel} {n} times, its FDP dispatches "
                         f"were {want}")
                launches[kernel] += n
        for name, sp in r["sp_forward"].items():
            if not sp["max_abs_diff"] <= sp["bound"]:
                fail(f"{tag}: qwen3-0.6b's SP forward on {name}: max |logit diff| "
                     f"{sp['max_abs_diff']:.3e} > {sp['bound']:.3e} (1e-4 x max |logit|)")
        if not r["qwen_serve"]["equal"]:
            fail(f"{tag}: qwen3-0.6b's serve on 2x2 != phase 3's tokens")
        if not r["megatron_equal"]:
            fail(f"{tag}: the Megatron mlp_block != the local block (FDP91_KERNEL)")
        for name, srv in r["dbrx_serve"].items():
            if not srv["equal"]:
                fail(f"{tag}: dbrx-132b's serve on {name} != phase 5's tokens (largest "
                     f"|logit diff| by step {srv['step_max_abs_diff']})")
        if not r["moe_tp"]["close"]:
            fail(f"{tag}: the sequence-sharded TP moe_block is not within rtol/atol "
                 f"{SHARD_MOE_TOL} of the local block (max |diff| "
                 f"{r['moe_tp']['max_abs_diff']:.3e})")
        if not r["moe_ep"]["equal"] or r["moe_ep"]["dropped"]:
            fail(f"{tag}: moe_block_ep != the local block (max |diff| "
                 f"{r['moe_ep']['max_abs_diff']:.3e}) or dropped {r['moe_ep']['dropped']} rows")
        bad = [k for k, ok in r["ragged_equal"].items() if not ok]
        if bad:
            fail(f"{tag}: the sorted-segment kernel != its plain version at {bad}")
    staged = sorted(op for op, st in r0["staged"].items() if st)
    log(f"phase 22 in phase 21's world, {wall:.2f} s after its last rank ended phase 21; "
        f"gloo on CUDA tensors stages {staged or 'nothing'} through host tensors (probed: "
        f"{sorted(r0['staged'])})")
    log(f"(a) all_gather, psum_scatter, all_to_all and axis_index over each axis of 1x4 "
        f"and 2x2 on CUDA tensors torch.equal the same on host tensors, every rank")
    for name, sp in r0["sp_forward"].items():
        log(f"(b) qwen3-0.6b SP forward 4 x {SHARD_SEQ} on {name} (FDP91_KERNEL), gathered: "
            f"max |diff| {max(r['sp_forward'][name]['max_abs_diff'] for r in ranks):.3e} "
            f"(bound {sp['bound']:.3e}), rows bit-equal {sp['rows_equal']}/{sp['rows']}, "
            f"top-1 agreement {100 * sp['top1']:.2f}%; "
            + ", ".join(f"{r['sp_forward'][name]['seconds']:.2f}" for r in ranks)
            + " s by rank")
    log(f"    serve on 2x2 (Megatron MLP at decode, fdp_psum) == phase 3's tokens on every "
        f"rank: " + ", ".join(f"{r['qwen_serve']['tok_s']:.2f}" for r in ranks)
        + f" tok/s by rank; the Megatron mlp_block torch.equal the local block")
    for name in r0["dbrx_serve"]:
        srv = r0["dbrx_serve"][name]
        log(f"(c) dbrx-132b serve {name} == phase 5's tokens on every rank: "
            + ", ".join(f"{r['dbrx_serve'][name]['tok_s']:.2f}" for r in ranks)
            + " tok/s by rank; largest |logit diff| by step against phase 5's: "
            + ", ".join(f"{x:.2e}" for x in srv["step_max_abs_diff"]))
    log(f"    layer 0's MoE on the 4 x {PROMPT} prefill input: sequence-sharded TP max |diff| "
        f"{max(r['moe_tp']['max_abs_diff'] for r in ranks):.3e} (within rtol/atol "
        f"{SHARD_MOE_TOL}); moe_block_ep torch.equal, 0 rows dropped; the sorted-segment "
        f"kernel torch.equal its plain version at {sorted(r0['ragged_equal'])}")
    log(f"    a rank's parameters (replicated, TP and EP slices): {r0['n_params'] / 1e9:.3f} G "
        f"f32; peak " + ", ".join(f"{r['peak_path_bytes'] / 1e9:.2f}" for r in ranks)
        + " GB by rank before the plain version's check at f/4, "
        + ", ".join(f"{r['peak_bytes'] / 1e9:.2f}" for r in ranks) + " GB with it")
    for name in r0["seconds"]:
        log(f"  {name}: " + ", ".join(f"{r['seconds'][name]:.2f}" for r in ranks) + " s by rank")
    by = collections.defaultdict(lambda: [0, 0.0])
    for r in ranks:
        for key, (calls, sec) in r["collectives"].items():
            by[key][0] += calls
            by[key][1] += sec
    for key, (calls, sec) in sorted(by.items(), key=lambda kv: -kv[1][1])[:12]:
        op, nbytes, dtype = key.split()
        log(f"  {op} of {int(nbytes)} B {dtype}: {calls} calls over the ranks, {sec:.3f} s")
    return {"launches": dict(launches), "wall_s": wall, "staged": r0["staged"],
            "ranks": ranks}


def ssm_sites(cfg) -> dict:
    """The dense kernel's (B, M, K, N) at each site of a decode step of
    ``cfg`` (an SSM or hybrid model) serving BATCH prompts: the six SSM
    projections, the hybrid's shared attention and MLP (the attention
    GEMMs grouped by KV head against a cache of PROMPT + GEN positions),
    the LM head."""
    d, di, gn = cfg.d_model, cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    sites = {"ssm_x": (BATCH, 1, d, di), "ssm_z": (BATCH, 1, d, di),
             "ssm_B": (BATCH, 1, d, gn), "ssm_C": (BATCH, 1, d, gn),
             "ssm_dt": (BATCH, 1, d, cfg.ssm_heads), "ssm_out": (BATCH, 1, di, d),
             "lm_head": (BATCH, 1, d, cfg.padded_vocab)}
    if cfg.family == "hybrid":
        hq, hkv, hd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.head_dim
        G, smax, bkh = cfg.n_heads // cfg.n_kv_heads, PROMPT + GEN, BATCH * cfg.n_kv_heads
        sites.update({"attn_q": (BATCH, 1, d, hq), "attn_k": (BATCH, 1, d, hkv),
                      "attn_v": (BATCH, 1, d, hkv), "attn_qk": (bkh, G, hd, smax),
                      "attn_av": (bkh, G, smax, hd), "attn_o": (BATCH, 1, hq, d),
                      "mlp_in": (BATCH, 1, d, cfg.d_ff), "mlp_gate": (BATCH, 1, d, cfg.d_ff),
                      "mlp_out": (BATCH, 1, cfg.d_ff, d)})
    return sites


def kernel_shapes(torch, dev, name: str, sites: dict, gen, check_rows: int = 0,
                  check_cols: int = 0) -> dict:
    """The dense kernel at each of ``sites`` (label -> (B, M, K, N,
    broadcast)) on random fp32 operands (a broadcast weight expanded over
    the batch, as ``dense`` passes it; else batched, as the attention
    GEMMs): torch.equal its plain version (that call timed by CUDA events),
    the kernel's CUDA-event ms (warm, back to back) and the bound. With
    ``check_rows``/``check_cols`` the plain version runs on a corner of the
    output (an output element depends only on its row of a and its column
    of b): the first ``check_rows`` rows of the first batch element (of
    every batch element when they hold at most 128 rows in all) and the
    first ``check_cols`` columns; the kernel runs the whole shape."""
    from repro_torch.core.accumulator import AccumulatorSpec
    from repro_torch.core.formats import FP32
    from repro_torch.kernels import fdp_gemm as K
    P91 = AccumulatorSpec.paper_91bit()
    out = {}
    for site, (B, M, Kd, N, bcast) in sites.items():
        a = FP32.quantize(torch.randn(B, M, Kd, generator=gen, device=dev))
        b = FP32.quantize(torch.randn(1 if bcast else B, Kd, N, generator=gen, device=dev)
                          * Kd ** -0.5)
        b = b.expand(B, Kd, N)
        got = K.fdp_gemm(a, b, spec=P91, fmt=FP32)
        mr = min(M, check_rows) if check_rows else M
        nb = B if B * mr <= 128 or not check_rows else 1
        nc = min(N, check_cols) if check_cols else N
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = K.fdp_gemm_plain(a[:nb, :mr], b[:nb, :, :nc], spec=P91, fmt=FP32)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        if got.shape != (B, M, N) or not torch.equal(got[:nb, :mr, :nc], want):
            fail(f"{name} {site} {(B, M, Kd, N)}: the dense kernel != its plain version "
                 f"(max |diff| {(got[:nb, :mr, :nc] - want).abs().max().item()})")
        b_elems = (1 if bcast else B) * Kd * N
        ops_n = K.int32_ops(B * M * Kd, b_elems, B * M * Kd * N)
        bnd = bound(4 * (B * M * Kd + b_elems + B * M * N), ops_n)
        reps = 3 if bnd["bound_ms"] > 5 else 20 if bnd["bound_ms"] > 0.3 else 50
        ms = cuda_ms(torch, lambda: K.fdp_gemm(a, b, spec=P91, fmt=FP32), reps=reps)
        at = "" if (nb, mr, nc) == (B, M, N) else f" on [{nb}, {mr}, {nc}] of the output"
        out[site] = {"shape": [B, M, Kd, N], "ms": ms, "plain_ms": plain_ms,
                     "plain_at": [nb, mr, nc], **bnd}
        log(f"  {name} {site:8s} {(B, M, Kd, N)}: kernel torch.equal plain{at}; "
            f"{ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) = "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of bound; plain {plain_ms:.2f} ms{at}")
        del a, b, got, want
    return out


def ssm_kernel_shapes(torch, dev, cfg, gen) -> dict:
    """The dense kernel at each of ``ssm_sites(cfg)`` (``kernel_shapes``,
    the plain version on the whole shape: a batched attention call's loops
    over its 128 batch elements, ~1 s)."""
    return kernel_shapes(torch, dev, cfg.name,
                         {site: (*shape, site not in ("attn_qk", "attn_av"))
                          for site, shape in ssm_sites(cfg).items()}, gen)


def ssm_model_part(torch, dev, cfg, eq_layers: int, zoo_file: str) -> dict:
    """Phase 23 on one model at published widths: the dense kernel at its
    decode shapes; a serve of BATCH x PROMPT prompts, GEN generated, under
    FDP91_KERNEL with the launch count set to 0 just before and read just
    after (== FDP dispatches == steps x sites a step), then again under
    torch.profiler (tokens and last logits bit-equal to the first run), then
    under MXU_FP32 and the zoo plan (no FDP launch); the chunked
    ``forward`` of SSM_FWD_SHAPE tokens against ``prefill``'s per-token
    logits (the step recurrence);
    ``pallas`` == ``simulate`` logits at ``eq_layers`` layers (a draw of
    that depth from the same seed). Frees the weights. Returns its numbers,
    and seconds and peak memory by part."""
    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import forward, init, init_cache, prefill
    from repro_torch.models import transformer as T
    secs, peak_gb, clock = {}, {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - clock[0]
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        clock[0] = now
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    params = init(cfg, seed=0, device=dev)          # no host copy: nothing draws it again
    torch.cuda.synchronize()
    lap("draw")
    log(f"init {cfg.name} at {cfg.n_layers} layers, full width: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} G f32 parameters drawn in "
        f"{secs['draw']:.2f} s")
    log(f"{cfg.name}: the dense kernel at its decode shapes")
    shapes = ssm_kernel_shapes(torch, dev, cfg, torch.Generator(device=dev).manual_seed(23))
    lap("kernel_shapes")

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    zoo = D.policy_from_plan(os.path.join(ROOT, "examples", "plans", zoo_file))

    def one_serve(policy):
        """(tokens, the last step's logits on the host), seconds."""
        with D.use_policy(policy), recording_serve(torch, serve_mod) as steps:
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks = serve_mod.serve(cfg, params, prompts, GEN, device=dev)
            torch.cuda.synchronize()
            return (toks, steps[-1]), time.perf_counter() - t

    hybrid = cfg.family == "hybrid"
    # six SSM sites a layer, the LM head, and nine sites a shared block
    per_step = 6 * cfg.n_layers + 1 + (9 * (cfg.n_layers // cfg.attn_every) if hybrid else 0)
    D.reset_sites_seen()
    K.fdp_gemm.launches = 0
    (toks, last), fdp_s = one_serve(FDP91_KERNEL)
    launches = K.fdp_gemm.launches
    calls = D.site_calls()
    n_fdp = sum(calls.values())
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"{cfg.name}: served tokens malformed: shape {tuple(toks.shape)}")
    if set(calls) != set(ssm_sites(cfg)):
        fail(f"{cfg.name}: dispatched sites {sorted(calls)} != {sorted(ssm_sites(cfg))}")
    if not launches == n_fdp == (PROMPT + GEN) * per_step:
        fail(f"{cfg.name}: dense launches {launches}, FDP dispatches {n_fdp}, expected "
             f"{PROMPT + GEN} steps x {per_step}")
    held = {}

    def traced_serve():
        held["out"], wall = one_serve(FDP91_KERNEL)
        return held["out"], wall

    trace = trace_serve(torch, traced_serve)
    again, last_again = held["out"]
    if not torch.equal(again, toks) or not torch.equal(last_again, last):
        fail(f"{cfg.name}: a second FDP91_KERNEL serve differs (tokens equal "
             f"{torch.equal(again, toks)}, last logits equal {torch.equal(last_again, last)})")
    (toks32, last32), fp32_s = one_serve(D.MXU_FP32)
    D.reset_sites_seen()
    before = (K.fdp_gemm.launches, K.fdp_ragged_gemm.launches)
    (toks_zoo, _), zoo_s = one_serve(zoo)
    zoo_calls = D.site_calls()
    if (K.fdp_gemm.launches, K.fdp_ragged_gemm.launches) != before \
            or sum(zoo_calls.values()) != n_fdp:
        fail(f"{cfg.name}: the zoo plan launched FDP kernels or dispatched "
             f"{sum(zoo_calls.values())} GEMMs, not {n_fdp}")
    lap("serves")
    tok_s = BATCH * GEN / fdp_s
    V = cfg.vocab_size
    log(f"serve {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"vocab {V}) under {FDP91_KERNEL.name}: batch {BATCH} prompt {PROMPT} gen {GEN}; "
        f"dense launches {launches} == FDP dispatches {n_fdp} == {PROMPT + GEN} steps x "
        f"{per_step}; {fdp_s:.3f} s = {tok_s:.2f} tok/s (each step's logits copied to the "
        f"host, as in every serve of this phase); a second, traced run repeats the tokens "
        f"and the last logits bit for bit")
    log(f"  {D.MXU_FP32.name}: {fp32_s:.3f} s = {BATCH * GEN / fp32_s:.2f} tok/s, tokens agree "
        f"{100 * float((toks32 == toks).float().mean()):.1f}%, last logits max |diff| "
        f"{(last32 - last)[..., :V].abs().max().item():.3e}; zoo plan {zoo.name!r} "
        f"(examples/plans/{zoo_file}, unchanged, every site native): {zoo_s:.3f} s = "
        f"{BATCH * GEN / zoo_s:.2f} tok/s, 0 FDP launches, tokens agree "
        f"{100 * float((toks_zoo == toks).float().mean()):.1f}%")
    if trace is None:
        log("  traced serve: torch.profiler recorded no device events; device busy and "
            "idle share not measured")
    else:
        log(f"  traced {FDP91_KERNEL.name} serve (torch.profiler): wall {trace['wall_s']:.3f} s, "
            f"device busy {trace['device_busy_s']:.3f} s, idle share "
            f"{100 * trace['idle_share']:.1f}%, {trace['device_events']} device events; "
            f"dense kernel {trace['kernels']['fdp_gemm']['count']} in "
            f"{trace['kernels']['fdp_gemm']['s']:.3f} s, outside it "
            f"{trace['device_busy_s'] - trace['fdp_kernel_s']:.3f} s busy; top: "
            + "; ".join(f"{n} {x:.3f} s" for n, x in trace["top"]))

    # the chunked SSD (forward) against the step recurrence (prefill)
    tokens = torch.randint(0, cfg.vocab_size, SSM_FWD_SHAPE,
                           generator=torch.Generator().manual_seed(23)).to(dev)
    with D.use_policy(FDP91_KERNEL), torch.no_grad():
        full = forward(params, cfg, {"tokens": tokens})[..., :V]
        cache = init_cache(cfg, SSM_FWD_SHAPE[0], SSM_FWD_SHAPE[1], dtype=torch.float32,
                           device=dev)
        with recording_serve(torch, T) as steps:
            last_pf, _ = prefill(params, cfg, {"tokens": tokens}, cache)
    stepped = torch.stack([s[:, 0, :V] for s in steps], 1)
    if stepped.shape != full.shape or not torch.equal(stepped[:, -1], last_pf[:, :V].cpu()):
        fail(f"{cfg.name}: prefill's recorded steps {tuple(stepped.shape)} do not end in its "
             f"last logits")
    if not bool(torch.isfinite(full).all()):
        fail(f"{cfg.name}: the chunked forward's logits are not finite")
    diff = (full.cpu() - stepped).abs()
    scale = stepped.abs().max().item()
    top1 = float((full.cpu().argmax(-1) == stepped.argmax(-1)).float().mean())
    fwd = {"max_abs_diff": diff.max().item(), "last_max_abs_diff": diff[:, -1].max().item(),
           "max_abs_logit": scale, "tol": SSM_FWD_TOL, "top1_agree": top1}
    log(f"  forward {SSM_FWD_SHAPE} (chunked SSD, chunks of 64) against prefill's per-token "
        f"logits (the step recurrence) under {FDP91_KERNEL.name}: max |diff| "
        f"{fwd['max_abs_diff']:.3e} ({fwd['max_abs_diff'] / scale:.2e} x max |logit| "
        f"{scale:.3f}; gate {SSM_FWD_TOL:g}), at the last position {fwd['last_max_abs_diff']:.3e}; "
        f"top-1 agree {100 * top1:.2f}%")
    if fwd["max_abs_diff"] > SSM_FWD_TOL * scale:
        fail(f"{cfg.name}: the chunked forward is {fwd['max_abs_diff']:.3e} from prefill, "
             f"past {SSM_FWD_TOL:g} x {scale:.3f}")
    del full, cache, stepped, diff, steps
    lap("forward_vs_prefill")
    del params
    torch.cuda.empty_cache()

    # the kernel path against the plain path at model level
    ecfg = dataclasses.replace(cfg, n_layers=eq_layers)
    eparams = init(ecfg, seed=0, device=dev)
    batch = {"tokens": torch.randint(0, V, SSM_EQ_SHAPE,
                                     generator=torch.Generator().manual_seed(2)).to(dev)}
    simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default, mode="simulate"))
    with torch.no_grad():
        with D.use_policy(FDP91_KERNEL):
            lk = forward(eparams, ecfg, batch)
        with D.use_policy(simulate):
            ls = forward(eparams, ecfg, batch)
    if lk.shape != SSM_EQ_SHAPE + (ecfg.padded_vocab,) or not torch.equal(lk, ls):
        fail(f"{cfg.name} at {eq_layers} layers: pallas != simulate logits "
             f"(max |diff| {(lk - ls).abs().max().item()})")
    log(f"  {eq_layers}-layer full-width {cfg.name} forward {SSM_EQ_SHAPE}: pallas logits "
        f"torch.equal simulate logits")
    del eparams, lk, ls
    gc.collect()
    torch.cuda.empty_cache()
    lap("pallas_vs_simulate")
    return {"layers": cfg.n_layers, "launches": launches, "dispatches_a_step": per_step,
            "calls": calls, "shapes": shapes, "fdp_serve_s": fdp_s,
            "tok_s": tok_s, "fp32_tok_s": BATCH * GEN / fp32_s,
            "zoo_tok_s": BATCH * GEN / zoo_s, "tokens": toks.tolist(),
            "trace": trace and {k: v for k, v in trace.items() if k != "top"},
            "forward_vs_prefill": fwd, "seconds": secs, "peak_gb": peak_gb}


def ssm_phase(torch, dev) -> dict:
    """Phase 23: ``ssm_model_part`` for each of SSM_ARCHS; logs the
    seconds and the peak memory by part."""
    from repro_torch.configs import get_config
    out = {}
    for arch, depth, eq_layers, zoo_file in SSM_ARCHS:
        cfg = get_config(arch)
        if depth != cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        out[arch] = ssm_model_part(torch, dev, cfg, eq_layers, zoo_file)
    log("phase 23 seconds (peak GB allocated) by part: " + "; ".join(
        f"{arch} " + ", ".join(f"{k} {v:.2f} ({r['peak_gb'][k]:.2f})"
                               for k, v in r["seconds"].items())
        for arch, r in out.items()))
    return out


def family_sites(cfg) -> dict:
    """The dense kernel's (B, M, K, N, weight broadcast) at the shapes
    ``cfg`` (whisper-large-v3 or paligemma-3b) gives it serving BATCH
    prompts of PROMPT tokens: for encdec the encoder's prefill over
    ``enc_seq`` frames (its projections and the decoder's cross K/V with
    the weight folded into the rows, and the non-causal attention over
    chunks of ``attn_chunk`` keys, the last padded), the cross-attention and
    the self-attention at decode (a cache of PROMPT + GEN positions), the
    decoder's projections and the LM head; for vlm the decode sites and the
    forward's attention and MLP over the patches and the prompt."""
    d, hd, V = cfg.d_model, cfg.head_dim, cfg.padded_vocab
    hq, hkv, G = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_heads // cfg.n_kv_heads
    bkh, smax, chunk = BATCH * cfg.n_kv_heads, PROMPT + GEN, cfg.attn_chunk
    sites = {}
    if cfg.family == "encdec":
        T = cfg.enc_seq
        sites.update({"enc attn_q/k/v/o, cross_k/v": (BATCH, T, d, hq, True),
                      "enc mlp_in/gate": (BATCH, T, d, cfg.d_ff, True),
                      "enc mlp_out": (BATCH, T, cfg.d_ff, d, True),
                      "enc attn_qk": (bkh, G * T, hd, chunk, False),
                      "enc attn_av": (bkh, G * T, chunk, hd, False),
                      "cross attn_qk": (bkh, G, hd, chunk, False),
                      "cross attn_av": (bkh, G, chunk, hd, False)})
    sites.update({"attn_q/o": (BATCH, 1, d, hq, True), "attn_k/v": (BATCH, 1, d, hkv, True),
                  "attn_qk": (bkh, G, hd, smax, False), "attn_av": (bkh, G, smax, hd, False),
                  "mlp_in/gate": (BATCH, 1, d, cfg.d_ff, True),
                  "mlp_out": (BATCH, 1, cfg.d_ff, d, True), "lm_head": (BATCH, 1, d, V, True)})
    if cfg.family == "vlm":
        S = cfg.n_patches + PROMPT
        sites.update({"fwd attn_qk": (bkh, G * S, hd, chunk, False),
                      "fwd attn_av": (bkh, G * S, chunk, hd, False),
                      "fwd mlp_in/gate": (BATCH, S, d, cfg.d_ff, True)})
    return sites


def family_dispatches(cfg) -> tuple:
    """(FDP dispatches of the prefill before its steps, of a decode step)
    of whisper-large-v3 or paligemma-3b under a policy with every site FDP.
    A decode step: self-attention q, k, v, qk, av, o; for encdec the
    cross-attention q, o and qk, av a chunk of the encoder's keys; the MLP;
    then the LM head. An encdec prefill runs the encoder (q, k, v, o, the
    MLP and qk, av a chunk) and each decoder layer's cross_k and cross_v."""
    mlp = 3 if cfg.d_ff else 0
    if cfg.family != "encdec":
        return 0, cfg.n_layers * (6 + mlp) + 1
    nc = -(-cfg.enc_seq // cfg.attn_chunk)
    return (cfg.n_enc_layers * (4 + 2 * nc + mlp) + 2 * cfg.n_layers,
            cfg.n_layers * (6 + 2 + 2 * nc + mlp) + 1)


def family_model_part(torch, dev, cfg, eq_over: dict, zoo_file: str) -> dict:
    """Phase 24 on whisper-large-v3 (encdec) or paligemma-3b (vlm) at
    published widths, drawn from seed 0: the dense kernel at
    ``family_sites`` (the plain version on FAMILY_CHECK_ROWS rows and
    FAMILY_CHECK_COLS columns of each); a serve of BATCH x PROMPT prompts,
    GEN generated, under FDP91_KERNEL with the launch count set to 0 just
    before and read just after (== FDP dispatches == ``family_dispatches``):
    for encdec prefill + greedy ``decode_step`` with 0.5 x normal frames
    (``launch.serve.serve`` gives zero frames: run once apart), for vlm
    ``launch.serve.serve``; the same again under torch.profiler (tokens and
    every step's logits bit-equal); under MXU_FP32 and the zoo plan (no FDP
    launch). encdec: the cached cross K/V equal a fresh ``cross_k``/
    ``cross_v`` dispatch of the encoder output; ``forward`` within
    FAMILY_FWD_TOL x max |logit| of prefill's step logits. vlm: ``forward``
    of BATCH x (n_patches + PROMPT) repeats bit for bit and moving the
    patches moves the text logits; a ContinuousBatcher graph engine of
    BATCH slots gives the serve's tokens. Then ``pallas`` == ``simulate``
    logits on a draw cut by ``eq_over`` (FAMILY_EQ_SHAPE tokens). Frees the
    weights. Returns its numbers, and seconds and peak memory by part."""
    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import forward, init
    from repro_torch.models import transformer as T
    secs, peak_gb, clock = {}, {}, [time.perf_counter()]
    encdec = cfg.family == "encdec"
    V = cfg.vocab_size

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - clock[0]
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        clock[0] = now
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    params = init(cfg, seed=0, device=dev)          # no host copy: nothing draws it again
    torch.cuda.synchronize()
    lap("draw")
    depth = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if encdec else f"{cfg.n_layers}")
    log(f"init {cfg.name} at {depth} layers, full width: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} G f32 parameters drawn in "
        f"{secs['draw']:.2f} s")
    log(f"{cfg.name}: the dense kernel at its new shapes")
    shapes = kernel_shapes(torch, dev, cfg.name, family_sites(cfg),
                           torch.Generator(device=dev).manual_seed(24),
                           FAMILY_CHECK_ROWS, FAMILY_CHECK_COLS)
    lap("kernel_shapes")

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    extra, width = ("frames", cfg.enc_seq) if encdec else ("patches", cfg.n_patches)
    extras = (0.5 * torch.randn((BATCH, width, cfg.d_model),
                                generator=torch.Generator().manual_seed(24))).to(dev)
    zoo = D.policy_from_plan(os.path.join(ROOT, "examples", "plans", zoo_file))

    def greedy():
        """encdec: prefill with ``extras`` as frames, then GEN greedy
        steps, as ``serve`` steps; vlm: ``serve`` itself. (tokens, every
        step's logits on the host, the cache or None)."""
        if not encdec:
            with recording_serve(torch, T) as pre_steps, \
                    recording_serve(torch, serve_mod) as steps:
                toks = serve_mod.serve(cfg, params, prompts, GEN, device=dev)
            return toks, torch.stack([x[:, 0] for x in pre_steps + steps], 1), None
        cache = T.init_cache(cfg, BATCH, PROMPT + GEN, dtype=torch.float32, device=dev)
        with recording_serve(torch, T) as steps:
            last, cache = T.prefill(params, cfg, {"tokens": prompts.to(dev), extra: extras},
                                    cache)
            tok, out = torch.argmax(last, dim=-1)[:, None], []
            for _ in range(GEN):
                out.append(tok)
                logits, cache = T.decode_step(params, cfg, cache, tok)
                tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        return torch.cat(out, 1), torch.stack([x[:, 0] for x in steps], 1), cache

    def one_serve(policy):
        with D.use_policy(policy):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = greedy()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

    pre, per_step = family_dispatches(cfg)
    expected = pre + (PROMPT + GEN) * per_step
    D.reset_sites_seen()
    K.fdp_gemm.launches = 0
    (toks, logits, cache), fdp_s = one_serve(FDP91_KERNEL)
    launches = K.fdp_gemm.launches
    calls = D.site_calls()
    n_fdp = sum(calls.values())
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 or int(toks.max()) >= V:
        fail(f"{cfg.name}: served tokens malformed: shape {tuple(toks.shape)}")
    if logits.shape != (BATCH, PROMPT + GEN, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits[..., :V]).all()):
        fail(f"{cfg.name}: step logits {tuple(logits.shape)} malformed or not finite")
    if not launches == n_fdp == expected:
        fail(f"{cfg.name}: dense launches {launches}, FDP dispatches {n_fdp}, expected "
             f"{pre} + {PROMPT + GEN} steps x {per_step} = {expected}")
    held = {}

    def traced_serve():
        held["out"], wall = one_serve(FDP91_KERNEL)
        return held["out"], wall

    trace = trace_serve(torch, traced_serve)
    again, logits_again, cache_again = held["out"]
    if not torch.equal(again, toks) or not torch.equal(logits_again, logits):
        fail(f"{cfg.name}: a second FDP91_KERNEL serve differs (tokens equal "
             f"{torch.equal(again, toks)}, step logits equal "
             f"{torch.equal(logits_again, logits)})")
    del cache_again
    (toks32, logits32, _), fp32_s = one_serve(D.MXU_FP32)
    D.reset_sites_seen()
    before = K.fdp_gemm.launches
    (toks_zoo, _, _), zoo_s = one_serve(zoo)
    zoo_calls = D.site_calls()
    if K.fdp_gemm.launches != before or sum(zoo_calls.values()) != n_fdp:
        fail(f"{cfg.name}: the zoo plan launched the FDP kernel or dispatched "
             f"{sum(zoo_calls.values())} GEMMs, not {n_fdp}")
    res = {}
    if encdec:
        # the reference-shaped serve: zero frames, from launch.serve.serve
        with D.use_policy(FDP91_KERNEL):
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks_zero = serve_mod.serve(cfg, params, prompts, GEN, device=dev)
            torch.cuda.synchronize()
            res["zero_frames_serve"] = {"s": time.perf_counter() - t, "tokens_agree": float(
                (toks_zero == toks).float().mean())}
        log(f"  launch.serve.serve (zero frames, as the reference's) under "
            f"{FDP91_KERNEL.name}: {res['zero_frames_serve']['s']:.3f} s = "
            f"{BATCH * GEN / res['zero_frames_serve']['s']:.2f} tok/s; tokens agree with the "
            f"frames' serve {100 * res['zero_frames_serve']['tokens_agree']:.1f}%")
    lap("serves")
    tok_s = BATCH * GEN / fdp_s
    log(f"serve {cfg.name} ({depth} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {V}"
        + (f", enc_seq {cfg.enc_seq}" if encdec else f", {cfg.n_patches} patches")
        + f") under {FDP91_KERNEL.name}: batch {BATCH} prompt {PROMPT} gen {GEN}"
        + (" with 0.5 x normal frames (prefill + greedy decode_step)" if encdec else
           " (launch.serve.serve, zero patches)")
        + f"; dense launches {launches} == FDP dispatches {n_fdp} == {pre} + "
        f"{PROMPT + GEN} steps x {per_step}; {fdp_s:.3f} s = {tok_s:.2f} tok/s (each step's "
        f"logits copied to the host); a second, traced run repeats the tokens and every "
        f"step's logits bit for bit")
    log(f"  {D.MXU_FP32.name}: {fp32_s:.3f} s = {BATCH * GEN / fp32_s:.2f} tok/s, tokens agree "
        f"{100 * float((toks32 == toks).float().mean()):.1f}%, last logits max |diff| "
        f"{(logits32 - logits)[:, -1, :V].abs().max().item():.3e}; zoo plan {zoo.name!r} "
        f"(examples/plans/{zoo_file}, unchanged, every site native): {zoo_s:.3f} s = "
        f"{BATCH * GEN / zoo_s:.2f} tok/s, 0 FDP launches, tokens agree "
        f"{100 * float((toks_zoo == toks).float().mean()):.1f}%")
    if trace is None:
        log("  traced serve: torch.profiler recorded no device events; device busy and "
            "idle share not measured")
    else:
        log(f"  traced {FDP91_KERNEL.name} serve (torch.profiler): wall {trace['wall_s']:.3f} s, "
            f"device busy {trace['device_busy_s']:.3f} s, idle share "
            f"{100 * trace['idle_share']:.1f}%, {trace['device_events']} device events; "
            f"dense kernel {trace['kernels']['fdp_gemm']['count']} in "
            f"{trace['kernels']['fdp_gemm']['s']:.3f} s, outside it "
            f"{trace['device_busy_s'] - trace['fdp_kernel_s']:.3f} s busy; top: "
            + "; ".join(f"{n} {x:.3f} s" for n, x in trace["top"]))

    if encdec:
        with D.use_policy(FDP91_KERNEL), torch.no_grad():
            enc = T._encode(params, cfg, extras)
            for i, blk in enumerate(params.dec_layers):
                kc, vc = T._cross_kv(enc, blk, cfg)
                if not (torch.equal(cache["cross"]["k"][i], kc)
                        and torch.equal(cache["cross"]["v"][i], vc)):
                    fail(f"{cfg.name}: decoder layer {i}'s cached cross K/V != a fresh "
                         f"cross_k/cross_v dispatch of the encoder output")
            del enc, kc, vc, cache
            full = forward(params, cfg, {"tokens": prompts.to(dev), extra: extras})[..., :V]
        stepped = logits[:, :PROMPT, :V]
        if full.shape != stepped.shape or not bool(torch.isfinite(full).all()):
            fail(f"{cfg.name}: forward's logits {tuple(full.shape)} malformed or not finite")
        diff = (full.cpu() - stepped).abs()
        scale = stepped.abs().max().item()
        top1 = float((full.cpu().argmax(-1) == stepped.argmax(-1)).float().mean())
        res["forward_vs_prefill"] = {
            "max_abs_diff": diff.max().item(), "last_max_abs_diff": diff[:, -1].max().item(),
            "max_abs_logit": scale, "tol": FAMILY_FWD_TOL, "top1_agree": top1}
        log(f"  the cached cross K/V of all {cfg.n_layers} decoder layers torch.equal a fresh "
            f"cross_k/cross_v dispatch of the encoder output; forward {(BATCH, PROMPT)} "
            f"against prefill's per-token logits under {FDP91_KERNEL.name}: max |diff| "
            f"{diff.max().item():.3e} ({diff.max().item() / scale:.2e} x max |logit| "
            f"{scale:.3f}; gate {FAMILY_FWD_TOL:g}), at the last position "
            f"{diff[:, -1].max().item():.3e}; top-1 agree {100 * top1:.2f}%")
        if diff.max().item() > FAMILY_FWD_TOL * scale:
            fail(f"{cfg.name}: forward is {diff.max().item():.3e} from prefill, past "
                 f"{FAMILY_FWD_TOL:g} x {scale:.3f}")
        del full, stepped, diff
        lap("forward_vs_prefill")
    else:
        batch = {"tokens": prompts.to(dev), extra: extras}
        with D.use_policy(FDP91_KERNEL), torch.no_grad():
            first = forward(params, cfg, batch)
            second = forward(params, cfg, batch)
            moved = forward(params, cfg, dict(batch, patches=extras + 1.0))
        S = cfg.n_patches + PROMPT
        text_diff = (first[:, cfg.n_patches:, :V] - moved[:, cfg.n_patches:, :V]).abs().max()
        if first.shape != (BATCH, S, cfg.padded_vocab) or not bool(
                torch.isfinite(first[..., :V]).all()):
            fail(f"{cfg.name}: forward's logits {tuple(first.shape)} malformed or not finite")
        if not torch.equal(first, second):
            fail(f"{cfg.name}: a second forward of {(BATCH, S)} positions differs")
        if not text_diff.item() > 1e-4:
            fail(f"{cfg.name}: moving the patches by 1.0 moved the text logits by "
                 f"{text_diff.item():.3e} only")
        res["forward"] = {"positions": S, "patches_move_text_logits": text_diff.item()}
        log(f"  forward of {BATCH} x ({cfg.n_patches} patches + {PROMPT} tokens) under "
            f"{FDP91_KERNEL.name}: repeats bit for bit; the patches + 1.0 move the text "
            f"logits by up to {text_diff.item():.3e} (the prefix reaches the text)")
        del first, second, moved
        lap("forward")
        from repro_torch.launch.batching import ContinuousBatcher, Request
        K.fdp_gemm.launches = K.fdp_gemm.captured = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = ContinuousBatcher(cfg, params, n_slots=BATCH, max_len=PROMPT + 2 * GEN + 2,
                                warmup=FDP91_KERNEL)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        reqs = [Request(uid=i, prompt=row.tolist(), max_new=GEN)
                for i, row in enumerate(prompts)]
        t = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        eng_s = time.perf_counter() - t
        eng_toks = torch.tensor([r.out for r in reqs])
        if eng.capture_count != 1 or eng.step_launches != {
                "fdp_gemm": sum(eng.step_dispatches.values())}:
            fail(f"{cfg.name}: graph engine captures {eng.capture_count}, launches a step "
                 f"{eng.step_launches}, FDP dispatches a step {eng.step_dispatches}")
        if not torch.equal(eng_toks, toks.cpu()):
            fail(f"{cfg.name}: the graph engine's tokens differ from the serve's")
        res["graph_engine"] = {"build_s": build_s, "run_s": eng_s,
                               "tok_s": sum(len(r.out) for r in reqs) / eng_s,
                               "warmup_launches": K.fdp_gemm.launches,
                               "captured_launches": K.fdp_gemm.captured,
                               "steps": eng.replays}
        log(f"  ContinuousBatcher, {BATCH} slots, one CUDA graph under {FDP91_KERNEL.name}: "
            f"built and captured in {build_s:.2f} s ({K.fdp_gemm.captured} launches "
            f"captured a step == its FDP dispatches), {eng.replays} replays in "
            f"{eng_s:.3f} s = {res['graph_engine']['tok_s']:.2f} tok/s; tokens equal the "
            f"serve's")
        del eng
        lap("graph_engine")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel path against the plain path at model level
    ecfg = dataclasses.replace(cfg, **eq_over)
    eparams = init(ecfg, seed=0, device=dev)
    batch = {"tokens": torch.randint(0, V, FAMILY_EQ_SHAPE,
                                     generator=torch.Generator().manual_seed(2)).to(dev),
             extra: (0.5 * torch.randn((FAMILY_EQ_SHAPE[0], getattr(ecfg, (
                 "enc_seq" if encdec else "n_patches")), cfg.d_model),
                 generator=torch.Generator().manual_seed(3))).to(dev)}
    simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default, mode="simulate"))
    with torch.no_grad():
        with D.use_policy(FDP91_KERNEL):
            lk = forward(eparams, ecfg, batch)
        with D.use_policy(simulate):
            ls = forward(eparams, ecfg, batch)
    n_pos = FAMILY_EQ_SHAPE[1] + (0 if encdec else ecfg.n_patches)
    if lk.shape != (FAMILY_EQ_SHAPE[0], n_pos, ecfg.padded_vocab) or not torch.equal(lk, ls):
        fail(f"{cfg.name} cut to {eq_over}: pallas != simulate logits "
             f"(max |diff| {(lk - ls).abs().max().item()})")
    log(f"  {cfg.name} cut to {eq_over}, full width, forward {FAMILY_EQ_SHAPE} + {extra}: "
        f"pallas logits torch.equal simulate logits")
    del eparams, lk, ls
    gc.collect()
    torch.cuda.empty_cache()
    lap("pallas_vs_simulate")
    return {"depth": depth, "launches": launches, "dispatches": {"prefill": pre,
                                                                 "a_step": per_step},
            "calls": calls, "shapes": shapes, "fdp_serve_s": fdp_s, "tok_s": tok_s,
            "fp32_tok_s": BATCH * GEN / fp32_s, "zoo_tok_s": BATCH * GEN / zoo_s,
            "tokens": toks.tolist(),
            "trace": trace and {k: v for k, v in trace.items() if k != "top"},
            **res, "seconds": secs, "peak_gb": peak_gb}


def family_phase(torch, dev) -> dict:
    """Phase 24: ``family_model_part`` for each of FAMILY_ARCHS; logs the
    seconds and the peak memory by part."""
    from repro_torch.configs import get_config
    out = {}
    for arch, cut, eq_over, zoo_file in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch), **cut)
        out[arch] = family_model_part(torch, dev, cfg, eq_over, zoo_file)
    log("phase 24 seconds (peak GB allocated) by part: " + "; ".join(
        f"{arch} " + ", ".join(f"{k} {v:.2f} ({r['peak_gb'][k]:.2f})"
                               for k, v in r["seconds"].items())
        for arch, r in out.items()))
    return out


def place_rank(dev, cfg, prompts, want: list) -> dict:
    """Phase 25 on one rank of the 2x2 world (module docstring): under each
    of PLACE_PROFILES the placed ``init`` (each unit drawn on the host, cut
    to the rank's blocks, then moved), its bytes on the card beside
    ``param_shardings``' figure, and one serve of ``prompts`` with the dense
    kernel's launches set to 0 just before and read just after, against the
    one-process serve's tokens ``want``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import dispatch as D
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.launch.sharding import distribution_for, make_mesh, param_shardings
    from repro_torch.models import init
    from repro_torch.models.transformer import init_abstract
    from repro_torch.parallel.placement import STATS

    mesh = make_mesh((2, 2))
    out = {"rank": dist.get_rank(), "coords": mesh.coords, "backends": mesh.backends(),
           "profiles": {}}
    # the Megatron MLP's K-split at decode is a reduce dispatch: plain limbs
    # + fdp_psum, no kernel launch (as in phase 22)
    reduce_calls = [0]
    dispatch_reduce = D._dispatch_reduce

    def counted_reduce(*args, **kw):
        reduce_calls[0] += 1
        return dispatch_reduce(*args, **kw)

    D._dispatch_reduce = counted_reduce
    prompts = prompts.to(dev)
    dtype = getattr(torch, cfg.param_dtype)
    for profile in PLACE_PROFILES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = distribution_for(mesh, profile, FDP91_KERNEL)
        params = init(cfg, 0, device=dev, dist=d, profile=profile)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held = list(params.parameters())
        spec_bytes = sum(pl.nbytes(dtype) for pl in
                         param_shardings(cfg, init_abstract(cfg), mesh, profile).values())
        res = {"init_s": init_s, "spec_bytes": spec_bytes,
               "on_card": sum(p.numel() * p.element_size() for p in held if p.device == dev),
               "off_card": sum(p.numel() for p in held if p.device != dev)}
        del held
        torch.cuda.reset_peak_memory_stats(dev)
        D.reset_sites_seen()
        reduce_calls[0] = 0
        K.fdp_gemm.launches = 0
        STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with D.use_policy(FDP91_KERNEL):
            toks = serve(cfg, params, prompts, PLACE_GEN, device=dev, dist=d)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = K.fdp_gemm.launches
        res["dispatches"] = sum(D.site_calls().values()) - reduce_calls[0]
        res["reduce_dispatches"] = reduce_calls[0]
        res["equal"] = toks.tolist() == want
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["gathers"] = STATS.snapshot()
        out["profiles"][profile] = res
        del params, toks
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    D._dispatch_reduce = dispatch_reduce
    return out


def place_phase(torch, dev) -> dict:
    """Phase 25 (module docstring): the one-process serve in the main
    process, the 2x2 world (``place_rank``), its gates and numbers, then the
    CLI with and without ``--mesh``. Returns the launches by profile and the
    phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.models import init
    from repro_torch.models.transformer import init_abstract
    from repro_torch.parallel.placement import placed_bytes

    seconds = {}
    t = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=PLACE_LAYERS)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PLACE_PROMPT),
                            generator=torch.Generator().manual_seed(1))
    # what earlier phases left allocated in this process is not the serve's
    base = torch.cuda.memory_allocated(dev)
    params = init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with D.use_policy(FDP91_KERNEL):
        want = serve(cfg, params, prompts, PLACE_GEN, device=dev).tolist()
    torch.cuda.synchronize()
    replicated_peak = torch.cuda.max_memory_allocated(dev) - base
    replicated = placed_bytes(params)
    if replicated != placed_bytes(init_abstract(cfg)):
        fail("qwen3-0.6b's one-process parameters != init_abstract's bytes")
    del params
    torch.cuda.empty_cache()
    seconds["one-process serve"] = time.perf_counter() - t

    t = time.perf_counter()
    ranks = spawn(place_rank, 4, device="cuda:0", args=(cfg, prompts, want),
                  timeout=PLACE_TIMEOUT, collective_timeout=PLACE_COLLECTIVE_TIMEOUT)
    seconds["2x2 world"] = time.perf_counter() - t
    launches = {}
    for r in ranks:
        tag = f"rank {r['rank']} {r['coords']}"
        if set(r["backends"].values()) != {"gloo"}:
            fail(f"{tag}: the 2x2 mesh's groups run {r['backends']}, not gloo")
        for profile, res in r["profiles"].items():
            if res["off_card"] or res["on_card"] != res["spec_bytes"]:
                fail(f"{tag} {profile}: {res['on_card']} bytes of placed parameters on the "
                     f"card ({res['off_card']} elements elsewhere), param_shardings says "
                     f"{res['spec_bytes']}")
            if not res["equal"]:
                fail(f"{tag} {profile}: the placed serve's tokens != the one-process "
                     f"serve's {want}")
            if res["launches"] <= 0 or res["launches"] != res["dispatches"]:
                fail(f"{tag} {profile}: the placed serve launched the dense kernel "
                     f"{res['launches']} times, its FDP dispatches were {res['dispatches']}")
            if res["gathers"]["calls"] <= 0:
                fail(f"{tag} {profile}: the placed serve gathered nothing")
            launches[profile] = launches.get(profile, 0) + res["launches"]
    steps = PLACE_PROMPT + PLACE_GEN       # prefill runs a decode step a prompt token
    log(f"(a) qwen3-0.6b at full width, {PLACE_LAYERS} layers, placed on 2x2 (four ranks on "
        f"the card, gloo): {BATCH} x {PLACE_PROMPT} prompts, {PLACE_GEN} tokens, FDP91_KERNEL; "
        f"tokens == the one-process serve's on every rank, launches == FDP dispatches, "
        f"placed bytes on the card == param_shardings'. The one-process serve: parameters "
        f"{replicated} B, peak {replicated_peak / 1e9:.4f} GB above what earlier phases "
        f"left allocated")
    for profile in PLACE_PROFILES:
        for r in ranks:
            res = r["profiles"][profile]
            g = res["gathers"]
            log(f"  {profile} rank {r['rank']} {r['coords']}: placed {res['on_card']} B "
                f"(replicated {replicated} B), peak {res['peak_bytes'] / 1e9:.4f} "
                f"GB, gathered {g['bytes'] / steps / 1e9:.4f} GB a decode step ({steps} "
                f"steps, {g['received'] / steps / 1e9:.4f} GB received, {g['calls']} "
                f"leaves, gathered alive at once at most {g['peak_live'] / 1e9:.4f} GB), "
                f"{g['seconds']:.2f} s in gathers of {res['seconds']:.2f} s serving "
                f"({BATCH * PLACE_GEN / res['seconds']:.3f} tok/s), launches {res['launches']} "
                f"== dispatches {res['dispatches']} (+ {res['reduce_dispatches']} reduce "
                f"dispatches), init {res['init_s']:.2f} s")

    # -- (b) the CLI with and without --mesh ------------------------------------
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = {}
    for name, extra in (("mesh", ("--mesh", "2x2", "--profile", "fsdp")), ("one process", ())):
        t = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *PLACE_CLI, *extra]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=PLACE_TIMEOUT)
        if proc.returncode != 0:
            fail(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stdout}\n"
                 f"{proc.stderr[-4000:]}")
        seconds[f"CLI, {name}"] = time.perf_counter() - t
        cli[name] = {"cmd": " ".join(cmd[1:]), "stdout": proc.stdout,
                     "sample": [l for l in proc.stdout.splitlines() if l.startswith("sample:")]}
    if len(cli["mesh"]["sample"]) != 1 or cli["mesh"]["sample"] != cli["one process"]["sample"]:
        fail(f"the CLI's tokens with --mesh 2x2 {cli['mesh']['sample']} != without "
             f"{cli['one process']['sample']}")
    if "mesh 2x2 (data gloo, model gloo) profile=fsdp: placed" not in cli["mesh"]["stdout"]:
        fail(f"the CLI with --mesh printed no placement line:\n{cli['mesh']['stdout']}")
    log(f"(b) {cli['mesh']['cmd']}: rc 0, tokens == the same command without --mesh:")
    for line in cli["mesh"]["stdout"].splitlines():
        log("    " + line)
    log("phase 25 seconds by part: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"launches": launches, "replicated_bytes": replicated,
            "replicated_peak_bytes": replicated_peak, "seconds": seconds,
            "ranks": ranks, "cli": {k: v["sample"] for k, v in cli.items()}}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        fail(f"imported {repro_torch.__file__}, not the checkout's package")
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.accumulator import SAFE_CHUNK, AccumulatorSpec
    from repro_torch.core.formats import BF16, FP32, POSIT16_1, PositFormat
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.kernels import ops, ragged_times
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.core.qformat import parse_quant
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import forward, init
    from repro_torch.train import optimizer as TO
    from repro_torch.train.loop import InjectedFailure, Trainer, make_loss_fn, make_train_step
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.workloads import PROBE_BATCH, PROBE_SEQ

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # -- 1. the card and the build ------------------------------------------
    phase("1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    # what ptxas made of the three tiled kernels, dense, sorted-segment
    # forward and weight gradient (registers, spills, instructions a
    # product), compiled beside the build
    sass_proc = subprocess.Popen([sys.executable, "-m", "repro_torch.kernels.sass_report"],
                                 cwd=ROOT, env={**os.environ, "PYTHONPATH": src},
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    libs = K.load()
    log(f"built and loaded the FDP kernels {sorted(libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    sass_out, sass_err = sass_proc.communicate()
    if sass_proc.returncode != 0:
        fail(f"sass_report failed: {sass_err[-2000:]}")
    sass = {"fdp_gemm.cu": [], "fdp_ragged_gemm.cu": [], "fdp_ragged_dw.cu": []}
    sass_kind = {"fdp_gemm.cu": "dense", "fdp_ragged_gemm.cu": "sorted-segment",
                 "fdp_ragged_dw.cu": "weight-gradient"}
    for line in sass_out.splitlines():
        r = json.loads(line)
        lc, tm, rne, masked = r["template"]
        loop = r["product_loop"] or {}
        sass[r["source"]].append({"lc": lc, "tm": tm, "rne": rne, "masked": masked,
                                  "registers": r["registers"],
                                  "spill_bytes": r["spill_stores"] + r["spill_loads"],
                                  "loop_instructions": loop.get("instructions"),
                                  "loop_products": loop.get("products"),
                                  "instructions_per_product": loop.get("per_product")})
        log(f"{sass_kind[r['source']]} kernel LC={lc} TM={tm} rne={rne} masked={masked}: "
            f"{r['registers']} registers, "
            f"spills {r['spill_stores']}/{r['spill_loads']} bytes; product loop "
            f"{loop.get('instructions')} instructions for {loop.get('products')} products = "
            f"{loop.get('per_product', 0):.2f} a product")
    if any(len(rows) != 76 for rows in sass.values()):
        fail(f"sass_report read {[len(rows) for rows in sass.values()]} instantiations of "
             f"the dense, sorted-segment and weight-gradient kernels, not 76 each")

    # -- 2. kernels vs plain versions on the card ----------------------------
    phase("2")
    P91 = AccumulatorSpec.paper_91bit()
    RNE = AccumulatorSpec(30, 30, -30, round_mode="rne")
    SAT = AccumulatorSpec(2, 4, -20, overflow_mode="saturate")
    F3 = AccumulatorSpec(ovf=9, msb=6, lsb=-20)          # the paper's Fig.-3 pick
    F3_SAT = AccumulatorSpec(9, 6, -20, overflow_mode="saturate")
    ONE = AccumulatorSpec(2, 5, -8)                      # 16 bits, 1 limb
    WIDE = AccumulatorSpec(100, 200, -100, round_mode="rne")   # 401 bits, 26 limbs
    WIDE12 = AccumulatorSpec(60, 60, -60)                # 181 bits, 12 limbs
    gen = torch.Generator(device=dev).manual_seed(0)

    def on_grid(fmt, *ts):
        if isinstance(fmt, PositFormat):
            return [fmt.from_float(t) for t in ts]
        return [fmt.quantize(t) for t in ts]

    def operands(B, M, Kd, N, fmt, a_scale=1.0, b_scale=1.0, bcast=False,
                 positive=False, ta=False, tb=False):
        a = torch.randn(B, M, Kd, generator=gen, device=dev) * a_scale
        b = torch.randn(1 if bcast else B, Kd, N, generator=gen, device=dev) * b_scale
        if positive:
            a, b = a.abs(), b.abs()
        a, b = on_grid(fmt, a, b)
        if ta:                                           # transposed views
            a = a.transpose(1, 2).contiguous().transpose(1, 2)
        if tb:
            b = b.transpose(1, 2).contiguous().transpose(1, 2)
        return a, (b.expand(B, Kd, N) if bcast else b)

    def n_saturated(got, spec):
        # the register's extremes, rounded to f32 as the read-out does
        hi = torch.tensor((2 ** (spec.width - 1) - 1) * 2.0 ** spec.lsb).float()
        lo = -(2 ** (spec.width - 1)) * 2.0 ** spec.lsb
        n_sat = int(((got == hi.item()) | (got == lo)).sum())
        if n_sat == 0:
            fail("the saturate case never saturated")
        return n_sat

    # the slice's decode shapes at full width: (B, M, K, N) per site
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=QWEN_LAYERS)
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    smax, G = PROMPT + GEN, cfg.n_heads // cfg.n_kv_heads
    bkh = BATCH * cfg.n_kv_heads
    SITES = {
        "attn_q": (BATCH, 1, d, hq), "attn_k": (BATCH, 1, d, hkv),
        "attn_v": (BATCH, 1, d, hkv), "attn_qk": (bkh, G, cfg.head_dim, smax),
        "attn_av": (bkh, G, smax, cfg.head_dim), "attn_o": (BATCH, 1, hq, d),
        "mlp_in": (BATCH, 1, d, f), "mlp_gate": (BATCH, 1, d, f),
        "mlp_out": (BATCH, 1, f, d), "lm_head": (BATCH, 1, d, V),
    }
    weight_sites = {"attn_q", "attn_k", "attn_v", "attn_o", "mlp_in", "mlp_gate",
                    "mlp_out", "lm_head"}
    cases = [
        ("fp32 91-bit ragged", (3, 5, 70, 9), FP32, P91, {}),
        ("bf16 91-bit ragged", (2, 17, 300, 33), BF16, P91, {}),
        ("posit16_1 91-bit", (2, 4, 64, 40), POSIT16_1, P91, {}),
        ("fp32 rne", (2, 4, 200, 40), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (2, 4, 200, 40), FP32, SAT, {"a_scale": 4.0}),
        ("fp32 stride-0 weight that folds into the rows", (4, 7, 96, 33), FP32, P91,
         {"bcast": True}),
        ("fp32 stride-0 weight, a transposed so that it does not fold", (4, 7, 96, 33),
         FP32, P91, {"bcast": True, "ta": True}),
        ("fp32 <9,6,-20> (3 limbs, capacity 4)", (3, 17, 150, 45), FP32, F3, {}),
        ("fp32 saturate <9,6,-20>, products past the top limb", (2, 4, 200, 40), FP32,
         F3_SAT, {"a_scale": 3e6}),
        ("fp32 1-limb <2,5,-8> (capacity 2)", (2, 9, 100, 37), FP32, ONE, {"a_scale": 8.0}),
        ("fp32 1 row a batch element (a thread tile of 1 row)", (3, 1, 100, 37), FP32, P91,
         {}),
        ("fp32 saturate <9,6,-20>, 2 rows a batch element (a thread tile of 2 rows)",
         (5, 2, 130, 21), FP32, F3_SAT, {"a_scale": 3e6}),
        ("fp32 <60,60,-60> (12 limbs, capacity 12), 1 row a batch element", (3, 1, 90, 19),
         FP32, WIDE12, {"a_scale": 1e10}),
        ("fp32 401-bit rne (26 limbs, capacity 32, one output a thread)", (1, 37, 170, 29),
         FP32, WIDE, {"a_scale": 1e20}),
        ("fp32 tiles ragged in M, N and K", (1, 37, 333, 71), FP32, P91, {}),
        ("fp32 transposed a and b", (2, 33, 257, 65), FP32, P91, {"ta": True, "tb": True}),
        # one output, so however the launcher splits K (at most 256 ways) each
        # register takes more than SAFE_CHUNK positive products, across many
        # chunks of BK
        ("fp32 K past 256 x SAFE_CHUNK, positive", (1, 1, 256 * SAFE_CHUNK + 37, 2), FP32,
         P91, {"positive": True}),
    ]
    for site, (B, M, Kd, N) in SITES.items():
        kw = ({"b_scale": Kd ** -0.5, "bcast": True} if site in weight_sites
              else {"b_scale": 1.0})
        cases.append((f"decode {site}", (B, M, Kd, N), FP32, P91, kw))
    max_err = 0.0
    for name, (B, M, Kd, N), fmt, spec, kw in cases:
        a, b = operands(B, M, Kd, N, fmt, **kw)
        want = K.fdp_gemm_plain(a, b, spec=spec, fmt=fmt)
        got = K.fdp_gemm(a, b, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"kernel != plain for {name} {(B, M, Kd, N)}: max |diff| {err}")
        saturating = spec.overflow_mode == "saturate"
        extra = f", {n_saturated(got, spec)} outputs saturated" if saturating else ""
        ka, _, lay = K.dense_plan(a, b, spec.num_limbs, sms)
        folded = ka is not a
        rows = ka.shape[1]
        bm, bn, bk = lay.tile
        if kw.get("bcast") and folded == kw.get("ta", False):
            fail(f"{name}: dense_plan folded: {folded}")
        if lay.tm > 1 and lay.tm >= 2 * rows:
            fail(f"{name}: a thread owns {lay.tm} rows of a call with {rows}")
        if name.startswith("fp32 tiles ragged") and not (rows % bm and N % bn and Kd % bk):
            fail(f"{name}: tile {lay.tile} divides {(rows, N, Kd)}")
        # K slice 0 takes bks k of every chunk of bk, and the first of the last
        first_slice = Kd // bk * lay.bks + min(lay.bks, Kd % bk)
        if "SAFE_CHUNK" in name and first_slice <= SAFE_CHUNK:
            fail(f"{name}: K slice 0's registers take only {first_slice} products")
        max_err = max(max_err, err)
        log(f"kernel == plain (torch.equal): {name} {(B, M, Kd, N)} "
            f"{fmt.name} {spec.describe()}{extra}; capacity {lay.lc}, "
            f"{'folded to ' + str((1, rows, Kd)) + ', ' if folded else ''}"
            f"tile {lay.tile}, {lay.tm}x{lay.tn} outputs a thread, K split {lay.ks}")

    # the full-width dbrx training LM head forward: whole, against the plain
    # version on its first 64 columns
    dcfg = get_config("dbrx-132b")
    head_a, head_b = operands(1, TRAIN_BATCH * TRAIN_SEQ, dcfg.d_model, dcfg.padded_vocab, FP32,
                              b_scale=dcfg.d_model ** -0.5)
    got = K.fdp_gemm(head_a, head_b, spec=P91, fmt=FP32)[..., :64]
    want = K.fdp_gemm_plain(head_a, head_b[..., :64], spec=P91, fmt=FP32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"kernel != plain at the training LM head forward's first 64 columns: max "
             f"|diff| {(got - want).abs().max().item()}")
    log(f"kernel == plain (torch.equal): dbrx-132b training LM head forward "
        f"{tuple(head_a.shape)} @ {tuple(head_b.shape)} on its first 64 columns")
    del got, want

    # the dense kernel's times at the main path's shapes, at 91 bits and at
    # <9,6,-20> on the same inputs, beside the bound (at the small shapes a
    # call's host work outlasts its kernel, so the CUDA-event time there is
    # the host's; kernels.dense_times reads device times); the log line also
    # quotes the time of the earlier dense kernel (one thread column an
    # output, limbs placed by compare-and-select) from PERF.md section 6,
    # which this run did not measure and the JSON line does not hold
    def dense_timed(name, a, b, reps, earlier_ms=None, call=None):
        call = call or (lambda spec: K.fdp_gemm(a, b, spec=spec, fmt=FP32))
        B, M, Kd = a.shape[-3:] if a.ndim == 3 else (1, *a.shape)
        N = b.shape[-1]
        w_elems = Kd * N * (1 if b.ndim == 2 or b.stride(0) == 0 else B)
        ops_n = K.int32_ops(B * M * Kd, w_elems, B * M * Kd * N)
        r = {"shape": [B, M, Kd, N], "ms": cuda_ms(torch, lambda: call(P91), reps=reps),
             "ms_fig3": cuda_ms(torch, lambda: call(F3), reps=reps),
             **bound(4 * (B * M * Kd + w_elems + B * M * N), ops_n)}
        log(f"dense kernel at {name} {tuple(r['shape'])}: {P91.describe()} {r['ms']:.4f} ms "
            f"= {100 * r['bound_ms'] / r['ms']:.1f}% of its bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); {F3.describe()} {r['ms_fig3']:.4f} ms = "
            f"{r['ms_fig3'] / r['ms']:.3f}x; the earlier dense kernel: "
            + (f"{earlier_ms} ms (PERF.md section 6)" if earlier_ms
               else "not timed"))
        return r

    dense = {"dbrx train lm_head forward": dense_timed(
        "dbrx train lm_head forward", head_a, head_b, reps=2)}
    del head_a, head_b
    for name, (B, M, Kd, N), bcast, earlier in (
            ("qwen lm_head decode", (BATCH, 1, d, V), True, 3.6734),
            ("qwen mlp_in decode", (BATCH, 1, d, f), True, 0.0995),
            ("qwen mlp_in prefill", (BATCH, PROMPT, d, f), True, 1.2052),
            ("bench hot shape", (1, 256, 1024, 256), False, 0.4386)):
        a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5, bcast=bcast)
        dense[name] = dense_timed(name, a, b, reps=20 if N > 10 ** 5 else 50,
                                  earlier_ms=earlier)
    # attention at decode: a few rows a head group (qwen 2, dbrx 6), so a
    # thread owns fewer rows than its capacity's most
    for model in ("qwen3-0.6b", "dbrx-132b"):
        acfg = get_config(model)
        ag, abkh = acfg.n_heads // acfg.n_kv_heads, BATCH * acfg.n_kv_heads
        for site, (Kd, N) in (("attn_qk", (acfg.head_dim, smax)),
                              ("attn_av", (smax, acfg.head_dim))):
            name = f"{model.split('-')[0]} {site} decode"
            a, b = operands(abkh, ag, Kd, N, FP32)
            dense[name] = dense_timed(name, a, b, reps=50)
    torch.cuda.empty_cache()

    # dbrx-132b at full width: the router is a 2-D call, (T, d) @ (d, E)
    mcfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    md, mf, mE, mk = mcfg.d_model, mcfg.d_ff, mcfg.n_experts, mcfg.top_k
    a, b = operands(1, BATCH, md, mE, FP32, b_scale=md ** -0.5)
    ra, rb = a[0], b[0]
    want = K.fdp_gemm_plain(ra[None], rb[None], spec=P91, fmt=FP32)[0]
    got = ops.fdp_gemm(ra, rb, spec=P91, fmt=FP32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"2-D kernel != plain at the router shape: max |diff| "
             f"{(got - want).abs().max().item()}")
    router = {**dense_timed("dbrx router (2-D, ops.fdp_gemm)", ra, rb, reps=50,
                            earlier_ms=0.4091,
                            call=lambda spec: ops.fdp_gemm(ra, rb, spec=spec, fmt=FP32)),
              "plain_ms": cuda_ms(torch, lambda: K.fdp_gemm_plain(
                  ra[None], rb[None], spec=P91, fmt=FP32), reps=3)}
    router["shape"] = [BATCH, md, mE]
    dense["dbrx router"] = router
    log(f"kernel == plain (torch.equal): router 2-D {(BATCH, md)} @ {(md, mE)} "
        f"through ops.fdp_gemm")

    def routed_sizes(tokens: int, seed: int) -> list:
        return ragged_times.routed_sizes(tokens, mE, mk, seed)

    def ragged_operands(T, dd, ff, gs, fmt, x_scale=1.0, f_cols=None, wt=False):
        x = torch.randn(T, dd, generator=gen, device=dev) * x_scale
        if wt:                                            # the dX view, (E, f, d) of (E, d, f)
            w = (torch.randn(len(gs), ff, dd, generator=gen, device=dev)
                 * dd ** -0.5).transpose(-1, -2)
        else:
            w = torch.randn(len(gs), dd, ff, generator=gen, device=dev) * dd ** -0.5
        x, w = on_grid(fmt, x, w)
        if f_cols is not None:
            w = w[:, :, :f_cols]                          # a strided column slice
        return x, w, torch.tensor(gs, dtype=torch.int32, device=dev)

    def ragged_work(T, dd, ff, gs):
        """Bytes and int32 operations this data needs: the rows that fall in
        a group and the weights of the non-empty groups, read once; the
        sizes; every output row written once."""
        rows = min(T, sum(gs))
        used = sum(1 for e, n in enumerate(gs) if n > 0 and sum(gs[:e]) < T)
        nbytes = 4 * (rows * dd + used * dd * ff + len(gs) + T * ff)
        return nbytes, K.int32_ops(rows * dd, used * dd * ff, rows * dd * ff), used

    def ragged_timed(name, x, w, sizes, gs, reps):
        """The sorted-segment kernel's time on (x, w, sizes) at 91 bits and
        at <9,6,-20>, beside the bound of this data (``ragged_work``)."""
        T, dd = x.shape
        ff = w.shape[2]
        nbytes, nops, used = ragged_work(T, dd, ff, gs)
        lay = K.ragged_launch(P91.num_limbs, T, len(gs), dd, ff, sms)
        r = {"shape": [T, dd, ff], "groups": gs, "non_empty_groups": used,
             "layout": dataclasses.asdict(lay),
             "ms": cuda_ms(torch, lambda: K.fdp_ragged_gemm(x, w, sizes, spec=P91, fmt=FP32),
                           reps=reps),
             "ms_fig3": cuda_ms(torch, lambda: K.fdp_ragged_gemm(x, w, sizes, spec=F3,
                                                                 fmt=FP32), reps=reps),
             "int32_ops_per_product": nops / (min(T, sum(gs)) * dd * ff),
             **bound(nbytes, nops)}
        log(f"sorted-segment kernel at {name} x {tuple(x.shape)} w {tuple(w.shape)}: "
            f"{P91.describe()} {r['ms']:.4f} ms = {100 * r['bound_ms'] / r['ms']:.1f}% of its "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); {F3.describe()} "
            f"{r['ms_fig3']:.4f} ms = {r['ms_fig3'] / r['ms']:.3f}x; tile {lay.tile}, "
            f"{lay.tm}x{lay.tn} outputs a thread, K split {lay.ks}")
        return r

    gs_decode = routed_sizes(BATCH, seed=3)
    gs_prefill = routed_sizes(BATCH * PROMPT, seed=4)
    MOE_SITES = {"moe_in": (BATCH * mk, md, mf), "moe_gate": (BATCH * mk, md, mf),
                 "moe_out": (BATCH * mk, mf, md)}
    ragged_cases = [
        ("fp32 91-bit, empty groups leading, inner and trailing, 10 rows past the "
         "total", (40, 70, 40, [0, 9, 0, 14, 7, 0]), FP32, P91, {}),
        ("bf16 91-bit, odd widths", (33, 300, 33, [10, 0, 23]), BF16, P91, {}),
        ("posit16_1 91-bit", (24, 64, 40, [0, 12, 12, 0]), POSIT16_1, P91, {}),
        ("fp32 rne", (40, 200, 40, [0, 20, 0, 20]), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (40, 200, 40, [15, 0, 25]), FP32, SAT,
         {"x_scale": 64.0}),
        ("fp32 every row in one group", (32, 128, 64, [0, 0, 32, 0]), FP32, P91, {}),
        ("fp32 rows past the total (28 of 48)", (48, 96, 40, [7, 0, 13, 0, 0]), FP32,
         P91, {}),
        ("fp32 groups longer than a row tile, partial last tiles", (150, 200, 72,
                                                                    [70, 0, 45, 35]),
         FP32, P91, {}),
        ("fp32 1- and 2-row groups (one-row tiles)", (16, 300, 100,
                                                      [1, 2, 0, 1, 2, 2, 0, 1, 1, 2, 0, 1,
                                                       2, 1, 0, 0]), FP32, P91, {}),
        ("fp32 a transposed weight (the dX view)", (96, 160, 72, [30, 0, 50, 16]), FP32,
         P91, {"wt": True}),
        ("fp32 1-limb <2,5,-8> (capacity 2)", (40, 100, 37, [0, 17, 23]), FP32, ONE,
         {"x_scale": 8.0}),
        ("fp32 <9,6,-20> (3 limbs, capacity 4)", (64, 150, 45, [20, 0, 44]), FP32, F3, {}),
        ("fp32 saturate <9,6,-20>, products past the top limb", (40, 200, 40,
                                                                 [15, 0, 25]),
         FP32, F3_SAT, {"x_scale": 3e6}),
        ("fp32 <60,60,-60> (12 limbs, capacity 12)", (24, 90, 19, [9, 0, 15]), FP32, WIDE12,
         {"x_scale": 1e10}),
        ("fp32 401-bit rne (26 limbs, capacity 32)", (24, 170, 29, [0, 11, 13]), FP32, WIDE,
         {"x_scale": 1e20}),
        ("fp32 rne, every product rounded", (32, 120, 40, [0, 12, 20]), FP32, RNE,
         {"x_scale": 1e-6}),
    ]
    # T = E: one-row tiles, run by fdp::row_chunks (its own instantiations)
    one_row = [
        ("one-row tiles, posit16_1 saturate <2,4,-20>",
         (16, 200, 70, [1, 2, 0, 1, 2, 1, 1, 0, 2, 1, 1, 0, 2, 1, 1, 0]), POSIT16_1, SAT,
         {"x_scale": 64.0}),
        ("one-row tiles, fp32 rne, every product rounded",
         (16, 240, 70, [2, 1, 1, 0, 1, 2, 0, 1, 1, 2, 1, 1, 0, 2, 1, 0]), FP32, RNE,
         {"x_scale": 1e-6}),
        ("one-row tiles, fp32 saturate <9,6,-20>, products past the top limb",
         (16, 200, 40, [0, 1, 2, 1, 1, 0, 2, 2, 1, 1, 0, 1, 2, 1, 1, 0]), FP32, F3_SAT,
         {"x_scale": 3e6}),
        ("one-row tiles, fp32 saturate <9,6,-20>, sums past the top limb",
         (16, 200, 40, [1, 1, 0, 2, 1, 1, 2, 0, 1, 1, 2, 1, 0, 1, 2, 0]), FP32, F3_SAT,
         {"x_scale": 6e4}),
    ]
    for name, (T, dd, ff, gs), fmt, spec, kw in one_row:
        if K.ragged_launch(spec.num_limbs, T, len(gs), dd, ff, sms).tile[0] != 1:
            fail(f"{name}: the launcher did not pick one-row tiles")
    ragged_cases += one_row
    for site, (T, dd, ff) in MOE_SITES.items():
        ragged_cases.append((f"decode {site} at full width, groups {gs_decode}",
                             (T, dd, ff, gs_decode), FP32, P91, {}))
    ragged_cases.append((f"prefill moe_in, {BATCH * PROMPT * mk} rows, the first 512 of "
                         f"{mf} columns (a strided view), groups {gs_prefill}",
                         (BATCH * PROMPT * mk, md, mf, gs_prefill), FP32, P91,
                         {"f_cols": 512}))
    ragged_err, ragged_sites = 0.0, {}
    for name, (T, dd, ff, gs), fmt, spec, kw in ragged_cases:
        x, w, sizes = ragged_operands(T, dd, ff, gs, fmt, **kw)
        want = K.fdp_ragged_gemm_plain(x, w, sizes, spec=spec, fmt=fmt)
        got = K.fdp_ragged_gemm(x, w, sizes, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"sorted-segment kernel != plain for {name}: max |diff| {err}")
        if got[sum(gs):].any():
            fail(f"rows past the total are not zero for {name}")
        saturating = spec.overflow_mode == "saturate"
        extra = f", {n_saturated(got, spec)} outputs saturated" if saturating else ""
        ragged_err = max(ragged_err, err)
        lay = K.ragged_launch(spec.num_limbs, T, len(gs), dd, ff, sms)
        log(f"sorted-segment kernel == plain (torch.equal): {name} "
            f"x {tuple(x.shape)} w {tuple(w.shape)} {fmt.name} {spec.describe()}{extra}; "
            f"capacity {lay.lc}, tile {lay.tile}, {lay.tm}x{lay.tn} outputs a thread, K "
            f"split {lay.ks}")
        site = name.split()[1] if name.startswith("decode") else None
        if site in MOE_SITES:
            ragged_sites[site] = ragged_timed(f"decode {site}", x, w, sizes, gs, reps=20)
            ragged_sites[site]["plain_ms"] = cuda_ms(torch, lambda: K.fdp_ragged_gemm_plain(
                x, w, sizes, spec=P91, fmt=FP32), reps=1)
        del x, w, want, got
    torch.cuda.empty_cache()

    # a training step's moe_in at full width, 1024 routed rows: the forward
    # and its dX against the transposed weights (a view), whole, held
    # against the plain version on their first 64 output columns
    gs_train = routed_sizes(TRAIN_BATCH * TRAIN_SEQ, seed=6)
    T_rows = TRAIN_BATCH * TRAIN_SEQ * mk
    w_train = torch.randn(mE, md, mf, generator=gen, device=dev) * md ** -0.5
    sizes = torch.tensor(gs_train, dtype=torch.int32, device=dev)
    ragged_train = {}
    for site, w in (("moe_in", w_train), ("moe_in@bwd.dA", w_train.transpose(-1, -2))):
        x = torch.randn(T_rows, w.shape[1], generator=gen, device=dev)
        got = K.fdp_ragged_gemm(x, w, sizes, spec=P91, fmt=FP32)[:, :64]
        want = K.fdp_ragged_gemm_plain(x, w[:, :, :64], sizes, spec=P91, fmt=FP32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sorted-segment kernel != plain at the training {site} on its first 64 "
                 f"columns: max |diff| {(got - want).abs().max().item()}")
        log(f"sorted-segment kernel == plain (torch.equal): training {site}, x "
            f"{tuple(x.shape)} w {tuple(w.shape)}{' (a transposed view)' if w.stride(1) == 1 else ''}, "
            f"groups {gs_train}, on its first 64 columns")
        ragged_train[site] = ragged_timed(f"training {site}", x, w, sizes, gs_train, reps=3)
        ragged_train[site]["plain_ms"] = cuda_ms(torch, lambda: K.fdp_ragged_gemm_plain(
            x, w[:, :, :64], sizes, spec=P91, fmt=FP32), reps=1)
        ragged_train[site]["plain_at"] = "the first 64 columns"
        del x, got, want
    del w_train, w
    torch.cuda.empty_cache()

    # -- 3. and 5. serve a model at full width -------------------------------
    phase("3")
    def serve_phase(cfg, params, counters: dict, site_ms: dict):
        """Serve under the kernel policy with every counter set to 0 just
        before the first run and read just after; then timing repeats in
        turns with native fp32 and one traced serve per policy. counters:
        kernel name -> (wrapper, the sites whose dispatches it launches)."""
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(1))

        def timed_serve(policy):
            with D.use_policy(policy):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = serve(cfg, params, prompts, GEN, device=dev)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t

        D.reset_sites_seen()
        for wrapper, _ in counters.values():
            wrapper.launches = 0
        toks, dt = timed_serve(FDP91_KERNEL)
        launches = {name: wrapper.launches for name, (wrapper, _) in counters.items()}
        calls = D.site_calls()
        n_fdp = sum(calls.values())
        if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            fail(f"served tokens malformed: shape {tuple(toks.shape)}")
        expected = set().union(*(sites for _, sites in counters.values()))
        if set(calls) != expected:
            fail(f"dispatched sites {sorted(calls)} != {sorted(expected)}")
        for name, (_, sites) in counters.items():
            n = sum(calls[s] for s in sites)
            if launches[name] <= 0 or launches[name] != n:
                fail(f"{name} launches {launches[name]} != its sites' FDP dispatches {n}")
        # an estimate of the serve's kernel time: per-site CUDA-event means of
        # warm back-to-back launches, times the serve's calls (the trace below
        # measures it inside the serve)
        kernel_ms = sum(calls[s] * site_ms[s] for s in calls)
        fdp_s, fp32_s = [dt], []
        for i in range(SERVE_RUNS):
            toks32, dt32 = timed_serve(D.MXU_FP32)
            fp32_s.append(dt32)
            if i + 1 < SERVE_RUNS:
                again, dt_again = timed_serve(FDP91_KERNEL)
                if not torch.equal(again, toks):
                    fail("FDP-served tokens differ between runs")
                fdp_s.append(dt_again)
        med, med32 = sorted(fdp_s)[len(fdp_s) // 2], sorted(fp32_s)[len(fp32_s) // 2]
        traces = {pol.name: trace_serve(torch, lambda: timed_serve(pol))
                  for pol in (FDP91_KERNEL, D.MXU_FP32)}
        log(f"serve {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
            f"{cfg.vocab_size}) under {FDP91_KERNEL.name}: batch {BATCH} prompt "
            f"{PROMPT} gen {GEN}; kernel launches "
            + ", ".join(f"{n} {launches[n]}" for n in counters)
            + f" == FDP dispatches {n_fdp} (first run)")
        log(f"  seconds per serve, {SERVE_RUNS} runs: "
            f"{', '.join(f'{x:.3f}' for x in fdp_s)}; median {med:.3f} s = "
            f"{BATCH * GEN / med:.2f} tok/s")
        log(f"estimate (per-site CUDA-event means x calls, not a trace): kernel "
            f"{kernel_ms / n_fdp:.4f} ms per launch, {kernel_ms / 1e3:.3f} s per serve "
            f"= {100 * kernel_ms / 1e3 / med:.1f}% of the median serve")
        for site in sorted(calls, key=lambda s: -calls[s] * site_ms[s]):
            log(f"  {site:10s} calls {calls[site]:5d} {site_ms[site]:.4f} ms/launch")
        for name, t in traces.items():
            if t is None:
                log(f"traced serve under {name}: torch.profiler recorded no device "
                    f"events, so device busy time and idle share are not measured")
                continue
            log(f"traced serve under {name} (torch.profiler): wall {t['wall_s']:.3f} s, "
                f"trace span {t['span_s']:.3f} s, device busy {t['device_busy_s']:.3f} s, "
                f"idle share {100 * t['idle_share']:.1f}%, {t['device_events']} device "
                f"events, FDP kernels {t['fdp_kernels']} (FDP dispatches "
                f"{n_fdp if name == FDP91_KERNEL.name else 0}) summing "
                f"{t['fdp_kernel_s']:.3f} s: "
                + "; ".join(f"{k} {v['count']} in {v['s']:.3f} s"
                            for k, v in t["kernels"].items()))
            log("  top device time: " + "; ".join(f"{n} {x:.3f} s" for n, x in t["top"]))
        log(f"sample tokens: {toks[0].tolist()}")
        agree = float((toks32 == toks).float().mean())
        log(f"serve under {D.MXU_FP32.name} (native fp32 matmul, the yardstick), "
            f"{SERVE_RUNS} runs: {', '.join(f'{x:.3f}' for x in fp32_s)}; median "
            f"{med32:.3f} s = {BATCH * GEN / med32:.2f} tok/s; FDP/fp32 = "
            f"{med / med32:.2f}x; greedy tokens agree on {100 * agree:.1f}%")
        return {"launches": launches, "calls": calls, "serve_s": fdp_s, "tokens": toks.tolist(),
                "fp32_serve_s": fp32_s, "tok_s": BATCH * GEN / med,
                "fp32_tok_s": BATCH * GEN / med32, "kernel_s_estimate": kernel_ms / 1e3,
                "trace": {name: t and {k: v for k, v in t.items() if k != "top"}
                          for name, t in traces.items()}}

    def dense_site_ms(sites: dict) -> dict:
        out = {}
        for site, (B, M, Kd, N) in sites.items():
            a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5,
                            bcast=site != "attn_qk" and site != "attn_av")
            out[site] = cuda_ms(torch, lambda: K.fdp_gemm(a, b, spec=P91, fmt=FP32),
                                reps=20 if site == "lm_head" else 50)
        return out

    # the init check: one seed gives the same weights on the card as on the
    # CPU (every tensor is drawn on the host, then scaled on its device)
    for rcfg in (cfg.reduced(), get_config("dbrx-132b").reduced()):
        on_cpu = dict(init(rcfg, seed=0, device="cpu").named_parameters())
        for name, p in init(rcfg, seed=0, device=dev).named_parameters():
            if not torch.equal(p.detach(), on_cpu[name].detach().to(dev)):
                fail(f"init({rcfg.name} reduced, 0) on the card != on the CPU at {name}")
        cut = init(dataclasses.replace(rcfg, n_layers=rcfg.n_layers - 1), seed=0, device="cpu")
        for name, p in cut.named_parameters():
            if not torch.equal(p, on_cpu[name]):
                fail(f"init({rcfg.name} reduced) cut by a layer is not the first layers of "
                     f"the deeper draw at {name}")
        log(f"init({rcfg.name} reduced, seed 0) on the card torch.equal init on the CPU "
            f"moved to the card, all {len(on_cpu)} parameters; cut by a layer, its "
            f"parameters are the deeper draw's")

    params = weights(torch, cfg, dev)
    spec_ms = dense_site_ms(SITES)
    qwen = serve_phase(cfg, params, {"fdp_gemm": (K.fdp_gemm, set(SITES))}, spec_ms)
    del params

    # -- 4. kernel path vs plain path at model level -------------------------
    phase("4")
    def pallas_equals_simulate(cfg, batch_shape, seed):
        params = weights(torch, cfg, dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, batch_shape,
                                         generator=torch.Generator().manual_seed(seed)).to(dev)}
        simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default,
                                                        mode="simulate"))
        with torch.no_grad():
            with D.use_policy(FDP91_KERNEL):
                t = time.perf_counter()
                lk = forward(params, cfg, batch)
                torch.cuda.synchronize()
                tk = time.perf_counter() - t
            with D.use_policy(simulate):
                t = time.perf_counter()
                ls = forward(params, cfg, batch)
                torch.cuda.synchronize()
                ts = time.perf_counter() - t
        if lk.shape != batch_shape + (cfg.padded_vocab,) \
                or not bool(torch.isfinite(lk[..., :cfg.vocab_size]).all()):
            fail(f"forward logits malformed: {tuple(lk.shape)}")
        if not torch.equal(lk, ls):
            fail(f"pallas != simulate logits for {cfg.name} at {cfg.n_layers} layers: "
                 f"max |diff| {(lk - ls).abs().max().item()}")
        log(f"{cfg.n_layers}-layer full-width {cfg.name} forward {batch_shape}: pallas "
            f"logits torch.equal simulate logits ({tk:.3f} s kernel path, {ts:.3f} s "
            f"plain path)")
        del params
        torch.cuda.empty_cache()
        return {"kernel_s": tk, "plain_s": ts}

    pallas_equals_simulate(dataclasses.replace(cfg, n_layers=2), (BATCH, PROMPT), seed=2)

    # -- 5. serve dbrx-132b (MoE) at full width, 1 layer ---------------------
    phase("5")
    mhkv = mcfg.n_kv_heads * mcfg.head_dim
    MOE_DENSE = {
        "attn_q": (BATCH, 1, md, mcfg.n_heads * mcfg.head_dim),
        "attn_k": (BATCH, 1, md, mhkv), "attn_v": (BATCH, 1, md, mhkv),
        "attn_qk": (BATCH * mcfg.n_kv_heads, mcfg.n_heads // mcfg.n_kv_heads,
                    mcfg.head_dim, smax),
        "attn_av": (BATCH * mcfg.n_kv_heads, mcfg.n_heads // mcfg.n_kv_heads, smax,
                    mcfg.head_dim),
        "attn_o": (BATCH, 1, mcfg.n_heads * mcfg.head_dim, md),
        "lm_head": (BATCH, 1, md, mcfg.padded_vocab),
    }
    moe_ms = dense_site_ms(MOE_DENSE)
    moe_ms["moe_router"] = router["ms"]
    moe_ms.update({s: r["ms"] for s, r in ragged_sites.items()})
    params = weights(torch, mcfg, dev)
    dbrx = serve_phase(mcfg, params, {
        "fdp_gemm": (K.fdp_gemm, set(MOE_DENSE) | {"moe_router"}),
        "fdp_ragged_gemm": (K.fdp_ragged_gemm, set(MOE_SITES))}, moe_ms)
    del params
    torch.cuda.empty_cache()

    # -- 6. MoE kernel path vs plain path at model level ---------------------
    phase("6")
    dbrx_eq = pallas_equals_simulate(dataclasses.replace(mcfg, n_layers=1), (1, 4), seed=5)

    # -- 7. per-kernel numbers -----------------------------------------------
    phase("7")
    def at_shape(site):
        B, M, Kd, N = SITES[site]
        a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5, bcast=True)
        products = B * M * Kd * N
        ops_n = K.int32_ops(B * M * Kd, Kd * N, products)    # weight decoded once
        plain_ms = cuda_ms(torch, lambda: K.fdp_gemm_plain(a, b, spec=P91, fmt=FP32),
                           reps=2)
        return {"shape": [B, M, Kd, N], "ms": spec_ms[site], "plain_ms": plain_ms,
                "int32_ops_per_product": ops_n / products,
                **bound(4 * (B * M * Kd + Kd * N + B * M * N), ops_n)}

    lm, mi = at_shape("lm_head"), at_shape("mlp_in")
    for site, r in (("qwen lm_head", lm), ("qwen mlp_in", mi), ("dbrx router", router),
                    *((f"dbrx {s} decode", r) for s, r in ragged_sites.items()),
                    *((f"dbrx {s} training", r) for s, r in ragged_train.items())):
        log(f"bound at {site}: {r['bound_ms']:.4f} ms ({r['bound_by']}; int32 ops at "
            f"{INT32_OPS_PER_S:.4g} op/s, bytes at {HBM_BYTES_PER_S:.3g} B/s); kernel "
            f"{r['ms']:.4f} ms = {100 * r['bound_ms'] / r['ms']:.1f}% of bound; plain "
            f"{r['plain_ms']:.2f} ms" + (f" on {r['plain_at']}" if "plain_at" in r else ""))
    # -- 8. the weight-gradient kernel; kernels 1 and 3 at backward shapes ----
    phase("8")
    tcfg = dataclasses.replace(mcfg, n_layers=TRAIN_LAYERS)
    n_tok = TRAIN_BATCH * TRAIN_SEQ               # T_rows routed rows, gs_train (phase 2)

    def dw_operands(T, dd, ff, fmt, x_scale=1.0, positive=False):
        x = torch.randn(T, dd, generator=gen, device=dev) * x_scale
        g = torch.randn(T, ff, generator=gen, device=dev) * ff ** -0.5
        if positive:
            x, g = x.abs(), g.abs()
        return on_grid(fmt, x, g)

    def dw_work(T, dd, ff, gs):
        """Bytes and int32 operations this data needs: the rows that fall in
        a group, of x and of g, and the sizes, read once; every dW element
        written once; one product per (row in a group, d, f)."""
        rows = min(T, sum(gs))
        nbytes = 4 * (rows * dd + rows * ff + len(gs) + len(gs) * dd * ff)
        return nbytes, K.int32_ops(rows * dd, rows * ff, rows * dd * ff)

    long_rows = 9 * SAFE_CHUNK + 517
    dw_cases = [
        ("fp32 91-bit, empty groups leading, inner and trailing, 10 rows past the "
         "total", (40, 70, 40, [0, 9, 0, 14, 7, 0]), FP32, P91, {}),
        ("bf16 91-bit, odd widths", (33, 300, 33, [10, 0, 23]), BF16, P91, {}),
        ("posit16_1 91-bit", (24, 64, 40, [0, 12, 12, 0]), POSIT16_1, P91, {}),
        ("fp32 rne", (40, 200, 40, [0, 20, 0, 20]), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (40, 200, 40, [15, 0, 25]), FP32, SAT,
         {"x_scale": 256.0}),
        ("fp32 every group empty", (16, 40, 40, [0, 0, 0]), FP32, P91, {}),
        ("fp32 every row in one group", (32, 128, 64, [0, 0, 32, 0]), FP32, P91, {}),
        ("fp32 rows past the total (28 of 48)", (48, 96, 40, [7, 0, 13, 0, 0]), FP32,
         P91, {}),
        (f"fp32 one group of {long_rows} rows (9 x SAFE_CHUNK + 517), positive, so "
         f"one register enters them all", (long_rows + 40, 4, 32, [0, long_rows, 0]), FP32,
         P91, {"positive": True}),
        ("fp32 groups of 1, 31, 33 and 65 rows (the last chunk cut short)",
         (140, 70, 90, [1, 31, 0, 33, 65]), FP32, P91, {}),
        ("fp32 rne, every product rounded, groups of 31 and 33 rows",
         (72, 120, 40, [0, 31, 33]), FP32, RNE, {"x_scale": 1e-6}),
        ("fp32 1-limb <2,5,-8> (capacity 2)", (60, 100, 37, [0, 17, 33]), FP32, ONE,
         {"x_scale": 8.0}),
        ("fp32 <9,6,-20> (3 limbs, capacity 4)", (80, 150, 45, [31, 0, 44]), FP32, F3, {}),
        ("fp32 saturate <9,6,-20>, products past the top limb", (70, 200, 40, [33, 0, 31]),
         FP32, F3_SAT, {"x_scale": 3e6}),
        ("fp32 <60,60,-60> (12 limbs, capacity 12)", (40, 90, 19, [9, 0, 31]), FP32, WIDE12,
         {"x_scale": 1e10}),
        ("fp32 401-bit rne (26 limbs, capacity 32)", (40, 170, 29, [0, 1, 33]), FP32, WIDE,
         {"x_scale": 1e20}),
    ]
    dw_err, dw_capacities = 0.0, set()
    for name, (T, dd, ff, gs), fmt, spec, kw in dw_cases:
        x, g = dw_operands(T, dd, ff, fmt, **kw)
        sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
        want = K.fdp_ragged_dw_plain(x, g, sizes, spec=spec, fmt=fmt)
        got = K.fdp_ragged_dw(x, g, sizes, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        if not torch.equal(got, want):
            fail(f"weight-gradient kernel != plain for {name}: max |diff| {err}")
        if any(got[e].any() for e, n in enumerate(gs) if n == 0):
            fail(f"a zero-size group's dW is not exactly zero for {name}")
        saturating = spec.overflow_mode == "saturate"
        extra = f", {n_saturated(got, spec)} outputs saturated" if saturating else ""
        dw_err = max(dw_err, err)
        lay = K.ragged_dw_launch(spec.num_limbs, T, len(gs), dd, ff, sms)
        dw_capacities.add(lay.lc)
        log(f"weight-gradient kernel == plain (torch.equal): {name} x {tuple(x.shape)} "
            f"g {tuple(g.shape)} groups {gs} {fmt.name} {spec.describe()}{extra}; capacity "
            f"{lay.lc}, tile {lay.tile}, {lay.tm}x{lay.tn} outputs a thread, K split {lay.ks}")
    if not {2, 4, 6, 12, 32} <= dw_capacities:
        fail(f"the weight-gradient cases ran capacities {sorted(dw_capacities)}, not all of "
             f"2, 4, 6, 12 and 32")
    DW_SITES = {"moe_in": (T_rows, md, mf), "moe_gate": (T_rows, md, mf),
                "moe_out": (T_rows, mf, md)}
    dw_sites = {}
    for site, (T, dd, ff) in DW_SITES.items():
        x, g = dw_operands(T, dd, ff, FP32)
        sizes = torch.tensor(gs_train, dtype=torch.int32, device=dev)
        # the timed call itself, on the whole shape at 91 bits and <9,6,-20>:
        # each column of dW depends only on the same column of g, so 64 of
        # its columns (strided for moe_gate) are held against the plain
        # version on those columns of g
        cols = slice(None, None, ff // 64) if site == "moe_gate" else slice(0, 64)
        for spec in (P91, F3):
            got = K.fdp_ragged_dw(x, g, sizes, spec=spec, fmt=FP32)
            want = K.fdp_ragged_dw_plain(x, g[:, cols], sizes, spec=spec, fmt=FP32)
            torch.cuda.synchronize()
            if not torch.equal(got[..., cols], want):
                fail(f"weight-gradient kernel != plain at {site}'s training shape under "
                     f"{spec.describe()}: max |diff| "
                     f"{(got[..., cols] - want).abs().max().item()}")
            del got, want
            torch.cuda.empty_cache()
        nbytes, nops = dw_work(T, dd, ff, gs_train)
        dw_sites[site] = {
            "shape": [T, dd, ff], "groups": gs_train,
            "layout": dataclasses.asdict(K.ragged_dw_launch(P91.num_limbs, T, len(gs_train),
                                                            dd, ff, sms)),
            "layout_fig3": dataclasses.asdict(K.ragged_dw_launch(F3.num_limbs, T,
                                                                 len(gs_train), dd, ff, sms)),
            "ms": cuda_ms(torch, lambda: K.fdp_ragged_dw(x, g, sizes, spec=P91, fmt=FP32),
                          reps=3),
            "ms_fig3": cuda_ms(torch, lambda: K.fdp_ragged_dw(x, g, sizes, spec=F3, fmt=FP32),
                               reps=3),
            "plain_ms": cuda_ms(torch, lambda: K.fdp_ragged_dw_plain(
                x, g[:, cols], sizes, spec=P91, fmt=FP32), reps=1),
            "plain_at": f"64 columns of g ({'strided' if site == 'moe_gate' else 'the first'})",
            "checked": "the timed call (layout and layout_fig3, the whole shape), its "
                       "plain_at columns torch.equal to the plain version at both specs",
            "outputs": len(gs_train) * dd * ff,
            "int32_ops_per_product": nops / (T * dd * ff), **bound(nbytes, nops)}
        log(f"weight-gradient kernel == plain (torch.equal): {site} at its training shape, "
            f"x {tuple(x.shape)} g {tuple(g.shape)}, the timed call at {P91.describe()} "
            f"(capacity {dw_sites[site]['layout']['lc']}) and {F3.describe()} (capacity "
            f"{dw_sites[site]['layout_fig3']['lc']}) checked on "
            f"{dw_sites[site]['plain_at']}, groups {gs_train}")
        r = dw_sites[site]
        log(f"bound at dbrx {site}@bwd.dB: {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel "
            f"{P91.describe()} {r['ms']:.4f} ms on the whole shape = "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound; {F3.describe()} "
            f"{r['ms_fig3']:.4f} ms = {r['ms_fig3'] / r['ms']:.3f}x; plain "
            f"{r['plain_ms']:.2f} ms on {r['plain_at']}")
        del x, g
        torch.cuda.empty_cache()
    # the read-out apart: moe_in's shape with no rows routed (every register
    # zero: the read-out's floor and the stores) and one row a group (one
    # product an output beside a full read-out), at 91 bits
    T, dd, ff = DW_SITES["moe_in"]
    x, g = dw_operands(T, dd, ff, FP32)
    dw_readout = {}
    for label, gs in (("no rows routed", [0] * mE), ("one row a group", [1] * mE)):
        sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
        ms = cuda_ms(torch, lambda: K.fdp_ragged_dw(x, g, sizes, spec=P91, fmt=FP32), reps=3)
        dw_readout[label] = {"groups": gs, "ms": ms, "share": ms / dw_sites["moe_in"]["ms"]}
        log(f"weight-gradient kernel at moe_in's shape, {label}: {ms:.4f} ms = "
            f"{100 * ms / dw_sites['moe_in']['ms']:.1f}% of the routed launch")
    del x, g
    torch.cuda.empty_cache()

    # kernels 1 and 3 at the step's backward shapes, the plain version on slices
    mV = tcfg.padded_vocab
    head = torch.randn(md, mV, generator=gen, device=dev) * md ** -0.5
    g_logits = torch.randn(TRAIN_BATCH, TRAIN_SEQ, mV, generator=gen, device=dev) * 1e-3
    h = torch.randn(TRAIN_BATCH, TRAIN_SEQ, md, generator=gen, device=dev)
    w_in = torch.randn(mE, md, mf, generator=gen, device=dev) * md ** -0.5
    g_moe = torch.randn(T_rows, mf, generator=gen, device=dev) * 1e-2
    x_tok = torch.randn(n_tok, md, generator=gen, device=dev)
    g_router = torch.randn(n_tok, mE, generator=gen, device=dev) * 1e-2
    sizes = torch.tensor(gs_train, dtype=torch.int32, device=dev)
    bwd_checks = {
        # G (B,S,V) @ head^T (V,d) with head^T a transposed view broadcast over B
        "lm_head@bwd.dA, 32 of 6144 columns": (
            g_logits, head.T[:, :32].expand(TRAIN_BATCH, mV, 32)),
        # the flattened h^T (d,T) @ G (T,V), a transposed view, 64 of V columns
        "lm_head@bwd.dB, 64 columns": (
            h.reshape(-1, md).T[None], g_logits.reshape(-1, mV)[None, :, :64]),
        "moe_router@bwd.dB (2-D, whole)": (x_tok.T[None], g_router[None]),
    }
    for name, (a, b) in bwd_checks.items():
        want = K.fdp_gemm_plain(a, b, spec=P91, fmt=FP32)
        got = K.fdp_gemm(a, b, spec=P91, fmt=FP32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"dense kernel != plain at {name}: max |diff| {(got - want).abs().max().item()}")
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"dense kernel == plain (torch.equal): {name}")
        dense[name] = dense_timed(name, a, b, reps=5)
    w_t = w_in.transpose(-1, -2)[:, :, :64]              # (E, f, 64 of d), strided
    want = K.fdp_ragged_gemm_plain(g_moe, w_t, sizes, spec=P91, fmt=FP32)
    got = K.fdp_ragged_gemm(g_moe, w_t, sizes, spec=P91, fmt=FP32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"sorted-segment kernel != plain at moe_in@bwd.dA: max |diff| "
             f"{(got - want).abs().max().item()}")
    log(f"sorted-segment kernel == plain (torch.equal): moe_in@bwd.dA, g {tuple(g_moe.shape)} "
        f"against w^T {tuple(w_in.transpose(-1, -2).shape)} (a transposed view), 64 of "
        f"{md} columns, groups {gs_train}")
    del head, g_logits, h, w_in, g_moe, x_tok, g_router, w_t, want, got
    torch.cuda.empty_cache()

    # -- 9. train dbrx-132b at full width, 1 layer --------------------------
    phase("9")
    qcfg = parse_quant("8x64")
    data = SyntheticLM(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    batches = [data.batch(i).as_dict() for i in range(TRAIN_STEPS)]
    counters = {"fdp_gemm": K.fdp_gemm, "fdp_ragged_gemm": K.fdp_ragged_gemm,
                "fdp_ragged_dw": K.fdp_ragged_dw}

    def kernel_of(site: str) -> str:
        name, _, phase = site.partition("@")
        if name in MOE_SITES:
            return "fdp_ragged_dw" if phase == "bwd.dB" else "fdp_ragged_gemm"
        return "fdp_gemm"

    def make_opt():
        return adamw(lr=cosine_schedule(TRAIN_LR, warmup=1, total=TRAIN_STEPS),
                     clip_norm=1.0, state_quant={"mu": qcfg, "nu": qcfg})

    def checksums(params) -> dict:
        """Per parameter, the int64 sums of its f32 bit patterns over slices
        of 2^24 elements (no second copy of the parameters is kept)."""
        return {n: torch.stack([torch.sum(c.view(torch.int32), dtype=torch.int64)
                                for c in p.detach().reshape(-1).split(1 << 24)]).tolist()
                for n, p in params.named_parameters()}

    def train_run(policy, count_first=False):
        """TRAIN_STEPS steps from seed 0: (params, opt, state, seconds per step,
        losses, first-step launches and dispatches, peak bytes)."""
        params = weights(torch, tcfg, dev)
        opt = make_opt()
        state = opt.init(params)
        step = make_train_step(tcfg, opt, remat="none", numerics_policy=policy)
        secs, losses, first, peak = [], [], None, 0
        for i, batch in enumerate(batches):
            if count_first and i == 0:
                D.reset_sites_seen()
                for wrapper in counters.values():
                    wrapper.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (params, state), metrics = step((params, state), batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            if count_first and i == 0:
                first = {"launches": {n: w.launches for n, w in counters.items()},
                         "calls": D.site_calls()}
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses.append(float(metrics["loss"]))
        return params, opt, state, secs, losses, first, peak

    t = time.perf_counter()
    params, opt, state, fdp_secs, fdp_losses, first, fdp_peak = train_run(
        FDP91_KERNEL, count_first=True)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"dbrx-132b at {TRAIN_LAYERS} layer, full width: {n_params / 1e9:.3f} G f32 "
        f"parameters = {4 * n_params / 1e9:.2f} GB; AdamW moments {qcfg.tag()} "
        f"({TO.optimizer_state_bytes(state) / 1e9:.2f} GB); batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} = {n_tok} tokens, {T_rows} routed rows; {TRAIN_STEPS} steps under "
        f"{FDP91_KERNEL.name} in {time.perf_counter() - t:.1f} s")
    calls = first["calls"]
    for name, n in first["launches"].items():
        want_n = sum(c for s, c in calls.items() if kernel_of(s) == name)
        sites = sorted(s for s in calls if kernel_of(s) == name)
        if n <= 0 or n != want_n:
            fail(f"{name} launched {n} times in the first training step, its sites "
                 f"dispatched {want_n}: {sites}")
        log(f"  first step: {name} launches {n} == dispatches of its sites "
            f"({', '.join(f'{s} {calls[s]}' for s in sites)})")
    if not all(map(math.isfinite, fdp_losses)):
        fail(f"training loss not finite: {fdp_losses}")
    sums = checksums(params)
    del params, opt, state
    torch.cuda.empty_cache()
    params, opt, state, fdp_secs2, fdp_losses2, _, _ = train_run(FDP91_KERNEL)
    if checksums(params) != sums or fdp_losses2 != fdp_losses:
        fail("a second training run from the same seed gave other parameters")
    log(f"  losses {fdp_losses}; a second run from the same seed gives the same "
        f"parameters (per-slice checksums of every parameter) and losses")
    del params, opt, state
    torch.cuda.empty_cache()
    params, opt, state, fp32_secs, fp32_losses, _, fp32_peak = train_run(D.MXU_FP32)
    fdp_med = sorted(fdp_secs2)[len(fdp_secs2) // 2]
    fp32_med = sorted(fp32_secs)[len(fp32_secs) // 2]

    def traced_step(policy):
        step = make_train_step(tcfg, opt, remat="none", numerics_policy=policy)

        def once():
            nonlocal params, state
            torch.cuda.synchronize()
            t = time.perf_counter()
            (params, state), _ = step((params, state), batches[0])
            torch.cuda.synchronize()
            return None, time.perf_counter() - t
        return trace_serve(torch, once)

    train_traces = {pol.name: traced_step(pol) for pol in (FDP91_KERNEL, D.MXU_FP32)}
    del params, opt, state
    torch.cuda.empty_cache()
    train = {"step_s": fdp_secs + fdp_secs2, "fp32_step_s": fp32_secs,
             "median_step_s": fdp_med, "fp32_median_step_s": fp32_med,
             "tok_s": n_tok / fdp_med, "fp32_tok_s": n_tok / fp32_med,
             "peak_bytes": fdp_peak, "fp32_peak_bytes": fp32_peak,
             "losses": fdp_losses, "fp32_losses": fp32_losses,
             "launches": first["launches"], "calls": calls,
             "trace": {n: t and {k: v for k, v in t.items() if k != "top"}
                       for n, t in train_traces.items()}}
    for pol, secs, med, peak in ((FDP91_KERNEL.name, fdp_secs + fdp_secs2, fdp_med, fdp_peak),
                                 (D.MXU_FP32.name, fp32_secs, fp32_med, fp32_peak)):
        log(f"train step under {pol}: seconds {', '.join(f'{s:.3f}' for s in secs)}; "
            f"median (last {TRAIN_STEPS}) {med:.3f} s = {n_tok / med:.1f} trained tok/s; "
            f"peak memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    log(f"FDP/fp32 step time {fdp_med / fp32_med:.2f}x; fp32 losses {fp32_losses}")
    for name, t in train_traces.items():
        if t is None:
            log(f"traced step under {name}: torch.profiler recorded no device events, so "
                f"device busy time and idle share are not measured")
            continue
        log(f"traced step under {name} (torch.profiler): wall {t['wall_s']:.3f} s, trace "
            f"span {t['span_s']:.3f} s, device busy {t['device_busy_s']:.3f} s, idle share "
            f"{100 * t['idle_share']:.1f}%: "
            + "; ".join(f"{k} {v['count']} in {v['s']:.3f} s" for k, v in t["kernels"].items()))
        log("  top device time: " + "; ".join(f"{n} {x:.3f} s" for n, x in t["top"]))

    # -- 10. one loss and backward: pallas gradients == simulate gradients ----
    phase("10")
    params = weights(torch, tcfg, dev)
    small = SyntheticLM(tcfg.vocab_size, 4, 1, seed=7, device=dev).batch(0).as_dict()
    loss_fn = make_loss_fn(tcfg, remat="none")
    names, leaves = zip(*params.named_parameters())
    simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default, mode="simulate"))

    def loss_and_grads(policy):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with D.use_policy(policy):
            loss, _ = loss_fn(params, small)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), grads, time.perf_counter() - t

    lk, gk, tk_s = loss_and_grads(FDP91_KERNEL)
    ls, gsim, ts_s = loss_and_grads(simulate)
    if not bool(torch.isfinite(lk)) or not torch.equal(lk, ls):
        fail(f"pallas loss {lk.item()} != simulate loss {ls.item()}")
    for name, a, b in zip(names, gk, gsim):
        if not torch.equal(a, b):
            fail(f"pallas != simulate gradient of {name}: max |diff| "
                 f"{(a - b).abs().max().item()}")
    log(f"{TRAIN_LAYERS}-layer full-width dbrx-132b, batch 1 x seq 4: loss and all "
        f"{len(names)} gradients in pallas mode torch.equal simulate mode ({tk_s:.3f} s "
        f"kernel path, {ts_s:.3f} s plain path); every site compared whole: no column "
        f"slice was needed (the plain version forms wide outputs a block of columns at a "
        f"time)")
    grads_eq = {"kernel_s": tk_s, "plain_s": ts_s, "gradients": len(names)}
    del params, leaves, gk, gsim
    torch.cuda.empty_cache()

    # -- 11. the fault-tolerant Trainer on the card ---------------------------
    phase("11")
    rcfg = get_config("dbrx-132b").reduced()
    ropt = adamw(lr=1e-3, state_quant={"mu": qcfg, "nu": qcfg})
    rstep = make_train_step(rcfg, ropt, remat="none", numerics_policy=FDP91_KERNEL)
    rdata = SyntheticLM(rcfg.vocab_size, 16, 4, seed=0, device=dev)
    injected = []
    from repro_torch.obs import default_registry, recorder

    def injector(step):
        if step == 3 and not injected:
            injected.append(step)
            raise InjectedFailure("injected failure at step 3")

    def obs_counts():
        """(step-time observations, restores, ``train.step`` spans' steps)"""
        m = default_registry().snapshot()["metrics"]
        hist = m.get("repro_train_step_seconds", {"values": []})["values"]
        return (sum(v["count"] for v in hist),
                default_registry().counter("repro_train_restarts_total", "").value(),
                [e["args"]["step"] for e in recorder().events() if e["name"] == "train.step"])

    runs, obs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, inj in (("injected", injector), ("clean", None)):
            recorder().clear()
            before = obs_counts()
            trainer = Trainer(rcfg, ropt, lambda s: rdata.batch(s).as_dict(), rstep,
                              os.path.join(tmp, name), save_every=2, failure_injector=inj,
                              device=dev)
            runs[name] = (trainer.run(5)[0], trainer.restarts)
            after = obs_counts()
            obs[name] = (after[0] - before[0], after[1] - before[1], after[2])
    if injected != [3] or runs["injected"][1] != 1:
        fail(f"the injected run restarted {runs['injected'][1]} times (want 1)")
    if runs["clean"][1] != 0:
        fail(f"a run without an injected failure restarted {runs['clean'][1]} times")
    for a, b in zip(runs["injected"][0].parameters(), runs["clean"][0].parameters()):
        if not torch.equal(a, b):
            fail("the Trainer that recovered from the failure ended on other parameters")
    # steps 0-2, the failure at 3, the restore to the step-2 checkpoint, 2-4
    want_obs = {"injected": (6, 1.0, [0, 1, 2, 2, 3, 4]), "clean": (5, 0.0, [0, 1, 2, 3, 4])}
    if obs != want_obs:
        fail(f"the Trainer's obs (step-time observations, restores, train.step spans' "
             f"steps) {obs} != {want_obs}")
    log(f"Trainer ({rcfg.name}, {FDP91_KERNEL.name}, checkpoints every 2 steps): an "
        f"injected failure at step 3, 1 restart, final parameters torch.equal to a run "
        f"without the failure (0 restarts); repro_train_step_seconds observations, "
        f"repro_train_restarts_total and train.step spans' steps: {obs}")
    del runs

    # -- 12. the seed-order kernel (impl="loop") against plain and vector ------
    phase("12")
    SEED_TILE = D.GemmPlan(32, 32, 128)

    def operands_2d(M, Kd, N, fmt, a_scale=1.0, b_scale=1.0, positive=False,
                    strided=False):
        if strided:                                      # transposed views of both
            a = (torch.randn(Kd, M, generator=gen, device=dev) * a_scale).T
            b = (torch.randn(N, Kd, generator=gen, device=dev) * b_scale).T
        else:
            a = torch.randn(M, Kd, generator=gen, device=dev) * a_scale
            b = torch.randn(Kd, N, generator=gen, device=dev) * b_scale
        if positive:
            a, b = a.abs(), b.abs()
        return on_grid(fmt, a, b)

    LOOP_SHAPES = {"bench hot shape": ((256, 1024, 256), SEED_TILE),
                   "qwen lm_head decode": ((BATCH, d, V), None),
                   "qwen mlp_in prefill": ((BATCH * PROMPT, d, f), None)}
    loop_cases = [
        ("fp32 91-bit ragged", (5, 70, 9), FP32, P91, SEED_TILE, {}),
        ("bf16 91-bit ragged", (17, 300, 33), BF16, P91, SEED_TILE, {}),
        ("posit16_1 91-bit", (4, 64, 40), POSIT16_1, P91, SEED_TILE, {}),
        ("fp32 rne", (4, 200, 40), FP32, RNE, SEED_TILE, {}),
        ("fp32 saturate <2,4,-20>", (4, 200, 40), FP32, SAT, SEED_TILE, {"a_scale": 4.0}),
        ("fp32 <9,6,-20>", (24, 96, 40), FP32, F3, SEED_TILE, {}),
        ("fp32 strided (transposed) a and b, ragged tiles", (37, 150, 45), FP32, P91,
         D.GemmPlan(16, 16, 64), {"strided": True}),
        ("fp32 K = 1000 past bk = 128, so carries normalize 8 times", (40, 1000, 24), FP32,
         P91, SEED_TILE, {}),
        (f"fp32 K = SAFE_CHUNK + 700 positive, bk = SAFE_CHUNK", (3, SAFE_CHUNK + 700, 16),
         FP32, P91, D.GemmPlan(8, 8, 1 << 20), {"positive": True}),
    ] + [(name, shape, FP32, P91, plan, {"b_scale": shape[1] ** -0.5})
         for name, (shape, plan) in LOOP_SHAPES.items()]
    K.fdp_gemm_looped.launches = 0
    loop_err, loop_sites = 0.0, {}
    for name, (M, Kd, N), fmt, spec, plan, kw in loop_cases:
        a, b = operands_2d(M, Kd, N, fmt, **kw)
        want = K.fdp_gemm_plain(a[None], b[None], spec=spec, fmt=fmt)[0]
        got = ops.fdp_gemm(a, b, spec=spec, fmt=fmt, plan=plan, impl="loop")
        vec = ops.fdp_gemm(a, b, spec=spec, fmt=fmt, plan=plan)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"seed-order kernel != plain for {name} {(M, Kd, N)}: max |diff| {err}")
        if not torch.equal(got, vec):
            fail(f"seed-order kernel != vector kernel for {name} {(M, Kd, N)}")
        loop_err = max(loop_err, err)
        fitted = ops.resolve_plan(plan, M, N, Kd)
        extra = f", {n_saturated(got, spec)} outputs saturated" if spec is SAT else ""
        log(f"seed-order kernel == plain == vector kernel (torch.equal): {name} "
            f"{(M, Kd, N)} {fmt.name} {spec.describe()}, plan {fitted.tile}{extra}")
        if name in LOOP_SHAPES:
            ops_n = K.int32_ops(M * Kd, Kd * N, M * Kd * N)
            loop_sites[name] = {
                "shape": [M, Kd, N], "plan": list(fitted.tile),
                "ms": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=P91, plan=plan,
                                                          impl="loop"), reps=10),
                "vector_ms": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=P91, plan=plan),
                                     reps=10),
                "plain_ms": cuda_ms(torch, lambda: K.fdp_gemm_plain(a[None], b[None], spec=P91,
                                                                    fmt=FP32), reps=1),
                # the 3-limb <9,6,-20> on the same inputs: both kernels run
                # their smallest (6-limb) instantiation
                "ms_fig3": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=F3, plan=plan,
                                                               impl="loop"), reps=10),
                "vector_ms_fig3": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=F3, plan=plan),
                                          reps=10),
                **bound(4 * (M * Kd + Kd * N + M * N), ops_n)}
            r = loop_sites[name]
            log(f"  {name}: seed-order kernel {r['ms']:.4f} ms, vector kernel "
                f"{r['vector_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of the seed-order kernel; at "
                f"{F3.describe()}: seed-order {r['ms_fig3']:.4f} ms, vector "
                f"{r['vector_ms_fig3']:.4f} ms")
        del a, b, want, got, vec
    loop_launches = K.fdp_gemm_looped.launches
    if loop_launches <= 0:
        fail("the seed-order kernel was never launched")
    log(f"seed-order kernel launches {loop_launches} in phase 12 ({len(loop_cases)} checks "
        f"and the timing repeats)")
    torch.cuda.empty_cache()

    # -- 13. the generator: native, simulate and pallas targets --------------
    phase("13")
    from repro_torch.core import metrics
    from repro_torch.core.generator import generate_gemm
    import numpy as np

    rng = np.random.default_rng(0)
    gen_runs = {}
    for shape_name, (M, Kd, N) in (("quickstart", (64, 256, 32)),
                                   ("qwen mlp_in prefill", (BATCH * PROMPT, d, f))):
        an = rng.standard_normal((M, Kd)).astype(np.float32)
        bn = rng.standard_normal((Kd, N)).astype(np.float32)
        ref64 = an.astype(np.float64) @ bn.astype(np.float64)
        a, b = torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev)
        for spec in (P91, F3):
            outs = {}
            for target, tile in (("native", None), ("simulate", None),
                                 ("pallas", (32, 32, 128)), ("pallas", None)):
                g = generate_gemm(None if target == "native" else spec, FP32, target, tile)
                log(g.report.describe())
                outs[(target, tile)] = g.fn(a, b)
            torch.cuda.synchronize()
            sim = outs[("simulate", None)]
            for tile in ((32, 32, 128), None):
                if not torch.equal(outs[("pallas", tile)], sim):
                    fail(f"generate_gemm pallas (tile {tile}) != simulate at {shape_name} "
                         f"{(M, Kd, N)} {spec.describe()}")
            bits = {t: metrics.correct_bits(o, ref64) for (t, _), o in outs.items()}
            gen_runs[f"{shape_name} {spec.describe()}"] = {
                t: {"median_correct_bits": float(np.median(v)), "min_correct_bits":
                    float(v.min())} for t, v in bits.items()}
            log(f"generate_gemm at {shape_name} {(M, Kd, N)}, {spec.describe()}: pallas "
                f"(tile (32, 32, 128) and plan_gemm's) torch.equal simulate; correct bits "
                f"against an f64 product, median/min: "
                + "; ".join(f"{t} {float(np.median(v)):.1f}/{float(v.min()):.1f}"
                            for t, v in bits.items()))

    # -- 14. qwen3-0.6b at full width, served under a PrecisionPlan from JSON --
    phase("14")
    from repro_torch.numerics import PrecisionPlan, SitePlan
    from repro_torch.train.optimizer import state_quant_from_policy

    kernel_cfg = D.GemmConfig(FP32, P91, "pallas")
    plan = PrecisionPlan(
        name="qwen3-0.6b fig3 mlp", default=kernel_cfg,
        sites=tuple(SitePlan(s, D.GemmConfig(FP32, F3, "pallas"))
                    for s in ("mlp_in", "mlp_gate", "mlp_out"))
        + (SitePlan("lm_head", D.GemmConfig(FP32, None, "native")),))
    with tempfile.TemporaryDirectory() as tmp:
        plan_path = os.path.join(tmp, "qwen3_0p6b_fig3.json")
        plan.save(plan_path)
        plan_policy = D.policy_from_plan(plan_path)       # the model gets it from the file
    log("precision plan saved and loaded back:\n" + plan.describe())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    params = weights(torch, cfg, dev)

    def serve_under(policy):
        with D.use_policy(policy):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = serve(cfg, params, prompts, GEN, device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

    launched_at: dict = {}
    last = [0]

    def attribute_launches(site_key, cfg_, a_, b_, out_):
        n = K.fdp_gemm.launches
        launched_at[site_key] = launched_at.get(site_key, 0) + n - last[0]
        last[0] = n

    D.reset_sites_seen()
    K.fdp_gemm.launches = 0
    remove_hook = D.add_trace_hook(attribute_launches)
    try:
        plan_toks, first_s = serve_under(plan_policy)
    finally:
        remove_hook()
    plan_launches = K.fdp_gemm.launches
    calls = D.site_calls()
    pallas_sites = sorted(s for s in calls if plan_policy.lookup(s).mode == "pallas")
    n_pallas = sum(calls[s] for s in pallas_sites)
    if any("@bwd" in s for s in calls):
        fail(f"a forward-only serve dispatched backward sites: {sorted(calls)}")
    if "lm_head" not in calls or plan_policy.lookup("lm_head").mode != "native":
        fail(f"lm_head did not dispatch natively: {calls}")
    if plan_launches <= 0 or plan_launches != n_pallas:
        fail(f"dense kernel launches {plan_launches} != dispatches at the plan's pallas "
             f"sites {n_pallas}")
    if launched_at.get("lm_head", 0) != 0 or any(launched_at.get(s) != calls[s]
                                                  for s in pallas_sites):
        fail(f"launches by site {launched_at} != pallas dispatches {calls}")
    plan_s = []
    for _ in range(SERVE_RUNS):
        again, dt = serve_under(plan_policy)
        if not torch.equal(again, plan_toks):
            fail("plan-served tokens differ between runs")
        plan_s.append(dt)
    plan_med = sorted(plan_s)[len(plan_s) // 2]
    plan_serve = {"launches": plan_launches, "calls": calls, "first_serve_s": first_s,
                  "serve_s": plan_s, "tok_s": BATCH * GEN / plan_med,
                  "fdp91_kernel_tok_s": qwen["tok_s"], "fp32_tok_s": qwen["fp32_tok_s"]}
    log(f"serve qwen3-0.6b ({cfg.n_layers} layers, full width) under the plan "
        f"{plan_policy.name!r} from JSON: dense kernel launches {plan_launches} == "
        f"dispatches at its pallas sites {n_pallas} (by site, from a trace hook: "
        + ", ".join(f"{s} {launched_at.get(s, 0)}" for s in sorted(calls))
        + "); lm_head native, 0 launches; no @bwd site")
    log(f"  seconds per serve (after a first, hooked serve of {first_s:.3f} s): "
        f"{', '.join(f'{x:.3f}' for x in plan_s)}; median {plan_med:.3f} s = "
        f"{plan_serve['tok_s']:.2f} tok/s, beside {qwen['tok_s']:.2f} under "
        f"{FDP91_KERNEL.name} and {qwen['fp32_tok_s']:.2f} under {D.MXU_FP32.name} "
        f"(phase 3, this run); tokens repeat across runs")
    del params
    torch.cuda.empty_cache()

    def simulate_twin(policy):
        swap = lambda c: dataclasses.replace(c, mode="simulate") if c.mode == "pallas" else c
        return dataclasses.replace(policy, default=swap(policy.default),
                                   overrides=tuple((p, swap(c)) for p, c in policy.overrides),
                                   name=policy.name + "/simulate")

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = weights(torch, cfg2, dev)
    batch = {"tokens": torch.randint(0, cfg2.vocab_size, (BATCH, PROMPT),
                                     generator=torch.Generator().manual_seed(2)).to(dev)}
    with torch.no_grad():
        logits = {}
        for name, pol in (("plan", plan_policy), ("twin", simulate_twin(plan_policy)),
                          ("fp32", D.MXU_FP32)):
            with D.use_policy(pol):
                t = time.perf_counter()
                logits[name] = forward(params, cfg2, batch)
                torch.cuda.synchronize()
                log(f"  2-layer forward under {pol.name}: {time.perf_counter() - t:.3f} s")
    if not bool(torch.isfinite(logits["plan"][..., :cfg2.vocab_size]).all()):
        fail("plan logits are not finite")
    if not torch.equal(logits["plan"], logits["twin"]):
        fail(f"plan logits != its simulate twin's: max |diff| "
             f"{(logits['plan'] - logits['twin']).abs().max().item()}")
    top1 = metrics.top1_agreement(logits["plan"][..., :cfg2.vocab_size],
                                  logits["fp32"][..., :cfg2.vocab_size])
    plan_serve["top1_vs_fp32_2layer"] = top1
    log(f"2-layer full-width qwen3-0.6b {tuple(batch['tokens'].shape)}: logits under the "
        f"plan torch.equal its simulate twin; top-1 agreement with native fp32 {top1:.4f}")
    del params, logits
    torch.cuda.empty_cache()

    # -- 15. the checked-in zoo plan, unchanged, at full width ----------------
    phase("15")
    zoo_path = os.path.join(ROOT, "examples", "plans", "qwen3_0p6b.json")
    zoo_policy = D.policy_from_plan(zoo_path)
    params = weights(torch, cfg, dev)
    all_kernels = (K.fdp_gemm, K.fdp_ragged_gemm, K.fdp_ragged_dw, K.fdp_gemm_looped)
    D.reset_sites_seen()
    for w in all_kernels:
        w.launches = 0
    zoo_toks, zoo_s = serve_under(zoo_policy)
    zoo_calls = D.site_calls()
    if not zoo_calls or any(w.launches for w in all_kernels):
        fail(f"the zoo plan launched FDP kernels {[w.launches for w in all_kernels]} "
             f"(dispatches {zoo_calls})")
    squant = state_quant_from_policy(zoo_policy)
    if squant is None or {m: c.tag() for m, c in squant.items()} != {"mu": "q8b64",
                                                                     "nu": "q8b64"}:
        fail(f"state_quant_from_policy of the zoo plan: {squant}")
    zoo_serve = {"serve_s": zoo_s, "tok_s": BATCH * GEN / zoo_s, "calls": zoo_calls,
                 "state_quant": {m: c.tag() for m, c in squant.items()}}
    log(f"serve qwen3-0.6b at full width under the zoo plan {zoo_policy.name!r} "
        f"(examples/plans/qwen3_0p6b.json, unchanged): {zoo_s:.3f} s = "
        f"{zoo_serve['tok_s']:.2f} tok/s, {sum(zoo_calls.values())} native dispatches, 0 FDP "
        f"launches; state_quant_from_policy: "
        + ", ".join(f"{m}={c.tag()}" for m, c in sorted(squant.items())))
    del params
    torch.cuda.empty_cache()

    # -- 16. the tailoring loop at full width: calibrate, search, serve ------
    phase("16")
    from repro_torch.numerics import (calibrate, config_fingerprint, load_plan, load_trace,
                                      search)

    search_mod = importlib.import_module("repro_torch.numerics.search")
    t16 = time.perf_counter()
    params = weights(torch, cfg, dev)
    cgen = torch.Generator().manual_seed(3)
    cal_batch = {k: torch.randint(0, cfg.vocab_size, (PROBE_BATCH, PROBE_SEQ),
                                  generator=cgen).to(dev) for k in ("tokens", "targets")}
    # (a) calibrate: one forward and one backward of the LM loss, native fp32;
    # an added hook counts the dispatches the hooks see (a checkpointed
    # recompute reaches none)
    dispatched = collections.Counter()
    remove = D.add_trace_hook(lambda site, *args: dispatched.update([site]))
    t = time.perf_counter()
    try:
        with calibrate() as trace:
            with D.use_policy(D.MXU_FP32):
                with torch.no_grad():
                    forward(params, cfg, {"tokens": cal_batch["tokens"]}, remat="none")
                loss, _ = make_loss_fn(cfg, remat="none")(params, cal_batch)
            loss.backward()               # autograd's device thread runs the hooks
        torch.cuda.synchronize()
    finally:
        remove()
    cal_s = time.perf_counter() - t
    params.zero_grad(set_to_none=True)
    del loss
    fwd_sites = set(trace.sites("fwd"))
    if fwd_sites != set(qwen["calls"]):
        fail(f"calibrated forward sites {sorted(fwd_sites)} != the FDP sites phase 3 "
             f"dispatched {sorted(qwen['calls'])}")
    pairs = {f"{s}@bwd.{o}" for s in fwd_sites for o in ("dA", "dB")}
    if set(trace.sites("bwd")) != pairs or set(trace.sites()) != set(dispatched):
        fail(f"calibrated sites {trace.sites()} != the forward sites, their @bwd.dA/dB "
             f"pairs and the dispatches {sorted(dispatched)}")
    for site in trace.sites():
        prof = trace.profile(site)
        if prof.calls != dispatched[site] or prof.sample is None:
            fail(f"{site}: {prof.calls} calls recorded for {dispatched[site]} dispatches, "
                 f"sample {'present' if prof.sample else 'missing'}")
    log(f"calibrated qwen3-0.6b at full width ({cfg.n_layers} layers, batch "
        f"{PROBE_BATCH} x {PROBE_SEQ} tokens with targets, native fp32, one forward and "
        f"one backward of the LM loss) in {cal_s:.3f} s: {len(fwd_sites)} forward sites "
        f"== phase 3's FDP sites, {len(pairs)} @bwd sites, {sum(dispatched.values())} "
        f"records == dispatches seen by an added hook, a sample at every site")
    for site in trace.sites():
        log("  " + trace.profile(site).describe())

    # (b) save and load back: every field and every sample byte
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "qwen3_0p6b.trace.json")
        trace.save(trace_path, fingerprint=config_fingerprint(
            {"arch": "qwen3-0.6b", "config": dataclasses.asdict(cfg), "batch": PROBE_BATCH,
             "seq": PROBE_SEQ, "phases": ["bwd", "fwd"]}),
            meta={"arch": "qwen3-0.6b", "config_name": cfg.name, "batch": PROBE_BATCH,
                  "seq": PROBE_SEQ, "phases": ["bwd", "fwd"], "reduced": False})
        trace_mb = os.path.getsize(trace_path) / 1e6
        loaded = load_trace(trace_path, expect_fingerprint=trace.fingerprint)
    if loaded.sites() != trace.sites() or loaded.meta != trace.meta or any(
            loaded.profile(s).to_full_dict() != trace.profile(s).to_full_dict()
            for s in trace.sites()):
        fail("the saved trace does not load back to the calibrated one")
    log(f"trace saved ({trace_mb:.1f} MB of JSON) and loaded back: every field and every "
        f"sample byte equal")

    # (c) and (d): search the loaded trace on the card. Every search refuses
    # to run while TF32 is on (native candidates would score ~11 bits).
    FDP_GRID = dict(formats=(FP32, BF16), widths=(24, 40, 64), include_native=False,
                    phases=("fwd", "bwd"), margin_bits=TAILOR_MARGIN)
    vs_plain = {"calls": 0, "outputs": 0, "max_abs_diff": 0.0}
    validating = [False]

    search_autotune = []

    def card_search(label, **kw):
        last = [None]

        def count(site_key, cfg_, a_, b_, out_):
            # every pallas dispatch of the search's own calls: its first
            # CHECK_COLS output columns (all of a sample's 16) torch.equal to
            # the plain version on the same operands. A timed repeat on the
            # operands just checked is not checked again (the check would land
            # in its time), nor are the validation runs: they run the served
            # model's calls, which (e) holds to the plain version.
            if cfg_.mode != "pallas" or validating[0]:
                return
            key = (site_key, cfg_, a_.data_ptr(), b_.data_ptr(), a_.shape, b_.shape)
            if key == last[0]:
                return
            last[0] = key
            cols = min(b_.shape[-1], CHECK_COLS)
            want = D.gemm(a_, b_[..., :cols], site=site_key, policy=D.NumericsPolicy(
                D.GemmConfig(cfg_.fmt, cfg_.acc, "simulate")))
            got = out_[..., :cols]
            if not torch.equal(got, want):
                fail(f"search {label}: {site_key} {cfg_.tag()} {tuple(a_.shape)} @ "
                     f"{tuple(b_.shape)}: the dense kernel != its plain version, max |diff| "
                     f"{(got - want).abs().max().item()}")
            vs_plain["calls"] += 1
            vs_plain["outputs"] += got.numel()

        K.fdp_gemm.launches = 0
        remove = D.add_trace_hook(count)
        t = time.perf_counter()
        try:
            with pallas_dispatches(D) as n_pallas, autotune_launches(D, K) as tuned:
                res = search(loaded, TAILOR_BUDGET, name=f"qwen3-0.6b {label}", device=dev,
                             **kw)
                torch.cuda.synchronize()
        finally:
            remove()
        dt = time.perf_counter() - t
        dispatched = K.fdp_gemm.launches - tuned["launches"]
        if dispatched != n_pallas[0]:
            fail(f"search {label}: dense kernel launches {K.fdp_gemm.launches} less "
                 f"{tuned['launches']} of the autotuner != pallas dispatches {n_pallas[0]}")
        search_autotune.append(tuned)
        log(f"search {label}: {len(res.decisions)} sites in {dt:.3f} s (with the checks), "
            f"dense kernel launches {dispatched} == pallas dispatches {n_pallas[0]}"
            + (f"; the latency column autotuned {tuned['keys']} plans in "
               f"{tuned['seconds']:.3f} s ({tuned['launches']} launches)" if tuned["keys"]
               else ""))
        return res, dispatched, dt

    res_k, launches_k, search_k_s = card_search("pallas", fdp_mode="pallas", **FDP_GRID)
    if launches_k <= 0:
        fail("the pallas search launched no dense kernel")
    res_s, _, search_s_s = card_search("simulate", fdp_mode="simulate", **FDP_GRID)

    def rows(res):
        return {s.site: (s.cfg.tag().replace("/simulate", "/pallas"), s.error_bits, s.energy_j)
                for s in res.plan.sites}

    if rows(res_k) != rows(res_s):
        fail(f"pallas and simulate plans differ: "
             f"{sorted(set(rows(res_k).items()) ^ set(rows(res_s).items()))}")
    for site, d in res_k.decisions.items():
        front = lambda dd: [(e.candidate.tag.rsplit("/", 1)[0], e.error_bits)
                            for e in dd.frontier]
        if front(d) != front(res_s.decisions[site]):
            fail(f"{site}: pallas frontier {front(d)} != simulate frontier "
                 f"{front(res_s.decisions[site])}")
    picked = sorted({s.cfg.acc.num_limbs for s in res_k.plan.sites})
    log(f"pallas and simulate searches agree site for site (tag, error bits, energy) and "
        f"on every frontier (tag, error bits); picked registers of {picked} limbs; "
        f"{vs_plain['calls']} kernel calls of the pallas search, {vs_plain['outputs']} "
        f"outputs, torch.equal to the plain version")

    # Each site's pick is scored on its 16 x 16 sample; the reference's
    # legacy loop (validate=) holds the assembled plan to the budget end to
    # end and upgrades the weakest forward site until it holds: here, the
    # full-width model's logits on the calibration tokens against FDP91's.
    with torch.no_grad(), D.use_policy(FDP91_KERNEL):
        ref_logits = forward(params, cfg, {"tokens": cal_batch["tokens"]})[..., :cfg.vocab_size]
    validated = []

    def validate(policy):
        validating[0] = True
        try:
            with torch.no_grad(), D.use_policy(policy):
                got = forward(params, cfg, {"tokens": cal_batch["tokens"]})[..., :cfg.vocab_size]
        finally:
            validating[0] = False
        validated.append(float(np.median(metrics.correct_bits(got, ref_logits, cap=24))))
        return validated[-1]

    res_l, launches_l, search_l_s = card_search("pallas with latency, validated",
                                                fdp_mode="pallas", measure_latency=True,
                                                validate=validate, **FDP_GRID)
    del ref_logits
    if not res_l.validated_bits >= TAILOR_BUDGET:
        fail(f"the validated search ends at {res_l.validated_bits:.3f} bits end to end, "
             f"below the budget of {TAILOR_BUDGET} (per call: {validated})")
    first = {site: next((i for i, p in enumerate(d.frontier)
                         if p.error_bits >= TAILOR_BUDGET + TAILOR_MARGIN), len(d.frontier) - 1)
             for site, d in res_l.decisions.items()}
    upgraded = {site: (d.frontier[first[site]].candidate.tag, d.pick.candidate.tag)
                for site, d in sorted(res_l.decisions.items()) if d.chosen != first[site]}
    log(f"validated end to end (median correct bits of the full-width logits on the "
        f"calibration tokens against FDP91, per call: "
        f"{', '.join(f'{b:.3f}' for b in validated)}); {len(upgraded)} upgrades: "
        + (", ".join(f"{s} {a} -> {b}" for s, (a, b) in upgraded.items()) or "none"))
    p91 = D.GemmConfig(FP32, P91, "pallas")
    with tempfile.TemporaryDirectory() as tmp:
        plan_path = os.path.join(tmp, "qwen3_0p6b.searched.json")
        res_l.plan.save(plan_path)
        searched = load_plan(plan_path)
        searched_policy = D.policy_from_plan(plan_path)    # as --precision-plan does
    if [(s.site, s.cfg.tag()) for s in searched.sites] != \
            [(s.site, s.cfg.tag()) for s in res_l.plan.sites]:
        fail("the searched plan does not load back to its own sites")
    lat91 = {}
    log(f"searched plan (budget {TAILOR_BUDGET} bits, latency measured on the card), "
        f"saved and loaded back; modeled energy {res_l.plan.meta['modeled_energy_j']:.4e} J "
        f"= {100 * res_l.plan.meta['energy_vs_baseline']:.1f}% of uniform 91 bits:")
    with autotune_launches(D, K) as tuned91:
        for site, d in sorted(res_l.decisions.items()):
            lat91[site] = search_mod._measure_latency_us(p91, d.profile, dev)
    search_autotune.append(tuned91)
    for site, d in sorted(res_l.decisions.items()):
        pk = d.pick
        shape = max(d.profile.shapes.items(), key=lambda kv: kv[1])[0]
        log(f"  {site:16s} {pk.candidate.tag:32s} {pk.error_bits:5.1f} bits "
            f"{pk.energy_j:.3e} J {pk.latency_us:9.1f} us; 91 bits {lat91[site]:9.1f} us "
            f"at (m, n, k) {shape[1:]}")
    k_tags = {site: row[0] for site, row in rows(res_k).items()}
    moved = {site: (k_tags[site], d.frontier[first[site]].candidate.tag)
             for site, d in res_l.decisions.items()
             if k_tags[site] != d.frontier[first[site]].candidate.tag}
    log(f"the latency axis moved {len(moved)} of the first picks of the search without it: "
        + (", ".join(f"{s} {a} -> {b}" for s, (a, b) in sorted(moved.items())) or "none"))
    res_d, launches_d, search_d_s = card_search("default grid (native included; FDP on the "
                                                "kernel by default)")
    by_tag: dict = {}
    for sp in res_d.plan.sites:
        by_tag[sp.cfg.tag()] = by_tag.get(sp.cfg.tag(), 0) + 1
    log("default grid picks by tag: " + ", ".join(f"{t} x{n}" for t, n in sorted(by_tag.items())))

    # (e) serve the searched plan at full width, as phase 3 serves
    D.reset_sites_seen()
    K.fdp_gemm.launches = 0
    tailored_toks, tailored_first = serve_under(searched_policy)
    tailored_launches = K.fdp_gemm.launches
    tcalls = D.site_calls()
    n_tailored = sum(n for s, n in tcalls.items() if searched_policy.lookup(s).mode == "pallas")
    if set(tcalls) != set(qwen["calls"]) or tailored_launches <= 0 \
            or tailored_launches != n_tailored:
        fail(f"searched-plan serve: dense kernel launches {tailored_launches} != its FDP "
             f"dispatches {n_tailored} (sites {sorted(tcalls)})")
    if tailored_toks.shape != (BATCH, GEN) or int(tailored_toks.min()) < 0 \
            or int(tailored_toks.max()) >= cfg.vocab_size:
        fail(f"searched-plan tokens malformed: {tuple(tailored_toks.shape)}")
    tailored_s = []
    for _ in range(SERVE_RUNS):
        again, dt = serve_under(searched_policy)
        if not torch.equal(again, tailored_toks):
            fail("searched-plan tokens differ between runs")
        tailored_s.append(dt)
    tailored_med = sorted(tailored_s)[len(tailored_s) // 2]
    # one more serve, untimed: each FDP call's exact outputs (f64 sums of the
    # exact products) against its pick's msb, and against the register's top
    # (msb + ovf), past which it wraps
    envelope = searched.meta["envelope"]["sites"]
    past_msb, wrapped = collections.Counter(), collections.Counter()
    n_checked = collections.Counter()

    def against_msb(site_key, cfg_, a_, b_, out_):
        if cfg_.mode != "pallas":
            return
        msb = envelope[site_key]["msb"]
        if msb != cfg_.acc.msb:
            fail(f"{site_key}: envelope msb {msb} != the deployed {cfg_.acc.describe()}")
        exact = torch.matmul(cfg_.fmt.quantize(a_).double(),
                             cfg_.fmt.quantize(b_).double()).abs()
        past_msb[site_key] += (exact >= 2.0 ** (msb + 1)).sum()
        wrapped[site_key] += (exact >= 2.0 ** (msb + cfg_.acc.ovf)).sum()
        n_checked[site_key] += exact.numel()

    remove = D.add_trace_hook(against_msb)
    try:
        again, _ = serve_under(searched_policy)
    finally:
        remove()
    if not torch.equal(again, tailored_toks):
        fail("searched-plan tokens differ under the msb hook")
    with torch.no_grad():
        with D.use_policy(searched_policy):
            lp = forward(params, cfg, {"tokens": prompts})[..., :cfg.vocab_size]
        with D.use_policy(FDP91_KERNEL):
            lr = forward(params, cfg, {"tokens": prompts})[..., :cfg.vocab_size]
    serve_bits = float(np.median(metrics.correct_bits(lp, lr, cap=24)))
    del lp, lr
    if not serve_bits >= TAILOR_BUDGET:
        fail(f"the searched plan's full-width logits on the serve's prompts keep a median "
             f"{serve_bits:.3f} correct bits against FDP91's, below the budget of "
             f"{TAILOR_BUDGET}")
    past_msb = {k: int(v) for k, v in past_msb.items() if int(v)}
    wrapped = {k: int(v) for k, v in wrapped.items() if int(v)}
    log(f"searched-plan full-width logits on the serve's prompts: median correct bits "
        f"against FDP91 {serve_bits:.3f} (budget {TAILOR_BUDGET})")
    log(f"searched-plan serve against each pick's msb: {sum(n_checked.values())} FDP outputs "
        f"at {len(n_checked)} sites; past msb {sum(past_msb.values())} "
        f"({past_msb or 'none'}), past msb + ovf (wrapped) {sum(wrapped.values())} "
        f"({wrapped or 'none'})")
    log(f"serve qwen3-0.6b at full width from the searched plan: dense kernel launches "
        f"{tailored_launches} == FDP dispatches {n_tailored}; seconds per serve (after a "
        f"first of {tailored_first:.3f} s): {', '.join(f'{x:.3f}' for x in tailored_s)}; "
        f"median {tailored_med:.3f} s = {BATCH * GEN / tailored_med:.2f} tok/s, beside "
        f"{qwen['tok_s']:.2f} under {FDP91_KERNEL.name} and {qwen['fp32_tok_s']:.2f} under "
        f"{D.MXU_FP32.name} (phase 3, this run)")
    del params
    torch.cuda.empty_cache()
    params = weights(torch, cfg2, dev)
    with torch.no_grad():
        lt = {}
        for name, pol in (("plan", searched_policy), ("twin", simulate_twin(searched_policy)),
                          ("fdp91", FDP91_KERNEL), ("fp32", D.MXU_FP32)):
            with D.use_policy(pol):
                lt[name] = forward(params, cfg2, batch)
    if not bool(torch.isfinite(lt["plan"][..., :cfg2.vocab_size]).all()):
        fail("searched-plan logits are not finite")
    if not torch.equal(lt["plan"], lt["twin"]):
        fail(f"searched-plan logits != its simulate twin's: max |diff| "
             f"{(lt['plan'] - lt['twin']).abs().max().item()}")
    tailored_bits = float(np.median(metrics.correct_bits(
        lt["plan"][..., :cfg2.vocab_size], lt["fdp91"][..., :cfg2.vocab_size], cap=24)))
    if not tailored_bits >= TAILOR_BUDGET:
        fail(f"searched-plan logits keep a median {tailored_bits:.3f} correct bits against "
             f"FDP91's, below the budget of {TAILOR_BUDGET}")
    tailored_top1 = metrics.top1_agreement(lt["plan"][..., :cfg2.vocab_size],
                                           lt["fp32"][..., :cfg2.vocab_size])
    del params, lt
    torch.cuda.empty_cache()
    phase16_s = time.perf_counter() - t16
    log(f"2-layer full-width qwen3-0.6b {tuple(batch['tokens'].shape)}: searched-plan logits "
        f"torch.equal its simulate twin; median correct bits against FDP91 "
        f"{tailored_bits:.3f} (budget {TAILOR_BUDGET}); top-1 agreement with native fp32 "
        f"{tailored_top1:.4f}. Phase 16 took {phase16_s:.2f} s")
    tailoring = {
        "calibrate_s": cal_s, "trace_mb": trace_mb, "sites": len(trace.sites()),
        "search_s": {"pallas": search_k_s, "simulate": search_s_s,
                     "pallas_latency": search_l_s, "default_grid": search_d_s},
        "search_launches": {"pallas": launches_k, "pallas_latency": launches_l,
                            "default_grid": launches_d},
        "autotune": {k: sum(t[k] for t in search_autotune)
                     for k in ("keys", "launches", "seconds")},
        "validated_bits": validated, "upgraded": upgraded,
        "search_kernel_vs_plain": vs_plain,
        "plan": {s.site: {"tag": s.cfg.tag(), "error_bits": s.error_bits,
                          "energy_j": s.energy_j, "latency_us": s.latency_us,
                          "latency_us_91bit": lat91[s.site]} for s in res_l.plan.sites},
        "latency_moved": moved, "default_grid_picks": by_tag,
        "energy_vs_baseline": res_l.plan.meta["energy_vs_baseline"],
        "serve": {"launches": tailored_launches, "first_serve_s": tailored_first,
                  "serve_s": tailored_s, "tok_s": BATCH * GEN / tailored_med,
                  "fdp91_kernel_tok_s": qwen["tok_s"], "fp32_tok_s": qwen["fp32_tok_s"],
                  "top1_vs_fp32_2layer": tailored_top1,
                  "bits_vs_fdp91_2layer": tailored_bits,
                  "bits_vs_fdp91_full_width": serve_bits,
                  "fdp_outputs": sum(n_checked.values()), "past_msb": past_msb,
                  "wrapped": wrapped},
        "phase_s": phase16_s}

    # -- 17. the workload zoo and the validated search at full width ---------
    phase("17")
    workloads = workloads_phase(torch, dev, cfg, cfg2, searched_policy, res_l.plan,
                                zoo_policy, FDP_GRID, res_k, card_search, validating)
    torch.cuda.empty_cache()

    # -- 18. the continuous engine on one CUDA graph a model ------------------
    phase("18")
    from repro_torch.launch.batching import Request
    from repro_torch.obs import default_registry, recorder, save_chrome_trace
    t18 = time.perf_counter()
    recorder().clear()

    def qwen_requests():
        """Phase 3's 4 prompts (16 tokens, 16 generated), then prompts of 4,
        8, 12 and 16 tokens generating 8-16 each, from torch.Generator(1)."""
        g = torch.Generator().manual_seed(1)
        first = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g)
        reqs = [Request(uid=i, prompt=row.tolist(), max_new=GEN) for i, row in enumerate(first)]
        for i, n in enumerate((4, 8, 12, 16)):
            prompt = torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
            reqs.append(Request(uid=BATCH + i, prompt=prompt,
                                max_new=int(torch.randint(8, GEN + 1, (1,), generator=g))))
        return reqs

    def dbrx_requests():
        g = torch.Generator().manual_seed(2)
        return [Request(uid=i, prompt=torch.randint(0, mcfg.vocab_size, (n,),
                                                    generator=g).tolist(), max_new=m)
                for i, (n, m) in enumerate(((8, 8), (4, 6), (6, 8), (8, 4)))]

    params = weights(torch, cfg, dev)
    eng_q = engine_phase(torch, dev, cfg, params, qwen_requests, n_slots=BATCH, max_len=160,
                         policy=FDP91_KERNEL, label="qwen3-0.6b continuous engine")
    if eng_q["tokens"][:BATCH] != qwen["tokens"]:
        fail("the continuous engine's first four requests != phase 3's tokens")
    t3 = qwen["trace"][FDP91_KERNEL.name]
    log(f"qwen3-0.6b continuous engine: the first four requests' tokens == phase 3's "
        f"(admitted at cursor 0). Beside phase 3's simple serve (this run): "
        f"{qwen['tok_s']:.2f} tok/s, traced idle share "
        + ("not measured" if t3 is None else f"{100 * t3['idle_share']:.1f}%")
        + f"; graph engine {eng_q['result']['graph']['tok_s']:.2f} tok/s, eager engine "
        f"{eng_q['result']['eager']['tok_s']:.2f} tok/s")
    del params                                            # the host copy stays for phase 19
    torch.cuda.empty_cache()
    params = weights(torch, mcfg, dev)                    # phase 5's weights
    eng_d = engine_phase(torch, dev, mcfg, params, dbrx_requests, n_slots=2, max_len=64,
                         policy=FDP91_KERNEL, label="dbrx-132b continuous engine")
    # phase 22's dbrx references, while the main process holds these weights
    t_ref = time.perf_counter()
    shard_refs = shard_refs_dbrx(torch, dev, mcfg, params, dbrx["tokens"])
    ref18_s = time.perf_counter() - t_ref
    del params
    drop_weights(mcfg)
    torch.cuda.empty_cache()
    # (c) the phase's spans, exported and read back
    n_runs = eng_q["runs"] + eng_d["runs"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase18_trace.json")
        n_ev = save_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    evs = doc.get("traceEvents", [])
    runs = [e for e in evs if e["name"] == "serving.batcher_run"]
    if len(evs) != n_ev or len(runs) != n_runs or any(
            e["ph"] != "X" or e["dur"] < 0 or e["cat"] != "serving" or e["args"]["steps"] < 1
            for e in runs):
        fail(f"phase 18's chrome trace: {n_ev} events, {len(runs)} serving.batcher_run "
             f"(expected {n_runs} engine runs), or a malformed event")
    phase18_s = time.perf_counter() - t18
    log(f"phase 18's spans saved with save_chrome_trace and loaded back: {n_ev} events, "
        f"{len(runs)} serving.batcher_run == {n_runs} engine runs, steps "
        f"{sorted({e['args']['steps'] for e in runs})}. Phase 18 took {phase18_s:.2f} s")
    log("obs registry snapshot: " + json.dumps(default_registry().snapshot(), sort_keys=True))
    # what the wrappers counted: the graph engines' warm-up steps and the
    # eager twins' first runs. A replay goes through no wrapper: the replays'
    # kernels are the profiler's events, under their own key.
    engine_launches = {
        n: {f"{model} continuous engine, {what} (phase 18)":
            r[k]["launches_built_and_first_run"].get(n, 0)
            for model, r in (("qwen3-0.6b", eng_q["result"]), ("dbrx-132b", eng_d["result"]))
            for k, what in (("graph", "graph warm-up"), ("eager", "eager"))
            if n == "fdp_gemm" or model == "dbrx-132b"}
        for n in ("fdp_gemm", "fdp_ragged_gemm")}
    replay_events = {
        n: {model: None if tr is None else {"replays": tr["steps"],
                                            "kernel_events": tr["kernels"][n]}
            for model, tr in (("qwen3-0.6b", eng_q["result"]["graph"]["traced_steps"]),
                              ("dbrx-132b", eng_d["result"]["graph"]["traced_steps"]))
            if n == "fdp_gemm" or model == "dbrx-132b"}
        for n in ("fdp_gemm", "fdp_ragged_gemm")}
    continuous = {"qwen3-0.6b": eng_q["result"], "dbrx-132b": eng_d["result"],
                  "trace_events": n_ev, "phase_s": phase18_s}

    # -- 19. the routed serving tier and the monitor at full width ------------
    phase("19")
    params = weights(torch, cfg, dev)                     # phase 3's weights
    routed = routed_phase(torch, dev, cfg, params, qwen["tokens"], searched, searched_policy,
                          workloads["zoo"], eng_q["result"]["graph"]["tok_s"])
    del params
    torch.cuda.empty_cache()
    routed_launches = routed["routed"]["launched"].get("fdp_gemm", 0)
    routed_replays = routed["routed"]["replays_traced"]
    monitored_launches = routed["monitor"]["launched"].get("fdp_gemm", 0)
    monitored_replays = routed["monitor"]["traced"]["monitored"]

    # -- 20. autotune and the schedule zoo ------------------------------------
    phase("20")
    params = weights(torch, cfg, dev)                     # phase 3's weights
    sched = schedules_phase(torch, dev, cfg, params, qwen["tokens"], eng_q["tokens"],
                            qwen_requests, qwen["tok_s"], eng_q["result"]["graph"]["tok_s"])
    del params
    torch.cuda.empty_cache()
    autotune_launches_total = tailoring["autotune"]["launches"] + sched["autotune_launches"]

    # -- 21. data parallelism: four ranks on the card -------------------------
    phase("21")
    t_ref = time.perf_counter()
    params = weights(torch, cfg, dev)                     # phase 3's weights
    shard_refs.update(shard_refs_qwen(torch, dev, cfg, params))
    shard_refs["qwen_prompts"] = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                               generator=torch.Generator().manual_seed(1))
    shard_refs["qwen_serve_tokens"] = qwen["tokens"]
    del params
    drop_weights(cfg)
    torch.cuda.empty_cache()
    ref21_s = time.perf_counter() - t_ref
    mesh = mesh_phase(torch, cfg.name, shard_refs)
    # phase 22 ran in phase 21's world: its seconds run from the last rank's
    # end of phase 21 to the world's end, and its references' seconds (in
    # the main process, during phases 18 and 21) count in it, not there
    p22_s = mesh["p22_wall_s"] + ref18_s + ref21_s

    # -- 23. the Mamba-2 families at published widths --------------------------
    phase("23")
    ssm = ssm_phase(torch, dev)

    # -- 24. the encoder-decoder and VLM families at published widths -------------
    phase("24")
    families = family_phase(torch, dev)

    # -- 25. placed parameters and launch.serve --mesh -------------------------------
    phase("25")
    placed = place_phase(torch, dev)

    phase("")
    PHASE_S["18"] -= ref18_s
    PHASE_S["21"] -= mesh["p22_wall_s"] + ref21_s
    PHASE_S["22"] = p22_s
    log(f"seconds by phase: {json.dumps({k: round(v, 2) for k, v in PHASE_S.items()})}; "
        f"phases 1-25 {sum(PHASE_S.values()):.2f} s")
    moe_in = ragged_sites["moe_in"]
    dw_in = dw_sites["moe_in"]
    hot = loop_sites["bench hot shape"]
    print(json.dumps({"kernels": [{
        "name": "fdp_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:65",
        "launches": (qwen["launches"]["fdp_gemm"] + dbrx["launches"]["fdp_gemm"]
                     + train["launches"]["fdp_gemm"] + launches_k + launches_l + launches_d
                     + tailored_launches + workloads["launches"]["total"]
                     + sum(engine_launches["fdp_gemm"].values()) + routed_launches
                     + monitored_launches
                     + autotune_launches_total + sched["dense_launches_on_persisted"]
                     + mesh["launches"] + mesh["p22"]["launches"]["fdp_gemm"]
                     + sum(r["launches"] for r in ssm.values())
                     + sum(r["launches"] + r.get("graph_engine", {}).get("warmup_launches", 0)
                           for r in families.values())
                     + sum(placed["launches"].values())),
        "launches_by_path": {"qwen3-0.6b serve": qwen["launches"]["fdp_gemm"],
                             "dbrx-132b serve": dbrx["launches"]["fdp_gemm"],
                             "dbrx-132b train step": train["launches"]["fdp_gemm"],
                             "qwen3-0.6b search (phase 16)":
                                 launches_k + launches_l + launches_d,
                             "qwen3-0.6b serve from the searched plan (phase 16)":
                                 tailored_launches,
                             "qwen3-0.6b workloads and validated search (phase 17)":
                                 workloads["launches"]["total"],
                             **engine_launches["fdp_gemm"],
                             "routed tier (phase 19)": routed_launches,
                             "monitored graph engine, warm-up (phase 19 b)":
                                 monitored_launches,
                             "autotuner's candidates (phases 16, 20)": autotune_launches_total,
                             "serve and graph engine on the cuda zoo (phase 20)":
                                 sched["dense_launches_on_persisted"],
                             "qwen3-0.6b mesh step, 1x4, summed over 4 ranks on the "
                             "card (phase 21)": mesh["launches"],
                             "sharded forward and serves, summed over 4 ranks on the card "
                             "(phase 22)": mesh["p22"]["launches"]["fdp_gemm"],
                             **{f"{arch} serve, {r['layers']} layers (phase 23)": r["launches"]
                                for arch, r in ssm.items()},
                             **{f"{arch} serve, {r['depth']} layers (phase 24)": r["launches"]
                                for arch, r in families.items()},
                             **{f"{arch} graph engine's two warm-up steps (phase 24)":
                                r["graph_engine"]["warmup_launches"]
                                for arch, r in families.items() if "graph_engine" in r},
                             **{f"qwen3-0.6b placed serve 2x2 {profile}, {PLACE_LAYERS} layers, "
                                f"summed over 4 ranks on the card (phase 25)": n
                                for profile, n in placed["launches"].items()}},
        "graph_replays_traced": {
            **replay_events["fdp_gemm"],
            "qwen3-0.6b routed tier, fdp91_kernel (phase 19)": None if routed_replays is None
            else {"replays": routed_replays["steps"],
                  "kernel_events": routed_replays["kernels"]["fdp_gemm"]},
            "qwen3-0.6b monitored graph engine, searched (phase 19 b)":
                None if monitored_replays is None
                else {"replays": monitored_replays["steps"],
                      "kernel_events": monitored_replays["kernels"]["fdp_gemm"]}},
        "max_abs_err": max_err,
        "ms": lm["ms"], "plain_ms": lm["plain_ms"], "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"], "library_ms": None,
        "at": f"qwen3-0.6b lm_head {tuple(lm['shape'])} fp32 {P91.describe()}",
        "mlp_in": mi, "router_2d": {**router, "launches": dbrx["calls"]["moe_router"]},
        "dense_shapes": dense, "sass": sass["fdp_gemm.cu"],
        "serve_kernel_s_estimate": qwen["kernel_s_estimate"],
        "serve_trace": qwen["trace"], "tailoring": tailoring, "workloads": workloads,
        "continuous": continuous, "routed_serving": routed, "schedules": sched,
        "mesh": {k: v for k, v in mesh.items() if k != "launches"},
        "ssm_families": ssm, "encdec_vlm_families": families, "placed": placed,
    }, {
        "name": "fdp_ragged_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_ragged_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:282",
        "launches": (dbrx["launches"]["fdp_ragged_gemm"] + train["launches"]["fdp_ragged_gemm"]
                     + sum(engine_launches["fdp_ragged_gemm"].values())
                     + mesh["p22"]["launches"]["fdp_ragged_gemm"]),
        "launches_by_path": {"dbrx-132b serve": dbrx["launches"]["fdp_ragged_gemm"],
                             "dbrx-132b train step": train["launches"]["fdp_ragged_gemm"],
                             **engine_launches["fdp_ragged_gemm"],
                             "dbrx-132b TP serves, summed over 4 ranks on the card "
                             "(phase 22)": mesh["p22"]["launches"]["fdp_ragged_gemm"]},
        "graph_replays_traced": replay_events["fdp_ragged_gemm"],
        "max_abs_err": ragged_err,
        "ms": moe_in["ms"], "plain_ms": moe_in["plain_ms"], "bound_ms": moe_in["bound_ms"],
        "bound_by": moe_in["bound_by"], "library_ms": None,
        "at": f"dbrx-132b moe_in decode {tuple(moe_in['shape'])} groups "
              f"{moe_in['groups']} fp32 {P91.describe()}",
        "sites": ragged_sites, "training_sites": ragged_train,
        "sass": sass["fdp_ragged_gemm.cu"],
        "dbrx_serve": {k: v for k, v in dbrx.items() if k != "trace"},
        "dbrx_serve_trace": dbrx["trace"], "dbrx_1layer_pallas_vs_simulate": dbrx_eq,
    }, {
        "name": "fdp_ragged_dw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_ragged_dw.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:363",
        "launches": train["launches"]["fdp_ragged_dw"],
        "launches_by_path": {"dbrx-132b train step": train["launches"]["fdp_ragged_dw"]},
        "max_abs_err": dw_err,
        "ms": dw_in["ms"], "plain_ms": dw_in["plain_ms"], "bound_ms": dw_in["bound_ms"],
        "bound_by": dw_in["bound_by"], "library_ms": None,
        "at": f"dbrx-132b moe_in@bwd.dB {tuple(dw_in['shape'])} groups {dw_in['groups']} "
              f"fp32 {P91.describe()}; plain_ms on {dw_in['plain_at']}",
        "sites": dw_sites, "readout": dw_readout, "sass": sass["fdp_ragged_dw.cu"],
        "dbrx_train": train, "dbrx_1layer_grads_pallas_vs_simulate": grads_eq,
    }, {
        "name": "fdp_gemm_looped", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm_looped.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:103",
        "launches": loop_launches,
        "launches_by_path": {"seed-order vs vector comparison (phase 12)": loop_launches},
        "max_abs_err": loop_err,
        "ms": hot["ms"], "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"], "library_ms": None,
        "at": f"bench hot shape {tuple(hot['shape'])} at the seed tile {tuple(hot['plan'])} "
              f"fp32 {P91.describe()}",
        "shapes": loop_sites, "generator": gen_runs,
        "qwen_plan_serve": plan_serve, "qwen_zoo_plan_serve": zoo_serve,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
