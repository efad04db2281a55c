#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

It drives the paths of the port, each through the entry points a user
calls: the pointnet2-cls forward (8 clouds of 1024 points), the
pointnet2-seg forward (8 clouds of 4096 points, whose FP stages run the
knn3 kernel), both through get_accelerator(CONFIG, policy).infer at full
width, the flat lattice query (`lattice_query_fused`) at the example
pipeline's shape (2048 points, 64 centroids) and at a seg-sized set (4096
points, 1024 centroids), and the serving path: ServingRuntime.submit
through the queue, the scheduler, the replica pool (its own CUDA streams
and worker threads), the preprocess cache and the pipelined executor, and
then its control plane (fault injection, autoscaler, adaptive controller,
exporters), training (launch/train.py, its step one captured CUDA
graph), and multi-device serving (a replica over a device group running
the batch- and tensor-sharded artifacts, and the GPipe schedule), and
the paper's comparison paths (baseline-1 global L2 FPS and ball query,
baseline-2 grid tiles, standard aggregation), dense LM serving
(make_serve_fns: stablelm-1.6b at full width and 12 layers, gemma3-12b at
full width and 6 layers, every linear on the SC matmul kernel under a
quant policy), dense LM training (make_train_step and train_lm, the
SC kernel in the forward and in the remat recompute), the moe, ssm and
hybrid LM families (granite-moe-3b-a800m, dbrx-132b, mamba2-1.3b,
recurrentgemma-2b) and the encdec and vlm families (whisper-small with its
cross-attention, internvl2-2b with its patch connector) through the same
two entry points, and the LM's device layout (the host mesh, the
activation hints, the op counter and the dry run).  On
the card the entry points replay captured CUDA graphs (core/graphs.py, the
counterpart of the JAX package's jit artifacts) unless the caller enters
graphs.eager(), which is the reference side of every graph check.

Phases, each of which stops the run with a non-zero exit code if it fails:

  1. print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from src/repro_torch/csrc with nvcc for
     sm_90a, one nvcc per source, all at once, and print ptxas's report of
     every instantiation (registers, shared memory, stack, spills);
  3. run one cls and one seg forward (quant="sc_w16a16") and the flat path
     eagerly (graphs.eager(): a graph replay calls no kernel wrapper from
     Python) while recording every kernel call's inputs, then hold each kernel
     against its plain PyTorch version on those inputs on the card
     (bitwise), and time kernel, plain version and, for the SC matmul, one
     float64 torch.matmul of the same operands: the card's busy time a call
     from torch.profiler (a session counts only if it recorded `reps` times
     the device events of one call; else it is profiled again, up to three
     times, and then timed by CUDA events around calls queued behind a spin
     kernel), and the time between CUDA events around back-to-back calls,
     which includes the host's enqueue time.  Then one cls and one seg
     forward under quant="sc_w8a8", every SC call held against the plain
     version bitwise;
  4. the paths, counted: for each path (and policy), every launch counter
     set to 0 just before it and read just after.  cls and seg run
     get_accelerator(CONFIG, policy).infer on a few batches of 8 clouds for
     quant="none" and quant="sc_w16a16"; a cls forward must launch 2 FPS,
     2 lattice and (under SC) 12 SC-matmul kernels, a seg forward 2 FPS,
     2 lattice, 2 knn3 and (under SC) 12 SC-matmul kernels, and the flat
     path one flat lattice kernel a query; one cls and one seg batch under
     "sc_w8a8" are counted likewise.  The first infer of a shape runs
     eagerly and captures its graph, which counts nothing; each later one
     replays it, which adds the captured launches.  Then a forward per batch is
     timed under both policies and one is profiled (device time by kernel,
     and the device's idle share) until two profiler sessions agree on the
     largest kernel count seen, up to five (PROFILE_TRIES; after five, the
     largest count two sessions agree on); in that session and in every one
     that recorded more events, the port's kernels the profiler saw, by
     symbol (KERNEL_SYMBOLS), must equal the launches the counters were
     credited in it;
  5. check the outputs against the port's own CPU run (plain versions):
     preprocessing, the seg FP stages' 3-NN indices and the flat query
     bitwise; logits finite, of shape (8, 8) for cls and (8, 4096, 8) for
     seg, and within the stated tolerance (the sc_w8a8 batch too);
  6. the graphs: for cls and seg under both policies, with a fresh params
     copy, each entry point (infer, infer_with_preprocess, preprocess_stage,
     feature_stage, feature_from_cached) is captured on one batch and
     replayed on another, bitwise equal to graphs.eager() on that batch
     (every leaf of the preprocessing too), with the launches of each
     replay equal to the per-forward counts, each replay profiled and its
     credited launches held against the port's kernels the card ran, and no
     capture after the first calls; the flat path is captured and replayed
     likewise.  It prints the
     eager and the replayed forward (host clock, median of 10), the device
     busy time and the idle share of each;
  7. the serving path at full width, every launch counter set to 0 before
     each counted run: ServingRuntime (bucket n_points, max_batch 8) serves
     64 ragged cls clouds of 600-1500 points under quant="none" and
     "sc_w16a16", each sequential and pipelined, and 16 seg clouds of
     3000-6000 points; every response must be bitwise equal to a direct
     eager infer (graphs.eager()) on the card of the padded micro-batch it
     rode in (rebuilt from the trace's batch members), no graph captured
     after the runtime's warmup, the pipelined responses bitwise equal to
     the sequential ones, the launches equal to the per-forward counts of
     phase 4 times the batches the metrics record (warmup included), with
     0 retries, 0 evictions and no failed request.  Then 16 cls clouds
     twice through the preprocess cache under SC: the second round is all
     hits, launches no FPS or lattice kernel, and answers bitwise as the
     first.  It prints requests/s and p50/p99 latency of each run, the
     device idle share of one micro-batch through the runtime (whose
     profile holds the credited launches against the kernels seen), and the wall
     time of 8 micro-batches through infer_pipelined against 8 infer calls,
     all replaying graphs;
  8. the serving control plane, pointnet2-cls on two replicas of the card
     with the trace, a Prometheus listener and a Reporter (its lines go to
     stderr), every launch counter set to 0 before each of its two runs.
     The chaos run (float and SC, autoscaler on) takes a kill of replica 0,
     a wedge of replica 1 that the heartbeat monitor evicts, the warm
     rejoins, and three more kill -> rejoin cycles, reading
     memory_allocated and memory_reserved around them.  The adaptive run
     serves clouds skewed small at one bucket, then the controller's
     poll_once splits the bucket while a feeder thread keeps submitting,
     and a reconfigure rolls the swap back.  Every response must be
     bitwise equal to an eager infer of its padded batch at its bucket,
     every graph capture (timed) must fall inside a warmup, a rejoin or a
     reconfigure, the rollback must capture nothing, /metrics must report
     the completed count seen, trace_problems must be empty,
     batch_crosscheck must cover every real batch, and neither the
     autoscaler nor the controller may record an error.  It prints the
     memory of one replica and its graphs, the growth per cycle, the
     capture time per new shape and p50/p99 inside the swap window, and
     writes both runs' Chrome traces under build/;
  9. training (launch/train.py): for pointnet2-cls (8 x 1024) and
     pointnet2-seg (8 x 4096), each in float and sc_w16a16, from seeded
     params and the same data.pointclouds batches: step 1's loss and
     gradients on the card (deterministic kernels) against the port's CPU
     run (TRAIN_GRAD_TOL); 5 eager steps against 5 steps of TrainStep, whose first call runs
     eagerly and captures the whole step (forward, torch.autograd.grad,
     AdamW in place) as one CUDA graph and whose later calls replay it,
     bitwise in every loss, parameter, moment and the step count under
     torch.use_deterministic_algorithms (scoped to that check, since the
     backward's scatter-adds race otherwise), with the launches of the 4
     replays = 4 x the per-forward counts of phase 4 and one capture; a
     checkpoint of {"params", "opt"} written from the card and read back
     bitwise; the "loss" graph's replay against eager.  Then, with the
     default kernels, 5 eager steps twice (their spread is printed) and 5
     replays, timed (host clock, median), one replay profiled (busy time,
     idle share, credited launches against the kernels the card ran), and
     the peak memory_allocated of each above what was allocated before it.  Last, train_pointcloud trains
     pointnet2-cls in float for 30 steps and the mean loss over its batches
     must fall;
 10. multi-device, on the cards present (shard_layout): two groups of two
     cards where there are four or more, one group of two cards where there
     are two or three, two shards on cuda:0 where there is one (it says
     which).  The kernels' calls of one sharded SC forward of cls and seg in
     each mode are held against their plain versions, bitwise.  Then
     get_accelerator(CONFIG, policy).mesh_artifacts(group).infer for cls
     and seg, quant in {none, sc_w16a16} x sharding in {batch, tensor},
     each counted on every group: launches = group size x the per-forward
     counts, SC logits bitwise equal to single-device eager infer, float
     bitwise or within LOGIT_ATOL["none"] (then the split matmuls that
     differ are named); it prints the eager sharded forward (host clock,
     median of 10), the card's busy time, and the single-device eager and
     replayed forward.  A ServingRuntime of pointnet2-cls (max_batch 8,
     devices_per_replica 2, two replicas, the autoscaler on) serves 32
     ragged clouds under sharding="batch", 32 under SC "tensor" and 8
     unsharded side by side, then a kill of replica 0 and its warm rejoin
     onto the same group (no MeshArtifacts built after the warmup), with 0
     failed requests, launches = the batch records' counts (warmup and
     rejoin included), and every response against an eager infer of its
     padded batch as above; it prints requests/s and p50/p99.  Last,
     pipeline_forward over 4 stages on min(4, cards) cards at (mb 4, d 16)
     and (mb 64, d 1024) against the sequential composition, within 2e-5;
 11. the paper's comparison paths: for cls (8 x 1024) and seg (8 x 4096),
     quant in {none, sc_w16a16}, the five corners other than the main
     path's (COMPARISON_CORNERS: baseline1/standard, baseline2/standard,
     pc2im/standard, baseline1/delayed, baseline2/delayed), each through
     get_accelerator(dataclasses.replace(CONFIG, preproc=..., aggregation=...),
     policy).infer.  Every kernel call of one eager forward is held against
     its plain version bitwise, and the calls at shapes phase 3 did not see
     (baseline1's global L2 FPS, standard aggregation's grouped SC rows) are
     timed as phase 3 times its calls; a forward must make, and each counted
     run launch, per stage 1 FPS kernel unless baseline2 (whose masked FPS,
     grid partition and ball query are plain ops, as in the reference) and
     1 lattice kernel under pc2im, plus 12 SC matmuls under SC and 2 knn3 for
     seg.  The replay of infer, infer_with_preprocess, preprocess_stage,
     feature_stage and feature_from_cached is bitwise equal to graphs.eager(),
     the preprocessing bitwise equal to the port's CPU run and the logits
     within LOGIT_ATOL of it.  It prints each corner's eager and replayed
     forward (host clock, median of 10), busy and idle share (profiled, with
     the credited launches held against the kernels the card ran) and peak
     memory, each pipeline's preprocess_stage replay alone, and fig12a's
     sampling quality (L1 against L2 FPS through the FPS kernel, the lattice
     kernel's recall of the ball query's neighbours), equal to the CPU run;
 12. dense LM serving through make_serve_fns(cfg, policy).  stablelm-1.6b at
     full width in bf16, cut to LM_LAYERS (12) of its 24 layers since phase
     14 came (weights drawn on the card from SEED)
     generates LM_NEW tokens for LM_BATCH prompts of LM_PROMPT tokens (caches
     of LM_S_MAX) under quant none, sc_w16a16 and sc_w8a8, each with float
     and int8 KV caches: generate, a prefill and a decode step are counted
     (7 SC matmuls a layer a step under SC, 84 for 12 layers; none in
     float), prefill's and decode's greedy tokens must be generate's, and
     every SC call of one eager prefill and decode step is held against the
     plain version bitwise, each new shape timed as phase 3 times its calls
     (float64 torch.matmul as the library call).  It prints prefill ms and
     decode ms a token (host clock, median of 10), busy and idle share of
     each (profiled: the SC kernels the card ran = the launches credited)
     and the peak allocated by generate.  Then stablelm cut to
     LM_CPU_LAYERS layers (full width, bf16) on the card against the port's
     CPU run of the same params: prefill logits and LM_CPU_STEPS
     teacher-forced decode steps within LM_CPU_TOL.  Then gemma3-12b at full
     width cut to one group of its 5:1 pattern (6 layers): 2 prompts of
     1280 tokens, past its 1024 window (prefill rolls the local caches), and
     8 decode steps, float and sc_w16a16, counted, every SC call of a
     prefill and a decode step held bitwise and new shapes timed;
 13. dense LM training through make_train_step(cfg, policy=...), eager.
     stablelm-1.6b at full width and LM_LAYERS layers in bf16 with remat "full"
     (weights drawn on the card from SEED) takes LM_TRAIN_STEPS steps of
     LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens from data.tokens.token_stream under
     quant none, sc_w16a16 and sc_w8a8, every step counted: 2 x 84 SC
     launches a step under SC (each of the 7 linears of the 12 layers once
     in the forward and once in the backward's recompute), none in float.
     Every SC call of step 1 is held against the plain version bitwise as it
     is made, and the new shapes (2048 rows) are timed as phase 3 times its
     calls.  The losses must be finite, and in float the loss on step 1's
     batch must fall over the steps.  It prints the eager step time (host
     clock, median of steps 2-5), busy and idle share of one profiled step
     (the SC kernels the card ran = the launches credited), the memory
     after init and the peak.  train_lm itself (the entry point of `python -m
     repro_torch.launch.train`) runs LM_ENTRY_STEPS SC steps, counted.
     Then stablelm cut to LM_CPU_LAYERS layers (full width, bf16) on the
     card against the port's CPU run of the same params and batch: the loss
     within LM_TRAIN_LOSS_TOL and every gradient leaf within
     LM_TRAIN_GRAD_TOL (SC: the nonzero pattern too).  Last, gemma3-12b at
     full width cut to one group of 6 layers, one sequence of 2048 tokens
     (past its 1024 window), GEMMA_TRAIN_STEPS float steps: losses finite,
     step times and peak memory;
 14. the moe, ssm and hybrid LM families (lm_families_phase), bf16,
     weights drawn on the card from SEED.  Serving through
     make_serve_fns under quant none, sc_w16a16 and sc_w8a8 (FAMILY_SERVE):
     granite-moe-3b-a800m (32 layers, 4 x 128 + 16, also int8 caches),
     mamba2-1.3b (48 layers, 4 x 128 + 16), recurrentgemma-2b (26 layers,
     2 x 2176 + 8, past its 2048 window: the local caches keep 2048 rolled
     entries) and dbrx-132b cut to 2 of its 40 layers (1 x 512 + 8: its
     ~250 GB of bf16 weights do not fit in 80 GB; the run says so), each
     with generate, a prefill and a decode step counted (the SC launches a
     step lm_linears gives: 160, 96, 200, 10; none in float), the greedy
     tokens of prefill and decode equal to generate's, every SC call of a
     prefill and a decode step held against the plain version bitwise and
     the FAMILY_TIMED_KN shapes (routers, mamba2's in_proj and out_proj,
     the RG-LRU's square linears) timed as phase 3 times its calls; prefill
     ms and decode ms a token (host clock, median of FAMILY_TIMED), busy and
     idle share (profiled: decode always, prefill in float), the peak of
     generate.  Training through
     make_train_step (remat "full", FAMILY_TRAIN_STEPS steps of
     FAMILY_TRAIN_ROWS tokens, quant none and sc_w16a16) for granite,
     mamba2 and recurrentgemma at full width and depth: each step counted
     (lm_linears(train=True): 320, 192, 384 SC launches), every SC call of
     step 1 held bitwise, the float loss on step 1's batch must fall; step
     ms, memory after init and peak, busy and idle of a profiled step, in
     which the card must run as many SC kernels as were counted.  Then each of the three at
     smoke width on the card against the port's CPU run: prefill and
     LM_CPU_STEPS teacher-forced decode steps within LM_CPU_TOL, under SC
     the MoE's top-k picks equal (their count of differences printed, 0),
     step 1's loss and gradients within phase 13's bounds;
 15. the encdec and vlm LM families (lm_encdec_vlm_phase), bf16, full
     width and depth, weights and stub frontend outputs drawn on the card
     from SEED.  Serving through make_serve_fns under quant none,
     sc_w16a16 and sc_w8a8 (ENCDEC_VLM_SERVE): whisper-small, 4 prompts of
     64 tokens over ENCDEC_FRAMES (1536) stub encoder frames, s_max 128, 16
     new tokens; internvl2-2b, 4 x (256 patches + 128 tokens), s_max 512,
     16 new tokens.  A generate, a prefill and a decode step counted (SC
     launches encdec_vlm_linears gives: 192 / 96 whisper, 169 / 168
     internvl2; none in float), greedy tokens equal to generate's, float
     caches of the shapes the reference's have (whisper's cross caches the
     frames'), every SC call of a prefill and a decode step held bitwise
     and the ENCDEC_VLM_TIMED_KN shapes timed as phase 3 times its calls;
     prefill and decode ms (median of FAMILY_TIMED), busy and idle share
     (profiled: decode always, prefill in float).  Training through
     make_train_step (remat "full", ENCDEC_VLM_TRAIN_STEPS steps of
     ENCDEC_VLM_TRAIN_ROWS tokens; whisper with the reference's zero
     frames, internvl2 with seeded normal patches, since zero ones overflow
     its gradient, in the reference too) under the three policies: 384 / 337 SC launches a step, step 1 held bitwise, the
     float loss on step 1's batch must fall; step ms, memory after init and
     peak, busy and idle of a profiled step, in which the card must run as
     many SC kernels as were counted.  Then both at smoke width on
     the card against the port's CPU run: prefill and LM_CPU_STEPS
     teacher-forced decode steps within LM_CPU_TOL, step 1's loss and
     gradients within phase 13's bounds (whisper's key biases, whose exact
     gradient is zero, within ZERO_GRAD_REL of the largest);
 16. the LM's device layout and dry run (lm_mesh_phase): stablelm-1.6b at
     full width and LM_LAYERS layers (bf16, weights drawn on the card from
     SEED) on the host mesh (launch.mesh.make_host_mesh, 1 x 1 on this
     card).  Its parameters, AdamW state and an LM_TRAIN_BATCH x
     LM_TRAIN_SEQ batch are placed (sharding.spec.place) by
     to_shardings(param_pspecs(...)) under MESH_POLICIES; one sc_w16a16
     train step under activation_sharding(mesh, mode) for each MESH_MODES
     mode is bitwise equal to the same step outside any context (loss, grad
     norm, every parameter), each counted (168 SC launches), every SC call
     of the first held against the plain version; a float and an SC prefill
     of LM_BATCH x LM_PROMPT and MESH_DECODE decode steps likewise, counted.
     The op counter (launch/hlo_analysis) over the float and the SC prefill
     on the card equals its count on meta tensors (ops, FLOPs, bytes), beside
     model_flops.  Placing the state grows memory_allocated by the dry run's
     per-device argument bytes of the same cell, within ALLOC_ROUND a
     tensor.  Last, launch/dryrun's run_cell for MESH_CELLS on meta, each
     timed, their roofline terms on this card (counted FLOPs of each type
     over n_devices x that type's peak in MESH_PEAKS, summed; bytes over
     n_devices x PEAK_BYTES_PER_S), and the skipped MESH_SKIPPED with the
     reference's reason;
 17. the comparison corners through the runtime, and the examples
     (corner_runtime_phase, examples_phase), by the checks phases 7, 9 and
     10 share (counted_serve, step1_against_cpu and replay_against_eager,
     sharded_forward).  For cls (8 x 1024) and seg (8 x 4096) in each corner
     of RUNTIME_CORNERS (baseline1/standard and baseline2/delayed, float and
     sc_w16a16; pc2im/standard under SC, for standard aggregation's SC scale
     path), with params drawn from SEED: every kernel call of one eager
     forward, of the card's step-1 gradient and of the SC sharded forwards
     held against its plain version bitwise, a call at a shape phase 3 did
     not time timed by CUDA events (kernel and plain version, back-to-back
     calls); a ServingRuntime (bucket n_points, max_batch 8) serving phase
     7's SERVE_TRAFFIC, queued before it starts, once in float and under SC
     twice through the preprocess cache (the second round all hits), then
     clouds[0] alone (an all-hit batch with 7 filler rows), each round
     counted as in phase 7, memory_allocated read after the warmup, each
     round's median batch time on the replica and its latency p50 and max
     (the first round's latencies are mostly a request's place in the queue
     filled before the start); training: step 1's loss and gradients on the
     card against the port's CPU run on CORNER_CPU_ROWS clouds
     (TRAIN_GRAD_TOL), CORNER_TRAIN_STEPS steps replayed and eager as in
     phase 9, eager and replayed step ms, busy and idle of a profiled
     replay; sharding: mesh_artifacts over two shards of cuda:0 in both
     modes as in phase 10.  Then each point-cloud example (EXAMPLE_RUNS:
     examples/torch_*.py) through its main() at its full config, counted,
     its own check required, its wall time printed.  One JSON line carries
     phase 17's numbers.

Then it prints one JSON line with every kernel's launches (summed over the
counted runs of phases 4 and 6-17; a replay's are the launches its
capture recorded, which the profiled replays of phases 4, 6, 7 and 9 show
the card running), error and times (summed over the calls recorded in
phase 3, with a breakdown by path), the card line again, and as its last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Inputs and weights come from numpy / torch generators seeded with SEED;
neither jax nor the JAX package is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
N_BATCHES = {"cls": 3, "seg": 2}
TIMED_FORWARDS = 10
# Profiler sessions of one forward before a run gives up on two agreeing on
# the largest device-event count: a session now and then loses events, and
# the run profiles twelve forwards (phases 4 and 6) and a served batch.
PROFILE_TRIES = 5
# The flat lattice query: (points, centroids, radius, nsample), one cloud each.
# examples/preprocess_pipeline.py's query, and a seg-sized one (SA1's counts).
FLAT_SETS = ((2048, 64, 0.3, 16), (4096, 1024, 0.2, 32))
# Logit tolerance card vs CPU.  Float: cuBLAS and the CPU BLAS sum the
# matmuls in different orders (~1e-7 relative per layer).  SC: the integer
# products are exact, but a float difference upstream can move an
# activation across a rounding boundary of the 16-bit quantizer, one
# quantum (max|x| / 32767) at a time.  Both models get the same bounds.
# SC W8A8: the same reason with a quantum of max|x| / 127, 258 times the
# 16-bit one, and about as many more activations that cross a boundary; the
# 16-bit bound scaled by that ratio would be 0.5.  Measured on an H100: cls
# 1.1e-2, seg 5.6e-2 (every SC call bitwise equal to the plain version).
LOGIT_ATOL = {"none": 1e-4, "sc_w16a16": 2e-3, "sc_w8a8": 0.25}
# Serving phase: (model, clouds, smallest and largest cloud) of its traffic,
# served at the model's full width in one bucket of n_points.
SERVE_TRAFFIC = {"cls": (64, 600, 1500), "seg": (16, 3000, 6000)}
SERVE_CACHE_CLOUDS = 16  # cls clouds served twice through the preprocess cache
SERVE_WAIT_S = 300  # bound on every future the serving phase waits for
# Control-plane phase: pointnet2-cls served by two replicas on the one card,
# ragged clouds of CONTROL_SIZES points in waves of CONTROL_WAVE (float and
# SC alternating, so each wave is one full batch of each policy).
CONTROL_SIZES = (300, 1500)
CONTROL_WAVE = 16
CONTROL_WAVES = 8  # most waves the kill and the wedge may take to fire
# The liveness timeout must exceed a replica's slowest batch, which is its
# warmup: two graphs captured while the other replica may hold the capture
# lock.  The wedge outlasts it, so the heartbeat monitor evicts the replica.
# The monitor checks every timeout / 4 and the pump beats as often, so the
# eviction lands at most 1.5 timeouts after the wedge starts.
CONTROL_HEARTBEAT_S = 3.0
CONTROL_WEDGE_S = 5.5
CONTROL_REJOIN_DELAY_S = 0.1
CONTROL_CYCLES = 3  # further kill -> rejoin cycles of replica 0 (memory)
# A dead replica's frees reach the allocator's count a moment after the last
# Python reference goes (no Python object holds them by then): each memory
# reading after a rejoin waits up to this long for the allocation to come back
# to within 1 MiB of the two warm replicas' level, and reports how long it took.
CONTROL_SETTLE_S = 5.0
CONTROL_REPORT_S = 2.0  # the Reporter's period (its lines go to stderr)
# The adaptive swap: traffic skewed to small clouds (3 in 4 of 300-480
# points), which makes propose_buckets split the one 1024 bucket.
ADAPT_BEFORE = 96  # clouds served at the 1024 bucket before the swap
ADAPT_FEED = 400  # clouds a feeder thread submits, one every ADAPT_FEED_S
ADAPT_FEED_S = 0.001
# A crosscheck's |span - recorded| / recorded bound, the JAX package's own
# (tests/test_trace.py `test_crosscheck_on_real_run`).
CROSSCHECK_REL = 0.5
# Training phase: each model and policy takes TRAIN_STEPS steps of batches
# from data.pointclouds (the batch keys of launch/train.py) at the
# reference's default learning rate.
TRAIN_STEPS = 5
TRAIN_LR = 3e-4
# Step 1 on the card against the port's CPU run.  Loss: as LOGIT_ATOL's
# reasons, on a mean of log-softmaxes.  Gradients, of each leaf's max |g|:
# float 5e-3.  Two card runs agree to ~4e-7 (the backward's racing
# scatter-adds), but the card's forward differs from the CPU's by ~1e-7,
# and where two neighbours' features nearly tie in a masked max-pool that
# sends the max's gradient to the other one: measured up to 1.0e-3 of the
# leaf's max on an H100 (cls SA layers; PERF.md, sec. 6).  SC: a weight's
# gradient comes only through the two quantizer scales (round and the
# int32 cast cut the rest, as in the reference), so the nonzero pattern
# above TRAIN_SC_FLOOR must be equal (below it lie denormals, which the
# card keeps and the CPU may not), and the values within 1e-3 of the leaf's
# max where that is at least 1e-3 (measured <= 1.4e-4), 1e-1 below it
# (measured <= 4.1e-2): such a leaf's gradient passes through the amax of
# later layers' inputs, a sum over a whole activation in which the card's
# and the CPU's few differing 16-bit quanta do not cancel, more so each
# layer back (tests/test_torch_train.py measures <= 1.05e-2 between the
# port and the JAX package on the CPU at smoke width).
TRAIN_LOSS_ATOL = {"none": 1e-5, "sc_w16a16": 1e-3}
TRAIN_GRAD_TOL = {"none": 5e-3, "sc_w16a16": 1e-3, "sc scale path": 1e-1}
TRAIN_SC_FLOOR = 1e-30
# Learning check: pointnet2-cls in float through train_pointcloud itself.
LEARN_STEPS = 30
LEARN_LR = 3e-4
# Sharding phase: pointnet2-cls served by two replicas over device groups of
# two (shard_layout), ragged clouds of SHARD_SERVE_SIZES points by policy.
SHARD_SERVE = {"batch": 32, "tensor": 32, "unsharded": 8}
SHARD_SERVE_SIZES = (600, 1500)
# The shards' threads share the interpreter lock: a thread woken at a barrier
# waits for the running one to drop it, which it is made to do only after
# the switch interval (5 ms by default).  The sharded forward is also timed
# at this shorter interval, set for the timing alone, to show that wait.
SHARD_SWITCH_S = 1e-4
# pipeline_forward: the JAX test's shape (mb 4, d 16) and a wide one, held
# to the JAX test's tolerance against the stages run one after another (the
# microbatches' matmuls have fewer rows than the whole batch's, so cuBLAS
# may sum them in another order).
PIPE_STAGES, PIPE_MICRO = 4, 8
PIPE_SHAPES = ((4, 16), (64, 1024))
PIPE_TOL = 2e-5

# Comparison phase: the preproc x aggregation corners other than the main
# path's pc2im/delayed, each model at full width under both policies.
COMPARISON_CORNERS = (("baseline1", "standard"), ("baseline2", "standard"),
                      ("pc2im", "standard"), ("baseline1", "delayed"), ("baseline2", "delayed"))
# fig12a's sampling quality: clouds, points a cloud, samples, query radius.
QUALITY_CLOUDS, QUALITY_POINTS, QUALITY_K, QUALITY_RADIUS = 8, 512, 128, 0.3

# Phase 17: comparison corners through serving, training and sharding, each
# model at full width; the policies run in each corner.  pc2im/standard runs
# under SC alone: it is there for standard aggregation's SC scale path.
RUNTIME_CORNERS = {("baseline1", "standard"): ("none", "sc_w16a16"),
                   ("baseline2", "delayed"): ("none", "sc_w16a16"),
                   ("pc2im", "standard"): ("sc_w16a16",)}
# Each corner serves phase 7's SERVE_TRAFFIC; its SC runs go through the
# preprocess cache twice (the second round all hits), then send clouds[0]
# alone with the scheduler's max_wait_s cut to LONE_WAIT_S: an all-hit batch
# with filler rows.
LONE_WAIT_S = 0.005
CORNER_TRAIN_STEPS = 3
# Clouds of step 1's CPU reference: the CPU's plain baseline-1 FPS and ball
# query over 8 x 4096 points, with the backward, are the slow part, so seg
# holds step 1 on 2 clouds (the card runs the same 2).
CORNER_CPU_ROWS = {"cls": BATCH, "seg": 2}
# Phase 17 (b): each point-cloud example's main() at its full config, with
# the counts cut as the arguments say.
EXAMPLE_RUNS = (
    ("quickstart", []),
    ("train_pointcloud", ["--steps", "20", "--log-every", "10"]),
    ("preprocess_pipeline", []),
    ("serve_runtime", ["--requests", "48", "--mix-quant"]),
    ("serve_slo", ["--requests", "120"]),
    ("serve_trace", ["--requests", "48"]),
)

# LM phase (12): stablelm-1.6b at full width in its config dtype (bf16), cut
# to LM_LAYERS of its 24 layers, weights drawn from SEED on the card;
# LM_BATCH prompts of LM_PROMPT tokens, LM_NEW tokens generated each, caches
# of LM_S_MAX, under every quant policy and KV-cache kind.  Phases 12 and 13
# ran it at all 24 layers until phase 14 pushed the whole run to ~1,050 s of
# its 1,200 s limit; the run says so.
LM_CFG = "stablelm-1.6b"
LM_LAYERS = 12
LM_BATCH, LM_PROMPT, LM_NEW, LM_S_MAX = 4, 128, 16, 256
LM_QUANTS = ("none", "sc_w16a16", "sc_w8a8")
LM_KV = ("none", "int8")
# gemma3-12b at full width, cut to one group of its 5:1 local:global pattern
# (6 of 48 layers): prompts longer than its 1024 window, so prefill rolls the
# local caches, then GEMMA_STEPS decode steps.
GEMMA_CFG, GEMMA_LAYERS = "gemma3-12b", 6
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS = 2, 1280, 8
GEMMA_QUANTS = ("none", "sc_w16a16")
# The card against the port's CPU run of the same params: stablelm cut to
# LM_CPU_LAYERS layers (full width, bf16), prefill and LM_CPU_STEPS
# teacher-forced decode steps, per (quant, kv) case.
LM_CPU_LAYERS, LM_CPU_STEPS = 2, 3
LM_CPU_CASES = (("none", "none"), ("sc_w16a16", "int8"))
# bf16 logits up to ~4.5: an ulp is 2^-5 = 0.031 in [4, 8), and cuBLAS and the
# CPU's bf16 GEMMs sum in other orders and round each layer's outputs to
# bf16, so the two runs part by an ulp or two (measured 4.3e-2 in float,
# 4.8e-2 under SC with int8 caches, on an H100; PERF.md sec. 6).
LM_CPU_TOL = {"none": 0.15, "sc_w16a16": 0.15}
# SC products of more than LM_BIG_OPS int8 operations take milliseconds each:
# timed with fewer back-to-back calls (kernel, plain, library).
LM_BIG_OPS = 1e11
LM_BIG_REPS = (20, 3, 10)
GEMMA_BIG_REPS = (5, 2, 3)

# LM training phase (13): stablelm-1.6b at full width and LM_LAYERS layers in bf16 with
# its remat "full", weights drawn on the card from SEED, LM_TRAIN_STEPS steps
# of make_train_step on LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens of token_stream
# (drawn on the CPU as train_lm's prefetch thread draws them) under every
# policy of LM_QUANTS.  The schedule warms up over one step, so step 1
# moves no weight (the reference's schedule starts at 0), then peaks at
# LM_TRAIN_LR.
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 256, 5
LM_TRAIN_LR = 1e-3
# The card against the port's CPU run: stablelm cut to LM_CPU_LAYERS layers
# (full width, bf16), the same params and one batch of LM_TRAIN_CPU_ROWS.
# Loss (~11.5 at init): a float32 mean over 256 tokens of lse - gold on bf16
# logits, which cuBLAS and the CPU's GEMMs round an ulp or two apart (0.031
# at 4) in random directions: ~1e-3 expected, bound 2e-2.  Gradients, of
# each leaf's max |g|: every leaf is bf16 (an ulp is at most 2^-7 = 7.8e-3
# of the max) computed from activations and gradients that both sides round
# to bf16 at every op and that part by an ulp or two (phase 12: logits 1 %
# apart); float 5e-2, six ulps at the max.  SC: 1e-1 of the leaf's max (a
# weight's gradient comes through the quantizer scales, sums over whole
# activations where the sides' one-quantum differences do not cancel: phase
# 9 measured 4.1e-2 in float32), 2e-1 for leaves whose max is below 1e-3;
# and the nonzero pattern as phase 9 holds it, except that an exact zero on
# one side may face up to LM_TRAIN_PATTERN_REL of the leaf's max on the
# other: bf16 sums cancel to an exact 0 now and then (the CPU's bf16
# embedding gradient of this cut holds 81 exact zeros among the 522,240
# entries of its used rows in float, 5 under SC), and where one side
# cancels, the other keeps its operands' rounding differences, which the
# float gradients put at up to 1.6e-2 of a leaf's max (H100); the bound is
# the float one, 5e-2.  An SC linear's weight keeps its whole pattern: its
# one nonzero (through the scale, at its max |w|) is the leaf's max.
LM_TRAIN_CPU_ROWS = (2, 128)
LM_TRAIN_LOSS_TOL = {"none": 2e-2, "sc_w16a16": 2e-2}
LM_TRAIN_GRAD_TOL = {"none": 5e-2, "sc_w16a16": 1e-1, "sc scale path": 2e-1}
LM_TRAIN_PATTERN_REL = LM_TRAIN_GRAD_TOL["none"]
# gemma3-12b at full width cut to one group of its pattern (GEMMA_LAYERS),
# one sequence of 2048 tokens, past its 1024 window: the windowed flash
# backward at full width, GEMMA_TRAIN_STEPS float steps.
GEMMA_TRAIN_ROWS, GEMMA_TRAIN_STEPS = (1, 2048), 2
# train_lm itself, which `python -m repro_torch.launch.train` runs: a
# few steps of stablelm under SC.
LM_ENTRY_STEPS, LM_ENTRY_QUANT = 2, "sc_w16a16"

# LM families phase (14): the moe, ssm and hybrid families in their config dtype
# (bf16), weights drawn on the card from SEED.  Serving through make_serve_fns
# under FAMILY_QUANTS, each (config, layers kept or None for all, prompts,
# prompt tokens, tokens generated); recurrentgemma's prompts pass its 2048
# window, so prefill rolls its local caches.  dbrx-132b's 40 layers of 16
# experts of 6144 x 10752 (~250 GB in bf16) do not fit in 80 GB: it keeps 2.
FAMILY_SERVE = (
    ("granite-moe-3b-a800m", None, 4, 128, 16),
    ("mamba2-1.3b", None, 4, 128, 16),
    ("recurrentgemma-2b", None, 2, 2176, 8),
    ("dbrx-132b", 2, 1, 512, 8),
)
FAMILY_QUANTS = ("none", "sc_w16a16", "sc_w8a8")
FAMILY_TIMED = 3  # host-clock timings: the median of this many calls
# The SC products this phase times beside float64 torch.matmul, by (K, N):
# the routers, mamba2's in_proj and out_proj, the RG-LRU's square linears;
# at every row count the W16A16 runs give them.
FAMILY_TIMED_KN = {(1536, 40), (6144, 16), (2048, 8512), (4096, 2048), (2560, 2560)}
# Training through make_train_step, remat "full": FAMILY_TRAIN_STEPS steps of
# FAMILY_TRAIN_ROWS tokens a step from token_stream, under quant none and
# sc_w16a16 (warmup over one step, then LM_TRAIN_LR).
FAMILY_TRAIN = ("granite-moe-3b-a800m", "mamba2-1.3b", "recurrentgemma-2b")
FAMILY_TRAIN_ROWS, FAMILY_TRAIN_STEPS = (8, 256), 4
# The card against the port's CPU run, at smoke width (the smoke configs:
# granite and mamba2 at 2 layers, recurrentgemma at 5, one group and two
# remainder layers; float32): prefill of FAMILY_CPU_ROWS and LM_CPU_STEPS
# teacher-forced decode steps within LM_CPU_TOL, step 1's loss and gradients
# within phase 13's bounds, and under SC the MoE's top-k picks equal.
FAMILY_CPU_ROWS = (2, 24)

# LM encdec and vlm phase (15): whisper-small and internvl2-2b at full width and
# depth in their config dtype (bf16), weights drawn on the card from SEED, the
# stubbed frontends' outputs drawn there too.  Serving through make_serve_fns
# under FAMILY_QUANTS, each (config, prompts, prompt tokens, tokens generated,
# s_max); whisper's prompts attend to ENCDEC_FRAMES stub encoder frames
# (whisper's own 1500 have no power-of-two divisor above 4, so the flash
# attention's blocks would be 4 wide: 140,625 block pairs a layer in the
# port's Python loop over pairs, ROADMAP.md queue B), internvl2's to its 256
# patches, which its s_max counts.
ENCDEC_VLM_SERVE = (
    ("whisper-small", 4, 64, 16, 128),
    ("internvl2-2b", 4, 128, 16, 512),
)
ENCDEC_FRAMES = 1536
# The SC products this phase times beside float64 torch.matmul, by (K, N):
# whisper's 768 -> 768 / 3072 and 3072 -> 768, internvl2's 2048 -> 2048 /
# 1024 / 8192 and 8192 -> 2048; at every row count the W16A16 runs give them.
ENCDEC_VLM_TIMED_KN = {(768, 768), (768, 3072), (3072, 768), (2048, 2048), (2048, 1024),
                       (2048, 8192), (8192, 2048)}
# Training through make_train_step, remat "full": ENCDEC_VLM_TRAIN_STEPS steps of
# ENCDEC_VLM_TRAIN_ROWS tokens a step from token_stream, under FAMILY_QUANTS.
# whisper takes the reference's zero stubs (as many encoder frames as
# tokens).  internvl2 takes seeded normal patches (its 256 ahead of the
# tokens), not the reference's zeros: a zero patch row stays zero through
# every layer, and each RMSNorm's backward multiplies its gradient there by
# rsqrt(eps) = 1000, which the attention carries into the layer below; the
# gradient norm grows ~1e5 every two layers and overflows by 8 (smoke width,
# the reference and the port alike: 9.0e4, 2.4e10, 3.7e16, inf at 2, 4, 6,
# 8 layers), so at 24 layers every step is NaN.
ENCDEC_VLM_TRAIN_ROWS, ENCDEC_VLM_TRAIN_STEPS = (8, 256), 4
# The card against the port's CPU run at smoke width (float32): prefill of
# FAMILY_CPU_ROWS with ENCDEC_CPU_FRAMES encoder frames (or the smoke config's
# 8 patches) and LM_CPU_STEPS teacher-forced decode steps within LM_CPU_TOL,
# step 1's loss and gradients within phase 13's bounds.  whisper's attention
# key biases get zero gradient in exact arithmetic (the softmax cancels the
# shift they add to a query's scores): both sides' are rounding noise, held
# within ZERO_GRAD_REL of the tree's largest gradient, not to their own max.
ENCDEC_CPU_FRAMES = 32
ZERO_GRAD_REL = 1e-6

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_INT8_OPS = 1979e12
# Single f32 instructions a second on the FP32 pipes: 132 SMs x 128 lanes x
# 1.98 GHz.  Half of PEAK_F32_OPS, which counts a fused multiply-add as two
# operations; the FPS, lattice and knn3 kernels issue no FMA (the build
# passes --fmad=false), so their count of single instructions is held to
# this rate.  An abs is no instruction: it is a free source modifier of the
# add that takes it.
PEAK_F32_INSTR = 33.5e12
# Single f32 instructions a (query, point) distance: 3 sub and 2 add, plus
# 3 mul under squared L2.
DISTANCE_INSTR = {"l1": 5, "l2": 8}

KERNELS = {
    "fps_tiles": {
        "source": "src/repro_torch/csrc/fps.cu",
        "replaces": "src/repro/kernels/fps/kernel.py:66",
    },
    "lattice_tiles": {
        "source": "src/repro_torch/csrc/lattice.cu",
        "replaces": "src/repro/kernels/lattice/kernel.py:50",
    },
    "sc_matmul": {
        "source": "src/repro_torch/csrc/sc_matmul.cu",
        "replaces": "src/repro/kernels/sc_matmul/kernel.py:89",
    },
    "knn3": {
        "source": "src/repro_torch/csrc/knn3.cu",
        "replaces": "src/repro/kernels/knn3/kernel.py:47",
    },
    "lattice_query": {
        "source": "src/repro_torch/csrc/lattice.cu",
        "replaces": "src/repro/kernels/lattice/kernel.py:97",
    },
}

# The port's CUDA kernels by their symbols in csrc/, each under the launch
# counters it serves: the two lattice wrappers launch one kernel.  A graph
# replay adds the launches its capture recorded; a profiled run holds what
# the counters were credited against the kernels the card ran.
KERNEL_SYMBOLS = {"fps_warp_kernel": "fps", "fps_tiles_kernel": "fps", "lattice_kernel": "lattice",
                  "knn3_kernel": "knn3", "sc_matmul_kernel": "sc_matmul",
                  "sc_matmul_res_kernel": "sc_matmul"}
SYMBOL_OF = {"fps_tiles": "fps", "lattice_tiles": "lattice", "lattice_query": "lattice",
             "knn3": "knn3", "sc_matmul": "sc_matmul"}
SYMBOL_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(KERNEL_SYMBOLS) + r")(?![A-Za-z0-9_])")


def fail(msg: str) -> None:
    """Report a failed phase on stderr and exit with code 1."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    """Print one line of the report."""
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def make_clouds(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """(b, n, 3) float32 clouds: surfaces, blobs and grid-snapped copies (ties)."""
    clouds = []
    for i in range(b):
        kind = i % 4
        if kind == 0:  # sphere surface
            v = rng.normal(size=(n, 3))
            c = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == 1:  # cube surface
            c = rng.uniform(-1, 1, (n, 3))
            face = rng.integers(0, 3, n)
            c[np.arange(n), face] = np.sign(c[np.arange(n), face])
        elif kind == 2:  # gaussian blobs
            centers = rng.uniform(-0.7, 0.7, (4, 3))
            c = centers[rng.integers(0, 4, n)] + 0.15 * rng.normal(size=(n, 3))
        else:  # uniform in the cube, snapped to a coarse grid: many ties
            c = np.round(rng.uniform(-1, 1, (n, 3)) * 8) / 8
        if i % 3 == 2:  # snap some of the others too
            c = np.round(c * 16) / 16
        clouds.append(c)
    return np.stack(clouds).astype(np.float32)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean time of fn() from CUDA events around `reps` back-to-back calls.

    When the host takes longer to enqueue a call than the card to run it,
    this is the host's enqueue time, not the card's.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PAD_KERNEL = "spin_kernel"  # the kernel torch.cuda._sleep launches
PAD_KERNELS = 64  # pads ahead of the profiled call: more than a session was seen to drop


def device_kernels(torch, fn) -> dict[str, list]:
    """{name: [count, ms]} of the device work one fn() call enqueues, from one
    torch.profiler session.

    Durations are the card's own (CUPTI), so the host's time to enqueue the
    work is left out.  A session now and then loses CUDA events, all or
    some: the callers below check the count and profile again.  Once CUDA
    graphs have been replayed or other threads have run CUDA work, a
    session drops its first device records: one or two after the
    comparison phase's graphs, nine or more after the serving phases' threads
    (a one-call session of a kernel, behind 8 pads, recorded none), so fn() runs after
    PAD_KERNELS pad kernels (torch.cuda._sleep's PAD_KERNEL) and before
    one, and the pads are left out.

    The session's raw records are read (the kineto results), not
    `prof.events()`: that builds a Python event tree of every host-side
    record too, tens of microseconds each, so tens of seconds for a train
    step's session of ~38k kernels; names are demangled as `prof.events()`
    demangles them.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    raw: dict[str, list] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            entry = raw.setdefault(evt.name(), [0, 0])
            entry[0] += 1
            entry[1] += evt.end_ns() - evt.start_ns()
    by_name: dict[str, list] = {}
    for name, (n, ns) in raw.items():
        name = torch._C._demangle(name) if len(name) > 1 else name
        if PAD_KERNEL not in name:
            entry = by_name.setdefault(name, [0, 0.0])
            entry[0] += n
            entry[1] += ns / 1e6
    return by_name


def n_events(by_name: dict[str, list]) -> int:
    """Device events a session recorded."""
    return sum(n for n, _ in by_name.values())


def device_ms(torch, fn, reps: int, tries: int = 3) -> float:
    """Device time of one fn() call: the card's busy time over `reps` calls, divided by reps.

    A session counts only if it recorded `reps` times the device events of
    a session around one call, or, where the one-call session lost its few
    events, if a second session of `reps` calls recorded the same nonzero
    multiple of `reps`; otherwise they are profiled again, up to `tries`
    times.  Late in a run the profiler can lose events in every session
    (some of a long session's too); then the time comes from CUDA events
    instead (`queued_ms`), and the run says so.
    """
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        one = n_events(device_kernels(torch, fn))
        by_name = device_kernels(torch, lambda: [fn() for _ in range(reps)])
        n = n_events(by_name)
        if one and n == reps * one:
            return sum(ms for _, ms in by_name.values()) / reps
        if not one and n and n % reps == 0:
            again = device_kernels(torch, lambda: [fn() for _ in range(reps)])
            if n_events(again) == n:
                return sum(ms for _, ms in again.values()) / reps
        say(f"torch.profiler session {attempt} of {tries}: {n} device events "
            f"over {reps} calls, expected {reps} x {one}")
    ms = queued_ms(torch, fn, reps)
    say(f"torch.profiler lost device events in every session: {ms:.4f} ms a call from CUDA "
        f"events around {reps} calls queued behind a spin kernel")
    return ms


SPIN_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz: outlasts the host's enqueue


def queued_ms(torch, fn, reps: int) -> float:
    """The card's time a call from CUDA events around `reps` back-to-back calls
    enqueued behind a spin kernel (torch.cuda._sleep), which holds the stream
    while the host enqueues them: the host's enqueue time stays out, the gaps
    between kernels stay in.  Where the enqueue outlasts the spin, the time
    includes the rest of it, so it is an upper bound."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(name: str, args, kw, plain_out) -> tuple[float, float, float]:
    """(bytes, operations, peak operation rate) the call's work needs."""
    if name == "fps_tiles":
        pts, k = args
        t, p, _ = pts.shape
        nbytes = t * p * 3 * 4 + t * k * 4
        # a point a step: its distance to the newest sample, min, compare
        ops = (DISTANCE_INSTR[kw["metric"]] + 2) * t * p * (k - 1)
        return nbytes, ops, PEAK_F32_INSTR
    if name in ("lattice_tiles", "lattice_query"):
        # the flat query is the per-tile one with T = 1
        coords, cents = (a if a.ndim == 3 else a[None] for a in args)
        idx, mask = (o if o.ndim == 3 else o[None] for o in plain_out)
        t, p, _ = coords.shape
        kk = cents.shape[1]
        ns = kw["nsample"]
        # the walk stops once a row is full: count the points each row scans
        scanned = np.where(
            mask[..., -1].cpu().numpy(), idx[..., -1].cpu().numpy() + 1, p
        ).astype(np.int64)
        nbytes = t * kk * 3 * 4 + t * p * 3 * 4 + t * kk * ns * (4 + 1)
        ops = (DISTANCE_INSTR["l1"] + 1) * int(scanned.sum())  # an L1 distance, compare
        return nbytes, ops, PEAK_F32_INSTR
    if name == "knn3":
        queries, points = args
        b, q, _ = queries.shape
        p = points.shape[1]
        nbytes = b * (q + p) * 3 * 4 + b * q * kw["k"] * 8
        ops = (DISTANCE_INSTR[kw["metric"]] + 1) * b * q * p  # distance, compare
        return nbytes, ops, PEAK_F32_INSTR
    x, w = args
    m, k = x.shape
    n = w.shape[1]
    planes = kw["n_planes"]
    nbytes = (m * k + k * n + m * n) * 4
    ops = 2 * m * k * n * planes * planes  # int8 plane-pair MACs
    return nbytes, ops, PEAK_INT8_OPS


def record_calls(torch, registry, run) -> dict[str, list]:
    """Every kernel call that run() makes, with cloned inputs: each kernel's
    CUDA wrapper is swapped for a recorder that calls it (so run() must be
    eager: a graph replay calls no wrapper)."""
    specs = {name: registry.get(name) for name in KERNELS}
    calls = {name: [] for name in KERNELS}

    def recorder(name, spec):
        def record(*args, **kw):
            calls[name].append(
                ([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw)))
            return spec.cuda(*args, **kw)
        return record

    try:
        for name, spec in specs.items():
            registry.register(name, plain=spec.plain, cuda=recorder(name, spec))
        run()
        torch.cuda.synchronize()
    finally:
        for name, spec in specs.items():
            registry.register(name, plain=spec.plain, cuda=spec.cuda)
    return calls


def hold_call(torch, name: str, spec, args, kw, path: str) -> tuple[float, object]:
    """One recorded call: the kernel against its plain version on the same inputs,
    bitwise, or the run fails.  Returns (max |diff|, the plain output)."""
    got = spec.cuda(*args, **kw)
    want = spec.plain(*args, **kw)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got_t, want_t):
        err = (g.to(torch.float64) - w.to(torch.float64)).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(g, w):
            fail(f"{name} at {[tuple(a.shape) for a in args if torch.is_tensor(a)]}"
                 f" ({path}): kernel differs from its plain version (max |diff| {err})")
    return worst, want


def time_call(torch, name: str, spec, args, kw, want, path: str,
              reps: tuple[int, int, int] = (50, 5, 20)) -> dict:
    """Device and enqueue times of one recorded call: kernel, plain version and,
    for the SC matmul, one float64 torch.matmul of the same operands; and its bound.

    ms / plain_ms / library_ms: the card's busy time a call (profiler);
    *_enqueue_ms: CUDA events around back-to-back calls, which is the host's
    enqueue time wherever that exceeds the card's.  `reps`: back-to-back
    calls of the kernel, the plain version and the library call (fewer for
    the LM phase's largest products, each of which takes milliseconds).
    """
    kernel_reps, plain_reps, library_reps = reps
    kernel_fn = functools.partial(spec.cuda, *args, **kw)
    plain_fn = functools.partial(spec.plain, *args, **kw)
    ms = device_ms(torch, kernel_fn, reps=kernel_reps)
    plain_ms = device_ms(torch, plain_fn, reps=plain_reps)
    nbytes, ops, peak = bound(name, args, kw, want)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    row = {"kernel": name, "path": path,
           "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
           "kw": {k: v for k, v in kw.items()}, "ms": ms, "plain_ms": plain_ms,
           "enqueue_ms": cuda_ms(torch, kernel_fn, reps=kernel_reps),
           "plain_enqueue_ms": cuda_ms(torch, plain_fn, reps=plain_reps, warmup=1),
           "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if name == "sc_matmul":
        xd, wd = args[0].to(torch.float64), args[1].to(torch.float64)
        library_fn = functools.partial(torch.matmul, xd, wd)
        row["library_ms"] = device_ms(torch, library_fn, reps=library_reps)
        row["library_enqueue_ms"] = cuda_ms(torch, library_fn, reps=library_reps)
    return row


def call_signature(torch, name: str, args, kw) -> tuple:
    """What makes two calls of a kernel the same work to time: shapes and options."""
    return (name, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)),
            tuple(a for a in args if not torch.is_tensor(a)), tuple(sorted(kw.items())))


def profile_forward(torch, accel, params, batch, wall_ms: float, registry, label: str) -> dict:
    """Device time of one forward by kernel name, from torch.profiler's CUDA events.

    The forward enqueues the same kernels every time, so a session that lost
    events records fewer of them: the forward is profiled until two sessions
    agree on the largest count seen, up to PROFILE_TRIES sessions, else on
    the largest count two of them agree on (profile_run), else the phase
    fails.  busy_ms sums the kernels' durations (one stream, so they do
    not overlap); idle_share compares it with the unprofiled forward's median
    wall time.
    """
    accel.infer(params, batch)
    torch.cuda.synchronize()
    return profile_run(torch, lambda: accel.infer(params, batch), wall_ms, registry, label)


def by_counter(launches: dict[str, int]) -> dict[str, int]:
    """Launch counts summed by the kernel symbol group they count (SYMBOL_OF)."""
    out = dict.fromkeys(sorted(set(KERNEL_SYMBOLS.values())), 0)
    for name, n in launches.items():
        out[SYMBOL_OF[name]] += n
    return out


def port_kernel_events(by_name: dict[str, list]) -> dict[str, int]:
    """How many of the port's kernels a profiler session saw, by symbol group."""
    out = dict.fromkeys(sorted(set(KERNEL_SYMBOLS.values())), 0)
    for name, (n, _) in by_name.items():
        hit = SYMBOL_RE.search(name)
        if hit:
            out[KERNEL_SYMBOLS[hit.group(1)]] += n
    return out


def profile_run(torch, fn, wall_ms: float | None, registry, label: str,
                tries: int = PROFILE_TRIES) -> dict:
    """profile_forward's sessions and report for any fn() that enqueues the
    same kernels each call on one stream at a time.  Where no two of the
    `tries` sessions agree on the largest count, the largest count that two
    agree on is taken; where no two agree at all, the phase fails.

    Every launch counter is set to 0 before each session, and every session
    that recorded at least the chosen count must have seen on the card as
    many of the port's kernels, by symbol, as its call credited to the
    counters, or the phase fails: a session with more events than the one
    chosen passes only where its extra events are none of the port's
    kernels, and those events are printed by name.
    """
    sessions, credited = [], []
    for _ in range(tries):
        registry.reset_launches()
        by_name = device_kernels(torch, fn)
        credited.append(by_counter(registry.launches()))
        sessions.append(by_name)
        counts = [n_events(b) for b in sessions]
        if max(counts) > 0 and counts.count(max(counts)) >= 2:
            chosen = max(counts)
            break
    else:
        agreed = [c for c in set(counts) if c > 0 and counts.count(c) >= 2]
        if not agreed:
            fail(f"{label}: torch.profiler sessions of one call recorded {counts} device "
                 "events: no two agree on a count")
        chosen = max(agreed)
        say(f"{label}: torch.profiler sessions recorded {counts} device events; "
            f"the largest count two agree on is {chosen}")
    best = counts.index(chosen)
    by_name = sessions[best]
    for i, count in enumerate(counts):
        if count < chosen:
            continue
        seen_i = port_kernel_events(sessions[i])
        if seen_i != credited[i]:
            fail(f"{label}: the card ran {seen_i} of the port's kernels in profiled session "
                 f"{i}, the launch counters were credited {credited[i]}")
        if count > chosen:
            extra = {name: n - by_name.get(name, (0, 0.0))[0]
                     for name, (n, _) in sessions[i].items()
                     if n > by_name.get(name, (0, 0.0))[0]}
            say(f"{label}: session {i} recorded {count - chosen} event(s) beyond session "
                f"{best}, none of the port's kernels: {extra}")
    seen = port_kernel_events(by_name)
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out = {
        "kernels_launched": n_events(by_name), "port_kernels_seen": seen, "sessions": counts,
        "busy_ms": busy_ms, "top": [{"name": name[:80], "count": n, "ms": ms}
                                    for name, (n, ms) in top],
    }
    if wall_ms is not None:
        out.update(wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms)
    return out


def n_linears(cfg) -> int:
    """Dense layers of one forward: the SA MLPs, then cls's global MLP or seg's
    FP MLPs (two layers each, one FP stage per SA stage), and the head."""
    sa = sum(len(stage.mlp) for stage in cfg.sa)
    middle = len(cfg.global_mlp) if cfg.task == "cls" else 2 * len(cfg.sa)
    return sa + middle + len(cfg.head) + 1


def expected_launches(path: str, quant: str, cfg=None) -> dict[str, int]:
    """Kernel launches one run of `path` makes under `quant` (phase 4's check),
    for the preproc corner of `cfg` (phase 11's)."""
    want = dict.fromkeys(KERNELS, 0)
    if path == "flat":
        want["lattice_query"] = len(FLAT_SETS)
        return want
    # the corner: baseline1's global FPS and pc2im's tiles launch the FPS
    # kernel a stage, pc2im the lattice kernel a stage; baseline2's masked FPS,
    # grid partition and ball query are plain ops, as in the reference
    want["fps_tiles"] = 0 if cfg.preproc == "baseline2" else len(cfg.sa)
    want["lattice_tiles"] = len(cfg.sa) if cfg.preproc == "pc2im" else 0
    want["sc_matmul"] = n_linears(cfg) if quant != "none" else 0
    if path == "seg":
        want["knn3"] = len(cfg.sa)
    return want


def ragged_clouds(rng: np.random.Generator, k: int, lo: int, hi: int) -> list:
    """k clouds of lo..hi points each, of make_clouds's kinds in turn."""
    out = []
    for i in range(k):
        n = int(rng.integers(lo, hi + 1))
        out.append(make_clouds(rng, i % 4 + 1, n)[i % 4])
    return out


def median_ms(fn, reps: int = TIMED_FORWARDS, warmup: bool = True) -> float:
    """Median host-clock time of fn() over `reps` calls (fn must wait for its work)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# Spans of one micro-batch's life in the serving runtime, as (from, to) trace
# events: request spans are medians over requests, batch spans over batches.
LAYER_SPANS = {
    "queue (submit -> drained)": ("request.submit", "request.drained"),
    "scheduler (drained -> assembled)": ("request.drained", "request.assembled"),
    "pool (assembled -> execute_start)": ("batch.assembled", "batch.execute_start"),
    "replica (execute: H2D, forward, D2H)": ("batch.execute_start", "batch.execute_end"),
    "completion (execute_end -> completed)": ("batch.execute_end", "batch.completed"),
    "request (submit -> completed)": ("request.submit", "request.completed"),
}


def layer_ms(rt, reduce=np.median, strict: bool = True) -> dict[str, float]:
    """`reduce` (the median) in ms of each LAYER_SPANS span over the runtime's
    traced micro-batches; a span the trace lacks fails the run if `strict`,
    else is left out (a pipelined batch has no execute span)."""
    by_trace, by_batch = {}, {}
    for e in rt.tracer.events():
        if e.trace_id != -1:
            by_trace.setdefault(e.trace_id, {})[e.name] = e.t
        elif e.batch_id != -1:
            by_batch.setdefault(e.batch_id, {})[e.name] = e.t
    out = {}
    for label, (a, b) in LAYER_SPANS.items():
        spans = by_trace if a.startswith("request.") else by_batch
        vals = [(d[b] - d[a]) * 1e3 for d in spans.values() if a in d and b in d]
        if vals:
            out[label] = float(reduce(vals))
        elif strict:
            fail(f"the runtime's trace has no {a} -> {b} span")
    return out


def graph_phase(torch, accels: dict, cfgs: dict, params: dict, batches: dict, flat_sets: list,
                registry, card: str) -> tuple[dict, dict]:
    """Phase 6: every entry point's graph replayed against graphs.eager(), bitwise.

    Returns the launch counts of each counted replay and the numbers to report.
    """
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import params_copy_on
    from repro_torch.core.engine import result_leaves, result_to_host
    from repro_torch.kernels.lattice.ops import lattice_query_fused

    counted, report = {}, {"card": card}

    def same(label, got, want):
        for i, (g, w) in enumerate(zip(result_leaves(got), result_leaves(want))):
            if not torch.equal(g, w):
                fail(f"graphs, {label}: leaf {i} of the replay differs from eager "
                     f"(max |diff| {(g.double() - w.double()).abs().max().item()})")

    def counted_replay(label, run, want):
        registry.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        if got != want:
            fail(f"graphs, {label}: launches {got} a replay, expected {want}")
        profile_run(torch, run, None, registry, f"graphs, {label}")  # the card ran them
        return out

    def sync(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    for (m, q), accel in accels.items():
        cfg = cfgs[m]
        p = params_copy_on(params[m], torch.device("cuda"))  # a fresh owner: captured here
        cap, new = batches[m][0], batches[m][1]
        first = graphs.captures()
        pre_cap = accel.preprocess_stage(cap)
        accel.feature_stage(p, cap, pre_cap)
        accel.infer(p, cap)
        captured = graphs.captures() - first
        with graphs.eager():
            ref_logits, ref_pre = accel.infer_with_preprocess(p, new)
            host_pre = result_to_host(ref_pre)
            ref = {"infer": ref_logits, "infer_with_preprocess": (ref_logits, ref_pre),
                   "preprocess_stage": ref_pre,
                   "feature_stage": accel.feature_stage(p, new, ref_pre),
                   "feature_from_cached": accel.feature_from_cached(p, new, host_pre)}
        whole = expected_launches(m, q, cfg)
        halves = {"preprocess": {n: v if n in ("fps_tiles", "lattice_tiles") else 0
                                 for n, v in whole.items()}}
        halves["feature"] = {n: whole[n] - halves["preprocess"][n] for n in whole}
        calls = {"infer": (lambda: accel.infer(p, new), whole),
                 "infer_with_preprocess": (lambda: accel.infer_with_preprocess(p, new), whole),
                 "preprocess_stage": (lambda: accel.preprocess_stage(new), halves["preprocess"]),
                 "feature_stage": (lambda: accel.feature_stage(p, new, ref_pre),
                                   halves["feature"]),
                 "feature_from_cached": (lambda: accel.feature_from_cached(p, new, host_pre),
                                         halves["feature"])}
        before = graphs.captures()
        for entry, (run, want) in calls.items():
            same(f"{m} quant={q} {entry}",
                 counted_replay(f"{m} quant={q} {entry}", run, want), ref[entry])
        if graphs.captures() != before:
            fail(f"graphs, {m} quant={q}: {graphs.captures() - before} captures during replays")
        with graphs.eager():
            infer_eager_ms = median_ms(sync(lambda: accel.infer(p, new)))
            eager_prof = profile_run(torch, lambda: accel.infer(p, new), infer_eager_ms,
                                     registry, f"graphs, {m} quant={q} eager infer")
        replay_ms = median_ms(sync(lambda: accel.infer(p, new)))
        replay_prof = profile_run(torch, lambda: accel.infer(p, new), replay_ms, registry,
                                  f"graphs, {m} quant={q} replayed infer")
        report[f"{m} quant={q}"] = {
            "captures_at_first_calls": captured,
            "eager": {k: eager_prof[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                                 "kernels_launched", "sessions")},
            "replay": {k: replay_prof[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                                  "kernels_launched", "sessions")},
        }
        say(f"graphs, {m} quant={q}: {len(calls)} entry points replayed on a batch other than "
            f"the captured one, bitwise equal to eager, launches = per-forward counts; "
            f"{captured} captures at the first calls, 0 after.  forward (host clock, median of "
            f"{TIMED_FORWARDS}; {card}): eager {infer_eager_ms:.3f} ms, busy "
            f"{eager_prof['busy_ms']:.3f} ms, idle {eager_prof['idle_share']:.3f}; replay "
            f"{replay_ms:.3f} ms, busy {replay_prof['busy_ms']:.3f} ms, idle "
            f"{replay_prof['idle_share']:.3f}")

    # the flat path: no model, so an artifact cache of its own
    flat_cache = graphs.ArtifactCache(torch.device("cuda"))
    specs = [(radius, ns) for _, _, radius, ns in flat_sets]

    def flat_fn(*sets):
        return tuple(lattice_query_fused(sets[2 * i], sets[2 * i + 1], radius, ns)
                     for i, (radius, ns) in enumerate(specs))

    rng = np.random.default_rng(SEED + 2)
    args_new = []
    for pts, cents, _, _ in flat_sets:
        cloud = make_clouds(rng, 1, pts.shape[0])[0]
        pick = np.sort(rng.choice(pts.shape[0], cents.shape[0], replace=False))
        args_new += [torch.from_numpy(cloud).cuda(), torch.from_numpy(cloud[pick]).cuda()]
    flat_cache.run(None, "flat", flat_fn, [a for s in flat_sets for a in s[:2]])
    with graphs.eager():
        want = flat_fn(*args_new)
    got = counted_replay("flat", lambda: flat_cache.run(None, "flat", flat_fn, args_new),
                         expected_launches("flat", "none"))
    same("flat path", got, want)
    say("graphs, flat: the flat path's replay on other sets equals eager bitwise, "
        f"launches {counted['flat']}")
    return counted, report


def settled_records(rt, start: int, n_requests: int, since: float) -> list:
    """The batch records since `start` once they hold n_requests requests and as many
    latencies have been recorded since monotonic instant `since`.  A request's
    future is set before its batch is recorded, so the records of the last
    batch may land a moment after its responses."""
    deadline = time.monotonic() + SERVE_WAIT_S
    while True:
        records = rt.metrics.batch_records[start:]
        if (sum(r.n_real for r in records) >= n_requests
                and len(rt.metrics.latencies_since(since)) >= n_requests):
            return list(records)
        if time.monotonic() > deadline:
            fail(f"batch records of {n_requests} requests never landed")
        time.sleep(0.001)


def counted_serve(torch, registry, counted: dict, label: str, cfg, params, policy, clouds,
                  rounds: int = 1, lone: bool = False, **cfg_kw) -> tuple:
    """Warm a traced one-replica ServingRuntime on the card (max_batch BATCH, one
    bucket of n_points, the other RuntimeConfig fields from cfg_kw), then serve
    `clouds` `rounds` times, each round queued whole and waited for.  The first
    round is queued before the scheduler starts, so it drains as full batches
    in submit order; later rounds need a max_wait_s long enough for that, and
    with a preprocess cache they start once the first round's fills have
    landed and must be all hits.  With `lone`, clouds[0] then goes alone, the
    scheduler's max_wait_s cut to LONE_WAIT_S: an all-hit batch of one real row
    and BATCH - 1 filler rows (ROADMAP queue C, fault 1).

    Each round is counted under its own tag (the first with the warmup):
    launches equal to expected_launches' a batch recorded (an all-hit batch
    launches no FPS or lattice kernel), no graph captured after the warmup,
    every response bitwise equal to an eager infer of the padded batch it rode
    in (`padded_batch_responses`).  No retry, eviction or failure.  Returns
    the runtime, each round's responses, the last full round's batch members,
    and the numbers: memory_allocated after the warmup and, each round, its
    requests, batches, all-hit batches, median batch duration on the replica,
    and p50 and largest latency (submit to response: the first round waits
    behind a queue filled before the start, so its latencies are mostly a
    request's place in that queue)."""
    from repro_torch.core import graphs
    from repro_torch.serve import (
        RuntimeConfig, ServingRuntime, TraceConfig, padded_batch_responses, served_batches,
    )

    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=BATCH, buckets=(cfg.n_points,),
                                                   trace=TraceConfig(), **cfg_kw),
                        policy=policy, device="cuda")
    per_batch = expected_launches(cfg.task, policy.quant, cfg)
    outs, members, numbers, start = [], [], {"rounds": []}, 0
    try:
        registry.reset_launches()
        rt.warmup()
        torch.cuda.synchronize()
        numbers["memory_after_warmup_mib"] = torch.cuda.memory_allocated() / 2**20
        warm = graphs.captures()
        for r in range(rounds + lone):
            alone = r == rounds
            sent = clouds[:1] if alone else clouds
            tag = (f"{label}, clouds[0] alone" if alone
                   else f"{label}, round {r + 1}" if rounds + lone > 1 else label)
            if r:
                if rt.cache is not None:  # the all-miss round's fills land on their own thread
                    deadline = time.monotonic() + SERVE_WAIT_S
                    while rt.cache.stats().insertions < len(clouds):
                        if time.monotonic() > deadline:
                            fail(f"{tag}: cache fills never landed: {rt.cache.stats()}")
                        time.sleep(0.01)
                registry.reset_launches()
            if alone:
                rt.scheduler.apply_config(dataclasses.replace(rt.scheduler.config,
                                                              max_wait_s=LONE_WAIT_S))
            t0 = time.monotonic()
            futs = [rt.submit(c) for c in sent]
            if not r:
                rt.start()
            outs.append([f.result(timeout=SERVE_WAIT_S) for f in futs])
            if graphs.captures() != warm:
                fail(f"{tag}: {graphs.captures() - warm} graphs captured after the warmup")
            records = settled_records(rt, start, len(sent), t0)
            start += len(records)
            got = {n: registry.launches()[n] for n in KERNELS}
            want = dict.fromkeys(KERNELS, 0)
            for rec in records:
                for n, v in per_batch.items():
                    skip = rec.preprocess_skipped and n in ("fps_tiles", "lattice_tiles")
                    want[n] += 0 if skip else v
            counted[tag] = got
            if got != want:
                fail(f"{tag}: launches {got}, expected {want} for {len(records)} batches "
                     f"({sum(not r.n_real for r in records)} warmup, "
                     f"{sum(r.preprocess_skipped for r in records)} all-hit)")
            real = [rec for rec in records if rec.n_real]
            if r and rt.cache is not None and not all(rec.preprocess_skipped for rec in real):
                fail(f"{tag}: a batch after the cold round was not all hits")
            if alone and [(rec.n_real, rec.batch_size) for rec in real] != [(1, BATCH)]:
                fail(f"{tag}: batches {[(rec.n_real, rec.batch_size) for rec in real]}, "
                     f"expected one of 1 real row in {BATCH}")
            # each round submits the same clouds: index them within the round
            batches = [([i % len(clouds) for i in idx], bucket)
                       for idx, bucket in served_batches(rt.tracer.events())[-len(real):]]
            want_out = padded_batch_responses(cfg, params, clouds, [policy] * len(clouds),
                                              batches, BATCH)
            for i, o in enumerate(outs[-1]):
                if not np.array_equal(o, want_out[i]):
                    fail(f"{tag}: response {i} differs from eager infer of its padded batch")
            if not alone:
                members = [idx for idx, _ in batches]
            lat = rt.metrics.latencies_since(t0) * 1e3
            numbers["rounds"].append({
                "tag": tag, "requests": len(sent), "batches": len(real),
                "all_hit_batches": sum(rec.preprocess_skipped for rec in real),
                "batch_ms_median": float(np.median([rec.duration_s * 1e3 for rec in real])),
                "p50_ms": float(np.median(lat)), "max_ms": float(lat.max())})
            say(f"{tag}: {len(sent)} responses over {len(real)} batches "
                f"({numbers['rounds'][-1]['all_hit_batches']} all-hit) bitwise equal to eager "
                f"infer of their padded batches; 0 captures after the warmup; launches {got}")
    finally:
        rt.stop()
    snap = rt.metrics.snapshot()
    n_sent = rounds * len(clouds) + lone
    if snap.retries or snap.evictions or snap.failed or snap.completed != n_sent:
        fail(f"{label}: retries={snap.retries} evictions={snap.evictions} "
             f"failed={snap.failed} completed={snap.completed} of {n_sent}")
    return rt, outs, members, numbers


def serving_phase(torch, cfgs: dict, params: dict, registry, card: str) -> tuple[dict, dict]:
    """Phase 7: ServingRuntime on the card, counted, and held against eager direct infer.

    Returns the launch counts of each counted run and the numbers to report.
    """
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.serve import (
        Request, RuntimeConfig, SchedulerConfig, ServingRuntime, TraceConfig, assemble_batch,
    )

    rng = np.random.default_rng(SEED + 1)
    traffic = {m: ragged_clouds(rng, *SERVE_TRAFFIC[m]) for m in SERVE_TRAFFIC}
    counted, report = {}, {"card": card}

    def serve(label, m, q, pipeline, clouds, rounds=1, **cfg_kw):
        """counted_serve under ExecutionPolicy(quant=q, pipeline=pipeline), then the
        run's throughput, latency, batch durations and slowest spans reported.
        Returns the runtime, each round's responses and the last round's batch
        members."""
        rt, outs, members, _ = counted_serve(
            torch, registry, counted, label, cfgs[m], params[m],
            ExecutionPolicy(quant=q, pipeline=pipeline), clouds, rounds, **cfg_kw)
        snap = rt.metrics.snapshot()
        # where a slow run lost its time: each span's slowest instance, and
        # the real batches' durations on the replica
        slowest = layer_ms(rt, reduce=np.max, strict=False)
        durations = [r.duration_s * 1e3 for r in rt.metrics.batch_records if r.n_real]
        say(f"{label}: {snap.throughput_rps:.1f} requests/s, p50 "
            f"{snap.latency_p50_s * 1e3:.2f} ms, p99 {snap.latency_p99_s * 1e3:.2f} ms; "
            f"0 retries, 0 evictions ({card}); batch on the replica: median "
            f"{np.median(durations):.3f} ms, max {max(durations):.3f} ms; slowest span (ms): "
            + "; ".join(f"{k} {v:.3f}" for k, v in slowest.items()))
        report[label] = {"requests_per_s": snap.throughput_rps,
                         "p50_ms": snap.latency_p50_s * 1e3, "p99_ms": snap.latency_p99_s * 1e3,
                         "batches": snap.batches, "batch_ms_median": float(np.median(durations)),
                         "batch_ms_max": max(durations), "slowest_span_ms": slowest}
        return rt, outs, members

    cls_clouds = traffic["cls"]
    for q in ("none", "sc_w16a16"):
        _, seq_outs, seq_members = serve(f"serve cls quant={q} sequential", "cls", q,
                                         "sequential", cls_clouds)
        _, pip_outs, pip_members = serve(f"serve cls quant={q} pipelined", "cls", q,
                                         "pipelined", cls_clouds)
        if pip_members != seq_members:
            fail(f"cls quant={q}: pipelined batches {pip_members} differ from sequential "
                 f"{seq_members}")
        if not all(np.array_equal(a, b) for a, b in zip(seq_outs[0], pip_outs[0])):
            fail(f"cls quant={q}: pipelined responses differ from the sequential ones")
        say(f"cls quant={q}: pipelined responses bitwise equal the sequential ones")
    _, seg_outs, _ = serve("serve seg quant=none sequential", "seg", "none", "sequential",
                           traffic["seg"])
    for c, o in zip(traffic["seg"], seg_outs[0]):
        if o.shape != (c.shape[0], cfgs["seg"].n_classes) or not np.isfinite(o).all():
            fail(f"seg response of shape {o.shape} for a cloud of {c.shape[0]} points")
    # the preprocess cache: the same clouds twice, as full batches under SC
    # (one max_wait long enough that only full batches flush)
    cache_clouds = cls_clouds[:SERVE_CACHE_CLOUDS]
    rt, rounds, _ = serve("serve cls quant=sc_w16a16 cached", "cls", "sc_w16a16",
                          "sequential", cache_clouds, rounds=2, cache_max_bytes=1 << 28,
                          max_wait_s=1.0)
    skipped = [r for r in rt.metrics.batch_records if r.n_real and r.preprocess_skipped]
    if len(skipped) != SERVE_CACHE_CLOUDS // BATCH:
        fail(f"cached cls: {len(skipped)} all-hit batches in the second round, expected "
             f"{SERVE_CACHE_CLOUDS // BATCH}")
    if not all(np.array_equal(a, b) for a, b in zip(*rounds)):
        fail("cached cls: all-hit responses differ from the first round's")
    say(f"cached cls: second round all hits ({len(skipped)} batches, no FPS or lattice "
        "launch), responses bitwise equal the first round's")

    # timings, outside the counted runs (host clock: compared only within this
    # run): one micro-batch through the runtime, by layer from its trace and
    # profiled; the same forward bare on this thread, and on a worker thread on
    # a side stream, alone and beside a thread that wakes every drain tick (as
    # the scheduler's loop does); 8 micro-batches pipelined against 8 infers
    accel = get_accelerator(cfgs["cls"], ExecutionPolicy(), device="cuda")
    padded = []
    for lo in range(0, len(cls_clouds), BATCH):
        reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=cfgs["cls"].n_points,
                        policy=accel.policy, deadline_t=None, submit_t=0.0, future=None)
                for i, c in enumerate(cls_clouds[lo:lo + BATCH])]
        padded.append(torch.from_numpy(assemble_batch(reqs, cfgs["cls"].n_points, 3, BATCH))
                      .cuda())

    def forward():
        return accel.infer(params["cls"], padded[0]).cpu()

    side = torch.cuda.Stream()

    def forward_on_side():
        with torch.cuda.stream(side):
            return forward()

    with graphs.eager():
        bare_eager = median_ms(forward)
    threads = {"bare forward, this thread": median_ms(forward),
               "bare eager forward, this thread": bare_eager}
    with ThreadPoolExecutor(max_workers=1) as worker:
        threads["forward on a worker thread, side stream"] = median_ms(
            lambda: worker.submit(forward_on_side).result())
        tick = SchedulerConfig().drain_tick_s
        stop = threading.Event()

        def ticker():
            cond = threading.Condition()
            while not stop.is_set():
                with cond:
                    cond.wait(tick)

        thread = threading.Thread(target=ticker)
        thread.start()
        try:
            threads[f"same, beside a thread waking every {tick * 1e3:g} ms"] = median_ms(
                lambda: worker.submit(forward_on_side).result())
        finally:
            stop.set()
            thread.join()
    rt = ServingRuntime(cfgs["cls"], params["cls"],
                        RuntimeConfig(max_batch=BATCH, trace=TraceConfig()),
                        device="cuda").warmup().start()
    try:
        def one_batch():
            futs = [rt.submit(c) for c in cls_clouds[:BATCH]]
            return [f.result(timeout=SERVE_WAIT_S) for f in futs]

        one_batch()
        rt.tracer.clear()
        threads["one micro-batch through the runtime"] = median_ms(one_batch, warmup=False)
        layers = layer_ms(rt)
        prof = profile_run(torch, one_batch, threads["one micro-batch through the runtime"],
                           registry, "one served cls micro-batch")
    finally:
        rt.stop()
    report["runtime_micro_batch"] = {"wall_ms": threads, "layers_ms": layers, "profile": prof}
    say(f"one cls micro-batch (host clock, median of {TIMED_FORWARDS}; {card}): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in threads.items()))
    say("  by layer, from the runtime's trace (median ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    span = layers["replica (execute: H2D, forward, D2H)"] / threads["bare forward, this thread"]
    say(f"  device busy {prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.3f}; the "
        f"replica's execute span is {span:.2f}x a bare replay")
    accel.infer_pipelined(params["cls"], padded)  # captures the pipelined pair's graphs
    times = {"pipelined": [], "sequential": []}
    for _ in range(5):
        for mode in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "pipelined":
                accel.infer_pipelined(params["cls"], padded)
            else:
                for b in padded:
                    accel.infer(params["cls"], b)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    report["eight_micro_batches_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    eight = report["eight_micro_batches_ms"]
    say(f"{len(padded)} cls micro-batches: pipelined {eight['pipelined']:.3f} ms, sequential "
        f"infer {eight['sequential']:.3f} ms (median of 5, host clock; {card})")
    return counted, report


def control_plane_phase(torch, cfgs: dict, params: dict, registry, card: str) -> tuple[dict, dict]:
    """Phase 8: the serving control plane on the card (chaos, autoscaler, adaptive
    controller, observability), every response held against eager direct infer.

    Returns the launch counts of each counted run and the numbers to report.
    """
    import gc
    import urllib.request
    import weakref

    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.device import CAPTURE_LOCK
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.serve import (
        AdaptiveConfig, AutoscalerConfig, ChaosInjector, Fault, RuntimeConfig, ServingRuntime,
        TERMINAL_EVENTS, TraceConfig, batch_crosscheck, padded_batch_responses,
        request_timelines, served_batches, trace_problems, write_chrome_trace,
    )

    cfg, cls_params = cfgs["cls"], params["cls"]
    width = 3 + cfg.in_features
    rng = np.random.default_rng(SEED + 2)
    counted, report = {}, {"card": card}
    params_bytes = sum(p.numel() * p.element_size() for p in cls_params.parameters())
    report["params_bytes_per_replica"] = params_bytes

    # every capture, timed, through the accelerators this phase serves with
    captures: list[tuple[float, float, str]] = []
    accels = [get_accelerator(cfg, ExecutionPolicy(quant=q), device="cuda")
              for q in ("none", "sc_w16a16")]
    originals = [a.artifacts._capture for a in accels]

    def timed(capture):
        def run(fn, static, what):
            t0 = time.monotonic()
            out = capture(fn, static, what)
            captures.append((t0, time.monotonic(), what))
            return out
        return run

    windows: list[tuple[str, float, float]] = []  # (what, start, end) of each warmup

    def windowed(label, fn):
        def run(*args, **kw):
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                windows.append((label, t0, time.monotonic()))
        return run

    memory = []
    replicas_seen = weakref.WeakSet()  # every Replica object a pool has held

    def collect():
        """A cyclic collection, under the capture lock (none may run beside a capture)."""
        with CAPTURE_LOCK:
            gc.collect()

    def read_memory(label, pool=None, empty=False, settle_to=None):
        """Allocated and reserved bytes on the card, after a collection and a
        sync (under the capture lock).  With a pool, first wait until every
        replica it replaced is released (a thread that still runs on a dead
        replica holds it: a heartbeat pump until its sleep of timeout / 4
        ends, a wedged worker until its wedge ends), and report how long
        that took.  With settle_to, then wait up to CONTROL_SETTLE_S for the
        allocation to come within 1 MiB of it.  With empty, release the
        allocator's cached blocks first."""
        held_s = settled_s = None
        if pool is not None:
            replicas_seen.update(pool.replicas)
            t0 = time.monotonic()
            collect()
            if not all(r in pool.replicas for r in list(replicas_seen)):
                while not all(r in pool.replicas for r in list(replicas_seen)):
                    if time.monotonic() - t0 > SERVE_WAIT_S:
                        fail(f"control plane: a dead replica was never released ({label})")
                    time.sleep(0.05)
                    collect()
                held_s = time.monotonic() - t0
        if settle_to is not None:
            t0 = time.monotonic()
            while (torch.cuda.memory_allocated() > settle_to + 2**20
                   and time.monotonic() - t0 < CONTROL_SETTLE_S):
                time.sleep(0.02)
            settled_s = time.monotonic() - t0
        with CAPTURE_LOCK:
            gc.collect()
            torch.cuda.synchronize()
            if empty:
                torch.cuda.empty_cache()
            row = {"at": label, "allocated": torch.cuda.memory_allocated(),
                   "reserved": torch.cuda.memory_reserved(), "waited_for_release_s": held_s,
                   "waited_to_settle_s": settled_s}
        memory.append(row)
        waits = ([f"{held_s:.2f} s for dead replicas to go"] if held_s else []) + (
            [f"{settled_s:.2f} s for their frees to count"] if settled_s and settled_s > 0.01 else [])
        waited = f", after waiting {' and '.join(waits)}" if waits else ""
        say(f"  memory {label}: allocated {row['allocated'] / 2**20:.2f} MiB, reserved "
            f"{row['reserved'] / 2**20:.2f} MiB{waited} ({card})")
        return row

    def wait_for(pred, what):
        deadline = time.monotonic() + SERVE_WAIT_S
        while not pred():
            if time.monotonic() > deadline:
                fail(f"control plane: {what} never happened")
            time.sleep(0.005)

    def scrape(rt, label, n_completed):
        """GET /metrics and /healthz from the runtime's listener."""
        url = rt.metrics_server.url
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            body = resp.read().decode()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = (resp.status, resp.read().decode())
        m = re.search(r"^pc2im_serve_completed_total (\d+)$", body, re.M)
        if m is None or int(m.group(1)) != n_completed or health != (200, "ok\n"):
            fail(f"{label}: /metrics says completed={m and m.group(1)} against "
                 f"{n_completed} seen, /healthz {health}")
        say(f"{label}: {url}/metrics reports {n_completed} requests completed, as seen; "
            "/healthz ok")

    def observe(rt, label, name):
        """After stop(): the trace is well formed and reconciles with the records."""
        events = rt.tracer.events()
        problems = trace_problems(events)
        if problems:
            fail(f"{label}: trace problems {problems[:5]}")
        if rt.tracer.dropped:
            fail(f"{label}: the trace ring dropped {rt.tracer.dropped} events")
        real = {r.batch_id for r in rt.metrics.batch_records if r.n_real}
        checks = batch_crosscheck(events, rt.metrics.batch_records)
        worst = max((c.rel_err for c in checks), default=float("inf"))
        if {c.batch_id for c in checks} != real or worst >= CROSSCHECK_REL:
            fail(f"{label}: batch_crosscheck covers {len(checks)} of {len(real)} batches, "
                 f"worst rel_err {worst:.3f}")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        path = os.path.join(ROOT, "build", f"{name}_trace.json")
        n_events = write_chrome_trace(path, events)
        say(f"{label}: trace_problems empty over {len(events)} events; batch_crosscheck "
            f"covers all {len(checks)} batches, worst rel_err {worst:.4f}; Chrome trace "
            f"{os.path.relpath(path, ROOT)} ({n_events} events)")
        return {"events": len(events), "chrome_events": n_events, "crosscheck_worst": worst}

    def check_responses(rt, label, clouds, quants, outs):
        batches = served_batches(rt.tracer.events())
        want = padded_batch_responses(cfg, cls_params, clouds,
                                      [ExecutionPolicy(quant=q) for q in quants], batches, BATCH)
        if sorted(want) != list(range(len(clouds))):
            fail(f"{label}: the trace's batches hold {len(want)} of {len(clouds)} requests")
        for i, o in enumerate(outs):
            if not np.array_equal(o, want[i]):
                fail(f"{label}: response {i} differs from eager infer of its padded batch")
        return batches

    def check_launches(rt, label, exact: bool):
        """Launches since the counters' reset against the batches recorded
        (warmups included); a dead replica may still run a batch queued behind
        its fault, whose copy another replica won, so only >= where faults fire."""
        got = {n: registry.launches()[n] for n in KERNELS}
        want = dict.fromkeys(KERNELS, 0)
        for rec in rt.metrics.batch_records:
            for n, v in expected_launches("cls", rec.policy_key[0], cfg).items():
                want[n] += v
        if (got != want) if exact else any(got[n] < want[n] for n in KERNELS):
            fail(f"{label}: launches {got}, expected {'' if exact else 'at least '}{want}")
        counted[label] = got
        return got, want

    def captures_outside_warmups():
        return [(t0, t1, what) for t0, t1, what in captures
                if not any(a <= t0 and t1 <= b for _, a, b in windows)]

    sc = ExecutionPolicy(quant="sc_w16a16")
    phase_t0 = time.perf_counter()
    try:
        for a, orig in zip(accels, originals):
            a.artifacts._capture = timed(orig)

        # -- chaos and recovery ----------------------------------------------
        label = "control: chaos and recovery"
        read_memory("before the runtime")
        rt = ServingRuntime(cfg, cls_params, RuntimeConfig(
            max_batch=BATCH, max_wait_s=0.5, buckets=(cfg.n_points,), n_replicas=2,
            heartbeat_timeout_s=CONTROL_HEARTBEAT_S, trace=TraceConfig(), prometheus_port=0,
            report_interval_s=CONTROL_REPORT_S,
            autoscaler=AutoscalerConfig(poll_interval_s=0.02,
                                        rejoin_delay_s=CONTROL_REJOIN_DELAY_S,
                                        min_replicas=2, max_replicas=2)), device="cuda")
        chaos = ChaosInjector([Fault(replica_id=0, at_batch=2, kind="kill")]).attach(rt.pool)
        rt.pool.rejoin = windowed("rejoin", rt.pool.rejoin)
        clouds, quants, outs = [], [], []

        def wave(k=CONTROL_WAVE):
            new = ragged_clouds(rng, k, *CONTROL_SIZES)
            qs = ["none" if i % 2 == 0 else "sc_w16a16" for i in range(k)]
            futs = [rt.submit(c, policy=sc if q != "none" else None) for c, q in zip(new, qs)]
            clouds.extend(new)
            quants.extend(qs)
            outs.extend(f.result(timeout=SERVE_WAIT_S) for f in futs)

        def rejoins():
            return [e for e in rt.autoscaler.events if e.action == "rejoin"]

        try:
            registry.reset_launches()
            base = len(captures)
            t0 = time.monotonic()
            rt.warmup(policies=(None, sc))
            windows.append(("warmup", t0, time.monotonic()))
            warm_captures = len(captures) - base
            if warm_captures != 4:
                fail(f"{label}: the warmup of 2 replicas x 2 policies captured {warm_captures}")
            level = read_memory("after the warmup (2 replicas)", rt.pool)["allocated"]
            rt.start()
            for _ in range(CONTROL_WAVES):  # the kill: replica 0's third real batch
                wave()
                if chaos.fired("kill"):
                    break
            else:
                fail(f"{label}: the kill never fired in {CONTROL_WAVES} waves")
            wait_for(lambda: len(rejoins()) >= 1, "the rejoin after the kill")
            read_memory("after the rejoin of replica 0 (kill)", rt.pool, settle_to=level)
            # the wedge: replica 1's next real batch, now that replica 0 serves again
            with chaos._lock:
                nxt = chaos._counts.get(1, 0)
            chaos.add(Fault(replica_id=1, at_batch=nxt, kind="wedge", duration_s=CONTROL_WEDGE_S))
            for _ in range(CONTROL_WAVES):
                wave()
                if chaos.fired("wedge"):
                    break
            else:
                fail(f"{label}: the wedge never fired in {CONTROL_WAVES} waves")
            wait_for(lambda: len(rejoins()) >= 2, "the rejoin after the wedge")
            after_wedge = read_memory("after the rejoin of replica 1 (wedge)", rt.pool,
                                      settle_to=level)
            evicted = [e for e in rt.tracer.events() if e.name == "replica.evicted"]
            reasons = [(e.replica_id, e.args["reason"]) for e in evicted]
            if reasons != [(0, "chaos-kill"), (1, "heartbeat")]:
                fail(f"{label}: evictions {reasons}, expected a chaos kill of 0 and a "
                     "heartbeat eviction of 1")
            got, want = check_launches(rt, label, exact=False)
            n_chaos = len(clouds)
            # further kill -> rejoin cycles of replica 0: does memory grow with each?
            cycles = [after_wedge]
            for c in range(CONTROL_CYCLES):
                with chaos._lock:
                    nxt = chaos._counts.get(0, 0)
                chaos.add(Fault(replica_id=0, at_batch=nxt, kind="kill"))
                start = len(clouds)
                while len(chaos.fired("kill")) < c + 2:
                    if len(clouds) - start >= CONTROL_WAVES * CONTROL_WAVE:
                        fail(f"{label}: cycle {c + 1}'s kill never fired")
                    wave()
                wait_for(lambda c=c: len(rejoins()) >= 3 + c, f"cycle {c + 1}'s rejoin")
                wave()  # the rejoined replica serves
                cycles.append(read_memory(f"after kill -> rejoin cycle {c + 1} of replica 0",
                                          rt.pool, settle_to=level))
            scrape(rt, label, len(outs))
            errors = [e for e in rt.autoscaler.events if e.action == "error"]
            if errors:
                fail(f"{label}: the autoscaler recorded errors {errors}")
        finally:
            rt.stop()
        stopped = read_memory("after stop()")
        emptied = read_memory("after stop() and empty_cache()", empty=True)
        snap = rt.metrics.snapshot()
        if snap.failed or snap.completed != len(clouds) or snap.rejoins != 2 + CONTROL_CYCLES:
            fail(f"{label}: failed={snap.failed} completed={snap.completed} of {len(clouds)}, "
                 f"rejoins={snap.rejoins}")
        fired = [(e.kind, e.replica_id, e.batch_index) for e in chaos.fired()]
        check_responses(rt, label, clouds, quants, outs)
        n_rejoins = len(rejoins())
        n_captured = len(captures) - base
        outside = captures_outside_warmups()
        if n_captured != 4 + 2 * n_rejoins or outside:
            fail(f"{label}: {n_captured} captures for the warmup and {n_rejoins} rejoins "
                 f"(expected {4 + 2 * n_rejoins}); outside any warmup: {outside}")
        obs = observe(rt, label, "control_chaos")
        first = memory[1]["allocated"] - memory[0]["allocated"]
        per_replica = first / 2
        growth = [b["allocated"] - a["allocated"] for a, b in zip(cycles, cycles[1:])]
        say(f"{label}: faults {fired}; {len(clouds)} responses ({n_chaos} through the kill and "
            f"the wedge, the rest through {CONTROL_CYCLES} more kill -> rejoin cycles) bitwise "
            f"equal to eager direct infer; {snap.retries} retries, {snap.evictions} evictions, "
            f"{snap.rejoins} warm rejoins; {n_captured} captures, every one inside a warmup "
            f"(the first and {n_rejoins} rejoins), none on a request's path; launches {got} "
            f"(from the records at least {want})")
        say(f"{label}: one replica's memory {per_replica / 2**20:.2f} MiB allocated: params "
            f"copy {params_bytes / 2**20:.2f} MiB, its 2 graphs (8x{cfg.n_points}, float and "
            f"SC) {(per_replica - params_bytes) / 2**20:.2f} MiB; growth per kill -> rejoin "
            f"cycle {[round(g / 2**20, 3) for g in growth]} MiB; reserved "
            f"+{(memory[1]['reserved'] - memory[0]['reserved']) / 2**20:.0f} MiB for the 2 "
            f"replicas' graph pools, then per rejoin "
            f"{[round((b['reserved'] - a['reserved']) / 2**20) for a, b in zip(cycles, cycles[1:])]}"
            f" MiB; after stop() {(stopped['allocated'] - memory[0]['allocated']) / 2**20:.2f} "
            f"MiB allocated and {(stopped['reserved'] - memory[0]['reserved']) / 2**20:.0f} MiB "
            f"reserved above the start, after empty_cache() "
            f"{(emptied['reserved'] - memory[0]['reserved']) / 2**20:.0f} MiB reserved ({card})")
        report["chaos"] = {
            "faults": fired, "requests": len(clouds), "retries": snap.retries,
            "evictions": snap.evictions, "rejoins": snap.rejoins, "captures": n_captured,
            "capture_ms": [(t1 - t0) * 1e3 for t0, t1, _ in captures[base:]],
            "memory": memory, "replica_bytes": per_replica,
            "graphs_bytes_per_replica": per_replica - params_bytes,
            "growth_per_cycle_bytes": growth, "p50_ms": snap.latency_p50_s * 1e3,
            "p99_ms": snap.latency_p99_s * 1e3, "observe": obs}

        # -- adaptive bucket swap under load ---------------------------------------
        label = "control: adaptive swap"
        rt = ServingRuntime(cfg, cls_params, RuntimeConfig(
            max_batch=BATCH, max_queue=2 * ADAPT_FEED, buckets=(cfg.n_points,), n_replicas=2,
            trace=TraceConfig(), prometheus_port=0, report_interval_s=CONTROL_REPORT_S,
            adaptive=AdaptiveConfig(poll_interval_s=3600.0, min_samples=64, min_bucket=128,
                                    tune_max_batch=False, tune_wait=False)), device="cuda")
        rt.reconfigure = windowed("reconfigure", rt.reconfigure)

        def skewed(k):
            small = ragged_clouds(rng, k - k // 4, CONTROL_SIZES[0], 480)
            large = ragged_clouds(rng, k // 4, 481, CONTROL_SIZES[1])
            return [c for pair in zip(small, large) for c in pair] + small[len(large):]

        clouds = skewed(ADAPT_BEFORE) + skewed(ADAPT_FEED)
        outs, futs = [None] * len(clouds), []
        try:
            registry.reset_launches()
            base = len(captures)
            t0 = time.monotonic()
            rt.warmup()
            windows.append(("warmup", t0, time.monotonic()))
            futs = [rt.submit(c) for c in clouds[:ADAPT_BEFORE]]
            rt.start()
            for i, f in enumerate(futs):
                outs[i] = f.result(timeout=SERVE_WAIT_S)
            before_end = time.monotonic()
            stop_feed = threading.Event()
            fed, feed_errors = [], []

            def feeder():
                try:
                    for i in range(ADAPT_BEFORE, len(clouds)):
                        if stop_feed.is_set():
                            return
                        fed.append((i, rt.submit(clouds[i])))
                        time.sleep(ADAPT_FEED_S)
                except Exception as e:  # noqa: BLE001 — reported below, fails the phase
                    feed_errors.append(repr(e))

            feed = threading.Thread(target=feeder, name="control-feeder")
            feed.start()
            try:
                time.sleep(0.05)  # traffic in flight before the swap starts
                swap0 = time.monotonic()
                rt.controller.poll_once()
                swap1 = time.monotonic()
                time.sleep(0.1)  # and after it
            finally:
                stop_feed.set()
                feed.join(timeout=SERVE_WAIT_S)
            if feed_errors or feed.is_alive():
                fail(f"{label}: the feeder thread failed: {feed_errors}")
            for i, f in fed:
                outs[i] = f.result(timeout=SERVE_WAIT_S)
            served = ADAPT_BEFORE + len(fed)
            decisions = rt.controller.decisions.all()
            if [d.kind for d in decisions] != ["buckets"] or not decisions[0].applied:
                fail(f"{label}: decisions {decisions}, expected one applied bucket swap")
            swap = decisions[0]
            if rt.buckets != swap.value or len(swap.value) < 2 or swap.value[0] >= cfg.n_points:
                fail(f"{label}: swapped to {swap.value} (runtime {rt.buckets}), expected "
                     f"a smaller bucket below {cfg.n_points}")
            new_shapes = [b for b in swap.value if b not in swap.previous]
            swap_captures = [c for c in captures[base:] if swap0 <= c[0] <= swap1]
            if len(swap_captures) != 2 * len(new_shapes):
                fail(f"{label}: the swap captured {len(swap_captures)} graphs for "
                     f"{len(new_shapes)} new shapes on 2 replicas")
            # the rollback: its graphs are still cached, so it captures nothing
            before_rb = len(captures)
            rb0 = time.monotonic()
            rt.reconfigure(buckets=tuple(swap.previous))
            rb1 = time.monotonic()
            if len(captures) != before_rb or rt.buckets != tuple(swap.previous):
                fail(f"{label}: the rollback to {swap.previous} captured "
                     f"{len(captures) - before_rb} graphs")
            after = skewed(CONTROL_WAVE)
            for c, f in zip(after, [rt.submit(c) for c in after]):
                clouds.append(c)
                outs.append(f.result(timeout=SERVE_WAIT_S))
            scrape(rt, label, served + len(after))
        finally:
            rt.stop()
        clouds = [c for i, c in enumerate(clouds) if outs[i] is not None]
        outs = [o for o in outs if o is not None]
        snap = rt.metrics.snapshot()
        if snap.failed or snap.completed != len(outs):
            fail(f"{label}: failed={snap.failed} completed={snap.completed} of {len(outs)}")
        errors = [d for d in rt.controller.decisions.all() if d.kind == "error"]
        if errors:
            fail(f"{label}: the controller recorded errors {errors}")
        got, _ = check_launches(rt, label, exact=True)  # before the eager references launch
        batches = check_responses(rt, label, clouds, ["none"] * len(clouds), outs)
        outside = captures_outside_warmups()
        if len(captures) - base != 2 + len(swap_captures) or outside:
            fail(f"{label}: {len(captures) - base} captures; outside any warmup: {outside}")
        obs = observe(rt, label, "control_adapt")
        timelines = request_timelines(rt.tracer.events())
        ends = {tid: next(e.t for e in tl.events if e.name in TERMINAL_EVENTS)
                for tid, tl in timelines.items()}
        e2e = {tid: tl.e2e_s * 1e3 for tid, tl in timelines.items()}
        before_ms = [e2e[t] for t in e2e if ends[t] <= before_end]
        inside_ms = [e2e[t] for t in e2e if swap0 <= ends[t] <= swap1]

        def pct(v):
            return ({"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                     "p99_ms": float(np.percentile(v, 99))} if v else {"n": 0})

        capture_ms = [(t1 - t0) * 1e3 for t0, t1, _ in swap_captures]
        by_bucket = {}
        for idx, bucket in batches:
            by_bucket[bucket] = by_bucket.get(bucket, 0) + len(idx)
        say(f"{label}: {swap.previous} -> {swap.value} ({swap.reason}), applied by poll_once "
            f"in {(swap1 - swap0) * 1e3:.1f} ms with {len(fed)} clouds fed meanwhile; capture "
            f"time per new shape and replica {[round(m, 1) for m in capture_ms]} ms; rollback "
            f"to {swap.previous} in {(rb1 - rb0) * 1e3:.1f} ms, 0 captures; {len(outs)} "
            f"responses bitwise equal to eager direct infer at their buckets {by_bucket}; "
            f"launches {got}; controller errors: none ({card})")
        say(f"{label}: latency before the swap {pct(before_ms)}, completed inside the swap "
            f"window {pct(inside_ms)} (host clock, {card})")
        report["adaptive"] = {
            "previous": list(swap.previous), "buckets": list(swap.value), "reason": swap.reason,
            "evidence": dict(swap.evidence), "poll_once_ms": (swap1 - swap0) * 1e3,
            "capture_ms_per_new_shape": capture_ms, "rollback_ms": (rb1 - rb0) * 1e3,
            "fed_during_swap": len(fed), "requests": len(outs), "by_bucket": by_bucket,
            "before": pct(before_ms), "inside_swap": pct(inside_ms), "observe": obs}
        report["phase_s"] = time.perf_counter() - phase_t0
        say(f"control plane phase: {report['phase_s']:.1f} s")
    finally:
        for a, orig in zip(accels, originals):
            a.artifacts._capture = orig
    return counted, report


@contextlib.contextmanager
def deterministic(torch):
    """torch.use_deterministic_algorithms(True, warn_only=True) inside the block only.

    The training step's backward adds into gathered rows (take_along_dim's
    backward is a scatter-add), whose float sums land in a racing order on
    the card unless PyTorch takes its deterministic kernels.  warn_only:
    an op with no deterministic kernel warns instead of raising, and a
    bitwise check then says whether it mattered.  The block's warnings are
    returned in the list it yields.
    """
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def grads_agree(torch, got: dict, want: dict, quant: str, tol: dict = TRAIN_GRAD_TOL,
                what: str = "training", pattern_rel: float = 0.0,
                zero: frozenset = frozenset()) -> tuple[float, str]:
    """The worst |got - want| / max|want| over the leaves, after the checks of
    `tol` (TRAIN_GRAD_TOL's keys) and, under SC, of the nonzero pattern: no
    entry at or below TRAIN_SC_FLOOR on one side where the other exceeds
    max(TRAIN_SC_FLOOR, pattern_rel x the leaf's max).  The leaves named in
    `zero`, whose exact gradient is zero, are held on both sides within
    ZERO_GRAD_REL of the largest |want| of the tree instead.  Fails the
    phase, naming every leaf out of bounds, if any is."""
    worst, where, bad = 0.0, "", []
    largest = max(w.detach().abs().max().item() for w in want.values())
    for name, w in want.items():
        g = got[name].detach().cpu().double()
        w = w.detach().cpu().double()
        top = w.abs().max().item()
        diff = (g - w).abs().max().item()
        if name in zero:
            noise = max(top, g.abs().max().item())
            if noise > ZERO_GRAD_REL * largest:
                bad.append(f"{name}: a zero gradient's noise {noise:.3e} > "
                           f"{ZERO_GRAD_REL * largest:.3e}")
            continue
        if quant == "none":
            bound = tol["none"] * top
        else:
            floor = max(TRAIN_SC_FLOOR, pattern_rel * top)
            apart = (((g.abs() <= TRAIN_SC_FLOOR) & (w.abs() > floor))
                     | ((w.abs() <= TRAIN_SC_FLOOR) & (g.abs() > floor)))
            if bool(apart.any()):
                bad.append(f"{name}: zero on one side, above {floor:.3e} on the other at "
                           f"{int(apart.sum())} of {w.numel()} (leaf max {top:.3e}, there up to "
                           f"{max(g[apart].abs().max().item(), w[apart].abs().max().item()):.3e})")
            if top <= TRAIN_SC_FLOOR:
                continue
            bound = tol["sc_w16a16" if top >= 1e-3 else "sc scale path"] * top
        if diff > bound:
            bad.append(f"{name}: max |diff| {diff:.3e} > {bound:.3e} (leaf max {top:.3e})")
        if top > 0 and diff / top > worst:
            worst, where = diff / top, name
    if bad:
        fail(f"{what} (quant={quant}), card vs CPU gradients out of bounds at {len(bad)} "
             f"leaves: {bad[:8]}")
    return worst, where


def sync_ms(torch, fn):
    """fn()'s result and its wall time in ms, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fresh_state(torch, accel) -> tuple:
    """Params drawn from SEED on the accelerator's device, and their AdamW state."""
    from repro_torch.optim import adamw_init

    p = accel.init(torch.Generator().manual_seed(SEED))
    return p, adamw_init(p)


def step1_against_cpu(torch, accel, pts, labels, label: str) -> dict:
    """Training step 1 on the card against the port's CPU run: the loss and every
    gradient of `value_and_grad` at params drawn from SEED on each side, on the
    same batch, the card's under deterministic kernels (the same gradient every
    run).  Fails the phase unless the loss is within TRAIN_LOSS_ATOL and every
    leaf within grads_agree's bounds.  Returns both losses, the worst relative
    leaf difference and its leaf, and the CPU run's seconds."""
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.launch.train import value_and_grad

    q = accel.policy.quant
    p, _ = fresh_state(torch, accel)
    with deterministic(torch):
        (loss_gpu, _), g_gpu = value_and_grad(accel, p, pts, labels)
    accel_cpu = get_accelerator(accel.config, accel.policy, device="cpu")
    p_cpu, _ = fresh_state(torch, accel_cpu)
    t_cpu = time.perf_counter()
    (loss_cpu, _), g_cpu = value_and_grad(accel_cpu, p_cpu, pts.cpu(), labels.cpu())
    t_cpu = time.perf_counter() - t_cpu
    loss_diff = abs(loss_gpu.item() - loss_cpu.item())
    if loss_diff > TRAIN_LOSS_ATOL[q]:
        fail(f"{label}: step-1 loss {loss_gpu.item()} on the card, {loss_cpu.item()} on "
             f"the CPU (|diff| {loss_diff} > {TRAIN_LOSS_ATOL[q]})")
    worst, where = grads_agree(torch, g_gpu, g_cpu, q, what=label)
    return {"step1_loss_card": loss_gpu.item(), "step1_loss_cpu": loss_cpu.item(),
            "step1_clouds": int(pts.shape[0]), "step1_cpu_s": t_cpu,
            "grad_worst_rel": worst, "grad_worst_leaf": where}


def replay_against_eager(torch, registry, accel, batches, tag: str, counted: dict) -> dict:
    """One TrainStep step a batch from fresh SEED state, eager (`graphs.eager()`)
    and graphed (the first step eager, then one capture, then replays), under
    deterministic kernels.  The replays' launches are counted under `tag` and
    must be expected_launches' a step; there must be one capture, and every
    step's loss and the final state must be bitwise equal.  Returns the graphed
    run's TrainStep, params and state, each run's step ms and losses, the
    launches, and the ops that warned for want of a deterministic kernel."""
    from repro_torch.core import graphs
    from repro_torch.launch.train import TrainStep

    cfg, q, n = accel.config, accel.policy.quant, len(batches)
    with deterministic(torch) as caught:
        pe, se = fresh_state(torch, accel)
        eager_step = TrainStep(accel, pe, se, lr=TRAIN_LR)
        with graphs.eager():
            eager = [sync_ms(torch, lambda b=b: eager_step(*b)["loss"]) for b in batches]
        pg, sg = fresh_state(torch, accel)
        graph_step = TrainStep(accel, pg, sg, lr=TRAIN_LR)
        first = graphs.captures()
        # the first step runs eagerly, then the capture
        replayed = [sync_ms(torch, lambda: graph_step(*batches[0])["loss"])]
        registry.reset_launches()
        replayed += [sync_ms(torch, lambda b=b: graph_step(*b)["loss"]) for b in batches[1:]]
        got = {k: registry.launches()[k] for k in KERNELS}
    captured = graphs.captures() - first
    want = {k: (n - 1) * v for k, v in expected_launches(cfg.task, q, cfg).items()}
    counted[tag] = got
    if got != want:
        fail(f"{tag}: {n - 1} replayed steps launched {got}, expected {want}")
    if captured != 1:
        fail(f"{tag}: {captured} captures over {n} steps, expected 1")
    for i, ((a, _), (b, _)) in enumerate(zip(replayed, eager)):
        if not torch.equal(a, b):
            fail(f"{tag}: step {i} loss replayed {a.item()}, eager {b.item()}")
    for i, (a, b) in enumerate(zip(graph_step._tensors(), eager_step._tensors())):
        if not torch.equal(a, b):
            fail(f"{tag}: after {n} steps, state tensor {i} of the replayed run differs from "
                 f"the eager run (max |diff| {(a.double() - b.double()).abs().max().item()})")
    if int(sg.step) != n:
        fail(f"{tag}: the step count reads {int(sg.step)} after {n} steps")
    return {"step": graph_step, "params": pg, "state": sg, "captures": captured,
            "launches": got, "eager_ms": [ms for _, ms in eager],
            "replay_ms": [ms for _, ms in replayed],
            "losses": [loss.item() for loss, _ in replayed],
            "no_deterministic_kernel": sorted({str(w.message).split(".")[0][:120]
                                               for w in caught
                                               if "determinis" in str(w.message)})}


def training_phase(torch, cfgs: dict, registry, card: str) -> tuple[dict, dict]:
    """Phase 9: pointnet2 training on the card, the step replayed as one CUDA graph.

    Returns the launch counts of each counted run and the numbers to report.
    """
    import argparse
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.pointclouds import fold_in, sample_batch
    from repro_torch.launch.train import TrainStep, train_pointcloud
    from repro_torch.params import tree_leaves

    counted, report = {}, {"card": card}
    t_phase = time.perf_counter()
    cuda = torch.device("cuda")

    for m, cfg in cfgs.items():
        batches = []
        for i in range(TRAIN_STEPS):
            pts, cls, seg = sample_batch(fold_in(SEED, 10_000 + i), BATCH, cfg.n_points,
                                         device=cuda)
            batches.append((pts, cls if cfg.task == "cls" else seg))
        for q in ("none", "sc_w16a16"):
            label = f"training {m} quant={q}"
            accel = get_accelerator(cfg, ExecutionPolicy(quant=q), device=cuda)
            step1 = step1_against_cpu(torch, accel, *batches[0], label)
            run = replay_against_eager(torch, registry, accel, batches, label, counted)
            pg, sg = run["params"], run["state"]

            # a checkpoint written from the card and read back, bitwise
            with tempfile.TemporaryDirectory() as tmp:
                save_checkpoint(tmp, TRAIN_STEPS, {"params": pg, "opt": sg})
                back, step, _ = load_checkpoint(tmp, {"params": pg, "opt": sg}, device=cuda)
            saved, loaded = tree_leaves({"params": pg, "opt": sg}), tree_leaves(back)
            if step != TRAIN_STEPS or len(saved) != len(loaded) or not all(
                    a.dtype == b.dtype and b.is_cuda and torch.equal(a, b)
                    for a, b in zip(saved, loaded)):
                fail(f"{label}: the checkpoint read back differs from what the card wrote")
            # the loss graph replays as eagerly
            accel.loss(pg, *batches[1])
            with graphs.eager():
                want_loss = accel.loss(pg, *batches[1])
            got_loss = accel.loss(pg, *batches[1])
            if not (torch.equal(got_loss[0], want_loss[0])
                    and torch.equal(got_loss[1]["accuracy"], want_loss[1]["accuracy"])):
                fail(f"{label}: the loss graph's replay differs from eager")
            got, no_det = run["launches"], run["no_deterministic_kernel"]
            del run, back

            # timings, default (racing) kernels: 5 eager steps twice (their spread), 5 replays;
            # peak memory_allocated above what the earlier phases left allocated
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eager_runs = []
            for _ in range(2):
                pa, sa = fresh_state(torch, accel)
                step_a = TrainStep(accel, pa, sa, lr=TRAIN_LR)
                with graphs.eager():
                    timed = [sync_ms(torch, lambda b=b: step_a(*b)["loss"]) for b in batches]
                eager_runs.append((step_a, [loss for loss, _ in timed], [ms for _, ms in timed]))
            eager_peak = torch.cuda.max_memory_allocated() - base
            (run_a, losses_a, ms_a), (run_b, losses_b, ms_b) = eager_runs
            spread = max((a.double() - b.double()).abs().max().item()
                         for a, b in zip(run_a._tensors(), run_b._tensors()))
            loss_spread = max(abs(a.item() - b.item()) for a, b in zip(losses_a, losses_b))
            eager_ms = float(np.median(ms_a + ms_b))
            del eager_runs, run_a, run_b, step_a, pa, sa
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pr, sr = fresh_state(torch, accel)
            step_r = TrainStep(accel, pr, sr, lr=TRAIN_LR)
            _, capture_ms = sync_ms(torch, lambda: step_r(*batches[0]))
            replay_ms = float(np.median([sync_ms(torch, lambda b=b: step_r(*b))[1]
                                         for b in batches]))
            replay_peak = torch.cuda.max_memory_allocated() - base
            prof = profile_run(torch, lambda: step_r(*batches[1]), replay_ms, registry,
                               f"{label} replayed step")
            del step_r, pr, sr
            gc.collect()
            torch.cuda.empty_cache()
            report[f"{m} quant={q}"] = {
                **step1, "replay_equals_eager": "bitwise (deterministic kernels)",
                "ops_without_deterministic_kernel": no_det,
                "eager_vs_eager_state_spread": spread, "eager_vs_eager_loss_spread": loss_spread,
                "eager_step_ms": eager_ms, "first_step_and_capture_ms": capture_ms,
                "replay_step_ms": replay_ms, "busy_ms": prof["busy_ms"],
                "idle_share": prof["idle_share"], "kernels_launched": prof["kernels_launched"],
                "peak_allocated_eager_mib": eager_peak / 2**20,
                "peak_allocated_replay_mib": replay_peak / 2**20,
                "launches_per_step": {n: v // (TRAIN_STEPS - 1) for n, v in got.items()},
            }
            say(f"{label}: step-1 loss card {step1['step1_loss_card']:.6f} / CPU "
                f"{step1['step1_loss_cpu']:.6f}, gradients within {step1['grad_worst_rel']:.2e} "
                f"of each leaf's max (worst {step1['grad_worst_leaf']}); {TRAIN_STEPS} steps "
                f"replayed bitwise equal to eager under deterministic kernels "
                f"(one capture), launches a replayed step "
                f"{report[f'{m} quant={q}']['launches_per_step']}; checkpoint read back bitwise; "
                f"with the default kernels two eager runs differ by {spread:.3e} in state, "
                f"{loss_spread:.3e} in loss.  step (host clock, median; {card}): eager "
                f"{eager_ms:.3f} ms, replay {replay_ms:.3f} ms, busy "
                f"{prof['busy_ms']:.3f} ms, idle {prof['idle_share']:.3f}; peak allocated above "
                f"the run's start: eager {eager_peak / 2**20:.1f} MiB (two runs), replay "
                f"{replay_peak / 2**20:.1f} MiB")
            if no_det:
                say(f"{label}: ops without a deterministic kernel (warned): {no_det}")

    # learning: pointnet2-cls in float through train_pointcloud itself
    cfg = cfgs["cls"]
    accel = get_accelerator(cfg, ExecutionPolicy(quant="none"), device=cuda)
    held = [sample_batch(fold_in(SEED, 10_000 + i), BATCH, cfg.n_points, device=cuda)[:2]
            for i in range(LEARN_STEPS)]
    init = accel.init(torch.Generator().manual_seed(SEED))
    before = float(np.mean([accel.loss(init, *b)[0].item() for b in held]))
    args = argparse.Namespace(steps=LEARN_STEPS, batch=BATCH, lr=LEARN_LR, seed=SEED,
                              quant="none", ckpt_dir=None, ckpt_every=50, log_every=10,
                              device="cuda")
    trained, learn_s = sync_ms(torch, lambda: train_pointcloud(cfg, args))
    after = float(np.mean([accel.loss(trained, *b)[0].item() for b in held]))
    if not after < before:
        fail(f"training cls: the mean loss over the {LEARN_STEPS} training batches went "
             f"{before:.4f} -> {after:.4f} in {LEARN_STEPS} steps of train_pointcloud")
    report["learning"] = {"steps": LEARN_STEPS, "lr": LEARN_LR, "loss_before": before,
                          "loss_after": after, "wall_ms": learn_s}
    say(f"training cls quant=none: train_pointcloud's {LEARN_STEPS} steps took the mean loss over "
        f"their batches {before:.4f} -> {after:.4f} ({learn_s / 1e3:.1f} s)")
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"training phase: {report['phase_s']:.1f} s")
    return counted, report


def shard_layout(torch) -> tuple[str, list[tuple]]:
    """The sharding phase's device groups, from the cards present, and how to say it."""
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    if n >= 4:
        return "two groups of two cards", [tuple(cards[0:2]), tuple(cards[2:4])]
    if n >= 2:
        return "one group of two cards", [tuple(cards[0:2])]
    return "two shards on cuda:0 (one card)", [(cards[0], cards[0])]


def busy_by_device(torch, fn) -> dict[str, float]:
    """{device: summed kernel ms} of one fn() call, from one torch.profiler session.

    Two shards on one card add up on that card, and may overlap there.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            key = f"cuda:{evt.device_index}"
            out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3
    return out


def matmul_splits(torch, accel, params, batch, g: int) -> dict[str, list]:
    """Which float linears of one eager single-device forward a split over g
    shards changes: the matmul of each shard's row block ("batch") and of
    each shard's column block of the zero-padded weight ("tensor"), against
    the same rows or columns of the full product, bitwise.  Names the op
    behind a float sharded forward that is not bitwise."""
    from repro_torch.core import graphs
    from repro_torch.models.nn import Linear

    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((args[0], mod.w)))
             for m in params.modules() if isinstance(m, Linear)]
    try:
        with graphs.eager():
            accel.infer(params, batch)
    finally:
        for h in hooks:
            h.remove()
    out = {"batch": [], "tensor": []}
    with torch.inference_mode():
        for layer, (x, w) in enumerate(seen):
            _split_diffs(torch, layer, x, w, g, out)
    torch.cuda.synchronize()
    return out


def _split_diffs(torch, layer: int, x, w, g: int, out: dict) -> None:
    """matmul_splits' check of one layer's input x and weight w."""
    full = torch.matmul(x, w)
    rows, n = x.shape[0] // g, w.shape[1]
    worst = max((torch.matmul(x[i * rows:(i + 1) * rows], w) - full[i * rows:(i + 1) * rows])
                .abs().max().item() for i in range(g))
    cols = -(-n // g)
    wp = torch.nn.functional.pad(w, (0, cols * g - n))
    got = torch.cat([torch.matmul(x, wp[:, i * cols:(i + 1) * cols]) for i in range(g)],
                    dim=-1)[..., :n]
    shape = [int(np.prod(x.shape[:-1])), int(w.shape[0]), int(n)]
    for mode, err in (("batch", worst), ("tensor", (got - full).abs().max().item())):
        if err:
            out[mode].append({"layer": layer, "mkn": shape, "max_abs_diff": err})


def sync_all(torch) -> None:
    """Wait for every card's queued work."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sharded_forward(torch, registry, counted: dict, label: str, cfg, params, policy, group,
                    batch, want, explain=None) -> tuple:
    """`mesh_artifacts(group).infer` of `batch` under `policy` (its sharding mode)
    against the single-device eager logits `want`: warmed once (the shards'
    threads, streams and handles), then one forward counted under `label`,
    whose launches must be len(group) times expected_launches'.  Its logits
    must be finite and of want's shape, bitwise equal under SC and within
    LOGIT_ATOL["none"] in float; where float is not bitwise, `explain()`
    (if given) names the split matmuls that differ.  Returns the artifacts and
    {"bitwise", "max_abs_diff"[, "matmuls_that_differ"]}."""
    from repro_torch.core.accelerator import get_accelerator

    arts = get_accelerator(cfg, policy, device=group[0]).mesh_artifacts(group)
    arts.infer(params, batch)
    registry.reset_launches()
    got = arts.infer(params, batch)
    sync_all(torch)
    counted[label] = {n: registry.launches()[n] for n in KERNELS}
    per = expected_launches(cfg.task, policy.quant, cfg)
    if counted[label] != {n: len(group) * v for n, v in per.items()}:
        fail(f"{label}: launches {counted[label]}, expected {len(group)} x {per}")
    got = got.to(want.device)
    if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
        fail(f"{label}: logits of shape {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    entry = {"bitwise": bool(torch.equal(got, want)), "max_abs_diff": err}
    if not entry["bitwise"]:
        if policy.quant != "none":
            fail(f"{label}: SC logits differ from single-device eager infer (max |diff| {err})")
        if explain is not None:
            entry["matmuls_that_differ"] = explain()
        if err > LOGIT_ATOL["none"]:
            fail(f"{label}: float logits differ from single-device eager infer by {err} > "
                 f"{LOGIT_ATOL['none']}; split matmuls that differ: "
                 f"{entry.get('matmuls_that_differ', 'not looked for')}")
    return arts, entry


def sharding_phase(torch, cfgs: dict, params: dict, batches: dict, registry,
                   card: str) -> tuple[dict, dict]:
    """Phase 10: the sharded artifacts, a sharded ServingRuntime and pipeline_forward.

    Returns the launch counts of each counted run and the numbers to report.
    """
    from repro_torch.core import accelerator as accel_mod
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.parallel import pipeline_forward
    from repro_torch.serve import (
        AutoscalerConfig, ChaosInjector, Fault, RuntimeConfig, ServingRuntime, TraceConfig,
        padded_batch_responses, served_batches, trace_problems,
    )

    t_phase = time.perf_counter()
    layout, groups = shard_layout(torch)
    g = len(groups[0])
    say(f"sharding phase: {layout}, groups {[[str(d) for d in grp] for grp in groups]}")
    counted, report = {}, {"card": card, "layout": layout,
                           "groups": [[str(d) for d in grp] for grp in groups], "group_size": g}
    policies = {q: ExecutionPolicy(quant=q) for q in ("none", "sc_w16a16")}

    # -- the kernels at the sharded shapes, against their plain versions -------
    specs = {name: registry.get(name) for name in KERNELS}
    checked = dict.fromkeys(KERNELS, 0)
    for m, cfg in cfgs.items():
        for mode in ("batch", "tensor"):
            arts = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16", sharding=mode),
                                   device=groups[0][0]).mesh_artifacts(groups[0])
            calls = []

            def recorder(name, spec, calls=calls):
                def record(*args, **kw):
                    calls.append((name, [a.clone() if torch.is_tensor(a) else a for a in args],
                                  dict(kw)))
                    return spec.cuda(*args, **kw)
                return record

            try:
                for name, spec in specs.items():
                    registry.register(name, plain=spec.plain, cuda=recorder(name, spec))
                arts.infer(params[m], batches[m][0])
                sync_all(torch)
            finally:
                for name, spec in specs.items():
                    registry.register(name, plain=spec.plain, cuda=spec.cuda)
            for name, args, kw in calls:
                got, want = specs[name].cuda(*args, **kw), specs[name].plain(*args, **kw)
                sync_all(torch)
                for a, b in zip(got if isinstance(got, tuple) else (got,),
                                want if isinstance(want, tuple) else (want,)):
                    if not torch.equal(a, b):
                        fail(f"{name} at {[tuple(t.shape) for t in args if torch.is_tensor(t)]} "
                             f"({m} {mode}-sharded): kernel differs from its plain version")
                checked[name] += 1
    say(f"kernels at the sharded shapes (sc_w16a16, both modes, cls and seg): calls equal to "
        f"their plain versions bitwise: {checked}")
    report["kernel_calls_checked"] = checked

    # -- parity, launches and times ----------------------------------------------
    parity, timing = {}, {}
    for m, cfg in cfgs.items():
        batch = batches[m][0]
        for q, pol in policies.items():
            single = get_accelerator(cfg, pol, device="cuda")
            with graphs.eager():
                want = single.infer(params[m], batch)
            splits = {}

            def explain(mode):
                if not splits:
                    splits.update(matmul_splits(torch, single, params[m], batch, g))
                return splits[mode]

            for mode in ("batch", "tensor"):
                for gi, group in enumerate(groups):
                    label = f"{m} quant={q} {mode}-sharded, group {gi}"
                    _, entry = sharded_forward(
                        torch, registry, counted, label, cfg, params[m],
                        ExecutionPolicy(quant=q, sharding=mode), group, batch, want,
                        explain=functools.partial(explain, mode))
                    parity[label] = entry
                    err = entry["max_abs_diff"]
                    say(f"{label}: {'bitwise' if entry['bitwise'] else 'max |diff| %.3e' % err}"
                        f" against single-device eager infer; launches {counted[label]}"
                        + (f"; split matmuls that differ: {entry['matmuls_that_differ']}"
                           if "matmuls_that_differ" in entry else ""))
                arts = get_accelerator(cfg, ExecutionPolicy(quant=q, sharding=mode),
                                       device=groups[0][0]).mesh_artifacts(groups[0])
                fn = functools.partial(arts.infer, params[m], batch)
                interval = sys.getswitchinterval()
                sys.setswitchinterval(SHARD_SWITCH_S)
                try:
                    short_switch_ms = median_ms(lambda: (fn(), sync_all(torch)))
                finally:
                    sys.setswitchinterval(interval)
                timing[f"{m} quant={q} {mode}"] = {
                    "sharded_eager_ms": median_ms(lambda: (fn(), sync_all(torch))),
                    "sharded_eager_ms_short_switch": short_switch_ms,
                    "busy_ms_by_device": busy_by_device(torch, fn),
                }
            with graphs.eager():
                eager_ms = median_ms(lambda: (single.infer(params[m], batch), sync_all(torch)))
            single.infer(params[m], batch)
            replay_ms = median_ms(lambda: (single.infer(params[m], batch), sync_all(torch)))
            for mode in ("batch", "tensor"):
                timing[f"{m} quant={q} {mode}"].update(single_eager_ms=eager_ms,
                                                       single_replay_ms=replay_ms)
    for label, t in timing.items():
        say(f"{label}: sharded eager {t['sharded_eager_ms']:.3f} ms over {g} shards "
            f"({t['sharded_eager_ms_short_switch']:.3f} ms at a {SHARD_SWITCH_S * 1e3:g} ms "
            f"switch interval) "
            f"(busy {', '.join(f'{d} {ms:.3f} ms' for d, ms in t['busy_ms_by_device'].items())}); "
            f"one device: eager {t['single_eager_ms']:.3f} ms, replay "
            f"{t['single_replay_ms']:.3f} ms")
    report["parity"], report["timing"] = parity, timing

    # -- a sharded ServingRuntime: batch float, tensor SC and unsharded side by side
    cfg = cfgs["cls"]
    rng = np.random.default_rng(SEED + 4)
    devices = [d for grp in groups for d in grp]
    pol_b = ExecutionPolicy(sharding="batch")
    pol_t = ExecutionPolicy(quant="sc_w16a16", sharding="tensor")
    mix = ([(pol_b, "none")] * SHARD_SERVE["batch"] + [(pol_t, "sc_w16a16")] * SHARD_SERVE["tensor"]
           + [(None, "none")] * SHARD_SERVE["unsharded"])
    order = rng.permutation(len(mix))
    mix = [mix[i] for i in order]
    clouds = ragged_clouds(rng, len(mix), *SHARD_SERVE_SIZES)
    wave2 = ragged_clouds(rng, 2 * BATCH, *SHARD_SERVE_SIZES)
    built = []
    real_init = accel_mod.MeshArtifacts.__init__

    def counting_init(self, accel, devs):
        built.append(tuple(devs))
        real_init(self, accel, devs)

    accel_mod.MeshArtifacts.__init__ = counting_init
    rt = ServingRuntime(cfg, params["cls"], RuntimeConfig(
        max_batch=BATCH, buckets=(cfg.n_points,), devices_per_replica=2, n_replicas=2,
        max_wait_s=0.01, trace=TraceConfig(),
        autoscaler=AutoscalerConfig(poll_interval_s=0.02, rejoin_delay_s=CONTROL_REJOIN_DELAY_S,
                                    min_replicas=2)), devices=devices)
    try:
        registry.reset_launches()
        rt.warmup((None, pol_b, pol_t))
        n_built = len(built)
        t0 = time.perf_counter()
        rt.start()
        futs = [rt.submit(c, policy=p) for c, (p, _) in zip(clouds, mix)]
        outs = [f.result(timeout=SERVE_WAIT_S) for f in futs]
        wall = time.perf_counter() - t0
        snap = rt.metrics.snapshot()
        # a chaos kill of replica 0 at its next real batch, then a warm rejoin
        chaos = ChaosInjector([Fault(replica_id=0, at_batch=0, kind="kill")]).attach(rt.pool)
        group0 = rt.pool.replicas[0].devices
        futs = [rt.submit(c, policy=pol_t) for c in wave2]
        outs2 = [f.result(timeout=SERVE_WAIT_S) for f in futs]
        deadline = time.monotonic() + SERVE_WAIT_S
        while rt.metrics.rejoins < 1:
            if time.monotonic() > deadline:
                fail("sharded serving: replica 0 never rejoined")
            time.sleep(0.01)
        futs = [rt.submit(c, policy=pol_t) for c in wave2]
        outs3 = [f.result(timeout=SERVE_WAIT_S) for f in futs]
        n_req = len(clouds) + 2 * len(wave2)
        while sum(r.n_real for r in rt.metrics.batch_records) < n_req:
            if time.monotonic() > deadline:
                fail("sharded serving: batch records never landed")
            time.sleep(0.001)
        sync_all(torch)
        got = {n: registry.launches()[n] for n in KERNELS}
    finally:
        rt.stop()
        accel_mod.MeshArtifacts.__init__ = real_init
    want = dict.fromkeys(KERNELS, 0)
    for r in rt.metrics.batch_records:
        q, sharding = r.policy_key[0], r.policy_key[3]
        factor = 2 if sharding is not None else 1
        for n, c in expected_launches("cls", q, cfg).items():
            want[n] += c * factor
    counted["sharded serving"] = got
    if got != want:
        fail(f"sharded serving: launches {got}, expected {want} from the batch records")
    fired = [(e.kind, e.replica_id) for e in chaos.fired()]
    final = rt.metrics.snapshot()
    if fired != [("kill", 0)] or final.failed or final.completed != n_req:
        fail(f"sharded serving: faults {fired}, {final.completed} of {n_req} completed, "
             f"{final.failed} failed")
    if rt.pool.replicas[0].devices != group0 or len(built) != n_built:
        fail(f"sharded serving: the rejoin landed on {rt.pool.replicas[0].devices} (was "
             f"{group0}) and built {len(built) - n_built} MeshArtifacts")
    problems = trace_problems(rt.tracer.events())
    if problems:
        fail(f"sharded serving: trace problems {problems[:5]}")
    all_clouds = clouds + wave2 + wave2
    all_outs = outs + outs2 + outs3
    quants = [q for _, q in mix] + ["sc_w16a16"] * (2 * len(wave2))
    sharded = [p is not None for p, _ in mix] + [True] * (2 * len(wave2))
    eager = padded_batch_responses(cfg, params["cls"], all_clouds,
                                   [ExecutionPolicy(quant=q) for q in quants],
                                   served_batches(rt.tracer.events()), BATCH)
    worst = 0.0
    for i, out in enumerate(all_outs):
        if np.array_equal(out, eager[i]):
            continue
        err = float(np.abs(out - eager[i]).max())
        if quants[i] != "none" or not sharded[i] or err > LOGIT_ATOL["none"]:
            fail(f"sharded serving: response {i} ({quants[i]}, sharded={sharded[i]}) differs "
                 f"from eager infer of its padded batch by {err}")
        worst = max(worst, err)
    report["serving"] = {
        "requests": n_req, "requests_per_s": len(clouds) / wall,
        "p50_ms": snap.latency_p50_s * 1e3, "p99_ms": snap.latency_p99_s * 1e3,
        "float_sharded_max_abs_diff": worst, "retries": final.retries,
        "evictions": final.evictions, "rejoins": final.rejoins,
        "mesh_artifacts_built": n_built, "replica_groups": [
            [str(d) for d in r.devices] for r in rt.pool.replicas]}
    say(f"sharded serving ({len(clouds)} ragged cls clouds: {SHARD_SERVE}): "
        f"{len(clouds) / wall:.1f} requests/s, p50 {snap.latency_p50_s * 1e3:.2f} ms, p99 "
        f"{snap.latency_p99_s * 1e3:.2f} ms; then a kill of replica 0 and a warm rejoin onto "
        f"{[str(d) for d in group0]} (MeshArtifacts built by the warmup: {n_built}, after it: "
        f"{len(built) - n_built}), "
        f"{final.completed}/{n_req} answered, 0 failed; SC and unsharded responses bitwise, "
        f"float sharded max |diff| {worst:.3e}; launches {got}")

    # -- pipeline_forward over min(4, cards) cards ----------------------------------
    n_cards = torch.cuda.device_count()
    stage_devs = [torch.device("cuda", s % min(PIPE_STAGES, n_cards)) for s in range(PIPE_STAGES)]
    pipe = {}
    for mb, d in PIPE_SHAPES:
        scale = 0.3 if d == 16 else 1.0 / np.sqrt(d)
        w = torch.from_numpy((rng.standard_normal((PIPE_STAGES, d, d)) * scale)
                             .astype(np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((PIPE_MICRO, mb, d)).astype(np.float32)).cuda()
        def stage_fn(wp, xx, s):
            return torch.tanh(xx @ wp)

        def sequential(x=x, w=w):
            # each stage's weights copied to its card as pipeline_forward does
            ref = x
            for s in range(PIPE_STAGES):
                ref = stage_fn(w[s].to(stage_devs[s]), ref.to(stage_devs[s]), s)
            return ref.to(x.device)

        def piped(x=x, w=w):
            return pipeline_forward(stage_devs, stage_fn, w, x)

        got, ref = piped(), sequential()
        sync_all(torch)
        err = (got - ref).abs().max().item()
        if tuple(got.shape) != tuple(x.shape) or not torch.allclose(got, ref, rtol=PIPE_TOL,
                                                                    atol=PIPE_TOL):
            fail(f"pipeline_forward at mb={mb}, d={d}: differs from the sequential "
                 f"composition by {err} > {PIPE_TOL}")
        pipe[f"mb={mb} d={d}"] = {
            "max_abs_diff": err, "pipeline_ms": median_ms(lambda: (piped(), sync_all(torch))),
            "sequential_ms": median_ms(lambda: (sequential(), sync_all(torch)))}
        say(f"pipeline_forward, {PIPE_STAGES} stages on {[str(s) for s in stage_devs]}, "
            f"{PIPE_MICRO} microbatches of {mb} x {d}: max |diff| {err:.3e} <= {PIPE_TOL} "
            f"against the sequential composition; {pipe[f'mb={mb} d={d}']['pipeline_ms']:.3f} "
            f"ms against {pipe[f'mb={mb} d={d}']['sequential_ms']:.3f} ms")
    report["pipeline_forward"] = {"stages": [str(s) for s in stage_devs], "runs": pipe}
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"sharding phase: {report['phase_s']:.1f} s")
    return counted, report


def sampling_quality(torch, device: str) -> dict:
    """fig12a's sampling quality on `device`, from QUALITY_CLOUDS seeded clouds.

    Per cloud: the covering radius and the min pairwise separation of the L1
    sample against the L2 one (the FPS kernel on the card, its plain version on
    the CPU), and the lattice query's recall of the ball query's neighbours of
    the L2 centroids (fig12a's neighbour recall: every neighbour, radius
    QUALITY_RADIUS).  Means are taken on the host from the per-cloud values.
    """
    from repro_torch.core import fps as F
    from repro_torch.core import query as Q
    from repro_torch.kernels.fps.ops import fps_tiles
    from repro_torch.kernels.lattice.ops import lattice_query_tiles

    b, n, k = QUALITY_CLOUDS, QUALITY_POINTS, QUALITY_K
    pts = torch.from_numpy(make_clouds(np.random.default_rng(SEED + 11), b, n)).to(device)
    i_l1, i_l2 = (fps_tiles(pts, k, metric=m) for m in ("l1", "l2"))
    cov = [F.coverage_radius(pts, i).cpu().numpy() for i in (i_l1, i_l2)]
    sep = [F.min_pairwise_separation(pts, i).cpu().numpy() for i in (i_l1, i_l2)]
    cents = torch.take_along_dim(pts, i_l2.long()[..., None], dim=1)
    ball = Q.ball_query(pts, cents, QUALITY_RADIUS, n)
    lat = lattice_query_tiles(pts, cents, QUALITY_RADIUS, n)
    found, total = (x.cpu().numpy() for x in Q.neighbor_overlap(ball, lat, n))
    return {
        "per_cloud": {"coverage_l1": cov[0].tolist(), "coverage_l2": cov[1].tolist(),
                      "separation_l1": sep[0].tolist(), "separation_l2": sep[1].tolist(),
                      "found": found.tolist(), "total": total.tolist()},
        "coverage_ratio": float(np.mean(cov[0].astype(np.float64) / cov[1])),
        "separation_ratio": float(np.mean(sep[0].astype(np.float64) / sep[1])),
        "lattice_recall": float(np.mean(found / np.maximum(total, 1))),
    }


def comparison_phase(torch, cfgs: dict, params: dict, batches: dict, registry, card: str,
                     timed: set) -> tuple[dict, dict]:
    """Phase 11: the paper's comparison paths, every corner but the main path's.

    `timed` holds the call signatures phase 3 timed; calls at other shapes
    are timed here.  Returns the launch counts of each counted run and the
    numbers to report.
    """
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import get_accelerator, params_copy_on
    from repro_torch.core.engine import result_leaves, result_to_host
    from repro_torch.core.policy import ExecutionPolicy

    t_phase = time.perf_counter()
    counted, report = {}, {"card": card, "corners": {}, "preprocess_stage": {}}
    specs = {name: registry.get(name) for name in KERNELS}
    rows, timed = [], set(timed)
    policies = {"none": ExecutionPolicy(quant="none"),
                "sc_w16a16": ExecutionPolicy(quant="sc_w16a16")}

    def sync(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    def counted_run(label, run, want):
        registry.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        if got != want:
            fail(f"comparison, {label}: launches {got}, expected {want}")
        return out

    def same(label, got, want):
        for i, (g, w) in enumerate(zip(result_leaves(got), result_leaves(want))):
            if not torch.equal(g, w):
                fail(f"comparison, {label}: leaf {i} differs from eager "
                     f"(max |diff| {(g.double() - w.double()).abs().max().item()})")

    def peak_mib(run) -> float:
        """Peak memory_allocated above what was allocated before run()."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    for m, base_cfg in cfgs.items():
        b0, b1 = batches[m][0], batches[m][1]
        params_cpu = params_copy_on(params[m], torch.device("cpu"))
        cpu_pre = {}  # preproc -> the CPU run's preprocessing of b0
        for pre, agg in COMPARISON_CORNERS:
            cfg = dataclasses.replace(base_cfg, preproc=pre, aggregation=agg)
            for q, pol in policies.items():
                label = f"{m} {pre}/{agg} quant={q}"
                accel = get_accelerator(cfg, pol, device="cuda")
                p = params[m]
                whole = expected_launches(m, q, cfg)
                halves = {"preprocess": {n: v if n in ("fps_tiles", "lattice_tiles") else 0
                                         for n, v in whole.items()}}
                halves["feature"] = {n: whole[n] - halves["preprocess"][n] for n in whole}
                # the kernel calls of one eager forward, against their plain versions
                with graphs.eager():
                    calls = record_calls(torch, registry, functools.partial(accel.infer, p, b0))
                made = {n: len(c) for n, c in calls.items()}
                if made != whole:
                    fail(f"comparison, {label}: kernel calls {made}, expected {whole}")
                worst = 0.0
                for name, cl in calls.items():
                    for args, kw in cl:
                        err, want = hold_call(torch, name, specs[name], args, kw, label)
                        worst = max(worst, err)
                        sig = call_signature(torch, name, args, kw)
                        if sig not in timed:
                            timed.add(sig)
                            rows.append(time_call(torch, name, specs[name], args, kw, want,
                                                  label))
                del calls
                # counted: the first call runs eagerly and captures, the next replays
                peak_capture = peak_mib(lambda: counted_run(
                    f"{label} batch 0", lambda: accel.infer(p, b0), whole))
                logits0 = accel.infer(p, b0)
                logits1 = counted_run(f"{label} batch 1", lambda: accel.infer(p, b1), whole)
                pre0 = accel.preprocess_stage(b0)  # captures the preprocess graph
                accel.feature_stage(p, b0, pre0)  # and the feature graph
                with graphs.eager():
                    ref_logits, ref_pre = accel.infer_with_preprocess(p, b1)
                    ref_feat = accel.feature_stage(p, b1, ref_pre)
                same(f"{label} infer", logits1, ref_logits)
                same(f"{label} infer_with_preprocess", accel.infer_with_preprocess(p, b1),
                     (ref_logits, ref_pre))
                same(f"{label} preprocess_stage",
                     counted_run(f"{label} preprocess_stage", lambda: accel.preprocess_stage(b1),
                                 halves["preprocess"]), ref_pre)
                same(f"{label} feature_stage",
                     counted_run(f"{label} feature_stage",
                                 lambda: accel.feature_stage(p, b1, ref_pre), halves["feature"]),
                     ref_feat)
                host_pre = result_to_host(ref_pre)
                same(f"{label} feature_from_cached", accel.feature_from_cached(p, b1, host_pre),
                     ref_feat)
                # against the port's CPU run (plain versions): preprocessing bitwise,
                # logits within phase 5's tolerance
                if pre not in cpu_pre:
                    cpu_pre[pre] = get_accelerator(cfg, pol, device="cpu").preprocess_stage(b0)
                for i, (g, c) in enumerate(zip(result_leaves(pre0), result_leaves(cpu_pre[pre]))):
                    if not torch.equal(g.cpu(), c):
                        fail(f"comparison, {label}: preprocessing leaf {i} differs from the "
                             "CPU run")
                # infer is feature_stage(preprocess_stage): the CPU preprocessing is shared
                want_cpu = get_accelerator(cfg, pol, device="cpu").feature_stage(
                    params_cpu, b0, cpu_pre[pre])
                got = logits0.cpu()
                if got.shape != want_cpu.shape or not torch.isfinite(got).all():
                    fail(f"comparison, {label}: logits of shape {tuple(got.shape)}, "
                         f"finite={bool(torch.isfinite(got).all())}")
                diff = (got - want_cpu).abs().max().item()
                if diff > LOGIT_ATOL[q]:
                    fail(f"comparison, {label}: logits differ from the CPU run by {diff} > "
                         f"{LOGIT_ATOL[q]}")
                # times: eager and replayed forward, busy, idle, peak memory
                with graphs.eager():
                    eager_ms = median_ms(sync(lambda: accel.infer(p, b1)))
                    peak_eager = peak_mib(lambda: accel.infer(p, b1))
                    eager_prof = profile_run(torch, lambda: accel.infer(p, b1), eager_ms,
                                             registry, f"comparison, {label} eager")
                replay_ms = median_ms(sync(lambda: accel.infer(p, b1)))
                peak_replay = peak_mib(lambda: accel.infer(p, b1))
                replay_prof = profile_run(torch, lambda: accel.infer(p, b1), replay_ms, registry,
                                          f"comparison, {label} replay")
                report["corners"][label] = {
                    "launches_per_forward": whole, "max_abs_err_kernel_vs_plain": worst,
                    "logit_diff_vs_cpu": diff,
                    "eager": {k: eager_prof[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                                         "kernels_launched", "sessions")},
                    "replay": {k: replay_prof[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                                          "kernels_launched", "sessions")},
                    "peak_mib": {"eager": peak_eager, "capture": peak_capture,
                                 "replay": peak_replay},
                }
                say(f"comparison, {label}: kernels == plain, replays == eager, launches "
                    f"{whole}, logits within {diff:.3e} of the CPU run.  forward (host clock, "
                    f"median of {TIMED_FORWARDS}; {card}): eager {eager_ms:.3f} ms, busy "
                    f"{eager_prof['busy_ms']:.3f} ms, idle {eager_prof['idle_share']:.3f}; "
                    f"replay {replay_ms:.3f} ms, busy {replay_prof['busy_ms']:.3f} ms, idle "
                    f"{replay_prof['idle_share']:.3f}; peak allocated eager {peak_eager:.1f} "
                    f"MiB, capture {peak_capture:.1f} MiB, replay {peak_replay:.1f} MiB")
        # the preprocessing comparison: each pipeline's preprocess_stage replay alone
        for pre in ("baseline1", "baseline2", "pc2im"):
            accel = get_accelerator(dataclasses.replace(base_cfg, preproc=pre,
                                                        aggregation="standard"),
                                    policies["none"], device="cuda")
            accel.preprocess_stage(b1)
            ms = median_ms(sync(lambda: accel.preprocess_stage(b1)))
            prof = profile_run(torch, lambda: accel.preprocess_stage(b1), ms, registry,
                               f"comparison, {m} {pre} preprocess_stage")
            report["preprocess_stage"][f"{m} {pre}"] = {
                k: prof[k] for k in ("wall_ms", "busy_ms", "idle_share", "kernels_launched",
                                     "sessions", "top")}
            say(f"comparison, {m} {pre}: preprocess_stage replay (host clock, median of "
                f"{TIMED_FORWARDS}; {card}) {ms:.3f} ms, busy {prof['busy_ms']:.3f} ms, idle "
                f"{prof['idle_share']:.3f}, {prof['kernels_launched']} kernels")

    # fig12a's sampling quality through the FPS and lattice kernels, held
    # against the plain versions' CPU run
    quality = sampling_quality(torch, "cuda")
    if quality != sampling_quality(torch, "cpu"):
        fail("comparison: sampling quality on the card differs from the CPU run")
    report["sampling_quality"] = quality
    say(f"comparison, sampling quality over {QUALITY_CLOUDS} clouds of {QUALITY_POINTS} points, "
        f"k = {QUALITY_K} (equal to the CPU run): L1/L2 coverage-radius ratio "
        f"{quality['coverage_ratio']:.6f}, separation ratio {quality['separation_ratio']:.6f}, "
        f"lattice recall of the ball's neighbours {quality['lattice_recall']:.6f}")
    report["kernel_calls"] = rows
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        if mine:
            say(f"comparison, {name}: {len(mine)} new shape(s) timed, kernel "
                f"{sum(r['ms'] for r in mine):.4f} ms, plain "
                f"{sum(r['plain_ms'] for r in mine):.4f} ms, bound "
                f"{sum(r['bound_ms'] for r in mine):.6f} ms")
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"comparison phase: {report['phase_s']:.1f} s")
    return counted, report


def lm_linears(cfg, train: bool = False) -> int:
    """SC matmuls of one LM prefill or decode step: wq, wk, wv, wo and the MLP's
    three (GLU) or two (dense) linears, every layer; the LM head is a float matmul.
    moe: the attention's 4 and the router (the experts are plain batched
    products); ssm: in_proj and out_proj; hybrid: an RG-LRU layer's 5 (in_x,
    in_y, gate_a, gate_x, out) or a local attention's 4, and the GLU's 3.
    train: one training step under remat "full", each linear once in the forward
    and once in the backward's recompute of its remat unit, but for the hybrid's
    remainder layers, which the reference does not remat."""
    kinds = cfg.pattern_for_layers()
    if cfg.family == "ssm":
        per = [2] * cfg.n_layers
    elif cfg.family == "moe":
        per = [4 + 1] * cfg.n_layers
    elif cfg.family == "hybrid":
        per = [(5 if t == "recurrent" else 4) + 3 for t in kinds]
    else:
        per = [4 + (3 if cfg.mlp_kind == "glu" else 2)] * cfg.n_layers
    if not train:
        return sum(per)
    rem = cfg.n_layers % len(cfg.layer_pattern) if cfg.family == "hybrid" else 0
    return 2 * sum(per) - sum(per[len(per) - rem:])


def stablelm_cut(what: str):
    """stablelm-1.6b at full width cut to LM_LAYERS layers, the cut said."""
    from repro_torch.configs import get_config

    full = get_config(LM_CFG)
    say(f"{what}: {full.name} cut to {LM_LAYERS} of its {full.n_layers} layers, so that the "
        "whole run, phase 14 included, stays well inside its time limit")
    return dataclasses.replace(full, n_layers=LM_LAYERS)


def lm_phase(torch, registry, card: str, timed: set) -> tuple[dict, dict]:
    """Phase 12: dense LM serving through make_serve_fns, the SC matmul at LM shapes.

    `timed` holds the call signatures already timed; calls at other shapes
    are timed here.  Returns the launch counts of each counted run and the
    numbers to report.
    """
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serve import make_serve_fns

    t_phase = time.perf_counter()
    counted, report = {}, {"card": card, "stablelm": {}, "gemma3": {}, "cpu": {}}
    spec = registry.get("sc_matmul")
    rows, timed = [], set(timed)
    rng = np.random.default_rng(SEED + 12)

    def sync():
        torch.cuda.synchronize()

    def want_sc(n_sc: int) -> dict[str, int]:
        return {**dict.fromkeys(KERNELS, 0), "sc_matmul": n_sc}

    def counted_run(label: str, run, n_sc: int):
        registry.reset_launches()
        out = run()
        sync()
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        if got != want_sc(n_sc):
            fail(f"lm, {label}: launches {got}, expected {want_sc(n_sc)}")
        return out

    def hold_all(label: str, run, n_sc: int, reps_big: tuple) -> float:
        """Every SC call of run() against the plain version, bitwise; new shapes timed."""
        calls = record_calls(torch, registry, run)
        made = {n: len(c) for n, c in calls.items()}
        if made != want_sc(n_sc):
            fail(f"lm, {label}: kernel calls {made}, expected {want_sc(n_sc)}")
        worst = 0.0
        for args, kw in calls["sc_matmul"]:
            err, want = hold_call(torch, "sc_matmul", spec, args, kw, label)
            worst = max(worst, err)
            sig = call_signature(torch, "sc_matmul", args, kw)
            if sig not in timed:
                timed.add(sig)
                big = bound("sc_matmul", args, kw, want)[1] > LM_BIG_OPS
                rows.append(time_call(torch, "sc_matmul", spec, args, kw, want, label,
                                      reps=reps_big if big else (50, 5, 20)))
        return worst

    def peak_mib(run) -> float:
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        sync()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def timings(label: str, prefill, decode, n_sc: int, profile_prefill: bool) -> dict:
        """Prefill and one decode step: host clock (median of TIMED_FORWARDS), busy and
        idle share (profiled: the port's kernels seen = the launches credited)."""
        def synced(fn):
            return lambda: (fn(), sync())
        out = {"prefill_ms": median_ms(synced(prefill)),
               "decode_ms_per_token": median_ms(synced(decode))}
        runs = [("decode", decode, out["decode_ms_per_token"])]
        if profile_prefill:
            runs.insert(0, ("prefill", prefill, out["prefill_ms"]))
        for what, fn, wall in runs:
            prof = profile_run(torch, fn, wall, registry, f"lm, {label} {what}")
            if prof["port_kernels_seen"]["sc_matmul"] != n_sc:
                fail(f"lm, {label} {what}: the card ran {prof['port_kernels_seen']} of the "
                     f"port's kernels, expected {n_sc} SC matmuls")
            out[what] = {k: prof[k] for k in ("busy_ms", "idle_share", "kernels_launched",
                                              "port_kernels_seen", "sessions", "top")}
        return out

    # -- stablelm-1.6b: full width, LM_LAYERS of its layers, bf16 ----------------------
    base = stablelm_cut("lm")
    n_lin = lm_linears(base)
    t0 = time.perf_counter()
    params = T.init_lm(base, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    sync()
    say(f"lm: {base.name} ({base.n_layers} layers, d_model {base.d_model}, {base.dtype}, "
        f"{sum(p.numel() for p in params.parameters()):,} parameters) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = {"tokens": rng.integers(0, base.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)}
    for q in LM_QUANTS:
        pol = ExecutionPolicy(quant=q)
        n_sc = n_lin if q != "none" else 0
        for kv in LM_KV:
            label = f"{base.name} quant={q} kv={kv}"
            cfg = dataclasses.replace(base, kv_quant=kv)
            fns = make_serve_fns(cfg, pol, device="cuda")
            box = {}
            peak = peak_mib(lambda: box.update(gen=counted_run(
                f"{label} generate", lambda: fns["generate"](params, batch, steps=LM_NEW,
                                                             s_max=LM_S_MAX), n_sc * LM_NEW)))
            gen = box.pop("gen").cpu()
            if gen.shape != (LM_BATCH, LM_NEW) or not bool(
                    ((gen >= 0) & (gen < base.vocab_size)).all()):
                fail(f"lm, {label}: generated {tuple(gen.shape)} tokens, some out of range")
            logits, state = counted_run(f"{label} prefill",
                                        lambda: fns["prefill"](params, batch, LM_S_MAX), n_sc)
            if logits.shape != (LM_BATCH, 1, base.vocab_size) or not bool(
                    torch.isfinite(logits).all()):
                fail(f"lm, {label}: prefill logits {tuple(logits.shape)}, not all finite")
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            if not torch.equal(tok.cpu(), gen[:, :1]):
                fail(f"lm, {label}: prefill's greedy token differs from generate's")
            _, nxt, state1 = counted_run(f"{label} decode",
                                         lambda: fns["decode"](params, state, {"token": tok}),
                                         n_sc)
            if int(state1.cache_len) != LM_PROMPT + 1 or not torch.equal(nxt.cpu(), gen[:, 1:2]):
                fail(f"lm, {label}: decode's state or greedy token differs from generate's")
            worst = None
            if q != "none" and kv == "none":
                with torch.inference_mode():
                    worst = hold_all(label, lambda: fns["decode"](
                        params, fns["prefill"](params, batch, LM_S_MAX)[1], {"token": tok}),
                        2 * n_sc, LM_BIG_REPS)
            t = timings(label, lambda: fns["prefill"](params, batch, LM_S_MAX),
                        lambda: fns["decode"](params, state, {"token": tok}), n_sc,
                        profile_prefill=kv == "none")
            t.update(peak_generate_mib=peak, max_abs_err_kernel_vs_plain=worst,
                     launches={"prefill": n_sc, "decode_step": n_sc, "generate": n_sc * LM_NEW},
                     tokens=gen[0].tolist())
            report["stablelm"][label] = t
            say(f"lm, {label}: generate {LM_BATCH} x {LM_PROMPT} + {LM_NEW} tokens, launches "
                f"{n_sc} SC a step{'' if worst is None else ', every SC call == plain'}; "
                f"(host clock, median of {TIMED_FORWARDS}; {card}) prefill {t['prefill_ms']:.3f} "
                f"ms, decode {t['decode_ms_per_token']:.3f} ms/token, decode busy "
                f"{t['decode']['busy_ms']:.3f} ms, idle {t['decode']['idle_share']:.3f}"
                + (f"; prefill busy {t['prefill']['busy_ms']:.3f} ms, idle "
                   f"{t['prefill']['idle_share']:.3f}" if "prefill" in t else "")
                + f"; peak allocated by generate {peak:.1f} MiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    report["stablelm_s"] = time.perf_counter() - t_phase

    # -- against the port's CPU run: stablelm at LM_CPU_LAYERS layers, same width --------
    cfg2 = dataclasses.replace(base, n_layers=LM_CPU_LAYERS)
    p_gpu = T.init_lm(cfg2, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    for q, kv in LM_CPU_CASES:
        label = f"{cfg2.name}[{LM_CPU_LAYERS} layers] quant={q} kv={kv}"
        cfg = dataclasses.replace(cfg2, kv_quant=kv)
        pol = ExecutionPolicy(quant=q)
        fg = make_serve_fns(cfg, pol, device="cuda")
        fc = make_serve_fns(cfg, pol, device="cpu")
        lg, sg = fg["prefill"](p_gpu, batch, LM_S_MAX)
        lc, sc = fc["prefill"](p_cpu, batch, LM_S_MAX)
        diffs = [(lg.cpu() - lc).abs().max().item()]
        scale = lc.abs().max().item()
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        for _ in range(LM_CPU_STEPS):  # teacher-forced: the card's greedy tokens into both
            lg, nxt, sg = fg["decode"](p_gpu, sg, {"token": tok})
            lc, _, sc = fc["decode"](p_cpu, sc, {"token": tok.cpu()})
            diffs.append((lg.cpu() - lc).abs().max().item())
            tok = nxt
        report["cpu"][label] = {"max_abs_diff": diffs, "max_abs_logit": scale,
                                "tolerance": LM_CPU_TOL[q]}
        if not all(np.isfinite(diffs)) or max(diffs) > LM_CPU_TOL[q]:
            fail(f"lm, {label}: logits differ from the CPU run by {diffs} > {LM_CPU_TOL[q]}")
        say(f"lm, {label}: card vs CPU, prefill and {LM_CPU_STEPS} teacher-forced decode "
            f"steps: max |logit diff| {[f'{d:.3e}' for d in diffs]} <= {LM_CPU_TOL[q]} "
            f"(logits up to {scale:.3f})")
    del p_gpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    report["cpu_check_s"] = time.perf_counter() - t_phase - report["stablelm_s"]

    # -- gemma3-12b: full width, one group of its 5:1 pattern (6 layers) -------------------
    gcfg = dataclasses.replace(get_config(GEMMA_CFG), n_layers=GEMMA_LAYERS)
    n_lin = lm_linears(gcfg)
    t0 = time.perf_counter()
    params = T.init_lm(gcfg, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    sync()
    say(f"lm: {gcfg.name} cut to {gcfg.n_layers} layers ({gcfg.layer_pattern}), d_model "
        f"{gcfg.d_model}, window {gcfg.window}, {gcfg.dtype}, "
        f"{sum(p.numel() for p in params.parameters()):,} parameters, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gbatch = {"tokens": rng.integers(0, gcfg.vocab_size, (GEMMA_BATCH, GEMMA_PROMPT)).astype(
        np.int32)}
    s_max = GEMMA_PROMPT + GEMMA_STEPS
    for q in GEMMA_QUANTS:
        pol = ExecutionPolicy(quant=q)
        n_sc = n_lin if q != "none" else 0
        label = f"{gcfg.name}[{gcfg.n_layers} layers] quant={q}"
        fns = make_serve_fns(gcfg, pol, device="cuda")

        def serve():
            logits, state = fns["prefill"](params, gbatch, s_max)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            for _ in range(GEMMA_STEPS):
                logits, tok, state = fns["decode"](params, state, {"token": tok})
            return logits, state

        box = {}
        peak = peak_mib(lambda: box.update(out=counted_run(f"{label} prefill + "
                                                           f"{GEMMA_STEPS} decode steps", serve,
                                                           n_sc * (1 + GEMMA_STEPS))))
        logits, state = box.pop("out")
        s_eff = [c.k.shape[2] for c in state.caches]
        if (logits.shape != (GEMMA_BATCH, 1, gcfg.vocab_size)
                or not bool(torch.isfinite(logits).all()) or int(state.cache_len) != s_max
                or s_eff != [min(s_max, gcfg.window) if t == "local" else s_max
                             for t in gcfg.layer_pattern]):
            fail(f"lm, {label}: logits {tuple(logits.shape)}, cache_len "
                 f"{int(state.cache_len)}, cache lengths {s_eff}")
        logits0, state0 = fns["prefill"](params, gbatch, s_max)
        tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)[:, None]
        worst = None
        if q != "none":
            with torch.inference_mode():
                worst = hold_all(label, lambda: fns["decode"](
                    params, fns["prefill"](params, gbatch, s_max)[1], {"token": tok}),
                    2 * n_sc, GEMMA_BIG_REPS)
        t = timings(label, lambda: fns["prefill"](params, gbatch, s_max),
                    lambda: fns["decode"](params, state0, {"token": tok}), n_sc,
                    profile_prefill=True)
        t.update(peak_serve_mib=peak, max_abs_err_kernel_vs_plain=worst, local_cache=s_eff,
                 launches={"prefill": n_sc, "decode_step": n_sc})
        report["gemma3"][label] = t
        say(f"lm, {label}: {GEMMA_BATCH} x {GEMMA_PROMPT} prompt (window {gcfg.window}: the "
            f"local caches keep {min(s_max, gcfg.window)} rolled entries) + {GEMMA_STEPS} decode "
            f"steps, launches {n_sc} SC a step{'' if worst is None else ', every SC call == plain'}"
            f"; (host clock, median of {TIMED_FORWARDS}; {card}) prefill {t['prefill_ms']:.3f} "
            f"ms, busy {t['prefill']['busy_ms']:.3f} ms, idle {t['prefill']['idle_share']:.3f}; "
            f"decode {t['decode_ms_per_token']:.3f} ms/token, busy {t['decode']['busy_ms']:.3f} "
            f"ms, idle {t['decode']['idle_share']:.3f}; peak allocated {peak:.1f} MiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    report["kernel_calls"] = rows
    for r in rows:
        say(f"lm, sc_matmul {r['shapes']} n_planes={r['kw']['n_planes']} ({r['path']}): kernel "
            f"{r['ms']:.4f} ms (enqueue {r['enqueue_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"float64 torch.matmul {r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"lm phase: {report['phase_s']:.1f} s (stablelm {report['stablelm_s']:.1f} s, against "
        f"the CPU {report['cpu_check_s']:.1f} s)")
    return counted, report


def lm_train_phase(torch, registry, card: str, timed: set) -> tuple[dict, dict]:
    """Phase 13: dense LM training through make_train_step and train_lm, the SC
    matmul at training rows, in the forward and again in the remat recompute.

    `timed` holds the call signatures already timed; calls at other shapes
    are timed here.  Returns the launch counts of each counted run and the
    numbers to report.
    """
    import argparse
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.tokens import token_stream
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.params import named_jax_params
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    counted, report = {}, {"card": card, "stablelm": {}, "cpu": {}, "gemma3": {}}
    spec = registry.get("sc_matmul")
    rows, timed = [], set(timed)
    cuda = torch.device("cuda")
    report["allocated_at_start_mib"] = torch.cuda.memory_allocated() / 2**20

    def sync():
        torch.cuda.synchronize()

    def want_sc(n_sc: int) -> dict[str, int]:
        return {**dict.fromkeys(KERNELS, 0), "sc_matmul": n_sc}

    def check_launches(label: str, n_sc: int) -> None:
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        if got != want_sc(n_sc):
            fail(f"lm train, {label}: launches {got}, expected {want_sc(n_sc)}")

    def stream_batches(cfg, rows_cols: tuple, n: int) -> list[dict]:
        """The first n batches of token_stream, drawn on the CPU."""
        stream = token_stream(SEED, *rows_cols, cfg.vocab_size, device="cpu")
        return [batch for _, (_, batch) in zip(range(n), stream)]

    def held_run(label: str, run) -> tuple:
        """run() with every SC call held against the plain version as it is made,
        bitwise (a step's inputs are not kept: they would take ~18 GB); the
        first call at each shape not timed before is kept and timed after.
        Returns (run()'s result, the calls made, the kept calls)."""
        made, bad, kept = [0], [], []

        def hold(*args, **kw):
            got = spec.cuda(*args, **kw)
            want = spec.plain(*args, **kw)
            made[0] += 1
            if not torch.equal(got, want):
                bad.append((made[0], [tuple(a.shape) for a in args if torch.is_tensor(a)],
                            (got.double() - want.double()).abs().max().item()))
            sig = call_signature(torch, "sc_matmul", args, kw)
            if sig not in timed:
                timed.add(sig)
                kept.append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw)))
            return got

        registry.register("sc_matmul", plain=spec.plain, cuda=hold)
        try:
            out = run()
            sync()
        finally:
            registry.register("sc_matmul", plain=spec.plain, cuda=spec.cuda)
        if bad:
            fail(f"lm train, {label}: SC calls (index, shapes, max |diff|) {bad[:5]} differ from "
                 "the plain version")
        return out, made[0], kept

    def time_kept(label: str, kept: list) -> None:
        for args, kw in kept:
            big = bound("sc_matmul", args, kw, None)[1] > LM_BIG_OPS
            rows.append(time_call(torch, "sc_matmul", spec, args, kw, None, label,
                                  reps=LM_BIG_REPS if big else (50, 5, 20)))

    def grads(cfg, params, batch, pol) -> tuple:
        named = named_jax_params(params)
        loss, _ = T.lm_loss(params, cfg, batch, policy=pol)
        return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    # -- stablelm-1.6b: full width, LM_LAYERS of its layers, bf16, remat "full" ---------
    base = stablelm_cut("lm train")
    n_fwd = lm_linears(base)
    train = stream_batches(base, (LM_TRAIN_BATCH, LM_TRAIN_SEQ), LM_TRAIN_STEPS)
    for q in LM_QUANTS:
        pol = ExecutionPolicy(quant=q)
        # each linear once in the forward and once more in the backward's recompute
        n_sc = 2 * n_fwd if q != "none" else 0
        label = f"{base.name} quant={q}"
        t0 = time.perf_counter()
        params = T.init_lm(base, generator=torch.Generator("cuda").manual_seed(SEED),
                           device="cuda")
        state = adamw_init(params)
        step_fn = make_train_step(base, peak_lr=LM_TRAIN_LR, warmup_steps=1,
                                  total_steps=LM_TRAIN_STEPS, policy=pol)
        on_card = [{k: v.to(cuda) for k, v in b.items()} for b in train]
        sync()
        init_s = time.perf_counter() - t0
        state_mib = torch.cuda.memory_allocated() / 2**20
        registry.reset_launches()
        t0 = time.perf_counter()
        # step 1, every SC call held against the plain version as it is made
        out, made, kept = held_run(label, lambda: step_fn(params, state, on_card[0]))
        m = out[2]  # the step returns the params and state it was given: hold no other name
        del out
        first_ms = (time.perf_counter() - t0) * 1e3
        check_launches(f"{label} step 1", n_sc)
        if made != n_sc:
            fail(f"lm train, {label}: step 1 made {made} SC calls, expected {n_sc}")
        time_kept(label, kept)
        sync()
        torch.cuda.reset_peak_memory_stats()  # the peak of steps 2-5, no plain version held
        losses, step_ms = [m["loss"]], []
        for i, b in enumerate(on_card[1:], start=2):
            registry.reset_launches()
            sync()
            t0 = time.perf_counter()
            m = step_fn(params, state, b)[2]
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_launches(f"{label} step {i}", n_sc)
            losses.append(m["loss"])
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        losses = [x.item() for x in losses]
        if not all(np.isfinite(losses)) or not np.isfinite(m["grad_norm"].item()):
            fail(f"lm train, {label}: losses {losses}, grad_norm {m['grad_norm'].item()}")
        learned = None
        if q == "none":  # the float loss falls: step 1's batch again, after the steps
            with torch.no_grad():
                learned = T.lm_loss(params, base, on_card[0], policy=pol)[0].item()
            if not learned < losses[0]:
                fail(f"lm train, {label}: the loss on step 1's batch went {losses[0]:.4f} -> "
                     f"{learned:.4f} in {LM_TRAIN_STEPS} steps")
        eager_ms = float(np.median(step_ms))
        prof = profile_run(torch, lambda: step_fn(params, state, on_card[1]), eager_ms, registry,
                           f"lm train, {label} step")
        if prof["port_kernels_seen"]["sc_matmul"] != n_sc:
            fail(f"lm train, {label}: the card ran {prof['port_kernels_seen']} of the port's "
                 f"kernels in a profiled step, expected {n_sc} SC matmuls")
        report["stablelm"][label] = {
            "tokens_a_step": LM_TRAIN_BATCH * LM_TRAIN_SEQ, "init_s": init_s,
            "losses": losses, "loss_after_on_batch_1": learned,
            "first_step_ms": first_ms, "eager_step_ms": eager_ms, "step_ms": step_ms,
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "kernels_launched": prof["kernels_launched"], "top": prof["top"],
            "state_mib": state_mib, "peak_allocated_mib": peak_mib,
            "sc_launches_a_step": n_sc,
        }
        say(f"lm train, {label}: {LM_TRAIN_STEPS} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
            f"tokens, losses {[f'{x:.4f}' for x in losses]}"
            + (f" (step 1's batch after: {learned:.4f})" if learned is not None else "")
            + f"; {n_sc} SC launches a step ({n_fwd} forward + {n_fwd if n_sc else 0} "
            f"recompute){', every SC call of step 1 == plain' if n_sc else ''}; (host clock, "
            f"median of {len(step_ms)}; {card}) step {eager_ms:.3f} ms (first {first_ms:.1f}), "
            f"busy {prof['busy_ms']:.3f} ms, idle {prof['idle_share']:.3f}, "
            f"{prof['kernels_launched']} kernels; allocated {state_mib:.1f} MiB after init, "
            f"peak {peak_mib:.1f} MiB")
        del params, state, step_fn, on_card, m, kept
        free()

    # -- train_lm, the entry point's own loop (prefetch thread, straggler monitor) ------
    args = argparse.Namespace(steps=LM_ENTRY_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                              lr=LM_TRAIN_LR, seed=SEED, quant=LM_ENTRY_QUANT, ckpt_dir=None,
                              ckpt_every=50, log_every=1, device="cuda")
    registry.reset_launches()
    t0 = time.perf_counter()
    driven = train_lm(base, args)
    sync()
    entry_s = time.perf_counter() - t0
    check_launches(f"{base.name} train_lm quant={LM_ENTRY_QUANT}", LM_ENTRY_STEPS * 2 * n_fwd)
    if int(driven["opt"].step) != LM_ENTRY_STEPS:
        fail(f"lm train, train_lm: the step count reads {int(driven['opt'].step)}")
    report["train_lm"] = {"steps": LM_ENTRY_STEPS, "quant": LM_ENTRY_QUANT, "wall_s": entry_s}
    say(f"lm train, train_lm ({base.name}, quant={LM_ENTRY_QUANT}): {LM_ENTRY_STEPS} steps "
        f"in {entry_s:.1f} s with init, {LM_ENTRY_STEPS * 2 * n_fwd} SC launches")
    del driven
    free()
    report["stablelm_s"] = time.perf_counter() - t_phase

    # -- against the port's CPU run: stablelm at LM_CPU_LAYERS layers, same width --------
    cfg2 = dataclasses.replace(base, n_layers=LM_CPU_LAYERS)
    p_gpu = T.init_lm(cfg2, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    batch = stream_batches(cfg2, LM_TRAIN_CPU_ROWS, 1)[0]
    for q in ("none", "sc_w16a16"):
        label = f"{cfg2.name}[{LM_CPU_LAYERS} layers] quant={q}"
        pol = ExecutionPolicy(quant=q)
        loss_gpu, g_gpu = grads(cfg2, p_gpu, {k: v.to(cuda) for k, v in batch.items()}, pol)
        loss_cpu, g_cpu = grads(cfg2, p_cpu, batch, pol)
        diff = abs(loss_gpu.item() - loss_cpu.item())
        if not np.isfinite(diff) or diff > LM_TRAIN_LOSS_TOL[q]:
            fail(f"lm train, {label}: loss {loss_gpu.item()} on the card, {loss_cpu.item()} "
                 f"on the CPU (|diff| {diff} > {LM_TRAIN_LOSS_TOL[q]})")
        worst, where = grads_agree(torch, g_gpu, g_cpu, q, tol=LM_TRAIN_GRAD_TOL,
                                   what=f"lm train, {label}", pattern_rel=LM_TRAIN_PATTERN_REL)
        report["cpu"][label] = {"loss_card": loss_gpu.item(), "loss_cpu": loss_cpu.item(),
                                "loss_abs_diff": diff, "grad_worst_rel": worst,
                                "grad_worst_leaf": where, "rows": list(LM_TRAIN_CPU_ROWS)}
        say(f"lm train, {label}: card vs CPU on {LM_TRAIN_CPU_ROWS[0]} x {LM_TRAIN_CPU_ROWS[1]} "
            f"tokens: loss {loss_gpu.item():.6f} / {loss_cpu.item():.6f} (|diff| {diff:.3e} <= "
            f"{LM_TRAIN_LOSS_TOL[q]}), gradients within {worst:.3e} of each leaf's max (worst "
            f"{where}){', nonzero patterns equal' if q != 'none' else ''}")
        del g_gpu, g_cpu
    del p_gpu, p_cpu
    free()
    report["cpu_check_s"] = time.perf_counter() - t_phase - report["stablelm_s"]

    # -- gemma3-12b: full width, one group of its 5:1 pattern, past its window -----------
    gcfg = dataclasses.replace(get_config(GEMMA_CFG), n_layers=GEMMA_LAYERS)
    params = T.init_lm(gcfg, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    state = adamw_init(params)
    step_fn = make_train_step(gcfg, peak_lr=LM_TRAIN_LR, warmup_steps=1,
                              total_steps=GEMMA_TRAIN_STEPS)
    gb = [{k: v.to(cuda) for k, v in b.items()}
          for b in stream_batches(gcfg, GEMMA_TRAIN_ROWS, GEMMA_TRAIN_STEPS)]
    sync()
    state_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    label = f"{gcfg.name}[{gcfg.n_layers} layers] quant=none"
    for i, b in enumerate(gb, start=1):
        registry.reset_launches()
        t0 = time.perf_counter()
        m = step_fn(params, state, b)[2]
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_launches(f"{label} step {i}", 0)
        losses.append(m["loss"].item())
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if not all(np.isfinite(losses)):
        fail(f"lm train, {label}: losses {losses}")
    report["gemma3"][label] = {"rows": list(GEMMA_TRAIN_ROWS), "window": gcfg.window,
                               "losses": losses, "step_ms": step_ms, "state_mib": state_mib,
                               "peak_allocated_mib": peak_mib}
    say(f"lm train, {label}: {GEMMA_TRAIN_ROWS[0]} x {GEMMA_TRAIN_ROWS[1]} tokens (window "
        f"{gcfg.window}), losses {[f'{x:.4f}' for x in losses]}; (host clock; {card}) steps "
        f"{[f'{x:.1f}' for x in step_ms]} ms; allocated {state_mib:.1f} MiB after init, peak "
        f"{peak_mib:.1f} MiB")
    del params, state, step_fn, gb, m
    free()

    report["kernel_calls"] = rows
    for r in rows:
        say(f"lm train, sc_matmul {r['shapes']} n_planes={r['kw']['n_planes']} ({r['path']}): "
            f"kernel {r['ms']:.4f} ms (enqueue {r['enqueue_ms']:.4f}), plain {r['plain_ms']:.4f} "
            f"ms, float64 torch.matmul {r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"lm train phase: {report['phase_s']:.1f} s (stablelm {report['stablelm_s']:.1f} s, "
        f"against the CPU {report['cpu_check_s']:.1f} s)")
    return counted, report


class MoEPicks:
    """The MoE router's top-k picks on each side, recorded while entered (the
    moe module's `route` swapped for a recorder that calls it): `check` fails
    unless the card's picks equal the CPU's."""

    def __init__(self, torch):
        from repro_torch.models import moe as moe_mod

        self.torch, self.mod, self.real = torch, moe_mod, moe_mod.route
        self.picks = {"cuda": [], "cpu": []}

    def _route(self, cfg, logits):
        probs = self.torch.softmax(logits, dim=-1)
        top = self.torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :cfg.top_k]
        self.picks[logits.device.type].append(top.cpu())
        return self.real(cfg, logits)

    def __enter__(self):
        for side in self.picks.values():
            side.clear()
        self.mod.route = self._route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real

    def check(self, what: str) -> tuple[dict, str]:
        """(report entries, note) of the picks recorded last."""
        got, want = self.picks["cuda"], self.picks["cpu"]
        differing = sum(int((a != b).sum()) for a, b in zip(got, want))
        n_picks = sum(a.numel() for a in want)
        if len(got) != len(want) or differing:
            fail(f"{what}: {differing} of {n_picks} MoE top-k picks differ between the card "
                 "and the CPU")
        return ({"moe_picks": n_picks, "moe_picks_differing": differing},
                f"; MoE top-k picks differing: {differing} of {n_picks}")


class LMRuns:
    """The runs of the LM family phases (14, 15), each into `report`: serving
    (`serve`), training (`train`) and the card against the CPU (`against_cpu`),
    with the counted, held, timed and profiled calls they are made of.

    `what` names the phase in failures; `timed` holds the call signatures
    already timed (copied), `timed_kn` the (K, N) of the SC products a held
    run may keep for timing.  `counted` gathers the launch counts of every
    counted run by label, `rows` the timed calls."""

    def __init__(self, torch, registry, what: str, card: str, timed: set, timed_kn: set):
        self.torch, self.registry, self.what, self.card = torch, registry, what, card
        self.spec = registry.get("sc_matmul")
        self.timed, self.timed_kn = set(timed), timed_kn
        self.counted, self.rows = {}, []
        self.report = {"card": card, "serving": {}, "training": {}, "cpu": {}}

    def sync(self) -> None:
        """Wait for the card."""
        self.torch.cuda.synchronize()

    def synced(self, fn):
        """fn, then a wait for the card."""
        return lambda: (fn(), self.sync())

    def free(self) -> None:
        """Collect and return the card's cached blocks."""
        gc.collect()
        self.torch.cuda.empty_cache()

    def check_launches(self, label: str, n_sc: int) -> None:
        """Every kernel's launches since the last reset: n_sc SC matmuls, nothing else."""
        got = {n: self.registry.launches()[n] for n in KERNELS}
        self.counted[label] = got
        want = {**dict.fromkeys(KERNELS, 0), "sc_matmul": n_sc}
        if got != want:
            fail(f"{self.what}, {label}: launches {got}, expected {want}")

    def counted_run(self, label: str, run, n_sc: int):
        """run() with the counters at 0 before it and checked after it."""
        self.registry.reset_launches()
        out = run()
        self.sync()
        self.check_launches(label, n_sc)
        return out

    def held_run(self, label: str, run, timing: bool) -> tuple:
        """run() with every SC call held against the plain version as it is made,
        bitwise; with `timing`, the first call at each (K, N) of `timed_kn` and row
        count not timed before is kept.  Returns (run()'s result, calls made,
        kept calls)."""
        torch, spec = self.torch, self.spec
        made, bad, kept = [0], [], []

        def hold(*args, **kw):
            got = spec.cuda(*args, **kw)
            want = spec.plain(*args, **kw)
            made[0] += 1
            if not torch.equal(got, want):
                bad.append((made[0], [tuple(a.shape) for a in args if torch.is_tensor(a)],
                            (got.double() - want.double()).abs().max().item()))
            sig = call_signature(torch, "sc_matmul", args, kw)
            if timing and (args[0].shape[1], args[1].shape[1]) in self.timed_kn and (
                    sig not in self.timed):
                self.timed.add(sig)
                kept.append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw)))
            return got

        self.registry.register("sc_matmul", plain=spec.plain, cuda=hold)
        try:
            out = run()
            self.sync()
        finally:
            self.registry.register("sc_matmul", plain=spec.plain, cuda=spec.cuda)
        if bad:
            fail(f"{self.what}, {label}: SC calls (index, shapes, max |diff|) {bad[:5]} differ "
                 "from the plain version")
        return out, made[0], kept

    def time_kept(self, label: str, kept: list) -> None:
        """Time the kept calls as phase 3 times its calls, into `rows`."""
        for args, kw in kept:
            big = bound("sc_matmul", args, kw, None)[1] > LM_BIG_OPS
            self.rows.append(time_call(self.torch, "sc_matmul", self.spec, args, kw, None, label,
                                       reps=LM_BIG_REPS if big else (50, 5, 20)))

    def peak_mib(self, run) -> float:
        """MiB allocated at run()'s peak above what was allocated before it."""
        torch = self.torch
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        self.sync()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def profiled(self, label: str, fn, wall: float, n_sc: int) -> dict:
        """One profiled call of fn: busy, idle share, kernels; n_sc SC matmuls seen."""
        prof = profile_run(self.torch, fn, wall, self.registry, f"{self.what}, {label}")
        if prof["port_kernels_seen"]["sc_matmul"] != n_sc:
            fail(f"{self.what}, {label}: the card ran {prof['port_kernels_seen']} of the "
                 f"port's kernels, expected {n_sc} SC matmuls")
        return {k: prof[k] for k in ("busy_ms", "idle_share", "kernels_launched",
                                     "port_kernels_seen", "sessions", "top")}

    def init(self, cfg):
        """cfg's family module, drawn on the card from SEED."""
        from repro_torch.models.families import get_family_api

        torch = self.torch
        return get_family_api(cfg)["init"](
            cfg, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")

    def serve(self, label: str, cfg, params, batch: dict, q: str, *, s_max: int, new: int,
              n_sc: tuple[int, int], prompt: str, profile_prefill: bool, ahead: int = 0,
              check_state=None) -> None:
        """cfg under quant q through make_serve_fns, into report["serving"][label]:
        `new` tokens generated (counted, its peak memory taken), then a counted
        prefill and decode step whose greedy tokens must be generate's first
        two; under SC every SC call of a prefill and a decode step held against
        the plain version (new shapes timed under sc_w16a16); host-clock
        prefill and decode times, and profiles of a decode step and, with
        `profile_prefill`, of a prefill.

        n_sc: the SC launches of a prefill and of a decode step under SC;
        `prompt` describes a prompt in the printed line; `ahead`: positions
        before the prompt (a vlm's patches); check_state(prefill's state)
        checks the caches and returns (report entries, printed note)."""
        from repro_torch.core.policy import ExecutionPolicy
        from repro_torch.serve import make_serve_fns

        torch, what = self.torch, f"{self.what}, {label}"
        b, n_tok = batch["tokens"].shape
        n_pre, n_dec = n_sc if q != "none" else (0, 0)
        n_gen = n_pre + (new - 1) * n_dec
        t_run = time.perf_counter()
        fns = make_serve_fns(cfg, ExecutionPolicy(quant=q), device="cuda")
        box = {}
        peak = self.peak_mib(lambda: box.update(gen=self.counted_run(
            f"{label} generate", lambda: fns["generate"](params, batch, steps=new, s_max=s_max),
            n_gen)))
        gen = box.pop("gen").cpu()
        if gen.shape != (b, new) or not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
            fail(f"{what}: generated {tuple(gen.shape)} tokens, some out of range")
        logits, state = self.counted_run(f"{label} prefill",
                                         lambda: fns["prefill"](params, batch, s_max), n_pre)
        if logits.shape != (b, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            fail(f"{what}: prefill logits {tuple(logits.shape)}, not all finite")
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        if not torch.equal(tok.cpu(), gen[:, :1]):
            fail(f"{what}: prefill's greedy token differs from generate's")
        _, nxt, state1 = self.counted_run(
            f"{label} decode", lambda: fns["decode"](params, state, {"token": tok}), n_dec)
        if int(state1.cache_len) != ahead + n_tok + 1 or not torch.equal(nxt.cpu(), gen[:, 1:2]):
            fail(f"{what}: decode's state or greedy token differs from generate's")
        extra, note = check_state(state) if check_state else ({}, "")
        if q != "none":
            with torch.inference_mode():
                _, made, kept = self.held_run(label, lambda: fns["decode"](
                    params, fns["prefill"](params, batch, s_max)[1], {"token": tok}),
                    timing=q == "sc_w16a16")
            if made != n_pre + n_dec:
                fail(f"{what}: a prefill and a decode step made {made} SC calls, expected "
                     f"{n_pre + n_dec}")
            self.time_kept(label, kept)
        prefill = (lambda: fns["prefill"](params, batch, s_max))
        decode = (lambda: fns["decode"](params, state, {"token": tok}))
        t = {"prefill_ms": median_ms(self.synced(prefill), reps=FAMILY_TIMED),
             "decode_ms_per_token": median_ms(self.synced(decode), reps=FAMILY_TIMED)}
        t["decode"] = self.profiled(f"{label} decode", decode, t["decode_ms_per_token"], n_dec)
        if profile_prefill:
            t["prefill"] = self.profiled(f"{label} prefill", prefill, t["prefill_ms"], n_pre)
        t.update(peak_generate_mib=peak,
                 max_abs_err_kernel_vs_plain=None if q == "none" else 0.0,
                 launches={"prefill": n_pre, "decode_step": n_dec, "generate": n_gen},
                 prompts=b, prompt_tokens=n_tok, positions_ahead=ahead, new_tokens=new,
                 parameters=sum(p.numel() for p in params.parameters()),
                 tokens=gen[0].tolist(), **extra)
        t["run_s"] = time.perf_counter() - t_run
        self.report["serving"][label] = t
        say(f"{what}: generate {b} x {prompt} + {new} tokens, launches {n_pre} SC a prefill, "
            f"{n_dec} a decode step"
            + (", every SC call of a prefill and a decode step == plain" if q != "none" else "")
            + note + f"; (host clock, median of {FAMILY_TIMED}; {self.card}) prefill "
            f"{t['prefill_ms']:.3f} ms"
            + (f" (busy {t['prefill']['busy_ms']:.3f} ms, idle "
               f"{t['prefill']['idle_share']:.3f})" if "prefill" in t else "")
            + f", decode {t['decode_ms_per_token']:.3f} ms/token (busy "
            f"{t['decode']['busy_ms']:.3f} ms, idle {t['decode']['idle_share']:.3f}, "
            f"{t['decode']['kernels_launched']} kernels); peak allocated by generate "
            f"{peak:.1f} MiB; this run {t['run_s']:.1f} s")

    def train(self, cfg, q: str, batches: list, n_sc: int, *, stubs: dict | None = None,
              note: str = "") -> None:
        """len(batches) steps of make_train_step from a fresh init under quant q
        (warmup over one step, then LM_TRAIN_LR), into report["training"]: each
        step's launches counted (n_sc SC matmuls under SC), every SC call of
        step 1 held bitwise (new shapes timed under sc_w16a16), the losses
        finite, the float loss on step 1's batch lower after the steps;
        host-clock step times, one profiled step (busy, idle, n_sc SC kernels
        seen on the card), memory after init and at the peak.  batches: token
        batches on the CPU; stubs: a frontend's outputs on the card, added to
        each; `note` describes them in the printed line."""
        from repro_torch.core.policy import ExecutionPolicy
        from repro_torch.models.families import get_family_api
        from repro_torch.optim import adamw_init
        from repro_torch.train import make_train_step

        torch, cuda = self.torch, self.torch.device("cuda")
        pol = ExecutionPolicy(quant=q)
        n_sc = n_sc if q != "none" else 0
        label = f"{cfg.name} quant={q}"
        what = f"{self.what}, {label}"
        bsz, seq = batches[0]["tokens"].shape
        t_run = t1 = time.perf_counter()
        params = self.init(cfg)
        state = adamw_init(params)
        step_fn = make_train_step(cfg, peak_lr=LM_TRAIN_LR, warmup_steps=1,
                                  total_steps=len(batches), policy=pol)
        on_card = [{**{k: v.to(cuda) for k, v in bt.items()}, **(stubs or {})} for bt in batches]
        self.sync()
        init_s = time.perf_counter() - t1
        state_mib = torch.cuda.memory_allocated() / 2**20
        self.registry.reset_launches()
        t1 = time.perf_counter()
        out, made, kept = self.held_run(label, lambda: step_fn(params, state, on_card[0]),
                                        timing=q == "sc_w16a16")
        m = out[2]
        del out
        first_ms = (time.perf_counter() - t1) * 1e3
        self.check_launches(f"{label} train step 1", n_sc)
        if made != n_sc:
            fail(f"{what}: train step 1 made {made} SC calls, expected {n_sc}")
        self.time_kept(f"{label} train", kept)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [m["loss"]], []
        for i, bt in enumerate(on_card[1:], start=2):
            self.registry.reset_launches()
            self.sync()
            t1 = time.perf_counter()
            m = step_fn(params, state, bt)[2]
            self.sync()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            self.check_launches(f"{label} train step {i}", n_sc)
            losses.append(m["loss"])
        peak = torch.cuda.max_memory_allocated() / 2**20
        losses = [x.item() for x in losses]
        if not all(np.isfinite(losses)) or not np.isfinite(m["grad_norm"].item()):
            fail(f"{what}: losses {losses}, grad_norm {m['grad_norm'].item()}")
        learned = None
        if q == "none":  # the float loss on step 1's batch falls
            with torch.no_grad():
                learned = get_family_api(cfg)["train_loss"](params, cfg, on_card[0],
                                                            policy=pol)[0].item()
            if not learned < losses[0]:
                fail(f"{what}: the loss on step 1's batch went {losses[0]:.4f} -> "
                     f"{learned:.4f} in {len(batches)} steps")
        step_med = float(np.median(step_ms))
        prof = self.profiled(f"{label} train step", lambda: step_fn(params, state, on_card[1]),
                             step_med, n_sc)
        entry = self.report["training"][label] = {
            "tokens_a_step": bsz * seq, "layers": cfg.n_layers, "init_s": init_s,
            "losses": losses, "loss_after_on_batch_1": learned, "first_step_ms": first_ms,
            "eager_step_ms": step_med, "step_ms": step_ms, **prof,
            "state_mib": state_mib, "peak_allocated_mib": peak, "sc_launches_a_step": n_sc,
            "run_s": time.perf_counter() - t_run}
        say(f"{self.what}, train {label}: {len(batches)} steps of {bsz} x {seq} tokens{note}, "
            f"losses {[f'{x:.4f}' for x in losses]}"
            + (f" (step 1's batch after: {learned:.4f})" if learned is not None else "")
            + f"; {n_sc} SC launches a step"
            + (", every SC call of step 1 == plain" if n_sc else "")
            + f"; (host clock, median of {len(step_ms)}; {self.card}) step {step_med:.3f} ms "
            f"(first {first_ms:.1f}), busy {prof['busy_ms']:.3f} ms, idle "
            f"{prof['idle_share']:.3f}, {prof['kernels_launched']} kernels; allocated "
            f"{state_mib:.1f} MiB after init, peak {peak:.1f} MiB; this run {entry['run_s']:.1f} s")

    def against_cpu(self, cfg, q: str, p_gpu, p_cpu, batch: dict, s_max: int, *, desc: str,
                    zero: frozenset = frozenset(), watch: MoEPicks | None = None) -> None:
        """The smoke config cfg under quant q on the card (p_gpu) against the
        port's CPU run (p_cpu, the same values), into report["cpu"]: a prefill of
        batch and LM_CPU_STEPS decode steps, teacher-forced with the card's
        tokens, within LM_CPU_TOL; train_loss and every gradient on batch within
        phase 13's bounds (`zero`: the leaves grads_agree holds to the tree's
        largest gradient).  batch: numpy tokens and CPU tensors of a frontend's
        output; `desc` describes it in the printed line; `watch` is entered
        around the serving runs and checked after them."""
        from repro_torch.core.policy import ExecutionPolicy
        from repro_torch.models.families import get_family_api
        from repro_torch.params import named_jax_params
        from repro_torch.serve import make_serve_fns

        torch, cuda = self.torch, self.torch.device("cuda")
        api = get_family_api(cfg)
        pol = ExecutionPolicy(quant=q)
        layers = (f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.encoder_layers
                  else f"{cfg.n_layers}")
        label = f"{cfg.name}[smoke, {layers} layers] quant={q}"
        what = f"{self.what}, {label}"
        on_card = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in batch.items()}
        fg, fc = make_serve_fns(cfg, pol, device="cuda"), make_serve_fns(cfg, pol, device="cpu")
        with watch or contextlib.nullcontext():
            lg, sg = fg["prefill"](p_gpu, on_card, s_max)
            lc, sc = fc["prefill"](p_cpu, batch, s_max)
            diffs = [(lg.cpu() - lc).abs().max().item()]
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            for _ in range(LM_CPU_STEPS):  # teacher-forced: the card's tokens into both
                lg, nxt, sg = fg["decode"](p_gpu, sg, {"token": tok})
                lc, _, sc = fc["decode"](p_cpu, sc, {"token": tok.cpu()})
                diffs.append((lg.cpu() - lc).abs().max().item())
                tok = nxt
        picks, note = watch.check(what) if watch else ({}, "")
        if not all(np.isfinite(diffs)) or max(diffs) > LM_CPU_TOL[q]:
            fail(f"{what}: logits differ from the CPU run by {diffs} > {LM_CPU_TOL[q]}")
        named_g, named_c = named_jax_params(p_gpu), named_jax_params(p_cpu)
        toks = batch["tokens"]
        tb = {**{k: v for k, v in batch.items() if torch.is_tensor(v)},
              "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, 1))}
        loss_g, _ = api["train_loss"](p_gpu, cfg, {k: v.to(cuda) for k, v in tb.items()},
                                      policy=pol)
        g_gpu = dict(zip(named_g, torch.autograd.grad(loss_g, list(named_g.values()))))
        loss_c, _ = api["train_loss"](p_cpu, cfg, tb, policy=pol)
        g_cpu = dict(zip(named_c, torch.autograd.grad(loss_c, list(named_c.values()))))
        ldiff = abs(loss_g.item() - loss_c.item())
        if not np.isfinite(ldiff) or ldiff > LM_TRAIN_LOSS_TOL[q]:
            fail(f"{what}: loss {loss_g.item()} on the card, {loss_c.item()} on the CPU "
                 f"(|diff| {ldiff} > {LM_TRAIN_LOSS_TOL[q]})")
        gworst, gwhere = grads_agree(torch, g_gpu, g_cpu, q, tol=LM_TRAIN_GRAD_TOL, what=what,
                                     pattern_rel=LM_TRAIN_PATTERN_REL, zero=zero)
        self.report["cpu"][label] = {
            "logit_max_abs_diff": diffs, "tolerance": LM_CPU_TOL[q], **picks,
            "loss_card": loss_g.item(), "loss_cpu": loss_c.item(), "grad_worst_rel": gworst,
            "grad_worst_leaf": gwhere, "zero_gradient_leaves": sorted(zero)}
        say(f"{what}: card vs CPU, prefill of {desc} and {LM_CPU_STEPS} teacher-forced decode "
            f"steps: max |logit diff| {[f'{d:.3e}' for d in diffs]} <= {LM_CPU_TOL[q]}" + note
            + f"; train_loss {loss_g.item():.6f} / {loss_c.item():.6f}, gradients within "
            f"{gworst:.3e} of each leaf's max (worst {gwhere})"
            + (f", {len(zero)} key-bias leaves within {ZERO_GRAD_REL} of the largest"
               if zero else ""))

    def say_rows(self) -> None:
        """The timed calls, into report["kernel_calls"] and printed."""
        self.report["kernel_calls"] = self.rows
        for r in self.rows:
            say(f"{self.what}, sc_matmul {r['shapes']} n_planes={r['kw']['n_planes']} "
                f"({r['path']}): kernel {r['ms']:.4f} ms (enqueue {r['enqueue_ms']:.4f}), plain "
                f"{r['plain_ms']:.4f} ms, float64 torch.matmul {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']})")


def lm_families_phase(torch, registry, card: str, timed: set) -> tuple[dict, dict]:
    """Phase 14: the moe, ssm and hybrid LM families through make_serve_fns and
    make_train_step, the SC matmul at their shapes.

    `timed` holds the call signatures already timed.  Returns the launch
    counts of each counted run and the numbers to report.
    """
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import token_stream
    from repro_torch.models.families import get_family_api

    t_phase = time.perf_counter()
    runs = LMRuns(torch, registry, "lm families", card, timed, FAMILY_TIMED_KN)
    report = runs.report
    rng = np.random.default_rng(SEED + 14)

    # -- serving at full width (dbrx cut to 2 layers) ----------------------------------
    t0 = time.perf_counter()
    for name, layers, b, prompt, new in FAMILY_SERVE:
        base = get_config(name)
        if layers is not None:
            say(f"lm families: {name} cut to {layers} of its {base.n_layers} layers "
                f"({base.n_experts} experts of {base.d_model} x {base.d_ff} a layer, "
                f"{base.param_count() * 2 / 1e9:.0f} GB of bf16 weights in all, do not fit in "
                "the card's 80 GB)")
            base = dataclasses.replace(base, n_layers=layers)
        n_lin = lm_linears(base)
        t1 = time.perf_counter()
        params = runs.init(base)
        runs.sync()
        n_params = sum(p.numel() for p in params.parameters())
        say(f"lm families: {base.name} ({base.family}, {base.n_layers} layers, d_model "
            f"{base.d_model}, {base.dtype}, {n_params:,} parameters) drawn on the card in "
            f"{time.perf_counter() - t1:.1f} s, {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
            "allocated")
        batch = {"tokens": rng.integers(0, base.vocab_size, (b, prompt)).astype(np.int32)}
        s_max = prompt + new

        def local_caches(state, base=base, s_max=s_max):
            """The hybrid's local caches keep the window, rolled."""
            n = state.group_caches[base.layer_pattern.index("local")].k.shape[2]
            if n != min(s_max, base.window):
                fail(f"lm families, {base.name}: local caches of {n}")
            return {"local_cache": n}, f", local caches of {n} (rolled)"

        cases = [(q, "none") for q in FAMILY_QUANTS]
        if base.family == "moe" and layers is None:
            cases.insert(1, ("none", "int8"))
        for q, kv in cases:
            label = (f"{base.name}[{base.n_layers} layers] quant={q}"
                     + (f" kv={kv}" if kv != "none" else ""))
            # recurrentgemma's prefill: ~40k kernels a profiler session
            runs.serve(label, dataclasses.replace(base, kv_quant=kv), params, batch, q,
                       s_max=s_max, new=new, n_sc=(n_lin, n_lin), prompt=str(prompt),
                       profile_prefill=kv == "none" and q == "none",
                       check_state=local_caches if base.family == "hybrid" else None)
        del params
        runs.free()
    report["serving_s"] = time.perf_counter() - t0

    # -- training at full width, remat "full" -------------------------------------------
    t0 = time.perf_counter()
    for name in FAMILY_TRAIN:
        base = get_config(name)
        stream = token_stream(SEED, *FAMILY_TRAIN_ROWS, base.vocab_size, device="cpu")
        train = [batch for _, (_, batch) in zip(range(FAMILY_TRAIN_STEPS), stream)]
        for q in ("none", "sc_w16a16"):
            runs.train(base, q, train, lm_linears(base, train=True))
            runs.free()
    report["training_s"] = time.perf_counter() - t0

    # -- against the port's CPU run, at smoke width ---------------------------------------
    t0 = time.perf_counter()
    rows, cols = FAMILY_CPU_ROWS
    for name in FAMILY_TRAIN:
        cfg = get_config(name, smoke=True)
        p_cpu = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(SEED),
                                            device="cpu")
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, cols)).astype(np.int32)}
        for q in ("none", "sc_w16a16"):
            runs.against_cpu(cfg, q, p_gpu, p_cpu, batch, cols + LM_CPU_STEPS,
                             desc=f"{rows} x {cols}",
                             watch=MoEPicks(torch) if cfg.family == "moe" else None)
        del p_gpu, p_cpu
        runs.free()
    report["cpu_check_s"] = time.perf_counter() - t0

    runs.say_rows()
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"lm families phase: {report['phase_s']:.1f} s (serving {report['serving_s']:.1f} s, "
        f"training {report['training_s']:.1f} s, against the CPU {report['cpu_check_s']:.1f} s)")
    return runs.counted, report


def encdec_vlm_linears(cfg) -> dict[str, int]:
    """SC matmuls of one whisper or internvl2 step: {"prefill", "decode", "train"}.

    encdec: an encoder layer's 6 (wq, wk, wv, wo, the MLP's 2) and a decoder
    layer's 10 (self-attention 4, cross-attention 4, the MLP's 2) in prefill; 8
    a decoder layer in decode, the cross K/V read from the cache.  vlm: 7 a
    layer (attention 4, GLU 3) and patch_proj, in prefill and training only.
    Training, remat "full": every layer's linears twice (the forward and the
    backward's recompute of its remat unit), patch_proj once."""
    if cfg.family == "encdec":
        pre = 6 * cfg.encoder_layers + 10 * cfg.n_layers
        return {"prefill": pre, "decode": 8 * cfg.n_layers, "train": 2 * pre}
    per = 7 * cfg.n_layers
    return {"prefill": per + 1, "decode": per, "train": 2 * per + 1}


def frontend_stub(torch, cfg, b: int, n: int, *, zeros: bool = False, generator=None) -> dict:
    """The stubbed frontend's output of cfg's family on the card in cfg.dtype:
    enc_embeds (b, n frames, D) or patch_embeds (b, n patches, D); seeded
    normal draws, or zeros (the reference's training stubs)."""
    key = "enc_embeds" if cfg.family == "encdec" else "patch_embeds"
    shape = (b, n, cfg.d_model)
    if zeros:
        x = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
    else:
        x = torch.randn(shape, generator=generator, device="cuda").to(cfg.dtype)
    return {key: x}


def lm_encdec_vlm_phase(torch, registry, card: str, timed: set) -> tuple[dict, dict]:
    """Phase 15: the encdec (whisper-small) and vlm (internvl2-2b) LM families
    through make_serve_fns and make_train_step, the SC matmul at their shapes.

    `timed` holds the call signatures already timed.  Returns the launch
    counts of each counted run and the numbers to report.
    """
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import token_stream
    from repro_torch.models.families import get_family_api
    from repro_torch.params import named_jax_params

    t_phase = time.perf_counter()
    runs = LMRuns(torch, registry, "lm encdec/vlm", card, timed, ENCDEC_VLM_TIMED_KN)
    report = runs.report
    rng = np.random.default_rng(SEED + 15)
    draw = torch.Generator("cuda").manual_seed(SEED + 15)

    # -- serving at full width and depth ---------------------------------------------
    t0 = time.perf_counter()
    for name, b, prompt, new, s_max in ENCDEC_VLM_SERVE:
        base = get_config(name)
        n = encdec_vlm_linears(base)
        t1 = time.perf_counter()
        params = runs.init(base)
        runs.sync()
        n_params = sum(p.numel() for p in params.parameters())
        encdec = base.family == "encdec"
        frames = ENCDEC_FRAMES if encdec else base.n_patches
        kind = "frames" if encdec else "patches"
        batch = {"tokens": rng.integers(0, base.vocab_size, (b, prompt)).astype(np.int32),
                 **frontend_stub(torch, base, b, frames, generator=draw)}
        say(f"lm encdec/vlm: {base.name} ({base.family}, {base.encoder_layers or 0} encoder + "
            f"{base.n_layers} layers, d_model {base.d_model}, {base.dtype}, {n_params:,} "
            f"parameters) drawn on the card in {time.perf_counter() - t1:.1f} s; stub "
            f"{'encoder frames' if encdec else 'patches'} {b} x {frames} x {base.d_model}")

        def float_caches(state, base=base, b=b, s_max=s_max, frames=frames, encdec=encdec):
            """Float caches of the reference's shapes: self of s_max, whisper's cross of
            the frames."""
            shape = (base.n_layers, b, s_max, base.n_kv_heads, base.head_dim)
            if encdec:
                caches = {"self": tuple(state.self_caches.k.shape),
                          "cross": tuple(state.cross_caches.k.shape)}
                dtypes = {state.self_caches.k.dtype, state.cross_caches.k.dtype}
                want = {"self": shape, "cross": shape[:2] + (frames,) + shape[3:]}
            else:
                caches = {"self": tuple(state.caches[0].k.shape)}
                dtypes = {c.k.dtype for c in state.caches}
                want = {"self": shape}
            if caches != want or dtypes != {base.dtype}:
                fail(f"lm encdec/vlm, {base.name}: caches {caches} of {dtypes}, expected "
                     f"{want} of {base.dtype}")
            return ({"caches": caches, "frontend_positions": frames},
                    f"; caches {caches} in {base.dtype}")

        for q in FAMILY_QUANTS:
            runs.serve(f"{base.name} quant={q}", base, params, batch, q, s_max=s_max, new=new,
                       n_sc=(n["prefill"], n["decode"]), prompt=f"({frames} {kind} + {prompt})",
                       profile_prefill=q == "none", ahead=0 if encdec else frames,
                       check_state=float_caches)
        del params, batch
        runs.free()
    report["serving_s"] = time.perf_counter() - t0

    # -- training at full width, remat "full" --------------------------------------------
    t0 = time.perf_counter()
    bsz, seq = ENCDEC_VLM_TRAIN_ROWS
    for name, _, _, _, _ in ENCDEC_VLM_SERVE:
        base = get_config(name)
        encdec = base.family == "encdec"
        stubs = frontend_stub(torch, base, bsz, seq if encdec else base.n_patches,
                              zeros=encdec, generator=draw)
        note = (" (+ the reference's zero stub frames)" if encdec else
                " (+ seeded normal stub patches: zeros overflow the gradient)")
        stream = token_stream(SEED, bsz, seq, base.vocab_size, device="cpu")
        train = [batch for _, (_, batch) in zip(range(ENCDEC_VLM_TRAIN_STEPS), stream)]
        for q in FAMILY_QUANTS:
            runs.train(base, q, train, encdec_vlm_linears(base)["train"], stubs=stubs, note=note)
            runs.free()
        del stubs
    report["training_s"] = time.perf_counter() - t0

    # -- against the port's CPU run, at smoke width ---------------------------------------
    t0 = time.perf_counter()
    rows, cols = FAMILY_CPU_ROWS
    for name, _, _, _, _ in ENCDEC_VLM_SERVE:
        cfg = get_config(name, smoke=True)
        encdec = cfg.family == "encdec"
        p_cpu = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(SEED),
                                            device="cpu")
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        frames = ENCDEC_CPU_FRAMES if encdec else cfg.n_patches
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, cols)).astype(np.int32),
                 "enc_embeds" if encdec else "patch_embeds": torch.from_numpy(
                     rng.standard_normal((rows, frames, cfg.d_model)).astype(np.float32))}
        s_max = (0 if encdec else frames) + cols + LM_CPU_STEPS
        zero = frozenset(k for k in named_jax_params(p_cpu) if k.endswith("wk.b"))
        for q in ("none", "sc_w16a16"):
            runs.against_cpu(cfg, q, p_gpu, p_cpu, batch, s_max, zero=zero,
                             desc=f"{rows} x ({frames} {'frames' if encdec else 'patches'} "
                                  f"+ {cols})")
        del p_gpu, p_cpu
        runs.free()
    report["cpu_check_s"] = time.perf_counter() - t0

    runs.say_rows()
    report["phase_s"] = time.perf_counter() - t_phase
    say(f"lm encdec/vlm phase: {report['phase_s']:.1f} s (serving {report['serving_s']:.1f} s, "
        f"training {report['training_s']:.1f} s, against the CPU {report['cpu_check_s']:.1f} s)")
    return runs.counted, report


# LM layout phase (16): stablelm-1.6b at full width and LM_LAYERS layers (bf16,
# weights drawn on the card from SEED) on the host mesh (make_host_mesh: 1 x 1
# on this card).  Its parameters, AdamW state and a LM_TRAIN_BATCH x
# LM_TRAIN_SEQ batch are placed by MESH_POLICIES' shardings; one sc_w16a16
# train step under each MESH_MODES activation-hint mode must equal the same
# step outside any context, bitwise; so must a float and an SC prefill of
# LM_BATCH x LM_PROMPT and MESH_DECODE decode steps.
MESH_POLICIES = ("fsdp_tp", "fsdp2d")
MESH_MODES = ("sp", "fsdp2d")
MESH_DECODE = 4
# The CUDA caching allocator hands out blocks in multiples of 512 bytes: the
# growth of memory_allocated from placing a tensor exceeds its bytes by less.
ALLOC_ROUND = 512
# dry-run cells run on meta tensors (launch/dryrun.py), each timed: (arch, shape, mesh)
MESH_CELLS = (("stablelm-1.6b", "train_4k", "single"), ("stablelm-1.6b", "decode_32k", "single"),
              ("mamba2-1.3b", "long_500k", "single"))
MESH_SKIPPED = ("stablelm-1.6b", "long_500k", "single")
# One H100's dense bf16 tensor-core peak (NVIDIA's data sheet, SXM, without
# sparsity).
PEAK_BF16_FLOPS = 989e12
# The dry-run cells' compute term: each FLOP type of the op counter
# (launch/hlo_analysis) over the peak of the unit that runs it.  The port's
# float32 dots run outside the tensor cores (TF32 is off); an elementwise,
# reduce, gather or write FLOP is one instruction on the FP32 pipes.
MESH_PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_OPS, "sc_int8": PEAK_INT8_OPS,
              "vector": PEAK_F32_INSTR}
# The dry-run cells' collective term: one device's collective bytes (the census,
# launch/spmd.py) over H100 NVLink 4's 450 GB/s a direction (NVIDIA's H100 SXM
# data sheet: 18 links, 900 GB/s both ways), the rate within one 8-card node.
# The bytes are DTensor's greedy layout of the eager step, 0.39-26.7x GSPMD's
# on a (2, 4) mesh (tests/test_torch_lm_collectives.py): an estimate, neither
# bound, which `roofline_ms` keeps out of bound_by.  The production meshes'
# 16-wide "model" axis spans two nodes, whose link is slower than this rate.
NVLINK_BYTES_PER_S = 450e9
# One device's peak on the card (max_memory_allocated over a step, less what was
# allocated before it, plus its arguments as allocated) against the census's
# peak_memory_in_bytes for the same cell on the 1 x 1 host mesh, within
# mem_band: at most 0.1 % under it (the census keeps a product that a fused
# call does not: 0.99996 at prefill on an H100), and over it by no more than what
# the allocator adds: cuBLAS's workspace (CUBLAS_WORKSPACE, where a step makes
# it) and the 512 B rounding of every storage the step allocates.
MEM_FLOOR = 0.999
CUBLAS_WORKSPACE = 32 * 2**20


def mem_band(census: dict) -> tuple[float, float]:
    """(lowest, highest) ratio of the card's peak to the census's for one step."""
    peak = census["memory"]["peak_memory_in_bytes"]
    return MEM_FLOOR, 1.0 + (CUBLAS_WORKSPACE + ALLOC_ROUND * census["allocations"]) / peak


def lm_mesh_phase(torch, registry, card: str) -> tuple[dict, dict]:
    """Phase 16: the LM's device layout on the host mesh, the op counter on the card
    and on meta, the dry run's argument bytes against the card's allocator, one
    device's peak on the card (SC train, prefill and decode steps) against the
    dry run's census on the 1 x 1 mesh (which must move nothing), and dry-run
    cells with their census (collectives, peak a device) and roofline terms,
    the collective term at NVLink's rate, on this card.

    Returns the launch counts of each counted run and the numbers to report.
    """
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.tokens import token_stream
    from repro_torch.launch import dryrun, hlo_analysis, spmd
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.families import get_family_api
    from repro_torch.optim import adamw_init
    from repro_torch.params import lm_param_tree, named_jax_params
    from repro_torch.sharding import policy as POL
    from repro_torch.sharding.hints import activation_sharding
    from repro_torch.sharding.spec import NamedSharding, PartitionSpec, place
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    counted, report = {}, {"card": card, "train": {}, "serve": {}, "memory": {}, "counter": {},
                           "dryrun": {}}
    spec = registry.get("sc_matmul")
    cfg = stablelm_cut("lm mesh")
    api = get_family_api(cfg)
    mesh = make_host_mesh()
    say(f"lm mesh: host mesh {mesh}")
    n_train, n_step = lm_linears(cfg, train=True), lm_linears(cfg)
    pols = {"none": ExecutionPolicy(quant="none"), "sc_w16a16": ExecutionPolicy(quant="sc_w16a16")}

    def sync():
        torch.cuda.synchronize()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def check_launches(label: str, n_sc: int) -> None:
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        want = {**dict.fromkeys(KERNELS, 0), "sc_matmul": n_sc}
        if got != want:
            fail(f"lm mesh, {label}: launches {got}, expected {want}")

    params0 = T.init_lm(cfg, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
    opt0 = adamw_init(params0)
    _, cpu_batch = next(token_stream(SEED, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab_size,
                                     device="cpu"))
    batch0 = {k: v.cuda() for k, v in cpu_batch.items()}
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
                               .astype(np.int32)).cuda()
    s_max = LM_PROMPT + MESH_DECODE
    step_fn = make_train_step(cfg, peak_lr=LM_TRAIN_LR, warmup_steps=1, total_steps=2,
                              policy=pols["sc_w16a16"])

    def shardings(p: str) -> tuple[dict, dict]:
        """Per port parameter and per batch leaf, its NamedSharding under policy p."""
        pol = POL.POLICIES[p]
        tree = lm_param_tree(params0, device="meta")
        psh = POL.module_pspecs(params0, POL.to_shardings(
            POL.param_pspecs(tree, mesh, pol, cfg), mesh))
        bsh = POL.to_shardings(POL.batch_pspecs(cfg, batch0, mesh, pol), mesh)
        return psh, bsh

    def placed_params(psh: dict):
        module = T.init_lm(cfg, device="meta")
        module.load_state_dict({n: place(t.detach(), psh[n])
                                for n, t in named_jax_params(params0).items()}, assign=True)
        return module

    def placed_state(p: str):
        """params, AdamW state and batch placed by policy p's shardings, and what
        placing them allocated: (module, opt, batch, bytes grown, tensors placed)."""
        psh, bsh = shardings(p)
        sync()
        before = torch.cuda.memory_allocated()
        module = placed_params(psh)
        moments = [None if d is None else {n: place(t, psh[n]) for n, t in d.items()}
                   for d in (opt0.mu, opt0.nu, opt0.master)]
        opt = type(opt0)(place(opt0.step, NamedSharding(mesh, PartitionSpec())), *moments)
        batch = {k: place(v, bsh[k]) for k, v in batch0.items()}
        sync()
        n_tensors = 1 + len(batch) + len(psh) * (1 + sum(d is not None for d in moments))
        return module, opt, batch, torch.cuda.memory_allocated() - before, n_tensors

    def held_step(module, opt, batch):
        """One train step with every SC call held against the plain version as it is
        made, bitwise (phase 13's check); returns (metrics, calls made)."""
        made, bad = [0], []

        def hold(*args, **kw):
            got = spec.cuda(*args, **kw)
            want = spec.plain(*args, **kw)
            made[0] += 1
            if not torch.equal(got, want):
                bad.append((made[0], [tuple(a.shape) for a in args if torch.is_tensor(a)]))
            return got

        registry.register("sc_matmul", plain=spec.plain, cuda=hold)
        try:
            m = step_fn(module, opt, batch)[2]
            sync()
        finally:
            registry.register("sc_matmul", plain=spec.plain, cuda=spec.cuda)
        if bad:
            fail(f"lm mesh: SC calls (index, shapes) {bad[:5]} differ from the plain version")
        return m, made[0]

    # -- (a) one SC train step outside any context, then under each policy x mode ------
    t0 = time.perf_counter()
    module, opt, batch, _, _ = placed_state(MESH_POLICIES[0])
    registry.reset_launches()
    with deterministic(torch):
        m = step_fn(module, opt, batch)[2]
    sync()
    check_launches("train, no context", n_train)
    want_loss, want_gn = m["loss"].clone(), m["grad_norm"].clone()
    want_params = {n: t.detach().clone() for n, t in named_jax_params(module).items()}
    del module, opt, batch, m
    free()
    for p in MESH_POLICIES:
        for i, mode in enumerate(MESH_MODES):
            module, opt, batch, grown, n_tensors = placed_state(p)
            if i == 0:  # (c) the dry run's argument bytes against the allocator
                meta_batch = {k: torch.empty_like(v, device="meta") for k, v in batch0.items()}
                args, shs = dryrun.cell_arguments(cfg, "train", meta_batch, mesh, p)
                want_bytes = dryrun.argument_bytes(args, shs)
                report["memory"][p] = {"argument_bytes": want_bytes, "allocated_growth": grown,
                                       "tensors": n_tensors}
                say(f"lm mesh, {p}: placing params, AdamW state and batch grew memory_allocated "
                    f"by {grown} B; the dry run's per-device argument bytes {want_bytes} "
                    f"({n_tensors} tensors, the allocator's {ALLOC_ROUND} B blocks)")
                if not 0 <= grown - want_bytes <= ALLOC_ROUND * n_tensors:
                    fail(f"lm mesh, {p}: placing grew memory by {grown} B against the dry run's "
                         f"{want_bytes} B, beyond {ALLOC_ROUND} B a tensor")
            label = f"train, policy={p} mode={mode}"
            registry.reset_launches()
            with activation_sharding(mesh, mode=mode), deterministic(torch):
                if (p, mode) == (MESH_POLICIES[0], MESH_MODES[0]):
                    m, made = held_step(module, opt, batch)
                    if made != n_train:
                        fail(f"lm mesh, {label}: {made} SC calls, expected {n_train}")
                else:
                    m = step_fn(module, opt, batch)[2]
            sync()
            check_launches(label, n_train)
            if not (torch.equal(m["loss"], want_loss) and torch.equal(m["grad_norm"], want_gn)):
                fail(f"lm mesh, {label}: loss {m['loss'].item()} / grad norm "
                     f"{m['grad_norm'].item()} against {want_loss.item()} / {want_gn.item()} "
                     "outside the context")
            diff = [n for n, t in named_jax_params(module).items()
                    if not torch.equal(t.detach(), want_params[n])]
            if diff:
                fail(f"lm mesh, {label}: parameters {diff[:5]} differ from the step outside "
                     "the context")
            report["train"][label] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
            del module, opt, batch, m
            free()
    del want_params
    free()
    say(f"lm mesh: one sc_w16a16 train step of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} under "
        f"{len(MESH_POLICIES)} placements x {len(MESH_MODES)} hint modes is bitwise the step "
        f"outside any context (loss {want_loss.item():.6f}, grad norm {want_gn.item():.6f}, "
        f"every parameter); {n_train} SC launches each, held against plain in the first; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (a) prefill and decode steps, float and SC ---------------------------------------
    def serve(params, pol) -> list:
        outs = []
        with torch.no_grad():
            logits, state = api["prefill"](params, cfg, {"tokens": prompts}, s_max, policy=pol)
            outs += [logits, *[t for c in state.caches for t in c], state.cache_len]
            for _ in range(MESH_DECODE):
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
                logits, state = api["decode_step"](params, cfg, state, {"token": tok},
                                                   policy=pol)
                outs += [logits, *[t for c in state.caches for t in c]]
        return outs

    t0 = time.perf_counter()
    want = {}
    for q, pol in pols.items():
        registry.reset_launches()
        want[q] = serve(params0, pol)
        sync()
        check_launches(f"serve quant={q}, no context", n_step * (1 + MESH_DECODE) if q != "none"
                       else 0)
    for p in MESH_POLICIES:
        module = placed_params(shardings(p)[0])
        for mode in MESH_MODES:
            for q, pol in pols.items():
                label = f"serve quant={q}, policy={p} mode={mode}"
                registry.reset_launches()
                with activation_sharding(mesh, mode=mode):
                    got = serve(module, pol)
                sync()
                check_launches(label, n_step * (1 + MESH_DECODE) if q != "none" else 0)
                bad = [i for i, (a, b) in enumerate(zip(got, want[q], strict=True))
                       if not torch.equal(a, b)]
                if bad:
                    fail(f"lm mesh, {label}: outputs {bad[:5]} differ from outside the context")
        del module
        free()
    report["serve"] = {"prompts": [LM_BATCH, LM_PROMPT], "decode_steps": MESH_DECODE,
                       "s": round(time.perf_counter() - t0, 3)}
    say(f"lm mesh: float and SC prefill of {LM_BATCH} x {LM_PROMPT} + {MESH_DECODE} decode "
        f"steps under every placement x mode bitwise equal outside the context "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- (b) the op counter: the prefill on the card and on meta --------------------------
    meta_params = SH.abstract_module(cfg)
    meta_prompts = torch.empty_like(prompts, device="meta")
    model = SH.model_flops_at(cfg, "prefill", LM_BATCH, LM_PROMPT)
    for q, pol in pols.items():
        counts = {}
        for where, params, toks in (("card", params0, prompts), ("meta", meta_params,
                                                                 meta_prompts)):
            with torch.no_grad():
                counts[where] = hlo_analysis.analyze(
                    lambda: api["prefill"](params, cfg, {"tokens": toks}, s_max, policy=pol))
        keys = ("ops", "flops", "bytes", "dot_flops", "ops_by_kind")
        if any(counts["card"][k] != counts["meta"][k] for k in keys):
            fail(f"lm mesh, counter, prefill quant={q}: card "
                 f"{ {k: counts['card'][k] for k in keys} } against meta "
                 f"{ {k: counts['meta'][k] for k in keys} }")
        c = counts["card"]
        report["counter"][q] = {k: c[k] for k in keys} | {"model_flops": model}
        say(f"lm mesh, counter, prefill {LM_BATCH} x {LM_PROMPT} quant={q}: card == meta: "
            f"{c['ops']} ops ({c['ops_by_kind'].get('sc_matmul', 0)} SC kernels), "
            f"{c['flops']:.6e} FLOPs (dots {c['dot_flops']:.6e}), {c['bytes']:.6e} bytes; "
            f"model_flops {model:.6e}")
    del meta_params
    free()

    # -- (f) one device's memory: the card's allocator against the census on 1 x 1 --------
    t0 = time.perf_counter()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    sc = pols["sc_w16a16"]
    meta = {"train": ({k: torch.empty_like(v, device="meta") for k, v in batch0.items()}, None),
            "prefill": ({"tokens": torch.empty_like(prompts, device="meta")}, None),
            "decode": ({"token": torch.empty((LM_BATCH, 1), dtype=torch.int32,
                                             device="meta")},
                       api["init_decode_state"](cfg, LM_BATCH, s_max, device="meta"))}
    predicted = {kind: spmd.census(cfg, kind, b, st, mesh, MESH_POLICIES[0], policy=sc,
                                   s_max=s_max)
                 for kind, (b, st) in meta.items()}
    for kind, c in predicted.items():  # nothing to move on one device
        moved = {k: v for k, v in c["collectives"].items() if v["count"] or v["bytes"]}
        if moved or c["collective_bytes_total"]:
            fail(f"lm mesh, census of {kind} on the 1 x 1 host mesh: collectives {moved}")

    def allocated(tensors) -> int:
        """Bytes the allocator holds for the distinct storages of `tensors`."""
        sizes = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
        return sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in sizes.values())

    def card_peak(run, arg_bytes: int) -> int:
        """max_memory_allocated over run(), less what was allocated before it, plus
        the arguments' bytes as allocated."""
        sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        sync()
        peak = torch.cuda.max_memory_allocated()
        del out
        return peak - before + arg_bytes

    registry.reset_launches()
    module, opt, batch, grown, _ = placed_state(MESH_POLICIES[0])
    got = {"train": card_peak(lambda: step_fn(module, opt, batch), grown)}
    del module, opt, batch
    free()
    module = placed_params(shardings(MESH_POLICIES[0])[0])
    params = list(module.parameters())
    with torch.no_grad():
        got["prefill"] = card_peak(
            lambda: api["prefill"](module, cfg, {"tokens": prompts}, s_max, policy=sc),
            allocated(params + [prompts]))
        logits, state = api["prefill"](module, cfg, {"tokens": prompts}, s_max, policy=sc)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        del logits
        leaves = [t for c in state.caches for t in c] + [state.cache_len]
        got["decode"] = card_peak(
            lambda: api["decode_step"](module, cfg, state, {"token": tok}, policy=sc),
            allocated(params + leaves + [tok]))
    check_launches("memory: train, two prefills and decode", n_train + 3 * n_step)
    del module, params, state, tok, leaves
    free()
    for kind, c in predicted.items():
        want = c["memory"]["peak_memory_in_bytes"]
        ratio, band = got[kind] / want, mem_band(c)
        report["memory"][f"peak {kind}"] = {"card": got[kind], "census": want, "ratio": ratio,
                                            "census_memory": c["memory"], "band": band,
                                            "allocations": c["allocations"]}
        say(f"lm mesh, memory, one sc_w16a16 {kind} step of the {cfg.n_layers}-layer stablelm "
            f"on this card ({card}): max_memory_allocated gives {got[kind]} B against the "
            f"census's {want} B on the 1 x 1 mesh (ratio {ratio:.6f}, band ({band[0]}, "
            f"{band[1]:.6f}): {c['allocations']} allocations); the census's collectives: none")
        if not band[0] <= ratio <= band[1]:
            fail(f"lm mesh, memory, {kind}: the card's peak {got[kind]} B is {ratio:.6f} x the "
                 f"census's {want} B, outside {band}")
    say(f"lm mesh, memory against the census: {time.perf_counter() - t0:.1f} s")

    # -- (d), (e) dry-run cells on meta, their roofline terms on this card -----------------
    for arch, shape, mk in MESH_CELLS:
        r = dryrun.run_cell(arch, shape, mk)
        if r["status"] != "ok":
            fail(f"lm mesh, dry run {arch} x {shape} x {mk}: {r['status']} "
                 f"{r.get('error', r.get('reason'))}")
        h = r["hlo_analysis"]
        roof = hlo_analysis.roofline_ms(h, r["n_devices"], MESH_PEAKS, PEAK_BYTES_PER_S,
                                        NVLINK_BYTES_PER_S)
        peak = r["memory_analysis"]["peak_memory_in_bytes"]
        if not h["collective_bytes_total"] > 0:
            fail(f"lm mesh, dry run {arch} x {shape} x {mk}: no collective bytes on "
                 f"{r['n_devices']} devices")
        report["dryrun"][f"{arch} x {shape} x {mk}"] = {
            "lower_s": r["lower_s"], "census_s": h["census_s"], "n_devices": r["n_devices"],
            "flops": h["flops"], "flops_by_type": h["flops_by_type"], "bytes": h["bytes"],
            "dot_flops": h["dot_flops"], "model_flops": r["model_flops"],
            "argument_bytes": r["memory_analysis"]["argument_size_in_bytes"],
            "collectives": h["collectives"], "collective_bytes_total": h["collective_bytes_total"],
            "replicated_ops": h["replicated_ops"], "memory_analysis": r["memory_analysis"],
            "card_bytes": card_bytes, **roof}
        census = "; ".join(f"{k} {v['count']} ops {v['bytes']} B"
                           for k, v in h["collectives"].items())
        say(f"lm mesh, dry run {arch} x {shape} x {mk}, one device's census: {census}; "
            f"collective term {roof['collective_ms']:.4f} ms ({h['collective_bytes_total']} B "
            f"/ {NVLINK_BYTES_PER_S:.3g} B/s, NVLink within one 8-card node; the bytes are "
            f"DTensor's greedy layout, an estimate kept out of bound_by); peak {peak / 1e9:.3f} GB a device against "
            f"this card's {card_bytes / 1e9:.1f} GB "
            f"({'fits' if peak <= card_bytes else 'does not fit'}); ops run on whole inputs: "
            f"{h['replicated_ops'] or 'none'}")
        by_type = ", ".join(f"{t} {f:.6e} FLOPs / {MESH_PEAKS[t]:.4g} FLOP/s = "
                            f"{roof['compute_ms_by_type'][t]:.4f} ms"
                            for t, f in h["flops_by_type"].items())
        say(f"lm mesh, dry run {arch} x {shape} x {mk} (policy fsdp_tp, {r['n_devices']} "
            f"devices): counted in {r['lower_s']} s; {h['flops']:.6e} FLOPs "
            f"(model_flops {r['model_flops']:.6e}), {h['bytes']:.6e} bytes, "
            f"{r['memory_analysis']['argument_size_in_bytes']} argument bytes a device; "
            f"roofline on this card ({card}): compute {roof['compute_ms']:.4f} ms "
            f"(over {r['n_devices']} devices: {by_type}), memory "
            f"{roof['memory_ms']:.4f} ms (bytes / ({r['n_devices']} x "
            f"{PEAK_BYTES_PER_S:.3g} B/s)), bound by {roof['bound_by']}")
    arch, shape, mk = MESH_SKIPPED
    r = dryrun.run_cell(arch, shape, mk)
    if r["status"] != "skipped" or r["reason"] != SH.skip_reason(arch, shape):
        fail(f"lm mesh, dry run {arch} x {shape} x {mk}: {r}")
    say(f"lm mesh, dry run {arch} x {shape} x {mk}: skipped, {r['reason']}")
    report["dryrun"][f"{arch} x {shape} x {mk}"] = {"status": "skipped", "reason": r["reason"]}

    del params0, opt0, batch0
    free()
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    say(f"lm mesh phase: {report['phase_s']} s")
    return counted, report


def corner_runtime_phase(torch, cfgs: dict, registry, card: str,
                         timed: set) -> tuple[dict, dict]:
    """Phase 17 (a): the comparison corners of RUNTIME_CORNERS through serving,
    training and sharding, each model at full width, by the checks of phases
    7, 9 and 10 (counted_serve, step1_against_cpu and replay_against_eager,
    sharded_forward).

    `timed` holds the call signatures earlier phases timed; the calls at other
    shapes are timed here.  Returns the launch counts of each counted run and
    the numbers to report.
    """
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.pointclouds import fold_in, sample_batch
    from repro_torch.launch.train import value_and_grad

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    counted, report = {}, {"card": card, "corners": {}}
    specs = {name: registry.get(name) for name in KERNELS}
    rows, timed, held = [], set(timed), dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(SEED + 17)

    def hold(label, run):
        """Every kernel call run() makes, against its plain version, bitwise.  A call at
        a shape no earlier timing saw is timed here by CUDA events around
        back-to-back calls of the kernel and of its plain version (the host's
        enqueue time where that exceeds the card's): profiling its ~100 new
        shapes as phase 3 does took phase 17 past its 90 s."""
        calls = record_calls(torch, registry, run)
        for name, cl in calls.items():
            for args, kw in cl:
                _, want = hold_call(torch, name, specs[name], args, kw, label)
                held[name] += 1
                sig = call_signature(torch, name, args, kw)
                if sig in timed:
                    continue
                timed.add(sig)
                nbytes, ops, peak = bound(name, args, kw, want)
                bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
                rows.append({
                    "kernel": name, "path": label,
                    "shapes": [list(a.shape) for a in args if torch.is_tensor(a)], "kw": kw,
                    "enqueue_ms": cuda_ms(torch, functools.partial(specs[name].cuda, *args, **kw),
                                          reps=20),
                    "plain_enqueue_ms": cuda_ms(torch, functools.partial(
                        specs[name].plain, *args, **kw), reps=3, warmup=1),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        return {n: len(c) for n, c in calls.items()}

    def serve(label, cfg, params, q, clouds):
        """counted_serve of `clouds` as full batches (max_wait_s 1 s): once in float;
        under SC through the preprocess cache cold, then all hits, then clouds[0]
        alone (one real row and BATCH - 1 filler rows)."""
        cached = q != "none"
        return counted_serve(torch, registry, counted, f"{label} serve", cfg, params,
                             ExecutionPolicy(quant=q), clouds, rounds=2 if cached else 1,
                             lone=cached, max_wait_s=1.0,
                             cache_max_bytes=(1 << 28) if cached else 0)[3]

    def train(label, cfg, q, batches):
        """Step 1 against the CPU on CORNER_CPU_ROWS clouds, its kernel calls held;
        the replayed steps against eager ones; step times, busy and idle."""
        accel = get_accelerator(cfg, ExecutionPolicy(quant=q), device=cuda)
        k = CORNER_CPU_ROWS[cfg.task]
        pts, labels = batches[0][0][:k], batches[0][1][:k]
        p, _ = fresh_state(torch, accel)
        hold(f"{label} train step 1 ({k} clouds)", lambda: value_and_grad(accel, p, pts, labels))
        del p
        out = step1_against_cpu(torch, accel, pts, labels, label)
        run = replay_against_eager(torch, registry, accel, batches, f"{label} replayed steps",
                                   counted)
        replay_ms = float(np.median(run["replay_ms"][1:]))
        prof = profile_run(torch, lambda: run["step"](*batches[1]), replay_ms, registry,
                           f"{label} replayed step")
        return {**out, "eager_step_ms": float(np.median(run["eager_ms"][1:])),
                "replay_step_ms": replay_ms, "busy_ms": prof["busy_ms"],
                "idle_share": prof["idle_share"], "losses": run["losses"]}

    def shard(label, cfg, params, q, batch):
        """sharded_forward in both modes over two shards of cuda:0, the SC forwards'
        kernel calls held; each mode's forward timed."""
        with graphs.eager():
            want = get_accelerator(cfg, ExecutionPolicy(quant=q), device=cuda).infer(
                params, batch)
        out = {}
        for mode in ("batch", "tensor"):
            tag = f"{label} {mode}-sharded"
            arts, entry = sharded_forward(torch, registry, counted, tag, cfg, params,
                                          ExecutionPolicy(quant=q, sharding=mode), (cuda, cuda),
                                          batch, want)
            if q != "none":
                hold(tag, lambda: arts.infer(params, batch))
            entry["sharded_eager_ms"] = median_ms(lambda: (arts.infer(params, batch),
                                                           torch.cuda.synchronize()))
            out[mode] = entry
        return out

    for m, base_cfg in cfgs.items():
        params = get_accelerator(base_cfg, device=cuda).init(torch.Generator().manual_seed(SEED))
        clouds = ragged_clouds(rng, *SERVE_TRAFFIC[m])
        batch = make_clouds(rng, BATCH, base_cfg.n_points)
        train_batches = []
        for i in range(CORNER_TRAIN_STEPS):
            pts, cls, seg = sample_batch(fold_in(SEED, 17_000 + i), BATCH, base_cfg.n_points,
                                         device=cuda)
            train_batches.append((pts, cls if m == "cls" else seg))
        for (pre, agg), quants in RUNTIME_CORNERS.items():
            cfg = dataclasses.replace(base_cfg, preproc=pre, aggregation=agg)
            for q in quants:
                label = f"{m} {pre}/{agg} quant={q}"
                t0 = time.perf_counter()
                with graphs.eager():
                    made = hold(f"{label} forward",
                                lambda: get_accelerator(cfg, ExecutionPolicy(quant=q),
                                                        device=cuda).infer(params, batch))
                if made != expected_launches(m, q, cfg):
                    fail(f"{label}: kernel calls {made}, expected {expected_launches(m, q, cfg)}")
                entry = {"serve": serve(label, cfg, params, q, clouds),
                         "train": train(label, cfg, q, train_batches),
                         "shard": shard(label, cfg, params, q, batch)}
                entry["seconds"] = time.perf_counter() - t0
                report["corners"][label] = entry
                s, t = entry["serve"], entry["train"]
                say(f"corners through the runtime, {label} ({entry['seconds']:.1f} s; {card}): "
                    f"served bitwise equal to eager infer, 0 captures after the warmup, "
                    f"{s['memory_after_warmup_mib']:.1f} MiB after the warmup; "
                    + "; ".join(
                        f"{r['tag']}: {r['requests']} requests in {r['batches']} batches "
                        f"({r['all_hit_batches']} all-hit), batch on the replica median "
                        f"{r['batch_ms_median']:.3f} ms, latency behind the queue filled "
                        f"before it p50 {r['p50_ms']:.2f} ms, max {r['max_ms']:.2f} ms"
                        for r in s["rounds"])
                    + f"; step 1 vs the CPU ({t['step1_clouds']} clouds, CPU "
                    f"{t['step1_cpu_s']:.1f} s): loss {t['step1_loss_card']:.6f} / "
                    f"{t['step1_loss_cpu']:.6f}, gradients within {t['grad_worst_rel']:.2e} of "
                    f"each leaf's max; {CORNER_TRAIN_STEPS} replayed steps bitwise equal to "
                    f"eager, step eager {t['eager_step_ms']:.3f} ms, replay "
                    f"{t['replay_step_ms']:.3f} ms, busy {t['busy_ms']:.3f} ms, idle "
                    f"{t['idle_share']:.3f}; sharded "
                    + ", ".join(f"{mode} "
                                + ("bitwise" if v["bitwise"] else "%.2e" % v["max_abs_diff"])
                                for mode, v in entry["shard"].items()))
        del params, train_batches
    report["kernel_calls_held"] = held
    report["kernel_calls"] = rows
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        if mine:
            say(f"corners through the runtime, {name}: {len(mine)} new shape(s) timed by CUDA "
                f"events, kernel {sum(r['enqueue_ms'] for r in mine):.4f} ms, plain "
                f"{sum(r['plain_enqueue_ms'] for r in mine):.4f} ms, bound "
                f"{sum(r['bound_ms'] for r in mine):.6f} ms")
    say(f"corners through the runtime: kernel calls held against their plain versions, "
        f"bitwise: {held}")
    report["phase_s"] = time.perf_counter() - t_phase
    return counted, report


def examples_phase(torch, registry, card: str) -> tuple[dict, dict]:
    """Phase 17 (b): each point-cloud example's main() at its full config on the card
    (EXAMPLE_RUNS), counted: its own check must pass (a failed check exits the
    run with code 1).  Returns each example's launches and its wall time."""
    import importlib.util

    counted, report = {}, {"card": card}
    for name, args in EXAMPLE_RUNS:
        path = os.path.join(ROOT, "examples", f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        registry.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted[f"example {name}"] = got = {n: registry.launches()[n] for n in KERNELS}
        if not any(got.values()):
            fail(f"example {name} launched none of the port's kernels")
        report[name] = {"args": args, "wall_s": wall, "launches": got}
        say(f"example torch_{name}.py {' '.join(args)}: its check passed in {wall:.2f} s "
            f"({card}); launches {got}")
    return counted, report


def main() -> None:
    """Run every phase; any failure exits non-zero before the last line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"src/repro_torch not found next to {os.path.basename(__file__)}")
    sys.path.insert(0, os.path.join(ROOT, "src"))

    from repro_torch.configs.pointnet2_cls import CONFIG as CLS_CONFIG
    from repro_torch.configs.pointnet2_seg import CONFIG as SEG_CONFIG
    from repro_torch.core import graphs
    from repro_torch.core.accelerator import clear_cache as clear_accelerators
    from repro_torch.core.accelerator import get_accelerator
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.fps import ops as _fps_ops  # noqa: F401  (registers)
    from repro_torch.kernels.knn3.ops import knn3
    from repro_torch.kernels.lattice.ops import lattice_query_fused
    from repro_torch.kernels.sc_matmul import ops as _sc_ops  # noqa: F401

    for mod in sys.modules:
        if mod == "jax" or mod.startswith(("jax.", "repro.")) or mod == "repro":
            fail(f"{mod} was imported; the port must not import jax or the JAX package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(card)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    say(f"built {len(libs)} kernel libraries with {build.nvcc_path()} "
        f"({' '.join(build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, path in libs.items():
        say(f"  {name}: {os.path.relpath(path, ROOT)}")
        ptxas[name] = build.ptxas_report(build.build_log(name))
        for e in ptxas[name]:
            say(f"    {e['kernel']}: {e['registers']} registers, {e['smem_bytes']} bytes static "
                f"smem, {e['stack_bytes']} bytes stack, spill stores/loads "
                f"{e['spill_stores']}/{e['spill_loads']} bytes")
    say(json.dumps({"ptxas": ptxas}))

    rng = np.random.default_rng(SEED)
    configs = {"cls": CLS_CONFIG, "seg": SEG_CONFIG}
    batches = {m: [make_clouds(rng, BATCH, cfg.n_points) for _ in range(N_BATCHES[m])]
               for m, cfg in configs.items()}
    flat_sets = []
    for p, m, radius, ns in FLAT_SETS:
        cloud = make_clouds(rng, 1, p)[0]
        cents = cloud[np.sort(rng.choice(p, m, replace=False))]
        flat_sets.append((torch.from_numpy(cloud).cuda(), torch.from_numpy(cents).cuda(),
                          radius, ns))

    def flat_path():
        return [lattice_query_fused(pts, cents, radius, ns) for pts, cents, radius, ns in flat_sets]

    sc = ExecutionPolicy(quant="sc_w16a16")
    policies = {"none": ExecutionPolicy(quant="none"), "sc_w16a16": sc}
    accels = {(m, q): get_accelerator(cfg, pol, device="cuda")
              for m, cfg in configs.items() for q, pol in policies.items()}
    params = {m: accels[m, "sc_w16a16"].init(torch.Generator().manual_seed(SEED))
              for m in configs}

    # -- 3. kernels against their plain versions, at main-path shapes --------
    specs = {name: registry.get(name) for name in KERNELS}
    with graphs.eager():
        recorded = {
            m: record_calls(torch, registry, functools.partial(
                accels[m, "sc_w16a16"].infer, params[m], batches[m][0]))
            for m in configs
        }
        recorded["flat"] = record_calls(torch, registry, flat_path)
    for path, calls in recorded.items():
        say(f"kernel calls of one {path} run"
            f"{' (sc_w16a16 forward)' if path != 'flat' else ''}: "
            + ", ".join(f"{n}={len(c)}" for n, c in calls.items()))

    per_call = []
    summary = {}
    for name, spec in specs.items():
        if not any(calls[name] for calls in recorded.values()):
            fail(f"no path made a {name} call")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0, "library_ms": 0.0 if name == "sc_matmul" else None,
               "max_abs_err": 0.0, "by_path": {}}
        for path, calls in recorded.items():
            if not calls[name]:
                continue
            part = {"calls": len(calls[name]), "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0 if name == "sc_matmul" else None}
            for args, kw in calls[name]:
                err, want = hold_call(torch, name, spec, args, kw, path)
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                row = time_call(torch, name, spec, args, kw, want, path)
                if name == "sc_matmul":
                    part["library_ms"] += row["library_ms"]
                    tot["library_ms"] += row["library_ms"]
                per_call.append(row)
                for acc in (tot, part):
                    acc["ms"] += row["ms"]
                    acc["plain_ms"] += row["plain_ms"]
                    acc["bound_ms"] += row["bound_ms"]
                tot["bytes_ms"] += row["bytes_ms"]
                tot["ops_ms"] += row["ops_ms"]
            tot["by_path"][path] = part
            say(f"{name} ({path}): {part['calls']} calls, kernel == plain version bitwise; "
                f"device time: kernel {part['ms']:.4f} ms, plain {part['plain_ms']:.4f} ms, "
                f"bound {part['bound_ms']:.6f} ms")
        summary[name] = tot
    # SC W8A8 on the main paths: every SC call of one eager forward of each
    # model against its plain version (its launches and logits: phases 4-5)
    w8 = ExecutionPolicy(quant="sc_w8a8")
    w8_accels = {m: get_accelerator(cfg, w8, device="cuda") for m, cfg in configs.items()}
    for m, accel in w8_accels.items():
        with graphs.eager():
            calls = record_calls(torch, registry, functools.partial(
                accel.infer, params[m], batches[m][0]))
        made = {n: len(c) for n, c in calls.items()}
        if made != expected_launches(m, "sc_w8a8", configs[m]):
            fail(f"{m} quant=sc_w8a8: kernel calls {made}, expected "
                 f"{expected_launches(m, 'sc_w8a8', configs[m])}")
        worst = 0.0
        for args, kw in calls["sc_matmul"]:
            worst = max(worst, hold_call(torch, "sc_matmul", specs["sc_matmul"], args, kw,
                                         f"{m} sc_w8a8")[0])
        summary["sc_matmul"]["max_abs_err"] = max(summary["sc_matmul"]["max_abs_err"], worst)
        summary["sc_matmul"]["by_path"][f"{m} sc_w8a8"] = {"calls": len(calls["sc_matmul"]),
                                                         "max_abs_err": worst}
        say(f"sc_matmul ({m} sc_w8a8 forward): {len(calls['sc_matmul'])} calls, kernel == plain "
            "version bitwise")
        del calls
    say(json.dumps({"kernel_calls": per_call}))

    # -- 4. the paths, counted -------------------------------------------------
    launches = dict.fromkeys(KERNELS, 0)
    counted = {}

    def counted_run(label: str, run, want: dict[str, int]):
        """Run with every counter at 0 just before; check the counts read just after."""
        registry.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = {n: registry.launches()[n] for n in KERNELS}
        counted[label] = got
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        for n in KERNELS:
            launches[n] += got[n]
        return out

    outputs = {}
    for (m, q), accel in accels.items():
        want_one = expected_launches(m, q, configs[m])
        outputs[m, q] = [
            counted_run(f"{m} quant={q} batch {i}", functools.partial(accel.infer, params[m], b),
                        want_one)
            for i, b in enumerate(batches[m])
        ]
    for m, accel in w8_accels.items():
        outputs[m, "sc_w8a8"] = [counted_run(
            f"{m} quant=sc_w8a8 batch 0", functools.partial(accel.infer, params[m], batches[m][0]),
            expected_launches(m, "sc_w8a8", configs[m]))]
    flat_out = counted_run("flat", flat_path, expected_launches("flat", "none"))
    say(f"main path launches: {json.dumps(counted)}")
    for name in KERNELS:
        if launches[name] == 0:
            fail(f"{name} was never launched on the paths")

    forward_ms = {}
    for (m, q), accel in accels.items():
        times = []
        for i in range(TIMED_FORWARDS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accel.infer(params[m], batches[m][i % N_BATCHES[m]])
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        forward_ms.setdefault(m, {"batch": BATCH, "n_points": configs[m].n_points})[q] = {
            "median_ms": float(np.median(times)), "min_ms": float(np.min(times)),
            "max_ms": float(np.max(times)), "runs": len(times)}
    say(json.dumps({"forward_per_batch": forward_ms}))
    say(json.dumps({"forward_profile": {
        m: {q: profile_forward(torch, accels[m, q], params[m], batches[m][0],
                               forward_ms[m][q]["median_ms"], registry, f"{m} quant={q} forward")
            for q in policies}
        for m in configs
    }}))

    # -- 5. against the port's own CPU run -------------------------------------
    for m, cfg in configs.items():
        params_cpu = accels[m, "sc_w16a16"].init(torch.Generator().manual_seed(SEED)).to("cpu")
        checked = batches[m] if m == "cls" else batches[m][:1]  # one seg batch: the CPU is slow
        for q, pol in policies.items():
            accel_cpu = get_accelerator(cfg, pol, device="cpu")
            shape = (BATCH, cfg.n_classes) if cfg.task == "cls" else (
                BATCH, cfg.n_points, cfg.n_classes)
            worst = 0.0
            for b, got in zip(checked, outputs[m, q]):
                pre_gpu = accels[m, q].preprocess_stage(b)
                pre_cpu = accel_cpu.preprocess_stage(b)
                for stage, (rg, rc) in enumerate(zip(pre_gpu, pre_cpu)):
                    for field in ("centroid_idx", "centroid_xyz"):
                        if not torch.equal(getattr(rg, field).cpu(), getattr(rc, field)):
                            fail(f"{m} quant={q} stage {stage}: {field} differs from the CPU run")
                    if not (torch.equal(rg.neighbors.idx.cpu(), rc.neighbors.idx)
                            and torch.equal(rg.neighbors.mask.cpu(), rc.neighbors.mask)):
                        fail(f"{m} quant={q} stage {stage}: neighbours differ from the CPU run")
                if cfg.task == "seg":  # each FP stage's 3-NN: a level among the next coarser
                    levels_gpu = [torch.from_numpy(b).cuda()] + [r.centroid_xyz for r in pre_gpu]
                    levels_cpu = [torch.from_numpy(b)] + [r.centroid_xyz for r in pre_cpu]
                    for i in range(len(pre_gpu)):
                        kg = knn3(levels_gpu[i], levels_gpu[i + 1])
                        kc = knn3(levels_cpu[i], levels_cpu[i + 1])
                        if not all(torch.equal(g.cpu(), c) for g, c in zip(kg, kc)):
                            fail(f"{m} quant={q}: 3-NN of level {i} differs from the CPU run")
                want = accel_cpu.infer(params_cpu, b)
                got = got.cpu()
                if tuple(got.shape) != shape or not torch.isfinite(got).all():
                    fail(f"{m} quant={q}: logits of shape {tuple(got.shape)}, "
                         f"finite={bool(torch.isfinite(got).all())}")
                worst = max(worst, (got - want).abs().max().item())
            if worst > LOGIT_ATOL[q]:
                fail(f"{m} quant={q}: logits differ from the CPU run by {worst} > {LOGIT_ATOL[q]}")
            extra = ", FP 3-NN indices" if cfg.task == "seg" else ""
            say(f"{m} quant={q}: preprocessing{extra} equal the CPU run bitwise over "
                f"{len(checked)} batch(es); max |logit diff| {worst:.3e} <= {LOGIT_ATOL[q]}")
        # SC W8A8: one batch
        got = outputs[m, "sc_w8a8"][0].cpu()
        want = get_accelerator(cfg, w8, device="cpu").infer(params_cpu, batches[m][0])
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{m} quant=sc_w8a8: logits of shape {tuple(got.shape)}, "
                 f"finite={bool(torch.isfinite(got).all())}")
        worst = (got - want).abs().max().item()
        if worst > LOGIT_ATOL["sc_w8a8"]:
            fail(f"{m} quant=sc_w8a8: logits differ from the CPU run by {worst} > "
                 f"{LOGIT_ATOL['sc_w8a8']}")
        say(f"{m} quant=sc_w8a8: max |logit diff| {worst:.3e} <= {LOGIT_ATOL['sc_w8a8']} "
            "over 1 batch")
    for (pts, cents, radius, ns), got in zip(flat_sets, flat_out):
        want = lattice_query_fused(pts.cpu(), cents.cpu(), radius, ns)
        if not (torch.equal(got.idx.cpu(), want.idx) and torch.equal(got.mask.cpu(), want.mask)):
            fail(f"flat lattice query at P={pts.shape[0]}, M={cents.shape[0]} differs from the "
                 "CPU run")
    say("flat: lattice_query_fused equals the CPU run bitwise at "
        + ", ".join(f"P={p} M={m}" for p, m, _, _ in FLAT_SETS))

    # -- 6. the graphs ------------------------------------------------------------
    graph_counted, graph_report = graph_phase(
        torch, accels, configs, params, batches, flat_sets, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in graph_counted.values())
    say(json.dumps({"graphs": graph_report, "graph_launches": graph_counted}))

    # -- 7. the serving path --------------------------------------------------
    serve_counted, serve_report = serving_phase(
        torch, configs, params, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in serve_counted.values())
    say(json.dumps({"serving": serve_report, "serving_launches": serve_counted}))

    # -- 8. the serving control plane -------------------------------------------
    control_counted, control_report = control_plane_phase(torch, configs, params, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in control_counted.values())
    say(json.dumps({"control_plane": control_report, "control_launches": control_counted}))

    # -- 9. training ------------------------------------------------------------------
    train_counted, train_report = training_phase(torch, configs, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in train_counted.values())
    say(json.dumps({"training": train_report, "training_launches": train_counted}))

    # -- 10. multi-device: sharded artifacts, sharded serving, pipeline_forward -----
    shard_counted, shard_report = sharding_phase(torch, configs, params, batches, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in shard_counted.values())
    say(json.dumps({"sharding": shard_report, "sharding_launches": shard_counted}))

    # -- 11. the paper's comparison paths -----------------------------------------
    comparison_counted, comparison_report = comparison_phase(
        torch, configs, params, batches, registry, card,
        {call_signature(torch, name, args, kw)
         for calls in recorded.values() for name, cl in calls.items() for args, kw in cl})
    for n in KERNELS:
        launches[n] += sum(c[n] for c in comparison_counted.values())
    say(json.dumps({"comparison": comparison_report, "comparison_launches": comparison_counted}))

    # The point-cloud phases are done.  Their params and accelerators go, and with
    # them every graph captured over them: the LM phases need the card's memory
    # (gemma3's training peaks at ~62 GiB).
    timed = {call_signature(torch, name, args, kw)
             for calls in recorded.values() for name, cl in calls.items() for args, kw in cl}
    del params, accels, w8_accels, outputs, flat_out, flat_sets, recorded
    clear_accelerators()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"memory before the LM phases: {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved")

    # -- 12. dense LM serving ---------------------------------------------------------
    lm_counted, lm_report = lm_phase(torch, registry, card, timed)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in lm_counted.values())
    lm_rows = lm_report["kernel_calls"]
    summary["sc_matmul"]["by_path"]["lm"] = {
        "calls": len(lm_rows), **{k: sum(r[k] for r in lm_rows)
                                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    say(json.dumps({"lm": lm_report, "lm_launches": lm_counted}))

    # -- 13. dense LM training ----------------------------------------------------------
    lm_train_counted, lm_train_report = lm_train_phase(torch, registry, card, timed)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in lm_train_counted.values())
    train_rows = lm_train_report["kernel_calls"]
    summary["sc_matmul"]["by_path"]["lm_train"] = {
        "calls": len(train_rows), **{k: sum(r[k] for r in train_rows)
                                     for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    say(json.dumps({"lm_train": lm_train_report, "lm_train_launches": lm_train_counted}))

    # -- 14. the moe, ssm and hybrid LM families ------------------------------------------
    fam_counted, fam_report = lm_families_phase(torch, registry, card, timed)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in fam_counted.values())
    fam_rows = fam_report["kernel_calls"]
    summary["sc_matmul"]["by_path"]["lm_families"] = {
        "calls": len(fam_rows), **{k: sum(r[k] for r in fam_rows)
                                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    say(json.dumps({"lm_families": fam_report, "lm_families_launches": fam_counted}))

    # -- 15. the encdec and vlm LM families -----------------------------------------------
    ev_counted, ev_report = lm_encdec_vlm_phase(torch, registry, card, timed)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in ev_counted.values())
    ev_rows = ev_report["kernel_calls"]
    summary["sc_matmul"]["by_path"]["lm_encdec_vlm"] = {
        "calls": len(ev_rows), **{k: sum(r[k] for r in ev_rows)
                                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    say(json.dumps({"lm_encdec_vlm": ev_report, "lm_encdec_vlm_launches": ev_counted}))

    # -- 16. the LM's device layout, the op counter and the dry run ------------------------
    mesh_counted, mesh_report = lm_mesh_phase(torch, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in mesh_counted.values())
    say(json.dumps({"lm_mesh": mesh_report, "lm_mesh_launches": mesh_counted}))

    # -- 17. the comparison corners through the runtime, and the examples ---------------
    t17 = time.perf_counter()
    corner_counted, corner_report = corner_runtime_phase(torch, configs, registry, card, timed)
    example_counted, example_report = examples_phase(torch, registry, card)
    for n in KERNELS:
        launches[n] += sum(c[n] for c in corner_counted.values())
        launches[n] += sum(c[n] for c in example_counted.values())
    phase17_s = time.perf_counter() - t17
    say(f"phase 17: {phase17_s:.1f} s ({card})")
    say(json.dumps({"phase17": {"seconds": phase17_s, "corners": corner_report,
                                "examples": example_report},
                    "phase17_launches": {**corner_counted, **example_counted}}))

    kernels = []
    for name, meta in KERNELS.items():
        tot = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"], "by_path": tot["by_path"],
        })
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
