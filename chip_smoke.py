#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (airpose_tpu_torch).

  python3 chip_smoke.py        # from the repository root, on one CUDA device

Phases, each of which exits non-zero on failure:
  1. build every kernel under airpose_tpu_torch/csrc/ with nvcc for sm_90a;
  2. skinning kernel vs its plain version at the main path's shapes
     (B = 128 bodies, V = 10475, J = 55) and at the training batch B = 60,
     with its registers and occupancy, and timings beside two library
     yardsticks (lbs.py's einsum pair; cuBLAS's SGEMM of T's used rows);
  3. fused layer1 kernel vs its plain version at (128, 56, 56, 64) bf16,
     BN statistics perturbed from a seed, with timings;
  4. the bf16 perception chain at B = 64 frames (128 crops of 224²), full
     synthetic SMPL-X: both kernels must launch, outputs must be finite
     and agree with the same chain through the plain versions (the
     benchmark's perceive_bf16_b64 times this chain);
  5. the int8 conv kernel vs its plain version, exact, in every epilogue
     mode (the static trunk's requant at the next conv's scale, int8 alone
     and bf16 + int8, among them) at layer1's 3×3 (128, 56, 56, 64) and
     layer2_0's 3×3/2 (128, 56, 56, 128); then the 52 convs of the int8
     trunk at 128 crops, as the trunk makes them, replayed through the
     kernel, the plain version and torch._int_mm; the int8 trunk's fused
     stem kernel (csrc/int8_stem.cu: conv, max-pool, bias, relu) at 1, 60
     and 128 crops of 224²: within one bf16 step of the map of its plain
     version (cuDNN) and of the fixed-order conv, differing on at most
     STEM_STEP_SHARE of the outputs, crops 0, 59 and 127 bit-equal alone
     and in the 60- and 128-crop calls, timed beside cuDNN's conv alone and
     the composed library route;
  6. the 13 int8 blocks of layers 2-4 chained at 128 crops of 224²: each
     within 1 int8 step on < 0.5% of elements of its plain version, with
     kernel, plain, torch._int_mm and bound times;
  7. the int8 chain and the int8-block chain at B = 64: the int8 conv
     kernel and skinning must launch, the int8 chain must quantize in torch
     once (the stem's output), outputs must be finite, each trunk's
     features must equal those of its plain version and each chain agree
     with its plain chain, the features must correlate > 0.9 with the bf16
     trunk's (the benchmark's perceive_int8_b64 times the int8 chain);
  8. the training step of record (make_twoview_step_fns, TrainConfig()
     defaults: AMSGrad at lr 5e-5, 3 IEF steps, dropout) on the bf16
     AirPoseTwoView at B = 30 frames of 224² from make_synthetic_dataset,
     full synthetic SMPL-X: the skinning Function's backward against
     autograd through the plain version at B = 60 bodies, with its times
     and bound; one step's loss and gradients with the skinning kernel
     against the same step with the plain version (same dropout masks),
     with an f32 and with the bf16 trunk, each beside the kernel step
     against itself; 25 steps on one batch of one step object, the first
     eager, the second captured as a CUDA graph and the rest replayed
     (eager_steps 1, graph_replays 24), skinning launched at the first two
     only (the host counts nothing at a replay), with the loss finite and
     falling; one eval_step; then ms per step, replayed and eager (a fresh
     step object's first call), frames/s, the forward / backward /
     forward_backward / optimizer split of each from CUDA events around
     loop.py's own spans and the replayed step's idle share from
     torch.profiler;
  9. the other model families on the same B = 30 batch: twoview_eval_metrics
     of phase 8's eval_step predictions with the skinning kernel against the
     plain version; for hmr, copenet_singleview and muhmr
     (make_singleview_step_fns) and copenet_twoview_sep
     (make_twoview_step_fns), each with its bf16 trunk, one step with the
     kernel against one with the plain skinning, then 10 steps (eager,
     capture, replays) launching skinning at the first two, with the loss
     finite and falling, and ms per replayed step; the per-drone model behind Int8Inference (104 int8 conv launches,
     each trunk's features equal to its plain version's), and its staged
     serving (AirPoseTwoViewSepView.regress_step, 3 rounds a view) against
     its fused forward;
 10. the trainer CLI and what it runs, fixtures under a temporary directory
     removed afterwards: airpose_tpu_torch.train.trainer.main in-process on
     copenet_twoview, synthetic://64 (51 train, 13 val) at full width (a
     10,475-vertex SMPLX_NEUTRAL.npz written from synthetic_smplx_params()),
     B = 30 of 224², 20 steps, val every 10: checkpoints and metrics written,
     the logged loss finite and falling, the summary grid rendered,
     skinning launched at the eager and the captured train step (60
     bodies; none at the 18 replays), once a val batch (26) and once a
     summary grid (2), counted in the call each launch ran in,
     and nothing else of the kernels; then `python -m
     airpose_tpu_torch.train.trainer` as two subprocesses at once, one
     resuming at step 20 and ending at 30, one resuming in a copy of the
     run's directory with --time_to_run 0 and exiting 3 after saving last
     at step 21; finish_batch on the card against the CPU at B = 30 of 672²
     context (context_scale 1 and 2), and a 4-worker Prefetcher's batches
     against the main thread's; an AerialPeople fixture of 300 records:
     precompute_canonical_gt with the kernel (2 launches: 256 + 44) against
     the plain skinning, then host_batch(decode_images=False) →
     finish_batch → one make_twoview_step_fns step; the CLI's last.ckpt
     loaded with strict=True, its eval forward equal to the in-memory
     model's;
 11. the real-data self-supervised fine-tune on a synthetic DJI capture of
     48 train and 30 test frames of 1920×1080 JPEGs a machine (written by
     airpose_tpu_torch.data.fake_real under phase 10's temporary
     directory), with the random VPoser prior of seed 0 at its published
     widths: VPoser encode/decode at 60 bodies on the card against the CPU;
     CopenetRealDataset.host_batch → finish_batch at B = 30 on the card
     against the CPU, with the host's decode time; one
     make_real_twoview_step_fns step (bf16 AirPoseTwoView) with the
     skinning kernel against one with the plain skinning (a determinism
     check: the real losses read no skinned vertex, so the two steps are
     equal bit for bit), then 10 steps on one batch skinning 60 bodies at
     the eager and the captured step, with the loss finite and falling, ms a step, and
     eval_step's predictions skinned with the kernel against the plain
     version (the kernel's agreement on this path); the
     hmr_camswap_difffl step on each view, kernel step against plain step,
     then 10 steps alternating views 0/1 skinning 30 bodies at each view's
     eager and captured step, its
     eval vertices kernel against plain, and 6 steps timed from a fresh
     model with their losses finite; the per-drone model's real step, kernel step against plain
     step; trainer.main in-process on real:// (copenet_twoview,
     B = 30 of 224², 10 steps, val at 10): skinning at the eager and the
     captured train step (60 bodies), once in the val batch (60) and once in the summary grid (2),
     counted in the call each ran in, checkpoints written and the grid
     rendered, the CLI step beside phase 8's; then a 2-step
     --pretrained_checkpoint (phase 10's last.ckpt) --train_reg_only run:
     the trunk bit-equal to the pretrained one, the heads moved;
 12. the eval CLI and AirPose+, in phase 10's temporary directory (its
     10,475-vertex npz, last.ckpt and AerialPeople fixture, whose windows are
     written as JPEGs here; phase 11's capture), the f32 trunk the eval CLI
     builds: (a) each compile pass of airpose_tpu_torch.eval.compile_results
     at B = 30 of 224² (compile_twoview --save-full and --int8 on the 300
     records, compile_singleview hmr on synthetic://64,
     compile_real_twoview --save-full and compile_real_singleview per camera
     on the 30 test frames at B = 16, a padded tail) with the skinning
     kernel and again with the plain skinning: skinning launches by bodies
     and int8 conv launches against the lists the code gives, the body
     fields within EVAL_BODY_REL, the metrics within EVAL_METRIC_REL, the
     --int8 trunk's features equal to the plain int8 trunk's, seconds and
     frames/s; (b) AirPose+ (BAConfig(): 100 + 200 Adam iterations) on a
     2,000-frame chunk of bodies decoded from the random VPoser prior: the
     trace finite and falling below half its start, no skinning in the
     joints-only inner loop, each stage's ms an iteration with its device
     work, the export of 2,000 bodies with the kernel against the plain
     skinning and its ms, skinning at B = 2,000 as in phase 2, the card's
     trace against the CPU's on 24 frames; (c) `python -m
     airpose_tpu_torch.eval.compile_results` on real:// as a subprocess,
     AirPose+ on its pkl through the bundle_adjust CLI's code, chunked
     across a chunk boundary and --sharded, and the figures' metric table
     (the plots, without matplotlib on the card machine, are left out),
     every output's shapes checked;
 13. two-drone serving (airpose_tpu_torch.serve) in phase 10's temporary
     directory, on phase 11's 30 test frames at 224² through real_batches,
     serving phase 10's last.ckpt (seed 0 without it): (a) StagedRegressor's
     3 rounds, one crop a call, with same-frame peer messages through the
     wire against the fused forward (f32 copenet_twoview, seed-0
     copenet_twoview_sep by sep_view), and with the int8 trunk against
     Int8Inference's trunk on the same scales at the served 1 crop a call and
     the fused IEF (features equal), each round a CUDA graph replay against
     the same rounds run eagerly (int8 features equal, wire floats within
     GRAPH_WIRE_ATOL), the int8 conv's host counter advancing only at the
     eager step-1 call (its calibration, clip report and step) and at the
     capture, 4 × 52, and graph_replays counting every later round; (b) the 52 int8
     convs of one step-1 call at 1 crop exact against the plain version,
     skinning at B = 1, each timed, and each round's wall time and device
     work; (c) run_benchtest, two in-process servers over localhost TCP, f32
     and --int8, with the served rate and the launches; (d) --rate-procs, two
     `python -m airpose_tpu_torch.serve.server` processes on the card; (e) the
     unchanged native C++ client (cmake, else g++) in fake mode at --fps 4
     against two port servers, then the ROI replay of the capture's full
     frames; (f) lag_one_report on a static scene and on the capture; (g) the
     viz CLI on the clients' dumped step-3 results with the 10,475-vertex
     body, 1 skinning launch a message, the vertices against the plain
     skinning's.
 14. the reference workflow's tools (airpose_tpu_torch.tools) in a temporary
     directory of its own: (a) create_aerialpeople at its defaults (4 subjects
     × 5 poses) on the 10,475-vertex body, one skinning launch a pose, its
     SMPL-X fields against the same run with the plain skinning, and the
     capture and TotalCapture db writers; (b) dress_rehearsal.run in process
     at 224² and 10,475 vertices (the JAX defaults otherwise: 48 fine-tune
     steps, stage 7's assert armed), each stage's seconds and its skinning
     and int8 conv launches against the counts the code gives, then the
     module's entry point as a subprocess at tests/test_dress_rehearsal.py's
     sizes, its stage seconds read from its [k/10] lines as they arrive
     (without matplotlib and h5py, the card machine's case, stage 8 leaves
     the plot out and stage 10 is left out, each with a printed reason); (c)
     train_roofline at B = 30 of 224², its eight stages through its entry
     point, then each with its device busy ms, idle share (utils/profiling's
     trace) and peak memory, and the full step and the trunk with --remat,
     beside phase 8's step; (d) qat_posture at B = 30 of 224², two batches
     and a held-out one, 2 + 2 steps, its five arms finite under the
     deployed int8 trunk (the int8 conv kernel), launches as the code gives
     them; (e) calibration and prepare_real_capture on generated chessboard
     and ArUco frames (to_hdf5 only where h5py is); and a gate on the int8
     trunk's stem kernel: crop 0's stem map and int8 features bit-equal
     alone and as the first of 60 crops, and each of the 60 crops' features
     alone equal to the 60-crop folded batch's (cuDNN's stem logged beside).
 15. multi-device at world size 1, in process, in phase 10's temporary
     directory: entry.dryrun_multichip(1) (its own NCCL group of one: one
     two-view train step, then the frame-sharded AirPose+); on an NCCL group
     of one, parallel.global_batch_norm against the local BatchNorm
     (forward, input gradient, running statistics), one data-parallel train
     step (bf16, B = 30 of 224²) against the one-process step,
     compile_results --mesh 1 --int8 --save-full on phase 12's AerialPeople
     records with phase 10's last.ckpt against the CLI without --mesh, and
     bundle_adjust_sharded over 2,000 frames against bundle_adjust; then
     utils.cluster's local backend requeueing a 2-step trainer job through
     one exit 3, and parity_run on a fixture bundle made from phase 10's
     last.ckpt; each sub-phase's kernel launches counted.
 16. HMR 2.0 (models/hmr2.py, perception.perceive_hmr2) at its published
     widths: the skinning kernel at SMPL's J = 24, V = 6,890 (B = 128)
     against its plain version, timed; the fused add + LayerNorm + cast
     (ops/add_layernorm.py) at 128 crops of 192 tokens of 1,280, and its
     LayerScale kernel (x += γ · branch) at Multi-HMR's 16 frames of 4,097
     tokens of 1,024, each against its plain version (x bit-equal, the bf16
     rows within one step), timed beside its bound, the plain ops and
     F.layer_norm alone; the attention guard (an input no fast backend
     takes raises under models/vit.attention, and the chain's attention
     kernels are the flash or memory-efficient ones); then the chain on 64 two-view frames of 256²
     from the benchmark's weights maker and inputs: 44 attention calls, 65
     add_layernorm launches and 1 skinning launch a call, the tokens and the
     tail against benchmark/reference/hmr2.py by the limits of the cell
     perceive_hmr2_vith_b64, and two_view_fps from CUDA events, with the norm
     points as the kernel and as the plain three ops; then Multi-HMR
     (perception.perceive_multihmr) at its published sizes on one two-view
     896² frame: 49 add_layernorm launches a call, counted from zero.
     ``python3 chip_smoke.py --only hmr2`` builds the kernels and runs this
     phase alone.
Prints the kernels as one JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is available.
"""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import shutil
import tempfile
import threading
import time
from functools import partial
from unittest import mock

import numpy as np
import torch

# The bounds below divide by the published H100 SXM peaks at 700 W, kept in the benchmark.
from benchmark.roofline.peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES, INT8_OPS

SKIN_ATOL = 2e-5            # tests/test_pallas_lbs.py's bound for the TPU kernel
STAGE_TOL = 0.05            # atol = rtol, tests/test_fused_bottleneck.py's bound
# Kernel and plain chains differ only in f32 summation order inside layer1
# and skinning; that flips some bf16 roundings, which 13 random-weight bf16
# blocks and the IEF amplify. Bound on rel-L2 of verts and j2d between the
# two chains: on the CPU, changing only layer1's accumulation (f64 for f32)
# flipped 1.4% of its bf16 outputs by one ulp and moved verts by 0.9% and
# j2d by 0.16% rel-L2 at B = 2; the bound leaves 5× that.
CHAIN_REL_L2 = 5e-2
# The int8 trunks equal their plain versions bit for bit (the conv kernel is
# exact), so their chains differ only in skinning's f32 summation order:
# measured rel-L2 4.8e-8 (verts) and 4e-9 (j2d) on the H100.
INT8_CHAIN_REL_L2 = 1e-5
# The fused stem kernel against its plain version (cuDNN's bf16 conv, pool,
# bias, relu) and against the fixed-order conv with the same pool, bias and
# relu: the convs sum 147 exact products in f32 in other orders (the tensor
# cores in their own) and round once, so a map value can lie one bf16 step
# apart (1e-6 more where a sum cancels towards 0), and the output then lies
# within int8_stem.one_step_range of the other's pre-bias pooled value. On
# the CPU, XLA's and torch's stems differ so on 3.7e-5 to 7.0e-5 of the map
# (tests/test_torch_int8.py); bound: at most 1e-3 of the outputs differ.
STEM_STEP_SHARE = 1e-3
STEM_CROPS = (1, 60, 128)
# global_batch_norm (f64 statistics, f32 normalisation) against torch's
# BatchNorm kernels (f32 statistics) on a bf16 map: the bf16 output rounds at
# most one step (2^-8 relative) apart where the two f32 values straddle a
# rounding boundary; bound on rel-L2 of y and dx and on the running stats.
GLOBAL_BN_REL = 1e-2   # a served step 1, compile_results --int8 at B = 30, the chain
# int8 block outputs: the JAX package's bound for its Pallas block
# (tests/test_int8_bottleneck.py): ≤ 1 step on < 0.5% of elements.
BLOCK_MAX_STEP, BLOCK_FRAC = 1.0, 5e-3
FEATURE_CORR = 0.9          # int8 vs bf16 trunk features, tests/test_int8_trunk.py
# Skinning's backward against autograd through the plain version: both are
# f32 sums over V = 10475 (dA) or J = 55 (dp) in other orders; bound on the
# max |difference| over max |reference| of each gradient.
SKIN_GRAD_REL = 1e-5
# One train step with the skinning kernel against the same step with the
# plain version: the same weights, batch and dropout masks, so only
# skinning's f32 summation order differs (its backward's dA and dp are
# ~1e-7 relative apart). Measured on the H100 with either trunk: the loss
# equal, the regressor gradients 1.3e-9 rel-L2 apart; bounds 1e-6 (~10 f32
# ulps of the loss, ~1e3 times the measurement). The trunk's backward
# amplifies small differences: with an f32 trunk the step is not
# deterministic (its convolutions' backward, presumably) and its trunk
# gradients differ by up to 4.9e-5 rel-L2 from run to run, by up to 5.2e-5
# against the plain step; bound 1e-3, 20 times that floor, where a wrong
# gradient gives O(1).
# The bf16 step equals itself bit for bit, and its trunk gradients differ
# from the plain step's by 2.08e-2 in every call: skinning's ~1e-7
# differences flip roundings of the bf16 backward, each a 2^-8 relative
# step, which the trunk amplifies; bound 5e-2, 2.4 times the measurement.
# The bf16 step's trunk gradients against the f32 step's on the same weights,
# batch and dropout masks measure bf16's own error in that backward; the
# kernel step's trunk gradients must lie closer than that to the plain
# step's (the bound of the "trunk" entry, taken in the run itself).
TRAIN_F32_BOUNDS = {"loss": 1e-6, "regressor": 1e-6, "trunk": 1e-3}
TRAIN_BF16_BOUNDS = {"loss": 1e-6, "regressor": 1e-6}
TRAIN_STEPS = 25
# Phase 9. Kernel step against plain step per family, on the bf16 trunk.
# Measured on the H100: each family's bf16 step equals itself bit for bit;
# against the plain step the loss is equal, the regressor gradients are
# 1.8e-9 (copenet_twoview_sep) to 6.0e-8 (hmr) rel-L2 apart, bound 1e-6 as
# in phase 8; the trunk gradients 1.78e-2 (hmr), 2.02e-2
# (copenet_singleview), 2.22e-2 (muhmr, copenet_twoview_sep) apart, as
# phase 8's bf16 step (flipped bf16 roundings in the trunk's backward);
# bound 5e-2, 2.25 times the largest.
FAMILY_BOUNDS = {family: {"loss": 1e-6, "regressor": 1e-6, "trunk": 5e-2}
                 for family in ("hmr", "copenet_singleview", "muhmr", "copenet_twoview_sep")}
FAMILY_STEPS = 10
# The six eval metrics with the kernel against the plain skinning: f32 sums
# in another order over 10,475 vertices, ~1e-7 relative.
EVAL_REL = 1e-5
# _sep int8 IEF on bit-equal features: only the f32 regressor's order.
INT8_SEP_REL_L2 = 1e-5
# staged _sep vs fused: the same trunks and cores on the same inputs.
STAGED_ATOL = 1e-5
# Phase 10. finish_batch on the card against the CPU: images within 1e-5
# (tests/test_torch_data.py's bound against JAX's resample), the bb and the
# crop-frame keypoints within 1e-6 relative (f32 elementwise, exact in
# exact arithmetic; only the resample's sums differ in order).
PIPE_IMG_ATOL, PIPE_GEOM_REL = 1e-5, 1e-6
# The readers' canonical GT with the skinning kernel against the plain
# skinning: f32 sums over 55 joints in another order.
CANON_REL = 1e-5
CLI_STEPS, CLI_VAL_EVERY, CLI_SAMPLES = 20, 10, 64
CLI_BATCH, CLI_IMG = 30, 224   # the trainer's defaults: B = 30 frames of 224²
AERIAL_RECORDS = 300  # one chunk of 256 bodies and a tail of 44
# Phase 11. VPoser on the card against the CPU, bound on max |diff| over
# max |CPU| of each output: the encoder's f32 dense layers of width 512 (TF32
# off) summed in other orders, measured 6.0e-7 on the H100, bound 1e-5; the
# decoder's rotations pass Gram-Schmidt, which divides by the residual of the
# second 6D column, small for some of the 1,260 random-weight joints: the
# CPU's own f32 decode is 7.1e-6 from an f64 one and the card's 9.4e-6 from
# the CPU's, bound 1e-4.
VPOSER_ENCODE_REL, VPOSER_DECODE_REL = 1e-5, 1e-4
# The real steps' kernel step against their plain step is a determinism
# check, not the kernel's agreement: the real losses read only the first 22
# joints, which the kinematic chain gives before skinning, so the skinned
# vertices reach neither the loss nor a gradient (their backward gets zeros)
# and the two steps are equal bit for bit (measured 0 in every part).
# Skinning's own agreement on this path is checked on the vertices of
# eval_step's predictions (CANON_REL).
REAL_BOUNDS = {"loss": 0.0, "regressor": 0.0, "trunk": 0.0}
REAL_TRAIN_FRAMES, REAL_TEST_FRAMES = 48, 30   # the synthetic DJI capture
REAL_STEPS = 10
# Phase 12. The eval passes with the skinning kernel against the plain
# skinning: the same predictions skinned in another f32 summation order
# (phases 10-11 measured 1.1-1.8e-7 on the canonical GT and the eval
# vertices); the metrics read the kinematic joints, which skinning does not
# reach, so they agree to f32 ulps.
EVAL_BODY_REL, EVAL_METRIC_REL = 2e-7, 1e-6
REAL_EVAL_BATCH = 16        # the 30 test frames: 16 and a padded tail of 14
BA_FRAMES = 2000            # one chunk of the reference's bundle_adj.py
BA_STAGE_ITERS = 20         # iterations of each stage's timed run
BA_CLI_ITERS = (20, 40)     # the bundle_adjust CLI runs of phase 12c (BA_FRAMES runs 100 + 200)
# AirPose+ on the card against the CPU at 24 frames, 10 + 20 iterations:
# f32 sums in other orders, which Adam's normalised steps amplify
# (tests/test_torch_bundle_adjust.py holds the port to JAX at rtol 2e-4).
BA_SMALL, BA_CPU_RTOL = 24, 1e-3
# Phase 13. Serving: the staged 3 rounds against the fused forward, f32 at
# tests/test_serve.py:82's atol, int8 (its pose against Int8Inference's trunk
# on the same scales, at the served 1 crop a call, and the fused IEF) at
# :151's. Against Int8Inference.apply on the 60-crop folded batch the pose
# differs by 5.3e-3 (measured on the H100: cuDNN's bf16 stem rounds differently at
# that batch size, and the int8 quantization carries it on; logged, not
# checked). The served-vs-offline diffs at :524's bound, the
# native ROI replay at tests/test_native_client.py:236's; --int8 served pose
# against the f32 offline forward as loosely as test_staged_int8_close_to_bf16
# (mean |Δ| < 0.2 × the pose's rms); lag-one on a static scene :659-660's.
STAGED_ATOL_F32, STAGED_ATOL_INT8 = 1e-4, 2e-3
# A replayed round against the same round run eagerly: the same kernels on
# the same data (cuBLAS may pick another gemv under capture).
GRAPH_WIRE_ATOL = 1e-6
SERVED_DIFF, SERVED_ROI_DIFF, SERVED_INT8_RMS = 1e-3, 2e-2, 0.2
LAGONE_STATIC = 1e-6
NATIVE_FAKE_FRAMES, VIZ_FRAMES = 4, 3
REFERENCE_FPS = 4.0         # the reference README's synchronized pipeline


def log(msg):
    print(msg, flush=True)


def wall_ms(fn, iters=20, warmup=3):
    """Time per call between two CUDA events: the device's time, waits for
    the host included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


# ~0.1 s of spinning at the H100's 1.98 GHz: longer than the host takes to
# queue any timed run of kernels below
SLEEP_CYCLES = 200_000_000


def time_ms(fn, iters=20, warmup=3):
    """Device time per call: the timed calls are queued behind a spin kernel,
    so that the device runs them back to back whatever the host's speed (a
    kernel shorter than its host-side launch path would otherwise time the
    host)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n_bytes, flops, flop_rate):
    t_bytes, t_ops = n_bytes / HBM_BYTES, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def ptxas_lines(text, kernel):
    """ptxas -v's lines for one kernel: its spills, registers and static
    shared memory."""
    lines, out = text.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 6]:
                out.append(nxt.strip())
                if "registers" in nxt:
                    break
    return out


def skinning_at(w, a, p):
    """The skinning kernel against its plain version at one batch, then the
    kernel, the plain version, both library yardsticks and the bound."""
    from airpose_tpu_torch.bodymodel import cuda_lbs

    (B, J), V = a.shape[:2], w.shape[0]
    got = cuda_lbs.skinning(w, a, p)
    want = cuda_lbs.skinning_reference(w, a, p)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"skinning B={B}: max_abs_err {err:.3e} (atol {SKIN_ATOL})")
    check(err <= SKIN_ATOL, f"skinning kernel disagrees with its plain version at B={B}: {err}")

    def einsum_pair():  # the library yardstick: lbs.py's two einsums
        T = torch.einsum("vj,bjk->bvk", w, a.reshape(B, -1, 16)).reshape(B, -1, 4, 4)
        return torch.einsum("bvij,bvj->bvi", T[..., :3, :3], p) + T[..., :3, 3]

    # the floor of any library route: cuBLAS's f32 SGEMM of T's 12 used rows
    # (W @ A12, all the FMAs and nothing else; TF32 is off package-wide)
    a12 = a[:, :, :3, :].permute(1, 0, 2, 3).reshape(J, B * 12).contiguous()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the SGEMM yardstick")
    ms = time_ms(lambda: cuda_lbs.skinning(w, a, p), iters=50, warmup=5)
    paced_ms = wall_ms(lambda: cuda_lbs.skinning(w, a, p), iters=50, warmup=5)
    plain_ms = time_ms(lambda: cuda_lbs.skinning_reference(w, a, p))
    library_ms = time_ms(einsum_pair)
    sgemm_ms = time_ms(lambda: torch.mm(w, a12), iters=50, warmup=5)
    n_bytes = 4 * (w.numel() + a.numel() + p.numel() + got.numel())
    flops = B * V * (J * 12 * 2 + 18)
    bound_ms, bound_by = bound(n_bytes, flops, FP32_FLOPS)
    log(f"skinning B={B}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
        f"{paced_ms:.4f} ms a call when the host paces the launches), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (einsum pair), "
        f"{sgemm_ms:.4f} ms (SGEMM W @ A12), bound {bound_ms:.4f} ms ({bound_by}), "
        f"kernel at {bound_ms / ms:.1%} of its bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "sgemm_ms": sgemm_ms,
            "host_paced_ms": paced_ms}


def phase_skinning(dev):
    """The main path's B = 128 bodies (two views of 64 frames), then the
    training slice's B = 60, at V = 10475, J = 55."""
    from airpose_tpu_torch.bodymodel import cuda_lbs, synthetic_smplx_params
    from airpose_tpu_torch.ops import _build

    B, V, J = 128, 10475, 55
    rng = np.random.default_rng(1)
    w = synthetic_smplx_params().lbs_weights.to(dev)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    a = torch.from_numpy(rel).to(dev)
    p = torch.from_numpy(rng.normal(size=(B, V, 3)).astype(np.float32)).to(dev)

    res = cuda_lbs.kernel_resources(J)
    ptxas = ptxas_lines(_build.build_log.get("lbs_skinning", ""), "skinning_kernel")
    log(f"skinning kernel: {res}; ptxas: {' | '.join(ptxas) or 'not built in this process'}")
    check(res["blocks_per_sm"] >= 1, f"a skinning block does not fit on an SM: {res}")
    row = skinning_at(w, a, p)
    row["at_b60"] = skinning_at(w, a[:60], p[:60])
    return {"name": "lbs_skinning", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/lbs_skinning.cu",
            "replaces": "airpose_tpu/bodymodel/pallas_lbs.py:75"} | row


def phase_stage1(dev):
    import torch.nn.functional as F

    from airpose_tpu_torch.models.resnet import ResNet50
    from airpose_tpu_torch.ops import fused_bottleneck as fb

    B, h, w = 128, 56, 56
    rng = np.random.default_rng(2)
    trunk = ResNet50(generator=torch.Generator().manual_seed(2))
    sd = trunk.state_dict()
    for k in sd:  # perturb layer1's BN statistics so that folding is non-trivial
        if k.startswith("layer1.") and k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.startswith("layer1.") and k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    ops = [{k: v.to(dev) for k, v in blk.items()}
           for blk in fb.stage1_params_from_state_dict(sd)]
    # a post-relu, post-maxpool stem output is non-negative
    x = torch.from_numpy(np.abs(rng.normal(size=(B, h, w, 64))).astype(np.float32)
                         ).to(dev, torch.bfloat16)

    got = fb.fused_stage1(x, ops)
    want = fb.fused_stage1_reference(x, ops)
    torch.cuda.synchronize()
    gf, wf = got.float(), want.float()
    err = (gf - wf).abs().max().item()
    close = torch.allclose(gf, wf, atol=STAGE_TOL, rtol=STAGE_TOL)
    log(f"fused_stage1: max_abs_err {err:.3e}, mean |out| {wf.abs().mean().item():.3e}, "
        f"allclose(atol=rtol={STAGE_TOL}) {close}")
    check(close, "fused layer1 kernel disagrees with its plain version")
    check(wf.abs().mean().item() > 1e-3, "fused layer1 output is trivially zero")

    # the library yardstick: the same folded blocks as cuDNN bf16 convolutions
    lib = []
    for blk in ops:
        conv = {k: blk[k].reshape(blk[k].shape[0], -1, 1, 1) for k in ("w1", "w3", "wp") if k in blk}
        conv["w2"] = blk["w2"].reshape(64, 3, 3, 64).permute(0, 3, 1, 2)
        lib.append({k: v.contiguous(memory_format=torch.channels_last) for k, v in conv.items()}
                   | {k: blk[k].to(torch.bfloat16) for k in ("b1", "b2", "b3", "bp") if k in blk})
    xc = x.permute(0, 3, 1, 2)

    def cudnn_chain():
        a = xc
        for blk in lib:
            y = F.relu(F.conv2d(a, blk["w1"], blk["b1"]))
            y = F.relu(F.conv2d(y, blk["w2"], blk["b2"], padding=1))
            y = F.conv2d(y, blk["w3"], blk["b3"])
            a = F.relu(y + (F.conv2d(a, blk["wp"], blk["bp"]) if "wp" in blk else a))
        return a

    ms = time_ms(lambda: fb.fused_stage1(x, ops))
    plain_ms = time_ms(lambda: fb.fused_stage1_reference(x, ops), iters=5, warmup=1)
    library_ms = time_ms(cudnn_chain)
    hw = h * w
    flops = B * 2 * hw * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256
                          + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
    n_bytes = (x.numel() + got.numel()) * 2 + sum(
        t.numel() * t.element_size() for blk in ops for t in blk.values())
    bound_ms, bound_by = bound(n_bytes, flops, BF16_FLOPS)
    log(f"fused_stage1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {"name": "fused_stage1", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/fused_stage1.cu",
            "replaces": "airpose_tpu/ops/fused_bottleneck.py:176",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_chain(dev):
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.perception import bench_inputs, build_perception, perceive

    B = 64
    model, smplx_params, features = build_perception(dev, trunk="bf16")
    inputs = bench_inputs(B, dev)

    _build.counts.clear()
    verts, j2d = perceive(model, smplx_params, *inputs, features)
    torch.cuda.synchronize()
    launches = {k: _build.counts[k] for k in ("lbs_skinning", "fused_stage1")}
    log(f"chain: launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path did not launch: {launches}")
    check(tuple(verts.shape) == (B, 2, 10475, 3) and tuple(j2d.shape) == (B, 2, 127, 2),
          f"chain output shapes {tuple(verts.shape)}, {tuple(j2d.shape)}")
    check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()),
          "non-finite chain output")

    v_ref, j_ref = perceive(model, smplx_params, *inputs, features, use_kernels=False)
    rel = {k: ((a - b).norm() / b.norm()).item()
           for k, a, b in (("verts", verts, v_ref), ("j2d", j2d, j_ref))}
    log(f"chain vs plain chain: rel-L2 {rel} (bound {CHAIN_REL_L2})")
    check(all(r < CHAIN_REL_L2 for r in rel.values()), f"chain disagrees with the plain chain: {rel}")
    return launches


def int_mm_conv(x, w, m, b, ksize, stride=1, res=None, r=None, relu=False,
                out_dtype=torch.int8, qscale=None):
    """The library yardstick for one int8 conv (the port never calls it):
    im2col by torch indexing, torch._int_mm (cuBLASLt's s8 GEMM), then the
    kernel's epilogue in torch."""
    from airpose_tpu_torch.ops import int8_conv as ic

    N, H, W, _ = x.shape
    ho, wo = ic.out_size(H, ksize, stride), ic.out_size(W, ksize, stride)
    if ksize == 1:
        cols = x[:, ::stride, ::stride]
    else:
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, di:di + stride * (ho - 1) + 1:stride,
                             dj:dj + stride * (wo - 1) + 1:stride]
                          for di in range(3) for dj in range(3)], dim=-1)
    acc = torch._int_mm(cols.reshape(N * ho * wo, -1), w.t())
    return ic.epilogue(acc.view(N, ho, wo, -1), m, b, res, r, relu, out_dtype, qscale)


def max_diff(got, want):
    """max |got − want| over an output or a (bf16, int8) pair of outputs."""
    if isinstance(got, tuple):
        return max(max_diff(g, w) for g, w in zip(got, want))
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    return (got.float() - want.float()).abs().max().item()


def phase_int8_conv(dev, qparams, act_scales, crops):
    """The conv kernel exact against its plain version in every epilogue mode
    at two full-width shapes, then the int8 trunk's 52 convs at 128 crops
    replayed through the kernel, the plain version and torch._int_mm."""
    from airpose_tpu_torch.ops import int8_conv as ic
    from airpose_tpu_torch.ops import int8_trunk as it

    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16
    for name, (N, H, W, cin, cout, ksize, stride) in (
            ("layer1 3x3", (128, 56, 56, 64, 64, 3, 1)),
            ("layer2_0 3x3/2", (128, 56, 56, 128, 128, 3, 2))):
        K = ksize * ksize * cin
        x = torch.from_numpy(rng.integers(-127, 128, (N, H, W, cin), dtype=np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (cout, K), dtype=np.int8)).to(dev)
        m = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 20 / (np.sqrt(K) * 127 * 73)
                              ).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, 5, cout).astype(np.float32)).to(dev)
        shape = (N, ic.out_size(H, ksize, stride), ic.out_size(W, ksize, stride), cout)
        res_f = torch.from_numpy(rng.normal(0, 20, shape).astype(np.float32)).to(dev)
        # the requant scale 0.3 puts the largest values past the int8 clip
        modes = {"requant": dict(relu=True), "f32": dict(out_dtype=torch.float32),
                 "block_end": dict(res=(res_f.abs() % 128).to(torch.int8),
                                   r=torch.tensor(0.37, device=dev), relu=True),
                 "block_end_bf16": dict(res=res_f, relu=True, out_dtype=bf16),
                 "qconv": dict(res=res_f.to(bf16), relu=True, out_dtype=bf16),
                 "qconv_quant": dict(relu=True, out_dtype=torch.int8, qscale=0.3),
                 "qconv_dual": dict(res=res_f.to(bf16), relu=True, out_dtype=bf16,
                                    qscale=0.3)}
        for mode, kw in modes.items():
            got = ic.int8_conv(x, w, m, b, ksize, stride, **kw)
            want = ic.int8_conv_reference(x, w, m, b, ksize, stride, **kw)
            torch.cuda.synchronize()
            diff = max_diff(got, want)
            check(diff == 0.0, f"int8 conv {name} {mode}: kernel differs from its plain "
                  f"version by {diff}")
        q = want[1]
        check(bool((q.abs() == 127).any() and (q == 0).any()),
              f"int8 conv {name}: the requant modes clip nothing or relu nothing")
        for mode in ("qconv", "qconv_dual", "qconv_quant"):
            kw = modes[mode]
            ms = time_ms(lambda: ic.int8_conv(x, w, m, b, ksize, stride, **kw))
            plain_ms = time_ms(lambda: ic.int8_conv_reference(x, w, m, b, ksize, stride, **kw),
                               iters=3, warmup=1)
            library_ms = time_ms(lambda: int_mm_conv(x, w, m, b, ksize, stride, **kw))
            n_ops, n_bytes = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                                       kw.get("qscale"))
            bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS)
            log(f"int8_conv {name} {(N, H, W, cin)}→{cout} {mode}: kernel {ms:.4f} ms "
                f"({n_ops / ms / 1e9:.1f} TOPS), plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        log(f"int8_conv {name}: exact in {len(modes)} modes")

    # the trunk's 52 convs as the static trunk makes them (conv1/conv2 int8
    # out, conv3 bf16 + int8), captured from one int8 trunk run at 128 crops
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ic.int8_conv(*a, **kw)

    it.resnet50_int8_infer(qparams, crops, act_scales, conv=record)
    check(len(calls) == 52, f"the int8 trunk made {len(calls)} conv calls, expected 52")
    n_quant = sum(kw.get("qscale") is not None for _, kw in calls)
    check(n_quant == 47, f"{n_quant} of the trunk's convs requantize in their epilogue, "
          "expected 47 (all but the 4 projections and the last conv3)")
    err = 0.0
    for a, kw in calls:
        err = max(err, max_diff(ic.int8_conv(*a, **kw), ic.int8_conv_reference(*a, **kw)))
    torch.cuda.synchronize()
    log(f"int8_conv: the trunk's 52 convs ({n_quant} requantizing), max_abs_err {err} "
        "vs the plain version (exact)")
    check(err == 0.0, f"int8 conv kernel differs from its plain version in the trunk: {err}")

    def replay(fn):
        for a, kw in calls:
            fn(*a, **kw)

    ms = time_ms(lambda: replay(ic.int8_conv), iters=10)
    plain_ms = time_ms(lambda: replay(ic.int8_conv_reference), iters=2, warmup=1)
    library_ms = time_ms(lambda: replay(int_mm_conv), iters=10)
    n_ops = n_bytes = 0
    for (x, w, m, b, ksize, stride), kw in calls:
        o, nb = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                          kw.get("qscale"))
        n_ops, n_bytes = n_ops + o, n_bytes + nb
    bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS)
    log(f"int8_conv: 52 convs at 128 crops: {n_ops / 1e9:.1f} GOP, {n_bytes / 1e9:.3f} GB; "
        f"kernel {ms:.4f} ms ({n_ops / ms / 1e9:.1f} TOPS), plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "int8_conv", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/int8_conv.cu",
            "replaces": "airpose_tpu/ops/int8_trunk.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}



def stem_at(w, b, x):
    """The fused stem kernel at one batch against its plain version (cuDNN's
    bf16 conv, then pool, bias and relu) and against the fixed-order conv
    with the same pool, bias and relu: each output within one bf16 step of
    the other's pre-bias pooled value, differing on at most STEM_STEP_SHARE
    of the outputs; then the kernel, the plain version, cuDNN's conv alone
    (the library yardstick), the composed library route (cuDNN's conv,
    max_pool2d, add, relu) and the bound. Returns (row, the kernel's output)."""
    from torch.nn import functional as F

    from airpose_tpu_torch.ops import int8_stem as st

    n = x.shape[0]
    got = st.stem_cuda(x, w, b)
    torch.cuda.synchronize()
    row = {}
    for name, conv, plain in (("plain", st.stem_conv_reference, st.stem_reference),
                              ("ordered", st.stem_conv_ordered, st.stem_ordered)):
        lo, hi = st.one_step_range(st.pool(conv(x, w)), b)
        want = plain(x, w, b)
        within = bool(((got >= lo) & (got <= hi)).all())
        share = (got != want).float().mean().item()
        err = (got.float() - want.float()).abs().max().item()
        log(f"int8 stem at {n} crops: the fused kernel vs stem_{name}: max_abs_err {err:.3e}, "
            f"within one step of the map {within}, differing on {share:.3e} of the outputs "
            f"(bound {STEM_STEP_SHARE})")
        check(within and share <= STEM_STEP_SHARE,
              f"the stem kernel disagrees with stem_{name} at {n} crops: {err}, {share}")
        row |= {f"{name}_max_abs_err": err, f"{name}_differing_share": share}
    del lo, hi, want
    torch.cuda.empty_cache()
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)

    def composed():  # the library route: cuDNN's conv, then three more passes
        h = F.max_pool2d(F.conv2d(xb, w, stride=2, padding=3), 3, stride=2, padding=1)
        return h.add_(b[:, None, None]).relu_()

    ms = time_ms(lambda: st.stem_cuda(x, w, b), iters=50, warmup=5)
    plain_ms = time_ms(lambda: st.stem_reference(x, w, b), iters=50, warmup=5)
    library_ms = time_ms(lambda: F.conv2d(xb, w, stride=2, padding=3), iters=50, warmup=5)
    composed_ms = time_ms(composed, iters=50, warmup=5)
    flops, n_bytes = st.stem_cost(x)
    bound_ms, bound_by = bound(n_bytes, flops, BF16_FLOPS)
    log(f"int8 stem at {n} crops: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
        f"(cuDNN's conv alone), composed library route {composed_ms:.4f} ms (cuDNN's conv, "
        f"max_pool2d, add, relu), bound {bound_ms:.4f} ms ({bound_by}), kernel at "
        f"{bound_ms / ms:.1%} of its bound")
    return {"max_abs_err": row["plain_max_abs_err"], **row, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "composed_library_ms": composed_ms}, got


def phase_stem(dev, qparams, crops):
    """The int8 trunk's fused stem kernel at 1, 60 and 128 crops of 224² (the
    chain's), on the main path's folded stem weight, bias and crops; then
    crops 0, 59 and 127 each alone against their places in the 60- and
    128-crop calls, bit for bit."""
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.ops import int8_stem as st

    ptxas = ptxas_lines(_build.build_log.get("int8_stem", ""), "fused_stem_kernel")
    log(f"int8 stem kernel ptxas: {' | '.join(ptxas) or 'not built in this process'}")
    w, b = qparams["stem"]["w"], qparams["stem"]["b"]
    rows, outs = {}, {}
    for n in STEM_CROPS:
        rows[n], outs[n] = stem_at(w, b, crops[:n])
    invariant = {}
    for k in (0, 59, 127):
        one = st.stem_cuda(crops[k:k + 1], w, b)[0]
        for n in STEM_CROPS:
            if k < n:
                invariant[f"crop {k} alone = crop {k} of {n}"] = torch.equal(outs[n][k], one)
    log(f"int8 stem position and batch invariance: {invariant}")
    check(all(invariant.values()), f"the stem kernel is not batch-invariant: {invariant}")
    row = rows[crops.shape[0]]
    row.update({f"at_{n}_crops": rows[n] for n in STEM_CROPS if n != crops.shape[0]})
    row["invariance"] = invariant
    row["ptxas"] = ptxas
    return {"name": "int8_stem", "route": "cuda", "source": "airpose_tpu_torch/csrc/int8_stem.cu",
            "replaces": "airpose_tpu/ops/int8_trunk.py:175-184 (the int8 trunk's stem: an XLA "
                        "conv, bias, relu and reduce_window)"} | row


def phase_int8_blocks(dev, model, blocks, crops):
    """The 13 int8 blocks of layers 2-4 chained at 128 crops: each against
    its plain version on the same input, then the chain's times."""
    from airpose_tpu_torch.ops import int8_bottleneck as ib

    with torch.no_grad():
        front = model.trunk(crops, part="front")
    h0 = torch.round(front.float() / blocks["s_in"]).clamp_(0, 127).to(torch.int8).contiguous()
    h, err, n_ops, n_bytes = h0, 0.0, 0, 0
    for i, blk in enumerate(blocks["blocks"]):
        got, want = ib.int8_block(h, blk), ib.int8_block_reference(h, blk)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        frac = (diff > 0).float().mean().item()
        err = max(err, diff.max().item())
        check(diff.max().item() <= BLOCK_MAX_STEP and frac < BLOCK_FRAC,
              f"int8 block {i}: max step {diff.max().item()} on {frac:.2e} of elements")
        B, H, W, cin = h.shape
        _, ho, wo, cout = got.shape
        cmid = blk["w1"].shape[0]
        # the TPU kernel's count: conv1 of a stride-2 block at the input resolution
        n_ops += 2 * B * (H * W * cin * cmid + ho * wo * (9 * cmid * cmid + cmid * cout
                                                          + (cin * cout if "wp" in blk else 0)))
        n_bytes += h.numel() + got.numel() * got.element_size() + sum(
            v.numel() * v.element_size() for v in blk.values() if torch.is_tensor(v))
        h = got
    check(h.dtype == torch.bfloat16 and tuple(h.shape) == (crops.shape[0], 7, 7, 2048),
          f"int8 blocks end in {h.dtype} {tuple(h.shape)}")
    log(f"int8_block: 13 blocks within {BLOCK_MAX_STEP} step on < {BLOCK_FRAC} of elements "
        f"(max |err| {err})")

    def chain(fn):
        x = h0
        for blk in blocks["blocks"]:
            x = fn(x, blk)
        return x

    ms = time_ms(lambda: chain(ib.int8_block), iters=10)
    plain_ms = time_ms(lambda: chain(ib.int8_block_reference), iters=2, warmup=1)
    library_ms = time_ms(lambda: chain(lambda x, blk: ib.run_block(int_mm_conv, x, blk)),
                         iters=10)
    bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS)
    log(f"int8_block: 13 blocks at {crops.shape[0]} crops: {n_ops / 1e9:.1f} GOP, "
        f"{n_bytes / 1e9:.3f} GB; kernel {ms:.4f} ms ({n_ops / ms / 1e9:.1f} TOPS), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "int8_block", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/int8_conv.cu",
            "replaces": "airpose_tpu/ops/int8_bottleneck.py:231",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_int8_chains(dev, model, smplx_params, chains, inputs, bf16_features):
    """The int8 chain and the int8-block chain at B = 64, each driven with
    the counters at 0, against its plain chain and the bf16 trunk.
    ``chains``: (name, features, int8 conv launches, int8_block calls,
    torch quantize calls of the int8 trunk)."""
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.perception import perceive

    B = inputs[0].shape[0]
    crops = inputs[0].reshape((B * 2,) + inputs[0].shape[2:])
    with torch.no_grad():
        xf_bf16 = bf16_features(crops)
    launches = {}
    for name, features, n_conv, n_block, n_quant in chains:
        _build.counts.clear()
        verts, j2d = perceive(model, smplx_params, *inputs, features)
        torch.cuda.synchronize()
        n = {k: _build.counts[k] for k in ("int8_conv", "int8_block", "lbs_skinning",
                                          "quantize_act", "int8_stem")}
        log(f"{name} chain: launches {n}")
        # the int8 trunk's stem is the stem kernel (one launch a trunk call);
        # the int8-block chain runs the bf16 trunk's own stem and layer1
        n_stem = n_conv // 52
        check(n == {"int8_conv": n_conv, "int8_block": n_block, "lbs_skinning": 1,
                    "quantize_act": n_quant, "int8_stem": n_stem},
              f"the {name} path launched {n}, expected {n_conv} int8 conv launches, "
              f"{n_block} int8_block calls, 1 skinning launch, {n_quant} torch "
              f"quantize calls and {n_stem} stem launches")
        launches[name] = n
        check(tuple(verts.shape) == (B, 2, 10475, 3) and tuple(j2d.shape) == (B, 2, 127, 2),
              f"{name} chain output shapes {tuple(verts.shape)}, {tuple(j2d.shape)}")
        check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()),
              f"non-finite {name} chain output")
        with torch.no_grad():
            xf = features(crops)
            xf_plain = features(crops, use_kernels=False)
        check(torch.equal(xf, xf_plain), f"{name} trunk differs from its plain version by "
              f"{(xf - xf_plain).abs().max().item()}")
        v_ref, j_ref = perceive(model, smplx_params, *inputs, features, use_kernels=False)
        rel = {k: ((a - b).norm() / b.norm()).item()
               for k, a, b in (("verts", verts, v_ref), ("j2d", j2d, j_ref))}
        log(f"{name} trunk equals its plain version; chain vs plain chain: rel-L2 {rel} "
            f"(bound {INT8_CHAIN_REL_L2})")
        check(all(r < INT8_CHAIN_REL_L2 for r in rel.values()),
              f"{name} chain disagrees with its plain chain: {rel}")
        corr = float(np.corrcoef(xf.cpu().numpy().ravel(), xf_bf16.cpu().numpy().ravel())[0, 1])
        feat_rel = ((xf - xf_bf16).norm() / xf_bf16.norm()).item()
        log(f"{name} trunk vs bf16 trunk: feature corr {corr:.6f}, rel-L2 {feat_rel:.4f} "
            f"(bound corr > {FEATURE_CORR})")
        check(corr > FEATURE_CORR, f"{name} features correlate {corr} with the bf16 trunk's")
    return launches


def skinning_backward_at(w, a, p):
    """The skinning Function's gradients against autograd through the plain
    version at one batch, then the backward's times and bound."""
    from airpose_tpu_torch.bodymodel import cuda_lbs

    (B, J), V = a.shape[:2], w.shape[0]
    a, p = a.clone().requires_grad_(True), p.clone().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=tuple(p.shape)).astype(np.float32)
                         ).to(p.device)
    got = torch.autograd.grad(cuda_lbs.skinning(w, a, p), (a, p), g)
    ref_out = cuda_lbs.skinning_reference(w, a, p)
    want = torch.autograd.grad(ref_out, (a, p), g, retain_graph=True)
    torch.cuda.synchronize()
    rel = {k: ((x - y).abs().max() / y.abs().max()).item()
           for k, x, y in zip(("d_rel_tf", "d_v_posed"), got, want)}
    log(f"skinning backward B={B}: max relative error {rel} (bound {SKIN_GRAD_REL})")
    check(all(r <= SKIN_GRAD_REL for r in rel.values()),
          f"skinning backward disagrees with autograd through the plain version: {rel}")
    ad, pd = a.detach(), p.detach()
    ms = time_ms(lambda: cuda_lbs.skinning_backward(w, ad, pd, g), iters=50, warmup=5)
    paced_ms = wall_ms(lambda: cuda_lbs.skinning_backward(w, ad, pd, g), iters=50, warmup=5)
    plain_ms = time_ms(lambda: torch.autograd.grad(ref_out, (a, p), g, retain_graph=True))
    n_bytes = 4 * (w.numel() + 2 * a.numel() + 2 * p.numel() + g.numel())
    flops = 2 * V * J * B * 9 + 2 * B * V * 9 + B * V * 12 + 2 * J * V * B * 12
    bound_ms, bound_by = bound(n_bytes, flops, FP32_FLOPS)
    log(f"skinning backward B={B}: {ms:.4f} ms (torch ops: two SGEMMs and elementwise "
        f"passes; {paced_ms:.4f} ms a call when the host paces the launches), autograd of "
        f"the einsum pair {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), at {bound_ms / ms:.1%} of its bound")
    return {"max_rel_err": max(rel.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "host_paced_ms": paced_ms}


class GradProbe:
    """A stand-in for the optimizer that keeps the gradients the train step
    hands it and updates nothing, so that steps driven through a step
    factory all start from the same weights."""

    def update(self, grads, opt_state, params):
        self.grads = grads


def grad_agreement(a, b):
    """Relative difference of two probed steps' losses and rel-L2 of their
    regressor's and trunk's gradients (core*, trunk*: one or one per drone);
    ``a``, ``b``: (loss, grads)."""
    (loss_a, ga), (loss_b, gb) = a, b

    def rel_l2(prefix):
        names = [n for n in gb if n.startswith(prefix)]
        num = sum((ga[n] - gb[n]).float().pow(2).sum() for n in names)
        return (num / sum(gb[n].float().pow(2).sum() for n in names)).sqrt().item()

    return {"loss": abs(loss_a - loss_b) / abs(loss_b),
            "regressor": rel_l2("core"), "trunk": rel_l2("trunk")}


def kernel_vs_plain_step(model, make_steps, cfg, batch, bounds, what, keep_step=False):
    """One train step's loss and gradients with the skinning kernel against
    the same step with the plain version, each driven through the step
    factory (``make_steps(tx, use_kernels)`` → (train_step, eval_step))
    with GradProbe for its optimizer, from the same weights and generator
    seed (so the same dropout masks); the kernel step against itself gives
    the floor of the comparison. ``keep_step`` returns the kernel step's
    (loss, gradients) too, as ``kernel_step``."""
    from airpose_tpu_torch.train import create_train_state

    state, _ = create_train_state(model, cfg.lr)
    dev = batch["images"].device

    def probed_step(use_kernels):
        probe = GradProbe()
        step, _ = make_steps(probe, use_kernels)

        def run():
            _, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(11))
            return metrics["loss"].item(), probe.grads
        return run

    kernel_step = probed_step(True)
    first = kernel_step()
    floor = grad_agreement(kernel_step(), first)
    plain = grad_agreement(probed_step(False)(), first)
    log(f"train step, {what}: skinning kernel vs plain {plain} (bounds {bounds}); "
        f"kernel vs itself {floor}")
    check(all(plain[k] <= bounds[k] for k in bounds),
          f"the kernel's {what} train step disagrees with the plain step: {plain}")
    return {"vs_plain": plain, "vs_itself": floor} | ({"kernel_step": first} if keep_step else {})


def twoview_steps(model, smplx_params, cfg):
    """make_steps for the two-view models: the plain step skins through
    twoview_loss's plain version."""
    from airpose_tpu_torch.train import make_twoview_step_fns, twoview_loss

    def make_steps(tx, use_kernels):
        return make_twoview_step_fns(
            model, smplx_params, cfg, tx,
            loss=None if use_kernels else partial(twoview_loss, use_kernels=False))
    return make_steps


def singleview_steps(model, smplx_params, cfg, family):
    """make_steps for the single-view families and muhmr."""
    from airpose_tpu_torch.train import make_singleview_step_fns

    def make_steps(tx, use_kernels):
        return make_singleview_step_fns(model, smplx_params, cfg, tx, family,
                                        use_kernels=use_kernels)
    return make_steps


def device_work(fn, n):
    """The device's kernels and copies of ``n`` calls of ``fn`` under the
    profiler (not the record_function spans' device-side ranges, which are
    not work), and the wall ms a call there (the profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = wall_ms(fn, iters=n, warmup=0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in ("forward", "backward", "forward_backward", "optimizer")]
    return events, prof_ms


def graph_launches(calls, objects=1):
    """Skinning launches at each of ``calls`` train steps of one batch
    layout, ``objects`` step objects called in turn: one at each object's
    eager first call and at its capture (its second), none at a replay,
    which the host counter does not see (train/loop.py)."""
    return [1] * min(calls, 2 * objects) + [0] * max(calls - 2 * objects, 0)


def phase_train(dev):
    """The two-view training step of record at B = 30 frames of 224²."""
    from unittest import mock

    from torch.profiler import record_function

    import airpose_tpu_torch.train.loop as loop
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns

    cfg = TrainConfig()
    B = cfg.batch_size
    smplx_params = synthetic_smplx_params().to(dev)
    batch = batch_slice(make_synthetic_dataset(smplx_params, B, seed=0), 0, B, dev)
    check(tuple(batch["images"].shape) == (B, 2, 224, 224, 3),
          f"synthetic batch images {tuple(batch['images'].shape)}")

    # skinning's backward at the step's 60 bodies, on the step's own inputs' scale
    rng = np.random.default_rng(3)
    rel = rng.normal(size=(2 * B, 55, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    backward = skinning_backward_at(
        smplx_params.lbs_weights, torch.from_numpy(rel).to(dev),
        torch.from_numpy(rng.normal(size=(2 * B, 10475, 3)).astype(np.float32)).to(dev))

    f32_model = AirPoseTwoView(seed=0).to(dev)
    agree = {"f32": kernel_vs_plain_step(f32_model, twoview_steps(f32_model, smplx_params, cfg),
                                         cfg, batch, TRAIN_F32_BOUNDS, "f32 trunk",
                                         keep_step=True)}
    del f32_model
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=0).to(dev)
    agree["bf16"] = kernel_vs_plain_step(model, twoview_steps(model, smplx_params, cfg), cfg,
                                         batch, TRAIN_BF16_BOUNDS, "bf16 trunk", keep_step=True)
    # bf16's own error in the step: the bf16 step against the f32 step on the
    # same seed-0 weights, batch and dropout masks (both with the kernel)
    f32_step = agree["f32"].pop("kernel_step")
    bf16_vs_f32 = grad_agreement(agree["bf16"].pop("kernel_step"), f32_step)
    agree["bf16"]["bf16_vs_f32_step"] = bf16_vs_f32
    del f32_step
    log(f"train step: the bf16 step vs the f32 step {bf16_vs_f32}; the bf16 kernel step's "
        f"trunk gradients vs the plain step's {agree['bf16']['vs_plain']['trunk']:.3e} must "
        "lie inside that gap")
    check(agree["bf16"]["vs_plain"]["trunk"] < bf16_vs_f32["trunk"],
          f"the bf16 kernel step's trunk gradients differ from the plain step's by "
          f"{agree['bf16']['vs_plain']['trunk']}, more than bf16 differs from f32 "
          f"({bf16_vs_f32['trunk']})")

    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_twoview_step_fns(model, smplx_params, cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    losses, launches = [], []
    for i in range(TRAIN_STEPS):
        _build.counts.clear()
        state, metrics = train_step(state, batch, gen)
        losses.append(metrics["loss"].item())
        launches.append(_build.counts["lbs_skinning"])
    counters = (train_step.eager_steps, train_step.graph_replays)
    log(f"train: {TRAIN_STEPS} steps at B={B}, losses {[round(x, 1) for x in losses]}; "
        f"skinning launches by step {launches}; eager_steps, graph_replays {counters}")
    check(launches == graph_launches(TRAIN_STEPS),
          f"train steps launched skinning {launches}, expected {graph_launches(TRAIN_STEPS)}")
    check(counters == (1, TRAIN_STEPS - 1), f"train step eager_steps, graph_replays {counters}")
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(np.mean(losses[-5:]) < np.mean(losses[:3]),
          f"training loss did not fall: first 3 {losses[:3]}, last 5 {losses[-5:]}")
    metrics, preds = eval_step(state, batch)
    check(tuple(preds["pred_rotmat"].shape) == (B, 2, 22, 3, 3)
          and bool(torch.isfinite(preds["pred_rotmat"]).all()),
          f"eval_step rotmats {tuple(preds['pred_rotmat'].shape)}")
    log(f"eval_step: loss {metrics['loss'].item():.1f}, pred_rotmat "
        f"{tuple(preds['pred_rotmat'].shape)}")

    # the step's time, replayed and eager (a fresh step object's first call
    # runs eagerly), then its parts: loop.py's spans, each also bracketed by
    # two CUDA events (the name loop.py calls is replaced here only)
    step_ms = wall_ms(lambda: train_step(state, batch, gen), iters=10, warmup=2)

    def eager_step():
        return make_twoview_step_fns(model, smplx_params, cfg, tx)[0](state, batch, gen)

    eager_ms = wall_ms(eager_step, iters=5, warmup=1)
    marks = []

    @contextlib.contextmanager
    def event_span(name):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with record_function(name):
            yield
        ev[1].record()
        marks.append((name, *ev))

    n_spans = 5
    splits = {}
    for kind, fn in (("replayed", lambda: train_step(state, batch, gen)), ("eager", eager_step)):
        marks.clear()
        with mock.patch.object(loop, "span", event_span):
            for _ in range(n_spans):
                fn()
        torch.cuda.synchronize()
        splits[kind] = {"forward": 0.0, "backward": 0.0, "forward_backward": 0.0,
                        "optimizer": 0.0}
        for name, start, stop in marks:
            splits[kind][name] += start.elapsed_time(stop) / n_spans
    # busy: the device time of every kernel and copy of 3 steps under the
    # profiler (the record_function spans' device-side ranges are not work);
    # idle share = 1 − busy / wall, wall from the unprofiled steps (the
    # profiler slows the host)
    n_prof = 3
    device_events, prof_ms = device_work(lambda: train_step(state, batch, gen), n_prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / n_prof
    fps = B / (step_ms / 1e3)
    log(f"train step at B={B} frames (2·{B} crops of 224²): replayed {step_ms:.3f} ms, {fps:.1f} "
        f"frames/s; eager {eager_ms:.3f} ms, {B / (eager_ms / 1e3):.1f} frames/s; eager_steps, "
        f"graph_replays {(train_step.eager_steps, train_step.graph_replays)}; spans (CUDA events) "
        + "; ".join(f"{kind} {{{', '.join(f'{k}: {v:.3f}' for k, v in split.items() if v)}}}"
                    for kind, split in splits.items())
        + f" ms; replayed: device busy {busy_ms:.3f} ms a step in {len(device_events) / n_prof:.0f} "
        f"kernels and copies, idle share {1 - busy_ms / step_ms:.3f} (under the profiler: wall "
        f"{prof_ms:.3f} ms, idle share {1 - busy_ms / prof_ms:.3f})")
    by_name = {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n_prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("train step, top device time a step: " + "; ".join(f"{ms:.3f} ms {n[:90]}"
                                                            for n, ms in top))
    backward["train_launches_by_step"] = launches
    return backward, {"step_ms": step_ms, "frames_per_s": fps, "spans_ms": splits,
                      "eager_step_ms": eager_ms, "eager_frames_per_s": B / (eager_ms / 1e3),
                      "eager_steps": train_step.eager_steps,
                      "graph_replays": train_step.graph_replays,
                      "busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
                      "profiled_step_ms": prof_ms,
                      "device_events_per_step": len(device_events) / n_prof,
                      "losses": losses, "kernel_vs_plain": agree}, (smplx_params, batch, preds)


def phase_eval_metrics(smplx_params, batch, preds):
    """Phase 9, check 3: twoview_eval_metrics of eval_step's predictions
    against the batch's GT, with the skinning kernel (two launches: the
    predicted and the GT bodies, 2·B each) and with the plain version."""
    from airpose_tpu_torch.eval import twoview_eval_metrics
    from airpose_tpu_torch.ops import _build

    args = (smplx_params, preds["pred_rotmat"], preds["pred_betas"], preds["pred_trans"],
            batch["gt_pose_rotmat"], batch["gt_orient"], batch["gt_betas"], batch["gt_trans"])
    _build.counts.clear()
    got = twoview_eval_metrics(*args)
    torch.cuda.synchronize()
    launches = _build.counts["lbs_skinning"]
    check(launches == 2, f"twoview_eval_metrics launched skinning {launches} times, expected 2")
    want = twoview_eval_metrics(*args, use_kernels=False)
    got, want = ({k: v.item() for k, v in m.items()} for m in (got, want))
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    log(f"eval metrics after {TRAIN_STEPS} steps (B={batch['images'].shape[0]}): {got}; "
        f"kernel vs plain: max relative difference {rel:.3e} (bound {EVAL_REL})")
    check(len(got) == 6 and all(np.isfinite(v) for v in got.values()),
          f"eval metrics {got}")
    check(rel <= EVAL_REL, f"eval metrics with the kernel disagree with the plain ones: {rel}")
    return {"metrics": got, "plain": want, "max_rel": rel, "skinning_launches": launches}


def phase_families(dev, smplx_params, batch, steps=FAMILY_STEPS):
    """Phase 9, checks 1-2: each of the other families' train steps on the
    bf16 trunk (TrainConfig(model=family)), kernel step against plain step,
    then ``steps`` steps, the eager first and the capture each launching
    skinning once (every family's loss makes one SMPL-X call: B bodies for
    hmr and copenet_singleview, 2·B folded for muhmr and the per-drone
    model) and the replays none, the loss falling."""
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.models import MODEL_REGISTRY
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.train import create_train_state

    B = batch["images"].shape[0]
    out = {}
    for family in FAMILY_BOUNDS:
        cfg = TrainConfig(model=family)
        model = MODEL_REGISTRY[family](dtype=torch.bfloat16, seed=0).to(dev)
        make_steps = (twoview_steps(model, smplx_params, cfg) if family == "copenet_twoview_sep"
                      else singleview_steps(model, smplx_params, cfg, family))
        agree = kernel_vs_plain_step(model, make_steps, cfg, batch, FAMILY_BOUNDS[family],
                                     f"{family}, bf16 trunk")
        state, tx = create_train_state(model, cfg.lr)
        train_step, _ = make_steps(tx, True)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        losses, launches = [], []
        for i in range(steps):
            _build.counts.clear()
            state, metrics = train_step(state, batch, gen)
            losses.append(metrics["loss"].item())
            launches.append(_build.counts["lbs_skinning"])
        check(launches == graph_launches(steps),
              f"{family} train steps launched skinning {launches}, expected "
              f"{graph_launches(steps)}")
        check(bool(np.isfinite(losses).all()), f"non-finite {family} training loss {losses}")
        check(np.mean(losses[-3:]) < np.mean(losses[:3]),
              f"{family} training loss did not fall: {losses}")
        step_ms = wall_ms(lambda: train_step(state, batch, gen), iters=5, warmup=1)
        log(f"{family}: {steps} steps at B={B}, losses {[round(x, 1) for x in losses]}; "
            f"{step_ms:.3f} ms a step, {B / step_ms * 1e3:.1f} frames/s")
        out[family] = {"kernel_vs_plain": agree, "losses": losses, "step_ms": step_ms,
                       "frames_per_s": B / step_ms * 1e3, "skinning_launches_by_step": launches}
        del model, state, tx, train_step, make_steps
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def phase_sep_serving(dev, batch):
    """Phase 9, checks 4-5: the per-drone model (bf16, seed 0) behind
    Int8Inference at B frames (each trunk quantized and calibrated on its
    own, on the first frame's two crops): 52 int8 conv launches and one
    torch quantize call per trunk, each trunk's features equal to its plain
    int8 conv version's, the IEF on them within INT8_SEP_REL_L2; then three
    staged rounds of AirPoseTwoViewSepView.regress_step for both views
    against the fused forward."""
    from airpose_tpu_torch import constants as C
    from airpose_tpu_torch.models import AirPoseTwoViewSep, AirPoseTwoViewSepView, mean_init_state
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.ops import int8_trunk as it

    images, bb = batch["images"], batch["bb"]
    B = images.shape[0]
    pos = torch.full_like(bb, 10.0 * C.TRANS_SCALE)
    model = AirPoseTwoViewSep(dtype=torch.bfloat16, seed=0).to(dev)
    shim = it.Int8Inference(model, images[0])
    _build.counts.clear()
    out = shim.apply(images, bb, pos)
    torch.cuda.synchronize()
    n = {k: _build.counts[k] for k in ("int8_conv", "quantize_act", "int8_stem")}
    log(f"_sep int8 inference at B={B}: launches {n}")
    check(n == {"int8_conv": 104, "quantize_act": 2, "int8_stem": 2},
          f"_sep int8 inference launched {n}, expected 104 int8 conv launches, 2 torch "
          "quantize calls and 2 stem launches")
    check(bool(torch.isfinite(out.pose).all() and torch.isfinite(out.betas).all()),
          "non-finite _sep int8 output")
    xf = shim._features(images)
    plain = torch.stack([it.resnet50_int8_infer(shim.qparams[v], images[:, v],
                                                shim.act_scales[v], use_kernels=False)
                         for v in (0, 1)], dim=1)
    for v in (0, 1):
        check(torch.equal(xf[:, v], plain[:, v]), f"_sep int8 trunk{v} differs from its plain "
              f"version by {(xf[:, v] - plain[:, v]).abs().max().item()}")
    ref = model.from_features(plain, bb, pos)
    rel = {k: ((a - b).norm() / b.norm()).item()
           for k, a, b in (("pose", out.pose, ref.pose), ("betas", out.betas, ref.betas))}
    log(f"_sep int8: each trunk's features equal their plain version's; IEF vs plain: "
        f"rel-L2 {rel} (bound {INT8_SEP_REL_L2})")
    check(all(r <= INT8_SEP_REL_L2 for r in rel.values()),
          f"_sep int8 IEF disagrees with the plain one: {rel}")
    ms = wall_ms(lambda: shim.apply(images, bb, pos), iters=10, warmup=2)
    log(f"_sep int8 inference: {ms:.3f} ms a call, {B / ms * 1e3:.1f} two-view frames/s")

    fused = model(images, bb, pos)
    views = []
    for v in (0, 1):
        view = AirPoseTwoViewSepView(dtype=torch.bfloat16, seed=1, view=v)
        view.load_state_dict(model.state_dict())
        views.append(view.to(dev))
    feats = [views[v](images[:, v]) for v in (0, 1)]
    theta, shape = mean_init_state((B, 2), dev)[:2]
    pose = torch.cat([pos, theta], dim=-1)
    for _ in range(3):
        steps = [views[v].regress_step(feats[v], bb[:, v], pose[:, v], shape[:, v],
                                       pose[:, 1 - v, 9:], shape[:, 1 - v]) for v in (0, 1)]
        pose = torch.stack([p for p, _ in steps], dim=1)
        shape = torch.stack([s for _, s in steps], dim=1)
    diff = max((pose - fused.pose).abs().max().item(), (shape - fused.betas).abs().max().item())
    log(f"staged _sep (3 rounds of regress_step per view) vs fused: max |diff| {diff:.3e} "
        f"(bound {STAGED_ATOL})")
    check(diff <= STAGED_ATOL, f"staged _sep serving disagrees with the fused forward: {diff}")
    return {"int8": {"launches": n, "ief_rel_l2": rel, "ms": ms, "frames_per_s": B / ms * 1e3},
            "staged_max_abs_diff": diff}


class _Lines(io.TextIOBase):
    """Standard output of the in-process CLI run: echoed, and kept line by
    line with the host clock at which each line was written."""

    def __init__(self, echo):
        self.echo, self.lines, self._buf = echo, [], ""

    def write(self, text):
        self.echo.write(text)
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        self.echo.flush()


def write_smplx_npz(directory):
    """synthetic_smplx_params() (10,475 vertices) as a SMPLX_NEUTRAL.npz in
    the released layout: posedirs (V, 3, 486), the kintree table, the mean
    hands as axis-angle, the landmarks as extra faces."""
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.geometry import rotmat_to_aa

    p = synthetic_smplx_params()
    V, J = p.lbs_weights.shape
    faces = np.concatenate([p.faces, p.lmk_vert_ids.numpy()])
    hands = rotmat_to_aa(p.hand_pose).numpy()
    np.savez(os.path.join(directory, "SMPLX_NEUTRAL.npz"),
             v_template=p.v_template.numpy(), shapedirs=p.shape_dirs.numpy(),
             posedirs=p.pose_dirs.numpy().T.reshape(V, 3, -1),
             J_regressor=p.j_regressor.numpy(), weights=p.lbs_weights.numpy(),
             kintree_table=np.stack([np.asarray(p.parents), np.arange(J)]), f=faces,
             hands_meanl=hands[:15].ravel(), hands_meanr=hands[15:].ravel(),
             lmk_faces_idx=np.arange(len(p.faces), len(faces)),
             lmk_bary_coords=p.lmk_bary.numpy())


KERNELS = ("lbs_skinning", "fused_stage1", "int8_conv", "int8_stem", "add_layernorm")


def kernel_counts():
    """Launches of each hand-written kernel since the last reset."""
    from airpose_tpu_torch.ops import _build

    return {k: _build.counts[k] for k in KERNELS}


def reset_kernel_counts():
    from airpose_tpu_torch.ops import _build

    _build.counts.clear()


class CliRun:
    """trainer.main in-process, with the bodies of each skinning launch and
    the call it ran in (the set-up, a train step, a val batch, a summary
    grid), the calls of each kind, the states the trainer saves, the seconds
    of each save and grid, and its standard output stamped by the host clock
    (the names trainer.main calls are wrapped here only). ``step_factory``
    names the loop.py factory whose steps the run calls."""

    def __init__(self, step_factory):
        self.step_factory = step_factory
        self.bodies, self.where, self.calls = [], [], {"train": 0, "val": 0, "grid": 0}
        self.saved, self.save_s, self.summary_s = [], [], []

    def run(self, argv):
        """→ (the stamped output, seconds to return); the kernel counts are
        reset to 0 just before the call."""
        from airpose_tpu_torch.bodymodel import cuda_lbs
        from airpose_tpu_torch.train import checkpoint as ckpt_mod
        from airpose_tpu_torch.train import loop, trainer

        inside = ["set-up"]
        launch, save = cuda_lbs._launch, ckpt_mod.CheckpointManager.save
        summary, step_fns = trainer._twoview_summary, getattr(loop, self.step_factory)

        def counted_launch(w, a, p):
            self.bodies.append(a.shape[0])
            self.where.append(inside[0])
            return launch(w, a, p)

        def within(name, fn):
            def call(*a):
                inside[0] = name
                self.calls[name] += 1
                try:
                    return fn(*a)
                finally:
                    inside[0] = "other"
            return call

        def tagged_step_fns(*a, **kw):
            train_step, eval_step = step_fns(*a, **kw)
            return within("train", train_step), within("val", eval_step)

        def kept_save(manager, state, name="last"):
            self.saved.append(state)
            t = time.perf_counter()
            save(manager, state, name)
            self.save_s.append(time.perf_counter() - t)

        def timed_summary(*a):
            t = time.perf_counter()
            try:
                return within("grid", summary)(*a)
            finally:
                self.summary_s.append(time.perf_counter() - t)

        out = _Lines(sys.stdout)
        reset_kernel_counts()
        t0 = time.perf_counter()
        with mock.patch.object(cuda_lbs, "_launch", counted_launch), \
                mock.patch.object(ckpt_mod.CheckpointManager, "save", kept_save), \
                mock.patch.object(trainer, "_twoview_summary", timed_summary), \
                mock.patch.object(loop, self.step_factory, tagged_step_fns), \
                contextlib.redirect_stdout(out):
            trainer.main(argv)
        torch.cuda.synchronize()
        self.t0 = t0
        return out, time.perf_counter() - t0

    def per_call(self):
        """Skinning launches a call of each kind (over the calls made) and
        in the set-up."""
        per_call = {name: self.where.count(name) / n for name, n in self.calls.items() if n}
        per_call["set-up"] = self.where.count("set-up")
        return per_call


def logged_losses(lines):
    """{step: train loss} and {step: val loss} from the trainer's output."""
    train = {int(ln.split()[1]): float(ln.split()[3]) for ln in lines
             if ln.startswith("step ") and " loss " in ln}
    val = {int(ln.split()[1]): float(ln.split()[3]) for ln in lines
           if ln.startswith("step ") and " val_loss " in ln}
    return train, val


def phase_cli(dev, tmp, card, phase8_step_ms):
    """Phase 10, the CLI: trainer.main in-process, then the module's entry
    point as a subprocess, resuming and then preempted."""
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import checkpoint as ckpt_mod

    write_smplx_npz(tmp)
    logs = os.path.join(tmp, "logs")
    args = ["--name", "smoke", "--version", "0", "--model", "copenet_twoview",
            "--datapath", f"synthetic://{CLI_SAMPLES}", "--smplx_model_dir", tmp,
            "--log_dir", logs, "--batch_size", str(CLI_BATCH), "--val_batch_size",
            str(CLI_BATCH), "--img_res", str(CLI_IMG), "--val_every", str(CLI_VAL_EVERY)]
    run_dir = os.path.join(logs, "smoke", "version_0")
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    cli = CliRun("make_twoview_step_fns")
    out, run_s = cli.run(args + ["--max_steps", str(CLI_STEPS)])
    t0 = cli.t0
    bodies, where, calls, saved = cli.bodies, cli.where, cli.calls, cli.saved
    save_s, summary_s = cli.save_s, cli.summary_s
    counts = kernel_counts()
    lines = [line for _, line in out.lines]
    first_s = out.lines[0][0] - t0
    log(f"CLI in-process: returned after {run_s:.1f} s; kernel launches {counts}; "
        f"{first_s:.1f} s to the first logged step (set-up and one step), "
        f"{len(save_s)} checkpoint saves {sum(save_s):.1f} s, {len(summary_s)} summary grids "
        f"{sum(summary_s):.1f} s [{card}]")

    # the val split as trainer.py cuts it (at B = 30: one tail batch of 13
    # frames, 26 bodies); the summary grid renders after the first val batch
    n_train = int(CLI_SAMPLES * 0.8)
    val = [2 * CLI_BATCH] * len(range(n_train, CLI_SAMPLES - CLI_BATCH + 1, CLI_BATCH))
    if CLI_SAMPLES - n_train < CLI_BATCH:
        val.append(2 * (CLI_SAMPLES - n_train))
    # the train step skins at its eager first call and its capture, not at a replay
    want = [CLI_SAMPLES]
    for step, n in enumerate(graph_launches(CLI_STEPS), 1):
        want += [2 * CLI_BATCH] * n + (val[:1] + [2] + val[1:]
                                       if step % CLI_VAL_EVERY == 0 else [])
    check(bodies == want, f"CLI skinning launches by bodies {bodies}, expected {want} "
          "(dataset; 60 at the eager and the captured train step; the val batch; the summary "
          "grid)")
    check(counts == {"lbs_skinning": len(want), "fused_stage1": 0, "int8_conv": 0,
                     "int8_stem": 0, "add_layernorm": 0},
          f"CLI kernel launches {counts}")
    files = sorted(os.listdir(ckpt_dir))
    check(files == ["best.ckpt", "best_val.json", "last.ckpt"], f"checkpoints {files}")
    metrics = [f for f in os.listdir(run_dir)
               if f == "metrics.jsonl" or f.startswith("events.out.tfevents")]
    check(bool(metrics), f"no metrics file in {os.listdir(run_dir)}")
    train_loss, val_loss = logged_losses(lines)
    skipped = [ln for ln in lines if ln.startswith("summary render skipped")]
    log(f"CLI losses: train {train_loss}, val {val_loss}; metrics file {metrics[0]}; "
        f"summary grids: {skipped or 'rendered'} [{card}]")
    check(not skipped, f"CLI summary grid not rendered: {skipped}")
    # skinning launches a call of each kind, counted in the call it ran in
    per_call = cli.per_call()
    log(f"CLI skinning launches a call: {per_call} over {calls} calls and the set-up; "
        f"{where.count('other')} elsewhere [{card}]")
    passes = CLI_STEPS // CLI_VAL_EVERY
    check(calls == {"train": CLI_STEPS, "val": len(val) * passes, "grid": passes},
          f"CLI calls {calls}")
    check(per_call == {"train": 2 / CLI_STEPS, "val": 1, "grid": 1, "set-up": 1}
          and "other" not in where,
          f"CLI skinning launches a call {per_call}, elsewhere {where.count('other')}")
    check(sorted(train_loss) == [1, 10, 20] and sorted(val_loss) == [10, 20],
          f"CLI logged steps {sorted(train_loss)}, val {sorted(val_loss)}")
    check(all(np.isfinite(v) for v in (*train_loss.values(), *val_loss.values())),
          "non-finite CLI loss")
    check(train_loss[20] < train_loss[1], f"CLI training loss did not fall: {train_loss}")
    stamp = {int(ln.split()[1]): t for t, ln in out.lines
             if ln.startswith("step ") and " loss " in ln}
    cli_step_ms = (stamp[10] - stamp[1]) / 9 * 1e3
    log(f"CLI train step at B={CLI_BATCH} (steps 2-10, wall time between the trainer's synchronising "
        f"log points): {cli_step_ms:.3f} ms, phase 8's step {phase8_step_ms:.3f} ms: the "
        f"CLI's own overhead {cli_step_ms - phase8_step_ms:.3f} ms a step [{card}]")

    # the in-memory model against last.ckpt loaded with strict=True
    state = saved[-1]
    blob = torch.load(os.path.join(ckpt_dir, "last.ckpt"), map_location="cpu",
                      weights_only=True)
    check(blob["global_step"] == CLI_STEPS == state.step, f"last.ckpt at {blob['global_step']}")
    g = torch.Generator(device=dev).manual_seed(5)
    inputs = (torch.randn(8, 2, CLI_IMG, CLI_IMG, 3, device=dev, generator=g),
              torch.randn(8, 2, 3, device=dev, generator=g) * 0.1,
              torch.full((8, 2, 3), 0.5, device=dev))
    loaded = AirPoseTwoView(dtype=torch.bfloat16, seed=1).to(dev)
    ckpt_mod.load_reference_state_dict(loaded, blob, "copenet_twoview")
    memory = AirPoseTwoView(dtype=torch.bfloat16, seed=2).to(dev)
    with torch.no_grad():
        got = loaded(*inputs)
        want = torch.func.functional_call(memory, {**state.params, **state.batch_stats}, inputs)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"last.ckpt (step {blob['global_step']}) loaded with strict=True: eval forward "
        f"{'equal to' if same else 'DIFFERS from'} the in-memory model's "
        f"(max |diff| {max((a - b).abs().max().item() for a, b in zip(got, want)):.3e}) [{card}]")
    check(same, "the checkpoint's eval forward differs from the in-memory model's")
    del saved, state, loaded, memory, got, want
    torch.cuda.empty_cache()

    # the entry point a user calls, twice and at once: resuming at step 20 in
    # this run's directory, and preempted at once in a copy of it
    root = os.path.dirname(os.path.abspath(__file__))
    copy_dir = os.path.join(logs, "smoke", "version_1", "checkpoints")
    shutil.copytree(ckpt_dir, copy_dir)
    deadline_args = [a if a != "0" or args[i - 1] != "--version" else "1"
                     for i, a in enumerate(args)]
    cases = {"resume": (args + ["--max_steps", "30"], ckpt_dir, 0, 30),
             "deadline": (deadline_args + ["--max_steps", "40", "--time_to_run", "0"],
                          copy_dir, 3, 21)}
    t = time.perf_counter()
    procs = {}
    try:
        for name, (argv, _, _, _) in cases.items():
            err = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen([sys.executable, "-m", "airpose_tpu_torch.train.trainer",
                                     *argv], cwd=root, stdout=subprocess.PIPE, stderr=err,
                                    text=True)
            stamped = []
            reader = threading.Thread(target=lambda p=proc, out=stamped: out.extend(
                (time.perf_counter() - t, ln.rstrip("\n")) for ln in p.stdout), daemon=True)
            reader.start()
            procs[name] = (proc, err, reader, stamped)
        runs = {}
        for name, (proc, err, reader, stamped) in procs.items():
            rc = proc.wait(timeout=300)
            reader.join(timeout=30)
            secs = time.perf_counter() - t
            err.seek(0)
            argv, run_ckpts, rc_want, step_want = cases[name]
            step = torch.load(os.path.join(run_ckpts, "last.ckpt"), map_location="cpu",
                              weights_only=True)["global_step"]
            start_s, first = next(((s_, ln) for s_, ln in stamped if ln.startswith("step ")),
                                  (secs, ""))
            log(f"CLI subprocess ({name}: {' '.join(argv[-4:])}): exit {rc} after {secs:.1f} s "
                f"({start_s:.1f} s to the first logged step), last.ckpt at step {step}; "
                f"output: {' | '.join(ln for _, ln in stamped[-4:])} [{card}]")
            if rc != rc_want:
                log(err.read()[-3000:])
            check(rc == rc_want and step == step_want,
                  f"CLI {name}: exit {rc}, step {step}; expected {rc_want}, {step_want}")
            check(first.startswith("step 21 loss"), f"CLI {name} did not resume at step 20: "
                  f"{first!r}")
            runs[name] = {"exit": rc, "last_step": step, "seconds": secs,
                          "first_line_s": start_s}
    finally:
        for proc, err, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    return {"seconds": run_s, "first_line_s": first_s, "save_s": save_s,
            "summary_s": summary_s, "skinning_bodies": bodies, "launches": counts,
            "launches_per_call": per_call,
            "train_loss": train_loss, "val_loss": val_loss, "step_ms": cli_step_ms,
            "phase8_step_ms": phase8_step_ms, "subprocess": runs}


def pipeline_host_batch(i, context_scale, base):
    """Host batch i in the readers' layout at B = 30, two views of 672²
    uint8 context: ``base`` shifted by i, metadata from seed 1000 + i."""
    rng = np.random.default_rng(1000 + i)
    B, S = base.shape[0], base.shape[2]
    ext = rng.uniform(S // 2, S, (B, 2, 2)).astype(np.float32)
    lo = rng.uniform(0, 0.3, (B, 2, 2)).astype(np.float32) * ext
    hi = lo + rng.uniform(0.3, 0.6, (B, 2, 2)).astype(np.float32) * ext
    return {
        "context": base + np.uint8(i),
        "context_extent": ext,
        "context_origin": rng.uniform(0, 800, (B, 2, 2)).astype(np.float32),
        "context_scale": np.full((B, 2), context_scale, np.float32),
        "person_box": np.concatenate([lo, hi], -1),
        "intr": np.tile(np.asarray([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]],
                                   np.float32), (B, 2, 1, 1)),
        "gt_j2d": rng.uniform(0, 1500, (B, 2, 24, 2)).astype(np.float32),
        "gt_j2d_conf": rng.uniform(0, 1500, (B, 2, 25, 3)).astype(np.float32),
    }


def phase_pipeline(dev, card):
    """Phase 10, the input pipeline: finish_batch on the card against the
    CPU, then a 4-worker Prefetcher against the main thread."""
    from airpose_tpu_torch.data.pipeline import Prefetcher, crop_resize_pad, finish_batch

    base = np.random.default_rng(7).integers(0, 256, (30, 2, 672, 672, 3)).astype(np.uint8)
    out = {}
    for cs in (1.0, 2.0):
        hb = pipeline_host_batch(int(cs), cs, base)
        got = finish_batch(hb, None, deterministic=True, device=dev)
        want = finish_batch(hb, None, deterministic=True, device="cpu")
        img = (got["images"].cpu() - want["images"]).abs().max().item()
        rel = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
               for k in ("bb", "gt_j2d_crop", "gt_j2d_crop_conf")}
        log(f"finish_batch card vs CPU, B=30 of 672², context_scale {cs:g}: images max abs "
            f"{img:.3e} (bound {PIPE_IMG_ATOL}), relative {rel} (bound {PIPE_GEOM_REL}) [{card}]")
        check(set(got) == set(want), f"finish_batch keys {sorted(got)} vs {sorted(want)}")
        check(img <= PIPE_IMG_ATOL and all(r <= PIPE_GEOM_REL for r in rel.values()),
              f"finish_batch on the card disagrees with the CPU: {img}, {rel}")
        out[f"context_scale_{cs:g}"] = {"images_max_abs": img, **rel}
    batch_ms = wall_ms(lambda: finish_batch(hb, None, deterministic=True, device=dev),
                       iters=5, warmup=1)
    ctx = torch.from_numpy(base).to(dev).reshape(60, 672, 672, 3)
    boxes = got["bb"].new_tensor([[100.0, 80.0, 400.0, 500.0]]).expand(60, 4).contiguous()
    crop_ms = time_ms(lambda: crop_resize_pad(ctx, boxes))
    log(f"finish_batch at B=30: {batch_ms:.3f} ms a batch with the 81 MB upload (wall), "
        f"crop_resize_pad {crop_ms:.3f} ms of device time for 60 crops [{card}]")

    count = {}

    def make_batch(wid):
        count[wid] = count.get(wid, 0) + 1
        i = 10 * (wid + 1) + count[wid]
        b = finish_batch(pipeline_host_batch(i, 2.0, base), None, deterministic=True,
                         device=dev)
        b["tag"] = np.asarray([i])
        return b

    pf = Prefetcher.from_factory(make_batch, num_workers=4, device=dev, host_keys=("tag",))
    got = [next(pf) for _ in range(8)]
    pf.close()
    tags = [int(b["tag"][0]) for b in got]
    for b in got:
        want = finish_batch(pipeline_host_batch(int(b["tag"][0]), 2.0, base), None,
                            deterministic=True, device=dev)
        check(set(b) - {"tag"} == set(want) and all(torch.equal(b[k], want[k]) for k in want),
              f"Prefetcher batch {b['tag']} differs from the main thread's")
    log(f"Prefetcher, 4 workers: batches {tags} from workers "
        f"{sorted({t // 10 - 1 for t in tags})} equal the main thread's, key for key [{card}]")
    check(len(set(tags)) == 8, f"Prefetcher tags {tags}")
    return {**out, "finish_batch_ms": batch_ms, "crop_resize_pad_ms": crop_ms,
            "prefetcher_tags": tags}


def write_aerialpeople(root, n):
    """An AerialPeople layout of n sample pkls (sample 0 passes the schema
    check) with empty image files for the path probe (phase 10 fills the
    windows from a seed; phase 12 writes them, write_aerialpeople_windows)."""
    rng = np.random.default_rng(0)
    for d in ("dataset", "pkls", "imgs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    K = np.asarray([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]], np.float32)
    files = []
    for i in range(n):
        rec = {"smplpose": (rng.normal(size=63) * 0.2).astype(np.float32),
               "smplshape": (rng.normal(size=10) * 0.3).astype(np.float32),
               "smplgender": "male", "smplorient_rotmat_wrt_origin": np.eye(3, dtype=np.float32),
               "smpltrans": np.asarray([0.3, 0.1, 0.2], np.float32),
               "smpl_joints_wrt_origin": (rng.normal(size=(127, 3)) * 0.4).astype(np.float32),
               "smpl_vertices_wrt_origin": np.zeros((1, 3), np.float32)}
        for cam, ang in ((0, 0.2), (1, -0.3)):
            c, s_ = np.cos(ang), np.sin(ang)
            R = np.asarray([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
            rec[f"cam{cam}"] = {"intr": K, "extr": np.concatenate(
                [R, np.asarray([[0.0], [0.0], [8.0]], np.float32)], 1)}
            x0, y0 = rng.uniform(700, 1000), rng.uniform(300, 500)
            rec[f"bb{cam}"] = np.asarray([[x0, y0], [x0 + rng.uniform(100, 250),
                                                     y0 + rng.uniform(150, 250)]], np.float32)
            rec[f"im{cam}"] = f"imgs/{i}_{cam}.jpg"
            open(os.path.join(root, rec[f"im{cam}"]), "wb").close()
        files.append(os.path.join(root, "pkls", f"{i}.pkl"))
        with open(files[-1], "wb") as f:
            pickle.dump(rec, f)
    for split in ("train", "test"):
        with open(os.path.join(root, "dataset", f"{split}_pkls.pkl"), "wb") as f:
            pickle.dump(files, f)


def write_aerialpeople_windows(root):
    """Each sample's two image files as the JPEGs the AerialPeople layout
    stores: the person box ±200 px window, a smooth pattern from a seed."""
    import cv2

    rng = np.random.default_rng(12)
    files = pickle.load(open(os.path.join(root, "dataset", "test_pkls.pkl"), "rb"))
    for path in files:
        rec = pickle.load(open(path, "rb"))
        for cam in (0, 1):
            (x0, y0), (x1, y1) = np.asarray(rec[f"bb{cam}"], np.float32)
            w, h = int(x1 - x0) + 400, int(y1 - y0) + 400
            coarse = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(root, rec[f"im{cam}"]),
                        cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR))


def phase_readers(dev, tmp, smplx_params, card):
    """Phase 10, the readers' device part on an AerialPeople fixture."""
    from airpose_tpu_torch.bodymodel import cuda_lbs, smplx_forward
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import AerialPeopleDataset
    from airpose_tpu_torch.data.pipeline import finish_batch
    from airpose_tpu_torch.geometry import batch_rodrigues
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns

    root = os.path.join(tmp, "aerialpeople")
    write_aerialpeople(root, AERIAL_RECORDS)
    ds = AerialPeopleDataset(root, "train")
    reset_kernel_counts()
    t = time.perf_counter()
    cache = ds.precompute_canonical_gt(smplx_params)
    secs = time.perf_counter() - t
    counts = kernel_counts()
    n = AERIAL_RECORDS
    with torch.no_grad():
        plain = smplx_forward(
            smplx_params, torch.from_numpy(cache["betas"]).to(dev),
            body_pose=batch_rodrigues(torch.from_numpy(cache["pose_aa"]).to(dev).reshape(n, 21, 3)),
            global_orient=torch.eye(3, device=dev).expand(n, 1, 3, 3), use_kernels=False)
    rel = {k: (np.abs(cache[k] - getattr(plain, k).cpu().numpy()).max()
               / np.abs(getattr(plain, k).cpu().numpy()).max()).item()
           for k in ("vertices", "joints")}
    chunks = -(-n // 256)
    log(f"precompute_canonical_gt, {n} bodies in chunks of 256: {secs:.2f} s (pkl reads "
        f"included), launches {counts}; kernel vs plain skinning, max relative {rel} "
        f"(bound {CANON_REL}) [{card}]")
    check(counts == {"lbs_skinning": chunks, "fused_stage1": 0, "int8_conv": 0,
                     "int8_stem": 0, "add_layernorm": 0},
          f"precompute launches {counts}, expected {chunks} skinning")
    check(all(r <= CANON_REL for r in rel.values()), f"canonical GT with the kernel: {rel}")

    idx = list(range(CLI_BATCH))
    hb = ds.host_batch(idx, np.random.default_rng(0), decode_images=False)
    S = ds.context_size
    hb["context"] = np.random.default_rng(1).integers(0, 256, hb["context"].shape).astype(np.uint8)
    hb["context_extent"] = np.minimum(hb["person_box"][..., 2:] + 200.0, S)
    gt = ds.canonical_gt(idx)
    hb["gt_vertices"], hb["gt_joints"] = gt["vertices"], gt["joints"]
    hb["gt_j2d"] = hb["gt_j2d"][:, :, :22]
    batch = finish_batch(hb, torch.Generator(device=dev).manual_seed(0), out_size=CLI_IMG,
                         device=dev)
    cfg = TrainConfig()
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=0).to(dev)
    state, tx = create_train_state(model, cfg.lr)
    train_step, _ = make_twoview_step_fns(model, smplx_params, cfg, tx, device=dev)
    reset_kernel_counts()
    state, metrics = train_step(state, batch, torch.Generator(device=dev).manual_seed(1))
    loss = metrics["loss"].item()
    step_counts = kernel_counts()
    log(f"AerialPeople host_batch(decode_images=False) → finish_batch → one train step at "
        f"B={CLI_BATCH}: loss {loss:.1f}, launches {step_counts} [{card}]")
    check(np.isfinite(loss) and step_counts["lbs_skinning"] == 1,
          f"AerialPeople step: loss {loss}, launches {step_counts}")
    return {"precompute_s": secs, "precompute_launches": counts["lbs_skinning"],
            "canonical_rel": rel, "step_loss": loss}


def real_batch(ds, idx, dev):
    """The trainer's real:// batch of frames ``idx`` of ``ds`` on ``dev``:
    host_batch (60 JPEG decodes of 1920×1080) → finish_batch, the first 22
    keypoints and the DJI focal lengths."""
    from airpose_tpu_torch import constants as C
    from airpose_tpu_torch.data.pipeline import finish_batch

    b = finish_batch(ds.host_batch(idx, np.random.default_rng(0)), None, deterministic=True,
                     margin=0.0, out_size=CLI_IMG, device=dev)
    b["gt_j2d_conf"] = b["gt_j2d_conf"][:, :, :22]
    b["focal"] = torch.tensor([C.REAL_FOCAL_LENGTH0, C.REAL_FOCAL_LENGTH1], device=dev)
    return b


def phase_real_data(dev, root, card):
    """Phase 11 (a)-(b): VPoser encode/decode on the card against the CPU at
    60 bodies; the DJI reader's host_batch → finish_batch on the card against
    the CPU at B = 30 of the capture's 1920×1080 frames, with the host's
    decode time."""
    from airpose_tpu_torch.bodymodel import init_vposer_params, vposer_decode, vposer_encode
    from airpose_tpu_torch.data import CopenetRealDataset
    from airpose_tpu_torch.data.pipeline import finish_batch

    params = init_vposer_params(0)
    rng = np.random.default_rng(21)
    pose = torch.from_numpy(rng.normal(size=(2 * CLI_BATCH, 63)).astype(np.float32) * 0.4)
    z = torch.from_numpy(rng.normal(size=(2 * CLI_BATCH, 32)).astype(np.float32))
    names = ("mu", "sigma", "pose_body", "pose_body_matrot")

    def vposer(p, device):
        with torch.no_grad():
            return (*vposer_encode(p, pose.to(device)),
                    *vposer_decode(p, z.to(device)).values())
    want, got = vposer(params, "cpu"), vposer(params.to(dev), dev)
    vrel = {n: ((g.cpu() - w).abs().max() / w.abs().max()).item()
            for n, g, w in zip(names, got, want)}
    bounds = dict(zip(names, (VPOSER_ENCODE_REL,) * 2 + (VPOSER_DECODE_REL,) * 2))
    log(f"VPoser (63 → 512 → 512 → 512 → 32; 32 → 512 → 512 → 126) at {2 * CLI_BATCH} bodies, "
        f"card vs CPU: max relative {vrel} (bounds {bounds}) [{card}]")
    check(all(vrel[n] <= bounds[n] for n in names), f"VPoser on the card: {vrel}")

    ds = CopenetRealDataset(root, frame_range=range(0, REAL_TRAIN_FRAMES))
    idx = np.random.default_rng(3).integers(0, len(ds), CLI_BATCH)
    hb = ds.host_batch(idx, np.random.default_rng(0))
    t = time.perf_counter()
    for _ in range(3):
        ds.host_batch(idx, np.random.default_rng(0))
    host_ms = (time.perf_counter() - t) / 3 * 1e3
    got = finish_batch(hb, None, deterministic=True, margin=0.0, out_size=CLI_IMG, device=dev)
    want = finish_batch(hb, None, deterministic=True, margin=0.0, out_size=CLI_IMG,
                        device="cpu")
    img = (got["images"].cpu() - want["images"]).abs().max().item()
    rel = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
           for k in ("bb", "gt_j2d_crop_conf")}
    finish_ms = wall_ms(lambda: finish_batch(hb, None, deterministic=True, margin=0.0,
                                             out_size=CLI_IMG, device=dev), iters=5, warmup=1)
    log(f"DJI reader: {len(ds)} frames of {ds.frame_wh}; host_batch at B={CLI_BATCH} "
        f"({2 * CLI_BATCH} JPEG decodes and crops) {host_ms:.1f} ms on the host, finish_batch "
        f"{finish_ms:.3f} ms; finish_batch card vs CPU: images max abs {img:.3e} (bound "
        f"{PIPE_IMG_ATOL}), relative {rel} (bound {PIPE_GEOM_REL}) [{card}]")
    check(ds.frame_wh == (1920, 1080) and len(ds) == REAL_TRAIN_FRAMES,
          f"DJI reader: {len(ds)} frames of {ds.frame_wh}")
    check(set(got) == set(want), f"finish_batch keys {sorted(got)} vs {sorted(want)}")
    check(img <= PIPE_IMG_ATOL and all(r <= PIPE_GEOM_REL for r in rel.values()),
          f"the real batch on the card disagrees with the CPU: {img}, {rel}")
    return ds, idx, {"vposer_rel": vrel, "host_batch_ms": host_ms, "finish_batch_ms": finish_ms,
                     "images_max_abs": img, **rel}


@contextlib.contextmanager
def skinning_bodies():
    """The bodies of each skinning launch made inside the block."""
    from airpose_tpu_torch.bodymodel import cuda_lbs

    bodies, launch = [], cuda_lbs._launch

    def counted(w, a, p):
        bodies.append(a.shape[0])
        return launch(w, a, p)

    with mock.patch.object(cuda_lbs, "_launch", counted):
        yield bodies


def real_twoview_steps(model, smplx_params, vposer, cfg):
    """make_steps (phase 8's kernel_vs_plain_step) for the real two-view
    steps."""
    from airpose_tpu_torch.train import make_real_twoview_step_fns

    def make_steps(tx, use_kernels):
        return make_real_twoview_step_fns(model, smplx_params, vposer, cfg, tx,
                                          use_kernels=use_kernels)
    return make_steps


def train_counted(train_step, state, batch, gen, what, bodies_a_step, views=None):
    """REAL_STEPS steps on one batch, skinning ``bodies_a_step`` bodies once
    at each eager first call and capture of a view's step object, not at a
    replay; ``views`` alternates the step's view. → the losses."""
    losses = []
    want = graph_launches(REAL_STEPS, 1 if views is None else len(views))
    for i in range(REAL_STEPS):
        extra = () if views is None else (views[i % len(views)],)
        with skinning_bodies() as bodies:
            state, metrics = train_step(state, batch, gen, *extra)
        losses.append(metrics["loss"].item())
        check(bodies == [bodies_a_step] * want[i], f"{what} step {i} skinned {bodies}, expected "
              f"{[bodies_a_step] * want[i]}")
    check(bool(np.isfinite(losses).all()), f"non-finite {what} loss {losses}")
    return losses


def eval_vertices_agree(smplx_params, rotmat, betas, what, card):
    """The canonical skinned vertices of eval_step's predictions (rotmat
    (B, V, 22, 3, 3), betas (B, V, 10)) with the kernel, one launch of B·V
    bodies, against the plain skinning."""
    from airpose_tpu_torch.train import canonical_smplx_two_view

    with torch.no_grad():
        with skinning_bodies() as bodies:
            got, _ = canonical_smplx_two_view(smplx_params, betas, rotmat)
        want, _ = canonical_smplx_two_view(smplx_params, betas, rotmat, use_kernels=False)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    n = rotmat.shape[0] * rotmat.shape[1]
    log(f"{what} eval_step predictions: skinned vertices with the kernel ({bodies} bodies) vs "
        f"plain, max relative {rel:.3e} (bound {CANON_REL}) [{card}]")
    check(bodies == [n] and rel <= CANON_REL,
          f"{what} eval vertices: skinned {bodies}, kernel vs plain {rel}")
    return rel


def phase_real_steps(dev, smplx_params, batch, card):
    """Phase 11 (c)-(d): the real two-view step (bf16 AirPoseTwoView, seed
    0), kernel step against plain step (a determinism check, REAL_BOUNDS),
    then REAL_STEPS steps on one batch with the loss falling and its ms,
    and its eval vertices kernel against plain; the same for the
    hmr_camswap_difffl step on each view, with REAL_STEPS steps
    alternating the view; the per-drone model's real step, kernel step
    against plain step."""
    from airpose_tpu_torch.bodymodel import init_vposer_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.geometry import rot6d_to_rotmat
    from airpose_tpu_torch.models import HMR, AirPoseTwoView, AirPoseTwoViewSep
    from airpose_tpu_torch.train import create_train_state, make_real_singleview_step_fns

    vposer = init_vposer_params(0).to(dev)
    B = batch["images"].shape[0]
    out = {}
    cfg = TrainConfig()
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=0).to(dev)
    make_steps = real_twoview_steps(model, smplx_params, vposer, cfg)
    agree = kernel_vs_plain_step(model, make_steps, cfg, batch, REAL_BOUNDS,
                                 "real two-view, bf16 trunk (determinism check)")
    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_steps(tx, True)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    losses = train_counted(train_step, state, batch, gen, "real two-view", 2 * B)
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"the real two-view loss did not fall: {losses}")
    metrics, preds = eval_step(state, batch)
    check(tuple(preds.pose.shape) == (B, 2, 135) and bool(torch.isfinite(preds.pose).all())
          and bool(torch.isfinite(metrics["loss"])), f"real eval_step pose {preds.pose.shape}")
    vertices_rel = eval_vertices_agree(
        smplx_params, rot6d_to_rotmat(preds.pose[..., 3:].reshape(B, 2, 22, 6)), preds.betas,
        "real two-view", card)
    # the step as the trainer feeds it, then with the batch's images made
    # contiguous: finish_batch hands them over (B, V, H, C, W)-strided
    timing = {}
    for layout, b in (("as finished", batch),
                      ("contiguous", {**batch, "images": batch["images"].contiguous()})):
        ms = wall_ms(lambda: train_step(state, b, gen), iters=10, warmup=2)
        events, _ = device_work(lambda: train_step(state, b, gen), 3)
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / 3
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        timing[layout] = {"step_ms": ms, "busy_ms": busy, "device_events_per_step":
                          len(events) / 3, "idle_share": 1 - busy / ms}
        log(f"real two-view step, images {layout} (strides {tuple(b['images'].stride())}): "
            f"{ms:.3f} ms, device busy {busy:.3f} ms in {len(events) / 3:.0f} kernels and "
            f"copies, idle share {1 - busy / ms:.3f}; top device time a step: "
            + "; ".join(f"{t:.3f} ms {n[:70]}" for n, t in top) + f" [{card}]")
    step_ms = timing["as finished"]["step_ms"]
    log(f"real two-view: {REAL_STEPS} steps at B={B}, losses {[round(x, 1) for x in losses]}; "
        f"{step_ms:.3f} ms a step, {B / step_ms * 1e3:.1f} frames/s; eval loss "
        f"{metrics['loss'].item():.1f} [{card}]")
    out["twoview"] = {"step_determinism": agree, "losses": losses, **timing["as finished"],
                      "frames_per_s": B / step_ms * 1e3, "contiguous_images": timing["contiguous"],
                      "skinning_bodies_a_step": 2 * B, "eval_vertices_rel": vertices_rel}
    del model, state, tx, train_step, eval_step, make_steps

    cfg = TrainConfig(model="hmr")
    model = HMR(dtype=torch.bfloat16, seed=0).to(dev)
    agree = {}
    for view in (0, 1):
        def view_steps(tx, use_kernels, view=view):
            step, ev = make_real_singleview_step_fns(model, smplx_params, vposer, cfg, tx,
                                                     "hmr_camswap_difffl",
                                                     use_kernels=use_kernels)
            return (lambda state, batch, gen: step(state, batch, gen, view)), ev
        agree[f"view {view}"] = kernel_vs_plain_step(
            model, view_steps, cfg, batch, REAL_BOUNDS, f"hmr_camswap_difffl view {view}, "
            "bf16 trunk (determinism check)")
    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_real_singleview_step_fns(model, smplx_params, vposer, cfg, tx,
                                                          "hmr_camswap_difffl")
    losses = train_counted(train_step, state, batch, gen, "hmr_camswap_difffl", B, views=(0, 1))
    check(np.mean(losses[-4:]) < np.mean(losses[:4]),
          f"the hmr_camswap_difffl loss did not fall: {losses}")
    _, preds = eval_step(state, batch)
    vertices_rel = eval_vertices_agree(
        smplx_params, rot6d_to_rotmat(preds.pose6d.reshape(B, 1, 22, 6)), preds.betas[:, None],
        "hmr_camswap_difffl", card)
    # timed on a fresh model, alternating views as above: the weak camera's barrier
    # exp(−t_z)², t_z = 2f/(res·s), overflows once a predicted scale s turns
    # negative, as the JAX package's objective does; on this one batch the step after
    # the 10 above was measured inf on the H100, so the timed steps start afresh and
    # their losses are checked finite
    del model, state, tx, train_step, eval_step
    model = HMR(dtype=torch.bfloat16, seed=0).to(dev)
    state, tx = create_train_state(model, cfg.lr)
    train_step, _ = make_real_singleview_step_fns(model, smplx_params, vposer, cfg, tx,
                                                  "hmr_camswap_difffl")
    timed = []
    step_ms = wall_ms(lambda: timed.append(
        train_step(state, batch, gen, len(timed) % 2)[1]["loss"]), iters=5, warmup=1)
    timed = [x.item() for x in timed]
    check(bool(np.isfinite(timed).all()), f"non-finite timed hmr_camswap_difffl loss {timed}")
    log(f"hmr_camswap_difffl: {REAL_STEPS} steps at B={B} alternating views 0/1, losses "
        f"{[round(x, 1) for x in losses]}; {step_ms:.3f} ms a step from a fresh model, its "
        f"losses {[round(x, 1) for x in timed]} [{card}]")
    out["hmr_camswap_difffl"] = {"step_determinism": agree, "losses": losses,
                                 "step_ms": step_ms, "timed_losses": timed,
                                 "skinning_bodies_a_step": B,
                                 "eval_vertices_rel": vertices_rel}
    del model, state, tx, train_step

    cfg = TrainConfig(model="copenet_twoview_sep")
    model = AirPoseTwoViewSep(dtype=torch.bfloat16, seed=0).to(dev)
    make_steps = real_twoview_steps(model, smplx_params, vposer, cfg)
    agree = kernel_vs_plain_step(model, make_steps, cfg, batch, REAL_BOUNDS,
                                 "real copenet_twoview_sep, bf16 trunks (determinism check)")
    state, tx = create_train_state(model, cfg.lr)
    train_step, _ = make_steps(tx, True)
    with skinning_bodies() as bodies:
        _, metrics = train_step(state, batch, gen)
    check(bodies == [2 * B] and bool(torch.isfinite(metrics["loss"])),
          f"real copenet_twoview_sep step: skinned {bodies}, loss {metrics['loss'].item()}")
    out["copenet_twoview_sep"] = {"step_determinism": agree, "skinning_bodies_a_step": bodies[0]}
    del model, state, tx, train_step, make_steps
    torch.cuda.empty_cache()
    return out


def trunk_tensors(state_dict):
    """The ResNet-50 trunk's parameters in a reference-layout state dict."""
    return {k: v for k, v in state_dict.items()
            if k.startswith(("model.conv1", "model.bn1", "model.layer"))
            and "running" not in k and "num_batches" not in k}


def phase_real_cli(tmp, root, card, phase8_step_ms, pretrained):
    """Phase 11 (e): trainer.main in-process on real:// (copenet_twoview,
    B = 30 of 224², REAL_STEPS steps, val at the end), skinning counted in
    the call each launch ran in; then the README's chain: a 2-step
    --train_reg_only fine-tune from ``pretrained`` whose trunk stays
    bit-equal to it while the heads move."""
    logs = os.path.join(tmp, "real_logs")
    args = ["--version", "0", "--model", "copenet_twoview", "--datapath", f"real://{root}",
            "--train_frames", "0", str(REAL_TRAIN_FRAMES), "--test_frames",
            str(REAL_TRAIN_FRAMES), str(REAL_TRAIN_FRAMES + REAL_TEST_FRAMES),
            "--log_dir", logs, "--batch_size", str(CLI_BATCH), "--val_batch_size",
            str(CLI_BATCH), "--img_res", str(CLI_IMG)]
    cli = CliRun("make_real_twoview_step_fns")
    out, run_s = cli.run(args + ["--name", "real", "--max_steps", str(REAL_STEPS),
                                 "--val_every", str(REAL_STEPS)])
    lines = [line for _, line in out.lines]
    train_loss, val_loss = logged_losses(lines)
    skipped = [ln for ln in lines if ln.startswith("summary render skipped")]
    # the eager and the captured train step; one val batch of the 30 test
    # frames, 60 bodies; the grid after it
    want = [2 * CLI_BATCH] * sum(graph_launches(REAL_STEPS)) + [2 * REAL_TEST_FRAMES, 2]
    per_call = cli.per_call()
    counts = kernel_counts()
    log(f"CLI real:// in-process: returned after {run_s:.1f} s; skinning by bodies "
        f"{cli.bodies}; launches a call {per_call} over {cli.calls}; kernel launches {counts}; "
        f"{len(cli.save_s)} checkpoint saves {sum(cli.save_s):.1f} s, grid "
        f"{sum(cli.summary_s):.1f} s; losses train {train_loss}, val {val_loss}; summary grid "
        f"{skipped or 'rendered'} [{card}]")
    check(cli.bodies == want, f"real CLI skinning launches by bodies {cli.bodies}, expected "
          f"{want}")
    check(cli.calls == {"train": REAL_STEPS, "val": 1, "grid": 1}, f"real CLI calls {cli.calls}")
    check(per_call == {"train": 2 / REAL_STEPS, "val": 1, "grid": 1, "set-up": 0}
          and "other" not in cli.where, f"real CLI skinning launches a call {per_call}")
    check(counts == {"lbs_skinning": len(want), "fused_stage1": 0, "int8_conv": 0,
                     "int8_stem": 0, "add_layernorm": 0},
          f"real CLI kernel launches {counts}")
    check(not skipped, f"real CLI summary grid not rendered: {skipped}")
    files = sorted(os.listdir(os.path.join(logs, "real", "version_0", "checkpoints")))
    check(files == ["best.ckpt", "best_val.json", "last.ckpt"], f"real CLI checkpoints {files}")
    check(sorted(train_loss) == [1, REAL_STEPS] and sorted(val_loss) == [REAL_STEPS]
          and all(np.isfinite(v) for v in (*train_loss.values(), *val_loss.values())),
          f"real CLI losses {train_loss}, {val_loss}")
    stamp = {int(ln.split()[1]): t for t, ln in out.lines
             if ln.startswith("step ") and " loss " in ln}
    cli_step_ms = (stamp[REAL_STEPS] - stamp[1]) / (REAL_STEPS - 1) * 1e3
    log(f"CLI real:// train step at B={CLI_BATCH} (steps 2-{REAL_STEPS}, wall time between "
        f"the trainer's synchronising log points; the trainer's 4 workers decoding "
        f"{2 * CLI_BATCH} JPEGs a batch): "
        f"{cli_step_ms:.3f} ms, phase 8's step {phase8_step_ms:.3f} ms [{card}]")

    ft = CliRun("make_real_twoview_step_fns")
    _, ft_s = ft.run(args + ["--name", "real_ft", "--max_steps", "2", "--val_every", "2",
                             "--pretrained_checkpoint", pretrained, "--train_reg_only"])
    ft_want = [2 * CLI_BATCH] * 2 + [2 * REAL_TEST_FRAMES, 2]
    a = torch.load(pretrained, map_location="cpu", weights_only=True)["state_dict"]
    b = torch.load(os.path.join(logs, "real_ft", "version_0", "checkpoints", "last.ckpt"),
                   map_location="cpu", weights_only=True)["state_dict"]
    trunk = trunk_tensors(a)
    kept = sum(torch.equal(v, b[k]) for k, v in trunk.items())
    heads = [k for k in a if k.startswith(("model.fc1", "model.fc2", "model.decpose",
                                           "model.decshape"))]
    moved = sum(not torch.equal(a[k], b[k]) for k in heads)
    log(f"CLI real:// --train_reg_only from {os.path.basename(pretrained)} (2 steps): "
        f"{ft_s:.1f} s, skinning by bodies {ft.bodies}; trunk tensors bit-equal {kept} of "
        f"{len(trunk)}, head tensors moved {moved} of {len(heads)} [{card}]")
    check(ft.bodies == ft_want, f"reg-only skinning launches by bodies {ft.bodies}")
    check(len(trunk) == 159 and kept == len(trunk), f"reg-only: trunk kept {kept}/{len(trunk)}")
    check(len(heads) > 0 and moved == len(heads),
          f"reg-only: heads moved {moved}/{len(heads)}")
    return {"seconds": run_s, "skinning_bodies": cli.bodies, "launches_per_call": per_call,
            "launches": counts["lbs_skinning"], "save_s": cli.save_s,
            "summary_s": cli.summary_s, "train_loss": train_loss, "val_loss": val_loss,
            "step_ms": cli_step_ms, "phase8_step_ms": phase8_step_ms,
            "reg_only": {"seconds": ft_s, "launches": len(ft.bodies), "trunk_kept": kept,
                         "heads_moved": moved, "heads": len(heads)}}


def phase_real(dev, tmp, card, smplx_params, phase8_step_ms, pretrained):
    """Phase 11, the real-data self-supervised fine-tune on a synthetic DJI
    capture of REAL_TRAIN_FRAMES + REAL_TEST_FRAMES 1920×1080 frames."""
    from airpose_tpu_torch.data.fake_real import write_fake_real_capture

    root = os.path.join(tmp, "capture")
    t = time.perf_counter()
    write_fake_real_capture(root, REAL_TRAIN_FRAMES + REAL_TEST_FRAMES)
    log(f"synthetic DJI capture: {REAL_TRAIN_FRAMES + REAL_TEST_FRAMES} frames a machine "
        f"written in {time.perf_counter() - t:.1f} s")
    ds, idx, data = phase_real_data(dev, root, card)
    batch = real_batch(ds, idx, dev)
    steps = phase_real_steps(dev, smplx_params, batch, card)
    del batch
    return {"data": data, "steps": steps,
            "cli": phase_real_cli(tmp, root, card, phase8_step_ms, pretrained)}


def eval_model(dev, family, ckpt=None):
    """A family's f32 model, as compile_results.main builds it (seed 0, or
    ``ckpt`` loaded with strict=True), and its eval TrainState."""
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.models import MODEL_REGISTRY
    from airpose_tpu_torch.train import TrainState, load_reference_state_dict
    from airpose_tpu_torch.train.state import model_variables

    model = MODEL_REGISTRY[family](iters=TrainConfig().reg_iters)
    if ckpt:
        load_reference_state_dict(model, torch.load(ckpt, map_location="cpu",
                                                    weights_only=False), family)
    model = model.to(dev)
    return model, TrainState(step=0, **model_variables(model), opt_state=None)


def body_rel(got, want):
    """max |kernel − plain| / max |plain| over the outputs' body fields
    (skinned vertices, cam-frame joints and their projections)."""
    rel = 0.0
    for g, w in zip(got, want):
        for k, v in w["output"].items():
            if k.startswith(("pred_vertices", "pred_j3d", "pred_j2d")):
                rel = max(rel, float(np.abs(g["output"][k] - v).max() / np.abs(v).max()))
    return rel


def phase_eval_passes(dev, tmp, card):
    """Phase 12a: each compile pass with the skinning kernel (its launches
    by bodies, the int8 conv's launches and its seconds) and again with the
    plain skinning, in one process; the int8 features against the plain
    int8 trunk."""
    import airpose_tpu_torch.eval.compile_results as cr
    from airpose_tpu_torch.bodymodel import init_vposer_params, load_smplx_npz
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import (AerialPeopleDataset, CopenetRealDataset,
                                        make_synthetic_dataset)
    from airpose_tpu_torch.ops import int8_trunk as it

    smplx = load_smplx_npz(tmp).to(dev)   # phase 10's 10,475-vertex npz
    vposer = init_vposer_params(0).to(dev)
    ckpt = os.path.join(tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt")
    capture = os.path.join(tmp, "capture")
    B, RB = CLI_BATCH, REAL_EVAL_BATCH
    cfg = TrainConfig(batch_size=B)
    twoview, twoview_state = eval_model(dev, "copenet_twoview", ckpt)
    hmr, hmr_state = eval_model(dev, "hmr")

    t = time.perf_counter()
    write_aerialpeople_windows(os.path.join(tmp, "aerialpeople"))
    log(f"AerialPeople fixture: its windows written as JPEGs in {time.perf_counter() - t:.1f} s")
    aerial = AerialPeopleDataset(os.path.join(tmp, "aerialpeople"), "test")
    n_aerial = len(aerial)
    with skinning_bodies() as bodies:
        aerial.precompute_canonical_gt(smplx)
    chunks = [min(256, n_aerial - s) for s in range(0, n_aerial, 256)]
    check(bodies == chunks, f"precompute_canonical_gt skinned {bodies}, expected {chunks}")
    synthetic = make_synthetic_dataset(smplx, CLI_SAMPLES, seed=7)   # main's synthetic://64
    real = CopenetRealDataset(capture, frame_range=range(REAL_TRAIN_FRAMES,
                                                         REAL_TRAIN_FRAMES + REAL_TEST_FRAMES))
    real_cams = [CopenetRealDataset(capture, first_cam=cam, frame_range=real.frames)
                 for cam in (0, 1)]

    def batches(n, b):
        return -(-n // b)

    nb = batches(n_aerial, B)
    full_aerial = [2 * B] * 3 * nb + [2 * n_aerial] * 2   # loss, 2 body fields; metrics
    nr = batches(REAL_TEST_FRAMES, RB)
    passes = {
        "compile_twoview AerialPeople --save-full": (
            lambda uk: cr.compile_twoview(twoview_state, twoview, smplx,
                                          cr.aerialpeople_batches(aerial, B, CLI_IMG, dev), cfg,
                                          save_full=True, use_kernels=uk, device=dev),
            n_aerial, full_aerial, 0),
        "compile_twoview AerialPeople --save-full --int8": (
            lambda uk: cr.compile_twoview(twoview_state, twoview, smplx,
                                          cr.aerialpeople_batches(aerial, B, CLI_IMG, dev), cfg,
                                          save_full=True, int8=True, use_kernels=uk, device=dev),
            n_aerial, full_aerial, 52 * (2 + nb)),   # calibration, clip report, each batch
        "compile_singleview hmr synthetic://64": (
            lambda uk: cr.compile_singleview(hmr_state, hmr, smplx,
                                             cr.synthetic_batches(synthetic, B), cfg, "hmr",
                                             use_kernels=uk, device=dev),
            CLI_SAMPLES, [B] * batches(CLI_SAMPLES, B) + [CLI_SAMPLES] * 2, 0),
        "compile_real_twoview real:// --save-full": (
            lambda uk: cr.compile_real_twoview(twoview_state, twoview, smplx, vposer, real, RB,
                                               cfg, save_full=True, out_size=CLI_IMG,
                                               use_kernels=uk, device=dev),
            REAL_TEST_FRAMES, [2 * RB] * 3 * nr + [2 * REAL_TEST_FRAMES], 0),
        **{f"compile_real_singleview real:// cam{cam}": (
            lambda uk, cam=cam: cr.compile_real_singleview(hmr_state, hmr, smplx, vposer,
                                                           real_cams[cam], RB, cfg, cam,
                                                           out_size=CLI_IMG, use_kernels=uk,
                                                           device=dev),
            REAL_TEST_FRAMES, [RB] * nr, 0) for cam in (0, 1)},
    }
    shims = []

    class RecordedInt8Inference(it.Int8Inference):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            shims.append(self)

    source_s = [0.0]

    def timed(batches):
        """The batch source with the host time each batch takes to make."""
        it_ = iter(batches)
        while True:
            t_ = time.perf_counter()
            try:
                b = next(it_)
            except StopIteration:
                return
            source_s[0] += time.perf_counter() - t_
            yield b

    sources = {f: getattr(cr, f)
               for f in ("aerialpeople_batches", "synthetic_batches", "real_batches")}
    out = {"precompute_canonical_gt": bodies}
    for name, (run, frames, want_bodies, want_int8) in passes.items():
        reset_kernel_counts()
        source_s[0] = 0.0
        with skinning_bodies() as bodies, \
                mock.patch.object(it, "Int8Inference", RecordedInt8Inference), \
                contextlib.ExitStack() as stack:
            for f, source in sources.items():
                stack.enter_context(mock.patch.object(
                    cr, f, lambda *a, source=source, **kw: timed(source(*a, **kw))))
            t = time.perf_counter()
            outputs, metrics = run(True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        counts = kernel_counts()
        with mock.patch.object(it, "Int8Inference", RecordedInt8Inference):
            plain_outputs, plain_metrics = run(False)
        rel_body = body_rel(outputs, plain_outputs)
        rel_metric = max(abs(metrics[k] - v) / max(abs(v), 1e-30)
                         for k, v in plain_metrics.items())
        rows = sum(len(next(iter(o["output"].values()))) for o in outputs)
        log(f"{name}: {rows} frames in {secs:.2f} s ({frames / secs:.1f} frames/s; making the "
            f"batches {source_s[0]:.2f} s of it on the host), metrics "
            f"{ {k: round(v, 4) for k, v in metrics.items()} }; skinning by bodies {bodies}, "
            f"launches {counts}; kernel vs plain: body fields {rel_body:.3e} (bound "
            f"{EVAL_BODY_REL}), metrics {rel_metric:.3e} (bound {EVAL_METRIC_REL}) [{card}]")
        check(rows == frames, f"{name}: {rows} rows, expected {frames}")
        check(bodies == want_bodies, f"{name}: skinned {bodies}, expected {want_bodies}")
        # one stem launch a trunk call, beside its 52 int8 convs
        check(counts == {"lbs_skinning": len(want_bodies), "fused_stage1": 0,
                         "int8_conv": want_int8, "int8_stem": want_int8 // 52,
                         "add_layernorm": 0},
              f"{name}: launches {counts}")
        check(all(np.isfinite(v) for v in metrics.values())
              and all(np.isfinite(a).all() for o in outputs for a in o["output"].values()),
              f"{name}: non-finite outputs or metrics {metrics}")
        check(rel_body <= EVAL_BODY_REL and rel_metric <= EVAL_METRIC_REL,
              f"{name}: kernel vs plain {rel_body}, metrics {rel_metric}")
        out[name] = {"seconds": secs, "frames_per_s": frames / secs, "source_s": source_s[0],
                     "metrics": metrics,
                     "skinning_launches": len(bodies), "int8_conv_launches": counts["int8_conv"],
                     "int8_stem_launches": counts["int8_stem"],
                     "body_rel": rel_body, "metric_rel": rel_metric}

    # the int8 pass's trunk against the plain int8 trunk on its first batch
    shim = shims[0]
    images = next(iter(cr.aerialpeople_batches(aerial, B, CLI_IMG, dev)))["images"]
    flat = images.reshape((-1,) + tuple(images.shape[2:]))
    with torch.no_grad():
        got = shim._features(images).reshape(flat.shape[0], -1)
        want = it.resnet50_int8_infer(shim.qparams[0], flat, act_scales=shim.act_scales[0],
                                      use_kernels=False)
    same = torch.equal(got, want)
    log(f"--int8 pass: the int8 trunk's features on {flat.shape[0]} crops "
        f"{'equal to' if same else 'DIFFER from'} its plain version's (max |diff| "
        f"{(got - want).abs().max().item():.3e}) [{card}]")
    check(same and len(shims) == 2, "the --int8 pass's features differ from the plain int8 trunk")
    out["int8_features_equal"] = same
    return out


def ba_problem(smplx, vposer, n, seed, dev):
    """tests/test_bundle_adjust.py's problem at n frames: a body decoded from
    the VPoser prior at z ~ N(0, 0.3²), seen by two cameras, its keypoints
    the exact projections with confidence 1, and the init perturbed; as
    numpy (init fields, keypoints (n, 2, 24, 3), intr (2, 3, 3))."""
    from scipy.spatial.transform import Rotation

    from airpose_tpu_torch.bodymodel import vposer_decode
    from airpose_tpu_torch.optim import joints_only_forward

    rng = np.random.default_rng(seed)
    z_true = rng.normal(size=(n, 32)).astype(np.float32) * 0.3
    with torch.no_grad():
        theta = vposer_decode(vposer, torch.from_numpy(z_true).to(dev))["pose_body_matrot"]
        joints = joints_only_forward(smplx, torch.zeros(n, 10, device=dev),
                                     theta)[:, :24].cpu().numpy()
    phi_rm = np.stack([np.stack([Rotation.from_euler("y", 0.1 * v + 0.02 * i).as_matrix()
                                 for v in (0, 1)]) for i in range(n)]).astype(np.float32)
    tau = np.tile(np.asarray([[0.0, 0.0, 6.0]], np.float32), (n, 2, 1))
    tau[:, 1, 0] = 0.5
    intr = np.asarray([[[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]]] * 2, np.float32)
    cam_j = np.einsum("nvij,nkj->nvki", phi_rm, joints) + tau[:, :, None]
    uv = cam_j[..., :2] / cam_j[..., 2:] * 1475.0 + intr[0, :2, 2]
    kp = np.concatenate([uv, np.ones((n, 2, 24, 1))], axis=-1).astype(np.float32)
    init = (z_true + 0.3 * rng.normal(size=z_true.shape).astype(np.float32),
            phi_rm[..., :2].reshape(n, 2, 6) + 0.05 * rng.normal(size=(n, 2, 6)).astype(
                np.float32),
            tau + 0.2 * rng.normal(size=tau.shape).astype(np.float32), np.zeros(10, np.float32))
    return init, kp, intr


def run_ba(smplx, vposer, problem, cfg, dev):
    from airpose_tpu_torch.optim import BAState, bundle_adjust

    init, kp, intr = problem
    kp_t = torch.from_numpy(kp).to(dev)
    return bundle_adjust(smplx, vposer, BAState(*(torch.from_numpy(a).to(dev) for a in init)),
                         kp_t, kp_t, torch.from_numpy(intr).to(dev), cfg)


def phase_airpose_plus(dev, card):
    """Phase 12b: AirPose+ on a 2,000-frame chunk at BAConfig() (the
    joints-only inner loop: no skinning), each stage's ms an iteration with
    its device work, the export at 2,000 bodies kernel vs plain and its ms,
    skinning at B = 2,000 as phase 2 times it, and the card's trace against
    the CPU's on a 24-frame problem."""
    from airpose_tpu_torch.bodymodel import init_vposer_params, synthetic_smplx_params
    from airpose_tpu_torch.optim import BAConfig, export_results

    smplx_cpu, vposer_cpu = synthetic_smplx_params(), init_vposer_params(0)
    smplx, vposer = smplx_cpu.to(dev), vposer_cpu.to(dev)
    problem = ba_problem(smplx, vposer, BA_FRAMES, 0, dev)
    cfg = BAConfig()
    reset_kernel_counts()
    with skinning_bodies() as bodies:
        t = time.perf_counter()
        state, info = run_ba(smplx, vposer, problem, cfg, dev)
        secs = time.perf_counter() - t
    trace = info["trace"]
    log(f"AirPose+ at {BA_FRAMES} frames, {cfg.iters_stage1} + {cfg.iters_stage2} iterations "
        f"(lr {cfg.lr}): {secs:.2f} s, trace {trace[0]:.4f} → {trace[cfg.iters_stage1 - 1]:.4f} "
        f"→ {trace[-1]:.4f}; final terms { {k: round(v, 5) for k, v in info.items() if k != 'trace'} }; "
        f"skinning launches {len(bodies)}, kernels {kernel_counts()} [{card}]")
    check(trace.shape == (cfg.iters_stage1 + cfg.iters_stage2,) and np.isfinite(trace).all(),
          f"AirPose+ trace {trace.shape}, finite {np.isfinite(trace).all()}")
    check(trace[-1] < 0.5 * trace[0], f"AirPose+ trace {trace[0]} → {trace[-1]}")
    check(bodies == [] and kernel_counts()["int8_conv"] == 0,
          f"the AirPose+ inner loop skinned {bodies}")

    stages = {}
    for stage, scfg in (("stage 1 (z frozen)", BAConfig(iters_stage1=BA_STAGE_ITERS,
                                                         iters_stage2=0)),
                        ("stage 2", BAConfig(iters_stage1=0, iters_stage2=BA_STAGE_ITERS))):
        ms = wall_ms(lambda scfg=scfg: run_ba(smplx, vposer, problem, scfg, dev), iters=1,
                     warmup=1) / BA_STAGE_ITERS
        events, prof_ms = device_work(lambda scfg=scfg: run_ba(smplx, vposer, problem, scfg,
                                                               dev), 1)
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / BA_STAGE_ITERS
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        stages[stage] = {"ms_per_iteration": ms, "busy_ms_per_iteration": busy,
                         "device_events_per_iteration": len(events) / BA_STAGE_ITERS,
                         "idle_share": 1 - busy / ms}
        log(f"AirPose+ {stage} at {BA_FRAMES} frames: {ms:.3f} ms an iteration (a run of "
            f"{BA_STAGE_ITERS}), device busy {busy:.3f} ms in "
            f"{len(events) / BA_STAGE_ITERS:.0f} kernels and copies, idle share "
            f"{1 - busy / ms:.3f}; top device time a run: "
            + "; ".join(f"{t_:.2f} ms {n[:60]}" for n, t_ in top) + f" [{card}]")

    with skinning_bodies() as bodies:
        got = export_results(smplx, vposer, state)
    want = export_results(smplx, vposer, state, use_kernels=False)
    rel = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
              for k in ("verts0", "verts1"))
    export_ms = wall_ms(lambda: export_results(smplx, vposer, state), iters=2, warmup=1)
    log(f"export_results at {BA_FRAMES} bodies: skinned {bodies}; kernel vs plain max relative "
        f"{rel:.3e} (bound {EVAL_BODY_REL}); {export_ms:.2f} ms (its "
        f"{got['verts0'].nbytes * 2 / 1e6:.0f} MB of vertices copied to the host included) "
        f"[{card}]")
    check(bodies == [BA_FRAMES] and rel <= EVAL_BODY_REL,
          f"export_results: skinned {bodies}, kernel vs plain {rel}")
    check(all(np.array_equal(got[k], want[k]) for k in ("pose_body", "beta", "cam1_wrt_cam0")),
          "export_results: the fields skinning does not reach differ between runs")

    # skinning at the export's shape, timed as phase 2 times it
    rng = np.random.default_rng(5)
    rel_tf = rng.normal(size=(BA_FRAMES, 55, 4, 4)).astype(np.float32) * 0.3
    rel_tf[:, :, 3] = [0, 0, 0, 1]
    p = torch.from_numpy(rng.normal(size=(BA_FRAMES, 10475, 3)).astype(np.float32)).to(dev)
    at_b2000 = skinning_at(smplx.lbs_weights, torch.from_numpy(rel_tf).to(dev), p)
    del p

    small = ba_problem(smplx, vposer, BA_SMALL, 1, dev)
    scfg = BAConfig(iters_stage1=10, iters_stage2=20)
    _, card_info = run_ba(smplx, vposer, small, scfg, dev)
    _, cpu_info = run_ba(smplx_cpu, vposer_cpu, small, scfg, "cpu")
    trace_rel = float(np.max(np.abs(card_info["trace"] - cpu_info["trace"])
                             / np.abs(cpu_info["trace"])))
    log(f"AirPose+ at {BA_SMALL} frames, 10 + 20 iterations: the card's trace against the "
        f"CPU's max relative {trace_rel:.3e} (bound {BA_CPU_RTOL}) [{card}]")
    check(trace_rel <= BA_CPU_RTOL, f"AirPose+ card vs CPU trace {trace_rel}")
    return {"seconds": secs, "trace_first": float(trace[0]), "trace_last": float(trace[-1]),
            "final": {k: v for k, v in info.items() if k != "trace"}, "stages": stages,
            "export_ms": export_ms, "export_rel": rel, "export_launches": len(bodies),
            "trace_vs_cpu_rel": trace_rel}, at_b2000


def phase_cli_chain(tmp, card):
    """Phase 12c: `python -m airpose_tpu_torch.eval.compile_results` on
    real:// as a subprocess; AirPose+ on its pkl through the bundle_adjust
    CLI's own code, chunked across a chunk boundary and --sharded; the
    figures over the pkl and its metrics. Without matplotlib (the card
    machine has none) the two CLIs' plots are left out: AirPose+ runs
    ``bundle_adjust.optimize`` (main up to its result pkl) and the figures
    ``load_results`` and ``write_metric_table`` (main but the plot)."""
    import importlib.util

    from airpose_tpu_torch.eval import figures
    ba = importlib.import_module("airpose_tpu_torch.optim.bundle_adjust")

    root = os.path.dirname(os.path.abspath(__file__))
    capture = os.path.join(tmp, "capture")
    ckpt = os.path.join(tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt")
    ap = os.path.join(tmp, "airpose.pkl")
    frames = ["--test_frames", str(REAL_TRAIN_FRAMES), str(REAL_TRAIN_FRAMES + REAL_TEST_FRAMES)]
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "airpose_tpu_torch.eval.compile_results",
                        "--model", "copenet_twoview", "--datapath", f"real://{capture}",
                        *frames, "--ckpt", ckpt, "--smplx_model_dir", tmp, "--batch_size",
                        str(REAL_EVAL_BATCH), "--save-full", "--out", ap],
                       cwd=root, capture_output=True, text=True, timeout=300)
    compile_s = time.perf_counter() - t
    log(f"compile_results subprocess: exit {r.returncode} after {compile_s:.1f} s; output: "
        + " | ".join(r.stdout.strip().splitlines()[-5:]) + f" [{card}]")
    if r.returncode:
        log(r.stderr[-3000:])
    check(r.returncode == 0, f"compile_results subprocess exit {r.returncode}")
    with open(ap, "rb") as f:
        res = pickle.load(f)
    with open(ap + ".metrics.json") as f:
        metrics = json.load(f)
    rows = sum(o["output"]["pred_pose0"].shape[0] for o in res[0])
    first = res[0][0]["output"]
    check(len(res) == 1 and rows == REAL_TEST_FRAMES
          and first["pred_vertices_cam0"].shape == (REAL_EVAL_BATCH, 10475, 3)
          and first["pred_j2d_cam1"].shape == (REAL_EVAL_BATCH, 127, 2)
          and set(metrics) == {"test"} and metrics["test"]["robust_frames"] == REAL_TEST_FRAMES,
          f"compile_results pkl: {rows} rows, {first['pred_vertices_cam0'].shape}, {metrics}")

    plots = importlib.util.find_spec("matplotlib") is not None
    common = ["--datapath", f"real://{capture}", "--airpose-pkl", ap, "--split", "test",
              *frames, "--smplx_model_dir", tmp, "--iters1", str(BA_CLI_ITERS[0]),
              "--iters2", str(BA_CLI_ITERS[1])]
    out = {"compile_s": compile_s, "metrics": metrics["test"], "plots": plots}
    for tag, extra, chunks in (("chunked", ["--chunk-size", str(REAL_EVAL_BATCH)], 2),
                               ("sharded", ["--sharded"], 1)):
        argv = common + ["--out", os.path.join(tmp, f"ba_{tag}"), *extra]
        t = time.perf_counter()
        if plots:
            ba.main(argv)
            pkl = os.path.join(tmp, f"ba_{tag}", "airpose_plus_test.pkl")
        else:
            _, _, pkl = ba.optimize(ba.build_parser().parse_args(argv))
        secs = time.perf_counter() - t
        with open(pkl, "rb") as f:
            result = pickle.load(f)
        n = REAL_TEST_FRAMES
        shapes = {k: v.shape for k, v in result.items()}
        log(f"bundle_adjust CLI {tag}: {secs:.2f} s; {shapes}; trace {result['trace'][0]:.4f} → "
            f"{result['trace'][-1]:.4f} [{card}]")
        check(shapes == {"z": (n, 32), "phi": (n, 2, 6), "tau": (n, 2, 3),
                         "beta_per_chunk": (chunks, 10), "pose_body": (n, 21, 3),
                         "cam1_wrt_cam0": (n, 4, 4), "trace": (sum(BA_CLI_ITERS) * chunks,)}
              and all(np.isfinite(v).all() for v in result.values()),
              f"bundle_adjust {tag} result {shapes}")
        out[tag] = {"seconds": secs, "trace_first": float(result["trace"][0]),
                    "trace_last": float(result["trace"][-1])}

    figs = os.path.join(tmp, "figures")
    entries = [f"AirPose={ap}"]
    if plots:
        figures.main(["--results", *entries, "--out", figs])
    else:
        os.makedirs(figs, exist_ok=True)
        trajs, by_model = figures.load_results(entries)
        check(trajs["AirPose"].shape == (REAL_TEST_FRAMES, 3), "figures trajectory")
        figures.write_metric_table(by_model, figs)
    table = open(os.path.join(figs, "metrics.md")).read()
    log(f"figures (plots {'drawn' if plots else 'left out: no matplotlib'}):\n{table.strip()}")
    check("AirPose/test" in table and "crossview_consistency" in table, f"metrics.md {table}")
    return out


def phase_eval(dev, tmp, card):
    """Phase 12, the eval CLI and AirPose+, in phase 10's temporary
    directory (its npz, last.ckpt and AerialPeople fixture; phase 11's
    capture)."""
    seconds, t = {}, time.perf_counter()
    passes = phase_eval_passes(dev, tmp, card)
    seconds["12a"], t = time.perf_counter() - t, time.perf_counter()
    torch.cuda.empty_cache()
    airpose_plus, at_b2000 = phase_airpose_plus(dev, card)
    seconds["12b"], t = time.perf_counter() - t, time.perf_counter()
    torch.cuda.empty_cache()
    chain = phase_cli_chain(tmp, card)
    seconds["12c"] = time.perf_counter() - t
    log(f"phase 12 by part: {', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())} [{card}]")
    return {"passes": passes, "airpose_plus": airpose_plus, "chain": chain,
            "part_seconds": seconds}, at_b2000


def staged_rounds(regs, u8, bb, eager=False):
    """The 3 rounds a frame with same-frame peer messages, one crop a call:
    (pose (n, 2, 135), betas (n, 2, 10), step-1 features (n, 2, 2048)).
    ``eager`` forgets the regressors' rounds before each call, so that every
    call is the first of its shape and runs eagerly."""
    from airpose_tpu_torch.serve.staged import state_to_wire, wire_to_peer

    def call(reg, method, *args):
        if eager:
            reg._rounds.clear()
        return getattr(reg, method)(*args)

    init = np.asarray([[0.0, 0.0, 10.0]], np.float32)
    pose, betas, feats = [], [], []
    for f in range(len(u8)):
        states = [call(regs[v], "step1", u8[f, v][None], bb[f, v][None], init) for v in (0, 1)]
        feats.append(torch.stack([s.xf[0] for s in states]))
        for _ in range(2):
            wires = [state_to_wire(s) for s in states]
            states = [call(regs[v], "step23", states[v], bb[f, v][None],
                           *(a[None] for a in wire_to_peer(wires[1 - v])))
                      for v in (0, 1)]
        pose.append(np.stack([s.pose[0] for s in states]))
        betas.append(np.stack([s.shape[0] for s in states]))
    return np.stack(pose), np.stack(betas), torch.stack(feats)


def serving_staged(dev, model, u8, bb):
    """Phase 13a: StagedRegressor's 3 rounds against the fused forward of the
    same crops: f32 AirPoseTwoView, the per-drone _sep (seed 0), and the
    int8 trunk against Int8Inference on the same scales."""
    from airpose_tpu_torch.models import MODEL_REGISTRY
    from airpose_tpu_torch.ops import Int8Inference
    from airpose_tpu_torch.serve import StagedRegressor

    n = len(u8)
    bb_d = torch.from_numpy(bb).to(dev)
    pos = torch.tensor([0.0, 0.0, 10.0 * 0.05], device=dev).expand(n, 2, 3)
    out = {}
    for name, m in (("copenet_twoview", model),
                    ("copenet_twoview_sep", MODEL_REGISTRY["copenet_twoview_sep"]().to(dev))):
        sep = name == "copenet_twoview_sep"
        regs = [StagedRegressor(m, sep_view=v if sep else None, device=dev) for v in (0, 1)]
        x = regs[0]._normalize(torch.from_numpy(u8).to(dev))
        pose, betas, _ = staged_rounds(regs, u8, bb)
        with torch.inference_mode():
            fused = m(x, bb_d, pos)
        diff = max(np.abs(pose - fused.pose.cpu().numpy()).max(),
                   np.abs(betas - fused.betas.cpu().numpy()).max())
        log(f"staged {name} (3 rounds, 1 crop a call, {n} frames) vs fused: max |diff| "
            f"{diff:.3e} (atol {STAGED_ATOL_F32})")
        check(diff <= STAGED_ATOL_F32, f"staged {name} disagrees with the fused forward: {diff}")
        out[name] = {"max_abs_diff": float(diff)}
        if not sep:
            eager = StagedRegressor(m, device=dev)
            out[name]["graph_vs_eager"] = graph_vs_eager(
                name, (pose, betas), staged_rounds([eager, eager], u8, bb, eager=True), regs, n)
        del m, regs

    # int8: one regressor for both views (one calibration table, on frame 0
    # view 0's crop), against Int8Inference holding the same table
    reg = StagedRegressor(model, int8=True, device=dev)
    x = reg._normalize(torch.from_numpy(u8).to(dev))
    reset_kernel_counts()
    pose, betas, feats = staged_rounds([reg, reg], u8, bb)
    torch.cuda.synchronize()
    launches = kernel_counts()
    # the host counters advance where the rounds' Python runs: the first
    # step-1 call (calibration, clip report, the step) and the capture;
    # every later step-1 call is a replay, which graph_replays counts
    want = 4 * 52
    log(f"staged int8 ({n} frames × 2 views): launches {launches}, expected int8_conv {want}")
    check(launches == {"lbs_skinning": 0, "fused_stage1": 0, "int8_conv": want,
                       "int8_stem": want // 52, "add_layernorm": 0},
          f"staged int8 launches {launches}, expected {want} int8 conv launches and "
          f"{want // 52} stem launches only")
    eager = StagedRegressor(model, int8=True, device=dev)
    eager._qp, eager._act_scales = reg._qp, reg._act_scales
    eager_rounds = staged_rounds([eager, eager], u8, bb, eager=True)
    graph_eager = graph_vs_eager("int8", (pose, betas), eager_rounds, [reg], n)
    feat_graph = (eager_rounds[2] - feats).abs().max().item()
    log(f"staged int8 step-1 features, replayed against eager: max |diff| {feat_graph} (exact)")
    check(feat_graph == 0.0, f"replayed int8 features differ from eager ones: {feat_graph}")
    # the fused forward: Int8Inference's trunk at the served shape (1 crop a
    # call; cuDNN's bf16 stem rounds differently at other batch sizes, and
    # the int8 quantization carries that on), then the fused 3-step IEF
    shim = Int8Inference(model, x[0, :1])
    shim.qparams, shim.act_scales = [reg._qp], [reg._act_scales]
    with torch.inference_mode():
        xf = torch.stack([torch.cat([shim._infer(0, x[f, v][None]) for v in (0, 1)])
                          for f in range(n)])
        fused = model.from_features(xf, bb_d, pos)
    feat_diff = (xf - feats).abs().max().item()
    diff = max(np.abs(pose - fused.pose.cpu().numpy()).max(),
               np.abs(betas - fused.betas.cpu().numpy()).max())
    folded = shim.apply(x, bb_d, pos)
    folded_feat = (shim._features(x) - feats).abs().max().item()
    folded_diff = max(np.abs(pose - folded.pose.cpu().numpy()).max(),
                      np.abs(betas - folded.betas.cpu().numpy()).max())
    log(f"staged int8 vs Int8Inference on the same scales at 1 crop a trunk call: features "
        f"max |diff| {feat_diff} (exact), pose and betas {diff:.3e} (atol {STAGED_ATOL_INT8}); "
        f"against Int8Inference.apply on the {2 * n}-crop folded batch (not checked): features "
        f"{folded_feat:.3e}, pose and betas {folded_diff:.3e}")
    check(feat_diff == 0.0, f"staged int8 features differ from Int8Inference's: {feat_diff}")
    check(diff <= STAGED_ATOL_INT8, f"staged int8 disagrees with Int8Inference: {diff}")
    out["int8"] = {"feature_max_abs_diff": feat_diff, "max_abs_diff": float(diff),
                   "folded_feature_max_abs_diff": folded_feat,
                   "folded_max_abs_diff": float(folded_diff), "launches": launches["int8_conv"],
                   "graph_vs_eager": {**graph_eager, "feature_max_abs_diff": feat_graph}}
    return out, reg


def graph_vs_eager(name, replayed, eager, regs, n):
    """The rounds replayed as CUDA graphs (``replayed``: pose and betas of
    ``staged_rounds``) against the same rounds run eagerly, and the replays
    counted: of one regressor a view, the first step-1 and step23 calls
    eager and every later one a replay; one regressor for both views, twice
    as many replays."""
    diff = max(np.abs(replayed[0] - eager[0]).max(), np.abs(replayed[1] - eager[1]).max())
    calls = [(r.eager_calls, r.graph_replays) for r in regs]
    want = [(2, 6 * n - 2)] if len(regs) == 1 else [(2, 3 * n - 2)] * len(regs)
    log(f"staged {name}, replayed rounds against eager: pose and betas max |diff| {diff:.3e} "
        f"(atol {GRAPH_WIRE_ATOL}); (eager calls, graph replays) {calls}, expected {want}")
    check(diff <= GRAPH_WIRE_ATOL, f"staged {name}: replayed rounds differ from eager: {diff}")
    check(calls == want, f"staged {name}: (eager calls, graph replays) {calls}, expected {want}")
    return {"max_abs_diff": float(diff), "eager_calls_graph_replays": calls}


def serving_kernels(dev, reg, crop):
    """Phase 13b: the kernels at this path's shapes against their plain
    versions: the 52 int8 convs of one step-1 call at 1 crop of 224², and
    skinning at B = 1 body; then each round's wall time and device work."""
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.ops import int8_conv as ic
    from airpose_tpu_torch.ops import int8_trunk as it

    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ic.int8_conv(*a, **kw)

    with torch.inference_mode():
        it.resnet50_int8_infer(reg._qp, crop, reg._act_scales, conv=record)
    check(len(calls) == 52, f"one step-1 call made {len(calls)} conv calls, expected 52")
    err = 0.0
    for a, kw in calls:
        err = max(err, max_diff(ic.int8_conv(*a, **kw), ic.int8_conv_reference(*a, **kw)))
    torch.cuda.synchronize()
    check(err == 0.0, f"int8 conv kernel differs from its plain version at 1 crop: {err}")

    def replay(fn):
        for a, kw in calls:
            fn(*a, **kw)

    ms = time_ms(lambda: replay(ic.int8_conv), iters=20)
    plain_ms = time_ms(lambda: replay(ic.int8_conv_reference), iters=3, warmup=1)
    library_ms = time_ms(lambda: replay(int_mm_conv), iters=20)
    n_ops = n_bytes = 0
    for (x, w, m, b, ksize, stride), kw in calls:
        o, nb = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                             kw.get("qscale"))
        n_ops, n_bytes = n_ops + o, n_bytes + nb
    bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS)
    rows = sorted({ic.out_size(a[0].shape[1], a[4], a[5]) * ic.out_size(a[0].shape[2], a[4], a[5])
                   for a, _ in calls})
    log(f"int8_conv at 1 crop of 224² (GEMM rows M from {rows[0]} to {rows[-1]}): the 52 "
        f"convs exact against the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms (torch._int_mm), bound {bound_ms:.4f} ms ({bound_by}), "
        f"kernel at {bound_ms / ms:.1%} of its bound")
    at_1_crop = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms}

    rng = np.random.default_rng(13)
    w = synthetic_smplx_params().lbs_weights.to(dev)
    rel = rng.normal(size=(1, 55, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    at_b1 = skinning_at(w, torch.from_numpy(rel).to(dev),
                        torch.from_numpy(rng.normal(size=(1, 10475, 3)).astype(np.float32)).to(dev))
    return at_1_crop, at_b1


def round_split(dev, model, int8_reg, crop_u8):
    """Each round's wall time on the host clock (it ends in its device→host
    copy) and its device work under the profiler, at 1 crop."""
    from airpose_tpu_torch.serve import StagedRegressor

    reg = StagedRegressor(model, device=dev)
    bb, init = np.zeros((1, 3), np.float32), np.asarray([[0.0, 0.0, 10.0]], np.float32)
    state = reg.step1(crop_u8, bb, init)
    art, shape = reg._mean_art, reg._mean_shape
    split = {}
    for name, fn in (("f32 step1", lambda: reg.step1(crop_u8, bb, init)),
                     ("step2/3", lambda: reg.step23(state, bb, art, shape)),
                     ("int8 step1", lambda: int8_reg.step1(crop_u8, bb, init))):
        for _ in range(3):
            fn()
        n = 30
        t = time.perf_counter()
        for _ in range(n):
            fn()
        wall = (time.perf_counter() - t) / n * 1e3
        events, _ = device_work(fn, 10)
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / 10
        split[name] = {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
                       "device_ops": len(events) / 10}
        log(f"round {name} at 1 crop: {wall:.3f} ms wall, device busy {busy:.3f} ms in "
            f"{len(events) / 10:.0f} kernels and copies, idle share {1 - busy / wall:.3f}")
    return split


def two_servers(model, dev, ports):
    """Two in-process servers of ``model`` on a loop thread: (loop, thread)."""
    import asyncio

    from airpose_tpu_torch.serve import StagedRegressor
    from airpose_tpu_torch.serve.server import run_server

    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        regs = [StagedRegressor(model, device=dev) for _ in (0, 1)]
        loop.create_task(run_server(regs[0], 1, ports[0], peer_port=ports[1]))
        loop.create_task(run_server(regs[1], 2, ports[1], peer_port=ports[0]))
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    time.sleep(1.0)
    return loop, thread


def stop_servers(loop, thread):
    import asyncio

    async def shutdown():
        tasks = [t for t in asyncio.all_tasks(loop) if t is not asyncio.current_task()]
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=5)
        loop.stop()

    asyncio.run_coroutine_threadsafe(shutdown(), loop)
    thread.join(timeout=10)
    check(not thread.is_alive(), "the servers' loop did not stop")
    loop.close()


def native_client_binary(tmp):
    """The unchanged native C++ client: built by the port's cmake recipe
    where cmake exists, else by g++ into ``tmp``. (path, route)."""
    from airpose_tpu_torch.serve import benchtest

    if shutil.which("cmake") and benchtest.ensure_client_built():
        return benchtest._client_binary(), "cmake (benchtest.ensure_client_built)"
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "airpose_client")
    r = subprocess.run(["g++", "-std=c++17", "-O2", "-I", os.path.join(root, "native"),
                        os.path.join(root, "native", "client", "airpose_client.cpp"),
                        "-o", path], capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"the native client builds neither with cmake nor with g++: "
          f"{r.stderr[-2000:]}")
    return path, "g++ -std=c++17 -O2 -I native"


def serving_native(dev, model, tmp, ds, batches, card):
    """Phase 13e: the native C++ client, unchanged, against the port's
    servers: two clients in fake mode at --fps 4, every frame answered (their
    dumped step-3 results are returned), then the ROI replay of the
    capture's full frames."""
    from airpose_tpu_torch.serve import benchtest

    client, route = native_client_binary(tmp)
    log(f"native client: built by {route}")
    ports = benchtest._free_ports(2)
    loop, thread = two_servers(model, dev, ports)
    dumps = [os.path.join(tmp, f"served_{v}.bin") for v in (0, 1)]
    try:
        procs = [subprocess.Popen(
            [client, "--host", "127.0.0.1", "--port", str(ports[v]), "--robot-id", str(v + 1),
             "--frames", str(NATIVE_FAKE_FRAMES), "--fps", "4", "--dump-results", dumps[v]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for v in (0, 1)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                check(p.returncode == 0, f"native client exited {p.returncode}: {err[-2000:]}")
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        stop_servers(loop, thread)
    for v, out in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("RESULT")]
        check(len(lines) == NATIVE_FAKE_FRAMES and all(
            f"frame={i} " in line for i, line in enumerate(lines)),
            f"native client {v + 1} got {len(lines)} RESULT lines for {NATIVE_FAKE_FRAMES} "
            f"frames:\n{out[-2000:]}")
    log(f"native clients in fake mode at --fps 4: {NATIVE_FAKE_FRAMES} RESULT lines each; "
        f"client 1's last: {outs[0].splitlines()[-1][:160]}")
    rec = np.fromfile(dumps[0], dtype=np.dtype([("fid", "<u4"), ("data", "<f4", 145)]))
    check(len(rec) == NATIVE_FAKE_FRAMES and np.isfinite(rec["data"]).all(),
          f"native client 1 dumped {len(rec)} results")

    with mock.patch.object(benchtest, "_client_binary", return_value=client):
        t = time.perf_counter()
        diffs = benchtest.run_benchtest(model, batches, native_roi=ds, device=dev)
    seconds = time.perf_counter() - t
    log(f"native ROI replay of {len(ds)} full 1920×1080 frames a camera: diffs "
        f"{json.dumps(diffs)} (bound {SERVED_ROI_DIFF}), {seconds:.1f} s [{card}]")
    check(all(v < SERVED_ROI_DIFF for v in diffs.values()),
          f"native ROI replay diffs beyond {SERVED_ROI_DIFF}: {diffs}")
    return {"route": route, "fake_mode_frames": NATIVE_FAKE_FRAMES, "roi_diffs": diffs,
            "roi_seconds": seconds}, rec["data"]


def phase_serving(dev, tmp, card):
    """Phase 13, two-drone serving (airpose_tpu_torch.serve) on phase 11's
    capture, its 30 test frames at 224², with phase 10's last.ckpt."""
    from airpose_tpu_torch.data import CopenetRealDataset
    from airpose_tpu_torch.eval.compile_results import real_batches
    from airpose_tpu_torch.serve import benchtest, lagone, viz
    from airpose_tpu_torch.serve.staged import normalize_host
    from airpose_tpu_torch.train.checkpoint import load_model_variables

    seconds, t = {}, time.perf_counter()
    ckpt = os.path.join(tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt")
    have_ckpt = os.path.exists(ckpt)
    model, _ = load_model_variables("copenet_twoview", torch_ckpt=ckpt if have_ckpt else None,
                                    random_init=not have_ckpt, device=dev)
    log(f"phase 13 serves {'phase 10' + chr(39) + 's last.ckpt' if have_ckpt else 'seed 0'}")
    ds = CopenetRealDataset(os.path.join(tmp, "capture"), frame_range=range(
        REAL_TRAIN_FRAMES, REAL_TRAIN_FRAMES + REAL_TEST_FRAMES))
    batches = list(real_batches(ds, REAL_TEST_FRAMES, device=dev))
    images = batches[0]["images"].cpu().numpy()
    bb = batches[0]["bb"].cpu().numpy()
    u8 = np.stack([[benchtest._denormalize_u8(images[f, v]) for v in (0, 1)]
                   for f in range(len(images))])
    out = {"frames": len(images), "weights": "last.ckpt" if have_ckpt else "seed 0"}

    out["staged"], int8_reg = serving_staged(dev, model, u8, bb)
    seconds["13a"], t = time.perf_counter() - t, time.perf_counter()
    crop = int8_reg._normalize(torch.from_numpy(u8[0, 0][None]).to(dev))
    at_1_crop, at_b1 = serving_kernels(dev, int8_reg, crop)
    out["round_split"] = round_split(dev, model, int8_reg, u8[0, 0][None])
    seconds["13b"], t = time.perf_counter() - t, time.perf_counter()

    with torch.inference_mode():
        fused = model(torch.from_numpy(np.stack([[normalize_host(u8[f, v]) for v in (0, 1)]
                                                 for f in range(len(u8))])).float().to(dev),
                      torch.from_numpy(bb).to(dev),
                      torch.tensor([0.0, 0.0, 0.5], device=dev).expand(len(u8), 2, 3))
    pose_rms = fused.pose[..., 3:].std(dim=(0, 2)).cpu().numpy()
    served = {}
    for name, int8 in (("f32", False), ("int8", True)):
        reset_kernel_counts()
        served[name] = benchtest.run_benchtest(model, batches, int8=int8, measure_rate=True,
                                               device=dev)
        torch.cuda.synchronize()
        served[name]["launches"] = kernel_counts()
        fps = served[name]["served_fps"]
        log(f"benchtest {name}, two in-process servers over localhost TCP, {len(u8)} frames: "
            f"{json.dumps(served[name])}; served_fps {fps:.2f} a drone pair after the warm-up "
            f"(the reference: {REFERENCE_FPS} FPS) [{card}]")
    check(all(served["f32"][k] < SERVED_DIFF for k in served["f32"] if k.startswith(
        ("beta", "trans", "pose"))), f"f32 served diffs beyond {SERVED_DIFF}: {served['f32']}")
    check(all(served["int8"][f"pose_{m}"] < SERVED_INT8_RMS * pose_rms[v]
              for v, m in enumerate(("m1", "m2"))),
          f"--int8 served pose beyond {SERVED_INT8_RMS} × rms {pose_rms}: {served['int8']}")
    # two servers, each: 52 at calibration, the clip report, the eager first
    # step-1 call and its capture; the later frames replay the graph
    want = 2 * 4 * 52
    check(served["f32"]["launches"] == {"lbs_skinning": 0, "fused_stage1": 0, "int8_conv": 0,
                                        "int8_stem": 0, "add_layernorm": 0},
          f"f32 serving launched kernels: {served['f32']['launches']}")
    check(served["int8"]["launches"] == {"lbs_skinning": 0, "fused_stage1": 0, "int8_conv": want,
                                         "int8_stem": want // 52, "add_layernorm": 0},
          f"--int8 serving launches {served['int8']['launches']}, expected {want} int8 conv")
    log(f"--int8 served pose rms of the f32 forward {pose_rms.tolist()}; int8 conv launches "
        f"{want} = 2 servers × (calibration + clip report + first frame + capture) × 52; "
        f"the other {len(u8) - 2} frames replay")
    out["served"] = served
    seconds["13c"], t = time.perf_counter() - t, time.perf_counter()

    args = ["--model", "copenet_twoview"] + (["--ckpt", ckpt] if have_ckpt else ["--random-init"])
    procs = benchtest.run_benchtest(model, batches, measure_rate=True, server_cli_args=args,
                                    device=dev)
    log(f"benchtest --rate-procs, two `python -m airpose_tpu_torch.serve.server` processes on "
        f"the card: {json.dumps(procs)}; served_fps {procs['served_fps']:.2f} [{card}]")
    check(all(procs[k] < SERVED_DIFF for k in procs if k != "served_fps"),
          f"--rate-procs diffs beyond {SERVED_DIFF}: {procs}")
    out["rate_procs"] = procs
    seconds["13d"], t = time.perf_counter() - t, time.perf_counter()

    out["native"], wire = serving_native(dev, model, tmp, ds, batches, card)
    seconds["13e"], t = time.perf_counter() - t, time.perf_counter()

    norm = [images[f] for f in range(len(images))]
    bbs = [bb[f] for f in range(len(bb))]
    init = np.asarray([0.0, 0.0, 10.0], np.float32)
    static = lagone.lag_one_report(model, norm[:1] * 4, bbs[:1] * 4, init, device=dev)
    moving = lagone.lag_one_report(model, norm, bbs, init, device=dev)
    log(f"lag-one: static scene {json.dumps(static)} (bound {LAGONE_STATIC}); the capture's "
        f"{len(norm)} frames {json.dumps(moving)}")
    check(static["pose_absdiff"] < LAGONE_STATIC and static["beta_absdiff"] < LAGONE_STATIC,
          f"lag-one differs from the synchronized protocol on a static scene: {static}")
    out["lagone"] = {"static": static, "capture": moving}
    seconds["13f"], t = time.perf_counter() - t, time.perf_counter()

    from airpose_tpu_torch.bodymodel import smplx_forward, synthetic_smplx_params
    from airpose_tpu_torch.geometry.rotations import rot6d_to_rotmat
    from airpose_tpu_torch.serve.protocol import unpack_params
    from airpose_tpu_torch.utils.render import overlay_mesh
    import cv2

    npy, viz_dir = os.path.join(tmp, "served.npy"), os.path.join(tmp, "viz")
    np.save(npy, wire)
    reset_kernel_counts()
    viz.main(["--wire", npy, "--out", viz_dir, "--max-frames", str(VIZ_FRAMES)])
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(launches == {"lbs_skinning": VIZ_FRAMES, "fused_stage1": 0, "int8_conv": 0,
                       "int8_stem": 0, "add_layernorm": 0},
          f"viz launches {launches}, expected {VIZ_FRAMES} skinning launches")
    pngs = sorted(os.listdir(viz_dir))
    check(len(pngs) == VIZ_FRAMES, f"viz wrote {pngs}")
    # each PNG against the same message rendered here from the plain
    # skinning's vertices: within one uint8 step, and showing a body exactly
    # where that render does (off the canvas, the message's translation
    # leaves it uniform)
    params = synthetic_smplx_params().to(dev)
    err, step, shown = 0.0, 0, 0
    for i, name in enumerate(pngs):
        betas, trans, pose6d = unpack_params(wire[i])
        with torch.inference_mode():
            rotmat = rot6d_to_rotmat(torch.from_numpy(pose6d.reshape(22, 6)).to(dev))
            verts = [smplx_forward(params, torch.from_numpy(np.array(betas))[None].to(dev),
                                   body_pose=rotmat[None, 1:],
                                   global_orient=torch.eye(3, device=dev).expand(1, 1, 3, 3),
                                   use_kernels=k).vertices for k in (True, False)]
        err = max(err, (verts[0] - verts[1]).abs().max().item())
        plain = verts[1][0].cpu().numpy() @ rotmat[0].cpu().numpy().T + trans
        want = overlay_mesh(np.full((540, 960, 3), 0.15), plain, params.faces,
                            (1475.0 * 960 / 1920, 1475.0 * 540 / 1080), center=(480, 270))
        want = (np.clip(want, 0, 1) * 255).astype(np.uint8)
        img = cv2.imread(os.path.join(viz_dir, name))
        check(img is not None and img.shape == (540, 960, 3), f"viz PNG {name} is unreadable")
        step = max(step, int(np.abs(img[..., ::-1].astype(np.int16) - want).max()))
        body = bool(want.std() > 0)
        shown += body
        check((img.std() > 0) == body, f"viz PNG {name}: body shown {img.std() > 0}, the plain "
              f"render's {body} (translation {trans.tolist()})")
    log(f"viz CLI: {VIZ_FRAMES} PNGs of the served step-3 results (10,475 vertices), "
        f"{shown} with the body on the canvas; {launches['lbs_skinning']} skinning launches; "
        f"kernel-skinned vertices max |diff| {err:.3e} from the plain skinning's (atol "
        f"{SKIN_ATOL}); the PNGs within {step} uint8 step(s) of the plain render")
    check(err <= SKIN_ATOL, f"viz vertices: kernel against plain skinning {err}")
    check(step <= 1, f"viz PNGs differ from the plain render by {step} uint8 steps")
    out["viz"] = {"pngs": len(pngs), "with_body": shown,
                  "skinning_launches": launches["lbs_skinning"],
                  "vertex_max_abs_diff": err, "max_uint8_step": step}
    seconds["13g"] = time.perf_counter() - t
    log(f"phase 13 by part: {', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())} [{card}]")
    out["part_seconds"] = seconds
    return out, at_1_crop, at_b1


# ---- phase 14: the reference workflow's tools ---------------------------------------------


class _StagedLines(_Lines):
    """_Lines that also keeps the kernel counts at each line."""

    def __init__(self, echo):
        super().__init__(echo)
        self.counts = []

    def write(self, text):
        n = len(self.lines)
        written = super().write(text)
        self.counts += [kernel_counts() for _ in self.lines[n:]]
        return written


class KernelInputs:
    """Within ``recording()``, a copy of the first inputs that the int8 conv
    and skinning wrappers get at each shape on the path (through
    int8_trunk's and lbs.py's calls, the only callers on phase 14's paths);
    ``compare()`` then runs each wrapper's kernel on those copies against its
    plain version, outside the counted run."""

    def __init__(self):
        self.convs, self.skins = {}, {}

    @contextlib.contextmanager
    def recording(self):
        import inspect

        from airpose_tpu_torch.bodymodel import lbs
        from airpose_tpu_torch.ops import int8_trunk

        conv, skin = int8_trunk.int8_conv, lbs.skinning
        sig = inspect.signature(conv)

        def keep(t):
            return t.detach().clone() if isinstance(t, torch.Tensor) else t

        def conv_rec(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            v = a.arguments
            key = tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
                        for n, t in v.items() if n not in ("m", "r", "qscale")) + (
                v["qscale"] is None,)
            if key not in self.convs:
                self.convs[key] = {n: keep(t) for n, t in v.items()}
            return conv(*args, **kwargs)

        def skin_rec(w, a, p):
            if tuple(p.shape) not in self.skins:
                self.skins[tuple(p.shape)] = (keep(w), keep(a), keep(p))
            return skin(w, a, p)

        with mock.patch.object(int8_trunk, "int8_conv", conv_rec), \
                mock.patch.object(lbs, "skinning", skin_rec):
            yield self

    def compare(self, what):
        """Each recorded int8 conv exactly equal to int8_conv_reference, each
        recorded skinning within SKIN_ATOL of skinning_reference; → a
        summary for the log and the kernels line."""
        from airpose_tpu_torch.bodymodel import cuda_lbs
        from airpose_tpu_torch.ops import int8_conv as ic

        conv_err, crops = 0.0, set()
        with torch.no_grad():
            for v in self.convs.values():
                got = ic.int8_conv_cuda(**v)
                want = ic.int8_conv_reference(**v)
                got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
                for g, w in zip(got, want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"{what}: int8 conv at {tuple(v['x'].shape)} gave {g.dtype} "
                          f"{tuple(g.shape)}, the plain version {w.dtype} {tuple(w.shape)}")
                    conv_err = max(conv_err, float((g.float() - w.float()).abs().max()))
                crops.add(v["x"].shape[0])
            skin_err = 0.0
            for w, a, p in self.skins.values():
                skin_err = max(skin_err, float((cuda_lbs.skinning_cuda(w, a, p) - cuda_lbs
                                                .skinning_reference(w, a, p)).abs().max()))
        out = {"int8_conv": {"shapes": len(self.convs), "batch_sizes": sorted(crops),
                             "max_abs_err": conv_err},
               "lbs_skinning": {"batch_sizes": sorted(s[0] for s in self.skins),
                                "max_abs_err": skin_err}}
        log(f"{what}: the kernels on the path's own inputs against their plain versions: "
            + json.dumps(out))
        check(conv_err == 0.0, f"{what}: the int8 conv kernel differs from its plain version "
              f"by {conv_err} on the path's inputs (it is exact)")
        check(skin_err <= SKIN_ATOL, f"{what}: skinning differs from its plain version by "
              f"{skin_err} > {SKIN_ATOL} on the path's inputs")
        return out


def stage_marks(stamped, t0):
    """{"[k/10]": (seconds since the previous stage ended, kernel counts)}
    from each stage tag's last line (a stage may print more than one)."""
    last = {}
    for (t, line), counts in stamped:
        if line.startswith("[") and "/10]" in line.split(" ", 1)[0]:
            last[line.split(" ", 1)[0]] = (t, counts)
    out, prev_t, prev_c = {}, t0, {k: 0 for k in kernel_counts()}
    for tag, (t, counts) in sorted(last.items(), key=lambda kv: kv[1][0]):
        out[tag] = {"s": t - prev_t, **{k: counts[k] - prev_c[k]
                                        for k in ("lbs_skinning", "int8_conv", "int8_stem")}}
        prev_t, prev_c = t, counts
    return out


def rehearsal_predicted(h5py_here):
    """(skinning, int8 conv) launches of each stage of dress_rehearsal.run at
    its defaults, from the code: one skinning launch a SMPL-X forward of any
    batch (a pose in create_aerialpeople, a train step, an eval loss, the
    eval metrics' prediction and GT, a summary grid, a gender group of
    precompute_canonical_gt, the cross-view metric, the AirPose+ export), 52
    int8 convs a trunk call. A trainer's train step skins at its eager first
    call and its capture only (graph_launches)."""
    return {
        "[1/10]": (3 * 2, 0),           # 3 subjects × 2 poses
        "[2/10]": (2 + 1 + sum(graph_launches(6)) + 1 + 1, 0),  # precompute: train's 2
                                        # genders, test's 1; 6 steps; 1 val batch; 1 grid
        "[3/10]": (0, 0),
        "[4/10]": (2 * (1 + 1 + 2), 3 * 52),  # per pass: precompute, the eval loss of
                                        # its 1 batch, the metrics' 2; --int8: calibration,
                                        # clip report, 1 batch
        "[5-6/10]": (2 + 1, 0),         # 6 frames at B = 4: 2 eval losses, cross-view
        "[7/10]": (sum(graph_launches(48)) + 1 + 1 + 3, 0),  # 48 steps, 1 full val batch,
                                        # 1 grid; the eval
        "[8/10]": (1, 0),               # the export (none in the joints-only loop)
        "[9/10]": (0, 0),               # served and offline forwards skin nothing
        "[9b/10]": (0, 0),
        # mixed:// train and h36m:// eval: 11, as counted on the CPU at these settings
        "[10/10]": (11 if h5py_here else 0, 0),
    }


def _chessboard_frames(root, K, square_m=0.05, n=6):
    """tests/test_tools.py:91-126's warped-chessboard calibration frames."""
    import cv2

    sq = 40
    tex = np.full(((7 + 2) * sq, (10 + 2) * sq), 255, np.uint8)
    for r in range(7):
        for c in range(10):
            if (r + c) % 2 == 0:
                tex[(r + 1) * sq:(r + 2) * sq, (c + 1) * sq:(c + 2) * sq] = 0
    out = os.path.join(root, "calib_frames")
    os.makedirs(out, exist_ok=True)
    for k in range(n):
        rvec = np.asarray([0.25 * np.sin(k), 0.25 * np.cos(1.3 * k), 0.1 * k])
        tvec = np.asarray([-0.25 + 0.02 * k, -0.18, 1.2 + 0.1 * k])
        plane = np.asarray([[0, 0, 0], [10 * square_m, 0, 0], [10 * square_m, 7 * square_m, 0],
                            [0, 7 * square_m, 0]], np.float32)
        uv, _ = cv2.projectPoints(plane, rvec, tvec, K, np.zeros(5))
        src = np.asarray([[sq, sq], [11 * sq, sq], [11 * sq, 8 * sq], [sq, 8 * sq]], np.float32)
        H, _ = cv2.findHomography(src, uv.reshape(-1, 2))
        cv2.imwrite(os.path.join(out, f"{k:03d}.png"),
                    cv2.warpPerspective(tex, H, (640, 480), borderValue=255))
    return out


def _aruco_frames(root, marker, n=4):
    """tests/test_tools.py:129-140's ArUco capture frames."""
    import cv2

    out = os.path.join(root, "capture_frames")
    os.makedirs(out, exist_ok=True)
    for k in range(n):
        frame = np.full((480, 640), 255, np.uint8)
        frame[140:340, 200 + 10 * k:400 + 10 * k] = marker
        cv2.imwrite(os.path.join(out, f"{k:03d}.jpg"), frame)
    return out


def phase_fixtures(root, card):
    """14a: create_aerialpeople at its defaults on the 10,475-vertex body,
    with the kernel and with the plain skinning; the capture and the
    TotalCapture db writers."""
    from airpose_tpu_torch import bodymodel
    from airpose_tpu_torch.tools import create_aerialpeople, synth_mocap_dbs, synth_real_capture

    out = {}
    runs = {}
    for name, patch in (("kernel", contextlib.nullcontext()),
                        ("plain", mock.patch.object(bodymodel, "smplx_forward", partial(
                            bodymodel.smplx_forward, use_kernels=False)))):
        d = os.path.join(root, f"aerialpeople_{name}")
        reset_kernel_counts()
        t = time.perf_counter()
        with patch:
            create_aerialpeople.main(["--out", d, "--num-vertices", "10475", "--render-blobs"])
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        out[f"{name}_launches"] = kernel_counts()["lbs_skinning"]
        runs[name] = d
    check(out["kernel_launches"] == 4 * 5 and out["plain_launches"] == 0,
          f"create_aerialpeople: {out['kernel_launches']} skinning launches with the kernel "
          f"and {out['plain_launches']} without, predicted 20 (one a pose) and 0")
    rel, same_bb, n = 0.0, 0, 0
    for f in sorted(os.listdir(os.path.join(runs["plain"], "pkls"))):
        with open(os.path.join(runs["kernel"], "pkls", f), "rb") as fk, \
                open(os.path.join(runs["plain"], "pkls", f), "rb") as fp:
            k, p = pickle.load(fk), pickle.load(fp)
        for key in ("smpl_vertices_wrt_origin", "smpl_joints_wrt_origin"):
            rel = max(rel, float(np.abs(k[key] - p[key]).max() / np.abs(p[key]).max()))
        same_bb += sum(np.array_equal(k[f"bb{c}"], p[f"bb{c}"]) for c in (0, 1))
        n += 2
    out["body_rel"], out["bb_equal"] = rel, f"{same_bb}/{n}"
    check(rel <= EVAL_BODY_REL, f"create_aerialpeople body fields kernel vs plain {rel:.3g} "
          f"> {EVAL_BODY_REL}")
    t = time.perf_counter()
    synth_real_capture.main(["--out", os.path.join(root, "synth_capture")])
    synth_mocap_dbs.main(["--kind", "totalcap", "--out", os.path.join(root, "totalcap")])
    out["writers_s"] = time.perf_counter() - t
    for path in ("synth_capture/machine_2/images/000015.jpg", "synth_capture/machine_1/"
                 "camera_calib.yml", "totalcap/dsets/totalcap_db.pkl", "totalcap/cameras.pkl"):
        check(os.path.exists(os.path.join(root, path)), f"fixture writers: no {path}")
    log(f"14a create_aerialpeople 20 poses: {out['kernel_launches']} skinning launches, "
        f"{out['kernel_s']:.2f} s (plain {out['plain_s']:.2f} s), body fields kernel vs plain "
        f"{rel:.3g}, boxes equal {out['bb_equal']}; writers {out['writers_s']:.2f} s [{card}]")
    return out


def phase_rehearsal(root, card):
    """14b: dress_rehearsal.run in process at full width (224², 10,475
    vertices, the JAX defaults otherwise), each stage's seconds and kernel
    launches against the counts the code gives; then the module's entry
    point as a subprocess at tests/test_dress_rehearsal.py's sizes, its
    stage seconds read from its [k/10] lines as they arrive."""
    import importlib.util

    from airpose_tpu_torch.tools import dress_rehearsal

    h5py_here = importlib.util.find_spec("h5py") is not None
    predicted = rehearsal_predicted(h5py_here)
    log(f"14b rehearsal predicted launches (skinning, int8_conv) a stage: {predicted}")
    wd = os.path.join(root, "rehearsal")
    stamped = _StagedLines(sys.stdout)
    inputs = KernelInputs()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped), inputs.recording():
        summary = dress_rehearsal.run(wd, img_res=224, verts=10475)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    stages = stage_marks(list(zip(stamped.lines, stamped.counts)), t0)
    for tag, (skin, i8) in predicted.items():
        check(tag in stages, f"rehearsal: no {tag} line")
        got = stages[tag]
        check((got["lbs_skinning"], got["int8_conv"], got["int8_stem"]) == (skin, i8, i8 // 52),
              f"rehearsal {tag}: {got['lbs_skinning']} skinning, {got['int8_conv']} int8 "
              f"conv and {got['int8_stem']} stem launches, predicted {skin}, {i8} and "
              f"{i8 // 52}")
    check(summary["converter_roundtrip_max_err"] == 0.0, "rehearsal: round trip not equal")
    check(summary["benchtest_absdiff_pose_m1"] < 1e-3, "rehearsal: served pose diff")
    # the card machine has cmake: stage 9b must build the native client and run
    check("native_benchtest_absdiff_pose_m1" in summary,
          "rehearsal: stage 9b left the native C++ client out")
    check(summary["real_ft"]["loss"] < summary["real"]["loss"],
          "rehearsal: stage 7's fine-tune did not improve")  # asserted in run() as well
    for k in ("synth_bf16", "synth_int8", "real", "real_ft"):
        check(all(np.isfinite(v) for v in summary[k].values()), f"rehearsal: {k} not finite")
    check(h5py_here == ("h36m" in summary), "rehearsal: stage 10 ran without h5py or not "
          "with it")
    with open(os.path.join(wd, "rehearsal_summary.json")) as f:
        check(json.load(f).keys() == summary.keys(), "rehearsal: the summary file's keys")
    log(f"14b rehearsal in process at 224², 10,475 vertices: {total_s:.1f} s; stages "
        + json.dumps(stages) + f" [{card}]")
    log("14b rehearsal summary " + json.dumps(summary))
    checked = inputs.compare("14b rehearsal")

    root_dir = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "airpose_tpu_torch.tools.dress_rehearsal", "--workdir",
           os.path.join(root, "rehearsal_cli"), "--steps", "2", "--frames", "4", "--subjects",
           "2", "--img_res", "64", "--ba_iters", "2", "3", "--verts", "60", "--batch_size", "2",
           "--ft_steps", "8"]
    t0 = time.perf_counter()
    lines = []
    with subprocess.Popen(cmd, cwd=root_dir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True) as proc:
        try:
            for line in proc.stdout:
                lines.append((time.perf_counter(), line.rstrip("\n")))
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"the dress_rehearsal entry point exited {rc}: "
          + " | ".join(ln for _, ln in lines[-15:]))
    zeros = {k: 0 for k in kernel_counts()}
    cli_stages = {tag: round(v["s"], 2) for tag, v in
                  stage_marks([(tl, zeros) for tl in lines], t0).items()}
    with open(os.path.join(root, "rehearsal_cli", "rehearsal_summary.json")) as f:
        cli_summary = json.load(f)
    check(cli_summary["benchtest_absdiff_pose_m1"] < 1e-3, "rehearsal CLI: served pose diff")
    log(f"14b rehearsal entry point (64², 60 vertices, 8 fine-tune steps): exit {rc} after "
        f"{cli_s:.1f} s, stage seconds {cli_stages} [{card}]")
    return {"in_process": {"seconds": total_s, "stages": stages,
                           "predicted": {k: list(v) for k, v in predicted.items()},
                           "summary": summary, "kernels_vs_plain": checked},
            "entry_point": {"seconds": cli_s, "stages": cli_stages}}


ROOFLINE_LENGTH = 10


def phase_roofline(dev, root, card, phase8_step_ms):
    """14c: train_roofline at B = 30 of 224². Its entry point over the eight
    stages once each (one timed iteration: the smoke of the CLI and its
    skinning launches); then each stage on its own copy of the model,
    timed once: CUDA events over ROOFLINE_LENGTH iterations for its ms and
    peak memory, then 3 iterations under utils/profiling.trace for its
    device busy ms; and the full step and the trunk with --remat. The
    split and the idle shares come from that one timing."""
    from torch.autograd import DeviceType

    from airpose_tpu_torch.tools import train_roofline as tr
    from airpose_tpu_torch.utils.profiling import trace

    reset_kernel_counts()
    t0 = time.perf_counter()
    results = tr.main(["--batch", "30", "--img", "224", "--length", "1"])
    main_s = time.perf_counter() - t0
    launches = kernel_counts()["lbs_skinning"]
    # loss_fwd and loss_fwdbwd each skin 30 × 2 bodies once an iteration,
    # full at its eager and captured train steps; the synthetic batch's GT, once
    want = sum(graph_launches(1 + tr.WARMUP)) + 2 * (1 + tr.WARMUP) + 1
    check(launches == want, f"train_roofline: {launches} skinning launches, predicted {want}")
    check(set(results) == set(tr.ALL_STAGES) and all(np.isfinite(v) and v > 0
                                                     for v in results.values()),
          f"train_roofline stages {results}")
    model, smplx_params, cfg, batch = tr.build(30, 224, dev)
    detail = {}
    for remat in (False, True):
        names = tr.ALL_STAGES if not remat else ("full", "fwdbwd_trunk")
        for name, (fn, c0) in tr.stage_fns(model, smplx_params, cfg, batch, names,
                                           remat).items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = tr.time_stage(fn, c0, ROOFLINE_LENGTH, dev) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            with trace(os.path.join(root, "roofline_trace", name + ("_remat" * remat))) as prof:
                c = c0
                for _ in range(3):
                    c = fn(c)
            busy = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.name not in ("forward", "backward", "forward_backward",
                                          "optimizer")) / 1e3 / 3
            detail[name + (" --remat" if remat else "")] = {
                "ms": ms, "busy_ms": busy, "idle_share": 1 - busy / ms, "peak_gib": peak}
            del fn, c0, c
            torch.cuda.empty_cache()
    r = {k: detail[k]["ms"] for k in tr.ALL_STAGES}
    split = {"trunk fwd+bwd": r["fwdbwd_trunk"],
             "IEF+heads fwd+bwd": r["fwdbwd_model"] - r["fwdbwd_trunk"],
             "SMPL-X+loss fwd+bwd": r["loss_fwdbwd"], "optimizer": r["opt"],
             "residual": r["full"] - r["fwdbwd_model"] - r["loss_fwdbwd"] - r["opt"]}
    log(f"14c train_roofline entry point B = 30 of 224², 1 iteration a stage ({main_s:.1f} s, "
        f"{launches} skinning launches): ms {({k: v * 1e3 for k, v in results.items()})} [{card}]")
    log(f"14c per stage over {ROOFLINE_LENGTH} iterations (ms, busy ms, idle share, peak GiB "
        f"over the model): " + json.dumps(detail) + f" [{card}]")
    log(f"14c split of the full step {split}; phase 8's step {phase8_step_ms:.3f} ms [{card}]")
    return {"ms": r, "split": split, "detail": detail, "skinning_launches": launches,
            "phase8_step_ms": phase8_step_ms, "entry_point_s": main_s}


def phase_qat_posture(card):
    """14d: qat_posture at B = 30 of 224², two batches and a held-out one,
    2 + 2 steps (cut from the config of record's 240 + 160): every arm
    finite, the int8 conv launches as the code gives them."""
    from airpose_tpu_torch.tools import qat_posture

    pre, ft = 2, 2
    inputs = KernelInputs()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with inputs.recording():
        results = qat_posture.main(["--batch", "30", "--img", "224", "--num_batches", "2",
                                    "--steps_pre", str(pre), "--steps_ft", str(ft)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    # calibration (one dynamic trunk call) and four deployed arms: 52 convs each;
    # skinning once for the synthetic dataset's GT, once a train step, once in
    # the eval step and once a deployed loss
    want = {"int8_conv": 52 * (1 + 4), "int8_stem": 1 + 4,
            "lbs_skinning": 1 + pre + 3 * ft + 1 + 4}
    check(all(np.isfinite(v) for v in results.values()) and len(results) == 5,
          f"qat_posture arms {results}")
    for k, v in want.items():
        check(counts[k] == v, f"qat_posture: {counts[k]} {k} launches, predicted {v}")
    log(f"14d qat_posture B = 30 of 224², {pre} + {ft} steps: {results}, launches "
        f"{counts}, {seconds:.1f} s [{card}]")
    return {"results": results, "launches": counts, "seconds": seconds,
            "kernels_vs_plain": inputs.compare("14d qat_posture")}


def phase_prepare(root, card):
    """14e: prepare_real_capture and calibration on generated frames;
    to_hdf5 runs only where h5py is."""
    import importlib.util

    import cv2

    from airpose_tpu_torch.data.real import load_calib_yml
    from airpose_tpu_torch.tools import calibration, prepare_real_capture

    out = {"cv2": cv2.__version__, "aruco": hasattr(cv2, "aruco")}
    t = time.perf_counter()
    K_true = np.asarray([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    calib = _chessboard_frames(root, K_true)
    frames = [cv2.imread(os.path.join(calib, n)) for n in sorted(os.listdir(calib))]
    K, _, rms = calibration.calibrate_chessboard(frames, square_size=0.05)
    check(abs(K[0, 0] / 600.0 - 1) < 0.15 and rms < 1.0, f"chessboard calibration K {K}")
    machine = os.path.join(root, "machine_1")
    if out["aruco"]:
        capture = _aruco_frames(root, calibration.generate_aruco_marker(0, 200))
        prepare_real_capture.main(["--machine_dir", machine, "--calib", calib, "--capture",
                                   capture, "--calib_stride", "1", "--square_size", "0.05",
                                   "--marker_length", "0.5", "--plot-markers"])
        with open(os.path.join(machine, "markerposes_corrected_all.pkl"), "rb") as f:
            poses = pickle.load(f)
        check(len(poses) == 4 and all("0" in v for v in poses.values()),
              f"prepare_real_capture: markers in {len(poses)} of 4 frames")
        out["marker_distance_m"] = float(np.linalg.norm(poses["000000"]["0"]["tvec"]))
    else:
        log("14e this OpenCV has no cv2.aruco: the ArUco generation, detection and the "
            "markerposes step are left out")
        prepare_real_capture.main(["--machine_dir", machine, "--calib", calib,
                                   "--calib_stride", "1", "--square_size", "0.05",
                                   "--skip-aruco"])
    Ky = load_calib_yml(os.path.join(machine, "camera_calib.yml"))
    check(abs(Ky[0, 0] / 600.0 - 1) < 0.15, f"prepare_real_capture K {Ky}")
    if importlib.util.find_spec("h5py") is None:
        log("14e h5py is not installed here: to_hdf5 is left out")
        out["to_hdf5"] = "left out: no h5py"
    else:
        from airpose_tpu_torch.tools import to_hdf5

        n = to_hdf5.export_split(os.path.join(root, "aerialpeople_kernel"), "train",
                                 os.path.join(root, "train.h5"))
        out["to_hdf5"] = f"{n} samples"
    out["seconds"] = time.perf_counter() - t
    log(f"14e real-capture preparation: {out} [{card}]")
    return out


def phase_stem_batch(dev, card):
    """A gate: the int8 trunk's stem (ops/int8_trunk.int8_stem, the stem
    kernel) on one crop alone and as the first of 60 gives crop 0 the same
    map, and the int8 trunk the same features; and each of the 60 crops
    alone gets the features it gets in the 60-crop folded batch. cuDNN's
    bf16 stem (the plain version) at the same two sizes is logged beside it."""
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.ops import int8_stem as st
    from airpose_tpu_torch.ops import int8_trunk

    qp = int8_trunk.quantize_trunk_params(AirPoseTwoView(seed=0).to(dev).trunk.state_dict())
    crops = torch.randn(60, 224, 224, 3, generator=torch.Generator().manual_seed(3)).to(dev)
    scales = int8_trunk.calibrate_act_scales(qp, crops[:2])
    with torch.no_grad():
        one = int8_trunk.int8_stem(qp["stem"], crops[:1])[0]
        many = int8_trunk.int8_stem(qp["stem"], crops)[0]
        cudnn = [st.stem_conv_reference(x, qp["stem"]["w"])[0].float() for x in (crops[:1], crops)]
        folded = int8_trunk.resnet50_int8_infer(qp, crops, scales)
        alone = torch.cat([int8_trunk.resnet50_int8_infer(qp, crops[i:i + 1], scales)
                           for i in range(60)])
    out = {"stem_equal": torch.equal(one, many),
           "int8_features_equal": torch.equal(alone[0], folded[0]),
           "folded_batch_equal_alone": torch.equal(alone, folded),
           "folded_max_abs_diff": (alone - folded).abs().max().item(),
           "cudnn_stem_max_diff": (cudnn[0] - cudnn[1]).abs().max().item(),
           "cudnn_stem_differing_share": (cudnn[0] != cudnn[1]).float().mean().item()}
    log(f"14 int8 stem at B = 1 vs B = 60 (crop 0) and each of 60 crops alone vs folded: {out} "
        f"[{card}]")
    check(out["stem_equal"], "the int8 stem's map of crop 0 differs between B = 1 and B = 60")
    check(out["int8_features_equal"], "crop 0's int8 features differ between B = 1 and 60")
    check(out["folded_batch_equal_alone"],
          f"the 60-crop folded batch's int8 features differ from each crop's alone by "
          f"{out['folded_max_abs_diff']}")
    return out


def phase_tools(dev, card, phase8_step_ms):
    """Phase 14 in its own temporary directory."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="airpose_phase14_") as root:
        for name, fn in (("fixtures", lambda: phase_fixtures(root, card)),
                         ("rehearsal", lambda: phase_rehearsal(root, card)),
                         ("roofline", lambda: phase_roofline(dev, root, card, phase8_step_ms)),
                         ("qat_posture", lambda: phase_qat_posture(card)),
                         ("prepare", lambda: phase_prepare(root, card)),
                         ("stem_batch", lambda: phase_stem_batch(dev, card))):
            t = time.perf_counter()
            out[name] = fn()
            out[name + "_s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
    return out



# ---- phase 15: multi-device at world size 1 on NCCL -------------------------------------

CLUSTER_JOB = """import os


def train_job(argv, ckpt, runs):
    \"\"\"A trainer job that checkpoints and exits 3 on its first run (no
    checkpoint yet: --time_to_run 0) and finishes on its requeued run; ->
    the kernel launches of the run that finished.\"\"\"
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.train import trainer

    with open(runs, "a") as f:
        f.write("run\\n")
    trainer.main(argv + ([] if os.path.exists(ckpt) else ["--time_to_run", "0"]))
    return {k: _build.counts[k] for k in ("lbs_skinning", "int8_conv", "int8_stem")}
"""


def params_diff(a, b):
    """(tensors not bit-equal, max |difference|) over two name → tensor dicts."""
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    return len(unequal), max([(a[k].float() - b[k].float()).abs().max().item()
                              for k in unequal] or [0.0])


def phase15_global_bn(dev):
    """parallel.global_batch_norm over the NCCL group of one against the
    port's own BatchNorm (torch's kernels), forward and input gradient, on a
    bf16 NCHW map of layer1's shape: the same arithmetic in other orders."""
    import torch.distributed as dist

    from airpose_tpu_torch.models.resnet import BatchNorm2d
    from airpose_tpu_torch.parallel import global_batch_norm

    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(60, 256, 56, 56, device=dev, generator=g) * 2 + 0.5).to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    up = torch.randn(x.shape, device=dev, generator=g).to(torch.bfloat16)
    bn = BatchNorm2d(256).to(dev)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = bn(xa, train=True)
    (ga,) = torch.autograd.grad(ya, xa, up)
    yb = global_batch_norm(xb, bn.weight, bn.bias, rm, rv, bn.momentum, bn.eps,
                           dist.group.WORLD)
    (gb,) = torch.autograd.grad(yb, xb, up)
    rel = {"y": ((ya.float() - yb.float()).norm() / ya.float().norm()).item(),
           "dx": ((ga.float() - gb.float()).norm() / ga.float().norm()).item(),
           "running_mean": ((bn.running_mean - rm).abs().max()).item(),
           "running_var": ((bn.running_var - rv).abs().max() / bn.running_var.abs().max()).item()}
    log(f"15 global_batch_norm (NCCL, world 1) vs the local BatchNorm at (60, 256, 56, 56) "
        f"bf16: {rel} (bound {GLOBAL_BN_REL})")
    check(all(v <= GLOBAL_BN_REL for v in rel.values()), f"global_batch_norm: {rel}")
    return rel


def phase15_dp_step(dev, card):
    """One data-parallel train step on the mesh of one rank (NCCL) against
    the one-process step: bf16 AirPoseTwoView, B = 30 of 224², the same
    weights, batch and generator."""
    from airpose_tpu_torch import parallel
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns

    cfg = TrainConfig()
    B = cfg.batch_size
    smplx = synthetic_smplx_params().to(dev)
    batch = batch_slice(make_synthetic_dataset(smplx, B, seed=0), 0, B, dev)
    runs = {}
    for name, mesh in (("one process", None), ("mesh of 1", parallel.make_mesh(1))):
        model = AirPoseTwoView(dtype=torch.bfloat16, seed=0).to(dev)
        state, tx = create_train_state(model, cfg.lr)
        step, _ = make_twoview_step_fns(model, smplx, cfg, tx, mesh=mesh)
        reset_kernel_counts()
        t = time.perf_counter()
        state, metrics = step(state, parallel.shard_batch(batch, mesh),
                              torch.Generator(device=dev).manual_seed(cfg.seed))
        torch.cuda.synchronize()
        runs[name] = {"loss": metrics["loss"].item(), "s": time.perf_counter() - t,
                      "launches": kernel_counts(),
                      "params": {k: v.detach().clone() for k, v in state.params.items()},
                      "stats": {k: v.clone() for k, v in state.batch_stats.items()}}
        del model, state, step
    a, b = runs["one process"], runs["mesh of 1"]
    n_params, d_params = params_diff(a["params"], b["params"])
    n_stats, d_stats = params_diff(a["stats"], b["stats"])
    out = {"loss": (a["loss"], b["loss"]), "params_unequal": n_params,
           "params_max_abs_diff": d_params, "stats_unequal": n_stats,
           "stats_max_abs_diff": d_stats, "launches": b["launches"],
           "seconds": (a["s"], b["s"])}
    log(f"15 DP train step on a mesh of 1 (NCCL) vs one process, bf16 B = {B} of 224²: loss "
        f"{a['loss']!r} vs {b['loss']!r}; {n_params} parameter tensors of {len(a['params'])} "
        f"not bit-equal (max |diff| {d_params:.3e}), {n_stats} BN statistics (max "
        f"{d_stats:.3e}); launches {b['launches']} [{card}]")
    check(abs(a["loss"] - b["loss"]) <= 1e-3 * abs(a["loss"]) and d_params <= 3 * cfg.lr,
          f"the DP step on a mesh of 1 disagrees with the one-process step: {out}")
    check(b["launches"]["lbs_skinning"] == 1, f"DP step launches {b['launches']}")
    return out


def phase15_compile_mesh(dev, tmp, card):
    """compile_results --mesh 1 (--int8 --save-full) on phase 12's AerialPeople
    records with phase 10's last.ckpt, against the same CLI without --mesh."""
    from airpose_tpu_torch.eval import compile_results

    ckpt = os.path.join(tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt")
    common = ["--model", "copenet_twoview", "--ckpt", ckpt, "--datapath",
              os.path.join(tmp, "aerialpeople"), "--split", "test", "--batch_size",
              str(CLI_BATCH), "--smplx_model_dir", tmp, "--save-full", "--int8",
              "--platform", dev.type]
    res = {}
    for name, extra in (("one process", []), ("--mesh 1", ["--mesh", "1"])):
        out = os.path.join(tmp, f"mesh_{len(extra)}.pkl")
        reset_kernel_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            compile_results.main(common + ["--out", out] + extra)
        torch.cuda.synchronize()
        with open(out, "rb") as f:
            res[name] = (pickle.load(f)[0], kernel_counts())
    (want, n_want), (got, n_got) = res["one process"], res["--mesh 1"]
    rows = [sum(len(b["output"]["pred_angles0"]) for b in r) for r in (want, got)]
    diff = max(float(np.abs(gb["output"][k] - wb["output"][k]).max())
               for gb, wb in zip(got, want) for k in wb["output"])
    out = {"rows": rows, "batches": len(got), "max_abs_diff": diff, "launches": n_got}
    log(f"15 compile_results --mesh 1 --int8 --save-full on {rows[0]} AerialPeople records "
        f"vs one process: rows {rows}, max |diff| over every field {diff:.3e}; launches "
        f"{n_got} (one process {n_want}) [{card}]")
    check(rows[0] == rows[1] and len(got) == len(want) and diff <= 1e-5,
          f"compile_results --mesh 1 differs from one process: {out}")
    check(n_got == n_want and n_got["int8_stem"] > 0, f"--mesh 1 launches {n_got}, {n_want}")
    return out


def phase15_sharded_ba(dev, card):
    """bundle_adjust_sharded on the mesh of one rank over BA_FRAMES frames
    (the reference's chunk) against bundle_adjust, at BAConfig()."""
    from airpose_tpu_torch import parallel
    from airpose_tpu_torch.bodymodel import init_vposer_params, synthetic_smplx_params
    from airpose_tpu_torch.optim import BAConfig, BAState, bundle_adjust_sharded

    smplx, vposer = synthetic_smplx_params().to(dev), init_vposer_params(0).to(dev)
    problem = ba_problem(smplx, vposer, BA_FRAMES, 0, dev)
    cfg = BAConfig()
    t = time.perf_counter()
    want_state, want = run_ba(smplx, vposer, problem, cfg, dev)
    want_s = time.perf_counter() - t
    init, kp, intr = problem
    kp_t = torch.from_numpy(kp).to(dev)
    reset_kernel_counts()
    t = time.perf_counter()
    got_state, got = bundle_adjust_sharded(
        smplx, vposer, BAState(*(torch.from_numpy(a).to(dev) for a in init)), kp_t, kp_t,
        torch.from_numpy(intr).to(dev), cfg, mesh=parallel.make_mesh(1))
    got_s = time.perf_counter() - t
    launches = kernel_counts()
    trace_rel = float(np.max(np.abs(got["trace"] - want["trace"])
                             / (2e-4 * np.abs(want["trace"]) + 1e-5)))
    state_rel = max(float(np.max(np.abs(a.cpu().numpy() - b.cpu().numpy())
                                 / (1e-3 * np.abs(b.cpu().numpy()) + 2e-4)))
                    for a, b in zip(got_state, want_state))
    out = {"trace_last": (float(got["trace"][-1]), float(want["trace"][-1])),
           "trace_of_bound": trace_rel, "state_of_bound": state_rel, "seconds": (got_s, want_s),
           "launches": launches}
    log(f"15 --sharded AirPose+ on a mesh of 1 (NCCL) over {BA_FRAMES} frames, "
        f"{cfg.iters_stage1} + {cfg.iters_stage2} iterations, vs bundle_adjust: trace "
        f"{got['trace'][-1]:.6f} vs {want['trace'][-1]:.6f}, trace at {trace_rel:.3f} of its "
        f"bound (rtol 2e-4, atol 1e-5), state at {state_rel:.3f} of its bound (rtol 1e-3, "
        f"atol 2e-4); {got_s:.2f} s vs {want_s:.2f} s; launches {launches} [{card}]")
    check(trace_rel <= 1 and state_rel <= 1, f"sharded AirPose+ on a mesh of 1: {out}")
    check(launches["lbs_skinning"] == 0, f"the sharded inner loop skinned: {launches}")
    return out


def phase15_cluster(dev, tmp, card):
    """utils.cluster's local backend on a 2-step trainer job (synthetic://12,
    B = 2 of 64², on the card) that exits 3 once and is requeued."""
    from airpose_tpu_torch.utils import cluster

    root = os.path.join(tmp, "cluster")
    os.makedirs(root)
    with open(os.path.join(root, "smoke_job.py"), "w") as f:
        f.write(CLUSTER_JOB)
    sys.path.insert(0, root)
    try:
        import smoke_job

        logs, runs = os.path.join(root, "logs"), os.path.join(root, "runs.txt")
        ckpt = os.path.join(logs, "job", "version_0", "checkpoints", "last.ckpt")
        argv = ["--name", "job", "--version", "0", "--model", "copenet_twoview", "--datapath",
                "synthetic://12", "--log_dir", logs, "--batch_size", "2", "--val_batch_size",
                "2", "--max_steps", "2", "--val_every", "2", "--img_res", "64",
                "--platform", dev.type]
        t = time.perf_counter()
        (launches,) = cluster.mixedmap(smoke_job.train_job, [(argv, ckpt, runs)],
                                       os.path.join(root, "jobs"))
        secs = time.perf_counter() - t
    finally:
        sys.path.remove(root)
        sys.modules.pop("smoke_job", None)
    with open(runs) as f:
        n_runs = len(f.readlines())
    step = torch.load(ckpt, map_location="cpu", weights_only=False)["global_step"]
    log(f"15 utils.cluster local backend: the 2-step trainer job ran {n_runs} times (one exit "
        f"3, requeued), last.ckpt at step {step}, {secs:.1f} s; the finishing run's launches "
        f"{launches} [{card}]")
    check(n_runs == 2 and step == 2 and launches["lbs_skinning"] > 0,
          f"cluster job: {n_runs} runs, step {step}, launches {launches}")
    return {"runs": n_runs, "step": step, "seconds": secs, "launches": launches}


def phase15_parity(dev, tmp, card):
    """parity_run on a fixture bundle: phase 10's last.ckpt as the released
    weights, a precalc pkl from compile_results on phase 12's AerialPeople
    records, the 10,475-vertex body."""
    from airpose_tpu_torch.eval import compile_results
    from airpose_tpu_torch.tools import parity_run

    ckpt = os.path.join(tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt")
    data, work = os.path.join(tmp, "aerialpeople"), os.path.join(tmp, "parity")
    precalc = os.path.join(tmp, "precalc.pkl")
    with contextlib.redirect_stdout(io.StringIO()):
        compile_results.main(["--model", "copenet_twoview", "--torch_ckpt", ckpt, "--datapath",
                              data, "--split", "test", "--out", precalc, "--batch_size",
                              str(CLI_BATCH), "--smplx_model_dir", tmp,
                              "--platform", dev.type])
        reset_kernel_counts()
        t = time.perf_counter()
        report = parity_run.main(["--model", "copenet_twoview", "--torch-ckpt", ckpt,
                                  "--precalc", precalc, "--datapath", data,
                                  "--smplx-model-dir", tmp, "--workdir", work,
                                  "--batch_size", str(CLI_BATCH), "--platform", dev.type])
        secs = time.perf_counter() - t
    launches = kernel_counts()
    fields = {k: report["fields"][k]["max_abs"]
              for k in ("pred_angles0", "pred_smpltrans1", "pred_betas0", "pred_vertices_cam0")
              if k in report["fields"]}
    out = {"n": (report["n_ours"], report["n_precalc"]), "fields_max_abs": fields,
           "metric_deltas": report.get("metric_deltas"), "seconds": secs, "launches": launches}
    log(f"15 parity_run on a fixture bundle (phase 10's last.ckpt): {out} [{card}]")
    check(report["n_ours"] == report["n_precalc"] and all(v < 1e-5 for v in fields.values())
          and all(abs(d) < 1e-4 for d in report["metric_deltas"].values()),
          f"parity_run on the fixture bundle: {out}")
    return out


def phase_multidevice(dev, tmp, card):
    """Phase 15 in process: dryrun_multichip(1), then on a process group of
    one (NCCL) global BatchNorm, a DP train step, compile_results --mesh 1
    and --sharded AirPose+; then the cluster requeue and parity_run."""
    import torch.distributed as dist

    from airpose_tpu_torch.entry import dryrun_multichip
    from airpose_tpu_torch.parallel import launch

    out = {}
    t = time.perf_counter()
    reset_kernel_counts()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        kind, loss, ba_loss = dryrun_multichip(1)
    out["dryrun"] = {"kind": kind, "loss": loss, "ba_loss": ba_loss,
                     "launches": kernel_counts(), "seconds": time.perf_counter() - t}
    log(f"15 {printed.getvalue().strip()} ({out['dryrun']}) [{card}]")
    check(kind == "dp" and np.isfinite(loss) and np.isfinite(ba_loss)
          and not dist.is_initialized(), f"dryrun_multichip(1): {out['dryrun']}")
    launch.init_in_process(dev)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 15's group: {dist.get_backend()}, {dist.get_world_size()}")
        for name, fn in (("global_bn", lambda: phase15_global_bn(dev)),
                         ("dp_step", lambda: phase15_dp_step(dev, card)),
                         ("compile_mesh", lambda: phase15_compile_mesh(dev, tmp, card)),
                         ("sharded_ba", lambda: phase15_sharded_ba(dev, card))):
            t = time.perf_counter()
            out[name] = fn()
            out[name + "_s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for name, fn in (("cluster", lambda: phase15_cluster(dev, tmp, card)),
                     ("parity_run", lambda: phase15_parity(dev, tmp, card))):
        t = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - t
    return out


def bf16_steps(a, b):
    """Per value, how many bf16 steps apart the bf16 tensors ``a`` and ``b``
    are."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def add_layernorm_at(dev, rows=128 * 192, width=1280, scaled=False):
    """The fused add + LayerNorm + cast at HMR 2.0's 128 crops (a bf16
    branch and output, the blocks' case), or with ``scaled`` the LayerScale
    kernel (``x += γ · branch``, |γ| drawn in [0.05, 1], either sign) at the
    given rows,
    against its plain version, then the kernel, the plain ops, F.layer_norm
    alone (f32 in and out: the library yardstick) and the bound."""
    from torch.nn import functional as F

    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.ops import add_layernorm as aln

    g = torch.Generator(device=dev).manual_seed(3)
    x = 2 * torch.randn(rows, width, generator=g, device=dev) + 0.5
    branch = torch.randn(rows, width, generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(width, generator=g, device=dev)
    b = 0.1 * torch.randn(width, generator=g, device=dev)
    gamma = None
    if scaled:
        gamma = ((0.05 + 0.95 * torch.rand(width, generator=g, device=dev))
                 * torch.randn(width, generator=g, device=dev).sign())
    want_x = x.clone()
    want = aln.add_layernorm_reference(want_x, branch, w, b, 1e-6, torch.bfloat16, gamma)
    got = aln.add_layernorm(x, branch, w, b, 1e-6, torch.bfloat16, gamma)
    torch.cuda.synchronize()
    # the f32 rows differ by the statistics' order of summation (within 2e-6
    # of the largest output): one bf16 step, or more on outputs near 0
    steps, diff = bf16_steps(got, want), (got.float() - want.float()).abs()
    far = steps > 1
    out = {"rows": rows, "width": width, "x_equal": bool(torch.equal(x, want_x)),
           "max_steps": int(steps.max()),
           "share_off": float((steps > 0).float().mean()),
           "share_over_one_step": float(far.float().mean()),
           "max_abs_over_one_step": float(diff[far].max()) if bool(far.any()) else 0.0,
           "largest_output": float(want.float().abs().max())}
    check(out["x_equal"] and out["share_off"] < 1e-3
          and out["max_abs_over_one_step"] <= 2e-6 * out["largest_output"],
          f"add_layernorm disagrees with its plain version: {out}")
    out["ms"] = time_ms(lambda: aln.add_layernorm(x, branch, w, b, 1e-6, torch.bfloat16, gamma),
                        iters=50, warmup=5)
    out["plain_ms"] = time_ms(
        lambda: aln.add_layernorm_reference(x, branch, w, b, 1e-6, torch.bfloat16, gamma),
        iters=50, warmup=5)
    out["library_ms"] = time_ms(lambda: F.layer_norm(x, (width,), w, b, 1e-6), iters=50,
                                warmup=5)
    out["bound_ms"] = aln.add_layernorm_cost(x, branch, torch.bfloat16) / HBM_BYTES * 1e3
    out["ptxas"] = ptxas_lines(_build.build_log.get("add_layernorm", ""), "add_layernorm")
    log(f"add_layernorm ({rows}, {width}{', γ' if scaled else ''}): kernel {out['ms']:.4f} ms, "
        f"plain ops {out['plain_ms']:.4f} ms, F.layer_norm alone {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms (bytes), kernel at {out['bound_ms'] / out['ms']:.1%} of its "
        f"bound; {out}")
    return out


def phase_hmr2(dev, card):
    """Phase 16: SMPL's skinning shape, the fused norm point (HMR 2.0's and
    Multi-HMR's LayerScale one), the attention guard, the HMR 2.0 chain at
    the published widths against the benchmark's reference, and the norm
    points' launches in a Multi-HMR forward."""
    from torch.profiler import ProfilerActivity, profile

    from airpose_tpu_torch.bodymodel import cuda_lbs, synthetic_smpl_params
    from airpose_tpu_torch.models import vit as vit_mod
    from airpose_tpu_torch.models.multihmr import persons_from_centres
    from airpose_tpu_torch.ops import _build
    from airpose_tpu_torch.ops import add_layernorm as aln
    from airpose_tpu_torch.perception import perceive_hmr2, perceive_multihmr
    from benchmark.drivers import (program_body, worst_ray_angle, worst_row_cos_gap,
                                   worst_row_rel_l2)
    from benchmark.drivers.perceive_hmr2 import program_hmr2, program_smpl
    from benchmark.drivers.perceive_multihmr import intrinsics, program_multihmr
    from benchmark.inputs import perception_pool
    from benchmark.reference import hmr2 as ref
    from benchmark.reference import multihmr as mref

    out = {}
    B, V, J = 128, 6890, 24
    rng = np.random.default_rng(2)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    p = torch.from_numpy(rng.normal(size=(B, V, 3)).astype(np.float32)).to(dev)
    w = synthetic_smpl_params().lbs_weights.to(dev)
    out["skinning"] = skinning_at(w, torch.from_numpy(rel).to(dev), p)
    out["skinning"]["resources"] = cuda_lbs.kernel_resources(J)
    out["add_layernorm"] = add_layernorm_at(dev)
    out["add_layernorm_gamma"] = add_layernorm_at(dev, 16 * 4097, 1024, scaled=True)

    q = torch.randn(2, 16, 192, 80, device=dev, dtype=torch.float64)
    try:
        vit_mod.attention(q, q, q)
        raised = False
    except RuntimeError:
        raised = True
    check(raised, "models/vit.attention ran float64 inputs: the math backend was taken")

    cfg = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                                      "configs", "hmr2_vith.json")))
    limits = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "benchmark", "workloads",
                                         "perceive_hmr2_vith_b64.json")))["limits"]
    model = program_hmr2(cfg, ref.make_state(cfg, 11, dev), dev)
    body = ref.make_smpl(12, V, dev)
    smpl = program_smpl(body)
    b = perception_pool(13, 1, 64, cfg["crop"], dev)[0]
    seen = {}
    model.backbone.register_forward_hook(lambda m, a, o: seen.update(tokens=o))
    calls, launches, norms = (model.attention_calls, _build.counts["lbs_skinning"],
                              _build.counts["add_layernorm"])
    verts, j2d = perceive_hmr2(model, smpl, b["images"], b["bb"], b["intr"])
    torch.cuda.synchronize()
    out["attention_calls_a_call"] = model.attention_calls - calls
    out["skinning_launches_a_call"] = _build.counts["lbs_skinning"] - launches
    out["add_layernorm_launches_a_call"] = _build.counts["add_layernorm"] - norms
    check(out["attention_calls_a_call"] == 44, f"attention calls a call: {out}")
    check(out["skinning_launches_a_call"] == 1, f"skinning launches a call: {out}")
    check(out["add_layernorm_launches_a_call"] == 2 * model.backbone.cfg.depth + 1,
          f"add_layernorm launches a call: {out}")
    check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()), "non-finite outputs")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        perceive_hmr2(model, smpl, b["images"], b["bb"], b["intr"])
        torch.cuda.synchronize()
    attn = sorted({e.key for e in prof.key_averages()
                   if any(t in e.key.lower() for t in ("flash", "fmha", "efficient", "attention"))})
    log(f"hmr2 attention kernels: {attn}")
    check(any("flash" in k.lower() for k in attn) and any("fmha" in k.lower() or "efficient"
                                                            in k.lower() for k in attn),
          f"the chain's attention kernels are not the flash and memory-efficient ones: {attn}")
    out["attention_kernels"] = attn
    fps_ms = wall_ms(lambda: perceive_hmr2(model, smpl, b["images"], b["bb"], b["intr"]),
                     iters=10, warmup=2)
    out["call_ms"], out["two_view_fps"] = fps_ms, 64 / fps_ms * 1e3
    tokens = seen["tokens"]
    with mock.patch.object(vit_mod, "add_layernorm", aln.add_layernorm_reference):
        out["call_ms_three_ops"] = wall_ms(
            lambda: perceive_hmr2(model, smpl, b["images"], b["bb"], b["intr"]), iters=10,
            warmup=2)
    log(f"hmr2 chain: {fps_ms:.3f} ms a call with the fused norm points, "
        f"{out['call_ms_three_ops']:.3f} ms with the plain three ops [{card}]")
    del model
    torch.cuda.empty_cache()

    sd = ref.make_state(cfg, 11, dev)
    with torch.no_grad():
        x = b["images"].flatten(0, 1)
        rt = ref.backbone(sd, cfg, x)
        tv, tj = ref.perceive_tail(sd, cfg, body, tokens.reshape(64, 2, *tokens.shape[1:]),
                                   b["bb"], b["intr"], cfg["crop"])
    m = rt.mean(0)
    out["tokens_cos_gap"] = worst_row_cos_gap(tokens - m, rt - m)
    out["tokens_call_rel"] = float((tokens - rt).norm() / rt.norm())
    out["tail_vertices_rel"] = worst_row_rel_l2(verts, tv, 2)
    out["joints2d_ray_angle"] = worst_ray_angle(j2d, tj, b["intr"])
    for k in ("tokens_cos_gap", "tokens_call_rel", "tail_vertices_rel", "joints2d_ray_angle"):
        check(out[k] <= limits[k], f"hmr2 {k} {out[k]} above the cell's limit {limits[k]}")
    del sd, rt, tokens
    torch.cuda.empty_cache()

    # Multi-HMR at its published sizes on one two-view 896² frame, four
    # persons given: each of the 49 norm points one LayerScale launch
    mcfg = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                                       "configs", "multihmr_vitl896.json")))
    mmodel = program_multihmr(mcfg, mref.make_state(mcfg, 21, dev), dev)
    mbody = program_body(mref.make_body(22, mcfg["smplx"]["num_vertices"], dev))
    S = mcfg["crop"]
    frames = torch.randint(0, 256, (1, 2, S, S, 3), generator=torch.Generator(
        device=dev).manual_seed(23), device=dev, dtype=torch.uint8)
    uv = torch.tensor([[100.0, 200.0], [450.5, 451.0], [890.0, 13.0], [30.0, 700.0]], device=dev)
    persons = persons_from_centres(uv, torch.tensor([0, 0, 0, 1], device=dev), 2,
                                   mcfg["backbone"]["patch"], mcfg["backbone"]["grid"], slots=3)
    K = intrinsics(S, dev).expand(1, 2, 3, 3)
    reset_kernel_counts()
    got = perceive_multihmr(mmodel, mbody, frames, K, persons)
    torch.cuda.synchronize()
    out["multihmr_add_layernorm_launches_a_call"] = _build.counts["add_layernorm"]
    check(out["multihmr_add_layernorm_launches_a_call"] == 2 * mcfg["backbone"]["depth"] + 1,
          f"add_layernorm launches a Multi-HMR call: {out}")
    check(bool(torch.isfinite(got.vertices).all() and torch.isfinite(got.j2d).all()),
          "non-finite Multi-HMR outputs")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"phase 16: {json.dumps(out)} [{card}]")
    del mmodel, mbody, got
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import airpose_tpu_torch  # noqa: F401  (turns TF32 off)
    from airpose_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"build: {seconds:.1f} s")
    for name, text in sorted(_build.build_log.items()):
        log(f"--- nvcc {name}.cu\n{text.strip()}")
    if sys.argv[1:] == ["--only", "hmr2"]:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
        phase_hmr2(dev, smi.splitlines()[0])
        print(smi.splitlines()[0])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = [phase_skinning(dev), phase_stage1(dev)]
    launches = phase_chain(dev)

    from airpose_tpu_torch.ops.int8_bottleneck import (quantize_trunk_blocks,
                                                       resnet50_int8_block_infer)
    from airpose_tpu_torch.perception import bench_inputs, build_perception, chain_ops

    model, smplx_params, int8_features = build_perception(dev, trunk="int8")
    qparams, act_scales = int8_features.args[0], int8_features.keywords["act_scales"]
    blocks = quantize_trunk_blocks(qparams, act_scales)
    block_features = partial(resnet50_int8_block_infer, model.trunk, blocks)
    inputs = bench_inputs(64, dev)
    crops = inputs[0].reshape((128,) + inputs[0].shape[2:])
    kernels.append(phase_int8_conv(dev, qparams, act_scales, crops))
    kernels.append(phase_stem(dev, qparams, crops))
    kernels.append(phase_int8_blocks(dev, model, blocks, crops))
    int8_launches = phase_int8_chains(
        dev, model, smplx_params,
        (("int8", int8_features, 52, 0, 1), ("int8_block", block_features, 42, 13, 0)),
        inputs, chain_ops(model, "bf16"))
    del model, smplx_params, int8_features, qparams, blocks, block_features, inputs, crops
    torch.cuda.empty_cache()
    kernels[0]["backward"], train, (smplx_params, batch, preds) = phase_train(dev)
    log(json.dumps({"train_step": train}))
    t9 = time.perf_counter()
    families = {"eval_metrics": phase_eval_metrics(smplx_params, batch, preds)}
    families["train_steps"] = phase_families(dev, smplx_params, batch)
    families["sep_serving"] = phase_sep_serving(dev, batch)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    log(json.dumps({"families": families}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    card = smi.splitlines()[0]
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="airpose_phase10_") as tmp:
        phase10 = {"cli": phase_cli(dev, tmp, card, train["step_ms"]),
                   "pipeline": phase_pipeline(dev, card),
                   "readers": phase_readers(dev, tmp, smplx_params, card)}
        phase10["seconds"] = time.perf_counter() - t10
        log(f"phase 10: {phase10['seconds']:.1f} s [{card}]")
        log(json.dumps({"phase10": phase10}))
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        # the README's chain warm-starts from phase 10's run (its last.ckpt, step 30)
        phase11 = phase_real(dev, tmp, card, smplx_params, train["step_ms"], os.path.join(
            tmp, "logs", "smoke", "version_0", "checkpoints", "last.ckpt"))
        phase11["seconds"] = time.perf_counter() - t11
        log(f"phase 11: {phase11['seconds']:.1f} s [{card}]")
        log(json.dumps({"phase11": phase11}))
        del smplx_params, batch, preds
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        phase12, kernels[0]["at_b2000"] = phase_eval(dev, tmp, card)
        phase12["seconds"] = time.perf_counter() - t12
        log(f"phase 12: {phase12['seconds']:.1f} s [{card}]")
        log(json.dumps({"phase12": phase12}))
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        phase13, int8_at_1_crop, kernels[0]["at_b1"] = phase_serving(dev, tmp, card)
        phase13["seconds"] = time.perf_counter() - t13
        log(f"phase 13: {phase13['seconds']:.1f} s [{card}]")
        log(json.dumps({"phase13": phase13}))
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        phase14 = phase_tools(dev, card, train["step_ms"])
        phase14["seconds"] = time.perf_counter() - t14
        log(f"phase 14: {phase14['seconds']:.1f} s [{card}]")
        log(json.dumps({"phase14": phase14}))
        torch.cuda.empty_cache()
        # phase 15 reads phase 10's last.ckpt and npz and phase 12's records
        t15 = time.perf_counter()
        phase15 = phase_multidevice(dev, tmp, card)
        phase15["seconds"] = time.perf_counter() - t15
    log(f"phase 15: {phase15['seconds']:.1f} s [{card}]")
    log(json.dumps({"phase15": phase15}))
    torch.cuda.empty_cache()
    hmr2 = phase_hmr2(dev, card)
    kernels[0]["at_smpl_shape"] = hmr2["skinning"]
    kernels.append({"name": "add_layernorm", "route": "cuda",
                    "source": "airpose_tpu_torch/csrc/add_layernorm.cu",
                    "replaces": "no TPU kernel (port only: HMR 2.0's residual add, LayerNorm "
                                "and bf16 cast, three PyTorch passes a norm point)"}
                   | hmr2["add_layernorm"]
                   | {"gamma_at_multihmr_rows": {
                       k: hmr2["add_layernorm_gamma"][k]
                       for k in ("rows", "ms", "plain_ms", "library_ms", "bound_ms",
                                 "max_steps", "share_off")},
                      "multihmr_launches_a_call":
                          hmr2["multihmr_add_layernorm_launches_a_call"]})
    launches["add_layernorm"] = hmr2["add_layernorm_launches_a_call"]
    # launches: kernel launches in the main path's run of the chain that uses
    # each kernel (int8_block: its 42 conv launches, beside its 13 block calls)
    launches["int8_conv"] = int8_launches["int8"]["int8_conv"]
    launches["int8_stem"] = int8_launches["int8"]["int8_stem"]
    launches["int8_block"] = int8_launches["int8_block"]["int8_conv"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "int8_block":
            k["blocks"] = int8_launches["int8_block"]["int8_block"]
    # launches on phase 9's paths: skinning at each family's eager and
    # captured train step (none at a replay) and twice in the eval metrics, the int8 conv in the _sep int8 inference
    kernels[0]["phase9_launches"] = {
        **{f"{f} train steps (eager, capture, replays)": v["skinning_launches_by_step"]
           for f, v in families["train_steps"].items()},
        "twoview_eval_metrics": families["eval_metrics"]["skinning_launches"]}
    next(k for k in kernels if k["name"] == "int8_conv")["phase9_launches"] = {
        "_sep int8 inference": families["sep_serving"]["int8"]["launches"]["int8_conv"]}
    # launches on phase 10's paths: skinning in the CLI run, a CLI train step
    # (2 of 20 skin: the eager and the captured), val batch and summary grid
    # and the set-up, as counted in each call, and
    # in the readers' precompute (once a 256-body chunk)
    per_call = phase10["cli"]["launches_per_call"]
    kernels[0]["phase10_launches"] = {
        "CLI run of 20 steps and 2 val passes": phase10["cli"]["launches"]["lbs_skinning"],
        "CLI train step": per_call["train"], "CLI val batch": per_call["val"],
        "CLI summary grid": per_call["grid"], "CLI set-up": per_call["set-up"],
        "precompute_canonical_gt of 300 bodies": phase10["readers"]["precompute_launches"]}
    # launches on phase 11's paths, each counted in the run: one an eager or
    # captured real step (60 bodies two-view, 30 single-view), one a val batch and a grid of the
    # real CLI run, and the reg-only fine-tune's
    real, real_cli = phase11["steps"], phase11["cli"]
    kernels[0]["phase11_launches"] = {
        "real two-view train step (bodies)": real["twoview"]["skinning_bodies_a_step"],
        "hmr_camswap_difffl train step (bodies)":
            real["hmr_camswap_difffl"]["skinning_bodies_a_step"],
        "real copenet_twoview_sep train step (bodies)":
            real["copenet_twoview_sep"]["skinning_bodies_a_step"],
        "CLI real:// run of 10 steps and 1 val pass": real_cli["launches"],
        "CLI real:// train step": real_cli["launches_per_call"]["train"],
        "CLI real:// val batch": real_cli["launches_per_call"]["val"],
        "CLI real:// summary grid": real_cli["launches_per_call"]["grid"],
        "CLI real:// --train_reg_only run of 2 steps": real_cli["reg_only"]["launches"]}
    # launches on phase 12's paths, each counted in its pass: skinning in
    # the eval passes (the eval loss a batch, --save-full's two forwards a
    # batch, the metrics), the readers' precompute and the AirPose+ export
    # (none in its optimisation); the int8 conv in the --int8 pass
    passes = phase12["passes"]
    kernels[0]["phase12_launches"] = {
        **{name: v["skinning_launches"] for name, v in passes.items()
           if isinstance(v, dict) and "skinning_launches" in v},
        "precompute_canonical_gt of 300 bodies": len(passes["precompute_canonical_gt"]),
        "AirPose+ optimisation (2,000 frames, 300 iterations)": 0,
        "export_results of 2,000 bodies": phase12["airpose_plus"]["export_launches"]}
    next(k for k in kernels if k["name"] == "int8_conv")["phase12_launches"] = {
        name: v["int8_conv_launches"] for name, v in passes.items()
        if isinstance(v, dict) and v.get("int8_conv_launches")}
    # launches on phase 13's path, each counted in its run: skinning once a
    # message the viz CLI renders; the int8 conv 52 times at a regressor's
    # calibration, clip report, eager first step-1 call and capture (the
    # host counter does not see graph replays)
    n13 = phase13["frames"]
    kernels[0]["phase13_launches"] = {
        f"viz CLI, {VIZ_FRAMES} served messages": phase13["viz"]["skinning_launches"]}
    int8_row = next(k for k in kernels if k["name"] == "int8_conv")
    int8_row["phase13_launches"] = {
        f"--int8 benchtest, 2 servers × {n13} frames":
            phase13["served"]["int8"]["launches"]["int8_conv"],
        f"staged int8, 3 rounds × {n13} frames × 2 views":
            phase13["staged"]["int8"]["launches"]}
    int8_row["at_1_crop"] = int8_at_1_crop
    # launches on phase 14's paths, each counted in its run: skinning once a
    # pose of create_aerialpeople, in each rehearsal stage, in the roofline's
    # full and loss stages and in qat_posture; the int8 conv in the
    # rehearsal's --int8 eval and in qat_posture's calibration and four arms
    rehearsal = phase14["rehearsal"]["in_process"]["stages"]
    kernels[0]["phase14_launches"] = {
        "create_aerialpeople, 20 poses": phase14["fixtures"]["kernel_launches"],
        **{f"dress rehearsal {tag}": v["lbs_skinning"] for tag, v in rehearsal.items()},
        "train_roofline entry point, 1 iteration and 2 warm-up a stage":
            phase14["roofline"]["skinning_launches"],
        "qat_posture, 2 + 2 steps": phase14["qat_posture"]["launches"]["lbs_skinning"]}
    int8_row["phase14_launches"] = {
        "dress rehearsal [4/10] --int8 eval": rehearsal["[4/10]"]["int8_conv"],
        "qat_posture, calibration and 4 deployed arms":
            phase14["qat_posture"]["launches"]["int8_conv"]}
    # each kernel on the inputs phase 14's rehearsal and qat_posture gave it,
    # at every shape, against its plain version
    checked = {"dress rehearsal": phase14["rehearsal"]["in_process"]["kernels_vs_plain"],
               "qat_posture": phase14["qat_posture"]["kernels_vs_plain"]}
    for row, name in ((kernels[0], "lbs_skinning"), (int8_row, "int8_conv")):
        row["phase14_vs_plain"] = {part: v[name] for part, v in checked.items()}
    # the stem kernel: one launch a call of the int8 trunk, on each phase's
    # int8 path, each counted in its run
    stem_row = next(k for k in kernels if k["name"] == "int8_stem")
    stem_row["phase9_launches"] = {
        "_sep int8 inference": families["sep_serving"]["int8"]["launches"]["int8_stem"]}
    stem_row["phase12_launches"] = {name: v["int8_stem_launches"] for name, v in passes.items()
                                    if isinstance(v, dict) and v.get("int8_stem_launches")}
    stem_row["phase13_launches"] = {
        f"--int8 benchtest, 2 servers × {n13} frames":
            phase13["served"]["int8"]["launches"]["int8_stem"],
        f"staged int8, 3 rounds × {n13} frames × 2 views":
            phase13["staged"]["int8"]["launches"] // 52}
    stem_row["phase14_launches"] = {
        "dress rehearsal [4/10] --int8 eval": rehearsal["[4/10]"]["int8_stem"],
        "qat_posture, calibration and 4 deployed arms":
            phase14["qat_posture"]["launches"]["int8_stem"]}
    stem_row["phase15_launches"] = {
        "compile_results --mesh 1 --int8": phase15["compile_mesh"]["launches"]["int8_stem"]}
    stem_row["batch_invariance"] = phase14["stem_batch"]
    # phase 15's launches of skinning and the int8 conv on each path
    kernels[0]["phase15_launches"] = {
        name: phase15[name]["launches"]["lbs_skinning"]
        for name in ("dryrun", "dp_step", "compile_mesh", "sharded_ba", "cluster", "parity_run")}
    int8_row["phase15_launches"] = {
        "compile_results --mesh 1 --int8": phase15["compile_mesh"]["launches"]["int8_conv"]}
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    log(f"card after the run: {' / '.join(clocks.splitlines())}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
