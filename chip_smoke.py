#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--steps N] [--profile FILE]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
imports nothing of JAX or of the JAX package. Phases:

1. the device: name and power limit (``nvidia-smi``), TF32 off;
2. the build: the CUDA kernels of ``multimodal_dmm_tpu_torch/csrc`` with
   nvcc for sm_90a;
3. each kernel against its plain PyTorch version at the main path's
   shapes (T = 25, B = 100 variant columns, D = H = 256, (M, K) = (3, 1),
   (3, 25), (5, 1)), with their times and the card's bound, in float32
   and for the route the kernels take (three TF32 passes on the tensor
   cores); the backward is held to the plain backward run on its own ReLU
   masks in the GTF's first layers, each unit where those differ from the
   plain masks within rounding of 0 (``relu_flip_bound``), and two runs
   of it must agree bit for bit; the weight-gradient kernel's device time
   on rows at its padded widths, as the backward launches it, beside its
   library yardstick (four ``torch.mm`` and the bias sums); the forward
   kernel also at the evaluation's smoothing shape (T = 56, B = 25, (M,
   K) = (5, 1)), a row of its own;
4. the Weizmann BFVI training step at full width (weights from --seed,
   a synthetic batch of T = B = 25, KLD multiplier 1 as at the end of the
   trainer's anneal): one step's loss and gradients on the kernels
   against the same step on the plain versions, then --steps optimizer
   steps through the kernels, with their launch counts and the median
   step time;
5. the PoE + sampling cell kernel against its plain version at the
   evaluation's shapes ((M, K, B, D) = (3, 200, 25, 256), the
   200-particle filter pass, and (5, 1, 25, 256)), with its device time,
   the plain version's and the card's bound;
6. the Weizmann BFVI evaluation (``WeizmannTrainer.evaluate``, the app's
   task: half of each sequence's steps deleted at random; 200 filter
   particles, MAP smoothing) on the weights trained in phase 4, over ten
   synthetic sequences of 30-60 steps (one batch of 25 with 15 ghost
   columns): on the kernels, then on the plain versions with the same
   generator seed, the metrics compared; then N_EVALS timed calls, with
   the launch counts and the median ms per call;
7. the step that the JAX package's bench.py times (bf16 codecs,
   ``ragged_mode_scans``, video in the codec-native layout) at full width
   on the seed's weights, on the kernels, on the same noise, on a batch of
   phase 4's sequences from the device loader (``DeviceTrainData``, burst
   deletion), stored native and stored edge, whose batches must agree
   permuted: the native step against the same trainer fed the edge-layout
   batch (loss within STEP_LOSS_RTOL, each gradient leaf within BF16_TOL's
   rtol in relative Frobenius norm; the f32 step in the two layouts
   within STEP_GRAD_TOL's), and against the f32 step (loss within
   BF16_TOL, the bf16 codecs' tolerance of the CPU tests, each gradient
   leaf within BF16_GRAD_RTOL). The port's ragged pass is the two-scan
   step's loop, which phase 4 holds to its plain version. Then the merged
   branch (``merge_mode_scans``: one scan of 2 V B = 200 columns at K =
   25) once on the kernels, its loss and gradients finite; then the bench
   configuration beside the f32 two-scan and merged steps, timed in
   turns, with its launch counts and each one's device time
   (torch.profiler);
8. the command line (``apps.weizmann.main``) in a temporary working and
   save directory: a ``gen_synthetic`` fixture of 90 sequences, 2 epochs
   of bf16 ragged training with the device loader, the 200-particle
   evaluation after each, best.pth, epoch_N.pth and last.pth; every
   epoch's loss finite; then ``--load last.pth --evaluate`` twice under
   one seed, with identical metrics; the seconds per epoch and per
   evaluation, and the launch counts of the run;
9. the kernels at the spirals app's shapes (z = 5, h = 20, which the
   scan kernels run zero-padded to D = 8): the (M, K) of the spirals
   training step's three scans, read from one step on the kernels (the
   rule that gives Weizmann's: M = 2, 2 and 4, K = 1, 25 and 1, at T =
   100 and 3 V B = 300 columns), then phase 3's checks at those shapes
   and at the evaluation's smoothing shape (T, B, M, K) = (100, 100, 4,
   1), and the cell at (M, K, B, D) = (2, 200, 100, 5) and (4, 1, 100, 5)
   with phase 5's;
10. spirals BFVI at full width (T = 100, B = 100): one step's loss and
   gradients on the kernels against the plain versions (phase 4's
   checks) and timed steps; then ``apps.spirals.main`` in a temporary
   directory on the corpus the port generates: 2 epochs of ``--method
   bfvi`` with the 200-particle evaluation after each, every loss finite,
   the launch counts checked; ``--load last.pth --evaluate`` twice under
   one seed, with identical metrics;
11. the baselines: on the spirals batch, the DKS (``b-skip``, ``f-mask``)
   and VRNN MAP forward and one MAP step's loss and gradients on the card
   against the port on the CPU (loss rtol 1e-4, each gradient leaf 5e-3
   in relative Frobenius norm), with timed steps; one epoch each of
   ``--method b-mask`` and ``--model vrnn`` through ``apps.spirals.main``;
   Weizmann ``--method f-mask`` at full width through
   ``apps.weizmann.main`` on a phase-8 fixture: one epoch and an
   evaluation, then ``--load last.pth --evaluate`` twice, identical; the
   Weizmann DKS step timed;
12. the VidTIMIT app at full width (video 3x64x64 and audio 10x1281, both
   Bernoulli, z = h = 256) on a ``gen_synthetic`` fixture of the real
   corpus's size (43 subjects x 10 sentences, 40-80 steps): the (M, K)
   of the training step's three scans read from one step on a fixture
   batch ((2, 1), (2, 25), (4, 1) at 3 V B = 75 columns), phase 3's checks
   at those shapes at T = 80 and at the smoothing shape (80, 25, 4, 1),
   the cell at (2, 200, 25, 256) and (4, 1, 25, 256); one BFVI step on
   the kernels against the plain versions (phase 4's checks, the batch
   in the codec-native layout); timed f32, bf16 and DKS f-mask steps with
   their device busy time; then ``apps.vidtimit.main``: 2 epochs of
   ``--method bfvi`` with the 200-particle evaluation after each, the
   checkpoints, the launch counts (3 of each scan kernel a step, per
   evaluation one forward scan a batch and the cell at each step), and
   ``--load last.pth --evaluate`` twice, identical;
13. the experiment layer, in a directory of its own, on phase 10's
   spirals corpus and phase 11's Weizmann fixture: (a) ``python -m
   multimodal_dmm_tpu_torch.experiments.spirals_suite`` with each trial
   in its own worker process (five methods, seed 0, 2 epochs, z = 5, h =
   20, B = 100), every trial TERMINATED, exit code 0, the four CSVs
   (five methods x five tasks) finite; the seconds of a fresh worker's
   imports, CUDA context and kernel libraries, of each trial's parts
   (process start, data, model, epochs, evaluations, checkpoints), and of
   the analysis per trial and per task, read from the output's lines as
   they arrive; (b) ``weizmann_semisup``'s grid in this process (levels
   0.0 and 0.5 x 2 seeds, 2 epochs, z = h = 256, ``--method bfvi``), the
   kernels' launches against the trials' steps and evaluation batches (3
   of each scan kernel a step; per evaluation batch one forward scan and
   the cell at each step), the seconds of each trial, then
   ``analyze_best3``'s two CSVs, two levels, finite; (c) the grid again
   with ``--resume``: every trial already done, nothing launched; (d)
   ``--find_best`` through ``apps.weizmann.main`` on the grid's first
   trial: a best epoch of 1 or 2, best.pth rewritten, finite metrics;
14. data parallelism (``multimodal_dmm_tpu_torch/parallel``), the Weizmann
   model at full width, each rank a process of ``parallel.launch`` on
   cuda:0: (a) one NCCL rank, the sampled default step at B = 25 through
   ``make_dp_train_step``; (b) two gloo ranks sharing the card, B = 24 (cut
   from 25 so that 2 divides it), a MAP and a sampled step; (c) 2x2 gloo
   ranks, the same; each mode's step from the seed's weights against the
   single process's on the whole batch with the same noise seed (loss
   within STEP_LOSS_RTOL, each gradient leaf within STEP_GRAD_TOL's rtol in
   relative Frobenius norm), every rank's weights identical after its
   steps, three launches of each scan kernel a step on every rank, and
   each rank's step time (ranks that time-slice one card: not a scaling
   figure); (d) ``apps.weizmann --mesh 2`` on this one-card machine raises
   "needs 2 devices";
15. ``bf16_gtf`` (the JAX package's ``MultiDMM(bf16_gtf=True)``: every GTF
   product in bfloat16), Weizmann at full width: (a) the bf16 library's
   ``-Xptxas -v`` lines; each scan kernel's bfloat16 variant (the two
   scans: clusters over column groups, ``csrc/bf16_scan.cuh``) against its
   bfloat16 plain version at the step's three shapes and at the spirals
   shapes (outputs at BF16_TOL, the backward's and the weight gradients'
   outputs each within BF16_GRAD_RTOL in relative Frobenius norm, the
   backward on its own ReLU masks, its flips within
   ``relu_flip_bound(D, bf16=True)``; the backward's recomputed transition
   equal to the forward's own bit for bit, 0 ReLU flips), with their
   times, each scan's beside its float32 twin's in the same call, their
   launch plans (clusters, waves on the card, resident or streamed) and
   their bound at one bf16 pass (PEAK_BF16_FLOPS); the bf16 weight-gradient
   kernel (``csrc/wgrad_bf16.cuh``) on rows in the bf16 backward's form
   (bfloat16 rows, ``BIAS_CHUNKS`` partials of the float32 bias sums,
   as the tiled route hands them over) against
   ``gtf_wgrad_bf16_ref``, two runs bit for bit, its library yardstick
   ``torch.mm(..., out_dtype=torch.float32)`` on the same rows; (b)
   one ``bf16_gtf`` step on the kernels against the plain versions (loss
   within BF16_GTF_LOSS_RTOL, each leaf within BF16_GRAD_RTOL), then the
   step timed in turns beside the float32 step and the bench
   configuration with ``bf16_gtf``, each with its device time; (c) the
   evaluation (200-particle cell filter) on the kernels against the plain
   versions, metrics within BF16_GTF_EVAL_RTOL; (d) torch.profiler's
   kernel names of one step: every scan launch a bf16 variant; (e)
   ``apps.weizmann.main --model_args '{bf16_gtf: true}'``: one epoch, then
   ``--load last.pth --evaluate --save_args '{skip: true}'``;
16. every width and particle count that the reference takes: (a) phase 3's
   and 15 (a)'s checks at one launch each (T = 25, M = 3): the float32
   kernels at K = 50 (100 columns) and K = 256 (25 columns), the bf16
   cluster route at K = 50, the bf16 tiled route (``..._bf16_tiled``,
   where no cluster holds a column's operands) at K = 100 and at z = h =
   768, K = 25; (b) one Weizmann step with ``train_particles: 50``, float32
   (phase 4's checks) and ``bf16_gtf`` (phase 15 (b)'s on the kernel's
   masks); (c) one ``bf16_gtf`` step at z = h = 768 (its K = 25 scan on the
   tiled route); the launches of each of the three steps' kernel runs by
   route, counted from 0 just before the run and read just after it,
   every kernel of those steps launched;
17. results export and evaluation across ranks: (a) ``apps.weizmann``'s
   command line (``Trainer.main`` of a ``WeizmannTrainer`` that keeps each
   set's results) with ``--load last.pth --evaluate --visualize`` on phase
   8's fixture and checkpoint, the default save_args: the collect path's
   launches (the forward scan once a batch, the cell at each of its
   steps), then, where cv2 is installed, each set's AVI read back (a frame
   for each step, 3 x 64 wide, the reconstruction's luma within
   AVI_LUMA_TOL off the label rows: fourcc 0 stores YUV 4:2:0), and where
   matplotlib is, each set's PDF; a renderer that is not installed is
   printed as such and its output not checked; (b) the evaluation of phase
   6's ten sequences on phase 8's checkpoint (the 200-particle filter and
   MAP smoothing) on the device path and the collect path, with a batch of
   25 columns (replicated: 2 does not divide it) and of 10 (split), and a
   MAP evaluation (the forward scan alone) on the device path, on 2 and
   2x2 gloo ranks sharing the card against this process: every
   per-sequence and summed metric and summary within STEP_LOSS_RTOL
   (accuracies: at most EVAL_LABEL_FLIPS decisions), every rank's launches
   those of the single process.

Any failed check raises, so the script exits non-zero before its last
line. The line before the last is a JSON object with one entry per
kernel and main path: the Weizmann rows, and the same kernels at the
spirals and VidTIMIT shapes (``... (spirals)``, ``... (vidtimit)``), and
the three bf16 variants (``..._bf16``, phase 15: times and bounds at the
Weizmann step's shapes, ``f32_twin_ms`` the float32 twin's in the same
call for the two scans, launches of its command line, ``launches_by_phase``
those of its step, evaluation and command line), and the tiled route's two
scans (``..._bf16_tiled``: phase 16 (a)'s one launch at z = h = 768, K =
25, launches of phase 16 (c)'s step; ``launches_by_phase`` of the bf16
rows adds phase 16 (b)'s ``bf16_gtf`` step and (c)'s, each on its own). ``library_ms`` is null for the scans
and the cell (no PyTorch call computes them) and, for the weight
gradients, the device time of four ``torch.mm`` (float32, or bf16 rows
with ``out_dtype=torch.float32``) and the bias sums. For
the scan kernels ``ms``, ``plain_ms`` and ``bound_ms`` are sums over the
training step's three launches (phase 3, 9 or 12); ``bound_ms`` is the
bound of the route the kernels take and ``bound_f32_ms`` that of float32
outside the tensor cores, both for the real (unpadded) work; for the cell
they are per launch at the evaluation's 200-particle shape. ``launches``
counts the launches of the row's command-line run (phase 8, 10 or 12),
and ``launches_by_phase`` those of the runs of phases 4 (the training
steps), 6 (one evaluation), 7 (the timed bench-configuration steps), 8,
10, 12, 13 (the Weizmann grid), 14 (summed over the ranks) and 16 (b)'s
float32 step at K = 50, and 17 ((a), and (b) summed over the ranks); the
last is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_MAIN, B_DATA, V_MAIN, Z_DIM = 25, 25, 4, 256
SCAN_SHAPES = ((3, 1), (3, 25), (5, 1))  # (M, K) of the step's 3 passes
SMOOTH_SHAPE = (56, 25, 5, 1)  # (T, B, M, K) of the evaluation's smoothing
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
TF32_PASSES = 3          # the scan kernels' 3xTF32 products
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
# name -> (its source, the TPU kernel or the part of it that it replaces)
SCAN_SRC = "multimodal_dmm_tpu_torch/csrc/bfvi_scan.cu"
KERNELS = {
    "bfvi_scan_fwd": (SCAN_SRC,
                      "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:118"),
    "bfvi_scan_bwd": (SCAN_SRC,
                      "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:293"),
    "gtf_wgrad": (SCAN_SRC, "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:451"),
    "poe_sample_cell": ("multimodal_dmm_tpu_torch/csrc/poe_cell.cu",
                        "multimodal_dmm_tpu/ops/pallas/poe_cell.py:32"),
}
SCAN_KERNELS = ("bfvi_scan_fwd", "bfvi_scan_bwd", "gtf_wgrad")
# The scan kernels' bfloat16 variants (bf16_gtf), each counted on its f32
# twin's wrapper in ``.launches_bf16`` (ops/cuda/bfvi_scan.py): name -> the
# f32 kernel it is a variant of.
BF16_KERNELS = {name + "_bf16": name for name in SCAN_KERNELS}
BF16_SRC = "multimodal_dmm_tpu_torch/csrc/bfvi_scan_bf16.cu"
BF16_SCAN_SRC = "multimodal_dmm_tpu_torch/csrc/bf16_scan.cuh"
WGRAD_BF16_SRC = "multimodal_dmm_tpu_torch/csrc/wgrad_bf16.cuh"
# The bf16 scans' tiled route (csrc/bfvi_scan.cuh on the tile engine's bf16
# route), counted in ``.launches_bf16_tiled``: name -> its f32 twin.
TILED_KERNELS = {"bfvi_scan_fwd_bf16_tiled": "bfvi_scan_fwd",
                 "bfvi_scan_bwd_bf16_tiled": "bfvi_scan_bwd"}
TILED_SRC = "multimodal_dmm_tpu_torch/csrc/bfvi_scan.cuh"
# (M, K, smoothing) at B = 25, D = 256
CELL_SHAPES = ((3, 200, False), (5, 1, True))
N_EVAL_SEQS = 10
N_EVALS = 10                # timed evaluations, after one warm-up call
FWD_TOL = dict(rtol=5e-4, atol=5e-5)
BWD_TOL = dict(rtol=1e-3, atol=1e-3)     # on max-abs-normalised gradients
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)  # on max-abs-normalised grads
CELL_TOL = 1e-5             # rtol = atol; 1e-4 with the inverse expert
EVAL_RTOL = 1e-4            # summed losses, MSE and SSIM (PERF.md)
EVAL_LABEL_FLIPS = 2        # label decisions that may flip (PERF.md)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # bf16 codecs vs f32, as on the CPU
# bf16 vs f32 gradients, each leaf in relative Frobenius norm: the bf16
# codecs' cotangents move the transition's weight gradients by about 8 %
# in the JAX package's own step too (tests/test_torch_bf16.py,
# test_weizmann_step_bf16_matches_jax); a wrong bf16 convolution moves
# its leaves by O(1).
BF16_GRAD_RTOL = 0.25
# Phase 15, bf16_gtf on the kernels against the plain versions, which
# round at the same points and differ only where an f32 sum lies within
# its summation order's rounding of a bfloat16 midpoint: the step's loss
# and the evaluation's metrics.
BF16_GTF_LOSS_RTOL = 1e-3
BF16_GTF_EVAL_RTOL = 1e-3
# Phase 15 (a): each output of a bf16 variant against its bf16 plain
# version, in relative Frobenius norm. BF16_TOL and BF16_GRAD_RTOL hold
# too, but they cannot tell a kernel that rounds at the bf16 points from
# one that does not. These limits lie about 3-5x above the largest
# readings on the card (3.5e-4, 1.05e-3, 2.1e-6). And in each output the
# float32 kernel must lie BF16_GTF_SEPARATION times farther from the
# bf16 plain version than the bf16 variant does: a kernel that skipped
# the rounding reads about 1x. At D = H = 256 the readings are 5-10x,
# not more, because two f32 orders of a 256-term sum round to different
# sides of a bf16 midpoint in about 1e-3 of the products and those
# one-ulp flips travel through the 25 steps; at the spirals widths they
# read 75x and more (PERF.md, section 6, PR 9).
BF16_GTF_RFRO = {"bfvi_scan_fwd": 1e-3, "bfvi_scan_bwd": 3e-3,
                 "gtf_wgrad": 1e-5}
BF16_GTF_SEPARATION = 3.0
# Phase 15 (b): the step's gradient leaves, backward kernel against the
# plain backward on its ReLU masks; the float32 step's transition weights
# lie BF16_GTF_SEPARATION times farther. (The loss cannot tell the routes
# apart: the float32 step's differs by one float32 ulp.)
BF16_GTF_STEP_RFRO = 3e-3
N_BENCH = 10                # timed steps per block in phase 7
CLI_EPOCHS = 2
SP_T, SP_B = 100, 100       # the spirals app's T and batch_size
SP_STEPS = 3                # timed steps of each phase 10-11 model, after 1
# The baselines' MAP forward on the card against the CPU: max error over
# the largest value, float32 both sides (TF32 off), through T = 100 steps
# of recurrence.
BASELINE_FWD_TOL = 1e-4
# Phase 12, VidTIMIT: the longest sequence (t_range 40-80), the batch, the
# fixture (the real corpus's 43 subjects x 10 sentences), timed steps.
VT_T, VT_B = 80, 25
VT_SUBJECTS, VT_SENTENCES = 43, 10
VT_STEPS = 3


_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def log_phase(text):
    """A phase's heading, with the seconds since the script started."""
    log("%s (at %.1f s)" % (text, time.perf_counter() - _START))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
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


def time_device_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call. A spin kernel of 200,000 cycles a call
    (about 100 us at 2 GHz, twice what the host takes to enqueue one)
    keeps the card busy while the host enqueues the calls, so the host's
    launch overhead between short kernels is not counted."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_work(t_max, n_exp, b_dim, k, d, h):
    """(flops, bytes) that the forward scan, the whole backward and the
    weight-gradient kernel alone must do: the six products of the
    transition at t >= 1 (the backward adds the input-gradient and
    weight-gradient products: 3x; the weight-gradient kernel does the
    last 1x), each input read once and each output written once.
    Elementwise work (under 2% of the products' FLOPs) is left out."""
    gemm = 2 * (d * (2 * h + d) + 2 * h * d + d * d)
    n_rows = (t_max - 1) * k * b_dim
    fwd_flops = n_rows * gemm
    n_w = d * (2 * h + d) + 2 * h * d + d * d + 2 * h + 3 * d
    obs = 2 * t_max * n_exp * b_dim * d + t_max * n_exp * b_dim
    tbd, tkbd = t_max * b_dim * d, t_max * k * b_dim * d
    fwd_bytes = 4 * (obs + 2 * b_dim * d + n_w + tkbd + 5 * tbd + tkbd)
    bwd_bytes = 4 * (obs + 2 * b_dim * d + n_w + 2 * tkbd + 7 * tbd
                     + 2 * t_max * n_exp * b_dim * d + 2 * b_dim * d + n_w)
    wgrad_bytes = 4 * (n_rows * (d + (2 * h + d) + (2 * h + 4 * d)) + n_w)
    return ((fwd_flops, fwd_bytes), (3 * fwd_flops, bwd_bytes),
            (fwd_flops, wgrad_bytes))


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scan_inputs(n_exp, k, dev, seed, t_max=T_MAIN, b_dim=V_MAIN * B_DATA,
                d=Z_DIM, smoothing=False):
    """Inputs shaped like one pass of the training step (by default: V*B =
    100 columns at D = 256), 10 % of expert cells masked; with
    ``smoothing`` the last two experts are the smoothing pass's filter
    prior and inverse global prior."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (t_max, n_exp, b_dim, d)
    obs_mean = torch.randn(shape, generator=gen, device=dev)
    obs_std = 0.1 + torch.rand(shape, generator=gen, device=dev)
    obs_mask = (torch.rand(shape[:3], generator=gen, device=dev)
                > 0.1).float()
    glb_mean = torch.zeros(shape[2:], device=dev)
    glb_std = torch.full(shape[2:], 1.001, device=dev)
    if smoothing:
        obs_std[:, -2] = 0.9 * glb_std      # filter prior
        obs_mean[:, -1] = glb_mean          # inverse global prior
        obs_std[:, -1] = -glb_std
        obs_mask[:, -2:] = 1.0
    eps = torch.randn((t_max, k) + shape[2:], generator=gen, device=dev)
    cots = [torch.randn((t_max,) + shape[2:], generator=gen, device=dev)
            for _ in range(5)]
    return [obs_mean, obs_std, obs_mask, glb_mean, glb_std], eps, cots


def max_norm_err(got, exp):
    """Max over elements of |got - exp| / max|exp| and the tolerance
    check on the normalised values."""
    scale = exp.abs().max().item() + 1e-6
    g, e = got / scale, exp / scale
    ok = bool(torch.all((g - e).abs() <= BWD_TOL["atol"]
                        + BWD_TOL["rtol"] * e.abs()))
    return ok, (got - exp).abs().max().item()


FWD_OUTPUTS = ("prior_mean", "prior_std", "infer_mean", "infer_std",
               "samples", "z_traj")


def check_fwd(scan, x, gtf, eps, what, bf16=False):
    """The forward kernel (its bfloat16 variant against the bfloat16 plain
    version, at BF16_TOL and ``hold_bf16``, with ``bf16``) against its
    plain version on one input; returns (plain outputs, largest absolute
    error)."""
    got = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, bf16=bf16)
    exp = scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3, bf16=bf16)
    torch.cuda.synchronize()
    tol = BF16_TOL if bf16 else FWD_TOL
    err = 0.0
    for name, g, e in zip(FWD_OUTPUTS, got, exp):
        check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
        a = (g - e).abs().max().item()
        err = max(err, a)
        check(torch.allclose(g, e, **tol), "forward kernel %s disagrees "
              "at %s: max abs err %.3g" % (name, what, a))
    if bf16:
        ctrl = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3)
        hold_bf16("bfvi_scan_fwd", what, zip(FWD_OUTPUTS, got, exp),
                  zip(FWD_OUTPUTS, ctrl, exp))
    return exp, err


def hold_bf16(kernel, what, pairs, controls):
    """Phase 15 (a): each (name, bf16 variant's output, bf16 plain
    version's) of ``pairs`` within BF16_GTF_RFRO[kernel] in relative
    Frobenius norm; and each (name, float32 kernel's output, the same
    plain output) of ``controls`` at least BF16_GTF_SEPARATION times
    farther from it than the bf16 variant is, so that the check tells a
    kernel that rounds at the bfloat16 points from one that does not."""
    lim = BF16_GTF_RFRO[kernel]
    errs = {name: rel_fro(g, e) for name, g, e in pairs}
    for name, fro in errs.items():
        check(fro <= lim, "%s_bf16 %s at %s: relative Frobenius error %.3g "
              "against the bf16 plain version, beyond %g"
              % (kernel, name, what, fro, lim))
    ratio = {}
    for name, c, e in controls:
        fro = rel_fro(c, e)
        ratio[name] = fro / max(errs[name], 1e-7)
        check(ratio[name] >= BF16_GTF_SEPARATION, "%s %s at %s: the float32 "
              "kernel lies %.3g from the bf16 plain version, only %.1fx the "
              "bf16 variant's %.3g" % (kernel, name, what, fro, ratio[name],
                                       errs[name]))
    worst = max(errs, key=errs.get)
    least = min(ratio, key=ratio.get)
    log("  %s_bf16 %s: largest relative Frobenius error %.3g at %s (limit "
        "%g); the float32 kernel against the bf16 plain version at least "
        "%.1fx the bf16 variant's error (%s: %.3g)"
        % (kernel, what, errs[worst], worst, lim, ratio[least], least,
           ratio[least] * max(errs[least], 1e-7)))


def rel_fro(got, exp):
    """|got - exp| / |exp| in Frobenius norm."""
    return ((got - exp).norm() / (exp.norm() + 1e-30)).item()


def with_kernel_rows(scan, fn):
    """``fn()``, and the xs rows that each backward kernel launch in it
    wrote, in launch order (their h1 and hn hold its ReLU masks)."""
    scan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        out = fn()
    finally:
        scan.bfvi_scan_bwd_cuda.rows = None
    return out, rows


def check_flips(scan, margins, d, what, bf16=False):
    """Every unit where the backward kernel's ReLU mask differs from the
    plain backward's has its exact pre-activation within
    ``relu_flip_bound(D, bf16)`` of 0. Returns (flips, largest margin)."""
    bound = scan.relu_flip_bound(d, bf16)
    n = sum(m.numel() for m in margins.values())
    worst = max((m.max().item() for m in margins.values() if m.numel()),
                default=0.0)
    check(worst <= bound, "%s: a ReLU flip between the backward kernel and "
          "the plain backward at margin %.3g, beyond the rounding bound %.3g"
          % (what, worst, bound))
    return n, worst


def check_recompute(scan, x, gtf, eps, cots, what):
    """Phase 15 (a): the bf16 backward's recomputed transition (its xs
    rows h1, hn, z_nonlin, in bfloat16 as the weight gradients read them)
    against the forward kernel's own rows on the forward's z_traj, rounded
    alike: 0 ReLU flips and every value equal bit for bit (one product
    routine and K-order for both, csrc/bf16_scan.cuh and, on the tiled
    route, csrc/tf32x3.cuh)."""
    h = gtf["gate_1"]["w"].shape[0]
    scan.bfvi_scan_fwd_cuda.rows = fwd_rows = []
    scan.bfvi_scan_bwd_cuda.rows = bwd_rows = []
    try:
        got = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, True)
        res = tuple(x) + (gtf, eps, got[5], got[0], got[1])
        scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, True)
        torch.cuda.synchronize()
    finally:
        scan.bfvi_scan_fwd_cuda.rows = scan.bfvi_scan_bwd_cuda.rows = None
    f, b = fwd_rows[0], bwd_rows[0]
    flips = int(((f[:, :2 * h] > 0) != (b[:, :2 * h] > 0)).sum().item())
    check(flips == 0, "bfvi_scan_bwd_bf16 at %s: %d ReLU flips between the "
          "forward and the backward's recompute" % (what, flips))
    check(torch.equal(f, b), "bfvi_scan_bwd_bf16 at %s: the recomputed "
          "transition differs from the forward's (max %.3g)"
          % (what, (f - b).abs().max().item()))
    log("  bfvi_scan_bwd_bf16 %s: the recompute equals the forward's "
        "transition bit for bit on %d rows, 0 ReLU flips" % (what, f.shape[0]))


def log_plan(scan, name, k, b_dim, d, h, backward):
    """The bf16 launch plan of ``name`` at one shape, with the clusters
    that the card runs at once (cudaOccupancyMaxActiveClusters)."""
    p = scan.bf16_scan_plan(k, b_dim, d, h, backward)
    if p["route"] == "tiled":
        log("    plan %s_bf16 (K = %d, %d columns, D = %d, H = %d): the tiled "
            "route (no cluster holds a column's operands), a cooperative "
            "launch on the tile engine's bf16 route" % (name, k, b_dim, d, h))
        return
    at_once = scan._lib(True).bfvi_scan_bf16_max_clusters(
        int(backward), p["cluster"], p["smem"])
    check(at_once >= 1, "%s_bf16: the card runs no cluster of %d CTAs with "
          "%d bytes of shared memory" % (name, p["cluster"], p["smem"]))
    log("    plan %s_bf16 (K = %d, %d columns, D = %d, H = %d): %d clusters "
        "of %d CTAs, %d columns (%d rows) each, weights %s, %d bytes of "
        "shared memory a CTA; %d clusters at once on the card: %d waves"
        % (name, k, b_dim, d, h, p["groups"], p["cluster"], p["cols"],
           p["rows"], "resident" if p["resident"] else "streamed", p["smem"],
           at_once, -(-p["groups"] // at_once)))


def ptxas_lines(name):
    """The ``-Xptxas -v`` lines of library ``name``'s kernels: each
    kernel's name, then its stack, spill and register lines."""
    from multimodal_dmm_tpu_torch.ops.cuda import _build
    out = []
    for line in _build.build_log(name).splitlines():
        line = line.strip()
        if "Function properties for" in line:
            out.append(line.split("for ")[-1])
        elif "spill" in line or ("Used" in line and "registers" in line):
            out.append("  " + line.replace("ptxas info    : ", ""))
    return out


def bwd_pairs(scan, out_a, out_b):
    """(name, a, b) for each output of two backward runs."""
    pairs = list(zip(("d_obs_mean", "d_obs_std", "d_glb_mean",
                      "d_glb_std"), out_a[:4], out_b[:4]))
    return pairs + [(n + "." + kk, out_a[4][n][kk], out_b[4][n][kk])
                    for n in scan.GTF_LAYERS for kk in ("w", "b")]


def has_mm_out_dtype():
    """Whether this PyTorch has ``torch.mm``'s ``out_dtype`` overload on the
    card (bfloat16 operands, a float32 result), the bf16 weight gradients'
    library yardstick."""
    a = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def wgrad_library(z, xs, ys, parts=None):
    """The weight gradients' library yardstick: the four products and the
    bias sums, one PyTorch call each. On float32 rows (z the first rows of
    z_traj) ``torch.mm`` in full float32 and ``sum(0)`` of the four
    cotangent blocks; with ``parts`` (bf16 rows and the float32 bias
    partials) ``torch.mm(..., out_dtype=torch.float32)`` on the bfloat16
    rows and the partials' ``sum(0)``."""
    d = z.shape[1]
    h = (xs.shape[1] - d) // 2
    y1, da2, dzn, dsr = torch.split(ys, [2 * h + d, d, d, d], 1)
    h1, hn, zn = torch.split(xs, [h, h, d], 1)
    if parts is None:
        mm, sums = torch.mm, [y.sum(0) for y in (y1, da2, dzn, dsr)]
    else:
        sums = [parts.sum(0)]

        def mm(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    return [mm(y1.t(), z), mm(da2.t(), h1), mm(dzn.t(), hn),
            mm(dsr.t(), zn)] + sums


def wgrad_bf16_inputs(scan, z_traj, xs, ys, n_rows):
    """Rows in the bf16 backward's form from float32 rows: the bfloat16
    images of z_traj's first ``n_rows`` rows, of xs and of ys, and
    ``scan.BIAS_CHUNKS`` partials of ys's float32 column sums (the tiled
    route's)."""
    d = z_traj.shape[-1]
    parts = torch.stack([c.sum(0) for c in ys.chunk(scan.BIAS_CHUNKS)])
    return (z_traj.reshape(-1, d)[:n_rows].to(torch.bfloat16),
            xs.to(torch.bfloat16), ys.to(torch.bfloat16), parts)


def wgrad_bf16_bytes(n_rows, d, h, n_parts):
    """Bytes that the bf16 weight gradients must move: the bf16 rows and the
    bias partials read once, the gradients written once."""
    la = 2 * h + d
    n_w = la * d + 2 * d * h + d * d
    return (2 * n_rows * (d + la + la + 3 * d)
            + 4 * (n_parts * (la + 3 * d) + n_w + la + 3 * d))


def check_kernels(scan, gtf, dev, t_max=T_MAIN, b_dim=V_MAIN * B_DATA,
                  shapes=SCAN_SHAPES, smooth_shape=SMOOTH_SHAPE, seed=100,
                  bf16=False):
    """Phases 3, 9 and 15 (a): every scan kernel against its plain version
    at a training step's shapes (T, V B columns, the step's three (M, K),
    the last the smoothing pass; D and H those of ``gtf``), and the
    forward at the evaluation's smoothing shape (T, B, M, K) unless that
    is None; returns per-kernel records, sums over the step's three
    launches. With ``bf16`` the kernels' bfloat16 variants against the
    bfloat16 plain versions: outputs at BF16_TOL, the backward's and the
    weight gradients' outputs each within BF16_GRAD_RTOL in relative
    Frobenius norm (their elementwise errors at BWD_TOL logged), every
    output within BF16_GTF_RFRO with the float32 kernel far beyond it
    (``hold_bf16``), bounds for one bf16 pass."""
    h, d = gtf["gate_1"]["w"].shape
    fl_passes, peak, route = ((1, PEAK_BF16_FLOPS, "bf16") if bf16 else
                              (TF32_PASSES, PEAK_TF32_FLOPS, "3xTF32"))

    def hold(what, g, e):
        """(largest absolute error, holds); the bf16 variants' outputs are
        held by ``hold_bf16`` as well."""
        ok, a = max_norm_err(g, e)
        if bf16:
            ok = rel_fro(g, e) <= BF16_GRAD_RTOL
        return a, ok
    rec = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_f32_ms=0.0,
                      bound_ms={"operations": 0.0, "bytes": 0.0})
           for name in SCAN_KERNELS}
    has_lib = not bf16 or has_mm_out_dtype()
    rec["gtf_wgrad"]["library_ms"] = 0.0 if has_lib else None
    for i, (n_exp, k) in enumerate(shapes):
        x, eps, cots = scan_inputs(n_exp, k, dev, seed + i, t_max, b_dim, d,
                                   smoothing=i == len(shapes) - 1)
        what = "(M, K) = (%d, %d)" % (n_exp, k)
        exp, err = check_fwd(scan, x, gtf, eps, what, bf16)
        res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
        g_out, rows = with_kernel_rows(
            scan, lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, bf16))
        e_out, margins = scan.bfvi_scan_bwd_ref_on_masks(res, cots, 1e-3,
                                                         rows[0], bf16)
        g_again = scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, bf16)
        torch.cuda.synchronize()
        flips, worst = check_flips(scan, margins, d, what, bf16)
        log("  bfvi_scan_bwd%s %s: %d ReLU flips against the plain backward "
            "in the GTF first layers (held on the kernel's masks), largest "
            "exact margin %.3g of the bound %.3g"
            % ("_bf16" if bf16 else "", what, flips, worst,
               scan.relu_flip_bound(d, bf16)))
        berr = 0.0
        for name, g, e in bwd_pairs(scan, g_out, e_out):
            check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
            a, ok = hold(name, g, e)
            berr = max(berr, a)
            check(ok, "backward kernel %s disagrees at (M, K) = (%d, %d): "
                  "max abs err %.3g (scale %.3g), relative Frobenius %.3g"
                  % (name, n_exp, k, a, e.abs().max().item(),
                     rel_fro(g, e)))
        if bf16:
            ctrl = scan.bfvi_scan_bwd_cuda(res, cots, 1e-3)
            hold_bf16("bfvi_scan_bwd", what, bwd_pairs(scan, g_out, e_out),
                      bwd_pairs(scan, ctrl, e_out))
        for name, g, g2 in bwd_pairs(scan, g_out, g_again):
            check(torch.equal(g, g2), "backward kernel %s: two runs differ "
                  "at (M, K) = (%d, %d)" % (name, n_exp, k))
        # The weight-gradient kernel alone, on rows shaped like those the
        # backward kernel writes: float32, or with bf16 in the bf16
        # backward's form (their bfloat16 images and partials of the
        # float32 bias sums); two runs agree bit for bit.
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        n_rows = (t_max - 1) * k * b_dim
        xs = torch.randn((n_rows, 2 * h + d), generator=gen, device=dev)
        ys = torch.randn((n_rows, 2 * h + 4 * d), generator=gen, device=dev)
        # Timed as the backward launches it, on rows at the kernels' padded
        # widths (the wrapper's padding copies are no part of the path).
        y_real = (h, h) + (d,) * 4
        if bf16:
            w_in = wgrad_bf16_inputs(scan, exp[5], xs, ys, n_rows)
            w_fn = lambda: scan.gtf_wgrad_bf16_cuda(*w_in)  # noqa: E731
            w_ref = lambda: scan.gtf_wgrad_bf16_ref(*w_in)  # noqa: E731
            w_lib = lambda: wgrad_library(*w_in)  # noqa: E731
            dp, hp = scan._check_sizes(k, d, h, True)
            blocks = (y_real, (hp, hp) + (dp,) * 4)
            w_pad = (scan._pad_last(w_in[0], dp),
                     scan._pad_blocks(w_in[1], (h, h, d), (hp, hp, dp)),
                     scan._pad_blocks(w_in[2], *blocks),
                     scan._pad_blocks(w_in[3], *blocks))
            w_path = lambda: scan._gtf_wgrad_bf16_launch(  # noqa: E731
                *w_pad, dp, hp)
        else:
            z_rows = exp[5].reshape(-1, d)[:n_rows]
            w_fn = lambda: scan.gtf_wgrad_cuda(exp[5], xs, ys)  # noqa: E731
            w_ref = lambda: scan.gtf_wgrad_ref(exp[5], xs, ys)  # noqa: E731
            w_lib = lambda: wgrad_library(z_rows, xs, ys)  # noqa: E731
            dp, hp = scan._check_sizes(k, d, h)
            w_pad = (scan._pad_last(exp[5], dp),
                     scan._pad_blocks(xs, (h, h, d), (hp, hp, dp)),
                     scan._pad_blocks(ys, y_real, (hp, hp) + (dp,) * 4))
            w_path = lambda: scan._gtf_wgrad_launch(  # noqa: E731
                *w_pad, n_rows, dp, hp)
        w_got, w_again, w_exp = w_fn(), w_fn(), w_ref()
        torch.cuda.synchronize()
        werr = 0.0
        for n in scan.GTF_LAYERS:
            for kk in ("w", "b"):
                a, ok = hold(n, w_got[n][kk], w_exp[n][kk])
                werr = max(werr, a)
                check(ok, "weight-gradient kernel %s.%s disagrees at K = %d: "
                      "max abs err %.3g, relative Frobenius %.3g"
                      % (n, kk, k, a, rel_fro(w_got[n][kk], w_exp[n][kk])))
                check(torch.equal(w_got[n][kk], w_again[n][kk]),
                      "weight-gradient kernel %s.%s: two runs differ at K = "
                      "%d" % (n, kk, k))
        if bf16:
            # The bias gradients sum float32 cotangents on both routes:
            # only the weights tell them apart.
            ctrl = scan.gtf_wgrad_cuda(exp[5], xs, ys)
            hold_bf16("gtf_wgrad", what,
                      [(n + "." + kk, w_got[n][kk], w_exp[n][kk])
                       for n in scan.GTF_LAYERS for kk in ("w", "b")],
                      [(n + ".w", ctrl[n]["w"], w_exp[n]["w"])
                       for n in scan.GTF_LAYERS])
        reps = 3 if k > 1 or t_max > T_MAIN else 10
        # The plain scans' Python loops take 0.2-0.5 s a call at T = 100:
        # one timed call there.
        plain_reps = 1 if t_max > T_MAIN else reps
        kw = {}
        if bf16:
            check_recompute(scan, x, gtf, eps, cots, what)
            # The cluster route's weight images, packed once as an autograd
            # call packs them (timed on their own); the tiled route reads
            # the weights as they are.
            dp, hp = scan._check_sizes(k, d, h, True)
            gtf_p = scan._pad_gtf(gtf, dp, hp)
            pack_ms = 0.0
            if scan.bf16_scan_plan(k, b_dim, dp, hp)["route"] == "cluster":
                def make_pack():
                    pk = scan.Bf16Pack(gtf_p, dp, hp)
                    pk.image(True)
                    return pk
                kw["pack"] = make_pack()
                pack_ms = time_ms(make_pack, reps)
        times = [time_ms(fn, r) for fn, r in (
            (lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, bf16, **kw),
             reps),
            (lambda: scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3, bf16),
             plain_reps),
            (lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, bf16, **kw),
             reps),
            (lambda: scan.bfvi_scan_bwd_ref(res, cots, 1e-3, bf16),
             plain_reps),
            (w_ref, reps))]
        # The weight gradients and their library yardstick: device time
        # (the host's enqueue of a call outlasts a K = 1 launch).
        times.insert(4, time_device_ms(w_path, max(reps, 10)))
        lib_ms = time_device_ms(w_lib, max(reps, 10)) if has_lib else None
        if bf16:
            # Each bf16 scan beside its float32 twin, in turns.
            twins = [time_ms(fn, reps) for fn in (
                lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3),
                lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, True,
                                                **kw),
                lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3),
                lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, True,
                                                **kw))]
            twin = {"bfvi_scan_fwd": twins[0], "bfvi_scan_bwd": twins[2]}
            log("  %s: bf16 forward %.3f ms against the f32 kernel's %.3f "
                "(%.2fx), bf16 backward %.3f against %.3f (%.2fx), in turns "
                "after the timed calls; packing the weight images %.3f ms"
                % (what, twins[1], twins[0], twins[0] / twins[1], twins[3],
                   twins[2], twins[2] / twins[3], pack_ms))
            for name, backward in (("bfvi_scan_fwd", False),
                                   ("bfvi_scan_bwd", True)):
                log_plan(scan, name, k, b_dim, dp, hp, backward)
                rec[name]["f32_twin_ms"] = (rec[name].get("f32_twin_ms", 0.0)
                                            + twin[name])
        (ff, fb), (bf, bb), (wf, wb) = scan_work(t_max, n_exp, b_dim, k, d,
                                                 h)
        if bf16:  # the weight gradients read the rows in bfloat16
            wb = wgrad_bf16_bytes(n_rows, d, h, w_in[3].shape[0])
        if has_lib:
            rec["gtf_wgrad"]["library_ms"] += lib_ms
        for name, e, ms, pms, fl, by in (
                ("bfvi_scan_fwd", err, times[0], times[1], ff, fb),
                ("bfvi_scan_bwd", berr, times[2], times[3], bf, bb),
                ("gtf_wgrad", werr, times[4], times[5], wf, wb)):
            r = rec[name]
            r["err"] = max(r["err"], e)
            r["ms"] += ms
            r["plain_ms"] += pms
            bms, by_what = bound_ms(fl_passes * fl, by, peak)
            r["bound_ms"][by_what] += bms
            f32_ms, f32_by = bound_ms(fl, by)
            r["bound_f32_ms"] += f32_ms
            lib = ""
            if name == "gtf_wgrad":
                lib = ", library %s" % ("%.3f ms" % lib_ms if has_lib else
                                        "not available")
            log("  %s%s (M, K) = (%d, %d): kernel %.3f ms, plain %.3f ms%s, "
                "bound %.3f ms (%s, %s), f32 bound %.3f ms (%s), max abs "
                "err %.3g" % (name, "_bf16" if bf16 else "", n_exp, k, ms,
                              pms, lib, bms, by_what, route, f32_ms, f32_by,
                              e))

    if smooth_shape is None:
        return rec
    # The evaluation's MAP smoothing pass: its own row, not in the sums.
    t_max, b_dim, n_exp, k = smooth_shape
    x, eps, _ = scan_inputs(n_exp, k, dev, seed + 10, t_max, b_dim, d,
                            smoothing=True)
    what = "(T, B, M, K) = (%d, %d, %d, %d)" % smooth_shape
    _, err = check_fwd(scan, x, gtf, eps, what, bf16)
    rec["bfvi_scan_fwd"]["err"] = max(rec["bfvi_scan_fwd"]["err"], err)
    ms, pms = [time_ms(fn, 10 if t_max <= T_MAIN * 3 else r) for fn, r in (
        (lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, bf16), 3),
        (lambda: scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3, bf16), 1))]
    fl, by = scan_work(t_max, n_exp, b_dim, k, d, h)[0]
    bms, by_what = bound_ms(fl_passes * fl, by, peak)
    f32_ms, f32_by = bound_ms(fl, by)
    log("  bfvi_scan_fwd%s, evaluation smoothing %s: kernel %.3f ms, plain "
        "%.3f ms, bound %.4f ms (%s, %s), f32 bound %.4f ms (%s), max "
        "abs err %.3g" % ("_bf16" if bf16 else "", what, ms, pms, bms,
                          by_what, route, f32_ms, f32_by, err))
    return rec


def cell_work(n_exp, k, b_dim, d):
    """(operations, bytes) of one cell launch: per (b, d) element the
    prior's and each expert's precision and product terms (about 8 + 5 M
    operations) and 3 per particle (z, and its share of the mean); each
    input read once and each output written once."""
    bd = b_dim * d
    flops = bd * (8 + 5 * n_exp + 3 * k)
    nbytes = 4 * (2 * bd + 2 * n_exp * bd + n_exp * b_dim + k * bd
                  + 3 * bd + k * bd)
    return flops, nbytes


def cell_inputs(n_exp, k, dev, seed, b_dim=B_DATA, d=Z_DIM,
                smoothing=False):
    """Inputs shaped like one step of the evaluation's passes (by default
    at B = 25, D = 256): a positive prior, M experts with 10 % of cells
    masked; with ``smoothing`` the last two experts are the filter prior
    and the inverse global prior, as in the smoothing pass."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    prior_mean = torch.randn((b_dim, d), generator=gen, device=dev)
    prior_std = 0.1 + torch.rand((b_dim, d), generator=gen, device=dev)
    obs_mean = torch.randn((n_exp, b_dim, d), generator=gen, device=dev)
    obs_std = 0.1 + torch.rand((n_exp, b_dim, d), generator=gen,
                               device=dev)
    mask = (torch.rand((n_exp, b_dim), generator=gen, device=dev)
            > 0.1).float()
    if smoothing:  # filter prior, inverse global prior (std 1.001)
        obs_std[-2] = 0.9 * 1.001
        obs_mean[-1] = 0.0
        obs_std[-1] = -1.001
        mask[-2:] = 1.0
    eps = torch.randn((k, b_dim, d), generator=gen, device=dev)
    return prior_mean, prior_std, obs_mean, obs_std, mask, eps


def check_cell(cell, dev, shapes=CELL_SHAPES, b_dim=B_DATA, d=Z_DIM,
               seed=300):
    """Phases 5 and 9: the cell kernel against its plain version at
    ``shapes`` ((M, K, smoothing) at B, D); returns its record (time,
    plain time and bound per launch at the first shape, the evaluation's
    200-particle filter step; largest error over all shapes)."""
    rec = dict(err=0.0)
    for i, (n_exp, k, smoothing) in enumerate(shapes):
        x = cell_inputs(n_exp, k, dev, seed + i, b_dim, d, smoothing)
        got = cell.poe_sample_cell_cuda(*x)
        exp = cell.poe_sample_cell_ref(*x)
        torch.cuda.synchronize()
        tol = CELL_TOL * (10 if smoothing else 1)
        for name, g, e in zip(("infer_mean", "infer_std", "z", "sample"),
                              got, exp):
            check(bool(torch.isfinite(g).all()), "non-finite cell %s" % name)
            err = (g - e).abs().max().item()
            rec["err"] = max(rec["err"], err)
            check(torch.allclose(g, e, rtol=tol, atol=tol),
                  "cell kernel %s disagrees at (M, K) = (%d, %d): max abs "
                  "err %.3g" % (name, n_exp, k, err))
        ms = time_device_ms(lambda: cell.poe_sample_cell_cuda(*x), 200)
        pms = time_device_ms(lambda: cell.poe_sample_cell_ref(*x), 50)
        host_ms = time_ms(lambda: cell.poe_sample_cell_cuda(*x), 200)
        bms, by_what = bound_ms(*cell_work(n_exp, k, b_dim, d))
        log("  poe_sample_cell (M, K, B, D) = (%d, %d, %d, %d): kernel "
            "%.4f ms (%.4f ms a call with the host's launch), plain %.4f "
            "ms, bound %.4f ms (%s), max abs err %.3g"
            % (n_exp, k, b_dim, d, ms, host_ms, pms, bms, by_what,
               rec["err"]))
        if i == 0:  # the evaluation's filter pass
            rec.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by_what)
    return rec


def synthetic_eval_set(seed):
    """Ten Weizmann-shaped sequences, like the held-out person's ten
    actions: lengths drawn in 30-60 from ``seed``, video in [0, 1],
    person 8, action 0-9."""
    rng = np.random.RandomState(seed + 1)
    items = []
    for a in range(N_EVAL_SEQS):
        length = int(rng.randint(30, 61))
        items.append({
            "video": rng.rand(length, 3, 64, 64).astype(np.float32),
            "person": np.full((length, 1), 8.0),
            "action": np.full((length, 1), float(a)),
            "length": length, "id": ("shahar", a)})
    return items


def run_eval(trainer, loader, args, plain, seed, wrappers=None):
    """One ``evaluate`` call on the kernels or on the plain versions, the
    generator reseeded, with the launch counts of ``wrappers`` (by default
    ``kernel_wrappers()``) set to 0 just before and read just after.
    Returns (summary, launches)."""
    wrappers = kernel_wrappers() if wrappers is None else wrappers
    for fn in wrappers.values():
        fn.launches = 0
    trainer.model.plain_scan = plain
    trainer.gen.manual_seed(seed)
    _, summary = trainer.evaluate(loader, args, collect_results=False)
    trainer.model.plain_scan = False
    return dict(summary), {n: fn.launches for n, fn in wrappers.items()}


def check_evaluation(trainer, seed, n_evals, bf16=False):
    """Phase 6 (and 15 (c) with ``bf16``, a ``bf16_gtf`` trainer: its
    forward scan the bf16 variant, its metrics within BF16_GTF_EVAL_RTOL):
    the Weizmann BFVI evaluation on the kernels against the plain
    versions, then timed. Returns (the launches of one evaluation, median
    ms per call, the loader, the eval args)."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training.loader import BatchLoader
    wrappers = all_wrappers() if bf16 else kernel_wrappers()
    rtol = BF16_GTF_EVAL_RTOL if bf16 else EVAL_RTOL
    items = synthetic_eval_set(seed)
    lengths = [d["length"] for d in items]
    t_max = max(lengths)
    loader = BatchLoader(items, weizmann.DEFAULTS["batch_size"])
    args = weizmann.eval_namespace("bfvi")
    log("  %d sequences, lengths %s (T = %d), one batch of B = %d; eval "
        "args %s, drop_frac %g" % (len(items), lengths, t_max,
                                   loader.batch_size, args.eval_args,
                                   args.drop_frac))
    torch.backends.cudnn.deterministic = True
    got, launches = run_eval(trainer, loader, args, False, seed, wrappers)
    exp, plain_launches = run_eval(trainer, loader, args, True, seed,
                                   wrappers)
    torch.backends.cudnn.deterministic = False
    log("  launches, kernels: %s; plain: %s" % (launches, plain_launches))
    want = {n: 0 for n in wrappers}
    want["bfvi_scan_fwd_bf16" if bf16 else "bfvi_scan_fwd"] = 1
    want["poe_sample_cell"] = t_max
    check(launches == want,
          "evaluation launches %s, expected the cell T = %d times and the "
          "forward scan once" % (launches, t_max))
    check(not any(plain_launches.values()),
          "the plain evaluation launched kernels: %s" % plain_launches)
    label_atol = EVAL_LABEL_FLIPS / (len(items) * min(lengths))
    for key in sorted(exp):
        g, e = float(got[key]), float(exp[key])
        if not np.isfinite(e) and key.startswith("m_"):
            continue  # no mask modality: NaN in both summaries
        check(np.isfinite(g), "non-finite evaluation metric %s" % key)
        label = key.split("_")[0] in ("action", "person")
        ok = (abs(g - e) <= label_atol if label
              else abs(g - e) <= rtol * abs(e) + 1e-6)
        log("  %-12s kernels %.7g, plain %.7g, diff %.3g" % (key, g, e,
                                                             g - e))
        check(ok, "evaluation metric %s: kernels %r vs plain %r" % (key, g,
                                                                     e))
    check(0.0 <= got["ssim"] <= 1.0 and got["kld_loss"] >= 0.0
          and 0.0 <= got["action"] <= 1.0 and 0.0 <= got["person"] <= 1.0,
          "evaluation metrics out of range: %s" % got)

    times = []
    wrappers = kernel_wrappers()
    cell = wrappers["poe_sample_cell"]
    cell.launches = 0
    for i in range(1 + n_evals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate(loader, args, collect_results=False)
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
    check(cell.launches == t_max * (1 + n_evals),
          "the cell launched %d times in %d evaluations of T = %d"
          % (cell.launches, 1 + n_evals, t_max))
    ms = statistics.median(times)
    log("  evaluation: median %.2f ms per call over %d calls (%s), %.1f "
        "seqs/s" % (ms, len(times), ", ".join("%.2f" % v for v in times),
                    len(items) / (ms / 1e3)))
    return launches, ms, loader, args


def kernel_wrappers():
    from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan, poe_cell
    out = {name: getattr(bfvi_scan, name + "_cuda") for name in SCAN_KERNELS}
    out["poe_sample_cell"] = poe_cell.poe_sample_cell_cuda
    return out


class RouteCount:
    """A scan wrapper's count of one bf16 route's launches
    (``.launches_bf16``: the cluster route; ``.launches_bf16_tiled``),
    read and set as ``.launches`` like the others."""

    def __init__(self, wrapper, attr="launches_bf16"):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self):
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.wrapper, self.attr, n)


def all_wrappers():
    """``kernel_wrappers()``, the counts of the scan kernels' bfloat16
    variants on both routes and the bf16 weight-gradient kernel's."""
    from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan
    out = kernel_wrappers()
    for name, f32 in BF16_KERNELS.items():
        out[name] = (bfvi_scan.gtf_wgrad_bf16_cuda if f32 == "gtf_wgrad"
                     else RouteCount(out[f32]))
    for name, f32 in TILED_KERNELS.items():
        out[name] = RouteCount(out[f32], "launches_bf16_tiled")
    return out


def synthetic_batch(seed, dev, b_dim=B_DATA):
    """T = 25, B = ``b_dim`` (25) Weizmann-shaped batch: video in [0, 1],
    10 % of frames deleted (NaN) in the inputs, full targets;
    person/action labels."""
    rng = np.random.RandomState(seed)
    video = rng.rand(T_MAIN, b_dim, 3, 64, 64).astype(np.float32)
    targets = {
        "video": video,
        "person": rng.randint(0, 10, (T_MAIN, b_dim, 1)).astype(np.float32),
        "action": rng.randint(0, 10, (T_MAIN, b_dim, 1)).astype(np.float32),
    }
    inputs = {m: v.copy() for m, v in targets.items()}
    inputs["video"][rng.rand(T_MAIN, b_dim) < 0.1] = np.nan
    to = lambda d: {m: torch.tensor(v, device=dev) for m, v in d.items()}  # noqa: E731
    return to(inputs), to(targets), torch.ones((T_MAIN, b_dim, 1),
                                               device=dev)


def step_grads(trainer, inputs, targets, mask, plain, seed, **step_kw):
    """Loss and gradients of one training step (no update) with the
    scan on the kernels or on the plain versions, noise from ``seed``;
    ``step_kw`` go to ``model.step`` (its branch)."""
    from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path
    trainer.model.plain_scan = plain
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    for p in trainer.leaves:
        p.grad = None
    loss, _ = trainer.model.step(trainer.params, trainer.state, inputs, mask,
                                 1.0, trainer.rec_mults, gen,
                                 targets=targets, train=True, **step_kw)
    loss.backward()
    trainer.model.plain_scan = False
    grads = {path: p.grad.detach().clone()
             for path, p in tree_leaves_with_path(trainer.params)}
    for p in trainer.leaves:
        p.grad = None
    return loss.item(), grads


def grad_diffs(g_a, g_b, tol=STEP_GRAD_TOL):
    """{path: dict(max=max normalised |a - b|, bad=elements beyond
    ``tol``, rows=rows holding them, n_rows, fro=relative Frobenius
    error, noise=whether b is rounding noise)} of a against b. A leaf
    whose gradient is under 1e-5 of the largest is a bias that feeds a
    training-mode BatchNorm: zero up to rounding noise, so it is
    normalised by the largest gradient instead of its own, and its
    relative Frobenius error (noise against noise) is not formed."""
    top = max(g.abs().max().item() for g in g_b.values())
    out = {}
    for path, e in g_b.items():
        g = g_a[path]
        check(bool(torch.isfinite(g).all()), "non-finite grad %s" % (path,))
        scale = e.abs().max().item()
        noise = scale < 1e-5 * top
        scale = (top if noise else scale) + 1e-6
        gn, en = g / scale, e / scale
        bad = ((gn - en).abs() > tol["atol"]
               + tol["rtol"] * en.abs()).reshape(e.shape[0], -1)
        out[path] = dict(
            max=(gn - en).abs().max().item(), bad=int(bad.sum()),
            rows=int(bad.any(-1).sum()), n_rows=e.shape[0], noise=noise,
            fro=0.0 if noise else ((gn - en).norm() / en.norm()).item())
    return out


def log_worst(what, diffs, n=4):
    for path in sorted(diffs, key=lambda p: -diffs[p]["max"])[:n]:
        log("  grad %s, %s: max %.3g, %d elements in %d of %d rows beyond "
            "tolerance, relative Frobenius %.3g"
            % ("/".join(map(str, path)), what, diffs[path]["max"],
               diffs[path]["bad"], diffs[path]["rows"],
               diffs[path]["n_rows"], diffs[path]["fro"]))


def check_step_against_plain(scan, trainer, inputs, targets, mask, seed,
                             n_launches=len(SCAN_SHAPES), **step_kw):
    """One step's loss and gradients on the kernels against the plain
    versions, with the same noise and deterministic cuDNN (``step_kw``:
    the step's branch).

    - Kernels against the forward kernel followed by the plain backward on
      the backward kernel's ReLU masks (``bfvi_scan_bwd_ref_on_masks``):
      the forward is the same bit for bit, so this holds the backward
      kernel to its plain version inside the step. Every gradient element
      is within STEP_GRAD_TOL (max-abs normalised), and every unit where
      the kernel's masks differ from the plain backward's own has its
      exact pre-activation within ``relu_flip_bound(D)`` of 0: the kernel
      recomputes the GTF's first layers in 3xTF32 and the plain backward
      in cuBLAS float32, so such a unit can fall on either side of its
      ReLU, and each flip moves one row of the layer's weight gradient by
      one sample's whole term. The rows that the flips move against the
      plain backward on its own masks are logged.
    - Kernels against the plain forward and backward: the loss is within
      STEP_LOSS_RTOL, and each gradient leaf within STEP_GRAD_TOL's rtol
      in relative Frobenius norm (a leaf that is rounding noise:
      elementwise against the largest gradient). Elementwise the two
      cannot agree to STEP_GRAD_TOL: the forward kernel's rounding (about
      1e-6 in z) flips ReLUs downstream of the sampled z, starting with
      the video decoder's first layer, and each flip moves one row of a
      weight gradient by one sample's whole term. How many flip depends
      on the weights (PERF.md). A second plain run shows that the plain
      path itself is deterministic.

    Returns the launches of the first run (the kernels' step) alone, by
    wrapper (``all_wrappers``), read just before and just after it.
    """
    torch.backends.cudnn.deterministic = True
    wrappers = all_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    (l_k, g_k), rows = with_kernel_rows(scan, lambda: step_grads(
        trainer, inputs, targets, mask, False, seed, **step_kw))
    launches = {n: w.launches - before[n] for n, w in wrappers.items()}
    check(len(rows) == n_launches, "the step launched the backward "
          "kernel %d times, expected %d" % (len(rows), n_launches))
    margins, launch = [], iter(rows)

    def on_masks(res, cots, min_std, bf16=False, pack=None):
        # pack: the bf16 kernels' weight images, which the plain backward
        # does not read.
        outs, m = scan.bfvi_scan_bwd_ref_on_masks(res, cots, min_std,
                                                  next(launch), bf16)
        margins.append(m)
        return outs
    # The step's backward calls the module's bfvi_scan_bwd_cuda: for this
    # run, the plain backward on the masks of the kernel's run above.
    bwd_kernel, scan.bfvi_scan_bwd_cuda = scan.bfvi_scan_bwd_cuda, on_masks
    try:
        l_km, g_km = step_grads(trainer, inputs, targets, mask, False, seed,
                                **step_kw)
    finally:
        scan.bfvi_scan_bwd_cuda = bwd_kernel
    l_kp, g_kp = step_grads(trainer, inputs, targets, mask, "bwd", seed,
                            **step_kw)
    l_p, g_p = step_grads(trainer, inputs, targets, mask, True, seed,
                          **step_kw)
    l_p2, g_p2 = step_grads(trainer, inputs, targets, mask, True, seed,
                            **step_kw)
    torch.backends.cudnn.deterministic = False
    log("  loss: kernels %.6f, forward kernel + plain backward %.6f (on the "
        "kernel's ReLU masks %.6f), plain %.6f, plain again %.6f"
        % (l_k, l_kp, l_km, l_p, l_p2))
    check(np.isfinite(l_k), "non-finite loss on the kernel path")
    check(l_k == l_kp == l_km,
          "the forward kernel gave different losses for one input")
    check(abs(l_k - l_p) <= STEP_LOSS_RTOL * abs(l_p),
          "step loss: kernels %r vs plain %r" % (l_k, l_p))

    d = trainer.model.z_dim
    flips = [check_flips(scan, m, d, "step, backward launch %d" % i)
             for i, m in enumerate(margins)]
    d_own = grad_diffs(g_k, g_kp)
    log("  backward kernel: %d ReLU flips in the GTF first layers against "
        "the plain backward (largest exact margin %.3g of the bound %.3g); "
        "on its own masks the plain backward differs beyond the "
        "elementwise tolerance in %d rows of %d leaves"
        % (sum(n for n, _ in flips), max(w for _, w in flips),
           scan.relu_flip_bound(d),
           sum(d["rows"] for d in d_own.values()),
           sum(bool(d["bad"]) for d in d_own.values())))
    d_bwd = grad_diffs(g_k, g_km)
    log_worst("backward kernel vs plain backward on its masks", d_bwd)
    bad = [p for p, d in d_bwd.items() if d["bad"]]
    check(not bad, "backward kernel: step gradients of %d leaves differ "
          "beyond rtol %g / atol %g (normalised) from the plain backward on "
          "the kernel's ReLU masks: %s"
          % (len(bad), STEP_GRAD_TOL["rtol"], STEP_GRAD_TOL["atol"], bad))

    d_all = grad_diffs(g_k, g_p)
    log_worst("kernels vs plain", d_all)
    log("  kernels vs plain: %d elements in %d rows of %d leaves beyond the "
        "elementwise tolerance; largest relative Frobenius error %.3g"
        % (sum(d["bad"] for d in d_all.values()),
           sum(d["rows"] for d in d_all.values()),
           sum(bool(d["bad"]) for d in d_all.values()),
           max(d["fro"] for d in d_all.values())))
    log("  plain vs plain again: max %.3g over %d leaves"
        % (max(d["max"] for d in grad_diffs(g_p2, g_p).values()),
           len(g_p)))
    bad = leaves_beyond(d_all, STEP_GRAD_TOL["rtol"])
    check(not bad, "step gradients of %d leaves differ beyond rtol %g in "
          "relative Frobenius norm: %s" % (len(bad), STEP_GRAD_TOL["rtol"],
                                           bad))
    log("  gradients: %d leaves agree" % len(d_all))
    return launches

def native_batch(batch, perms):
    """``batch`` with the modalities of ``perms`` in the codec-native
    layout (trailing dims permuted, contiguous), as the device loader
    stores them."""
    out = dict(batch)
    for m, perm in perms.items():
        out[m] = batch[m].permute(
            (0, 1) + tuple(2 + p for p in perm)).contiguous()
    return out


def time_steps(trainer, inputs, targets, mask, n_data, n):
    """``n`` optimizer steps, each timed by CUDA events around it; returns
    the times in ms."""
    times = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, applied = trainer.train_step(inputs, targets, mask, 1.0, n_data)
        end.record()
        torch.cuda.synchronize()
        check(applied, "update skipped (non-finite gradient)")
        check(np.isfinite(loss.item()), "non-finite loss")
        times.append(start.elapsed_time(end))
    return times


def device_profile(fn, n, warm=True):
    """(device busy ms, device kernels) per call of ``fn`` over ``n``
    calls under torch.profiler (after one call outside it, with
    ``warm``): the sum of the kernels' device times, which run on one
    stream and do not overlap. (None, None) if the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not busy_us:
        return None, None
    return busy_us / 1e3 / n, len(kernels) / n


def leaves_beyond(diffs, rtol):
    """The leaves of ``grad_diffs`` whose relative Frobenius error exceeds
    ``rtol``, and the rounding-noise leaves with an element beyond the
    elementwise tolerance."""
    return [p for p, d in diffs.items()
            if d["fro"] > rtol or (d["noise"] and d["bad"])]


def check_bench_step(scan, seed, targets, card, profile_path=None):
    """Phase 7: the bench configuration's step (bf16 codecs, ragged, video
    in the codec-native layout) on the kernels, on a batch of ``targets``
    from the device loader, against the same trainer fed the loader's
    edge-layout batch and against the f32 step, on the same noise; the
    merged branch once; then the bench configuration timed beside the f32
    two-scan and merged steps, with their device time (and, with
    ``profile_path``, the profiler's table of one bench-configuration step
    appended there). Returns (the bench steps' launches, {config: median
    ms})."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training.device_loader import \
        DeviceTrainData
    dev = targets["video"].device
    trainer = weizmann.make_trainer(seed=seed, device=dev)
    perms = trainer.model.native_input_perms()
    bench_kw = dict(ragged_mode_scans=True, native_mods=tuple(perms))
    bench = weizmann.make_trainer(seed=seed, device=dev,
                                  model_args={"bf16": True},
                                  train_args=bench_kw)

    # One batch of the B_DATA sequences, stored native and stored edge:
    # one seed, so one shuffle and the same bursts.
    items = [dict({m: v[:, b].cpu().numpy() for m, v in targets.items()},
                  length=T_MAIN) for b in range(B_DATA)]
    batches = [next(DeviceTrainData(
        items, list(targets), B_DATA, weizmann.DEFAULTS["burst_frac"],
        native_perms=np_, device=dev).epoch(seed))[:3]
        for np_ in (perms, None)]
    (x_nat, y_nat, mask), (x_edge, y_edge, mask_edge) = batches
    same = lambda a, b: torch.equal(a.nan_to_num(-1.0),  # noqa: E731
                                    b.nan_to_num(-1.0))
    check(torch.equal(mask, mask_edge) and all(
        same(native_batch(e, perms)[m], n[m]) for e, n in
        ((x_edge, x_nat), (y_edge, y_nat)) for m in targets),
        "device loader: the native batch is not the edge batch permuted")
    n_burst = int(torch.isnan(x_edge["video"]).any(-1).any(-1).any(-1).sum())
    log("  device loader: native batch = edge batch permuted by %s, %d "
        "video frames in bursts" % (perms, n_burst))

    torch.backends.cudnn.deterministic = True
    l_nat, g_nat = step_grads(bench, x_nat, y_nat, mask, False, seed,
                              **bench_kw)
    l_edge, g_edge = step_grads(bench, x_edge, y_edge, mask, False, seed,
                                ragged_mode_scans=True)
    l_f32, g_f32 = step_grads(trainer, x_edge, y_edge, mask, False, seed)
    l_f32n, g_f32n = step_grads(trainer, x_nat, y_nat, mask, False, seed,
                                native_mods=tuple(perms))
    torch.backends.cudnn.deterministic = False
    check(np.isfinite(l_nat), "bench step: non-finite loss")

    def hold(what, l_a, g_a, l_b, g_b, loss_tol, grad_rtol, tol):
        """Loss within ``loss_tol`` (rtol, atol) and every gradient leaf
        within ``grad_rtol`` in relative Frobenius norm; the elementwise
        counts at ``tol`` are logged."""
        d = grad_diffs(g_a, g_b, tol)
        log_worst(what, d)
        log("  %s: loss %.6f vs %.6f (relative difference %.3g); "
            "gradients: %d elements in %d leaves beyond rtol %g / atol %g "
            "(normalised), largest relative Frobenius error %.3g; bit for "
            "bit equal: %s"
            % (what, l_a, l_b, (l_a - l_b) / abs(l_b),
               sum(x["bad"] for x in d.values()),
               sum(bool(x["bad"]) for x in d.values()), tol["rtol"],
               tol["atol"], max(x["fro"] for x in d.values()),
               l_a == l_b and all(torch.equal(g_a[p], g_b[p]) for p in g_b)))
        check(abs(l_a - l_b) <= loss_tol[1] + loss_tol[0] * abs(l_b),
              "%s: loss %r vs %r" % (what, l_a, l_b))
        bad = leaves_beyond(d, grad_rtol)
        check(not bad, "%s: gradients of %d leaves differ beyond rtol %g "
              "in relative Frobenius norm: %s"
              % (what, len(bad), grad_rtol, bad))

    log("  (1) native layout vs the edge-layout batch, kernels, same noise: "
        "f32 at the step's tolerance, then the bench configuration (bf16 "
        "codecs, whose cotangents cuDNN rounds to bf16 after summing in a "
        "layout-dependent order) at BF16_TOL")
    hold("f32, native vs edge layout", l_f32n, g_f32n, l_f32, g_f32,
         (STEP_LOSS_RTOL, 0.0), STEP_GRAD_TOL["rtol"], STEP_GRAD_TOL)
    hold("bench step, native vs edge layout", l_nat, g_nat, l_edge, g_edge,
         (STEP_LOSS_RTOL, 0.0), BF16_TOL["rtol"], BF16_TOL)
    log("  (2) bench step (bf16 codecs, native) vs the f32 two-scan step "
        "(edge), kernels, same noise")
    hold("bench step, bf16 vs f32", l_nat, g_nat, l_f32, g_f32,
         (BF16_TOL["rtol"], BF16_TOL["atol"]), BF16_GRAD_RTOL, BF16_TOL)

    log("  (3) merged branch (one scan of 2 V B = %d columns at K = 25), "
        "kernels" % (2 * V_MAIN * B_DATA))
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    l_m, g_m = step_grads(trainer, x_edge, y_edge, mask, False, seed,
                          merge_mode_scans=True)
    merged = {n: fn.launches for n, fn in wrappers.items()}
    check(np.isfinite(l_m), "merged branch: non-finite loss")
    check(all(bool(torch.isfinite(g).all()) for g in g_m.values()),
          "merged branch: non-finite gradient")
    check(merged == {"bfvi_scan_fwd": 2, "bfvi_scan_bwd": 2,
                     "gtf_wgrad": 2, "poe_sample_cell": 0},
          "merged branch launches %s, expected two of each scan kernel"
          % merged)
    log("  merged loss %.6f (two-scan %.6f, relative difference %.3g); "
        "launches %s" % (l_m, l_f32, (l_m - l_f32) / abs(l_f32), merged))

    log("  (4) steps timed in turns, %d per block [%s]" % (N_BENCH, card))
    configs = {
        "two_scan_f32": (trainer, x_edge, y_edge),
        "merge_f32": (weizmann.make_trainer(
            seed=seed, device=dev, train_args={"merge_mode_scans": True}),
            x_edge, y_edge),
        "bench_bf16_ragged_native": (bench, x_nat, y_nat),
    }
    n_data = float(mask.sum().item())
    times = {name: [] for name in configs}
    for name, (tr, x, y) in configs.items():
        time_steps(tr, x, y, mask, n_data, 2)  # warm-up
    bench_launches = None
    order = list(configs) + list(configs)[::-1]
    for i, name in enumerate(order):
        tr, x, y = configs[name]
        counted = name == "bench_bf16_ragged_native" and bench_launches is None
        if counted:
            for fn in wrappers.values():
                fn.launches = 0
        times[name] += time_steps(tr, x, y, mask, n_data, N_BENCH)
        if counted:
            bench_launches = {n: fn.launches for n, fn in wrappers.items()}
    for name in SCAN_KERNELS:
        check(bench_launches[name] == 3 * N_BENCH, "bench steps: %s launched "
              "%d times in %d steps" % (name, bench_launches[name], N_BENCH))
    check(bench_launches["poe_sample_cell"] == 0,
          "the cell kernel launched during training")
    ms = {name: statistics.median(v) for name, v in times.items()}
    for name, v in times.items():
        tr, x, y = configs[name]
        busy, n_kern = device_profile(
            lambda: tr.train_step(x, y, mask, 1.0, n_data), 3)
        dev_note = ("device time not measured" if busy is None else
                    "device busy %.2f ms, %d kernels a step" % (busy, n_kern))
        log("  %-26s median %.2f ms per step over %d steps (blocks in turns),"
            " %.1f seqs/s; %s (torch.profiler, 3 steps) [%s]"
            % (name, ms[name], len(v), B_DATA / (ms[name] / 1e3), dev_note,
               card))
    log("  bench-configuration launches over %d steps: %s"
        % (N_BENCH, bench_launches))
    if profile_path:
        from torch.profiler import ProfilerActivity, profile
        tr, x, y = configs["bench_bf16_ragged_native"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train_step(x, y, mask, 1.0, n_data)
            torch.cuda.synchronize()
        with open(profile_path, "a") as f:
            f.write("\none step of the bench configuration (bf16 codecs, "
                    "ragged, native layout; %.2f ms median without the "
                    "profiler)\n" % ms["bench_bf16_ragged_native"])
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        log("  bench-configuration profile appended to %s" % profile_path)
    return bench_launches, ms


def cli_flags(tmp, seed):
    """Phase 8's fixture, save directory and model flags in ``tmp``."""
    return ["--data_dir", os.path.join(tmp, "data"), "--save_dir",
            os.path.join(tmp, "save"), "--method", "bfvi", "--model_args",
            "{bf16: true}", "--seed", str(seed)]


def run_cli(seed, card, tmp):
    """Phase 8: the command line with ``tmp`` as its working directory,
    fixture and save directory (phase 17 evaluates its checkpoint).
    Returns (the training run's launches, its history)."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
    cwd = os.getcwd()
    os.chdir(tmp)  # param_hist.tsv is written there
    try:
        data, save = os.path.join(tmp, "data"), os.path.join(tmp, "save")
        t0 = time.perf_counter()
        gen_synthetic(data)
        log("  gen_synthetic: 90 sequences in %.1f s"
            % (time.perf_counter() - t0))
        flags = cli_flags(tmp, seed)
        argv = flags + ["--epochs", str(CLI_EPOCHS), "--eval_freq", "1",
                        "--save_freq", "1", "--train_args",
                        "{ragged_mode_scans: true}"]
        log("  main(%s)" % " ".join(argv[4:]))
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hist = weizmann.main(argv)
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in wrappers.items()}
        names = sorted(os.listdir(save))
        check(len(hist["epoch_loss"]) == CLI_EPOCHS
              and all(np.isfinite(hist["epoch_loss"])),
              "epoch losses %s" % hist["epoch_loss"])
        check(all(np.isfinite(e["rec_loss"]) for e in hist["eval"]),
              "non-finite evaluation")
        want = ["best.pth", "last.pth"] + ["epoch_%d.pth" % (e + 1)
                                           for e in range(CLI_EPOCHS)]
        check(sorted(want) == names, "checkpoints %s" % names)
        n_bwd = launches["bfvi_scan_bwd"]
        check(n_bwd > 0 and n_bwd % 3 == 0
              and launches["gtf_wgrad"] == n_bwd
              and launches["bfvi_scan_fwd"] == n_bwd + CLI_EPOCHS
              and launches["poe_sample_cell"] > 0,
              "command-line run launches %s: expected 3 of each scan "
              "kernel per step, one forward scan and the cell per "
              "evaluation" % launches)
        log("  %d epochs of %d steps in %.1f s of command: losses %s, "
            "seconds per epoch %s, evaluation seconds %s, eval rec_loss "
            "%s [%s]" % (CLI_EPOCHS, n_bwd // 3 // CLI_EPOCHS, wall,
                         ["%.1f" % v for v in hist["epoch_loss"]],
                         ["%.2f" % v for v in hist["epoch_s"]],
                         ["%.3f" % v for v in hist["eval_s"]],
                         ["%.1f" % e["rec_loss"] for e in hist["eval"]],
                         card))
        log("  launches: %s; checkpoints %s" % (launches, names))

        torch.backends.cudnn.deterministic = True
        evals = [weizmann.main(flags + [
            "--load", os.path.join(save, "last.pth"), "--evaluate",
            "--save_args", "{skip: true}"]) for _ in range(2)]
        torch.backends.cudnn.deterministic = False
        for i, name in enumerate(("train", "test")):
            a, b = dict(evals[0][i]), dict(evals[1][i])
            check(a.keys() == b.keys() and all(
                a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))
                for k in a), "--load --evaluate on the %s set: two runs "
                "differ: %s vs %s" % (name, a, b))
            check(np.isfinite(a["rec_loss"]) and 0 <= a["ssim"] <= 1,
                  "--load --evaluate %s metrics %s" % (name, a))
            log("  --load last.pth --evaluate, %s set, twice: identical;"
                " rec_loss %.2f, kld %.2f, mse %.4f, ssim %.4f"
                % (name, a["rec_loss"], a["kld_loss"], a["mse"],
                   a["ssim"]))
    finally:
        os.chdir(cwd)
    return launches, hist


# -- phases 9-11: the spirals app and the baselines ---------------------------

def spirals_batch(seed, dev):
    """A full-width spirals batch (T = 100, B = 100): every tenth spiral
    of the app's corpus (both directions), its noisy x and y, 10 % of
    each modality's steps deleted (NaN) in the inputs, full targets."""
    from multimodal_dmm_tpu_torch.data.spirals import gen_spirals
    _, spirals = gen_spirals()
    arr = np.stack(spirals[::10][:SP_B], axis=1)  # (T, B, 8)
    rng = np.random.RandomState(seed)
    targets = {"spiral-x": arr[..., 2:3], "spiral-y": arr[..., 3:4]}
    inputs = {m: v.copy() for m, v in targets.items()}
    for v in inputs.values():
        v[rng.rand(SP_T, SP_B) < 0.1] = np.nan
    def to(d):
        return {m: torch.tensor(v, dtype=torch.float32, device=dev)
                for m, v in d.items()}
    return to(inputs), to(targets), torch.ones((SP_T, SP_B, 1), device=dev)


def scan_launch_shapes(scan, fn):
    """``fn()``, and the (T, M, columns, K) of each forward scan launch in
    it, in launch order."""
    shapes, launch = [], scan.bfvi_scan_fwd_cuda

    def recorded(obs_mean, *rest, **kw):
        shapes.append(tuple(obs_mean.shape[:3]) + (rest[5].shape[1],))
        return launch(obs_mean, *rest, **kw)
    # The wrapper counts its launches under the module's name, which is
    # the recording one's while it is in place: every route's counter.
    for name in scan._COUNTERS.values():
        setattr(recorded, name, getattr(launch, name))
    scan.bfvi_scan_fwd_cuda = recorded
    try:
        out = fn()
    finally:
        for name in scan._COUNTERS.values():
            setattr(launch, name, getattr(recorded, name))
        scan.bfvi_scan_fwd_cuda = launch
    return out, shapes


def check_spirals_kernels(scan, cell, seed, dev):
    """Phase 9: the kernels at the spirals app's shapes against their
    plain versions. The (M, K) of the step's three scans come from one
    spirals training step on the kernels. Returns (the trainer, the
    batch, the scan records, the cell record)."""
    from multimodal_dmm_tpu_torch.apps import spirals
    trainer = spirals.make_trainer(seed=seed, device=dev)
    model = trainer.model
    inputs, targets, mask = spirals_batch(seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        _, launched = scan_launch_shapes(scan, lambda: model.step(
            trainer.params, trainer.state, inputs, mask, 1.0,
            trainer.rec_mults, gen, targets=targets, train=True))
    n, vb = model.n_mods, (1 + model.n_mods) * SP_B
    want = [(SP_T, n, vb, 1), (SP_T, n, vb, 25), (SP_T, n + 2, vb, 1)]
    check(launched == want, "the spirals step's scans (T, M, V B, K) are %s, "
          "expected %s" % (launched, want))
    log("  the spirals step's three forward scans (T, M, V B, K): %s, by the "
        "rule that gives Weizmann's (3, 1), (3, 25), (5, 1): M = the %d "
        "modalities (the smoothing pass: + the filter prior and the inverse "
        "global prior), K = 1 (f-mode filter), 25 (train_particles), 1 "
        "(smoothing), V = 1 + %d variants; D = %d, H = %d"
        % (launched, n, n, model.z_dim, model.h_dim))
    gtf = {k: {kk: v.detach() for kk, v in p.items()}
           for k, p in trainer.params["trans"]["bwd"].items()}
    rec = check_kernels(scan, gtf, dev, SP_T, vb,
                        [(m, k) for _, m, _, k in launched],
                        smooth_shape=(SP_T, SP_B, n + 2, 1), seed=500)
    cell_rec = check_cell(cell, dev, ((n, 200, False), (n + 2, 1, True)),
                          SP_B, model.z_dim, seed=600)
    return trainer, (inputs, targets, mask), rec, cell_rec


def spirals_cli(argv):
    """``apps.spirals.main(argv)`` with the launch counts set to 0 just
    before and read just after; returns (what main returns, launches,
    seconds)."""
    from multimodal_dmm_tpu_torch.apps import spirals
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = spirals.main(argv)
    return (out, {n: fn.launches for n, fn in wrappers.items()},
            time.perf_counter() - t0)


def check_reload(main_fn, flags, save, what):
    """``--load last.pth --evaluate --eval_sets test`` twice under one
    seed, deterministic cuDNN: identical finite metrics. Returns them."""
    torch.backends.cudnn.deterministic = True
    a, b = [dict(main_fn(flags + [
        "--load", os.path.join(save, "last.pth"), "--evaluate",
        "--eval_sets", "test", "--save_args", "{skip: true}"])[1])
        for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    check(a.keys() == b.keys() and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a),
        "%s: --load --evaluate: two runs differ: %s vs %s" % (what, a, b))
    check(np.isfinite(a["rec_loss"]) and np.isfinite(a["kld_loss"]),
          "%s: --load --evaluate metrics %s" % (what, a))
    return a


def busy_note(trainer, batch, n, warm=True):
    """The device's busy time and kernels of ``n`` training steps on
    ``batch`` under torch.profiler, as a note for the log."""
    inputs, targets, mask = batch
    n_data = float(mask.sum().item())
    busy, n_kern = device_profile(
        lambda: trainer.train_step(inputs, targets, mask, 1.0, n_data), n,
        warm=warm)
    if busy is None:
        return "device time not measured"
    return ("device busy %.2f ms, %d kernels a step (torch.profiler, %d "
            "step%s)" % (busy, n_kern, n, "s" if n > 1 else ""))


def check_spirals_bfvi(scan, trainer, batch, seed, tmp, card,
                       profile_path=None):
    """Phase 10: one spirals BFVI step on the kernels against the plain
    versions, timed steps (with ``profile_path``, the profiler's table of
    one step appended there), then the command line: 2 epochs and an
    evaluation after each, then ``--load last.pth --evaluate`` twice.
    Returns (the command line's launches, a record of its times)."""
    inputs, targets, mask = batch
    check_step_against_plain(scan, trainer, inputs, targets, mask, seed,
                             n_launches=3)
    n_data = float(mask.sum().item())
    times = time_steps(trainer, inputs, targets, mask, n_data,
                       1 + SP_STEPS)[1:]
    step_ms = statistics.median(times)
    log("  step: median %.2f ms over %d steps, %.1f seqs/s; %s [%s]"
        % (step_ms, len(times), SP_B / (step_ms / 1e3),
           busy_note(trainer, batch, 2), card))
    if profile_path:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(inputs, targets, mask, 1.0, n_data)
            torch.cuda.synchronize()
        with open(profile_path, "a") as f:
            f.write("\none spirals BFVI step (T = B = 100, z = 5, h = 20; "
                    "%.2f ms median without the profiler)\n" % step_ms)
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=30))

    data, save = os.path.join(tmp, "spirals"), os.path.join(tmp, "sp_bfvi")
    flags = ["--data_dir", data, "--save_dir", save, "--method", "bfvi",
             "--seed", str(seed)]
    argv = flags + ["--epochs", str(CLI_EPOCHS), "--eval_freq", "1",
                    "--save_freq", "1"]
    log("  main(%s), the corpus generated by the port" % " ".join(argv[4:]))
    hist, launches, wall = spirals_cli(argv)
    n_test = len(os.listdir(os.path.join(data, "test")))
    n_eval = CLI_EPOCHS * -(-n_test // SP_B)  # evaluation batches
    n_bwd = launches["bfvi_scan_bwd"]
    check(len(hist["epoch_loss"]) == CLI_EPOCHS
          and all(np.isfinite(hist["epoch_loss"]))
          and all(np.isfinite(e["mse"]) for e in hist["eval"]),
          "spirals run: losses %s, evaluations %s" % (hist["epoch_loss"],
                                                     hist["eval"]))
    check(n_bwd > 0 and n_bwd % 3 == 0 and launches["gtf_wgrad"] == n_bwd
          and launches["bfvi_scan_fwd"] == n_bwd + n_eval
          and launches["poe_sample_cell"] == n_eval * SP_T,
          "spirals run launches %s: expected 3 of each scan kernel a step, "
          "and per evaluation batch (%d) one forward scan and the cell T = "
          "%d times" % (launches, n_eval, SP_T))
    log("  %d epochs of %d steps in %.1f s of command: losses %s, seconds "
        "per epoch %s, evaluation seconds %s, eval mse %s; launches %s [%s]"
        % (CLI_EPOCHS, n_bwd // 3 // CLI_EPOCHS, wall,
           ["%.3f" % v for v in hist["epoch_loss"]],
           ["%.2f" % v for v in hist["epoch_s"]],
           ["%.3f" % v for v in hist["eval_s"]],
           ["%.4f" % e["mse"] for e in hist["eval"]], launches, card))
    from multimodal_dmm_tpu_torch.apps import spirals
    test = check_reload(spirals.main, flags, save, "spirals BFVI")
    log("  --load last.pth --evaluate twice: identical; test mse %.4f, "
        "rec_loss %.3f, kld %.3f" % (test["mse"], test["rec_loss"],
                                      test["kld_loss"]))
    return launches, dict(step_ms=step_ms, epoch_s=hist["epoch_s"],
                          eval_s=hist["eval_s"])


def baseline_grads(model, params, state, inputs, targets, mask, rec_mults,
                   **step_kw):
    """Loss and gradients {path: grad} of one MAP step of ``model`` (no
    update) on ``params`` (a tree of leaves on one device)."""
    from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path, tree_map
    params = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      params)
    loss, _ = model.step(params, state, inputs, mask, 1.0, rec_mults, None,
                         targets=targets, train=True, sample=False,
                         **step_kw)
    loss.backward()
    return loss.item(), {path: p.grad for path, p in
                         tree_leaves_with_path(params)}


def check_baselines(seed, dev, batch, tmp, card):
    """Phase 11: the DKS (b-skip, f-mask) and VRNN MAP forward and step on
    the card against the port on the CPU at the spirals width, timed
    steps; one epoch of ``--method b-mask`` and of ``--model vrnn``
    through ``apps.spirals.main``; Weizmann ``--method f-mask`` at full
    width through ``apps.weizmann.main``: one epoch and an evaluation,
    then its checkpoint reloaded twice. Returns {config: step ms}."""
    from multimodal_dmm_tpu_torch.apps import spirals, weizmann
    from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
    from multimodal_dmm_tpu_torch.tree import tree_map
    cpu = lambda d: {m: v.cpu() for m, v in d.items()}  # noqa: E731
    inputs, targets, mask = batch
    step_ms = {}
    for name, model_name, model_args, train_args in (
            ("dks b-skip", "dks", dict(rnn_dir="bwd", rnn_skip=True,
                                       feat_to_z=False), dict(uni_loss=False)),
            ("dks f-mask", "dks", dict(rnn_dir="fwd", rnn_skip=False,
                                       feat_to_z=False), dict(uni_loss=False)),
            ("vrnn", "vrnn", {}, {})):
        trainer = spirals.make_trainer(seed=seed, device=dev,
                                       model=model_name,
                                       model_args=model_args,
                                       train_args=train_args)
        model = trainer.model
        p_cpu, s_cpu = model.init(seed, device="cpu")
        with torch.no_grad():
            got = model.forward(trainer.params, trainer.state, inputs,
                                sample=False)[0]
            exp = model.forward(p_cpu, s_cpu, cpu(inputs), sample=False)[0]
        outs = [(n, g, e) for n, g, e in zip(
            ("infer_mean", "infer_std", "prior_mean", "prior_std"),
            got[0] + got[1], exp[0] + exp[1])]
        outs += [("recon %s %d" % (m, i), g, e) for m in model.modalities
                 for i, (g, e) in enumerate(zip(got[2][m], exp[2][m]))]
        worst = 0.0
        for what, g, e in outs:
            check(bool(torch.isfinite(g).all()), "%s: non-finite %s"
                  % (name, what))
            err = ((g.cpu() - e).abs().max() / (e.abs().max() + 1e-6)).item()
            worst = max(worst, err)
            check(err <= BASELINE_FWD_TOL, "%s MAP forward %s: card vs CPU "
                  "max error %.3g of the largest value" % (name, what, err))
        l_g, g_g = baseline_grads(model, trainer.params, trainer.state,
                                  inputs, targets, mask, trainer.rec_mults,
                                  **train_args)
        l_c, g_c = baseline_grads(model, p_cpu, s_cpu, cpu(inputs),
                                  cpu(targets), mask.cpu(), trainer.rec_mults,
                                  **train_args)
        d = grad_diffs(g_g, {k: v.to(dev) for k, v in g_c.items()})
        bad = leaves_beyond(d, STEP_GRAD_TOL["rtol"])
        check(abs(l_g - l_c) <= STEP_LOSS_RTOL * abs(l_c),
              "%s step loss: card %r vs CPU %r" % (name, l_g, l_c))
        check(not bad, "%s step gradients of %d leaves differ beyond rtol %g "
              "in relative Frobenius norm: %s"
              % (name, len(bad), STEP_GRAD_TOL["rtol"], bad))
        n_data = float(mask.sum().item())
        times = time_steps(trainer, inputs, targets, mask, n_data,
                           1 + SP_STEPS)[1:]
        step_ms[name] = statistics.median(times)
        log("  %s (spirals, T = B = 100): MAP forward card vs CPU within %.3g "
            "of the largest value; step loss %.6f vs %.6f, largest leaf "
            "relative Frobenius error %.3g over %d leaves; step median "
            "%.2f ms over %d steps; %s [%s]"
            % (name, worst, l_g, l_c, max(x["fro"] for x in d.values()),
               len(d), step_ms[name], len(times),
               busy_note(trainer, batch, 1, warm=False), card))

    data = os.path.join(tmp, "spirals")
    for flags in (["--method", "b-mask"], ["--model", "vrnn"]):
        save = os.path.join(tmp, "sp_" + flags[1])
        hist, launches, wall = spirals_cli(
            ["--data_dir", data, "--save_dir", save, "--seed", str(seed),
             "--epochs", "1", "--eval_freq", "1", "--save_freq", "1"]
            + flags)
        check(all(np.isfinite(hist["epoch_loss"]))
              and np.isfinite(hist["eval"][0]["mse"]),
              "spirals %s: loss %s, evaluation %s"
              % (flags[1], hist["epoch_loss"], hist["eval"]))
        check(not any(launches.values()), "spirals %s launched kernels: %s"
              % (flags[1], launches))
        log("  spirals %s: 1 epoch in %.2f s, evaluation %.2f s, loss %.3f, "
            "eval mse %.4f (%.1f s of command) [%s]"
            % (" ".join(flags), hist["epoch_s"][0], hist["eval_s"][0],
               hist["epoch_loss"][0], hist["eval"][0]["mse"], wall, card))

    data, save = os.path.join(tmp, "weizmann"), os.path.join(tmp, "wz_dks")
    gen_synthetic(data)
    flags = ["--data_dir", data, "--save_dir", save, "--method", "f-mask",
             "--seed", str(seed)]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hist = weizmann.main(flags + ["--epochs", "1", "--eval_freq", "1",
                                  "--save_freq", "1"])
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    check(all(np.isfinite(hist["epoch_loss"]))
          and np.isfinite(hist["eval"][0]["rec_loss"]),
          "Weizmann f-mask: loss %s, evaluation %s" % (hist["epoch_loss"],
                                                       hist["eval"]))
    check(not any(launches.values()), "Weizmann f-mask launched kernels: %s"
          % launches)
    test = check_reload(weizmann.main, flags, save, "Weizmann f-mask")
    log("  Weizmann --method f-mask (z = h = 256): 1 epoch in %.2f s, "
        "evaluation %.2f s, loss %.1f (%.1f s of command); --load "
        "last.pth --evaluate twice: identical, test rec_loss %.1f, ssim "
        "%.4f [%s]" % (hist["epoch_s"][0], hist["eval_s"][0],
                       hist["epoch_loss"][0], wall, test["rec_loss"],
                       test["ssim"], card))
    dks = weizmann.make_trainer(
        seed=seed, device=dev, model="dks", model_args=dict(
            rnn_dir="fwd", rnn_skip=False, feat_to_z=True),
        train_args=dict(uni_loss=True))
    w_inputs, w_targets, w_mask = synthetic_batch(seed, dev)
    times = time_steps(dks, w_inputs, w_targets, w_mask,
                       float(w_mask.sum().item()), 1 + SP_STEPS)[1:]
    step_ms["dks f-mask weizmann"] = statistics.median(times)
    log("  Weizmann DKS f-mask step (T = B = 25): median %.2f ms over %d "
        "steps; %s [%s]" % (step_ms["dks f-mask weizmann"], len(times),
                            busy_note(dks, (w_inputs, w_targets, w_mask), 1,
                                      warm=False), card))
    return step_ms


# -- phase 12: the VidTIMIT app ----------------------------------------------

def vidtimit_batch(data, seed, dev):
    """A training batch of the VidTIMIT fixture in ``data``: its training
    set (sentences other than sa1/sa2) split into 25-step chunks, one
    batch of VT_B from the device loader (burst deletion), in the edge
    layout; returns (inputs, targets, mask) and the lengths."""
    from multimodal_dmm_tpu_torch.apps import vidtimit
    from multimodal_dmm_tpu_torch.data.vidtimit import VidTIMITDataset
    from multimodal_dmm_tpu_torch.training.device_loader import \
        DeviceTrainData
    ds = VidTIMITDataset(data, item_as_dict=True)
    train = ds.select([None, ["sa1", "sa2"]], invert=True)
    train = train.split(vidtimit.DEFAULTS["split"], True)
    loader = DeviceTrainData(train, vidtimit.DEFAULTS["modalities"], VT_B,
                             vidtimit.DEFAULTS["burst_frac"], device=dev)
    inputs, targets, mask, lengths = next(loader.epoch(seed))
    return (inputs, targets, mask), lengths


def vidtimit_eval_cells(data):
    """The cell launches of one evaluation of the fixture's test set (the
    sa1/sa2 sequences, in the dataset's order, in batches of VT_B): the
    sum of each batch's longest sequence, the video's frame count (the
    audio has one frame more, which the dataset truncates)."""
    vdir = os.path.join(data, "video")
    names = sorted(f for f in os.listdir(vdir)
                   if f.endswith(("_sa1.npy", "_sa2.npy")))
    lengths = [np.load(os.path.join(vdir, f), mmap_mode="r").shape[0]
               for f in names]
    batches = [lengths[i:i + VT_B] for i in range(0, len(lengths), VT_B)]
    return len(batches), sum(max(b) for b in batches)


def check_vidtimit(scan, cell, seed, dev, tmp, card, profile_path=None):
    """Phase 12: the VidTIMIT app at full width (z = h = 256, video 3x64x64
    and audio 10x1281, both Bernoulli). (a) the kernels at its shapes
    against their plain versions; (b) one BFVI step on the kernels
    against the plain versions, on a fixture batch in the codec-native
    layout; (c) timed f32, bf16 and DKS f-mask steps; (d) the command
    line: 2 epochs of --method bfvi with an evaluation after each, then
    ``--load last.pth --evaluate`` twice. With ``profile_path``, the
    profiler's table of one f32 step is appended there. Returns (the scan
    records, the cell record, the command line's launches)."""
    from multimodal_dmm_tpu_torch.apps import vidtimit
    from multimodal_dmm_tpu_torch.data.vidtimit import gen_synthetic
    data, small = os.path.join(tmp, "vidtimit"), os.path.join(tmp, "vt_3")
    t0 = time.perf_counter()
    gen_synthetic(data, n_subjects=VT_SUBJECTS, n_sentences=VT_SENTENCES,
                  t_range=(40, 80))
    log("  gen_synthetic: %d subjects x %d sentences in %.1f s"
        % (VT_SUBJECTS, VT_SENTENCES, time.perf_counter() - t0))
    # The same seed writes the same first subjects: a 3-subject copy for
    # the step's batch, quicker to load than the whole fixture.
    gen_synthetic(small, n_subjects=3, n_sentences=VT_SENTENCES,
                  t_range=(40, 80))

    trainer = vidtimit.make_trainer(seed=seed, device=dev)
    model = trainer.model
    perms = model.native_input_perms()
    batch, lengths = vidtimit_batch(small, seed, dev)
    inputs, targets, mask = batch
    nat_in, nat_tg = native_batch(inputs, perms), native_batch(targets, perms)
    step_kw = dict(native_mods=tuple(m for m in model.modalities
                                     if m in perms))
    t_batch = int(mask.shape[0])
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        _, launched = scan_launch_shapes(scan, lambda: model.step(
            trainer.params, trainer.state, nat_in, mask, 1.0,
            trainer.rec_mults, gen, targets=nat_tg, train=True, **step_kw))
    n, vb = model.n_mods, (1 + model.n_mods) * VT_B
    want = [(t_batch, n, vb, 1), (t_batch, n, vb, 25),
            (t_batch, n + 2, vb, 1)]
    check(launched == want, "the VidTIMIT step's scans (T, M, V B, K) are "
          "%s, expected %s" % (launched, want))
    log("  the VidTIMIT step's three forward scans (T, M, V B, K): %s on a "
        "fixture batch of lengths %s; native layout %s"
        % (launched, lengths, perms))

    log("  (a) kernels at T = %d, V B = %d, (M, K) = %s, smoothing (T, B, "
        "M, K) = (%d, %d, %d, 1); cell (M, K, B, D) = (%d, 200, %d, %d)"
        % (VT_T, vb, [(m, k) for _, m, _, k in want], VT_T, VT_B, n + 2,
           n, VT_B, model.z_dim))
    gtf = {k: {kk: v.detach() for kk, v in p.items()}
           for k, p in trainer.params["trans"]["bwd"].items()}
    rec = check_kernels(scan, gtf, dev, VT_T, vb,
                        [(m, k) for _, m, _, k in want],
                        smooth_shape=(VT_T, VT_B, n + 2, 1), seed=700)
    cell_rec = check_cell(cell, dev, ((n, 200, False), (n + 2, 1, True)),
                          VT_B, model.z_dim, seed=800)

    log("  (b) one BFVI step on the kernels vs the plain versions, fixture "
        "batch, native layout")
    check_step_against_plain(scan, trainer, nat_in, nat_tg, mask, seed,
                             **step_kw)

    log("  (c) timed steps [%s]" % card)
    n_data = float(mask.sum().item())
    step_ms = {}
    bf16 = vidtimit.make_trainer(seed=seed, device=dev,
                                 model_args={"bf16": True})
    dks = vidtimit.make_trainer(seed=seed, device=dev, model="dks",
                                model_args=dict(rnn_dir="fwd",
                                                rnn_skip=False),
                                train_args=dict(uni_loss=True))
    for name, tr, x, y, kw in (
            ("bfvi f32", trainer, nat_in, nat_tg, step_kw),
            ("bfvi bf16", bf16, nat_in, nat_tg, step_kw),
            ("dks f-mask", dks, inputs, targets, {})):
        tr.train_args = dict(tr.train_args, **kw)
        times = time_steps(tr, x, y, mask, n_data, 1 + VT_STEPS)[1:]
        step_ms[name] = statistics.median(times)
        log("  %s step (T = %d, B = %d): median %.2f ms over %d steps, %.1f "
            "seqs/s; %s [%s]" % (name, t_batch, VT_B, step_ms[name],
                                 len(times), VT_B / (step_ms[name] / 1e3),
                                 busy_note(tr, (x, y, mask), 2), card))
    if profile_path:
        from torch.profiler import ProfilerActivity, profile
        trainer.train_args = dict(step_kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(nat_in, nat_tg, mask, 1.0, n_data)
            torch.cuda.synchronize()
        with open(profile_path, "a") as f:
            f.write("\none VidTIMIT BFVI step (T = B = 25, z = h = 256, "
                    "f32, native layout; %.2f ms median without the "
                    "profiler)\n" % step_ms["bfvi f32"])
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=30))

    log("  (d) the command line, --method bfvi, %d epochs" % CLI_EPOCHS)
    save = os.path.join(tmp, "vt_bfvi")
    flags = ["--data_dir", data, "--save_dir", save, "--method", "bfvi",
             "--seed", str(seed)]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hist = vidtimit.main(flags + ["--epochs", str(CLI_EPOCHS),
                                  "--eval_freq", "1", "--save_freq", "1"])
    wall = time.perf_counter() - t0
    launches = {nm: fn.launches for nm, fn in wrappers.items()}
    names = sorted(os.listdir(save))
    check(len(hist["epoch_loss"]) == CLI_EPOCHS
          and all(np.isfinite(hist["epoch_loss"]))
          and all(np.isfinite(e["rec_loss"]) and np.isfinite(e["a_mse"])
                  for e in hist["eval"]),
          "VidTIMIT run: losses %s, evaluations %s" % (hist["epoch_loss"],
                                                      hist["eval"]))
    want_ck = ["best.pth", "last.pth"] + ["epoch_%d.pth" % (e + 1)
                                          for e in range(CLI_EPOCHS)]
    check(sorted(want_ck) == names, "VidTIMIT checkpoints %s" % names)
    n_eval, eval_cells = vidtimit_eval_cells(data)
    n_bwd = launches["bfvi_scan_bwd"]
    check(n_bwd > 0 and n_bwd % 3 == 0 and launches["gtf_wgrad"] == n_bwd
          and launches["bfvi_scan_fwd"] == n_bwd + CLI_EPOCHS * n_eval
          and launches["poe_sample_cell"] == CLI_EPOCHS * eval_cells,
          "VidTIMIT run launches %s: expected 3 of each scan kernel a step, "
          "and per evaluation (%d batches, %d cell steps) one forward scan a "
          "batch and the cell at each step" % (launches, n_eval, eval_cells))
    log("  %d epochs of %d steps in %.1f s of command: losses %s, seconds "
        "per epoch %s, evaluation seconds %s, eval rec_loss %s, a_mse %s; "
        "launches %s; checkpoints %s [%s]"
        % (CLI_EPOCHS, n_bwd // 3 // CLI_EPOCHS, wall,
           ["%.1f" % v for v in hist["epoch_loss"]],
           ["%.2f" % v for v in hist["epoch_s"]],
           ["%.3f" % v for v in hist["eval_s"]],
           ["%.1f" % e["rec_loss"] for e in hist["eval"]],
           ["%.4f" % e["a_mse"] for e in hist["eval"]], launches, names,
           card))
    t0 = time.perf_counter()
    test = check_reload(vidtimit.main, flags, save, "VidTIMIT BFVI")
    check(0.0 <= test["ssim"] <= 1.0 and np.isfinite(test["a_mse"]),
          "VidTIMIT --load --evaluate metrics %s" % test)
    log("  --load last.pth --evaluate twice (%.1f s): identical; test "
        "rec_loss %.1f, kld %.2f, v_mse %.4f, ssim %.4f, a_mse %.4f"
        % (time.perf_counter() - t0, test["rec_loss"], test["kld_loss"],
           test["v_mse"], test["ssim"], test["a_mse"]))
    return rec, cell_rec, launches


# -- phase 13: the experiment layer ------------------------------------------

# The Weizmann grid of phase 13 (b): semi-supervised levels x seeds.
GRID_LEVELS, GRID_REPEATS = ("0.0", "0.5"), 2
# What one fresh worker process spends before its trial's first line: the
# interpreter with torch and the port imported, the CUDA context, the
# kernels' libraries loaded (their build is there already).
PROBE = """
import json, time
t0 = time.time()
import torch
from multimodal_dmm_tpu_torch.apps import spirals
from multimodal_dmm_tpu_torch.ops.cuda import _build
t1 = time.time()
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
t2 = time.time()
_build.load("bfvi_scan"); _build.load("poe_cell")
t3 = time.time()
print(json.dumps({"imports_s": t1 - t0, "cuda_context_s": t2 - t1,
                  "kernel_libraries_s": t3 - t2, "t0": t0}))
"""


def subprocess_env():
    """This environment with the repository on the path and unbuffered
    output (each line of a child arrives when it is printed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path),
                PYTHONUNBUFFERED="1")


def stream_lines(cmd, cwd):
    """Run ``cmd`` and return (exit code, [(seconds since the start, line)])
    with each line of its output (stdout and stderr) stamped as it
    arrives; the process has ended when this returns."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=cwd,
                            env=subprocess_env())
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        return proc.wait(), lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def first_at(lines, start, prefix):
    """The index of the first line at or after ``start`` that begins with
    ``prefix``, else None."""
    for i in range(start, len(lines)):
        if lines[i][1].startswith(prefix):
            return i
    return None


def trial_timeline(lines, start, end):
    """Seconds of one isolated trial's parts, from its worker's lines
    between ``start`` (the runner's "== Trial" line) and ``end``."""
    marks = {}
    for key, prefix in (("setup", "Setting up"), ("data", "Loading data"),
                        ("data_done", "Done."), ("model", "Constructing"),
                        ("built", "Number of parameters")):
        i = first_at(lines, start, prefix)
        check(i is not None and i < end, "trial at line %d: no %r line"
              % (start, prefix))
        marks[key] = lines[i][0]
    epochs = [lines[i][0] for i in range(start, end)
              if lines[i][1].startswith("Epoch: ")]
    evals = [lines[i][0] for i in range(start, end)
             if lines[i][1].startswith("Evaluation")]
    check(len(epochs) == len(evals) == CLI_EPOCHS,
          "trial at line %d: %d epochs, %d evaluations" % (start,
                                                           len(epochs),
                                                           len(evals)))
    t_end = lines[end][0] if end < len(lines) else lines[-1][0]
    prev = [marks["built"]] + evals[:-1]
    return {"start_s": marks["setup"] - lines[start][0],
            "data_s": marks["data_done"] - marks["data"],
            "build_s": marks["built"] - marks["model"],
            "epoch_s": [e - p for e, p in zip(epochs, prev)],
            "eval_s": [v - e for v, e in zip(evals, epochs)],
            "end_s": t_end - evals[-1],
            "total_s": t_end - lines[start][0]}


def analysis_timeline(lines, start):
    """Seconds of the suite's analysis from line ``start`` on: per trial
    (from its "Trial:" line to the next) and per task (from its
    "==Inference Task" line to the next task's or trial's)."""
    heads = [i for i in range(start, len(lines))
             if lines[i][1].startswith("Trial: ")]
    per_trial, first_task, later_tasks = [], [], []
    for n, i in enumerate(heads):
        stop = heads[n + 1] if n + 1 < len(heads) else len(lines) - 1
        per_trial.append(lines[stop][0] - lines[i][0])
        tasks = [j for j in range(i, stop)
                 if lines[j][1].startswith("==Inference Task")]
        bounds = tasks + [stop]
        secs = [lines[b][0] - lines[a][0] for a, b in zip(bounds, bounds[1:])]
        first_task.append(secs[0])
        later_tasks += secs[1:]
    return per_trial, first_task, later_tasks


def check_spirals_suite(data, root, card):
    """Phase 13 (a): the spirals suite from its command line, one worker
    process per trial (five methods, seed 0), then its analysis; every
    trial TERMINATED, the four CSVs five methods x five tasks, finite.
    Logs the times of the trials' parts and of the analysis."""
    from multimodal_dmm_tpu_torch.experiments import table
    rc, probe = stream_lines([sys.executable, "-c", PROBE], root)
    check(rc == 0, "worker probe failed: %s" % probe[-20:])
    probe = json.loads(probe[-1][1])
    log("  a fresh worker process: imports %.2f s (torch and the port), "
        "CUDA context %.2f s, kernel libraries %.3f s [%s]"
        % (probe["imports_s"], probe["cuda_context_s"],
           probe["kernel_libraries_s"], card))
    cfg = "{epochs: %d, eval_freq: 1, save_freq: 1, data_dir: %s}" % (
        CLI_EPOCHS, json.dumps(data))
    cmd = [sys.executable, "-m",
           "multimodal_dmm_tpu_torch.experiments.spirals_suite",
           "--local_dir", root, "--config", cfg]
    log("  %s" % " ".join(cmd[1:]))
    rc, lines = stream_lines(cmd, root)
    with open(os.path.join(root, "spirals_suite.log"), "w") as f:
        f.writelines("%8.3f %s\n" % tl for tl in lines)
    check(rc == 0, "spirals suite exited %d: %s" % (
        rc, "\n".join(tl[1] for tl in lines[-40:])))
    exp_dir = os.path.join(root, "spirals_suite")
    with open(os.path.join(exp_dir, "experiment_state-spirals_suite.json")) \
            as f:
        state = json.load(f)["checkpoints"]
    methods = ["bfvi", "b-mask", "f-mask", "b-skip", "f-skip"]
    check([c["config"]["method"] for c in state] == methods
          and all(c["status"] == "TERMINATED" for c in state),
          "spirals suite trials: %s" % [(c["config"]["method"], c["status"])
                                        for c in state])
    tasks = ["recon", "half", "fwd", "bwd", "condgen"]
    for name, cols in (("run_results.csv", ["mean_loss", "mse"]),
                       ("task_results.csv", tasks),
                       ("task_results_std.csv", tasks),
                       ("task_results_runs.csv", tasks)):
        tab = table.read_csv(os.path.join(exp_dir, name))
        check(sorted(tab["method"].tolist()) == sorted(methods)
              and all(np.isfinite(tab[c].tolist()).all() for c in cols),
              "%s: %s" % (name, tab))
    starts = [i for i, (_, l) in enumerate(lines) if l.startswith("== Trial")]
    analysis = first_at(lines, starts[-1], "===")
    trials = [trial_timeline(lines, a, b)
              for a, b in zip(starts, starts[1:] + [analysis])]
    per_trial, first_task, later_tasks = analysis_timeline(lines, analysis)
    for m, t in zip(methods, trials):
        log("  trial %-6s %.2f s: start %.2f (process, imports), data %.2f, "
            "model on the card %.2f, epochs %s, evaluations %s, checkpoints "
            "and exit %.2f" % (m, t["total_s"], t["start_s"], t["data_s"],
                               t["build_s"],
                               ["%.2f" % v for v in t["epoch_s"]],
                               ["%.2f" % v for v in t["eval_s"]], t["end_s"]))
    log("  analysis %.2f s: per trial %s s; first task of a trial (the "
        "trainer built, the checkpoint loaded) median %.2f s, later tasks "
        "median %.2f s (%d tasks) [%s]"
        % (lines[-1][0] - lines[analysis][0],
           ["%.2f" % v for v in per_trial], statistics.median(first_task),
           statistics.median(later_tasks), len(later_tasks), card))
    log("  spirals suite: %.1f s of command, trials %.1f s, the CSVs: five "
        "methods x five tasks, finite" % (lines[-1][0],
                                          lines[analysis][0]
                                          - lines[starts[0]][0]))


def check_weizmann_grid(data, root, card):
    """Phase 13 (b)-(d): a Weizmann semi-supervised grid at full width in
    this process (z = h = 256, BFVI, two levels x two seeds, two epochs)
    with the kernels' launches checked against its steps and
    evaluations, its best-3 analysis; the grid resumed (every trial
    already done, nothing launched); then ``--find_best`` on one trial.
    Returns the grid's launches."""
    import contextlib
    import io
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.experiments import table
    from multimodal_dmm_tpu_torch.experiments import weizmann_semisup as ws
    from multimodal_dmm_tpu_torch.training.trainer import Trainer
    W = weizmann.WeizmannTrainer
    # The grid sets no --method: without one the trials' evaluation
    # filters with one particle, through the scan kernel, and never
    # reaches the cell; "bfvi" gives them the 200-particle filter.
    argv = ["--local_dir", root, "--no_isolate", "--n_repeats",
            str(GRID_REPEATS), "--levels", *GRID_LEVELS, "--config",
            "{epochs: %d, eval_freq: 1, save_freq: 1, method: bfvi, "
            "data_dir: %s}" % (CLI_EPOCHS, json.dumps(data))]
    trial_s, trainers, steps = [], [], [0]

    def timed_tune(cls, config, reporter):
        t0 = time.perf_counter()
        try:
            return Trainer.tune.__func__(cls, config, reporter)
        finally:
            trial_s.append(time.perf_counter() - t0)

    def keep(cls, args):
        trainers.append(Trainer.from_args.__func__(cls, args))
        return trainers[-1]

    def counted_step(self, *a, **kw):
        steps[0] += 1
        return Trainer.train_step(self, *a, **kw)

    wrappers = kernel_wrappers()
    W.tune, W.from_args = classmethod(timed_tune), classmethod(keep)
    W.train_step = counted_step
    try:
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ws.run(ws.parser.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in wrappers.items()}
        n_trials = len(GRID_LEVELS) * GRID_REPEATS
        check(len(trainers) == len(trial_s) == n_trials,
              "%d trials built, %d run" % (len(trainers), len(trial_s)))
        # Per trial: an evaluation each epoch of the test set's batches,
        # one smoothing scan a batch and the cell at each of its steps.
        eval_batches = eval_cells = 0
        for tr in trainers:
            (_, dev_data), = tr._eval_dev_cache.values()
            eval_batches += CLI_EPOCHS * len(dev_data.batches)
            eval_cells += CLI_EPOCHS * sum(b.mask.shape[0]
                                           for b in dev_data.batches)
        trainers.clear()
        n = steps[0]
        check(n > 0 and launches["bfvi_scan_bwd"] == 3 * n
              and launches["gtf_wgrad"] == 3 * n
              and launches["bfvi_scan_fwd"] == 3 * n + eval_batches
              and launches["poe_sample_cell"] == eval_cells,
              "grid launches %s for %d steps, %d evaluation batches and %d "
              "cell steps: expected 3 of each scan kernel a step, one "
              "forward scan an evaluation batch, the cell at each of its "
              "steps" % (launches, n, eval_batches, eval_cells))
        exp_dir = os.path.join(root, "weizmann_semisup")
        (state,) = [f for f in os.listdir(exp_dir)
                    if f.startswith("experiment_state")]
        with open(os.path.join(exp_dir, state)) as f:
            ckpts = json.load(f)["checkpoints"]
        check(len(ckpts) == n_trials
              and all(c["status"] == "TERMINATED" for c in ckpts),
              "grid trials: %s" % [c["status"] for c in ckpts])
        log("  %d trials in process, %.1f s: seconds per trial %s (first "
            "against later), %d steps, %d evaluation batches; launches %s "
            "[%s]" % (n_trials, wall, ["%.2f" % v for v in trial_s], n,
                      eval_batches, launches, card))
        t0 = time.perf_counter()
        ws.analyze(ws.parser.parse_args(argv))
        analysis_s = time.perf_counter() - t0
        for name in ("best_results.csv", "best_results_std.csv"):
            tab = table.read_csv(os.path.join(exp_dir, name))
            check(tab.columns == ["loss", "ssim", "action"] and len(tab) == 2
                  and all(np.isfinite(tab[c].tolist()).all()
                          for c in tab.columns), "%s: %s" % (name, tab))
        log("  analyze_best3: %.3f s (%.4f s a trial); best_results.csv and "
            "best_results_std.csv: two levels, finite"
            % (analysis_s, analysis_s / n_trials))

        # (c) the grid again with --resume: every trial already done.
        for fn in wrappers.values():
            fn.launches = 0
        steps[0] = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ws.run(ws.parser.parse_args(argv + ["--resume"]))
        resumed = out.getvalue().count("[resume: already done]")
        relaunched = {n: fn.launches for n, fn in wrappers.items()}
        check(resumed == n_trials and not any(relaunched.values())
              and steps[0] == 0 and len(trial_s) == n_trials,
              "--resume: %d trials already done, launches %s"
              % (resumed, relaunched))
        log("  (c) --resume: %d of %d trials already done, no launch, %.3f s"
            % (resumed, n_trials, time.perf_counter() - t0))
    finally:
        for name in ("tune", "from_args", "train_step"):
            delattr(W, name)

    # (d) --find_best on the grid's first trial.
    cfg = ckpts[0]["config"]
    save = os.path.join(ckpts[0]["logdir"], W.defaults["save_dir"])
    best = os.path.join(save, "best.pth")
    before = os.stat(best).st_mtime_ns
    flags = ["--data_dir", data, "--save_dir", save, "--method", "bfvi",
             "--seed", str(cfg["seed"]), "--epochs", str(CLI_EPOCHS),
             "--save_freq", "1", "--find_best", "--modalities",
             *cfg["modalities"], "--eval_mods", *cfg["eval_mods"],
             "--drop_mods", *cfg["drop_mods"]]
    t0 = time.perf_counter()
    best_epoch, metrics = weizmann.main(flags)
    check(best_epoch in range(1, CLI_EPOCHS + 1)
          and os.stat(best).st_mtime_ns != before
          and all(np.isfinite(metrics[k]) for k in (
              "rec_loss", "kld_loss", "mse", "ssim", "action")),
          "--find_best: epoch %s, metrics %s" % (best_epoch, metrics))
    log("  (d) --find_best on %s: best epoch %d of %d, best.pth rewritten, "
        "rec_loss %.2f, ssim %.4f, action %.3f (%.1f s)"
        % (os.path.basename(ckpts[0]["logdir"]), best_epoch, CLI_EPOCHS,
           metrics["rec_loss"], metrics["ssim"], metrics["action"],
           time.perf_counter() - t0))
    return launches


def check_experiments(tmp, card):
    """Phase 13: the experiment layer in ``tmp``/experiments, on phase
    10's spirals corpus and phase 11's Weizmann fixture. Returns the
    Weizmann grid's launches."""
    root = os.path.join(tmp, "experiments")
    os.makedirs(root)
    torch.cuda.empty_cache()
    log("  (a) the spirals suite, isolated, %d epochs a trial" % CLI_EPOCHS)
    check_spirals_suite(os.path.join(tmp, "spirals"), root, card)
    log("  (b) the Weizmann semi-supervised grid in process, levels %s x "
        "%d seeds, z = h = 256" % (", ".join(GRID_LEVELS), GRID_REPEATS))
    return check_weizmann_grid(os.path.join(tmp, "weizmann"), root, card)


# -- phase 14: data parallelism ---------------------------------------------

# MAP: the training step without noise (one particle, no prior matching).
MAP_ARGS = {"sample": False, "match_mult": 0.0, "train_particles": 1}
DP_TIMED = 3        # timed (sampled) steps of each rank, after the compared
DP_TIMEOUT = 600    # seconds a collective may wait before it fails


def dp_steps(new_trainer, inputs, targets, mask, n_data, modes, n_timed):
    """The step of each of ``modes`` ("map" or "sampled", the app's default
    step) through ``train_step`` (a rank's step under a mesh) of a fresh
    trainer from ``new_trainer()``, so that each starts from the seed's
    weights (after an Adam step the weights would carry the signs of
    gradients at rounding level), then ``n_timed`` sampled steps of the
    last one, timed on the host's clock. Returns the losses, the gradients
    of each mode's step (on the CPU) and the timed steps' ms."""
    from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path
    out = {"losses": [], "grads": [], "ms": []}
    for i, mode in enumerate(list(modes) + ["sampled"] * n_timed):
        if i < len(modes):
            trainer = new_trainer()
            base = dict(trainer.train_args)
        trainer.train_args = dict(base, **(MAP_ARGS if mode == "map"
                                           else {}))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, applied = trainer.train_step(inputs, targets, mask, 1.0, n_data)
        loss = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        check(applied and np.isfinite(loss),
              "%s step: non-finite loss or gradient" % mode)
        if i < len(modes):
            out["losses"].append(loss)
            out["grads"].append({path: p.grad.detach().cpu() for path, p in
                                 tree_leaves_with_path(trainer.params)})
        else:
            out["ms"].append(ms)
    return out


def dp_rank(mesh_spec, seed, b_dim, modes, n_timed):
    """One rank of phase 14 (in a process of ``parallel.launch``): the
    Weizmann trainer of ``seed`` at full width on this process's card as a
    rank of ``mesh_spec`` (``set_mesh``, also for one rank), its columns of
    ``synthetic_batch(seed, b_dim)``, then ``dp_steps``. Returns its
    results (rank 0's gradients, the others' None), a digest of its last
    trainer's weights, and the launches of each kernel wrapper."""
    import hashlib
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                                   parse_mesh, shard_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    n_data, n_model = parse_mesh(mesh_spec)
    mesh = (make_mesh(n_data, dev) if n_model == 1 else
            make_mesh_2d(n_data, n_model, dev, timeout=DP_TIMEOUT))
    trainers = []

    def new_trainer():
        trainers[:] = [weizmann.make_trainer(seed=seed, device=dev)]
        trainers[0].set_mesh(mesh)
        return trainers[0]

    inputs, targets, mask = synthetic_batch(seed, dev, b_dim)
    n_rows = float(mask.sum().item())
    inputs, _ = shard_batch(mesh, inputs, mask)
    targets, mask = shard_batch(mesh, targets, mask)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = dp_steps(new_trainer, inputs, targets, mask, n_rows, modes,
                   n_timed)
    out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    out["columns"] = mask.shape[1]
    digest = hashlib.sha256()
    for p in trainers[0].leaves:
        digest.update(p.detach().cpu().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    if mesh.rank:
        out["grads"] = None
    return out


def check_dp_run(what, mesh_spec, backend, seed, b_dim, modes, ref, card):
    """Phase 14's ranks of ``mesh_spec`` on cuda:0 with ``backend``: each
    mode's loss against the single process's ``ref`` within
    STEP_LOSS_RTOL, each gradient leaf within STEP_GRAD_TOL's rtol in
    relative Frobenius norm, the replicas' weights identical after the
    steps, three launches of each scan kernel a step on every rank.
    Returns the launches summed over the ranks."""
    from multimodal_dmm_tpu_torch.parallel import launch, parse_mesh
    n_data, n_model = parse_mesh(mesh_spec)
    n = n_data * n_model
    t0 = time.perf_counter()
    outs = launch(dp_rank, ["cuda:0"] * n, backend,
                  args=(mesh_spec, seed, b_dim, modes, DP_TIMED),
                  timeout=DP_TIMEOUT)
    log("  %s: %d rank(s), %s, %d columns a rank, %.1f s with the "
        "processes' start" % (what, n, backend, outs[0]["columns"],
                              time.perf_counter() - t0))
    n_steps = len(modes) + DP_TIMED
    for r, out in enumerate(outs):
        for name in SCAN_KERNELS:
            check(out["launches"][name] == 3 * n_steps,
                  "%s rank %d: %s launched %d times in %d steps, expected 3 "
                  "a step" % (what, r, name, out["launches"][name], n_steps))
        check(out["launches"]["poe_sample_cell"] == 0,
              "%s rank %d: the cell kernel launched in training" % (what, r))
        check(out["digest"] == outs[0]["digest"],
              "%s: rank %d's weights differ from rank 0's" % (what, r))
    for i, mode in enumerate(modes):
        l_dp, l_ref = outs[0]["losses"][i], ref["losses"][i]
        diffs = grad_diffs(outs[0]["grads"][i], ref["grads"][i])
        log("  %s, %s step: loss %.6g vs %.6g single-process (rel %.2e)"
            % (what, mode, l_dp, l_ref, abs(l_dp - l_ref) / abs(l_ref)))
        log_worst("%s %s vs single process" % (what, mode), diffs, n=2)
        check(abs(l_dp - l_ref) <= STEP_LOSS_RTOL * abs(l_ref),
              "%s %s: loss %r vs %r" % (what, mode, l_dp, l_ref))
        bad = leaves_beyond(diffs, STEP_GRAD_TOL["rtol"])
        check(not bad, "%s %s: %d gradient leaves beyond %g in relative "
              "Frobenius norm: %s" % (what, mode, len(bad),
                                      STEP_GRAD_TOL["rtol"], bad))
    for r, out in enumerate(outs):
        log("  %s rank %d: sampled step median %.1f ms over %d (ranks that "
            "time-slice one card, not a scaling figure) [%s]"
            % (what, r, statistics.median(out["ms"]), len(out["ms"]), card))
    return {name: sum(o["launches"][name] for o in outs) for name in KERNELS}


def check_data_parallel(seed, card):
    """Phase 14: (a) a one-rank NCCL group, (b) two and (c) 2x2 gloo ranks,
    all on cuda:0, against the single-process steps; (d) ``apps.weizmann
    --mesh 2`` on this one-card machine. Returns the launches of (a)-(c)
    summed over the ranks."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    dev = torch.device("cuda")
    refs = {}
    for b_dim, modes in ((B_DATA, ("sampled",)), (B_DATA - 1,
                                                  ("map", "sampled"))):
        inputs, targets, mask = synthetic_batch(seed, dev, b_dim)
        refs[b_dim] = dp_steps(
            lambda: weizmann.make_trainer(seed=seed, device=dev), inputs,
            targets, mask, float(mask.sum().item()), modes, DP_TIMED)
        log("  single process, B = %d: sampled step median %.1f ms over %d "
            "[%s]" % (b_dim, statistics.median(refs[b_dim]["ms"]), DP_TIMED,
                      card))
    launches = {name: 0 for name in KERNELS}
    for what, spec, backend, b_dim, modes in (
            ("(a)", "1", "nccl", B_DATA, ("sampled",)),
            ("(b)", "2", "gloo", B_DATA - 1, ("map", "sampled")),
            ("(c)", "2x2", "gloo", B_DATA - 1, ("map", "sampled"))):
        got = check_dp_run(what, spec, backend, seed, b_dim, modes,
                           refs[b_dim], card)
        launches = {k: launches[k] + got[k] for k in launches}
    try:
        weizmann.main(["--mesh", "2", "--data_dir", "unused", "--save_dir",
                       "unused"])
    except ValueError as e:
        check("needs 2 devices but only 1 are visible" in str(e),
              "(d): unexpected error %r" % (e,))
        log("  (d) apps.weizmann --mesh 2: %s" % e)
    else:
        raise AssertionError("(d) apps.weizmann --mesh 2 did not raise")
    return launches


# -- phase 15: the GTF products in bfloat16 (bf16_gtf) ------------------------

def scan_kernel_names(fn):
    """{kernel name: device launches} of the scan kernels (either route)
    that torch.profiler saw in one call of ``fn``; None if it saw no
    device activity at all."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    names = [n + "_kernel" for n in
             list(SCAN_KERNELS) + list(BF16_KERNELS) + list(TILED_KERNELS)]
    counts = {n: 0 for n in names}
    for e in events:
        for n in names:
            # "bfvi_scan_fwd_kernel" is no substring of a bf16 variant's
            # name ("..._bf16_kernel", "..._bf16_tiled_kernel"), nor the
            # reverse; "gtf_wgrad_bf16_kernel" none of its reduction's.
            if n in e.name:
                counts[n] += 1
    return counts


def step_bf16_launches(scan, model, ks):
    """The launches of a ``bf16_gtf`` step whose three scans take K = ``ks``
    particles over V B columns: each scan's route as ``bf16_scan_plan``
    chooses it, one bf16 weight-gradient launch a backward."""
    dp, hp = scan._check_sizes(1, model.z_dim, model.h_dim, True)
    want = {n: 0 for n in all_wrappers()}
    for k in ks:
        route = scan.bf16_scan_plan(k, V_MAIN * B_DATA, dp, hp)["route"]
        for f32 in ("bfvi_scan_fwd", "bfvi_scan_bwd"):
            want[f32 + ("_bf16" if route == "cluster" else "_bf16_tiled")] += 1
        want["gtf_wgrad_bf16"] += 1
    return want


def check_bf16_step(scan, trainer, inputs, targets, mask, seed,
                    ks=(1, 25, 1), control=True):
    """Phase 15 (b) and (d) (and 16): one ``bf16_gtf`` step's loss and
    gradients on the kernels against the same step on the plain versions,
    with the same noise and deterministic cuDNN: the loss within
    BF16_GTF_LOSS_RTOL, each gradient leaf within BF16_GRAD_RTOL in
    relative Frobenius norm, and within BF16_GTF_STEP_RFRO against the
    plain backward run on the backward kernel's ReLU masks (every flip
    within ``relu_flip_bound(D, bf16=True)``); with ``control``, the same
    step in float32 on the same weights lies BF16_GTF_SEPARATION times
    farther in every transition weight that has a gradient, and the
    profiler's kernel names agree with the wrappers' counts. Every scan
    launch of the step is a bf16 variant on the route of its plan (the
    scans' K: ``ks``). Returns the step's launches."""
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.backends.cudnn.deterministic = True
    (l_k, g_k), rows = with_kernel_rows(scan, lambda: step_grads(
        trainer, inputs, targets, mask, False, seed))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    want = step_bf16_launches(scan, trainer.model, ks)
    check(launches == want, "bf16_gtf step launches %s, expected %s"
          % (launches, want))
    margins, launch = [], iter(rows)

    def on_masks(res, cots, min_std, bf16=False, pack=None):
        check(bf16, "the bf16_gtf step ran the float32 backward")
        outs, m = scan.bfvi_scan_bwd_ref_on_masks(res, cots, min_std,
                                                  next(launch), bf16)
        margins.append(m)
        return outs
    bwd_kernel, scan.bfvi_scan_bwd_cuda = scan.bfvi_scan_bwd_cuda, on_masks
    try:
        l_km, g_km = step_grads(trainer, inputs, targets, mask, False, seed)
    finally:
        scan.bfvi_scan_bwd_cuda = bwd_kernel
    l_p, g_p = step_grads(trainer, inputs, targets, mask, True, seed)
    if control:
        trainer.model.bf16_gtf = False
        try:
            l_f, g_f = step_grads(trainer, inputs, targets, mask, False, seed)
        finally:
            trainer.model.bf16_gtf = True
    torch.backends.cudnn.deterministic = False
    log("  loss: kernels %.6f, forward kernel + plain backward on the "
        "kernel's ReLU masks %.6f, plain %.6f (relative difference %.3g)"
        % (l_k, l_km, l_p, (l_k - l_p) / abs(l_p)))
    check(np.isfinite(l_k), "bf16_gtf step: non-finite loss")
    check(l_k == l_km, "the bf16 forward kernel gave different losses for "
          "one input")
    check(abs(l_k - l_p) <= BF16_GTF_LOSS_RTOL * abs(l_p),
          "bf16_gtf step loss: kernels %r vs plain %r" % (l_k, l_p))
    d = trainer.model.z_dim
    flips = [check_flips(scan, m, d, "bf16_gtf step, backward launch %d" % i,
                         bf16=True) for i, m in enumerate(margins)]
    for what, g_b, lim in (
            ("backward kernel vs plain backward on its masks", g_km,
             BF16_GTF_STEP_RFRO), ("kernels vs plain", g_p, BF16_GRAD_RTOL)):
        diffs = grad_diffs(g_k, g_b, BF16_TOL)
        log_worst(what, diffs, n=2)
        bad = leaves_beyond(diffs, lim)
        log("  %s: largest relative Frobenius error %.3g over %d leaves "
            "(bound %g); %d elements beyond BF16_TOL (normalised)"
            % (what, max(x["fro"] for x in diffs.values()), len(diffs),
               lim, sum(x["bad"] for x in diffs.values())))
        check(not bad, "bf16_gtf step, %s: %d leaves beyond %g in relative "
              "Frobenius norm: %s" % (what, len(bad), lim, bad))
    log("  backward kernel: %d ReLU flips in the GTF first layers against the "
        "plain backward (largest exact margin %.3g of the bound %.3g)"
        % (sum(n for n, _ in flips), max((w for _, w in flips), default=0.0),
           scan.relu_flip_bound(d, True)))
    if not control:
        return launches
    # The transition weights whose gradient is more than rounding noise.
    on_masks = grad_diffs(g_k, g_km, BF16_TOL)
    ratio = {p: x["fro"] / max(on_masks[p]["fro"], 1e-7)
             for p, x in grad_diffs(g_f, g_km).items()
             if p[0] == "trans" and p[-1] == "w" and not x["noise"]}
    least = min(ratio, key=ratio.get)
    log("  control, the float32 step on the same weights against the plain "
        "bf16 backward on the kernel's masks: loss %.6f (relative "
        "difference %.3g); every transition weight at least %.1fx farther "
        "than the kernels' (%s: %.3g)"
        % (l_f, (l_f - l_km) / abs(l_km), ratio[least],
           "/".join(map(str, least)),
           ratio[least] * max(on_masks[least]["fro"], 1e-7)))
    check(ratio[least] >= BF16_GTF_SEPARATION, "the float32 step's %s is "
          "only %.1fx farther from the bf16 plain backward than the bf16 "
          "kernels'" % ("/".join(map(str, least)), ratio[least]))

    def one_step():
        for p in trainer.leaves:
            p.grad = None
        loss, _ = trainer.model.step(
            trainer.params, trainer.state, inputs, mask, 1.0,
            trainer.rec_mults, torch.Generator(device=mask.device)
            .manual_seed(seed), targets=targets, train=True)
        loss.backward()
    names = scan_kernel_names(one_step)
    for p in trainer.leaves:
        p.grad = None
    log("  (d) torch.profiler, one bf16_gtf step's scan kernels: %s" % names)
    check(names is not None, "torch.profiler saw no device activity")
    check(all(v == want[n[:-len("_kernel")]] for n, v in names.items()),
          "bf16_gtf step: the profiler's scan launches %s, expected %s"
          % (names, want))
    return launches


def run_bf16_cli(seed, card):
    """Phase 15 (e): ``apps.weizmann.main`` with ``--model_args '{bf16_gtf:
    true}'`` in a temporary directory, on a ``gen_synthetic`` fixture: one
    epoch with an evaluation, then ``--load last.pth --evaluate
    --save_args '{skip: true}'``. Returns the training run's launches."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.chdir(tmp)  # param_hist.tsv is written there
        try:
            data, save = os.path.join(tmp, "data"), os.path.join(tmp, "save")
            gen_synthetic(data)
            flags = ["--data_dir", data, "--save_dir", save, "--method",
                     "bfvi", "--model_args", "{bf16_gtf: true}", "--seed",
                     str(seed)]
            wrappers = all_wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            hist = weizmann.main(flags + ["--epochs", "1", "--eval_freq",
                                          "1", "--save_freq", "1"])
            wall = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in wrappers.items()}
            check(all(np.isfinite(hist["epoch_loss"]))
                  and np.isfinite(hist["eval"][0]["rec_loss"]),
                  "bf16_gtf command line: loss %s, evaluation %s"
                  % (hist["epoch_loss"], hist["eval"]))
            n_bwd = launches["bfvi_scan_bwd_bf16"]
            check(n_bwd > 0 and n_bwd % 3 == 0
                  and launches["gtf_wgrad_bf16"] == n_bwd
                  and launches["bfvi_scan_fwd_bf16"] == n_bwd + 1
                  and launches["poe_sample_cell"] > 0
                  and not any(launches[n] for n in SCAN_KERNELS),
                  "bf16_gtf command-line run launches %s: expected 3 of "
                  "each bf16 variant per step, one bf16 forward scan and "
                  "the cell per evaluation, no float32 scan" % launches)
            for fn in wrappers.values():
                fn.launches = 0
            evals = weizmann.main(flags + [
                "--load", os.path.join(save, "last.pth"), "--evaluate",
                "--save_args", "{skip: true}"])
            e_launches = {n: fn.launches for n, fn in wrappers.items()}
            check(e_launches["bfvi_scan_fwd_bf16"] > 0
                  and not any(e_launches[n] for n in SCAN_KERNELS),
                  "--evaluate launches %s" % e_launches)
            for i, name in enumerate(("train", "test")):
                a = dict(evals[i])
                check(np.isfinite(a["rec_loss"]) and 0 <= a["ssim"] <= 1,
                      "--load --evaluate %s metrics %s" % (name, a))
            log("  main(%s --epochs 1): %d steps, epoch %.2f s, evaluation "
                "%.2f s, loss %.1f, eval rec_loss %.1f (%.1f s of command); "
                "launches %s; --load last.pth --evaluate: test rec_loss %.1f, "
                "ssim %.4f, launches %s [%s]"
                % (" ".join(flags[4:]), n_bwd // 3, hist["epoch_s"][0],
                   hist["eval_s"][0], hist["epoch_loss"][0],
                   hist["eval"][0]["rec_loss"], wall, launches,
                   evals[1]["rec_loss"], evals[1]["ssim"], e_launches, card))
        finally:
            os.chdir(cwd)
    return launches


def check_bf16_gtf(scan, seed, dev, sp_gtf, card):
    """Phase 15: ``bf16_gtf`` (a) each bf16 scan kernel against its bf16
    plain version at the Weizmann step's shapes and at the spirals shapes;
    (b) the Weizmann BFVI step on the kernels against the plain versions,
    timed beside the float32 step and the bench configuration with
    ``bf16_gtf``; (c) the evaluation; (d) the profiler's kernel names of
    (b); (e) the command line. Returns (the Weizmann records of (a), the
    launches of (b), (c) and (e))."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    t0 = time.perf_counter()
    trainer = weizmann.make_trainer(seed=seed, device=dev,
                                    model_args={"bf16_gtf": True})
    gtf = {n: {k: v.detach() for k, v in p.items()}
           for n, p in trainer.params["trans"]["bwd"].items()}
    log("  (a) the bf16 library's kernels, nvcc -Xptxas -v:")
    for line in ptxas_lines("bfvi_scan_bf16"):
        log("    " + line)
    log("  (a) the bf16 variants against their bf16 plain versions, "
        "Weizmann (T = %d, %d columns, D = H = %d)"
        % (T_MAIN, V_MAIN * B_DATA, Z_DIM))
    rec = check_kernels(scan, gtf, dev, smooth_shape=None, bf16=True)
    log("  (a) the same at the spirals shapes (T = %d, %d columns, z = 5 "
        "and h = 20 run as 16 and 32)" % (SP_T, 3 * SP_B))
    sp_rec = check_kernels(scan, sp_gtf, dev, SP_T, 3 * SP_B,
                           ((2, 1), (2, 25), (4, 1)), None, seed=700,
                           bf16=True)
    for name in ("bfvi_scan_fwd", "bfvi_scan_bwd"):
        log("  (a) %s_bf16, the three launches of a step: Weizmann %.3f ms "
            "(f32 twin %.3f), spirals shapes %.3f ms (f32 twin %.3f) [%s]"
            % (name, rec[name]["ms"], rec[name]["f32_twin_ms"],
               sp_rec[name]["ms"], sp_rec[name]["f32_twin_ms"], card))
    log("  (a) %.1f s" % (time.perf_counter() - t0))

    log("  (b) the bf16_gtf step, kernels vs plain versions (T = B = %d)"
        % T_MAIN)
    inputs, targets, mask = synthetic_batch(seed, dev)
    step_launches = check_bf16_step(scan, trainer, inputs, targets, mask,
                                    seed)
    f32 = weizmann.make_trainer(seed=seed, device=dev)
    perms = f32.model.native_input_perms()
    bench_kw = dict(ragged_mode_scans=True, native_mods=tuple(perms))
    bench = weizmann.make_trainer(
        seed=seed, device=dev, model_args={"bf16": True, "bf16_gtf": True},
        train_args=bench_kw)
    configs = {
        "two_scan_f32": (f32, inputs, targets),
        "two_scan_bf16_gtf": (trainer, inputs, targets),
        "bench_bf16_gtf": (bench, native_batch(inputs, perms),
                           native_batch(targets, perms)),
    }
    n_data = float(mask.sum().item())
    times = {name: [] for name in configs}
    for name, (tr, x, y) in configs.items():
        time_steps(tr, x, y, mask, n_data, 2)  # warm-up
    for name in list(configs) + list(configs)[::-1]:
        tr, x, y = configs[name]
        times[name] += time_steps(tr, x, y, mask, n_data, N_BENCH // 2)
    for name, v in times.items():
        tr, x, y = configs[name]
        busy, n_kern = device_profile(
            lambda: tr.train_step(x, y, mask, 1.0, n_data), 3)
        dev_note = ("device time not measured" if busy is None else
                    "device busy %.2f ms, %d kernels a step" % (busy, n_kern))
        ms = statistics.median(v)
        log("  %-18s median %.2f ms per step over %d steps (blocks in "
            "turns), %.1f seqs/s; %s (torch.profiler, 3 steps) [%s]"
            % (name, ms, len(v), B_DATA / (ms / 1e3), dev_note, card))
    log("  (b) and (d) %.1f s" % (time.perf_counter() - t0))

    log("  (c) the Weizmann evaluation with bf16_gtf, kernels vs plain "
        "versions [%s]" % card)
    eval_launches, _, _, _ = check_evaluation(trainer, seed, 3, bf16=True)

    log("  (e) the command line, --model_args '{bf16_gtf: true}'")
    cli_launches = run_bf16_cli(seed, card)
    log("  phase 15: %.1f s" % (time.perf_counter() - t0))
    return rec, {"15b": step_launches, "15c": eval_launches,
                 "15e": cli_launches}


# -- phase 16: every width and particle count the reference takes ------------

REPAIR_K = 50      # train_particles of phase 16's steps
WIDE_ZH = 768      # z = h of its wide bf16_gtf step
# (K, columns, D = H, bf16) of phase 16 (a)'s kernel checks at T = 25: the
# float32 kernels past 32 particles, the bf16 cluster route at K = 50 (one
# column a cluster) and the tiled route at K = 100 and at D = H = 768.
REPAIR_KERNELS = ((REPAIR_K, V_MAIN * B_DATA, Z_DIM, False),
                  (256, B_DATA, Z_DIM, False),
                  (REPAIR_K, V_MAIN * B_DATA, Z_DIM, True),
                  (100, B_DATA, Z_DIM, True),
                  (25, V_MAIN * B_DATA, WIDE_ZH, True))


def check_repaired(scan, seed, dev, gtf, card):
    """Phase 16: the widths and particle counts that the scan kernels took
    only up to K = 32 (float32) and within a cluster's shared memory
    (bf16). (a) Each kernel against its plain version (phase 3's and 15
    (a)'s checks, one launch each, M = 3) at REPAIR_KERNELS; (b) one
    Weizmann step at z = h = 256 with ``train_particles: 50`` in float32
    (phase 4's checks) and with ``bf16_gtf`` (phase 15 (b)'s, on the
    backward kernel's masks); (c) one ``bf16_gtf`` step at z = h = 768, K =
    25, on the tiled route, against the plain backward on its masks; each
    route's launches. Returns (the records of (a) by (K, D, bf16), the
    launches of each step's kernel run, "16b_f32", "16b_bf16" and "16c",
    each counted from 0 just before that run and read just after it)."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    t0 = time.perf_counter()
    recs = {}
    wide = weizmann.make_trainer(
        seed=seed, device=dev, train_args={"train_particles": 25},
        model_args={"bf16_gtf": True, "z_dim": WIDE_ZH, "h_dim": WIDE_ZH})
    wide_gtf = {n: {k: v.detach() for k, v in p.items()}
                for n, p in wide.params["trans"]["bwd"].items()}
    for i, (k, cols, zh, bf16) in enumerate(REPAIR_KERNELS):
        dp, hp = scan._check_sizes(k, zh, zh, bf16)
        route = (scan.bf16_scan_plan(k, cols, dp, hp)["route"] if bf16
                 else "f32")
        log("  (a) K = %d, %d columns, z = h = %d, %s route" % (k, cols, zh,
                                                               route))
        recs[(k, zh, bf16)] = check_kernels(
            scan, wide_gtf if zh == WIDE_ZH else gtf, dev, T_MAIN, cols,
            ((3, k),), None, seed=900 + 10 * i, bf16=bf16)
    log("  (a) %.1f s" % (time.perf_counter() - t0))

    inputs, targets, mask = synthetic_batch(seed, dev)
    wrappers = all_wrappers()

    def counted(what, fn):
        """The launches of the kernel run of ``fn``'s step (``fn`` returns
        them, read just after that run), the counts set to 0 before it."""
        for w in wrappers.values():
            w.launches = 0
        got = fn()
        log("  %s: launches by route %s" % (what, {n: v for n, v in
                                                  got.items() if v}))
        return got
    log("  (b) the Weizmann step at K = %d, float32, kernels vs plain "
        "versions" % REPAIR_K)
    f32 = weizmann.make_trainer(seed=seed, device=dev,
                                train_args={"train_particles": REPAIR_K})
    runs = {"16b_f32": counted("(b) float32", lambda: check_step_against_plain(
        scan, f32, inputs, targets, mask, seed))}
    want = {n: 3 if n in SCAN_KERNELS else 0 for n in wrappers}
    check(runs["16b_f32"] == want, "the float32 step at K = %d launched %s, "
          "expected %s" % (REPAIR_K, runs["16b_f32"], want))
    log("  (b) the same with bf16_gtf")
    b16 = weizmann.make_trainer(seed=seed, device=dev,
                                model_args={"bf16_gtf": True},
                                train_args={"train_particles": REPAIR_K})
    runs["16b_bf16"] = counted("(b) bf16_gtf", lambda: check_bf16_step(
        scan, b16, inputs, targets, mask, seed, ks=(1, REPAIR_K, 1),
        control=False))
    log("  (c) the bf16_gtf step at z = h = %d, K = 25" % WIDE_ZH)
    runs["16c"] = counted("(c) bf16_gtf, z = h = %d" % WIDE_ZH,
                          lambda: check_bf16_step(scan, wide, inputs, targets,
                                                  mask, seed, control=False))
    for name in list(SCAN_KERNELS) + list(BF16_KERNELS) + list(TILED_KERNELS):
        check(any(r[name] for r in runs.values()),
              "phase 16's steps launched %s no time" % name)
    for name in TILED_KERNELS:
        check(runs["16c"][name] > 0, "the step at z = h = %d launched %s no "
              "time" % (WIDE_ZH, name))
    log("  phase 16: launches %s (%.1f s) [%s]"
        % (runs, time.perf_counter() - t0, card))
    return recs, runs


# -- phase 17: results export and evaluation across ranks ------------------

# Rows of a frame that the export's labels cannot reach (text at y = 10
# and y = 60, scale 0.4), where the luma is compared.
AVI_ROWS = slice(16, 48)
# The mean luma levels that a frame's round trip through the AVI moves:
# fourcc 0 stores raw YUV 4:2:0 through FFmpeg (about 2 levels; another
# frame lies tens of levels away).
AVI_LUMA_TOL = 4.0
# Phase 17 (b): (data path, eval batch size, --method) of each
# evaluation; 25 columns (10 sequences and 15 ghost columns) the data axis
# of 2 does not divide, so every rank computes the whole batch; 10 it
# divides. "bfvi" filters with 200 particles (the cell), None is MAP (the
# forward scan alone).
MESH_EVALS = (("device", 25, "bfvi"), ("device", 10, "bfvi"),
              ("host", 25, "bfvi"), ("host", 10, "bfvi"),
              ("device", 10, None))
MESH_EVAL_TIMEOUT = 600


def renderers():
    """{renderer: whether it is installed} (``find_spec``, nothing
    imported), each missing one printed on a line of its own."""
    import importlib.util
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("matplotlib", "cv2")}
    for name, what in (("matplotlib", "visualize"), ("cv2",
                                                     "save_results")):
        if not found[name]:
            log("%s: %s not installed on this host" % (what, name))
    return found


def read_avi(path):
    """The frames of the AVI at ``path`` (BGR uint8)."""
    import cv2
    video = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = video.read()
        if not ok:
            break
        frames.append(frame)
    video.release()
    return frames


def check_avi(path, results):
    """The AVI of one eval set: a frame for each step of each sequence,
    3 x 64 wide, each frame's third part the reconstruction after the
    export's uint8 conversion, compared in luma off the label rows
    (``AVI_LUMA_TOL``). Returns the largest mean error."""
    import cv2
    frames = read_avi(path)
    recon = np.concatenate([v[:, 0] for v in results["recon"]["video"]])
    check(len(frames) == len(recon), "%s: %d frames for %d steps"
          % (path, len(frames), len(recon)))
    worst = 0.0
    for i, (frame, rec) in enumerate(zip(frames, recon)):
        check(frame.shape == (64, 3 * 64, 3), "%s frame %d: shape %s"
              % (path, i, frame.shape))
        exp = cv2.cvtColor((np.clip(rec, 0, 1) * 255).astype("uint8")
                           .transpose(1, 2, 0), cv2.COLOR_RGB2BGR)
        luma = [cv2.cvtColor(x, cv2.COLOR_BGR2GRAY)[AVI_ROWS].astype(float)
                for x in (frame[:, 128:], exp)]
        err = float(np.abs(luma[0] - luma[1]).mean())
        check(err <= AVI_LUMA_TOL, "%s frame %d: the reconstruction's luma "
              "is %.2f levels away (tolerance %g)" % (path, i, err,
                                                      AVI_LUMA_TOL))
        worst = max(worst, err)
    return worst


def eval_batches_tmax(results, batch_size):
    """The longest sequence of each eval batch of ``batch_size`` (the
    loader's batching, in input order) from a collect path's results."""
    lengths = [len(v) for v in results["targets"]["video"]]
    return [max(lengths[i:i + batch_size])
            for i in range(0, len(lengths), batch_size)]


def check_results_export(card, save, flags):
    """Phase 17 (a): ``apps.weizmann``'s command line with ``--load
    last.pth --evaluate --visualize`` on phase 8's fixture and checkpoint,
    with the default save_args, through a ``WeizmannTrainer`` that keeps
    each set's results: the collect path's launches (a forward scan a
    batch and the cell at each step of it), then what the installed
    renderers wrote. Returns the launches."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    found = renderers()

    class Kept(weizmann.WeizmannTrainer):
        """Keeps each set's results; exports them where cv2 is."""
        results = {}

        def save_results(self, results, args):
            Kept.results[args.eval_set] = results
            if found["cv2"]:
                super().save_results(results, args)

    argv = flags + ["--load", os.path.join(save, "last.pth"), "--evaluate"]
    if found["matplotlib"]:
        argv.append("--visualize")
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    metrics = Kept.main(argv)
    secs = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    check(sorted(Kept.results) == ["test", "train"],
          "results of %s" % sorted(Kept.results))
    t_maxes = []
    for name, m in zip(("train", "test"), metrics):
        check(np.isfinite(m["rec_loss"]) and 0 <= m["ssim"] <= 1,
              "(a) %s metrics %s" % (name, dict(m)))
        t_maxes += eval_batches_tmax(Kept.results[name], 25)
    want = {n: 0 for n in wrappers}
    want["bfvi_scan_fwd"] = len(t_maxes)
    want["poe_sample_cell"] = sum(t_maxes)
    check(launches == want, "(a) launches %s, expected the forward scan "
          "once a batch and the cell at each of its steps: %s"
          % (launches, want))
    log("  (a) --load last.pth --evaluate%s: %.1f s of command, %d eval "
        "batches, launches %s [%s]"
        % (" --visualize" if found["matplotlib"] else "", secs,
           len(t_maxes), {n: v for n, v in launches.items() if v}, card))
    if found["cv2"]:
        for name in ("train", "test"):
            path = os.path.join(save, name + ".avi")
            worst = check_avi(path, Kept.results[name])
            log("  (a) %s.avi: %d frames, 192 x 64, reconstruction within "
                "%.2f luma levels (mean, worst frame) [cv2 %s]"
                % (name, sum(len(v) for v in Kept.results[name]["targets"]
                             ["video"]), worst, __import__("cv2")
                   .__version__))
    if found["matplotlib"]:
        for name in ("train", "test"):
            path = os.path.join(save, name + ".pdf")
            with open(path, "rb") as f:
                check(f.read(5) == b"%PDF-", "%s is not a PDF" % path)
            log("  (a) %s.pdf written (%d bytes)" % (name,
                                                     os.path.getsize(path)))
    return launches


def run_mesh_evals(trainer, seed):
    """The evaluations of ``MESH_EVALS`` (phase 6's ten sequences, the
    200-particle filter or MAP, then MAP smoothing), each with the
    generator and numpy seeded from ``seed``, its launches counted from 0
    just before it and read just after. Returns, for each, its
    per-sequence and summed metrics (as handed to ``summarize_metrics``),
    its summary and launches."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training.loader import BatchLoader
    items = synthetic_eval_set(seed)
    recorded = []
    summarize = trainer.summarize_metrics

    def recording(metrics, n_timesteps):
        recorded.append({k: np.asarray(v, np.float64)
                         for k, v in metrics.items()})
        return summarize(metrics, n_timesteps)
    trainer.summarize_metrics = recording
    wrappers = all_wrappers()
    out = []
    for path, batch, method in MESH_EVALS:
        args = weizmann.eval_namespace(method)
        for w in wrappers.values():
            w.launches = 0
        np.random.seed(seed)
        trainer.gen.manual_seed(seed)
        _, summary = trainer.evaluate(BatchLoader(items, batch), args,
                                      collect_results=path == "host")
        out.append({"metrics": recorded[-1],
                    "summary": {k: float(v) for k, v in summary.items()},
                    "launches": {n: w.launches for n, w in wrappers.items()}})
    return out


def mesh_eval_trainer(seed, dev, ckpt_path):
    """Phase 8's model (bf16 codecs) on ``dev`` with its checkpoint."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training import checkpoint
    trainer = weizmann.make_trainer(seed=seed, device=dev,
                                    model_args={"bf16": True})
    trainer.restore(checkpoint.load_checkpoint(ckpt_path))
    return trainer


def mesh_eval_rank(mesh_spec, seed, ckpt_path):
    """One rank of phase 17 (b) (a process of ``parallel.launch`` on the
    card): the checkpoint's trainer as a rank of ``mesh_spec``, then
    ``run_mesh_evals``."""
    from multimodal_dmm_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                                   parse_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", torch.cuda.current_device())
    trainer = mesh_eval_trainer(seed, dev, ckpt_path)
    n_data, n_model = parse_mesh(mesh_spec)
    trainer.set_mesh(make_mesh(n_data, dev) if n_model == 1 else
                     make_mesh_2d(n_data, n_model, dev,
                                  timeout=MESH_EVAL_TIMEOUT))
    return run_mesh_evals(trainer, seed)


def check_mesh_eval(seed, dev, card, ckpt_path):
    """Phase 17 (b): ``run_mesh_evals`` in this process and on the gloo
    ranks of ``--mesh 2`` and ``2x2`` sharing the card: each rank's
    per-sequence and summed metrics and summaries within STEP_LOSS_RTOL of
    the single process's (accuracies: at most EVAL_LABEL_FLIPS decisions),
    and every rank launching the forward scan and the cell in every
    evaluation. Returns the launches summed over the ranks."""
    from multimodal_dmm_tpu_torch.parallel import launch, parse_mesh
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    ref = run_mesh_evals(mesh_eval_trainer(seed, dev, ckpt_path), seed)
    log("  single process: %d evaluations in %.1f s" % (len(ref),
                                                        time.perf_counter()
                                                        - t0))
    lengths = [d["length"] for d in synthetic_eval_set(seed)]
    label_atol = EVAL_LABEL_FLIPS / min(lengths)
    total = {}
    for spec in ("2", "2x2"):
        n_data, n_model = parse_mesh(spec)
        t0 = time.perf_counter()
        outs = launch(mesh_eval_rank, ["cuda:0"] * (n_data * n_model),
                      "gloo", args=(spec, seed, ckpt_path),
                      timeout=MESH_EVAL_TIMEOUT)
        secs = time.perf_counter() - t0
        worst = 0.0
        for r, out in enumerate(outs):
            for (path, batch, method), got, exp in zip(MESH_EVALS, out, ref):
                what = "--mesh %s rank %d, %s path, batch %d, %s" % (
                    spec, r, path, batch, method or "MAP")
                for n in ("bfvi_scan_fwd", "poe_sample_cell")[
                        :2 if method else 1]:
                    check(got["launches"][n] > 0, "%s: %s launched no time"
                          % (what, n))
                check(got["launches"] == exp["launches"],
                      "%s: launches %s vs the single process's %s"
                      % (what, got["launches"], exp["launches"]))
                for key, e in exp["metrics"].items():
                    g = got["metrics"][key]
                    label = key in ("action", "person")
                    diff = np.abs(g - e)
                    if label:
                        ok = diff.max() <= label_atol
                    else:
                        ok = np.all(diff <= STEP_LOSS_RTOL * np.abs(e))
                        worst = max(worst, float(np.max(
                            diff / np.maximum(np.abs(e), 1e-30))))
                    check(ok, "%s: %s %s vs %s" % (what, key, g, e))
                for key, e in exp["summary"].items():
                    g = got["summary"][key]
                    if np.isnan(e) and np.isnan(g):
                        continue  # no mask modality
                    tol = (label_atol if key.split("_")[0] in
                           ("action", "person") else STEP_LOSS_RTOL * abs(e))
                    check(abs(g - e) <= tol, "%s: summary %s %r vs %r"
                          % (what, key, g, e))
            for got in out:
                for n, v in got["launches"].items():
                    total[n] = total.get(n, 0) + v
        log("  (b) --mesh %s, %d gloo ranks on cuda:0: %d evaluations each "
            "(%s) within %.2e relative of the single process on every "
            "rank; %.1f s with the processes' start; rank 0's launches %s "
            "[%s]" % (spec, len(outs), len(MESH_EVALS),
                      ", ".join("%s/%d/%s" % e for e in MESH_EVALS), worst,
                      secs, [{n: v for n, v in o["launches"].items() if v}
                             for o in outs[0]], card))
    torch.backends.cudnn.deterministic = False
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8,
                    help="timed optimizer steps (after 2 warm-up steps)")
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of one step, one "
                    "evaluation, one bench-configuration step, one spirals "
                    "step and one VidTIMIT step here")
    args = ap.parse_args()
    check(args.steps >= 5, "--steps must be at least 5")

    # -- phase 1: the device ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.ops.cuda import _build
    from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as scan
    from multimodal_dmm_tpu_torch.ops.cuda import poe_cell as cell

    dev = torch.device("cuda")
    card = card_line()
    log("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    log("TF32 as found: matmul %s, cudnn %s; both set to False"
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: the build -------------------------------------------------
    secs = _build.build()
    log("build: %.1f s (nvcc, sm_90a, %d sources at once)"
        % (secs, len(_build.SOURCES)))
    for name in _build.SOURCES:
        for line in ptxas_lines(name):
            log("  ptxas %s:" % name, line)

    trainer = weizmann.make_trainer(seed=args.seed, device=dev)
    model = trainer.model
    gtf = {n: {k: v.detach() for k, v in p.items()}
           for n, p in trainer.params["trans"]["bwd"].items()}

    # -- phase 3: kernels against their plain versions -----------------------
    log_phase("phase 3: kernels vs plain versions [%s]" % card)
    rec = check_kernels(scan, gtf, dev)
    log("  no single PyTorch call computes a scan: its library_ms is null; "
        "the weight gradients' library_ms is four torch.mm in float32 and "
        "the four bias sums (the products that their plain version runs, "
        "one call each)")

    # -- phase 4: the training path -------------------------------------------
    log_phase("phase 4: Weizmann BFVI training step, T = B = %d, z = h = %d"
              % (T_MAIN, model.z_dim))
    inputs, targets, mask = synthetic_batch(args.seed, dev)
    n_data = float(mask.sum().item())
    # At the seed's weights, before any update, so that the comparison
    # is the same in every run.
    check_step_against_plain(scan, trainer, inputs, targets, mask,
                             args.seed)

    before = {k: v.detach().clone() for k, v in
              trainer.params["trans"]["bwd"]["gate_1"].items()}
    before["video"] = trainer.params["dec"]["video"]["deconvs"][2]["w"] \
        .detach().clone()
    n_warm, times, losses = 2, [], []
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for i in range(n_warm + args.steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, applied = trainer.train_step(inputs, targets, mask, 1.0, n_data)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        check(applied, "step %d: update skipped (non-finite gradient)" % i)
        check(np.isfinite(losses[-1]), "step %d: non-finite loss" % i)
        if i >= n_warm:
            times.append(start.elapsed_time(end))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_steps = n_warm + args.steps
    log("  losses / n_data: %s" % ", ".join("%.2f" % (v / n_data)
                                            for v in losses))
    log("  launches over %d steps: %s" % (n_steps, launches))
    for name in SCAN_KERNELS:
        check(launches[name] == 3 * n_steps, "%s launched %d times in %d "
              "steps, expected 3 per step" % (name, launches[name], n_steps))
    check(launches["poe_sample_cell"] == 0,
          "the cell kernel launched during training")
    changed = [not torch.equal(v, trainer.params["trans"]["bwd"]["gate_1"]
                               [k]) for k, v in before.items()
               if k != "video"]
    changed.append(not torch.equal(
        before["video"], trainer.params["dec"]["video"]["deconvs"][2]["w"]))
    check(all(changed), "parameters did not change")
    ms = statistics.median(times)
    log("  step: median %.2f ms over %d steps, %.1f seqs/s [%s]"
        % (ms, len(times), B_DATA / (ms / 1e3), card))
    log("  peak device memory: %.2f GB"
        % (torch.cuda.max_memory_allocated() / 1e9))

    if args.profile:
        from torch.profiler import profile, ProfilerActivity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(inputs, targets, mask, 1.0, n_data)
            torch.cuda.synchronize()
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        with open(args.profile, "w") as f:
            f.write("%s\none training step\n" % card)
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        log("  profile written to %s" % args.profile)

    # -- phase 5: the cell kernel against its plain version -------------------
    log_phase("phase 5: poe_sample_cell vs its plain version [%s]" % card)
    cell_rec = check_cell(cell, dev)
    log("  no single PyTorch call computes the cell: library_ms is null")

    # -- phase 6: the evaluation path -----------------------------------------
    log_phase("phase 6: Weizmann BFVI evaluation on the phase-4 weights [%s]"
              % card)
    eval_launches, eval_ms, loader, eval_args = check_evaluation(
        trainer, args.seed, N_EVALS)
    if args.profile:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.evaluate(loader, eval_args, collect_results=False)
            torch.cuda.synchronize()
        with open(args.profile, "a") as f:
            f.write("\none evaluation (%.2f ms median without the "
                    "profiler)\n" % eval_ms)
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        log("  evaluation profile appended to %s" % args.profile)

    # -- phase 7: the bench configuration's step -----------------------------
    log_phase("phase 7: the bench configuration's step at full width [%s]"
              % card)
    bench_launches, _ = check_bench_step(scan, args.seed, targets, card,
                                         profile_path=args.profile)

    # -- phase 8: the command line -------------------------------------------
    log_phase("phase 8: the Weizmann command line, bf16 ragged, %d epochs "
              "[%s]" % (CLI_EPOCHS, card))
    # Phase 17 evaluates this run's checkpoint: the directory lasts until
    # then.
    cli_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    cli_launches, _ = run_cli(args.seed, card, cli_dir.name)

    profile = os.path.abspath(args.profile) if args.profile else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)  # param_hist.tsv is written there
        try:
            # -- phase 9: the kernels at the spirals shapes -------------------
            log_phase("phase 9: the kernels at the spirals shapes (T = %d, "
                      "B = %d, z = 5, h = 20) vs their plain versions [%s]"
                      % (SP_T, SP_B, card))
            sp_trainer, sp_batch, sp_rec, sp_cell = check_spirals_kernels(
                scan, cell, args.seed, dev)
            sp_gtf = {n: {k: v.detach() for k, v in p.items()} for n, p in
                      sp_trainer.params["trans"]["bwd"].items()}

            # -- phase 10: spirals BFVI at full width -------------------------
            log_phase("phase 10: spirals BFVI at full width, step and "
                      "command line [%s]" % card)
            sp_launches, _ = check_spirals_bfvi(
                scan, sp_trainer, sp_batch, args.seed, tmp, card,
                profile_path=profile)

            # -- phase 11: the baselines --------------------------------------
            log_phase("phase 11: the DKS and VRNN baselines on spirals, "
                      "card vs CPU, and Weizmann f-mask [%s]" % card)
            check_baselines(args.seed, dev, sp_batch, tmp, card)

            # -- phase 12: the VidTIMIT app -----------------------------------
            log_phase("phase 12: VidTIMIT at full width, kernels, step and "
                      "command line [%s]" % card)
            vt_rec, vt_cell, vt_launches = check_vidtimit(
                scan, cell, args.seed, dev, tmp, card, profile_path=profile)

            # -- phase 13: the experiment layer -------------------------------
            log_phase("phase 13: the experiment layer: the spirals suite "
                      "isolated, a Weizmann grid in process [%s]" % card)
            exp_launches = check_experiments(tmp, card)
        finally:
            os.chdir(cwd)

    # -- phase 14: data parallelism -------------------------------------------
    log_phase("phase 14: data parallelism, Weizmann at full width: one NCCL "
              "rank, 2 and 2x2 gloo ranks sharing the card [%s]" % card)
    dp_launches = check_data_parallel(args.seed, card)

    # -- phase 15: the GTF products in bfloat16 -------------------------------
    log_phase("phase 15: bf16_gtf, the scan kernels' bfloat16 variants, "
              "Weizmann at full width [%s]" % card)
    bf16_rec, bf16_launches = check_bf16_gtf(scan, args.seed, dev, sp_gtf,
                                             card)

    # -- phase 16: every width and particle count --------------------------
    log_phase("phase 16: the scans past 32 particles and at wide bf16_gtf "
              "transitions, kernels and steps [%s]" % card)
    repair_rec, repair_launches = check_repaired(scan, args.seed, dev, gtf,
                                                 card)

    # -- phase 17: results export and evaluation across ranks -------------
    log_phase("phase 17: results export from the command line on phase 8's "
              "checkpoint; evaluation on 2 and 2x2 gloo ranks sharing the "
              "card [%s]" % card)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(cli_dir.name)  # param_hist.tsv is written there
    try:
        export_launches = check_results_export(
            card, os.path.join(cli_dir.name, "save"),
            cli_flags(cli_dir.name, args.seed))
    finally:
        os.chdir(cwd)
    mesh_launches = check_mesh_eval(
        args.seed, dev, card, os.path.join(cli_dir.name, "save", "last.pth"))
    cli_dir.cleanup()
    p17 = {n: export_launches[n] + mesh_launches[n] for n in export_launches}
    log("  phase 17: %.1f s; launches %s" % (
        time.perf_counter() - t0, {n: v for n, v in p17.items() if v}))

    # -- summary --------------------------------------------------------------
    log(card)
    rec["poe_sample_cell"] = cell_rec
    sp_rec["poe_sample_cell"] = sp_cell
    vt_rec["poe_sample_cell"] = vt_cell
    by_phase = {"4": launches, "6": eval_launches, "7": bench_launches,
                "8": cli_launches, "10": sp_launches, "12": vt_launches,
                "13": exp_launches, "14": dp_launches,
                "16b": repair_launches["16b_f32"], "17": p17}
    kernels = []
    for rows, suffix, main_path in ((rec, "", cli_launches),
                                    (sp_rec, " (spirals)", sp_launches),
                                    (vt_rec, " (vidtimit)", vt_launches)):
        for name, (source, replaces) in KERNELS.items():
            r = rows[name]
            if name in SCAN_KERNELS:
                by_what = max(r["bound_ms"], key=r["bound_ms"].get)
                bms = sum(r["bound_ms"].values())
            else:
                by_what, bms = r["bound_by"], r["bound_ms"]
            kernels.append({
                "name": name + suffix, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": main_path[name],
                "launches_by_phase": {k: v[name]
                                      for k, v in by_phase.items()},
                "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": bms, "bound_by": by_what,
                "library_ms": r.get("library_ms")})
            if name in SCAN_KERNELS:
                kernels[-1]["bound_f32_ms"] = r["bound_f32_ms"]
    # The bf16 variants: times and bounds of phase 15 (a) at the Weizmann
    # step's shapes (one bf16 pass a product), launches of its command line
    # (e), of its step (b) and evaluation (c).
    # The tiled route's rows: phase 16 (a) at z = h = 768, K = 25 (one
    # launch), launches of phase 16 (c)'s step.
    bf16_launches["16b"] = repair_launches["16b_bf16"]
    bf16_launches["16c"] = repair_launches["16c"]
    bf16_launches["17"] = p17
    wide = repair_rec[(25, WIDE_ZH, True)]
    for name, f32_name, r, src in (
            [(n, f, bf16_rec[f], WGRAD_BF16_SRC if f == "gtf_wgrad"
              else BF16_SCAN_SRC) for n, f in BF16_KERNELS.items()]
            + [(n, f, wide[f], TILED_SRC) for n, f in TILED_KERNELS.items()]):
        tiled = name in TILED_KERNELS
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": KERNELS[f32_name][1],
            "launches": bf16_launches["16c" if tiled else "15e"][name],
            "launches_by_phase": {k: v[name]
                                  for k, v in bf16_launches.items()},
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": sum(r["bound_ms"].values()),
            "bound_by": max(r["bound_ms"], key=r["bound_ms"].get),
            "library_ms": r.get("library_ms"),
            "bound_f32_ms": r["bound_f32_ms"]})
        if "f32_twin_ms" in r:
            kernels[-1]["f32_twin_ms"] = r["f32_twin_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
