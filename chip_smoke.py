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
   of it must agree bit for bit; the forward kernel also at the
   evaluation's smoothing shape (T = 56, B = 25, (M, K) = (5, 1)), a row
   of its own;
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
   the launch counts and the median ms per call.

Any failed check raises, so the script exits non-zero before its last
line. The line before the last is a JSON object with one entry per
kernel (for the scan kernels ``ms``, ``plain_ms`` and ``bound_ms`` are
sums over the training step's three launches and ``launches`` counts the
training steps' launches; ``bound_ms`` is the bound of the route the
kernels take and ``bound_f32_ms`` that of float32 outside the tensor
cores; for the cell they are per launch at (3, 200, 25, 256) and
``launches`` counts one evaluation's); the last is ``{"ok": true,
"device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T_MAIN, B_DATA, V_MAIN, Z_DIM = 25, 25, 4, 256
SCAN_SHAPES = ((3, 1), (3, 25), (5, 1))  # (M, K) of the step's 3 passes
SMOOTH_SHAPE = (56, 25, 5, 1)  # (T, B, M, K) of the evaluation's smoothing
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 tensor cores, dense
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
CELL_SHAPES = ((3, 200), (5, 1))  # (M, K) at B = 25, D = 256
N_EVAL_SEQS = 10
N_EVALS = 10                # timed evaluations, after one warm-up call
FWD_TOL = dict(rtol=5e-4, atol=5e-5)
BWD_TOL = dict(rtol=1e-3, atol=1e-3)     # on max-abs-normalised gradients
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)  # on max-abs-normalised grads
CELL_TOL = 1e-5             # rtol = atol; 1e-4 with the inverse expert
EVAL_RTOL = 1e-4            # summed losses, MSE and SSIM (PERF.md)
EVAL_LABEL_FLIPS = 2        # label decisions that may flip (PERF.md)


def log(*a):
    print(*a, flush=True)


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


def scan_inputs(n_exp, k, dev, seed, t_max=T_MAIN, b_dim=V_MAIN * B_DATA):
    """Inputs shaped like one pass of the training step (by default: V*B =
    100 columns), 10 % of expert cells masked; the 5-expert case carries
    the smoothing pass's filter prior and inverse global prior."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (t_max, n_exp, b_dim, Z_DIM)
    obs_mean = torch.randn(shape, generator=gen, device=dev)
    obs_std = 0.1 + torch.rand(shape, generator=gen, device=dev)
    obs_mask = (torch.rand(shape[:3], generator=gen, device=dev)
                > 0.1).float()
    glb_mean = torch.zeros(shape[2:], device=dev)
    glb_std = torch.full(shape[2:], 1.001, device=dev)
    if n_exp == 5:
        obs_std[:, 3] = 0.9 * glb_std      # filter prior
        obs_mean[:, 4] = glb_mean          # inverse global prior
        obs_std[:, 4] = -glb_std
        obs_mask[:, 3:] = 1.0
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


def check_fwd(scan, x, gtf, eps, what):
    """The forward kernel against its plain version on one input; returns
    (plain outputs, largest absolute error)."""
    got = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3)
    exp = scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, e in zip(("prior_mean", "prior_std", "infer_mean",
                           "infer_std", "samples", "z_traj"), got, exp):
        check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
        a = (g - e).abs().max().item()
        err = max(err, a)
        check(torch.allclose(g, e, **FWD_TOL), "forward kernel %s disagrees "
              "at %s: max abs err %.3g" % (name, what, a))
    return exp, err


def with_kernel_rows(scan, fn):
    """``fn()``, and the xs rows that each backward kernel launch in it
    wrote, in launch order (their h1 and hn hold its ReLU masks)."""
    scan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        out = fn()
    finally:
        scan.bfvi_scan_bwd_cuda.rows = None
    return out, rows


def check_flips(scan, margins, d, what):
    """Every unit where the backward kernel's ReLU mask differs from the
    plain backward's has its exact pre-activation within
    ``relu_flip_bound(D)`` of 0. Returns (flips, largest margin)."""
    bound = scan.relu_flip_bound(d)
    n = sum(m.numel() for m in margins.values())
    worst = max((m.max().item() for m in margins.values() if m.numel()),
                default=0.0)
    check(worst <= bound, "%s: a ReLU flip between the backward kernel and "
          "the plain backward at margin %.3g, beyond the rounding bound %.3g"
          % (what, worst, bound))
    return n, worst


def bwd_pairs(scan, out_a, out_b):
    """(name, a, b) for each output of two backward runs."""
    pairs = list(zip(("d_obs_mean", "d_obs_std", "d_glb_mean",
                      "d_glb_std"), out_a[:4], out_b[:4]))
    return pairs + [(n + "." + kk, out_a[4][n][kk], out_b[4][n][kk])
                    for n in scan.GTF_LAYERS for kk in ("w", "b")]


def check_kernels(scan, gtf, dev):
    """Phase 3: every kernel against its plain version at the main
    path's shapes; returns per-kernel records."""
    rec = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_f32_ms=0.0,
                      bound_ms={"operations": 0.0, "bytes": 0.0})
           for name in SCAN_KERNELS}
    for i, (n_exp, k) in enumerate(SCAN_SHAPES):
        x, eps, cots = scan_inputs(n_exp, k, dev, seed=100 + i)
        what = "(M, K) = (%d, %d)" % (n_exp, k)
        exp, err = check_fwd(scan, x, gtf, eps, what)
        res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
        g_out, rows = with_kernel_rows(
            scan, lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3))
        e_out, margins = scan.bfvi_scan_bwd_ref_on_masks(res, cots, 1e-3,
                                                         rows[0])
        g_again = scan.bfvi_scan_bwd_cuda(res, cots, 1e-3)
        torch.cuda.synchronize()
        flips, worst = check_flips(scan, margins, Z_DIM, what)
        log("  bfvi_scan_bwd %s: %d ReLU flips against the plain backward "
            "in the GTF first layers (held on the kernel's masks), largest "
            "exact margin %.3g of the bound %.3g"
            % (what, flips, worst, scan.relu_flip_bound(Z_DIM)))
        berr = 0.0
        for name, g, e in bwd_pairs(scan, g_out, e_out):
            check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
            ok, a = max_norm_err(g, e)
            berr = max(berr, a)
            check(ok, "backward kernel %s disagrees at (M, K) = (%d, %d): "
                  "max abs err %.3g (scale %.3g)"
                  % (name, n_exp, k, a, e.abs().max().item()))
        for name, g, g2 in bwd_pairs(scan, g_out, g_again):
            check(torch.equal(g, g2), "backward kernel %s: two runs differ "
                  "at (M, K) = (%d, %d)" % (name, n_exp, k))
        # The weight-gradient kernel alone, on rows shaped like those the
        # backward kernel writes.
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        n_rows = (T_MAIN - 1) * k * V_MAIN * B_DATA
        xs = torch.randn((n_rows, 3 * Z_DIM), generator=gen, device=dev)
        ys = torch.randn((n_rows, 6 * Z_DIM), generator=gen, device=dev)
        w_got = scan.gtf_wgrad_cuda(exp[5], xs, ys)
        w_exp = scan.gtf_wgrad_ref(exp[5], xs, ys)
        torch.cuda.synchronize()
        werr = 0.0
        for n in scan.GTF_LAYERS:
            for kk in ("w", "b"):
                ok, a = max_norm_err(w_got[n][kk], w_exp[n][kk])
                werr = max(werr, a)
                check(ok, "weight-gradient kernel %s.%s disagrees at K = %d: "
                      "max abs err %.3g" % (n, kk, k, a))
        reps = 3 if k > 1 else 10
        times = [time_ms(fn, reps) for fn in (
            lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3),
            lambda: scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3),
            lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3),
            lambda: scan.bfvi_scan_bwd_ref(res, cots, 1e-3),
            lambda: scan.gtf_wgrad_cuda(exp[5], xs, ys),
            lambda: scan.gtf_wgrad_ref(exp[5], xs, ys))]
        (ff, fb), (bf, bb), (wf, wb) = scan_work(
            T_MAIN, n_exp, V_MAIN * B_DATA, k, Z_DIM, Z_DIM)
        for name, e, ms, pms, fl, by in (
                ("bfvi_scan_fwd", err, times[0], times[1], ff, fb),
                ("bfvi_scan_bwd", berr, times[2], times[3], bf, bb),
                ("gtf_wgrad", werr, times[4], times[5], wf, wb)):
            r = rec[name]
            r["err"] = max(r["err"], e)
            r["ms"] += ms
            r["plain_ms"] += pms
            bms, by_what = bound_ms(TF32_PASSES * fl, by, PEAK_TF32_FLOPS)
            r["bound_ms"][by_what] += bms
            f32_ms, f32_by = bound_ms(fl, by)
            r["bound_f32_ms"] += f32_ms
            log("  %s (M, K) = (%d, %d): kernel %.3f ms, plain %.3f ms, "
                "bound %.3f ms (%s, 3xTF32), f32 bound %.3f ms (%s), max abs "
                "err %.3g" % (name, n_exp, k, ms, pms, bms, by_what, f32_ms,
                              f32_by, e))

    # The evaluation's MAP smoothing pass: its own row, not in the sums.
    t_max, b_dim, n_exp, k = SMOOTH_SHAPE
    x, eps, _ = scan_inputs(n_exp, k, dev, seed=110, t_max=t_max,
                            b_dim=b_dim)
    what = "(T, B, M, K) = (%d, %d, %d, %d)" % SMOOTH_SHAPE
    _, err = check_fwd(scan, x, gtf, eps, what)
    rec["bfvi_scan_fwd"]["err"] = max(rec["bfvi_scan_fwd"]["err"], err)
    ms, pms = [time_ms(fn, 10) for fn in (
        lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3),
        lambda: scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3))]
    fl, by = scan_work(t_max, n_exp, b_dim, k, Z_DIM, Z_DIM)[0]
    bms, by_what = bound_ms(TF32_PASSES * fl, by, PEAK_TF32_FLOPS)
    f32_ms, f32_by = bound_ms(fl, by)
    log("  bfvi_scan_fwd, evaluation smoothing %s: kernel %.3f ms, plain "
        "%.3f ms, bound %.4f ms (%s, 3xTF32), f32 bound %.4f ms (%s), max "
        "abs err %.3g" % (what, ms, pms, bms, by_what, f32_ms, f32_by, err))
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


def cell_inputs(n_exp, k, dev, seed):
    """Inputs shaped like one step of the evaluation's passes at B = 25,
    D = 256: a positive prior, M experts with 10 % of cells masked; the
    5-expert case carries the filter prior and the inverse global prior,
    as the smoothing pass does."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b_dim = B_DATA
    prior_mean = torch.randn((b_dim, Z_DIM), generator=gen, device=dev)
    prior_std = 0.1 + torch.rand((b_dim, Z_DIM), generator=gen, device=dev)
    obs_mean = torch.randn((n_exp, b_dim, Z_DIM), generator=gen, device=dev)
    obs_std = 0.1 + torch.rand((n_exp, b_dim, Z_DIM), generator=gen,
                               device=dev)
    mask = (torch.rand((n_exp, b_dim), generator=gen, device=dev)
            > 0.1).float()
    if n_exp == 5:  # filter prior, inverse global prior (std 1.001)
        obs_std[3] = 0.9 * 1.001
        obs_mean[4] = 0.0
        obs_std[4] = -1.001
        mask[3:] = 1.0
    eps = torch.randn((k, b_dim, Z_DIM), generator=gen, device=dev)
    return prior_mean, prior_std, obs_mean, obs_std, mask, eps


def check_cell(cell, dev):
    """Phase 5: the cell kernel against its plain version; returns its
    record (time, plain time and bound per launch at the evaluation's
    200-particle shape, largest error over both shapes)."""
    rec = dict(err=0.0)
    for i, (n_exp, k) in enumerate(CELL_SHAPES):
        x = cell_inputs(n_exp, k, dev, seed=300 + i)
        got = cell.poe_sample_cell_cuda(*x)
        exp = cell.poe_sample_cell_ref(*x)
        torch.cuda.synchronize()
        tol = CELL_TOL * (10 if n_exp == 5 else 1)
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
        bms, by_what = bound_ms(*cell_work(n_exp, k, B_DATA, Z_DIM))
        log("  poe_sample_cell (M, K, B, D) = (%d, %d, %d, %d): kernel "
            "%.4f ms (%.4f ms a call with the host's launch), plain %.4f "
            "ms, bound %.4f ms (%s), max abs err %.3g"
            % (n_exp, k, B_DATA, Z_DIM, ms, host_ms, pms, bms, by_what,
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


def run_eval(trainer, loader, args, plain, seed):
    """One ``evaluate`` call on the kernels or on the plain versions, the
    generator reseeded, with the launch counts set to 0 just before and
    read just after. Returns (summary, launches)."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    trainer.model.plain_scan = plain
    trainer.gen.manual_seed(seed)
    _, summary = trainer.evaluate(loader, args, collect_results=False)
    trainer.model.plain_scan = False
    return dict(summary), {n: fn.launches for n, fn in wrappers.items()}


def check_evaluation(trainer, seed, n_evals):
    """Phase 6: the Weizmann BFVI evaluation on the kernels against the
    plain versions, then timed. Returns (cell launches of one evaluation,
    median ms per call)."""
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training.loader import BatchLoader
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
    got, launches = run_eval(trainer, loader, args, False, seed)
    exp, plain_launches = run_eval(trainer, loader, args, True, seed)
    torch.backends.cudnn.deterministic = False
    log("  launches, kernels: %s; plain: %s" % (launches, plain_launches))
    check(launches == {"bfvi_scan_fwd": 1, "bfvi_scan_bwd": 0,
                       "gtf_wgrad": 0, "poe_sample_cell": t_max},
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
              else abs(g - e) <= EVAL_RTOL * abs(e) + 1e-6)
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
    return launches["poe_sample_cell"], ms, loader, args


def kernel_wrappers():
    from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan, poe_cell
    out = {name: getattr(bfvi_scan, name + "_cuda") for name in SCAN_KERNELS}
    out["poe_sample_cell"] = poe_cell.poe_sample_cell_cuda
    return out


def synthetic_batch(seed, dev):
    """T = B = 25 Weizmann-shaped batch: video in [0, 1], 10 % of frames
    deleted (NaN) in the inputs, full targets; person/action labels."""
    rng = np.random.RandomState(seed)
    video = rng.rand(T_MAIN, B_DATA, 3, 64, 64).astype(np.float32)
    targets = {
        "video": video,
        "person": rng.randint(0, 10, (T_MAIN, B_DATA, 1)).astype(np.float32),
        "action": rng.randint(0, 10, (T_MAIN, B_DATA, 1)).astype(np.float32),
    }
    inputs = {m: v.copy() for m, v in targets.items()}
    inputs["video"][rng.rand(T_MAIN, B_DATA) < 0.1] = np.nan
    to = lambda d: {m: torch.tensor(v, device=dev) for m, v in d.items()}  # noqa: E731
    return to(inputs), to(targets), torch.ones((T_MAIN, B_DATA, 1),
                                               device=dev)


def step_grads(trainer, inputs, targets, mask, plain, seed):
    """Loss and gradients of one training step (no update) with the
    scan on the kernels or on the plain versions, noise from ``seed``."""
    from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path
    trainer.model.plain_scan = plain
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    for p in trainer.leaves:
        p.grad = None
    loss, _ = trainer.model.step(trainer.params, trainer.state, inputs, mask,
                                 1.0, trainer.rec_mults, gen,
                                 targets=targets, train=True)
    loss.backward()
    trainer.model.plain_scan = False
    grads = {path: p.grad.detach().clone()
             for path, p in tree_leaves_with_path(trainer.params)}
    for p in trainer.leaves:
        p.grad = None
    return loss.item(), grads


def grad_diffs(g_a, g_b):
    """{path: dict(max=max normalised |a - b|, bad=elements beyond
    STEP_GRAD_TOL, rows=rows holding them, n_rows, fro=relative Frobenius
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
        bad = ((gn - en).abs() > STEP_GRAD_TOL["atol"]
               + STEP_GRAD_TOL["rtol"] * en.abs()).reshape(e.shape[0], -1)
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


def check_step_against_plain(scan, trainer, inputs, targets, mask, seed):
    """One step's loss and gradients on the kernels against the plain
    versions, with the same noise and deterministic cuDNN.

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
    """
    torch.backends.cudnn.deterministic = True
    (l_k, g_k), rows = with_kernel_rows(scan, lambda: step_grads(
        trainer, inputs, targets, mask, False, seed))
    check(len(rows) == len(SCAN_SHAPES), "the step launched the backward "
          "kernel %d times, expected %d" % (len(rows), len(SCAN_SHAPES)))
    margins, launch = [], iter(rows)

    def on_masks(res, cots, min_std):
        outs, m = scan.bfvi_scan_bwd_ref_on_masks(res, cots, min_std,
                                                  next(launch))
        margins.append(m)
        return outs
    # The step's backward calls the module's bfvi_scan_bwd_cuda: for this
    # run, the plain backward on the masks of the kernel's run above.
    bwd_kernel, scan.bfvi_scan_bwd_cuda = scan.bfvi_scan_bwd_cuda, on_masks
    try:
        l_km, g_km = step_grads(trainer, inputs, targets, mask, False, seed)
    finally:
        scan.bfvi_scan_bwd_cuda = bwd_kernel
    l_kp, g_kp = step_grads(trainer, inputs, targets, mask, "bwd", seed)
    l_p, g_p = step_grads(trainer, inputs, targets, mask, True, seed)
    l_p2, g_p2 = step_grads(trainer, inputs, targets, mask, True, seed)
    torch.backends.cudnn.deterministic = False
    log("  loss: kernels %.6f, forward kernel + plain backward %.6f (on the "
        "kernel's ReLU masks %.6f), plain %.6f, plain again %.6f"
        % (l_k, l_kp, l_km, l_p, l_p2))
    check(np.isfinite(l_k), "non-finite loss on the kernel path")
    check(l_k == l_kp == l_km,
          "the forward kernel gave different losses for one input")
    check(abs(l_k - l_p) <= STEP_LOSS_RTOL * abs(l_p),
          "step loss: kernels %r vs plain %r" % (l_k, l_p))

    flips = [check_flips(scan, m, Z_DIM, "step, backward launch %d" % i)
             for i, m in enumerate(margins)]
    d_own = grad_diffs(g_k, g_kp)
    log("  backward kernel: %d ReLU flips in the GTF first layers against "
        "the plain backward (largest exact margin %.3g of the bound %.3g); "
        "on its own masks the plain backward differs beyond the "
        "elementwise tolerance in %d rows of %d leaves"
        % (sum(n for n, _ in flips), max(w for _, w in flips),
           scan.relu_flip_bound(Z_DIM),
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
    bad = [p for p, d in d_all.items() if d["fro"] > STEP_GRAD_TOL["rtol"]
           or (d["noise"] and d["bad"])]
    check(not bad, "step gradients of %d leaves differ beyond rtol %g in "
          "relative Frobenius norm: %s" % (len(bad), STEP_GRAD_TOL["rtol"],
                                           bad))
    log("  gradients: %d leaves agree" % len(d_all))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8,
                    help="timed optimizer steps (after 2 warm-up steps)")
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of one step and one "
                    "evaluation here")
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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s:" % name, line.strip())

    trainer = weizmann.make_trainer(seed=args.seed, device=dev)
    model = trainer.model
    gtf = {n: {k: v.detach() for k, v in p.items()}
           for n, p in trainer.params["trans"]["bwd"].items()}

    # -- phase 3: kernels against their plain versions -----------------------
    log("phase 3: kernels vs plain versions [%s]" % card)
    rec = check_kernels(scan, gtf, dev)
    log("  no single PyTorch call computes the scan, or the weight "
        "gradients' four products with their sums: library_ms is null "
        "(gtf_wgrad's plain version is those four cuBLAS products)")

    # -- phase 4: the training path -------------------------------------------
    log("phase 4: Weizmann BFVI training step, T = B = %d, z = h = %d"
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
    log("phase 5: poe_sample_cell vs its plain version [%s]" % card)
    cell_rec = check_cell(cell, dev)
    log("  no single PyTorch call computes the cell: library_ms is null")

    # -- phase 6: the evaluation path -----------------------------------------
    log("phase 6: Weizmann BFVI evaluation on the phase-4 weights [%s]"
        % card)
    cell_launches, eval_ms, loader, eval_args = check_evaluation(
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

    # -- summary --------------------------------------------------------------
    log(card)
    rec["poe_sample_cell"] = cell_rec
    launches["poe_sample_cell"] = cell_launches
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        if name in SCAN_KERNELS:
            by_what = max(r["bound_ms"], key=r["bound_ms"].get)
            bms = sum(r["bound_ms"].values())
        else:
            by_what, bms = r["bound_by"], r["bound_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bms, "bound_by": by_what, "library_ms": None})
        if name in SCAN_KERNELS:
            kernels[-1]["bound_f32_ms"] = r["bound_f32_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
