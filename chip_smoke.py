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
   (3, 25), (5, 1)), with their times and the card's bound;
4. the Weizmann BFVI training step at full width (weights from --seed,
   a synthetic batch of T = B = 25, KLD multiplier 1 as at the end of the
   trainer's anneal): one step's loss and gradients on the kernels
   against the same step on the plain versions, then --steps optimizer
   steps through the kernels, with their launch counts and the median
   step time.

Any failed check raises, so the script exits non-zero before its last
line. The line before the last is a JSON object with one entry per
kernel (its ``ms``, ``plain_ms`` and ``bound_ms`` are sums over the
step's three launches); the last is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

T_MAIN, B_DATA, V_MAIN, Z_DIM = 25, 25, 4, 256
SCAN_SHAPES = ((3, 1), (3, 25), (5, 1))  # (M, K) of the step's 3 passes
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
# name -> the TPU kernel (or the part of it) that it replaces
KERNELS = {
    "bfvi_scan_fwd": "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:118",
    "bfvi_scan_bwd": "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:293",
    "gtf_wgrad": "multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:451",
}
FWD_TOL = dict(rtol=5e-4, atol=5e-5)
BWD_TOL = dict(rtol=1e-3, atol=1e-3)     # on max-abs-normalised gradients
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)  # on max-abs-normalised grads


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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scan_inputs(n_exp, k, dev, seed):
    """Inputs shaped like one pass of the training step: V*B = 100
    columns, 10 % of expert cells masked; the 5-expert case carries the
    smoothing pass's filter prior and inverse global prior."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (T_MAIN, n_exp, V_MAIN * B_DATA, Z_DIM)
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
    eps = torch.randn((T_MAIN, k) + shape[2:], generator=gen, device=dev)
    cots = [torch.randn((T_MAIN,) + shape[2:], generator=gen, device=dev)
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


def check_kernels(scan, gtf, dev):
    """Phase 3: every kernel against its plain version at the main
    path's shapes; returns per-kernel records."""
    rec = {name: dict(err=0.0, ms=0.0, plain_ms=0.0,
                      bound_ms={"operations": 0.0, "bytes": 0.0})
           for name in KERNELS}
    for i, (n_exp, k) in enumerate(SCAN_SHAPES):
        x, eps, cots = scan_inputs(n_exp, k, dev, seed=100 + i)
        got = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3)
        exp = scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, e in zip(("prior_mean", "prior_std", "infer_mean",
                               "infer_std", "samples", "z_traj"), got, exp):
            check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
            ok = torch.allclose(g, e, **FWD_TOL)
            err = max(err, (g - e).abs().max().item())
            check(ok, "forward kernel %s disagrees at (M, K) = (%d, %d): "
                  "max abs err %.3g" % (name, n_exp, k,
                                        (g - e).abs().max().item()))
        res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
        g_out = scan.bfvi_scan_bwd_cuda(res, cots, 1e-3)
        e_out = scan.bfvi_scan_bwd_ref(res, cots, 1e-3)
        torch.cuda.synchronize()
        berr = 0.0
        pairs = list(zip(("d_obs_mean", "d_obs_std", "d_glb_mean",
                          "d_glb_std"), g_out[:4], e_out[:4]))
        pairs += [(n + "." + kk, g_out[4][n][kk], e_out[4][n][kk])
                  for n in scan.GTF_LAYERS for kk in ("w", "b")]
        for name, g, e in pairs:
            check(bool(torch.isfinite(g).all()), "non-finite %s" % name)
            ok, a = max_norm_err(g, e)
            berr = max(berr, a)
            check(ok, "backward kernel %s disagrees at (M, K) = (%d, %d): "
                  "max abs err %.3g (scale %.3g)"
                  % (name, n_exp, k, a, e.abs().max().item()))
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
            bms, by_what = bound_ms(fl, by)
            r["bound_ms"][by_what] += bms
            log("  %s (M, K) = (%d, %d): kernel %.3f ms, plain %.3f ms, "
                "bound %.3f ms (%s), max abs err %.3g"
                % (name, n_exp, k, ms, pms, bms, by_what, e))
    return rec


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


def check_step_against_plain(trainer, inputs, targets, mask, seed):
    """One step's loss and gradients on the kernels against the plain
    versions, with the same noise and deterministic cuDNN.

    - Kernels against the forward kernel followed by the plain backward:
      the forward is the same bit for bit, so this holds the backward
      kernel to its plain version inside the step. Every gradient element
      is within STEP_GRAD_TOL (max-abs normalised).
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
    l_k, g_k = step_grads(trainer, inputs, targets, mask, False, seed)
    l_kp, g_kp = step_grads(trainer, inputs, targets, mask, "bwd", seed)
    l_p, g_p = step_grads(trainer, inputs, targets, mask, True, seed)
    l_p2, g_p2 = step_grads(trainer, inputs, targets, mask, True, seed)
    torch.backends.cudnn.deterministic = False
    log("  loss: kernels %.6f, forward kernel + plain backward %.6f, "
        "plain %.6f, plain again %.6f" % (l_k, l_kp, l_p, l_p2))
    check(np.isfinite(l_k), "non-finite loss on the kernel path")
    check(l_k == l_kp, "the forward kernel gave two losses for one input")
    check(abs(l_k - l_p) <= STEP_LOSS_RTOL * abs(l_p),
          "step loss: kernels %r vs plain %r" % (l_k, l_p))

    d_bwd = grad_diffs(g_k, g_kp)
    log_worst("backward kernel vs plain backward", d_bwd)
    bad = [p for p, d in d_bwd.items() if d["bad"]]
    check(not bad, "backward kernel: step gradients of %d leaves differ "
          "beyond rtol %g / atol %g (normalised): %s"
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
                    help="write a torch.profiler table of one step here")
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
    log("build: %.1f s (nvcc, sm_90a)" % secs)
    for line in _build.build_log("bfvi_scan").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

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
    check_step_against_plain(trainer, inputs, targets, mask, args.seed)

    before = {k: v.detach().clone() for k, v in
              trainer.params["trans"]["bwd"]["gate_1"].items()}
    before["video"] = trainer.params["dec"]["video"]["deconvs"][2]["w"] \
        .detach().clone()
    n_warm, times, losses = 2, [], []
    wrappers = {name: getattr(scan, name + "_cuda") for name in KERNELS}
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
    for name, n in launches.items():
        check(n == 3 * n_steps, "%s launched %d times in %d steps, "
              "expected 3 per step" % (name, n, n_steps))
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
            f.write("%s\n" % card)
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        log("  profile written to %s" % args.profile)

    # -- phase 5: summary ---------------------------------------------------
    log(card)
    kernels = []
    for name, replaces in KERNELS.items():
        r = rec[name]
        by_what = max(r["bound_ms"], key=r["bound_ms"].get)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_dmm_tpu_torch/csrc/bfvi_scan.cu",
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": sum(r["bound_ms"].values()), "bound_by": by_what,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
