#!/usr/bin/env python3
"""Drive the PyTorch port's data parallelism across the GPUs of one host
and check it against one process.

    python3 multigpu_smoke.py [--seed N] [--epochs N]

Run from the repository root on a host with at least four CUDA GPUs and
nvcc. It imports nothing of JAX or of the JAX package. It builds the
kernels, writes a Weizmann fixture of 90 sequences (``gen_synthetic``) to
a temporary directory, and runs ``apps.weizmann.main`` at full width (z =
h = 256, ``--batch_size 24`` so that 4 divides it) in one process on
cuda:0, then under ``--mesh 4`` and ``--mesh 2x2`` (one process a rank,
rank r on cuda:r under NCCL, as the command line runs on such a host):

- MAP training (one particle, no prior matching, no burst deletion), one
  epoch: each mesh's epoch loss within LOSS_RTOL of the single process's;
- the app's default (sampled) training, ``--epochs`` epochs with an
  evaluation after each (on every rank, each on its columns of the
  evaluation batch): the first epoch's loss within LOSS_RTOL of the
  single process's (the ranks draw the single process's noise), every
  epoch loss and metric finite, and the checkpoints written;
- ``--load last.pth --evaluate --eval_sets test`` on the single process's
  sampled checkpoint (the collect path, its AVI written by rank 0) in one
  process and under ``--mesh 4`` and ``2x2``: every metric within
  LOSS_RTOL of the single process's (the accuracies within
  LABEL_ATOL);
- a one-epoch trial through ``experiments.tune.run`` under ``mesh: "4"``
  (in this process): TERMINATED, its two ``progress.csv`` rows finite, the
  last ``done``.

It prints each run's seconds per epoch and per evaluation (host clock,
rank 0's), the cards' names and power limits, one JSON line with those
numbers, and last ``{"ok": true, ...}``. Any failed check raises.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LOSS_RTOL = 1e-4    # STEP_LOSS_RTOL of chip_smoke.py
# An accuracy summary may move by two flipped label decisions among the
# test set's steps (chip_smoke.py's EVAL_LABEL_FLIPS; 10 sequences of 30
# steps or more).
LABEL_ATOL = 2.0 / 300
MAP_ARGS = "{sample: false, match_mult: 0.0, train_particles: 1}"
MESHES = ("4", "2x2")


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cards():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()


def run(weizmann, data, save, seed, mesh, epochs, map_mode):
    """One ``apps.weizmann.main`` training run; returns its history."""
    argv = ["--data_dir", data, "--save_dir", save, "--method", "bfvi",
            "--seed", str(seed), "--batch_size", "24", "--epochs",
            str(epochs), "--eval_freq", "1", "--save_freq", str(epochs),
            "--mesh", mesh]
    if map_mode:
        argv += ["--train_args", MAP_ARGS, "--burst_frac", "0.0"]
    hist = weizmann.main(argv)
    check(all(np.isfinite(hist["epoch_loss"])), "%s: non-finite epoch "
          "loss %s" % (mesh, hist["epoch_loss"]))
    check(all(np.isfinite(e["rec_loss"]) for e in hist["eval"]),
          "%s: non-finite evaluation" % mesh)
    check(sorted(os.listdir(save)) == sorted(
        ["best.pth", "epoch_%d.pth" % epochs, "last.pth"]),
        "%s: checkpoints %s" % (mesh, sorted(os.listdir(save))))
    log("  --mesh %s, %s: epoch losses %s, epochs %s s, evaluations %s s"
        % (mesh, "MAP" if map_mode else "sampled",
           ["%.6g" % v for v in hist["epoch_loss"]],
           ["%.2f" % v for v in hist["epoch_s"]],
           ["%.2f" % v for v in hist["eval_s"]]))
    return hist


def evaluate(weizmann, data, save, seed, mesh):
    """``--load last.pth --evaluate --eval_sets test`` of ``save``'s
    checkpoint under ``mesh`` (the results exported to ``save``/test.avi).
    Returns (the test set's metrics, the seconds of the command)."""
    argv = ["--data_dir", data, "--save_dir", save, "--method", "bfvi",
            "--seed", str(seed), "--batch_size", "24", "--mesh", mesh,
            "--load", os.path.join(save, "last.pth"), "--evaluate",
            "--eval_sets", "test"]
    t0 = time.perf_counter()
    _, metrics = weizmann.main(argv)
    secs = time.perf_counter() - t0
    check(np.isfinite(metrics["rec_loss"]) and os.path.exists(
        os.path.join(save, "test.avi")), "%s: --evaluate metrics %s"
        % (mesh, metrics))
    log("  --mesh %s --evaluate: %.1f s of command, rec_loss %.6g, ssim "
        "%.6g" % (mesh, secs, metrics["rec_loss"], metrics["ssim"]))
    return dict(metrics), secs


def trial(weizmann, data, root, seed):
    """A one-epoch Weizmann trial through ``tune.run`` under ``mesh:
    "4"``. Returns its progress.csv rows and seconds."""
    from multimodal_dmm_tpu_torch.experiments import tune
    config = {"data_dir": data, "method": "bfvi", "seed": seed,
              "batch_size": 24, "epochs": 1, "eval_freq": 1,
              "save_freq": 1, "mesh": "4"}
    t0 = time.perf_counter()
    ck = tune.run(weizmann.WeizmannTrainer.tune, "mesh4", config,
                  local_dir=root)[0]
    secs = time.perf_counter() - t0
    with open(os.path.join(ck["logdir"], "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    check(ck["status"] == "TERMINATED" and len(rows) == 2
          and [r["done"] for r in rows] == ["False", "True"]
          and all(np.isfinite(float(r["mean_loss"])) for r in rows),
          "trial under mesh 4: %s, rows %s" % (ck["status"], rows))
    log("  trial under mesh 4: %.1f s, mean_loss %s" % (
        secs, [r["mean_loss"] for r in rows]))
    return rows, secs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("multigpu_smoke: needs four CUDA GPUs, found %d"
              % (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
    from multimodal_dmm_tpu_torch.ops.cuda import _build

    log("build: %.1f s" % _build.build())
    for line in cards():
        log("card:", line)
    results = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="multigpu_smoke_") as tmp:
        os.chdir(tmp)  # param_hist.tsv is written there
        try:
            data = os.path.join(tmp, "data")
            gen_synthetic(data)
            for map_mode in (True, False):
                epochs = 1 if map_mode else args.epochs
                for mesh in ("1",) + MESHES:
                    key = "%s %s" % (mesh, "map" if map_mode else "sampled")
                    save = os.path.join(tmp, key.replace(" ", "_"))
                    results[key] = run(weizmann, data, save, args.seed, mesh,
                                       epochs, map_mode)
            evals = {mesh: evaluate(weizmann, data,
                                    os.path.join(tmp, "1_sampled"),
                                    args.seed, mesh)
                     for mesh in ("1",) + MESHES}
            rows, trial_s = trial(weizmann, data, os.path.join(tmp, "trials"),
                                  args.seed)
        finally:
            os.chdir(cwd)
    for mesh in MESHES:
        got, exp = evals[mesh][0], evals["1"][0]
        for key in sorted(exp):
            g, e = got[key], exp[key]
            if np.isnan(e) and np.isnan(g):
                continue  # no mask modality
            tol = (LABEL_ATOL if key.split("_")[0] in ("action", "person")
                   else LOSS_RTOL * abs(e))
            check(abs(g - e) <= tol, "--mesh %s --evaluate: %s %r vs %r in "
                  "one process" % (mesh, key, g, e))
        log("  --mesh %s --evaluate: every metric within tolerance of one "
            "process (rec_loss rel %.2e)" % (mesh, abs(
                got["rec_loss"] - exp["rec_loss"]) / abs(exp["rec_loss"])))
    for mode in ("map", "sampled"):
        single = results["1 " + mode]["epoch_loss"]
        for mesh in MESHES:
            got = results["%s %s" % (mesh, mode)]["epoch_loss"]
            log("  %s epoch losses, --mesh %s: %s vs %s in one process (rel "
                "%s)" % (mode, mesh, got, single,
                         ["%.2e" % (abs(a - b) / abs(b))
                          for a, b in zip(got, single)]))
            check(abs(got[0] - single[0]) <= LOSS_RTOL * abs(single[0]),
                  "--mesh %s: %s epoch loss %r vs %r" % (mesh, mode, got[0],
                                                         single[0]))
    summary = {key: {"epoch_loss": h["epoch_loss"], "epoch_s": h["epoch_s"],
                     "eval_s": h["eval_s"]} for key, h in results.items()}
    for mesh, (metrics, secs) in evals.items():
        summary["%s evaluate" % mesh] = {"command_s": secs,
                                         "rec_loss": metrics["rec_loss"]}
    summary["4 trial"] = {"command_s": trial_s, "mean_loss": [
        float(r["mean_loss"]) for r in rows]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
