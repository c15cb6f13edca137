"""The Weizmann evaluation and its sampled filter pass on the card, for one
or more checkouts of the port in turns, to compare a change with its
parent on one card.

    python3 scripts/eval_filter_compare.py [ROOT ...] [--evals N]

Each ROOT (a directory holding ``multimodal_dmm_tpu_torch``; by default
this repository) runs in a process of its own, in the order given (for
example parent, change, change, parent). The process builds that
checkout's kernels at first use, makes the Weizmann trainer at full width
(``weizmann.make_trainer``, seed 0) and, on the ten synthetic sequences of
``chip_smoke.py``'s phase 6 (one batch of 25 columns; the app's ``bfvi``
evaluation: 200 filter particles, MAP smoothing), times N ``evaluate``
calls after a warm-up (median wall ms, host clock after
``torch.cuda.synchronize``) and profiles three more (device busy ms and
device kernels a call, torch.profiler); then the 200-particle filter pass
alone at the evaluation's shapes (``z_filter(use_cell=True)``, T = the
longest sequence, M = 3 experts, B = 25): its median wall ms over ten
calls, its device busy ms and kernels, and kernels a step. Each process
prints one JSON line; the card's name and power limit come first.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's chip_smoke.py (its phase-6 data and profiler
    helpers), whatever ROOT is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root, n_evals):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from multimodal_dmm_tpu_torch.apps import weizmann
    from multimodal_dmm_tpu_torch.training.loader import BatchLoader
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    trainer = weizmann.make_trainer(seed=0, device=dev)
    items = cs.synthetic_eval_set(0)
    loader = BatchLoader(items, weizmann.DEFAULTS["batch_size"])
    args = weizmann.eval_namespace("bfvi")

    def evaluate():
        trainer.evaluate(loader, args, collect_results=False)

    evaluate()
    times = []
    for _ in range(n_evals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    busy, kernels = cs.device_profile(evaluate, 3)

    model, params = trainer.model, trainer.params
    t_max, b_dim, d = max(x["length"] for x in items), 25, model.z_dim
    gen = torch.Generator(device=dev).manual_seed(1)
    zm = torch.randn((3, t_max, b_dim, d), generator=gen, device=dev)
    zs = 0.3 + torch.rand((3, t_max, b_dim, d), generator=gen, device=dev)
    zk = torch.rand((3, t_max, b_dim), generator=gen, device=dev) > 0.3
    eps = torch.randn((t_max, 200, b_dim, d), generator=gen, device=dev)

    def filter_pass():
        with torch.no_grad():
            model.z_filter(params, zm, zs, zk, n_particles=200, eps=eps,
                           use_cell=True)

    filter_pass()
    f_times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filter_pass()
        torch.cuda.synchronize()
        f_times.append(1e3 * (time.perf_counter() - t0))
    f_busy, f_kernels = cs.device_profile(filter_pass, 3)
    print(json.dumps({
        "root": root, "card": cs.card_line(),
        "eval_ms": statistics.median(times), "eval_ms_all": times,
        "eval_busy_ms": busy, "eval_kernels": kernels,
        "filter_T": t_max, "filter_ms": statistics.median(f_times),
        "filter_busy_ms": f_busy, "filter_kernels": f_kernels,
        "filter_kernels_a_step": (None if f_kernels is None
                                  else f_kernels / t_max)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--evals", type=int, default=10)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        worker(a.worker, a.evals)
        return 0
    rc = 0
    for root in a.roots:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--worker", root, "--evals", str(a.evals)])
    return rc


if __name__ == "__main__":
    sys.exit(main())
