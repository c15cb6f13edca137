"""The driver of the ``eval`` mixes: ``Trainer.evaluate(...,
collect_results=False)`` back to back, each call ending with its metrics
on the host.

Set-up runs ``warm_calls`` calls; the window runs calls until ``--seconds``
have passed; the rate is every real frame of every call over the window,
the tail the 95th percentile of every call's time. With ``--trace 1``
``trace_calls`` calls follow the window under the profiler. The program's
state is then freed, and the reference replays ``check_calls`` calls drawn
from the seed among the window's.
"""

import math
import time

import numpy as np

from ..core import checks, program
from ..core.checks import initial_weights
from ..core.common import Outcome, free, patch, peak, quiet, seeds, sync
from ..core.data import make_corpus
from ..core.trace import profile


def run(cell, seed, seconds, trace, device, t_start, trace_path=None):
    cfg, mix = cell.cfg, cell.mix
    data_seed, weight_seed, prog_seed = seeds(seed)
    stages = {"start": time.perf_counter() - t_start}
    corpus = make_corpus(cfg, data_seed, device, splits=("test",))
    params, state = initial_weights(cfg, weight_seed, device)
    stages["data_and_weights"] = time.perf_counter() - t_start
    with quiet():
        trainer, args = program.build(cfg, params, state, prog_seed, device)
    stages["trainer"] = time.perf_counter() - t_start
    del params, state
    loader = program.eval_loader(args, corpus["test"])
    lengths = [it["length"] for it in corpus["test"]]
    frames = sum(lengths)
    n_warm = mix["warm_calls"]

    def call():
        return trainer.evaluate(loader, args, collect_results=False)[1]
    with quiet():
        for _ in range(n_warm):
            call()
    sync(device)
    setup_s = time.perf_counter() - t_start
    times, summaries = [], []
    t0 = time.perf_counter()
    with quiet():
        while True:
            c0 = time.perf_counter()
            summaries.append(dict(call()))
            c1 = time.perf_counter()
            times.append(c1 - c0)
            if c1 - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    sl = None
    if trace:
        def traced():
            with quiet():
                for _ in range(mix["trace_calls"]):
                    call()
        sl = profile(traced, mix["trace_calls"], trace_path)
    memory_peak = peak(device)
    del trainer
    free()
    n = len(summaries)
    rng = np.random.RandomState(data_seed)
    picked = sorted(rng.choice(n, min(mix["check_calls"], n), replace=False))
    calls = [n_warm + int(i) for i in picked]
    ref = checks.reference_eval(cfg, corpus["test"], weight_seed, prog_seed,
                                device, calls)
    prog = {n_warm + int(i): summaries[i] for i in picked}
    numbers = checks.compare_eval(cfg, prog, ref)
    keys = list(next(iter(ref.values())))
    failed = sum(1 for s in summaries
                 if not all(math.isfinite(float(s[k])) for k in keys))
    stages["warm"] = setup_s
    ctx = {"cfg": cfg, "slice": sl, "lengths": lengths, "lengths_units": 1,
           "window_s": window_s, "unit_s": times, "window_units": n,
           "peak": memory_peak, "stages": stages}
    return Outcome({"eval_frames_per_s": frames * n / window_s,
                    "eval_ms_p95": 1e3 * float(np.percentile(times, 95)),
                    "setup_s": setup_s}, n, failed, numbers, ctx)


def control(cell, seed, device, kind):
    """The check's numbers of the reference at the precision ``kind`` in
    the program's place, over as many calls as a run compares."""
    cfg = cell.cfg
    data_seed, weight_seed, prog_seed = seeds(seed)
    items = make_corpus(cfg, data_seed, device, ("test",))["test"]
    first = cell.mix["warm_calls"]
    calls = list(range(first, first + cell.mix["check_calls"]))
    ref = checks.reference_eval(cfg, items, weight_seed, prog_seed, device,
                                calls)
    ctrl = checks.reference_eval(cfg, items, weight_seed, prog_seed, device,
                                 calls, control=kind)
    return checks.compare_eval(cfg, ctrl, ref), None


def _half_batch(cls, cfg):
    import torch

    def make(metrics):
        def half(self, model, infer, prior, recon, targets, mask, lengths,
                 rec_mults):
            out = metrics(self, model, infer, prior, recon, targets, mask,
                          lengths, rec_mults)
            n = max(1, int((lengths > 0).sum()) // 2)
            idx = torch.arange(mask.shape[1], device=mask.device) % n
            return {k: v if v.dim() == 0 else v[idx] for k, v in out.items()}
        return half
    return patch(cls, "compute_metrics_device", make)


def _answer_altered(cls, cfg):
    """The last compared term's per-sequence values raised by 0.01 where
    the program computes them."""
    key = list(cfg["eval_checks"].values())[-1]

    def make(metrics):
        def altered(self, *a):
            out = metrics(self, *a)
            out[key] = out[key] + 0.01
            return out
        return altered
    return patch(cls, "compute_metrics_device", make)


def _stale_answer(cls, cfg):
    def make(evaluate):
        first = {}

        def stale(self, *a, **kw):
            return first.setdefault("out", evaluate(self, *a, **kw))
        return stale
    return patch(cls, "evaluate", make)


# Half of the batch left out, the mean taken over the rest; an answer
# altered where it is produced; a step that returns its state unchanged
# (every call answers with the first call's summary). One chip: no
# exchange between chips.
FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered,
          "stale_answer": _stale_answer}
