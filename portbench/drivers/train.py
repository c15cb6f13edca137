"""The driver of the ``train`` mixes: ``Trainer.train`` epoch after epoch
over the device-resident loader, closed loop, one caller.

Set-up runs ``warm_epochs`` epochs, whose first ``check_steps`` steps are
recorded for the check; the window then runs whole epochs until
``--seconds`` have passed, and its rate is every real frame of every step
over the window's seconds on the host clock. With ``--trace 0`` whole
epochs of at least ``device_steps`` steps follow the window under the
profiler, and the device's rate is their real frames over the device's
busy seconds (the union of its operations' intervals); with ``--trace 1``
whole epochs of at least ``trace_steps`` steps follow it there instead,
for the per-layer readers. The program's state is then freed and the
reference run for the check.
"""

import math
import time

import numpy as np

from ..core import checks, program
from ..core.checks import ADAM_BETA1, initial_weights
from ..core.common import Outcome, free, patch, peak, quiet, seeds, sync
from ..core.data import make_corpus
from ..core.trace import profile


def _adam_steps(trainer):
    st = trainer.optimizer.state.get(trainer.leaves[0], {})
    return int(st.get("step", 0))


def run(cell, seed, seconds, trace, device, t_start, trace_path=None):
    cfg, mix = cell.cfg, cell.mix
    data_seed, weight_seed, prog_seed = seeds(seed)
    stages = {"start": time.perf_counter() - t_start}
    corpus = make_corpus(cfg, data_seed, device, splits=("train",))
    params, state = initial_weights(cfg, weight_seed, device)
    stages["data_and_weights"] = time.perf_counter() - t_start
    with quiet():
        trainer, args = program.build(cfg, params, state, prog_seed, device)
        stages["trainer"] = time.perf_counter() - t_start
        loader = program.train_loader(trainer, args, corpus["train"])
        stages["loader"] = time.perf_counter() - t_start
    del params, state
    lengths = [it["length"] for it in corpus["train"]]
    frames = sum(lengths)
    n_batches, n_check = len(loader), mix["check_steps"]
    record = {"losses": []}
    step = trainer.train_step

    def recorded_step(*a):
        out = step(*a)
        i = len(record["losses"])
        if i < n_check:
            record["losses"].append(out[0])
            if i == 0 and out[1] and trainer.optimizer.state:
                record["grad1"] = [
                    trainer.optimizer.state[p]["exp_avg"] / (1 - ADAM_BETA1)
                    for p in trainer.leaves]
            if i == n_check - 1:
                record["params"] = [p.detach().clone()
                                    for p in trainer.leaves]
        return out
    trainer.train_step = recorded_step
    with quiet():
        for epoch in range(1, 1 + mix["warm_epochs"]):
            trainer.train(loader, epoch, args)
    del trainer.train_step
    sync(device)
    setup_s = time.perf_counter() - t_start
    applied0 = _adam_steps(trainer)
    epoch += 1
    n_epochs, ends = 0, []
    t0 = time.perf_counter()
    with quiet():
        while True:
            trainer.train(loader, epoch + n_epochs, args)
            n_epochs += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
    window_s = time.perf_counter() - t0
    steps = n_epochs * n_batches
    failed = steps - (_adam_steps(trainer) - applied0)
    metrics = {"train_frames_per_s": frames * n_epochs / window_s,
               "setup_s": setup_s}
    n_ep = max(1, math.ceil(mix["trace_steps" if trace else "device_steps"]
                            / n_batches))
    first = epoch + n_epochs

    def traced():
        with quiet():
            for e in range(first, first + n_ep):
                trainer.train(loader, e, args)
    sl = profile(traced, n_ep * n_batches, trace_path if trace else None)
    if sl.busy_s > 0:
        metrics["train_frames_per_device_s"] = frames * n_ep / sl.busy_s
    if not trace:
        sl = None
    memory_peak = peak(device)
    del trainer, loader, step
    free()
    record["losses"] = [float(x) for x in record["losses"]]
    ref = checks.reference_train(cfg, corpus["train"], weight_seed,
                                 prog_seed, device, n_check)
    if "params" in record:
        record["change"] = [p - q for p, q in zip(record.pop("params"),
                                                  ref["p0"])]
    numbers = checks.compare_train(record, ref)
    stages["warm"] = setup_s
    ctx = {"cfg": cfg, "slice": sl, "lengths": lengths,
           "lengths_units": n_batches,
           "unit_s": np.diff([0.0] + ends).tolist(),
           "window_s": window_s, "window_units": steps, "peak": memory_peak,
           "stages": stages, "leaves": checks.leaf_detail(record, ref)}
    return Outcome(metrics, steps, failed, numbers, ctx)


def control(cell, seed, device, kind):
    """The check's numbers of the reference at the precision ``kind`` in
    the program's place, and the leaves that read the largest gaps."""
    cfg = cell.cfg
    data_seed, weight_seed, prog_seed = seeds(seed)
    items = make_corpus(cfg, data_seed, device, ("train",))["train"]
    n = cell.mix["check_steps"]
    ref = checks.reference_train(cfg, items, weight_seed, prog_seed, device,
                                 n)
    ctrl = checks.reference_train(cfg, items, weight_seed, prog_seed, device,
                                  n, control=kind)
    return checks.compare_train(ctrl, ref), checks.leaf_detail(ctrl, ref)


def _state_unchanged(cls, cfg):
    return patch(cls, "apply_gradients", lambda orig: lambda self: True)


def _half_batch(cls, cfg):
    from multimodal_dmm_tpu_torch.models.dmm import MultiDMM

    def make(step):
        def half_step(self, params, state, inputs, mask, *a, targets=None,
                      **kw):
            half = mask.shape[1] // 2
            cut = {m: v[:, :half] for m, v in inputs.items()}
            tcut = {m: v[:, :half] for m, v in targets.items()}
            loss, new_state = step(self, params, state, cut, mask[:, :half],
                                   *a, targets=tcut, **kw)
            return loss * mask.sum() / mask[:, :half].sum(), new_state
        return half_step
    return patch(MultiDMM, "step", make)


# A step that returns its state unchanged; half of the batch left out, the
# mean taken over the rest. One chip: no exchange between chips.
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}
