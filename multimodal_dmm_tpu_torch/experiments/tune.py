"""Trial runner: grid-search experiment orchestration (counterpart of
multimodal_dmm_tpu/experiments/tune.py, of which it is a copy; standard
library only).

It stands in for the reference's Ray Tune and keeps its on-disk contract,
so that the analysis layer reads either package's experiments:

- ``grid_search(values)`` markers expand to the cartesian product;
- each trial gets its own log directory under
  ``{local_dir}/{exp_name}/`` and runs with that directory as cwd
  (checkpoints under the trainer's relative ``save_dir`` land inside it,
  as Ray trials did);
- the per-trial reporter appends rows to ``progress.csv``;
- ``experiment_state-*.json`` lists trial checkpoints with
  ``trial_id`` / ``logdir`` / ``config`` / ``experiment_tag``.

Trials run one after another, in this process or (``isolate``) each in a
subprocess of its own.
"""

import copy
import itertools
import json
import os
import time


class grid_search:  # noqa: N801 — tune-API-compatible name
    """Marker for grid-search dimensions (tune.grid_search)."""

    def __init__(self, values):
        self.values = list(values)


_REGISTRY = {}

def _json_default(v):
    """Coerce numpy scalars to JSON numbers; repr anything else.

    Ray and the reference wrote float metrics; a bare ``default=str``
    would turn np.float32 losses into strings.
    """
    try:
        import numpy as np
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.bool_):
            return bool(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
    except ImportError:
        pass
    return str(v)



def register_trainable(name, fn):
    """tune.register_trainable equivalent."""
    _REGISTRY[name] = fn


def expand_config(config):
    """Expand grid_search markers into the list of concrete configs."""
    keys = list(config.keys())
    grids = [(k, config[k].values) for k in keys
             if isinstance(config[k], grid_search)]
    base = {k: config[k] for k in keys
            if not isinstance(config[k], grid_search)}
    if not grids:
        return [dict(base)]
    out = []
    for combo in itertools.product(*[vals for _, vals in grids]):
        c = dict(base)
        for (k, _), v in zip(grids, combo):
            c[k] = v
        out.append(c)
    return out


class StopTrial(Exception):
    """Raised by the reporter when a trial reports done=True — the
    in-process equivalent of Ray terminating the trial (``run_train``
    reports done on a NaN loss and at its end)."""


class Reporter:
    """Per-trial status reporter writing progress.csv rows."""

    def __init__(self, logdir, resume=False):
        self.path = os.path.join(logdir, "progress.csv")
        self._keys = None
        self.last_result = {}
        if resume and os.path.exists(self.path):
            # Partial-trial resume: keep the prior attempt's rows and
            # append (the trainer continues from its epoch checkpoint).
            with open(self.path) as f:
                header = f.readline().strip()
            if header:
                self._keys = header.split(",")

    def __call__(self, **kwargs):
        self.last_result = dict(kwargs)
        row = {k: v for k, v in kwargs.items()
               if not isinstance(v, (list, dict))}
        row.setdefault("timestamp", time.time())
        if self._keys is None:
            self._keys = list(row.keys())
            with open(self.path, "w") as f:
                f.write(",".join(self._keys) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys)
                    + "\n")
        if kwargs.get("done"):
            raise StopTrial()


def _tag(i, config, grid_keys):
    parts = []
    for k in grid_keys:
        v = config[k]
        if isinstance(v, dict):
            v = ";".join(f"{a}-{b}" for a, b in v.items())
        parts.append(f"{k}={v}")
    return f"{i}_" + ",".join(parts) if parts else str(i)


def run(trainable, name, config, local_dir="./",
        resources_per_trial=None, trial_procs=1, isolate=None,
        resume=False):
    """tune.run equivalent: expand the grid and execute every trial.

    ``trainable`` is a registered name or a callable ``fn(config,
    reporter)``. Returns the list of checkpoint dicts (also persisted to
    experiment_state-*.json).

    ``isolate``: optional ``"module.path:TrainerClass"`` spec. When
    given, each trial runs in its OWN subprocess (``python -m
    multimodal_dmm_tpu_torch.experiments.tune --worker ...``) instead of
    in-process, so that no trial inherits the allocator and cache state
    of the trials before it; each pays a process start, which
    ``chip_smoke.py``'s phase 13 measures on the GPU.

    ``resume``: skip trials whose logdir already holds a completed
    ``last_result.json`` (done=True), reconstructing their checkpoint
    entries from disk — relaunching an interrupted sweep continues
    from the first unfinished trial instead of retraining the grid.
    A partially-trained trial (progress.csv but no completed
    last_result.json) continues from its latest epoch checkpoint
    (bit-exact vs the uninterrupted run; see Trainer.run_train).
    """
    if isinstance(trainable, str):
        fn = _REGISTRY[trainable]
        trainable_name = trainable
    else:
        fn = trainable
        trainable_name = getattr(trainable, "__name__", "trainable")

    exp_dir = os.path.join(local_dir, name)
    if not os.path.exists(exp_dir):
        os.makedirs(exp_dir)

    grid_keys = [k for k, v in config.items()
                 if isinstance(v, grid_search)]
    configs = expand_config(config)
    checkpoints = []
    root = os.getcwd()
    for i, trial_config in enumerate(configs):
        trial_id = "{}_{:05d}".format(name, i)
        tag = _tag(i, trial_config, grid_keys)
        logdir = os.path.join(os.path.abspath(exp_dir),
                              "{}_{}".format(trainable_name, tag))
        if not os.path.exists(logdir):
            os.makedirs(logdir)
        partial = False
        if resume:
            prior = _load_completed(logdir)
            if prior is not None:
                print("== Trial {} ({}) == [resume: already done]"
                      .format(trial_id, tag))
                checkpoints.append({
                    "trial_id": trial_id,
                    "experiment_tag": tag,
                    "logdir": logdir,
                    "status": "TERMINATED",
                    "config": copy.deepcopy(trial_config),
                    "last_result": prior,
                })
                _write_state(exp_dir, name, checkpoints)
                continue
            # Interrupted mid-trial: continue from the trainer's latest
            # epoch checkpoint instead of retraining from scratch.
            partial = os.path.exists(os.path.join(logdir,
                                                  "progress.csv"))
        with open(os.path.join(logdir, "params.json"), "w") as f:
            json.dump(trial_config, f, default=_json_default)
        print("== Trial {} ({}) =={}".format(
            trial_id, tag, " [resume: partial]" if partial else ""))
        reporter = Reporter(logdir, resume=partial)
        status = "TERMINATED"
        if isolate is not None:
            status, last_result = _run_trial_subprocess(
                isolate, logdir, resume_partial=partial)
        else:
            run_config = copy.deepcopy(trial_config)
            if partial:
                run_config["resume_trial"] = True
            try:
                os.chdir(logdir)
                fn(run_config, reporter)
            except StopTrial:
                pass  # trial self-terminated (done=True / NaN loss)
            except Exception as e:  # failure should not kill the sweep
                print("Trial {} errored: {!r}".format(trial_id, e))
                status = "ERROR"
            finally:
                os.chdir(root)
            last_result = reporter.last_result
            with open(os.path.join(logdir, "last_result.json"),
                      "w") as f:
                json.dump({k: v for k, v in last_result.items()
                           if not isinstance(v, (list, dict))},
                          f, default=_json_default)
        checkpoints.append({
            "trial_id": trial_id,
            "experiment_tag": tag,
            "logdir": logdir,
            "status": status,
            "config": copy.deepcopy(trial_config),
            "last_result": last_result,
        })
        _write_state(exp_dir, name, checkpoints)
    return checkpoints


def exit_on_errors(checkpoints, name):
    """SystemExit(1) if any trial in the sweep ended with status ERROR.

    Trial failures never abort a sweep (every remaining trial still
    runs — tune.run swallows per-trial exceptions by design); this
    helper makes the failure visible at the PROCESS edge so pipelines
    gating on exit codes cannot stamp a half-failed grid as done, and
    so the post-run analysis of an incomplete grid never runs."""
    errs = [c["trial_id"] for c in checkpoints
            if c.get("status") == "ERROR"]
    if errs:
        print("sweep '{}': {}/{} trial(s) ERRORED: {}".format(
            name, len(errs), len(checkpoints), ", ".join(errs)))
        raise SystemExit(1)


def _load_completed(logdir):
    """Return the prior last_result dict if this trial finished
    (last_result.json present with done=True), else None."""
    lr_path = os.path.join(logdir, "last_result.json")
    if not os.path.exists(lr_path):
        return None
    try:
        with open(lr_path) as f:
            last = json.load(f)
    except ValueError:
        return None
    return last if last.get("done") else None


def _run_trial_subprocess(spec, logdir, resume_partial=False):
    """Execute one trial in a fresh interpreter; the worker reads
    ``params.json`` (already written), runs ``TrainerClass.tune``, and
    leaves ``last_result.json`` behind. ``resume_partial`` continues an
    interrupted trial from its latest epoch checkpoint (the env var is
    read by Trainer.run_train and the worker's Reporter)."""
    import subprocess
    import sys
    cmd = [sys.executable, "-m",
           "multimodal_dmm_tpu_torch.experiments.tune",
           "--worker", spec, "--logdir", logdir]
    env = dict(os.environ)
    if resume_partial:
        env["MDMM_RESUME_TRIAL"] = "1"
    else:
        env.pop("MDMM_RESUME_TRIAL", None)
    proc = subprocess.run(cmd, env=env)
    lr_path = os.path.join(logdir, "last_result.json")
    last_result = {}
    if os.path.exists(lr_path):
        try:
            with open(lr_path) as f:
                last_result = json.load(f)
        except ValueError:
            pass
    status = "TERMINATED" if proc.returncode == 0 else "ERROR"
    if proc.returncode != 0:
        print("Trial subprocess rc={} ({})".format(proc.returncode,
                                                   logdir))
    return status, last_result


def _worker_main(spec, logdir):
    """--worker entry: run one trial in this process."""
    import importlib
    mod_name, cls_name = spec.split(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    with open(os.path.join(logdir, "params.json")) as f:
        config = json.load(f)
    reporter = Reporter(
        logdir, resume=os.environ.get("MDMM_RESUME_TRIAL") == "1")
    status = 0
    os.chdir(logdir)
    try:
        cls.tune(config, reporter)
    except StopTrial:
        pass
    except Exception as e:
        print("worker trial errored: {!r}".format(e))
        status = 1
    with open(os.path.join(logdir, "last_result.json"), "w") as f:
        json.dump({k: v for k, v in reporter.last_result.items()
                   if not isinstance(v, (list, dict))}, f, default=_json_default)
    return status


def _write_state(exp_dir, name, checkpoints):
    # Ray 0.7 stored the trial config both at the checkpoint top level
    # AND inside last_result — the reference analysis relies on both
    # layouts (`trial['method']` unprefixed from the former,
    # `trial['config:corrupt:uniform']` from the latter after
    # flattening). Reproduce that contract.
    out = []
    for c in checkpoints:
        last = {k2: v2 for k2, v2 in c["last_result"].items()
                if not isinstance(v2, (list, dict))}
        last["config"] = copy.deepcopy(c["config"])
        entry = {k: v for k, v in c.items() if k != "last_result"}
        entry["last_result"] = last
        out.append(entry)
    state = {
        "checkpoints": out,
        "runner_data": {"name": name},
        "stats": {"timestamp": time.time()},
    }
    path = os.path.join(exp_dir, "experiment_state-{}.json".format(name))
    with open(path, "w") as f:
        json.dump(state, f, default=_json_default)


if __name__ == "__main__":
    import argparse
    import sys
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True,
                    help="module.path:TrainerClass spec")
    ap.add_argument("--logdir", required=True)
    a = ap.parse_args()
    sys.exit(_worker_main(a.worker, a.logdir))
