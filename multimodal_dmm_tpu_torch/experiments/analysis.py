"""Experiment results analysis (counterpart of
multimodal_dmm_tpu/experiments/analysis.py, a vendored Ray 0.7.2
ExperimentAnalysis): reads ``experiment_state-*.json`` plus each trial's
``progress.csv`` into tables with the same flattened-key layout
(``config:corrupt:uniform`` style columns). The tables are ``table.Table``,
not pandas frames, so that the analysis runs where pandas is not
installed.
"""

import copy
import glob
import json
import os

from .table import Table, read_csv

UNNEST_KEYS = ("config", "last_result")


class TuneError(Exception):
    pass


def flatten_dict(dt, delimiter=":"):
    dt = copy.deepcopy(dt)
    while any(isinstance(v, dict) for v in dt.values()):
        remove, add = [], {}
        for key, value in dt.items():
            if isinstance(value, dict):
                for subkey, v in value.items():
                    add[delimiter.join([key, str(subkey)])] = v
                remove.append(key)
        dt.update(add)
        for k in remove:
            del dt[k]
    return dt


def unnest_checkpoints(checkpoints):
    out = []
    for g in checkpoints:
        checkpoint = copy.deepcopy(g)
        for key in UNNEST_KEYS:
            if key not in checkpoint:
                continue
            try:
                checkpoint.update(flatten_dict(checkpoint.pop(key)))
            except Exception:
                pass
        out.append(flatten_dict(checkpoint))
    return out


class ExperimentAnalysis:
    """Analyze results from an experiment directory."""

    def __init__(self, experiment_path, trials=None):
        experiment_path = os.path.expanduser(experiment_path)
        if not os.path.isdir(experiment_path):
            raise TuneError(
                "{} is not a valid directory.".format(experiment_path))
        paths = glob.glob(os.path.join(experiment_path,
                                       "experiment_state*.json"))
        if not paths:
            raise TuneError("No experiment state found in {}!".format(
                experiment_path))
        with open(max(paths)) as f:
            self._experiment_state = json.load(f)
        if "checkpoints" not in self._experiment_state:
            raise TuneError(
                "Experiment state invalid; no checkpoints found.")
        self._checkpoints = self._experiment_state["checkpoints"]
        self._scrubbed_checkpoints = unnest_checkpoints(self._checkpoints)
        self.trials = trials
        self._dataframe = None

    def get_all_trial_dataframes(self):
        dfs = {}
        for checkpoint in self._checkpoints:
            logdir = checkpoint["logdir"].replace('[', '[[]')
            progress = max(glob.glob(os.path.join(logdir,
                                                  "progress.csv")))
            dfs[checkpoint["trial_id"]] = read_csv(progress)
        return dfs

    def dataframe(self, refresh=False):
        if self._dataframe is None or refresh:
            self._dataframe = Table(self._scrubbed_checkpoints)
        return self._dataframe

    def stats(self):
        return self._experiment_state.get("stats")

    def runner_data(self):
        return self._experiment_state.get("runner_data")

    def trial_dataframe(self, trial_id):
        for checkpoint in self._checkpoints:
            if checkpoint["trial_id"] == trial_id:
                logdir = checkpoint["logdir"].replace('[', '[[]')
                progress = max(glob.glob(
                    os.path.join(logdir, "progress.csv")))
                return read_csv(progress)
        raise ValueError("Trial id {} not found".format(trial_id))

    def get_best_trainable(self, metric, trainable_cls, mode="max"):
        return trainable_cls(config=self.get_best_config(metric, mode))

    def get_best_config(self, metric, mode="max"):
        rows = self._retrieve_rows(metric=metric, mode=mode)
        best_path = self._get_best_path(metric, mode)
        return rows[best_path]["config"] if best_path else None

    def get_best_logdir(self, metric, mode="max"):
        df = self.dataframe()
        if mode == "max":
            return df.iloc[df[metric].idxmax()].logdir
        return df.iloc[df[metric].idxmin()].logdir

    def _retrieve_rows(self, metric=None, mode=None):
        rows = {}
        for checkpoint in self._checkpoints:
            rows[checkpoint["logdir"]] = checkpoint
        return rows

    def _get_best_path(self, metric, mode):
        df = self.dataframe()
        key = "last_result:" + metric if \
            ("last_result:" + metric) in df.columns else metric
        if key not in df.columns:
            return None
        idx = df[key].idxmax() if mode == "max" else df[key].idxmin()
        return df.iloc[idx].logdir


def merge_experiment_states(src_dirs, out_dir):
    """Concatenate the checkpoints of several experiment dirs into one.

    Writes ``out_dir/experiment_state-merged.json`` whose checkpoints
    are the union of the sources' (logdirs are absolute, so the trial
    progress stays readable in place). Lets a widened sweep (e.g. the
    spirals_partial 10-level curve run as two grids in different
    rounds) be analyzed as one experiment, matching the reference's
    single-sweep layout.
    Trial ids are prefixed with the source experiment name to stay
    unique across sources.
    """
    merged = []
    for d in src_dirs:
        paths = glob.glob(os.path.join(d, "experiment_state*.json"))
        if not paths:
            raise TuneError("No experiment state found in {}!".format(d))
        with open(max(paths)) as f:
            state = json.load(f)
        tag = os.path.basename(os.path.normpath(d))
        for ck in state["checkpoints"]:
            ck = copy.deepcopy(ck)
            ck["trial_id"] = "{}:{}".format(tag, ck["trial_id"])
            merged.append(ck)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "experiment_state-merged.json")
    with open(out_path, "w") as f:
        json.dump({"checkpoints": merged}, f)
    return out_path


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(
        description="merge experiment states for joint analysis")
    parser.add_argument("--merge", nargs="+", metavar="DIR",
                        help="source experiment directories")
    parser.add_argument("--out", type=str, metavar="DIR",
                        help="destination experiment directory")
    args = parser.parse_args()
    if args.merge:
        print(merge_experiment_states(args.merge, args.out))
