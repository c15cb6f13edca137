"""The port's experiment layer with real trainings at tiny sizes on the
CPU: ``Trainer.tune`` reporting numbers, an isolated worker, a suite's
task evaluation of one checkpoint against the JAX suite's (the filter
noise injected where the method samples), ``run_find`` against JAX's, and
a partial-data grid from its command line."""

import csv
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_dmm_tpu.apps.spirals import SpiralsTrainer as JSpirals
from multimodal_dmm_tpu.experiments import spirals_suite as jsuite
from multimodal_dmm_tpu.training import trainer as jtrainer
from multimodal_dmm_tpu_torch.apps import spirals as ts
from multimodal_dmm_tpu_torch.data import spirals as tsp
from multimodal_dmm_tpu_torch.experiments import spirals_suite as tsuite
from multimodal_dmm_tpu_torch.experiments import tune as ttune
from multimodal_dmm_tpu_torch.models import dmm as tdmm
from multimodal_dmm_tpu_torch.training import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "multimodal_dmm_tpu_torch.apps.spirals:SpiralsTrainer"


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """param_hist.tsv goes to the working directory."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spirals_data"))
    tsp.gen_dataset(n_examples=14, n_train=8, timesteps=16, data_dir=d)
    return d


def _config(data_dir, **over):
    cfg = {"data_dir": data_dir, "device": "cpu", "epochs": 2,
           "eval_freq": 1, "save_freq": 1, "batch_size": 4, "lr": 5e-3,
           "eval_args": {"flt_particles": 4}}
    cfg.update(over)
    return cfg


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


def test_tune_reports_numbers(tiny_env):
    """``Trainer.tune`` trains from a trial config and reports after each
    evaluation and at the end, every value a Python or numpy number (a
    tensor would reach progress.csv as ``tensor(...)``)."""
    calls = []
    ts.SpiralsTrainer.tune(_config(tiny_env, method="bfvi", seed=0),
                           lambda **kw: calls.append(kw))
    assert [c["training_iteration"] for c in calls] == [1, 2, 2]
    assert [c["done"] for c in calls] == [False, False, True]
    for c in calls:
        for k, v in c.items():
            assert isinstance(v, (bool, int, float, np.number)), (k, type(v))
        assert np.isfinite(c["mean_loss"]) and c["mean_loss"] == c["mse"]
    assert os.path.exists(os.path.join("spirals_save", "best.pth"))


def test_isolated_worker_trains_a_trial(tiny_env, tmp_path, monkeypatch):
    """One isolated trial: the port's worker process trains it from its
    params.json and leaves the runner's files and the checkpoints in the
    trial directory."""
    monkeypatch.setenv("PYTHONPATH", _env()["PYTHONPATH"])
    ttune.register_trainable("spirals_tune",
                             lambda c, r: ts.SpiralsTrainer.tune(c, r))
    (ck,) = ttune.run("spirals_tune", "iso",
                      _config(tiny_env, method="bfvi", seed=0),
                      str(tmp_path), isolate=SPEC)
    assert ck["status"] == "TERMINATED" and ck["last_result"]["done"]
    with open(os.path.join(ck["logdir"], "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    assert all(np.isfinite(float(r["mean_loss"])) for r in rows)
    assert sorted(os.listdir(os.path.join(ck["logdir"], "spirals_save"))) \
        == ["best.pth", "epoch_1.pth", "epoch_2.pth", "last.pth"]


@pytest.fixture(scope="module")
def trained_trials(tiny_env, tmp_path_factory):
    """Two tiny spirals trials (bfvi, f-mask) trained in the port through
    its runner; {method: (trial_dir, trial_config)}."""
    root = str(tmp_path_factory.mktemp("trials"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ckpts = ttune.run(
            lambda c, r: ts.SpiralsTrainer.tune(c, r), "suite",
            dict(_config(tiny_env, seed=0),
                 method=ttune.grid_search(["bfvi", "f-mask"])), root)
    finally:
        os.chdir(cwd)
    assert all(c["status"] == "TERMINATED" for c in ckpts)
    return {c["config"]["method"]: (c["logdir"], c["config"])
            for c in ckpts}


@pytest.mark.parametrize("method", ["bfvi", "f-mask"])
def test_suite_evaluate_matches_jax(trained_trials, monkeypatch, method):
    """The port's ``spirals_suite.evaluate`` and JAX's on the best.pth the
    port wrote (JAX's format 2), with JAX's filter noise injected into
    the port where the method samples (BFVI's particle filter): the
    deterministic tasks' MSEs and stds within rtol 1e-4 / atol 1e-5.
    ``half`` deletes half of each sequence's steps at random, from each
    framework's own generator, so it is checked only for being finite."""
    trial_dir, config = trained_trials[method]
    n_particles = config["eval_args"]["flt_particles"]
    eps = []
    get_task_eval = jtrainer.Trainer._get_task_eval

    def recording(self, *a, **kw):
        fn = get_task_eval(self, *a, **kw)

        def call(params, state, targets, mask, lengths, rng, *rest):
            if hasattr(self.model, "_filter_eps"):
                k_flt = jax.random.split(jax.random.split(rng)[1], 4)[1]
                eps.append(np.asarray(self.model._filter_eps(
                    k_flt, mask.shape[0], n_particles, mask.shape[1], True,
                    False)))
            return fn(params, state, targets, mask, lengths, rng, *rest)
        return call

    monkeypatch.setattr(jtrainer.Trainer, "_get_task_eval", recording)
    exp = jsuite.evaluate(dict(config), trial_dir)
    plain = tdmm.MultiDMM._filter_eps

    def injected(self, gen, t_len, n, b, do_sample, sample_init, device):
        if do_sample:
            e = eps.pop(0)
            assert e.shape == (t_len, n, b, self.z_dim)
            return torch.tensor(e, device=device)
        return plain(self, gen, t_len, n, b, do_sample, sample_init, device)

    monkeypatch.setattr(tdmm.MultiDMM, "_filter_eps", injected)
    n_eps = len(eps)
    got = tsuite.evaluate(dict(config), trial_dir)
    assert not eps and (n_eps > 0) == (method == "bfvi")
    _, _, test, test_std = got
    _, _, jtest, jtest_std = exp
    assert list(test) == list(jtest) == tsuite.TASKS
    for task in ("recon", "fwd", "bwd", "condgen"):
        np.testing.assert_allclose(test[task], jtest[task], rtol=1e-4,
                                   atol=1e-5, err_msg=task)
        np.testing.assert_allclose(test_std[task], jtest_std[task],
                                   rtol=1e-4, atol=1e-5, err_msg=task)
    assert np.isfinite(test["half"]) and np.isfinite(test_std["half"])


def test_run_find_picks_the_jax_best_epoch(tiny_env, tmp_path):
    """``--find_best`` over the epoch checkpoints of a port run, with a
    MAP evaluation (one filter particle, no random deletion): the port
    picks the epoch that JAX's ``run_find`` picks on the same files,
    rewrites best.pth with that epoch's weights and reports the same
    metrics (rtol 1e-4)."""
    common = ["--data_dir", tiny_env, "--batch_size", "4", "--seed", "2",
              "--method", "bfvi", "--eval_args", "{flt_particles: 1}",
              "--drop_frac", "0", "--epochs", "3", "--save_freq", "1",
              "--eval_freq", "1", "--lr", "5e-2"]
    save = tmp_path / "save"
    ts.main(common + ["--device", "cpu", "--save_dir", str(save)])
    shutil.copytree(save, tmp_path / "jsave")
    jargs = JSpirals.parser.parse_args(
        common + ["--save_dir", str(tmp_path / "jsave"), "--find_best"])
    jbest, jmetrics = JSpirals(jargs).run_find(jargs)
    before = os.stat(save / "best.pth").st_mtime_ns
    best, metrics = ts.main(common + ["--device", "cpu", "--save_dir",
                                      str(save), "--find_best"])
    assert best == jbest and 1 <= best <= 3
    assert os.stat(save / "best.pth").st_mtime_ns != before
    written = tck.load_checkpoint(str(save / "best.pth"))["params"]
    epoch = tck.load_checkpoint(str(save / "epoch_{}.pth".format(best)))
    for a, b in zip(jax.tree_util.tree_leaves(written),
                    jax.tree_util.tree_leaves(epoch["params"])):
        np.testing.assert_array_equal(a, b)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_partial_grid_from_its_command_line(tiny_env, tmp_path):
    """``python -m multimodal_dmm_tpu_torch.experiments.spirals_partial``
    trains two levels in process and writes the best-3 CSVs; ``--analyze``
    alone reads the grid again to the same CSVs."""
    cfg = ("{device: cpu, epochs: 1, eval_freq: 1, save_freq: 1, "
           "batch_size: 4, data_dir: %s, method: bfvi, "
           "eval_args: {flt_particles: 4}}" % tiny_env)
    cmd = [sys.executable, "-m",
           "multimodal_dmm_tpu_torch.experiments.spirals_partial",
           "--local_dir", str(tmp_path), "--config", cfg]
    proc = subprocess.run(cmd + ["--levels", "0.0", "0.5", "--n_repeats",
                                 "1", "--no_isolate"], capture_output=True,
                          text=True, env=_env(), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    exp_dir = tmp_path / "spirals_partial"
    first = {n: (exp_dir / n).read_text()
             for n in ("best_results.csv", "best_results_std.csv")}
    rows = list(csv.reader(first["best_results.csv"].splitlines()))
    assert rows[0] == ["loss", "mse", "rec_loss"] and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    std_rows = list(csv.reader(first["best_results_std.csv"].splitlines()))
    assert std_rows[1:] == [["", "", ""]] * 2  # one run per level
    for n in first:
        (exp_dir / n).unlink()
    proc = subprocess.run(cmd + ["--analyze"], capture_output=True,
                          text=True, env=_env(), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "== Trial" not in proc.stdout
    for n, text in first.items():
        assert (exp_dir / n).read_text() == text
