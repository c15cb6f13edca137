"""Evaluation and trials across the ranks of ``--mesh`` on the CPU (gloo
ranks started by the port's launcher), against the port's own single
process on the same weights and seeds:

- ``Trainer.evaluate`` (the collect path, tasks composed with numpy) and
  ``_evaluate_device`` (tasks composed on the device) under ``--mesh 2``
  and ``2x2``: MAP and sampled filters, batches whose columns the data
  axis divides (each rank runs its block) and batches it does not divide
  (every rank runs the whole batch), the DKS and VRNN baselines (under 2:
  they have no variant axis), and the Weizmann model's conv codecs on the
  collect path. Every per-sequence and summed metric on every rank within
  ``RTOL`` of the single process, the reconstructions too, and every
  rank's generator left in the single process's state;
- ``apps.spirals --mesh 2 --evaluate`` and ``--find_best`` give the single
  process's metrics, best epoch and ``best.pth``;
- a one-epoch spirals trial through ``experiments.tune.run`` under
  ``mesh: "2"``, in this process and in a worker process, writes the
  single process's ``progress.csv`` rows (same columns, losses within
  ``RTOL``) and stops on ``done``;
- a rank that raises ends the trial at once with that rank's exception.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from multimodal_dmm_tpu_torch.apps import spirals as ts
from multimodal_dmm_tpu_torch.data import spirals as tsp
from multimodal_dmm_tpu_torch.experiments import tune
from multimodal_dmm_tpu_torch.parallel import launch, parse_mesh
from multimodal_dmm_tpu_torch.training import checkpoint as tck

import torch_mesh_eval_ranks as ranks

RTOL = 1e-5
SAMPLED = {"flt_particles": 4}
# name -> evaluate()'s arguments. Two data ranks divide 4 columns and not
# 5; the 10 sequences leave ghost columns in the last batch of 4.
JOBS = {
    "dmm_map_device_div": dict(model="dmm", path="device", eval_args={},
                               batch_size=4),
    "dmm_sampled_device_div": dict(model="dmm", path="device",
                                   eval_args=SAMPLED, batch_size=4),
    "dmm_sampled_device_rep": dict(model="dmm", path="device",
                                   eval_args=SAMPLED, batch_size=5),
    "dmm_sampled_host_div": dict(model="dmm", path="host",
                                 eval_args=SAMPLED, batch_size=4),
    "dmm_map_host_rep": dict(model="dmm", path="host", eval_args={},
                             batch_size=5),
    "dks_device_div": dict(model="dks", path="device", eval_args={},
                           batch_size=4),
    "dks_host_rep": dict(model="dks", path="host", eval_args={},
                         batch_size=5),
    "vrnn_device_div": dict(model="vrnn", path="device", eval_args={},
                            batch_size=4),
    "weizmann_sampled_host_div": dict(model="weizmann", path="host",
                                      eval_args={"flt_particles": 3},
                                      batch_size=2),
}
# The baselines have no stacked-variant axis for a 2-D mesh.
MESH_JOBS = {"2": sorted(JOBS),
             "2x2": sorted(j for j in JOBS if j.startswith(("dmm", "weiz")))}


@pytest.fixture(scope="module")
def single():
    return ranks.eval_jobs(sorted(JOBS.items()), "1")


@pytest.fixture(scope="module")
def mesh_runs():
    """mesh -> [each rank's {job: result}], each mesh launched once."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            n_data, n_model = parse_mesh(mesh)
            jobs = [(name, JOBS[name]) for name in MESH_JOBS[mesh]]
            runs[mesh] = launch(ranks.eval_jobs, ["cpu"] * (n_data * n_model),
                                "gloo", args=(jobs, mesh),
                                timeout=ranks.TIMEOUT)
        return runs[mesh]
    return get


@pytest.mark.parametrize("mesh,job", [(m, j) for m in MESH_JOBS
                                      for j in MESH_JOBS[m]])
def test_evaluation_matches_the_single_process(single, mesh_runs, mesh,
                                               job):
    exp = single[job]
    for rank, out in enumerate(mesh_runs(mesh)):
        got = out[job]
        assert got["metrics"].keys() == exp["metrics"].keys()
        for key, val in exp["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], val, rtol=RTOL,
                                       err_msg="rank %d %s" % (rank, key))
        for key, val in exp["summary"].items():
            np.testing.assert_allclose(got["summary"][key], val, rtol=RTOL,
                                       err_msg="rank %d %s" % (rank, key))
        assert np.array_equal(got["gen"], exp["gen"]), rank
        for m, seqs in exp.get("recon", {}).items():
            for a, b in zip(got["recon"][m], seqs):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# The command line and the trial runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spirals_data"))
    tsp.gen_dataset(n_examples=14, n_train=8, timesteps=12, data_dir=d)
    return d


def _argv(data_dir, save_dir, *extra):
    return ["--device", "cpu", "--data_dir", data_dir, "--save_dir",
            str(save_dir), "--epochs", "2", "--batch_size", "4", "--seed",
            "3", "--eval_freq", "1", "--save_freq", "1", "--method", "bfvi",
            "--eval_args", "{flt_particles: 4}"] + list(extra)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """A two-epoch single-process run's save directory."""
    tmp = tmp_path_factory.mktemp("trained")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        ts.main(_argv(corpus, tmp / "save"))
    return tmp / "save"


def _close(got, exp):
    assert got.keys() == exp.keys()
    for key in exp:
        np.testing.assert_allclose(got[key], exp[key], rtol=RTOL,
                                   err_msg=key)


def test_cli_evaluate_under_a_mesh(corpus, trained, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--load", str(trained / "last.pth"), "--evaluate"]
    exp = ts.main(_argv(corpus, trained, *flags))
    got = ts.main(_argv(corpus, trained, *flags, "--mesh", "2"))
    for g, e in zip(got, exp):
        _close(g, dict(e))


def test_cli_find_best_under_a_mesh(corpus, trained, tmp_path,
                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = {}
    for mesh in ("1", "2"):
        save = tmp_path / mesh
        shutil.copytree(trained, save)
        (save / "best.pth").unlink()
        epoch, metrics = ts.main(_argv(corpus, save, "--find_best",
                                       "--mesh", mesh))
        out[mesh] = epoch, dict(metrics), tck.load_checkpoint(
            str(save / "best.pth"))
    assert out["2"][0] == out["1"][0] in (1, 2)
    _close(out["2"][1], out["1"][1])
    assert _leaves(out["1"][2]["params"])
    for key in ("params", "state"):
        got, exp = (_leaves(out[m][2][key]) for m in ("2", "1"))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _rows(logdir):
    with open(os.path.join(logdir, "progress.csv")) as f:
        lines = f.read().splitlines()
    header = lines[0].split(",")
    return header, [dict(zip(header, line.split(","))) for line in lines[1:]]


@pytest.fixture(scope="module")
def trials(corpus, tmp_path_factory):
    """mesh / isolation -> the trial's progress.csv (header, rows) and its
    checkpoint entry; one epoch of 8 spirals."""
    root = tmp_path_factory.mktemp("trials")
    config = {"device": "cpu", "data_dir": corpus, "epochs": 1,
              "eval_freq": 1, "save_freq": 1, "batch_size": 4, "seed": 3,
              "method": "bfvi", "eval_args": {"flt_particles": 4}}
    out = {}
    for key, mesh, isolate in (
            ("single", "1", None), ("mesh", "2", None),
            ("mesh_worker", "2",
             "multimodal_dmm_tpu_torch.apps.spirals:SpiralsTrainer")):
        ck = tune.run(ts.SpiralsTrainer.tune, key, dict(config, mesh=mesh),
                      local_dir=str(root), isolate=isolate)
        out[key] = _rows(ck[0]["logdir"]), ck[0]
    return out


@pytest.mark.parametrize("key", ["mesh", "mesh_worker"])
def test_trial_under_a_mesh_writes_the_single_process_rows(trials, key):
    (header, rows), ck = trials[key]
    (exp_header, exp_rows), _ = trials["single"]
    assert ck["status"] == "TERMINATED"
    assert header == exp_header and len(rows) == len(exp_rows) == 2
    assert [r["done"] for r in rows] == ["False", "True"]
    for row, exp in zip(rows, exp_rows):
        for col in header:
            if col in ("timestamp", "done"):
                continue
            np.testing.assert_allclose(float(row[col]), float(exp[col]),
                                       rtol=RTOL, err_msg=col)
    assert ck["last_result"]["done"] is True
    np.testing.assert_allclose(ck["last_result"]["mean_loss"],
                               float(exp_rows[-1]["mean_loss"]), rtol=RTOL)


def test_a_rank_that_raises_ends_the_trial(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = {"device": "cpu", "data_dir": corpus, "epochs": 1,
              "batch_size": 4, "mesh": "2", "save_dir": str(tmp_path)}
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        ranks.FailingSpiralsTrainer.tune(config, lambda **kw: None)
    assert time.perf_counter() - t0 < ranks.TIMEOUT / 2
    ck = tune.run(ranks.FailingSpiralsTrainer.tune, "failing", config,
                  local_dir=str(tmp_path))
    assert ck[0]["status"] == "ERROR"
    assert torch.distributed.is_initialized() is False
