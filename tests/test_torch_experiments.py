"""The port's experiment layer against the JAX package's, without training:
grid expansion and trial tags, the trial runner's on-disk contract, errors
and resume (in process and isolated), the analysis without pandas (its
tables against the JAX package's pandas frames), the best-3 CSVs of the
partial-data and semi-supervised grids, and the three suites' aggregated
CSVs with each suite's task evaluation replaced by the same numbers in
both packages."""

import csv
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from multimodal_dmm_tpu.experiments import _partial_semisup as jps
from multimodal_dmm_tpu.experiments import analysis as jan
from multimodal_dmm_tpu.experiments import tune as jtune
from multimodal_dmm_tpu_torch.experiments import _partial_semisup as tps
from multimodal_dmm_tpu_torch.experiments import analysis as tan
from multimodal_dmm_tpu_torch.experiments import table as ttab
from multimodal_dmm_tpu_torch.experiments import tune as ttune

METHODS = ['bfvi', 'b-mask', 'f-mask', 'b-skip', 'f-skip']


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _grid_config(tune, which):
    g = tune.grid_search
    return {
        "flat": {"data_dir": "/d", "lr": 5e-3, "seed": g([0, 1, 2]),
                 "method": g(METHODS)},
        "dict": {"data_dir": "/d", "seed": g([0, 1]),
                 "corrupt": g([{"uniform": 0.0}, {"uniform": 0.5}]),
                 "lr": 5e-4},
        "semi": {"seed": g([0]), "corrupt": g(
            [{"semi": f, "modalities": ["action"]} for f in (0.0, 0.3)])},
        "none": {"lr": 5e-3, "method": "bfvi"},
    }[which]


@pytest.mark.parametrize("which", ["flat", "dict", "semi", "none"])
def test_expand_config_and_tags_match_jax(which):
    jcfg, tcfg = _grid_config(jtune, which), _grid_config(ttune, which)
    exp, got = jtune.expand_config(jcfg), ttune.expand_config(tcfg)
    assert got == exp
    keys = [k for k, v in tcfg.items() if isinstance(v, ttune.grid_search)]
    jkeys = [k for k, v in jcfg.items() if isinstance(v, jtune.grid_search)]
    assert keys == jkeys
    assert [ttune._tag(i, c, keys) for i, c in enumerate(got)] == \
        [jtune._tag(i, c, jkeys) for i, c in enumerate(exp)]


def dummy(config, reporter):
    """A deterministic trainable: numpy and Python floats, a list value
    (left out of progress.csv), done at its last report."""
    x = config["x"]
    for it in range(3):
        reporter(mean_loss=np.float32(2.5 - 0.5 * it + x),
                 best_loss=2.5 - 0.25 * it, mse=np.float64(0.125 * (it + 1)),
                 ssim=np.float32(0.75) if it != 1 else float("nan"),
                 training_iteration=it + 1, done=(it == 2), hist=[1, 2])


def _dummy_config(tune):
    return {"x": tune.grid_search([0, 1]), "method": "bfvi",
            "corrupt": tune.grid_search(
                [{"semi": 0.5, "modalities": ["action"]}])}


def _progress_rows(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return list(rows[0]), [{k: v for k, v in r.items() if k != "timestamp"}
                           for r in rows]


def _state(exp_dir):
    (path,) = glob.glob(os.path.join(exp_dir, "experiment_state-*.json"))
    with open(path) as f:
        state = json.load(f)
    state.pop("stats")
    for ck in state["checkpoints"]:
        ck["logdir"] = os.path.relpath(ck["logdir"], exp_dir)
    return os.path.basename(path), state


def test_runner_disk_contract_matches_jax(tmp_path):
    """The same trainable through both runners: the same trial
    directories (a dict-valued grid puts ``[`` in their names), params,
    progress rows (but their timestamps), last results and experiment
    state (but absolute paths and the timestamp)."""
    jtune.run(dummy, "exp", _dummy_config(jtune), str(tmp_path / "jax"))
    ttune.run(dummy, "exp", _dummy_config(ttune), str(tmp_path / "port"))
    jdir, tdir = str(tmp_path / "jax" / "exp"), str(tmp_path / "port" / "exp")
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    trials = [n for n in names if n.startswith("dummy_")]
    assert len(trials) == 2 and all("[" in n for n in trials)
    for n in trials:
        for fname in ("params.json", "last_result.json"):
            with open(os.path.join(jdir, n, fname)) as f:
                exp = json.load(f)
            with open(os.path.join(tdir, n, fname)) as f:
                assert json.load(f) == exp, (n, fname)
        header, rows = _progress_rows(os.path.join(tdir, n, "progress.csv"))
        assert (header, rows) == _progress_rows(
            os.path.join(jdir, n, "progress.csv"))
        assert "timestamp" in header and len(rows) == 3
    assert _state(tdir) == _state(jdir)


def test_trial_error_does_not_stop_the_sweep():
    def trainable(config, reporter):
        if config["x"] == 1:
            raise RuntimeError("boom")
        reporter(mean_loss=1.0, training_iteration=1, done=True)

    ckpts = ttune.run(trainable, "err", {"x": ttune.grid_search([0, 1, 2])})
    assert [c["status"] for c in ckpts] == ["TERMINATED", "ERROR",
                                            "TERMINATED"]
    with pytest.raises(SystemExit) as exc:
        ttune.exit_on_errors(ckpts, "err")
    assert exc.value.code == 1
    ttune.exit_on_errors([c for c in ckpts if c["status"] == "TERMINATED"],
                         "err")


def test_resume_in_process(tmp_path, capsys):
    """Completed trials are skipped (their results read back from disk);
    a partial one (progress.csv, no completed last_result.json) runs again
    with ``resume_trial`` and appends to its progress rows."""
    calls = []

    def trainable(config, reporter):
        calls.append((config["x"], config.get("resume_trial", False)))
        reporter(mean_loss=float(config["x"]), training_iteration=1,
                 done=True)

    cfg = {"x": ttune.grid_search([0, 1, 2])}
    ttune.run(trainable, "res", cfg)
    assert calls == [(0, False), (1, False), (2, False)]
    last = sorted((tmp_path / "res").glob("trainable_*"))[-1]
    (last / "last_result.json").unlink()
    calls.clear()
    capsys.readouterr()
    ckpts = ttune.run(trainable, "res", cfg, resume=True)
    out = capsys.readouterr().out
    assert out.count("[resume: already done]") == 2
    assert "[resume: partial]" in out
    assert calls == [(2, True)]
    assert [c["status"] for c in ckpts] == ["TERMINATED"] * 3
    assert [c["last_result"]["mean_loss"] for c in ckpts] == [0.0, 1.0, 2.0]
    with open(last / "progress.csv") as f:
        assert len(f.read().splitlines()) == 3  # the header, two rows


def test_isolated_trials_start_the_port_worker(tmp_path, monkeypatch):
    """An isolated trial runs ``python -m
    multimodal_dmm_tpu_torch.experiments.tune --worker SPEC``; a partial
    one gets ``MDMM_RESUME_TRIAL=1``, a fresh one none; a worker that
    fails leaves the trial in ERROR."""
    calls = []
    rcs = iter([0, 3, 0])

    def fake_run(cmd, env=None, **kw):
        calls.append((cmd, env))
        logdir = cmd[cmd.index("--logdir") + 1]
        with open(os.path.join(logdir, "last_result.json"), "w") as f:
            json.dump({"mean_loss": 1.0, "done": True}, f)
        return subprocess.CompletedProcess(cmd, next(rcs))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setenv("MDMM_RESUME_TRIAL", "1")
    spec = "multimodal_dmm_tpu_torch.apps.spirals:SpiralsTrainer"
    cfg = {"seed": ttune.grid_search([0, 1])}
    ckpts = ttune.run(dummy, "iso", cfg, isolate=spec)
    assert [c["status"] for c in ckpts] == ["TERMINATED", "ERROR"]
    for cmd, env in calls:
        assert cmd[:5] == [sys.executable, "-m",
                           "multimodal_dmm_tpu_torch.experiments.tune",
                           "--worker", spec]
        assert "MDMM_RESUME_TRIAL" not in env
    logdir = calls[1][0][-1]
    os.remove(os.path.join(logdir, "last_result.json"))
    with open(os.path.join(logdir, "progress.csv"), "w") as f:
        f.write("mean_loss,done\n1.0,False\n")
    calls.clear()
    ckpts = ttune.run(dummy, "iso", cfg, isolate=spec, resume=True)
    assert len(calls) == 1 and calls[0][1]["MDMM_RESUME_TRIAL"] == "1"
    assert [c["status"] for c in ckpts] == ["TERMINATED"] * 2


# ---------------------------------------------------------------------------
# The analysis without pandas
# ---------------------------------------------------------------------------

def assert_table_equals_frame(tab, df, dtypes=False):
    """Column by column and row label by row label, NaN-aware, exact; the
    17-digit timestamps that progress.csv holds within 1e-15, because
    pandas' parser is not round-trip exact (the port's is)."""
    assert tab.columns == [str(c) for c in df.columns]
    assert tab.index == list(df.index)
    for c in df.columns:
        exp = df[c].tolist()
        got = tab[c].tolist()
        assert len(got) == len(exp)
        if c == "timestamp":
            np.testing.assert_allclose(got, exp, rtol=1e-15, atol=0)
            continue
        for g, e in zip(got, exp):
            if isinstance(e, float) and e != e:
                assert ttab.isna(g), (c, g, e)
            else:
                assert g == e, (c, g, e)
        if dtypes:
            kind = {"int": "int64", "float64": "float64", "bool": "bool",
                    "float32": "float32"}.get(ttab._kind(got), "object")
            assert kind == str(df[c].dtype) or kind == "object", c


def _experiment(tmp_path, name, tune):
    tune.run(dummy, name, _dummy_config(tune), str(tmp_path))
    return str(tmp_path / name)


def test_analysis_tables_equal_pandas_frames(tmp_path, monkeypatch):
    """With pandas unavailable, the port's ``dataframe()``,
    ``trial_dataframe()`` and ``get_all_trial_dataframes()`` read an
    experiment (written by the port's runner) to the values of JAX's
    pandas frames; floats written as short decimals, which pandas' parser
    also reads exactly."""
    exp_dir = _experiment(tmp_path, "ana", ttune)
    monkeypatch.setitem(sys.modules, "pandas", None)
    ea = tan.ExperimentAnalysis(exp_dir)
    tab = ea.dataframe()
    trial_tabs = {tid: ea.trial_dataframe(tid) for tid in tab["trial_id"]}
    all_tabs = ea.get_all_trial_dataframes()
    monkeypatch.delitem(sys.modules, "pandas")
    jea = jan.ExperimentAnalysis(exp_dir)
    df = jea.dataframe()
    assert "config:corrupt:semi" in tab.columns and "method" in tab.columns
    assert_table_equals_frame(tab, df)
    assert list(trial_tabs) == list(df["trial_id"])
    for tid, t in trial_tabs.items():
        jdf = jea.trial_dataframe(tid)
        assert_table_equals_frame(t, jdf, dtypes=True)
        assert_table_equals_frame(all_tabs[tid], jdf)
        assert t.mean_loss.idxmin() == jdf.mean_loss.idxmin() == 2
        assert t.ssim.idxmax() == jdf.ssim.idxmax() == 0
    assert ea.stats() == jea.stats() and ea.runner_data() == \
        jea.runner_data()
    with pytest.raises(ValueError):
        ea.trial_dataframe("nope")


@pytest.mark.parametrize("mode", ["min", "max"])
def test_best_config_and_logdir_match_jax(tmp_path, mode):
    exp_dir = _experiment(tmp_path, "best", ttune)
    ea, jea = tan.ExperimentAnalysis(exp_dir), jan.ExperimentAnalysis(exp_dir)
    for metric in ("mean_loss", "training_iteration"):
        assert ea.get_best_config(metric, mode) == \
            jea.get_best_config(metric, mode)
        assert ea.get_best_logdir(metric, mode) == \
            jea.get_best_logdir(metric, mode)
    assert ea.get_best_config("mean_loss", mode)["x"] == \
        (0 if mode == "min" else 1)
    assert ea.get_best_config("no_such_metric", mode) is None


def test_merge_experiment_states_matches_jax(tmp_path):
    a = _experiment(tmp_path, "exp_a", ttune)
    b = _experiment(tmp_path, "exp_b", ttune)
    out_t = tan.merge_experiment_states([a, b], str(tmp_path / "m_port"))
    out_j = jan.merge_experiment_states([a, b], str(tmp_path / "m_jax"))
    with open(out_t) as f, open(out_j) as g:
        assert json.load(f) == json.load(g)
    ea = tan.ExperimentAnalysis(str(tmp_path / "m_port"))
    tab = ea.dataframe()
    assert_table_equals_frame(
        tab, jan.ExperimentAnalysis(str(tmp_path / "m_jax")).dataframe())
    assert len(tab) == 4 and len(set(tab["trial_id"])) == 4
    for tid in tab["trial_id"]:
        assert len(ea.trial_dataframe(tid)) == 3
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_dmm_tpu_torch.experiments.analysis",
         "--merge", a, b, "--out", str(tmp_path / "m_cli")],
        capture_output=True, text=True, env=_env())
    assert proc.returncode == 0, proc.stderr
    with open(proc.stdout.strip()) as f, open(out_j) as g:
        assert json.load(f) == json.load(g)


def _env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


# ---------------------------------------------------------------------------
# The table against pandas
# ---------------------------------------------------------------------------

def test_read_csv_types_like_pandas(tmp_path):
    path = str(tmp_path / "p.csv")
    with open(path, "w") as f:
        f.write("i,f,b,s,e,n,m,big\n"
                "1,2.5,True,x,,nan,3,0.25\n"
                "-2,1e-05,False,y z,,,4,1.5e+300\n"
                "\n"
                "3,-inf,True,1a,,NaN,,2\n")
    assert_table_equals_frame(ttab.read_csv(path), pd.read_csv(path),
                              dtypes=True)
    # Every shortest repr reads back exactly (pandas' parser can be a
    # unit in the last place off: 0.30000000000000004 gives 0.3 there).
    vals = np.random.RandomState(0).randn(1000) * 1e3
    with open(path, "w") as f:
        f.write("v\n" + "\n".join(repr(v) for v in vals.tolist()) + "\n")
    assert ttab.read_csv(path)["v"].tolist() == vals.tolist()
    with open(path, "w") as f:
        f.write("")
    with pytest.raises(ttab.EmptyDataError):
        ttab.read_csv(path)
    with pytest.raises(pd.errors.EmptyDataError):
        pd.read_csv(path)


def test_groupby_sort_and_to_csv_like_pandas(tmp_path):
    """``sort_values``, ``groupby(...).head/mean/std`` and ``to_csv`` (with
    and without the index) write pandas' text, bit for bit: float64, int
    and float32 columns, NaN skipped, a group of one (std NaN), string and
    float keys."""
    rng = np.random.RandomState(0)
    for trial in range(40):
        n = rng.randint(2, 13)
        keys = (list(rng.choice(METHODS, n)) if trial % 2 else
                [float(k) for k in rng.randint(0, 4, n) / 10])
        a = (rng.randn(n) * 10.0 ** rng.randint(-3, 5)).tolist()
        a[rng.randint(n)] = float("nan")
        b = [np.float32(v) for v in rng.randn(n) * 10.0 ** rng.randint(-4, 4)]
        c = [int(v) for v in rng.randint(-5, 5, n)]
        data = {"a": a, "b": b, "c": c, "key": keys}
        tab, df = ttab.Table(data), pd.DataFrame(data)
        outs = [
            (tab.groupby("key").mean(), df.groupby("key").mean(), True),
            (tab[["a", "c", "key"]].groupby("key").std(),
             df[["a", "c", "key"]].groupby("key").std(), True),
            (tab.sort_values(by="a").groupby("key").head(2),
             df.sort_values(by="a").groupby("key").head(2), False),
            (tab, df, False)]
        for i, (t, d, index) in enumerate(outs):
            t.to_csv(str(tmp_path / "t.csv"), index=index)
            d.to_csv(str(tmp_path / "d.csv"), index=index)
            with open(tmp_path / "t.csv") as f, open(tmp_path / "d.csv") as g:
                assert f.read() == g.read(), (trial, i)
        srt = tab.sort_values(["a"])
        assert srt.index == list(df.sort_values(["a"]).index)
        assert tab.a.idxmin() == df.a.idxmin()


# ---------------------------------------------------------------------------
# The best-3 CSVs of the partial-data and semi-supervised grids
# ---------------------------------------------------------------------------

def _levels_trainable(corrupt_key):
    def trainable(config, reporter):
        rng = np.random.RandomState(17 * config["seed"] + int(
            10 * config["corrupt"][corrupt_key]))
        for it in range(4):
            loss = float(rng.rand() * 10)
            if config["seed"] == 1 and it == 0:
                loss = float("nan")  # skipped by idxmin
            rec = float(rng.rand())
            if config["seed"] == 2 and it == 3:
                rec = float("nan")
            reporter(mean_loss=loss, best_loss=loss, mse=rng.rand(),
                     rec_loss=rec, training_iteration=it + 1,
                     done=it == 3)
    return trainable


@pytest.mark.parametrize("corrupt_key", ["uniform", "semi"])
def test_analyze_best3_csvs_match_jax(tmp_path, corrupt_key):
    """Three levels × four seeds with known per-epoch metrics (one NaN
    loss, one NaN metric, no tied losses): the port's best_results.csv and
    best_results_std.csv against JAX's, the same header and values within
    rtol 1e-12 (pandas' float parser is not round-trip exact)."""
    grid = [({corrupt_key: f, "modalities": ["spiral-y"]}
             if corrupt_key == "semi" else {corrupt_key: f})
            for f in (0.0, 0.3, 0.6)]
    cfg = {"seed": ttune.grid_search(list(range(4))),
           "corrupt": ttune.grid_search(grid)}
    ttune.run(_levels_trainable(corrupt_key), "grid", cfg, str(tmp_path))
    argv = ["--local_dir", str(tmp_path), "--exp_name", "grid", "--analyze"]
    key = "config:corrupt:" + corrupt_key
    cols = ["mse", "rec_loss"]
    jmean, _ = jps.analyze_best3(jps.make_parser("x").parse_args(argv), key,
                                 cols)
    exp_dir = tmp_path / "grid"
    exp = {}
    for name in ("best_results.csv", "best_results_std.csv"):
        exp[name] = (exp_dir / name).read_text()
        (exp_dir / name).unlink()
    tmean, _ = tps.analyze_best3(tps.make_parser("x").parse_args(argv), key,
                                 cols)
    assert tmean.index == list(jmean.index) == [0.0, 0.3, 0.6]
    for name, text in exp.items():
        got = list(csv.reader((exp_dir / name).read_text().splitlines()))
        want = list(csv.reader(text.splitlines()))
        assert got[0] == want[0] == ["loss", "mse", "rec_loss"]
        assert len(got) == len(want) == 4
        to_f = lambda rows: np.array([[float(v) if v else np.nan for v in r]  # noqa: E731
                                      for r in rows[1:]])
        np.testing.assert_allclose(to_f(got), to_f(want), rtol=1e-12,
                                   atol=0, equal_nan=True)
        assert np.isfinite(to_f(got)[:, 0]).all()


# ---------------------------------------------------------------------------
# The suites' aggregation
# ---------------------------------------------------------------------------

SUITES = {"spirals": ("mse", ["recon", "half", "fwd", "bwd", "condgen"]),
          "weizmann": ("ssim", ["recon", "half", "fwd", "bwd", "mask",
                                "action"]),
          "vidtimit": ("ssim", ["recon", "half", "fwd", "bwd", "a2v",
                                "v2a"])}


def _suite_trainable(metric):
    def trainable(config, reporter):
        m = METHODS.index(config["method"])
        for it in range(3):
            reporter(mean_loss=np.float32(3.0 - it * 0.5 + 0.125 * m
                                          + 0.0625 * config["seed"]),
                     **{metric: np.float32(0.1 * (m + 1) + 0.01 * it
                                           + 0.001 * config["seed"])},
                     training_iteration=it + 1, done=it == 2)
    return trainable


def _fixed_evaluate(tasks):
    """The same task numbers for a trial in both packages (float32, as the
    apps' per-sequence means are)."""
    def evaluate(trial_config, trial_dir):
        m = METHODS.index(trial_config["method"])
        s = trial_config["seed"]
        test = {t: np.float32(0.3 + 0.1 * m + 0.017 * s + 0.003 * k)
                for k, t in enumerate(tasks)}
        std = {t: np.float32(0.05 * (m + 1) + 0.0031 * s * k)
               for k, t in enumerate(tasks)}
        nan = {t: float("nan") for t in tasks}
        return nan, nan, test, std
    return evaluate


@pytest.mark.parametrize("suite", list(SUITES))
def test_suite_csvs_match_jax(tmp_path, monkeypatch, suite):
    """A method × seed experiment (5 methods × 2 seeds), each suite's
    ``evaluate`` replaced in both packages by the same numbers: the four
    CSVs the port writes are the JAX suite's, byte for byte."""
    import importlib
    jmod = importlib.import_module("multimodal_dmm_tpu.experiments."
                                   + suite + "_suite")
    tmod = importlib.import_module("multimodal_dmm_tpu_torch.experiments."
                                   + suite + "_suite")
    metric, tasks = SUITES[suite]
    assert tmod.TASKS == jmod.TASKS == tasks
    assert tmod.TASK_ARGS == jmod.TASK_ARGS
    cfg = {"seed": ttune.grid_search([0, 1]),
           "method": ttune.grid_search(METHODS)}
    ttune.run(_suite_trainable(metric), "suite", cfg, str(tmp_path))
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod, "evaluate", _fixed_evaluate(tasks))
    argv = ["--local_dir", str(tmp_path), "--exp_name", "suite",
            "--analyze"]
    names = ("run_results.csv", "task_results.csv", "task_results_std.csv",
             "task_results_runs.csv")
    exp_dir = tmp_path / "suite"
    jmod.analyze(jmod.parser.parse_args(argv))
    exp = {}
    for name in names:
        exp[name] = (exp_dir / name).read_text()
        (exp_dir / name).unlink()
    tmod.analyze(tmod.parser.parse_args(argv))
    for name in names:
        assert (exp_dir / name).read_text() == exp[name], name
    with open(exp_dir / "task_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["method"] + tasks and len(rows) == 6


def test_suite_scripts_take_the_jax_flags():
    """Every script's parser has the JAX script's flags and defaults (the
    grids' ``--levels`` too), ``--config`` read by the port's flow YAML."""
    import importlib
    for name in ("spirals_suite", "weizmann_suite", "vidtimit_suite",
                 "spirals_partial", "spirals_semisup", "weizmann_partial",
                 "weizmann_semisup"):
        j = importlib.import_module("multimodal_dmm_tpu.experiments." + name)
        t = importlib.import_module("multimodal_dmm_tpu_torch.experiments."
                                    + name)
        ja = {a.dest: a.default for a in j.parser._actions}
        ta = {a.dest: a.default for a in t.parser._actions}
        assert ta == ja, name
        cfg = "{epochs: 2, data_dir: /x/y, eval_args: {flt_particles: 4}}"
        assert t.parser.parse_args(["--config", cfg]).config == \
            j.parser.parse_args(["--config", cfg]).config


def test_grid_isolation_spec_names_the_port(monkeypatch):
    """A grid's trials run isolated by default, in workers that import the
    port's app; ``--no_isolate`` runs them in process."""
    from multimodal_dmm_tpu_torch.apps.spirals import SpiralsTrainer
    captured = {}

    def fake_run(trainable, name, config, isolate=None, **kw):
        captured.update(isolate=isolate, config=config)
        return []

    monkeypatch.setattr(tps.tune, "run", fake_run)
    args = tps.make_parser("x").parse_args(["--n_repeats", "3"])
    tps.run_grid(args, SpiralsTrainer, "t", base_config={"lr": 5e-3},
                 corrupt_grid=[{"uniform": 0.1}])
    assert captured["isolate"] == \
        "multimodal_dmm_tpu_torch.apps.spirals:SpiralsTrainer"
    assert captured["config"]["seed"].values == [0, 1, 2]
    assert captured["config"]["data_dir"] == os.path.abspath(
        SpiralsTrainer.defaults["data_dir"])
    args = tps.make_parser("x").parse_args(["--no_isolate"])
    tps.run_grid(args, SpiralsTrainer, "t", base_config={},
                 corrupt_grid=[{"uniform": 0.1}])
    assert captured["isolate"] is None
