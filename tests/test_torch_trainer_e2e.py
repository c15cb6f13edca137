"""The port's Weizmann command line on the CPU (apps/weizmann.main,
training/trainer.py): a few-sequence fixture with 'shahar' held out,
narrow latent widths (the DKS baseline at the app's z = h = 256), 2
epochs. Training leaves best.pth, epoch_N.pth and
last.pth; ``--load ... --evaluate`` runs and repeats under one seed;
``--resume_trial`` reproduces the uninterrupted run bit for bit;
``--visualize`` and the results export run (``--rng_impl`` raises); the
flag surface is the JAX app's."""

import numpy as np
import pytest

from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer as JTrainer
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
from multimodal_dmm_tpu_torch.training import checkpoint as tck


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("weizmann"))
    gen_synthetic(d, persons_subset=["daria", "denis", "shahar"],
                  actions_subset=["bend", "jack"], t_range=(8, 14))
    return d


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """param_hist.tsv goes to the working directory."""
    monkeypatch.chdir(tmp_path)


TRAIN = {"ragged_bf16": ["--model_args", "{bf16: true, z_dim: 8, h_dim: 8}",
                         "--train_args", "{ragged_mode_scans: true, "
                         "train_particles: 3, match_particles: 4}"],
         "merge": ["--model_args", "{z_dim: 8, h_dim: 8}", "--train_args",
                   "{merge_mode_scans: true, train_particles: 3, "
                   "match_particles: 4}"],
         "two_scan_host_loader": ["--model_args", "{z_dim: 8, h_dim: 8}",
                                  "--train_args", "{train_particles: 3, "
                                  "match_particles: 4}", "--host_loader"],
         # The DKS baseline over the conv features; --method replaces
         # --model_args, so z = h = 256.
         "dks_f_mask": ["--method", "f-mask"]}


def _argv(data_dir, save_dir, *extra, epochs=2):
    return ["--device", "cpu", "--data_dir", data_dir, "--save_dir",
            str(save_dir), "--epochs", str(epochs), "--eval_freq", "1",
            "--save_freq", "1", "--method", "bfvi", "--eval_args",
            "{flt_particles: 4}", "--split", "5", "--batch_size", "4",
            "--seed", "3"] + list(extra)


def _run(data_dir, save_dir, *extra, epochs=2):
    return tw.main(_argv(data_dir, save_dir, *extra, epochs=epochs))


@pytest.mark.parametrize("config", sorted(TRAIN))
def test_cli_trains_and_writes_checkpoints(data_dir, tmp_path, config):
    hist = _run(data_dir, tmp_path / "save", *TRAIN[config])
    assert len(hist["epoch_loss"]) == 2
    assert np.all(np.isfinite(hist["epoch_loss"]))
    assert all(np.isfinite(e["rec_loss"]) for e in hist["eval"])
    names = sorted(p.name for p in (tmp_path / "save").iterdir())
    assert names == ["best.pth", "epoch_1.pth", "epoch_2.pth", "last.pth"]
    ck = tck.load_checkpoint(str(tmp_path / "save" / "epoch_2.pth"))
    assert ck["format"] == 2 and ck["epoch"] == 2
    assert ck["modalities"] == ["video", "person", "action"]
    rows = (tmp_path / "param_hist.tsv").read_text().splitlines()
    assert rows[0].split("\t")[-2:] == ["h_dim", "z_dim"] and len(rows) == 2


def test_load_evaluate_repeats_under_one_seed(data_dir, tmp_path):
    save = tmp_path / "save"
    _run(data_dir, save, *TRAIN["ragged_bf16"], epochs=1)
    runs = [_run(data_dir, save, "--model_args", "{bf16: true, z_dim: 8, "
                 "h_dim: 8}", "--load", str(save / "last.pth"),
                 "--evaluate", "--save_args", "{skip: true}")
            for _ in range(2)]
    for train_m, test_m in runs:
        assert np.isfinite(train_m["rec_loss"])
        assert np.isfinite(test_m["rec_loss"])
        assert 0.0 <= test_m["ssim"] <= 1.0
    for i in range(2):  # the mask metrics are NaN: no mask modality
        a, b = dict(runs[0][i]), dict(runs[1][i])
        assert a.keys() == b.keys()
        np.testing.assert_array_equal([a[k] for k in sorted(a)],
                                      [b[k] for k in sorted(a)])


def test_resume_trial_is_bit_identical(data_dir, tmp_path):
    """Two epochs in one run equal one epoch, then a --resume_trial run to
    epoch 2 from epoch_1.pth: weights, BatchNorm state, Adam's moments
    and the epoch's loss."""
    flags = TRAIN["ragged_bf16"]
    whole = _run(data_dir, tmp_path / "a", *flags)
    _run(data_dir, tmp_path / "b", *flags, epochs=1)
    resumed = _run(data_dir, tmp_path / "b", *flags, "--resume_trial")
    assert resumed["epoch_loss"] == whole["epoch_loss"][1:]
    a, b = (tck.load_checkpoint(str(tmp_path / d / "last.pth"))
            for d in ("a", "b"))
    for key in ("params", "state", "torch_adam"):
        la, lb = _leaves(a[key]), _leaves(b[key])
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


# --rng_impl chooses one of JAX's PRNGs, which the port does not take.
@pytest.mark.parametrize("flags", [["--rng_impl", "rbg"]],
                         ids=lambda f: f[0].strip("-"))
def test_later_slice_flags_raise(data_dir, tmp_path, flags):
    argv = _argv(data_dir, tmp_path / "save", *flags)
    with pytest.raises(NotImplementedError, match="later slice"):
        tw.main(argv)


# During training and --find_best the evaluation has no eval set, so
# --visualize draws without writing a PDF, as in the JAX app; --evaluate
# writes each set's AVI (and its PDF with --visualize).
@pytest.mark.parametrize("flags,written", [
    (["--mesh", "2", "--visualize"], []),
    (["--visualize"], []),
    (["--find_best", "--visualize"], []),
    (["--evaluate", "--save_args", "{}"], ["test.avi", "train.avi"]),
    (["--evaluate", "--visualize"],
     ["test.avi", "test.pdf", "train.avi", "train.pdf"])],
    ids=["mesh", "visualize", "find_best", "evaluate", "evaluate_visualize"])
def test_visualize_and_results_export_run(data_dir, tmp_path, flags,
                                          written):
    save = tmp_path / "save"
    ckpts = ["best.pth", "epoch_1.pth", "last.pth"]
    if flags[0] in ("--evaluate", "--find_best"):
        _run(data_dir, save, *TRAIN["merge"], epochs=1)
        flags = flags + ["--model_args", "{z_dim: 8, h_dim: 8}"]
    else:
        flags = flags + TRAIN["merge"]
    out = tw.main(_argv(data_dir, save, *flags, epochs=1))
    assert sorted(p.name for p in save.iterdir()) == sorted(ckpts + written)
    if flags[0] == "--evaluate":
        assert all(np.isfinite(m["rec_loss"]) for m in out)
        import cv2
        video = cv2.VideoCapture(str(save / "test.avi"))
        assert video.get(cv2.CAP_PROP_FRAME_WIDTH) == 3 * 64
        video.release()
    elif flags[0] == "--find_best":
        assert out[0] == 1 and np.isfinite(out[1]["rec_loss"])
    else:
        assert np.isfinite(out["eval"][0]["rec_loss"])


def test_bf16_gtf_trains_and_reloads(data_dir, tmp_path):
    """``--model_args '{bf16_gtf: true}'`` (with the bf16 codecs and the
    ragged step) reaches the model: one epoch trains, and ``--load
    last.pth --evaluate`` runs on the checkpoint, whose evaluation without
    the flag gives other metrics."""
    save = tmp_path / "save"
    args = "{bf16: true, bf16_gtf: true, z_dim: 8, h_dim: 8}"
    hist = _run(data_dir, save, "--model_args", args, *TRAIN[
        "ragged_bf16"][2:], epochs=1)
    assert np.all(np.isfinite(hist["epoch_loss"]))
    assert np.isfinite(hist["eval"][0]["rec_loss"])
    evals = [_run(data_dir, save, "--model_args", a, "--load",
                  str(save / "last.pth"), "--evaluate", "--save_args",
                  "{skip: true}")
             for a in (args, "{bf16: true, z_dim: 8, h_dim: 8}")]
    for train_m, test_m in evals:
        assert np.isfinite(train_m["rec_loss"])
        assert np.isfinite(test_m["rec_loss"])
        assert 0.0 <= test_m["ssim"] <= 1.0
    assert evals[0][1]["rec_loss"] != evals[1][1]["rec_loss"]


def test_flag_surface_is_the_jax_apps():
    """The same flags with the same defaults, except --device (cuda) and
    the parsers of the dict flags."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}
    port, ref = actions(tw.WeizmannTrainer.parser), actions(JTrainer.parser)
    assert port.keys() == ref.keys()
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.nargs == a.nargs and b.choices == a.choices, dest
        if dest != "device":
            assert b.default == a.default, dest
    assert port["device"].default == "cuda"
    args = tw.WeizmannTrainer.parser.parse_args(
        ["--train_args", "{ragged_mode_scans: true}"])
    assert args.train_args == {"ragged_mode_scans": True}
    assert args.rec_mults == tw.DEFAULTS["rec_mults"]
