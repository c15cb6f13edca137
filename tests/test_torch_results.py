"""The storyboards, the results export, the data modules' command lines and
``Trainer.load_checkpoint`` of the port against the JAX package's, on the
CPU:

- the same seeded ``results`` (the dict that ``Trainer.evaluate`` returns
  with ``collect_results``: a few sequences of narrow spirals, Weizmann or
  VidTIMIT data, with NaN-deleted steps) go through the JAX apps'
  ``visualize`` and ``save_results`` (called unbound: they do not use
  ``self``) and the port's; under ``SOURCE_DATE_EPOCH=0`` every PDF, AVI
  and WAV is byte for byte the JAX package's, for each ``one_file``,
  ``comparison`` and ``labels`` setting;
- ``python -m`` of the port's ``data.spirals`` (generate, then ``--test
  --stats``) and ``data.weizmann`` (``--synthetic --stats``) prints what
  the JAX modules' functions print, line for line, and writes the same
  files;
- ``Trainer.load_checkpoint`` returns what ``checkpoint.load_checkpoint``
  (and the JAX package's) returns.
"""

import filecmp
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from multimodal_dmm_tpu.apps import spirals as jsp
from multimodal_dmm_tpu.apps import vidtimit as jvt
from multimodal_dmm_tpu.apps import weizmann as jwz
from multimodal_dmm_tpu.data import spirals as jsd
from multimodal_dmm_tpu.data import weizmann as jwd
from multimodal_dmm_tpu.training import checkpoint as jck
from multimodal_dmm_tpu_torch.apps import spirals as tsp
from multimodal_dmm_tpu_torch.apps import vidtimit as tvt
from multimodal_dmm_tpu_torch.apps import weizmann as twz
from multimodal_dmm_tpu_torch.training import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO_BINS = 1281   # the spectrogram's bins at 32 kHz and 25 fps
AVI_LUMA_TOL = 4    # mean luma levels a frame's YUV 4:2:0 round trip moves


@pytest.fixture(autouse=True)
def fixed_dates(monkeypatch):
    """matplotlib stamps a PDF with SOURCE_DATE_EPOCH when it is set."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


def _observed(rng, seq, frac=0.3):
    """``seq`` with a share of its steps deleted (NaN)."""
    out = np.array(seq, copy=True)
    out[rng.rand(len(seq)) < frac] = np.nan
    return out


def spirals_results(seed=0, n=8):
    rng = np.random.RandomState(seed)
    res = {"seq_ids": [(i,) for i in range(n)], "targets": {}, "inputs": {},
           "recon": {}}
    lengths = rng.randint(10, 20, n)
    for m in ("spiral-x", "spiral-y"):
        res["targets"][m] = [rng.randn(L, 1) for L in lengths]
        res["inputs"][m] = [_observed(rng, x) for x in res["targets"][m]]
        res["recon"][m] = [np.stack([rng.randn(L, 1), rng.rand(L, 1) + 0.1],
                                    axis=1) for L in lengths]
    res["targets"]["metadata"] = [rng.randn(L, 6) for L in lengths]
    return res, list(rng.rand(n))


def _labels(rng, L, n_classes):
    return rng.randint(0, n_classes, (L, 1)).astype(np.float64)


def _probs(rng, L, n_classes):
    p = rng.rand(L, 1, n_classes)
    return p / p.sum(-1, keepdims=True)


def weizmann_results(seed=0, n=3):
    rng = np.random.RandomState(seed + 1)
    res = {"seq_ids": [("shahar", twz.weizmann.actions[i]) for i in
                       range(n)],
           "targets": {"video": [], "person": [], "action": []},
           "inputs": {"video": [], "person": [], "action": []},
           "recon": {"video": [], "person": [], "action": []}}
    for i in range(n):
        L = int(rng.randint(5, 9))
        video = rng.rand(L, 3, 64, 64)
        res["targets"]["video"].append(video)
        res["inputs"]["video"].append(_observed(rng, video))
        res["recon"]["video"].append(rng.rand(L, 1, 3, 64, 64) * 1.2 - 0.1)
        for m, k in (("person", 9), ("action", 10)):
            labels = _labels(rng, L, k)
            res["targets"][m].append(labels)
            res["inputs"][m].append(_observed(rng, labels))
            res["recon"][m].append(_probs(rng, L, k))
    return res, list(rng.rand(n))


def vidtimit_results(seed=0, n=2):
    rng = np.random.RandomState(seed + 2)
    res = {"seq_ids": [("fadg0", "sa%d" % (i + 1)) for i in range(n)],
           "targets": {"video": [], "audio": []},
           "inputs": {"video": [], "audio": []},
           "recon": {"video": [], "audio": []}}
    for i in range(n):
        L = int(rng.randint(4, 7))
        for m, shape in (("video", (3, 64, 64)), ("audio", (10, AUDIO_BINS))):
            x = rng.rand(L, *shape)
            res["targets"][m].append(x)
            res["inputs"][m].append(_observed(rng, x))
            res["recon"][m].append(rng.rand(L, 1, *shape))
    return res, list(rng.rand(n))


APPS = {"spirals": (jsp.SpiralsTrainer, tsp.SpiralsTrainer, spirals_results),
        "weizmann": (jwz.WeizmannTrainer, twz.WeizmannTrainer,
                     weizmann_results),
        "vidtimit": (jvt.VidTIMITTrainer, tvt.VidTIMITTrainer,
                     vidtimit_results)}


def _args(save_dir, save_args=None):
    return types.SimpleNamespace(save_dir=str(save_dir), eval_set="test",
                                 viz_mod="video", save_args=save_args or {})


def _same_files(tmp_path, names):
    """The JAX package's and the port's directories hold the same files,
    byte for byte (``names``, and nothing else)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == sorted(
        names)
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _both(tmp_path, fn):
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        fn(name, tmp_path / name)


@pytest.mark.parametrize("app", sorted(APPS))
def test_visualize_writes_the_jax_pdf(tmp_path, app):
    jcls, tcls, make = APPS[app]
    results, metric = make()
    _both(tmp_path, lambda name, d: (jcls if name == "jax" else tcls)
          .visualize(None, results, metric, _args(d)))
    _same_files(tmp_path, ["test.pdf"])


def _flags(keys):
    return [dict(zip(keys, values)) for values in
            np.ndindex(*(2,) * len(keys))]


@pytest.mark.parametrize("save_args", [
    {k: bool(v) for k, v in f.items()}
    for f in _flags(("one_file", "comparison", "labels"))],
    ids=lambda a: "-".join(k for k, v in a.items() if v) or "none")
def test_weizmann_save_results_writes_the_jax_avi(tmp_path, save_args):
    results, _ = weizmann_results()
    _both(tmp_path, lambda name, d: (
        jwz.WeizmannTrainer if name == "jax" else twz.WeizmannTrainer)
        .save_results(None, results, _args(d, save_args)))
    names = ["test.avi"]
    if not save_args["one_file"]:
        # A file for each (person, action) of a sequence's first step.
        names = sorted({"%s_%s.avi" % (
            twz.weizmann.persons[int(p[0, 0])],
            twz.weizmann.actions[int(a[0, 0])]) for p, a in zip(
                results["targets"]["person"], results["targets"]["action"])})
    _same_files(tmp_path, names)


@pytest.mark.parametrize("save_args", [
    {k: bool(v) for k, v in f.items()}
    for f in _flags(("one_file", "comparison"))],
    ids=lambda a: "-".join(k for k, v in a.items() if v) or "none")
def test_vidtimit_save_results_writes_the_jax_avi_and_wav(tmp_path,
                                                          save_args):
    results, _ = vidtimit_results()
    _both(tmp_path, lambda name, d: (
        jvt.VidTIMITTrainer if name == "jax" else tvt.VidTIMITTrainer)
        .save_results(None, results, _args(d, save_args)))
    stems = (["test"] if save_args["one_file"] else
             ["%s_%s" % s for s in results["seq_ids"]])
    _same_files(tmp_path, [s + ext for s in stems for ext in (".avi",
                                                              ".wav")])


def _luma(bgr):
    import cv2
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY).astype(np.float64)


def test_weizmann_avi_frames_are_the_reconstruction(tmp_path):
    """The AVI holds a frame for each step of each sequence, 3 x 64 wide,
    whose third part is the reconstruction as uint8: fourcc 0 stores raw
    YUV 4:2:0 through FFmpeg, so the colours come back at half resolution
    and the luma within rounding (a mean of about 2 levels; another frame
    is about 80 levels away)."""
    import cv2
    results, _ = weizmann_results()
    twz.WeizmannTrainer.save_results(None, results, _args(
        tmp_path, {"labels": False}))
    video = cv2.VideoCapture(str(tmp_path / "test.avi"))
    frames = []
    while True:
        ok, frame = video.read()
        if not ok:
            break
        frames.append(frame)
    video.release()
    recon = np.concatenate([v[:, 0] for v in results["recon"]["video"]])
    assert len(frames) == len(recon)
    for i, (frame, rec) in enumerate(zip(frames, recon)):
        assert frame.shape == (64, 3 * 64, 3)
        exp = cv2.cvtColor((np.clip(rec, 0, 1) * 255).astype("uint8")
                           .transpose(1, 2, 0), cv2.COLOR_RGB2BGR)
        err = np.abs(_luma(frame[:, 128:]) - _luma(exp)).mean()
        other = np.abs(_luma(frame[:, 128:])
                       - _luma(frames[i - 1][:, 128:])).mean()
        assert err <= AVI_LUMA_TOL < other, (i, err, other)


# ---------------------------------------------------------------------------
# The data modules' command lines
# ---------------------------------------------------------------------------

def _port_module(name, *argv, cwd):
    """The standard output of ``python -m`` the port's module ``name``."""
    out = subprocess.run(
        [sys.executable, "-m", "multimodal_dmm_tpu_torch." + name]
        + list(argv), cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return out.stdout


def _same_tree(a, b):
    """Directories ``a`` and ``b`` hold the same files, byte for byte."""
    for root, dirs, names in os.walk(a):
        other = os.path.join(b, os.path.relpath(root, a))
        assert sorted(os.listdir(other)) == sorted(dirs + names)
        _, mismatch, errors = filecmp.cmpfiles(root, other, names,
                                               shallow=False)
        assert not mismatch and not errors, (mismatch, errors)


def test_spirals_module_is_the_jax_modules(tmp_path, capsys, monkeypatch):
    """``python -m ...data.spirals`` writes the JAX generator's CSVs (numpy
    seeded with 1) byte for byte, and ``--test --stats`` prints what JAX's
    ``test_dataset`` prints."""
    monkeypatch.chdir(tmp_path)
    out = _port_module("data.spirals", "--n_examples", "12", "--n_train",
                       "8", "--timesteps", "16", "--data_dir", "port",
                       cwd=tmp_path)
    assert out == ""
    jsd.gen_dataset(12, 8, 16, "jax")
    _same_tree("jax", "port")
    assert len(os.listdir("port/train")) == 8
    capsys.readouterr()
    jsd.test_dataset("jax", "test", True)
    exp = capsys.readouterr().out
    assert "Batch shapes:" in exp and "-- metadata --" in exp
    assert _port_module("data.spirals", "--test", "--stats", "--subset",
                        "test", "--data_dir", "port", cwd=tmp_path) == exp


def test_weizmann_module_is_the_jax_modules(tmp_path, capsys, monkeypatch):
    """``python -m ...data.weizmann --synthetic --stats`` writes the JAX
    module's 90-sequence fixture byte for byte and prints what its
    ``test_dataset`` prints."""
    monkeypatch.chdir(tmp_path)
    out = _port_module("data.weizmann", "--synthetic", "--stats",
                       "--data_dir", "port", cwd=tmp_path)
    jwd.gen_synthetic("jax")
    _same_tree("jax", "port")
    assert len(os.listdir("port")) == 180
    capsys.readouterr()
    jwd.test_dataset("jax", True)
    exp = capsys.readouterr().out
    assert "Number of sequences: 90" in exp and "-- action --" in exp
    assert out == exp


# ---------------------------------------------------------------------------
# Trainer.load_checkpoint
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [(k,) + p for k in sorted(tree) for p in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(i,) + p for i, v in enumerate(tree) for p in _leaves(v)]
    return [(np.asarray(tree),)]


def test_load_checkpoint_is_checkpoint_load_checkpoint(tmp_path):
    trainer = tsp.make_trainer(seed=2, device="cpu")
    path = str(tmp_path / "ck.pth")
    trainer.save_checkpoint(["spiral-x", "spiral-y"], path,
                            extra={"epoch": 3})
    got = trainer.load_checkpoint(path)
    for exp in (tck.load_checkpoint(path), jck.load_checkpoint(path)):
        assert got.keys() == exp.keys()
        a, b = _leaves(got), _leaves(exp)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x[:-1] == y[:-1]
            np.testing.assert_array_equal(x[-1], y[-1])
    assert got["epoch"] == 3
