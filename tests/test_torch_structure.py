"""Structure of the PyTorch port: it imports nothing of JAX, of the JAX
package or of pandas, nor at module level a package that the GPU machine
lacks (nor the renderers, matplotlib and cv2), and its experiment layer not
PyYAML at all; its entry points default to the GPU and refuse to fall back to the
CPU; and ``params_from_jax`` covers every leaf of the apps' model trees
(the Weizmann and VidTIMIT BFVI and DKS models, the spirals DMM, DKS and
VRNN)."""

import ast
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_dmm_tpu.apps.spirals import SpiralsTrainer
from multimodal_dmm_tpu.apps.vidtimit import VidTIMITTrainer
from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer
from multimodal_dmm_tpu.models import get_model as jget_model
from multimodal_dmm_tpu_torch.apps import spirals as tsa
from multimodal_dmm_tpu_torch.apps import vidtimit as tvt
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.convert import params_from_jax
from multimodal_dmm_tpu_torch.data.weizmann import gen_synthetic
from multimodal_dmm_tpu_torch.training.device_loader import DeviceTrainData
from multimodal_dmm_tpu_torch.training.eval_engine import DeviceEvalData
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "pandas",
             "multimodal_dmm_tpu")
# Not installed on the GPU machine: imported only inside the functions
# that need them, which the training and evaluation paths do not reach.
NOT_ON_THE_CARD = ("yaml", "matplotlib", "skimage", "skvideo")
# On the GPU machine, but slow to import and needed only by the data
# modules' transforms: imported inside the functions that use them.
IN_FUNCTIONS_ONLY = ("scipy",)


def _port_files():
    files = sorted((ROOT / "multimodal_dmm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "multigpu_smoke.py"]


EXPERIMENTS = ("__init__", "tune", "analysis", "table", "_partial_semisup",
               "_suite", "spirals_suite", "spirals_partial",
               "spirals_semisup", "weizmann_suite", "weizmann_partial",
               "weizmann_semisup", "vidtimit_suite")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def _module_level_roots(path):
    """Roots of the imports that run when the module is imported (not
    those inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        else:
            todo += list(ast.iter_child_nodes(node))


def test_experiments_import_no_jax_pandas_or_yaml():
    """The runner, the analysis and the seven scripts are in the ``ast``
    scans above, and import no PyYAML anywhere (``--config`` is read by
    ``training/flow_yaml.py``)."""
    exp_dir = ROOT / "multimodal_dmm_tpu_torch" / "experiments"
    files = [exp_dir / (name + ".py") for name in EXPERIMENTS]
    assert sorted(files) == sorted(exp_dir.glob("*.py"))
    assert set(files) <= set(_port_files())
    for path in files:
        bad = set(_imported_roots(path)) & (set(FORBIDDEN) | {"yaml"})
        assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_port_imports_no_missing_package_at_module_level():
    for path in _port_files():
        bad = set(_module_level_roots(path)) & set(NOT_ON_THE_CARD)
        assert not bad, "%s imports %s at module level" % (
            path.relative_to(ROOT), bad)


def test_port_imports_scipy_inside_functions_only():
    """No module imports scipy when it is imported; the VidTIMIT data
    module uses scipy's STFT inside its transform functions."""
    for path in _port_files():
        bad = set(_module_level_roots(path)) & set(IN_FUNCTIONS_ONLY)
        assert not bad, "%s imports %s at module level" % (
            path.relative_to(ROOT), bad)
    path = ROOT / "multimodal_dmm_tpu_torch" / "data" / "vidtimit.py"
    assert "scipy" in set(_imported_roots(path))


def test_renderers_are_imported_inside_functions_only():
    """matplotlib (not on the GPU machine) and cv2 are imported by the
    apps' ``visualize`` and ``save_results`` alone, never when a module is
    imported."""
    for path in _port_files():
        bad = set(_module_level_roots(path)) & {"matplotlib", "cv2"}
        assert not bad, "%s imports %s at module level" % (
            path.relative_to(ROOT), bad)
    apps = ROOT / "multimodal_dmm_tpu_torch" / "apps"
    for name, renderers in (("spirals", {"matplotlib"}),
                            ("weizmann", {"matplotlib", "cv2"}),
                            ("vidtimit", {"matplotlib", "cv2"})):
        assert renderers <= set(_imported_roots(apps / (name + ".py")))


_ITEM = {"video": np.zeros((3, 3, 64, 64), np.float32),
         "person": np.zeros((3, 1)), "action": np.zeros((3, 1)),
         "length": 3, "id": ("p", "a")}


@pytest.mark.parametrize("entry", ["model_init", "trainer", "eval_data",
                                   "train_data", "from_args", "main",
                                   "tune"])
def test_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    """With no device given, entry points run on CUDA; without CUDA they
    raise instead of running on the CPU (the experiment runner's
    trainable, ``Trainer.tune``, too)."""
    monkeypatch.chdir(tmp_path)  # main writes param_hist.tsv there
    data = str(tmp_path / "data")
    gen_synthetic(data, persons_subset=["daria", "shahar"],
                  actions_subset=["bend"], t_range=(4, 6))
    argv = ["--data_dir", data, "--save_dir", str(tmp_path / "save"),
            "--epochs", "0", "--model_args", "{z_dim: 8, h_dim: 8}"]
    call = {"model_init": lambda: tw.build_model(
                model_args={"z_dim": 8, "h_dim": 8}).init(0),
            "trainer": lambda: tw.make_trainer(
                seed=0, model_args={"z_dim": 8, "h_dim": 8}),
            "eval_data": lambda: DeviceEvalData(
                [_ITEM], tw.DEFAULTS["modalities"], 2),
            "train_data": lambda: DeviceTrainData(
                [_ITEM], tw.DEFAULTS["modalities"], 2, 0.2),
            "from_args": lambda: tw.WeizmannTrainer.from_args(
                tw.WeizmannTrainer.parser.parse_args(argv)),
            "main": lambda: tw.main(argv),
            "tune": lambda: tw.WeizmannTrainer.tune(
                {"data_dir": data, "save_dir": str(tmp_path / "save"),
                 "epochs": 0, "model_args": {"z_dim": 8, "h_dim": 8}},
                lambda **kw: reported.append(kw))}[entry]
    reported = []
    if torch.cuda.is_available():
        out = call()
        if entry in ("main", "tune"):
            assert (tmp_path / "save" / "last.pth").exists()
            return
        leaf = {"model_init": lambda: out[0]["z0_mean"],
                "trainer": lambda: out.params["z0_mean"],
                "from_args": lambda: out.params["z0_mean"],
                "eval_data": lambda: out.batches[0].targets["video"],
                "train_data": lambda: out.data["video"]}[entry]()
        assert leaf.is_cuda
        if entry in ("trainer", "from_args"):
            assert isinstance(out, tw.WeizmannTrainer)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("entry", ["dks_init", "vrnn_init", "main"])
def test_spirals_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    """The spirals app's models and command line, like the Weizmann
    app's, run on CUDA by default and raise without it."""
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    from multimodal_dmm_tpu_torch.data.spirals import gen_dataset
    gen_dataset(n_examples=4, n_train=2, timesteps=5, data_dir=data)
    call = {"dks_init": lambda: tsa.build_model(model="dks").init(0),
            "vrnn_init": lambda: tsa.build_model(model="vrnn").init(0),
            "main": lambda: tsa.main(["--data_dir", data, "--save_dir",
                                      str(tmp_path / "save"), "--epochs",
                                      "0", "--method", "b-skip"])}[entry]
    if torch.cuda.is_available():
        out = call()
        if entry != "main":
            assert out[0]["h0"].is_cuda if entry == "vrnn_init" else \
                out[0]["h0"]["spiral-x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("entry", ["model_init", "trainer", "main"])
def test_vidtimit_entry_points_default_to_cuda(entry, tmp_path,
                                               monkeypatch):
    """The VidTIMIT app's model, trainer and command line, like the other
    apps', run on CUDA by default and raise without it."""
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    from multimodal_dmm_tpu_torch.data.vidtimit import gen_synthetic as gen
    gen(data, n_subjects=1, n_sentences=3, t_range=(4, 6))
    narrow = {"z_dim": 8, "h_dim": 8}
    call = {"model_init": lambda: tvt.build_model(model_args=narrow).init(0),
            "trainer": lambda: tvt.make_trainer(seed=0, model_args=narrow),
            "main": lambda: tvt.main(["--data_dir", data, "--save_dir",
                                      str(tmp_path / "save"), "--epochs",
                                      "0", "--model_args",
                                      "{z_dim: 8, h_dim: 8}"])}[entry]
    if torch.cuda.is_available():
        out = call()
        if entry == "model_init":
            assert out[0]["z0_mean"].is_cuda
        elif entry == "trainer":
            assert out.params["enc"]["audio"]["convs"][0]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_params_from_jax_covers_weizmann_trees():
    _check_params_from_jax("weizmann", "dmm")


@pytest.mark.parametrize("app,model", [
    ("weizmann", "dks"), ("spirals", "dmm"), ("spirals", "dks"),
    ("spirals", "vrnn"), ("vidtimit", "dmm"), ("vidtimit", "dks")])
def test_params_from_jax_covers_the_baselines_and_spirals(app, model):
    _check_params_from_jax(app, model)


def _check_params_from_jax(app, model):
    jcls, tmod = {"weizmann": (WeizmannTrainer, tw),
                  "spirals": (SpiralsTrainer, tsa),
                  "vidtimit": (VidTIMITTrainer, tvt)}[app]
    args = types.SimpleNamespace(model_args={}, model=model,
                                 modalities=tmod.DEFAULTS["modalities"])
    jmodel = jcls.build_model(None, jget_model(model), args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams, jstate = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    tmodel = tmod.build_model(model=model)
    got_p, got_s = params_from_jax(jparams, jstate, tmodel, device="cpu")
    exp_p, exp_s = tmodel.init(0, device="cpu")
    for got, exp in ((got_p, exp_p), (got_s, exp_s)):
        got_leaves = dict(tree_leaves_with_path(got))
        exp_leaves = dict(tree_leaves_with_path(exp))
        assert got_leaves.keys() == exp_leaves.keys()
        for path, leaf in exp_leaves.items():
            assert got_leaves[path].shape == leaf.shape, path
    n_jax = len(jax.tree_util.tree_leaves((jparams, jstate)))
    n_bn_scalars = 2 * sum(len(s["bns"]) for side in ("enc", "dec")
                           for s in jstate.get(side, {}).values() if s)
    assert n_jax == (len(tree_leaves_with_path(got_p))
                     + len(tree_leaves_with_path(got_s)) + n_bn_scalars)
