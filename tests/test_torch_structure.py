"""Structure of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points default to the GPU and refuse to fall back to
the CPU, and ``params_from_jax`` covers every leaf of the Weizmann
model's trees."""

import ast
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.convert import params_from_jax
from multimodal_dmm_tpu_torch.training.eval_engine import DeviceEvalData
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "multimodal_dmm_tpu")


def _port_files():
    files = sorted((ROOT / "multimodal_dmm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


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


_ITEM = {"video": np.zeros((3, 3, 64, 64), np.float32),
         "person": np.zeros((3, 1)), "action": np.zeros((3, 1)),
         "length": 3, "id": ("p", "a")}


@pytest.mark.parametrize("entry", ["model_init", "trainer", "eval_data"])
def test_entry_points_default_to_cuda(entry):
    """With no device given, entry points run on CUDA; without CUDA they
    raise instead of running on the CPU."""
    call = {"model_init": lambda: tw.build_model(
                model_args={"z_dim": 8, "h_dim": 8}).init(0),
            "trainer": lambda: tw.make_trainer(
                seed=0, model_args={"z_dim": 8, "h_dim": 8}),
            "eval_data": lambda: DeviceEvalData(
                [_ITEM], tw.DEFAULTS["modalities"], 2)}[entry]
    if torch.cuda.is_available():
        out = call()
        leaf = {"model_init": lambda: out[0]["z0_mean"],
                "trainer": lambda: out.params["z0_mean"],
                "eval_data": lambda: out.batches[0].targets["video"]}[
                    entry]()
        assert leaf.is_cuda
        if entry == "trainer":
            assert isinstance(out, tw.WeizmannTrainer)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_params_from_jax_covers_weizmann_trees():
    args = types.SimpleNamespace(model_args={}, model="dmm",
                                 modalities=tw.DEFAULTS["modalities"])
    jmodel = WeizmannTrainer.build_model(None, JMultiDMM, args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams, jstate = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    tmodel = tw.build_model()
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
                           for s in jstate[side].values() if s)
    assert n_jax == (len(tree_leaves_with_path(got_p))
                     + len(tree_leaves_with_path(got_s)) + n_bn_scalars)
