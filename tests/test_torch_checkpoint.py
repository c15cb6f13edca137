"""Checkpoints between the JAX package and the port
(training/checkpoint.py, convert.py): a JAX-written format-2 or format-1
checkpoint loads into the port and gives JAX's MAP forward; a
port-written checkpoint loads in the JAX package's ``load_checkpoint``
with equal params and state; Adam's moments map both ways between optax's
``ScaleByAdamState`` and ``torch.optim.Adam``."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from multimodal_dmm_tpu.training import checkpoint as jck
from multimodal_dmm_tpu_torch.convert import (adam_to_jax, optax_adam_moments,
                                              params_to_jax, tree_from_jax)
from multimodal_dmm_tpu_torch.training import checkpoint as tck
from multimodal_dmm_tpu_torch.training.trainer import Trainer
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

from test_torch_dmm import _image_batch, _image_models
from torch_parity import np_tree, port_tree, t

LR, WD = 1e-3, 1e-4
MODS = ["video", "label"]


@pytest.fixture(scope="module")
def models():
    return _image_models()


def _tx():
    return optax.apply_if_finite(optax.chain(optax.add_decayed_weights(WD),
                                             optax.adam(LR)), 10 ** 6)


def _grads(jparams, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*np.shape(p)).astype(np.float32)),
        jparams)


def _optax_steps(jparams, n):
    """(params, opt_state) after ``n`` updates with gradients from seeds
    0..n-1."""
    tx = _tx()
    opt_state = tx.init(jparams)
    for i in range(n):
        updates, opt_state = tx.update(_grads(jparams, i), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
    return jparams, opt_state


def _port_trainer(tmodel, jparams, jstate):
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return Trainer(tmodel, lr=LR, w_decay=WD, params=tparams, state=tstate,
                   device="cpu")


def _set_grads(trainer, jgrads):
    g = dict(tree_leaves_with_path(tree_from_jax(np_tree(jgrads), "cpu")))
    for path, p in tree_leaves_with_path(trainer.params):
        p.grad = g[path].reshape(p.shape).clone()


def _map_forward_close(jmodel, tmodel, jparams, jstate, trainer):
    inputs, _, _ = _image_batch(3)
    (ji, jp, jr), _ = jmodel.forward(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()},
        rng=jax.random.PRNGKey(0), mode="fsmooth", sample=False)
    with torch.no_grad():
        (ti, tp, tr), _ = tmodel.forward(
            trainer.params, trainer.state,
            {m: t(v) for m, v in inputs.items()}, mode="fsmooth",
            sample=False)
    for g, e in ((ti[0], ji[0]), (ti[1], ji[1]), (tp[0], jp[0]),
                 (tr["video"][0], jr["video"][0]),
                 (tr["label"][0], jr["label"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-6)


def _to_v1(obj):
    """The inverse of the format 1 -> 2 deconv conversion, over dicts,
    lists and optax NamedTuples."""
    if isinstance(obj, dict):
        return {k: ([{kk: (np.ascontiguousarray(
                        np.transpose(vv, (0, 1, 3, 2))[::-1, ::-1])
                        if kk == "w" else vv) for kk, vv in layer.items()}
                     for layer in v] if k == "deconvs" else _to_v1(v))
                for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_to_v1(v) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_v1(v) for v in obj)
    return obj


@pytest.mark.parametrize("fmt", [2, 1])
def test_jax_checkpoint_loads_into_port(models, tmp_path, fmt):
    """A JAX checkpoint (with optax state) restores the port's weights,
    BatchNorm state and Adam moments; the MAP forward then equals JAX's
    at rtol 1e-5."""
    jmodel, tmodel, jparams, jstate = models
    jparams, opt_state = _optax_steps(jparams, 2)
    path = str(tmp_path / "jax.pth")
    jck.save_checkpoint(path, MODS, jparams, jstate, opt_state,
                        extra={"epoch": 3, "rng": np.asarray(
                            jax.random.PRNGKey(4))})
    if fmt == 1:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        del payload["format"]
        payload["params"] = _to_v1(payload["params"])
        payload["opt_state"] = _to_v1(payload["opt_state"])
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    ck = tck.load_checkpoint(path)
    assert ck["format"] == 2 and ck["epoch"] == 3
    assert isinstance(ck["opt_state"], tck.OptaxStandIn)
    trainer = _port_trainer(tmodel, *jmodel.init(jax.random.PRNGKey(9)))
    trainer.restore(ck, opt=True)
    _map_forward_close(jmodel, tmodel, jparams, jstate, trainer)
    count, mu, nu = optax_adam_moments(opt_state)
    got = adam_to_jax(trainer._adam_states(), trainer.params)
    assert int(got["count"]) == int(count) == 2
    for a, b in ((got["mu"], mu), (got["nu"], nu)):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(np_tree(b))):
            np.testing.assert_array_equal(x, y)


def test_port_checkpoint_loads_in_jax(models, tmp_path):
    """The port writes params and state in the JAX layout (format 2),
    its Adam moments and generator under keys of its own; the JAX
    package's load_checkpoint reads back the JAX trees exactly, and the
    port reads back its Adam state exactly."""
    jmodel, tmodel, jparams, jstate = models
    trainer = _port_trainer(tmodel, jparams, jstate)
    _set_grads(trainer, _grads(jparams, 0))
    assert trainer.apply_gradients()
    path = str(tmp_path / "port.pth")
    trainer.save_checkpoint(MODS, path, extra={"epoch": 1})
    ck = jck.load_checkpoint(path)
    assert ck["format"] == 2 and ck["modalities"] == MODS
    assert "opt_state" not in ck and "rng" not in ck
    assert {"torch_adam", "torch_gen"} <= set(ck)
    exp_p, exp_s = params_to_jax(trainer.params, trainer.state)
    for got, exp in ((ck["params"], exp_p), (ck["state"], exp_s)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(exp))
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(exp)):
            np.testing.assert_array_equal(x, y)
    # Unchanged state equals the JAX package's own trees.
    for x, y in zip(jax.tree_util.tree_leaves(ck["state"]),
                    jax.tree_util.tree_leaves(np_tree(jstate))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    other = _port_trainer(tmodel, jparams, jstate)
    other.restore(tck.load_checkpoint(path), opt=True)
    for path_, st in trainer._adam_states().items():
        got = other._adam_states()[path_]
        assert float(got["step"]) == float(st["step"]) == 1.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k], st[k])


def test_params_to_jax_inverts_params_from_jax(models):
    jmodel, tmodel, jparams, jstate = models
    back_p, back_s = params_to_jax(*port_tree(jparams, jstate, tmodel))
    for got, exp in ((back_p, jparams), (back_s, jstate)):
        exp = np_tree(exp)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(exp))
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(exp)):
            assert np.shape(x) == np.shape(y)
            np.testing.assert_array_equal(x, y)


def test_adam_moments_map_both_ways(models):
    """Two updates with the same gradients give the same moments in
    optax and in the port (rtol 1e-5); optax's moments loaded into the
    port then give the same third update as optax (rtol 1e-5)."""
    jmodel, tmodel, jparams, jstate = models
    trainer = _port_trainer(tmodel, jparams, jstate)
    for i in range(2):
        _set_grads(trainer, _grads(jparams, i))
        assert trainer.apply_gradients()
    j2, opt_state = _optax_steps(jparams, 2)
    count, mu, nu = optax_adam_moments(opt_state)
    got = adam_to_jax(trainer._adam_states(), trainer.params)
    assert int(got["count"]) == int(count) == 2
    for a, b in ((got["mu"], mu), (got["nu"], nu)):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(np_tree(b))):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-8)

    fresh = _port_trainer(tmodel, j2, jstate)
    fresh.restore({"params": np_tree(j2), "state": np_tree(jstate),
                   "opt_state": jax.tree_util.tree_map(np.asarray,
                                                       opt_state)},
                  opt=True)
    g3 = _grads(jparams, 2)
    _set_grads(fresh, g3)
    assert fresh.apply_gradients()
    updates, _ = _tx().update(g3, opt_state, j2)
    j3 = optax.apply_updates(j2, updates)
    exp = dict(tree_leaves_with_path(port_tree(j3, jstate, tmodel)[0]))
    for path, p in tree_leaves_with_path(fresh.params):
        np.testing.assert_allclose(p.detach().numpy(), exp[path].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
