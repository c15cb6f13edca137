"""The port's GRU and MultiDKS against the JAX package's: ``gru_step`` with
one and two layers; the MAP ``forward`` of the four baselines (rnn_dir x
rnn_skip) with an absent modality, a label modality (embedding encoder)
and sequences whose observations end early (the t > t_stop tail, where
the posterior is the prior); the training step's loss and gradients.
Inputs come from a numpy seed; JAX's parameters are carried across with
``convert.params_from_jax``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.models.dks import MultiDKS as JMultiDKS
from multimodal_dmm_tpu_torch.convert import tree_from_jax
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.models.dks import MultiDKS as TMultiDKS
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

from torch_parity import (assert_trees_close, grads_of, np_tree, port_tree,
                          t, with_grad)

# The MLP shapes of tests/test_dks_golden.py.
Z, H, T, B = 4, 8, 9, 3
MODS = ["m0", "m1", "lab"]
DIMS = [2, 3, 5]
DISTS = ["Normal", "Normal", "Categorical"]
VARIANTS = [("bwd", True), ("bwd", False), ("fwd", True), ("fwd", False)]
REC_MULTS = {"m0": 1.0, "m1": 0.5, "lab": 2.0}


@pytest.mark.parametrize("n_layers", [1, 2])
def test_gru_step_matches_jax(n_layers):
    rng = np.random.RandomState(n_layers)
    jp = jnn.gru_init(jax.random.PRNGKey(n_layers), 6, H, n_layers)
    x = rng.randn(B, 6).astype(np.float32)
    h = rng.randn(n_layers, B, H).astype(np.float32)
    exp = jnn.gru_step(jp, jnp.asarray(x), jnp.asarray(h))
    got = tnn.gru_step(tree_from_jax(np_tree(jp), "cpu"), t(x), t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-6)
    # The port's initialiser draws the same shapes and bounds.
    tp = tnn.gru_init(torch.Generator().manual_seed(0), 6, H, n_layers)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            assert tuple(tl[k].shape) == tuple(np.shape(jl[k]))
            assert float(tl[k].abs().max()) <= 1.0 / np.sqrt(H)


def _models(rnn_dir, rnn_skip, feat_to_z=True):
    kw = dict(dists=DISTS, z_dim=Z, h_dim=H, rnn_dir=rnn_dir,
              rnn_skip=rnn_skip, feat_to_z=feat_to_z)
    jmodel = JMultiDKS(MODS, DIMS, **kw)
    tmodel = TMultiDKS(MODS, DIMS, **kw)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(7))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, jstate, tparams, tstate


def _inputs(seed, absent=(), tail=True):
    """Normal modalities with 30 % of steps missing, labels in 0..4; with
    ``tail`` every modality of column 0 ends at t = 4 and one modality of
    column 1 at t = 6."""
    rng = np.random.RandomState(seed)
    out = {}
    for m, d in zip(MODS, DIMS):
        if m == "lab":
            x = rng.randint(0, d, (T, B, 1)).astype(np.float32)
        else:
            x = rng.randn(T, B, d).astype(np.float32)
        x[rng.rand(T, B) < 0.3] = np.nan
        if tail:
            x[5:, 0] = np.nan
            if m == "m1":
                x[7:, 1] = np.nan
        out[m] = x
    return {m: v for m, v in out.items() if m not in absent}


def _close(got, exp, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("absent", [(), ("m1",)], ids=["all", "absent_m1"])
@pytest.mark.parametrize("rnn_dir,rnn_skip", VARIANTS)
def test_forward_map_matches_jax(rnn_dir, rnn_skip, absent):
    jmodel, tmodel, jparams, jstate, tparams, tstate = _models(rnn_dir,
                                                               rnn_skip)
    inputs = _inputs(1, absent)
    (ji, jp, jr), _ = jmodel.forward(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()},
        rng=jax.random.PRNGKey(3), sample=False)
    (ti, tp, tr), _ = tmodel.forward(
        tparams, tstate, {m: t(v) for m, v in inputs.items()}, sample=False,
        flt_particles=200)  # BFVI's evaluation arguments are ignored
    for g, e in zip((*ti, *tp), (*ji, *jp)):
        _close(g, e)
    for m in MODS:
        for g, e in zip(tr[m], jr[m]):
            _close(g, e)
    if not absent:
        # Past column 0's last joint observation the posterior is the
        # prior.
        np.testing.assert_array_equal(ti[0][5:, 0].numpy(),
                                      tp[0][5:, 0].numpy())


@pytest.mark.parametrize("rnn_dir,rnn_skip,feat_to_z,uni_loss", [
    ("bwd", True, True, True), ("fwd", False, False, False)])
def test_step_loss_and_grads_match_jax(rnn_dir, rnn_skip, feat_to_z,
                                       uni_loss):
    """The joint and unimodal ELBOs through ``ModelBase.step`` (MAP
    passes), as the Weizmann (feat_to_z, uni_loss) and spirals (neither)
    apps train the baselines."""
    jmodel, tmodel, jparams, jstate, _, _ = _models(rnn_dir, rnn_skip,
                                                    feat_to_z)
    targets = _inputs(2, tail=False)
    inputs = {m: v.copy() for m, v in targets.items()}
    for m in ("m0", "m1"):
        inputs[m][np.random.RandomState(3).rand(T, B) < 0.2] = np.nan
    mask = np.ones((T, B, 1), np.float32)
    mask[6:, 2] = 0.0
    kw = dict(uni_loss=uni_loss, sample=False)

    def jloss(p):
        return jmodel.step(p, jstate,
                           {m: jnp.asarray(v) for m, v in inputs.items()},
                           jnp.asarray(mask), 0.7, REC_MULTS,
                           jax.random.PRNGKey(2),
                           targets={m: jnp.asarray(v)
                                    for m, v in targets.items()},
                           train=True, **kw)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, _ = tmodel.step(tparams, tstate, {m: t(v) for m, v in inputs.items()},
                        t(mask), 0.7, REC_MULTS, None,
                        targets={m: t(v) for m, v in targets.items()},
                        train=True, **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    exp_g, _ = port_tree(jg, jstate, tmodel)
    assert_trees_close(exp_g, grads_of(tparams), rtol=5e-3, atol=5e-4,
                       normalise=True)


def test_sampled_forward_and_sample_are_finite():
    """The sampled passes draw from a torch.Generator (other numbers than
    JAX's): their shapes and finiteness, and the prior's rollout."""
    _, tmodel, _, _, tparams, tstate = _models("bwd", True)
    gen = torch.Generator().manual_seed(0)
    (ti, tp, tr), _ = tmodel.forward(
        tparams, tstate, {m: t(v) for m, v in _inputs(4).items()}, gen=gen)
    assert ti[0].shape == (T, B, Z) and tr["lab"][0].shape == (T, B, 5)
    assert all(bool(torch.isfinite(x).all()) for x in (*ti, *tp))
    rec = tmodel.sample(tparams, tstate, T, B, gen)
    assert rec["m1"][0].shape == (T, B, 3)
    assert bool(torch.isfinite(rec["m1"][1]).all())


def test_params_tree_matches_jax():
    """``init`` gives the JAX package's tree (paths and shapes, GRU weights
    in its layout), so its checkpoints carry across leaf for leaf."""
    _, tmodel, _, _, tparams, tstate = _models("fwd", True)
    for conv, own in zip((tparams, tstate), tmodel.init(0, device="cpu")):
        conv, own = (dict((p, tuple(x.shape)) for p, x in
                          tree_leaves_with_path(tree)) for tree in (conv, own))
        assert conv == own
    assert tparams["rnn"]["m0"]["layers"][0]["w_ih"].shape == (H, 3 * H)
