"""The port's MultiVRNN against the JAX package's, for both recurrence
modes (``no_inputs``; ``use_inputs``, with missing entries imputed from
the model's reconstructions): the MAP ``forward`` with all modalities and
with one absent, and the training step's loss and gradients. Inputs come
from a numpy seed (the shapes of tests/test_dks_vrnn.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models.vrnn import MultiVRNN as JMultiVRNN
from multimodal_dmm_tpu_torch.models.vrnn import MultiVRNN as TMultiVRNN

from torch_parity import (assert_trees_close, grads_of, port_tree, t,
                          with_grad)

T, B, Z, H = 10, 3, 4, 8
MODS = ["a", "b"]
DIMS = [2, 3]
REC_MULTS = {"a": 1.0, "b": 0.5}
MODES = ["no_inputs", "use_inputs"]


def _models(recur_mode, n_layers=1):
    kw = dict(z_dim=Z, h_dim=H, recur_mode=recur_mode, n_layers=n_layers)
    jmodel = JMultiVRNN(MODS, DIMS, **kw)
    tmodel = TMultiVRNN(MODS, DIMS, **kw)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(5))
    return jmodel, tmodel, jparams, jstate


def _inputs(seed, nan_frac=0.3):
    """Rows with 30 % of steps missing, and single missing entries (which
    ``use_inputs`` imputes elementwise)."""
    rng = np.random.RandomState(seed)
    out = {}
    for m, d in zip(MODS, DIMS):
        x = rng.randn(T, B, d).astype(np.float32)
        x[rng.rand(T, B) < nan_frac] = np.nan
        x[rng.rand(T, B, d) < 0.1] = np.nan
        out[m] = x
    return out


@pytest.mark.parametrize("absent", [None, "b"], ids=["all", "absent_b"])
@pytest.mark.parametrize("recur_mode", MODES)
def test_forward_map_matches_jax(recur_mode, absent):
    jmodel, tmodel, jparams, jstate = _models(recur_mode, n_layers=2)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    inputs = {m: v for m, v in _inputs(1).items() if m != absent}
    (ji, jp, jr), _ = jmodel.forward(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()},
        rng=jax.random.PRNGKey(3), sample=False)
    (ti, tp, tr), _ = tmodel.forward(
        tparams, tstate, {m: t(v) for m, v in inputs.items()}, sample=False,
        flt_particles=200)  # BFVI's evaluation arguments are ignored
    pairs = list(zip((*ti, *tp), (*ji, *jp)))
    pairs += [(g, e) for m in MODS for g, e in zip(tr[m], jr[m])]
    for g, e in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("recur_mode", MODES)
def test_step_loss_and_grads_match_jax(recur_mode):
    """Joint and unimodal ELBOs (``ModelBase.step``, MAP passes): in the
    unimodal variants the other modality is absent, and ``use_inputs``
    feeds the GRU its detached reconstruction."""
    jmodel, tmodel, jparams, jstate = _models(recur_mode)
    targets = _inputs(2, nan_frac=0.0)
    inputs = _inputs(2)
    mask = np.ones((T, B, 1), np.float32)
    mask[7:, 1] = 0.0
    kw = dict(uni_loss=True, sample=False)

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


def test_sampling_and_the_modalities_it_models():
    """Sampled passes draw from a torch.Generator (finite, shaped as the
    MAP pass); a label or image modality is refused, as the JAX package's
    VRNN fails on one."""
    _, tmodel, jparams, jstate = _models("use_inputs")
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    gen = torch.Generator().manual_seed(0)
    (ti, _, tr), _ = tmodel.forward(
        tparams, tstate, {m: t(v) for m, v in _inputs(3).items()}, gen=gen)
    assert ti[0].shape == (T, B, Z) and tr["b"][0].shape == (T, B, 3)
    rec = tmodel.sample(tparams, tstate, T, B, gen)
    assert all(bool(torch.isfinite(x).all()) for x in (*rec["a"], *ti))
    with pytest.raises(ValueError, match="Normal"):
        TMultiVRNN(["x", "y"], [2, 10], dists=["Normal", "Categorical"])
