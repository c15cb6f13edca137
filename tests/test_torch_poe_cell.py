"""The port's PoE + sampling cell and the filtering passes that step
through it, against the JAX package: ``poe_sample_cell_ref`` against the
Pallas cell in interpret mode (D = 128) and against the XLA composite
(D = 5); the cell path of ``z_filter`` against the JAX ``z_filter`` with
injected noise; the 200-particle BFVI forward on the Weizmann codecs with
JAX's noise injected."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer as JWeizmann
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu.ops.pallas.poe_cell import (_xla_composite,
                                                    poe_sample_cell as jcell)
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM
from multimodal_dmm_tpu_torch.ops.cuda import poe_cell as tcell

from torch_parity import port_tree, t

# (m, b, k, seed, inverse expert): the three shape sets of
# tests/test_pallas_cell.py.
SHAPES = {"plain": (3, 40, 5, 0, False), "inverse": (4, 16, 3, 1, True),
          "b13": (3, 13, 2, 2, False)}


def _cell_inputs(shape, d):
    m, b, k, seed, inverse = SHAPES[shape]
    rng = np.random.RandomState(seed)
    prior_mean = rng.randn(b, d).astype(np.float32)
    prior_std = (rng.rand(b, d) + 0.2).astype(np.float32)
    obs_mean = rng.randn(m, b, d).astype(np.float32)
    obs_std = (rng.rand(m, b, d) + 0.2).astype(np.float32)
    mask = rng.rand(m, b) > 0.4
    eps = rng.randn(k, b, d).astype(np.float32)
    if inverse:  # the smoothing pass's inverse global prior expert
        obs_std[-1] = -obs_std[-1]
        mask[-1] = True
    return prior_mean, prior_std, obs_mean, obs_std, mask, eps


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("d", [128, 5])
def test_cell_ref_matches_jax(shape, d):
    """D = 128 against the Pallas kernel in interpret mode, D = 5 against
    the XLA composite; rtol/atol 1e-5 (1e-4 with the inverse expert), as
    tests/test_pallas_cell.py holds the two JAX paths to each other."""
    args = _cell_inputs(shape, d)
    jargs = [jnp.asarray(a) for a in args]
    if d % 128 == 0:
        exp = jcell(*jargs, use_pallas=True, interpret=True)
    else:
        exp = _xla_composite(*jargs)
    got = tcell.poe_sample_cell_ref(*[t(a) for a in args])
    tol = 1e-4 if SHAPES[shape][4] else 1e-5
    for g, e in zip(got, exp):
        assert tuple(g.shape) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=tol,
                                   atol=tol)


def test_cell_entry_on_cpu_is_the_plain_version_and_has_no_gradient():
    args = [t(a) for a in _cell_inputs("plain", 8)]
    for g, e in zip(tcell.poe_sample_cell(*args),
                    tcell.poe_sample_cell_ref(*args)):
        assert torch.equal(g, e)
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        tcell.poe_sample_cell(*args)
    with torch.no_grad():
        tcell.poe_sample_cell(*args)
    assert tcell.poe_sample_cell_cuda.launches == 0


T, B, Z, H, K = 6, 5, 16, 12, 7


@pytest.fixture(scope="module")
def mlp_models():
    jmodel = JMultiDMM(["a", "b"], [4, 6], z_dim=Z, h_dim=H,
                       use_pallas=False, use_scan_kernel=False)
    tmodel = TMultiDMM(["a", "b"], [4, 6], z_dim=Z, h_dim=H)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, _ = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, tparams


def _experts(seed, n_exp=3):
    rng = np.random.RandomState(seed)
    zm = rng.randn(n_exp, T, B, Z).astype(np.float32)
    zs = (rng.rand(n_exp, T, B, Z) + 0.3).astype(np.float32)
    zk = (rng.rand(n_exp, T, B) > 0.3).astype(np.float32)
    return zm, zs, zk


@pytest.mark.parametrize("sample_init", [False, True])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_cell_path_z_filter_matches_jax(mlp_models, direction, sample_init):
    """The port's cell path (``use_cell``, K = 7 particles) against the
    JAX ``lax.scan`` cell with the same noise; rtol 1e-4 / atol 1e-5 as
    in tests/test_torch_dmm.py."""
    jmodel, tmodel, jparams, tparams = mlp_models
    zm, zs, zk = _experts(3)
    eps = np.asarray(jmodel._filter_eps(jax.random.PRNGKey(4), T, K, B,
                                        True, sample_init))
    exp = jmodel.z_filter(jparams, zm, zs, zk, None, direction=direction,
                          n_particles=K, sample_init=sample_init,
                          eps=jnp.asarray(eps))
    got = tmodel.z_filter(tparams, t(zm), t(zs), t(zk), direction=direction,
                          n_particles=K, sample_init=sample_init, eps=t(eps),
                          use_cell=True)
    for g, e in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


def test_cell_path_equals_scan_path(mlp_models):
    """Where the scan takes the particle count (K <= 32), stepping through
    the cell gives the scan's values: the two are the same loop."""
    _, tmodel, _, tparams = mlp_models
    zm, zs, zk = _experts(5)
    eps = t(np.random.RandomState(6).randn(T, K, B, Z).astype(np.float32))
    outs = [tmodel.z_filter(tparams, t(zm), t(zs), t(zk), n_particles=K,
                            eps=eps, use_cell=c) for c in (False, True)]
    for g, e in zip((*outs[1][0], *outs[1][1], outs[1][2]),
                    (*outs[0][0], *outs[0][1], outs[0][2])):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cell_path_refuses_gradients(mlp_models):
    _, tmodel, _, tparams = mlp_models
    zm, zs, zk = _experts(7)
    with pytest.raises(ValueError, match="no gradient"):
        tmodel.z_filter(tparams, t(zm).requires_grad_(True), t(zs), t(zk),
                        n_particles=K, use_cell=True,
                        gen=torch.Generator().manual_seed(0))


def test_bfvi_forward_200_particles_matches_jax(monkeypatch):
    """``forward(train=False, sample=False, flt_particles=200)``: the
    200-particle filter pass (cell path) and the MAP smoothing pass
    (scan) on the Weizmann codecs at z = h = 8, with the JAX forward's
    filter noise (``split(rng, 4)[1]``) injected; rtol 1e-4 / atol 1e-5."""
    args = types.SimpleNamespace(model_args={"z_dim": 8, "h_dim": 8},
                                 model="dmm",
                                 modalities=tw.DEFAULTS["modalities"])
    jmodel = JWeizmann.build_model(None, JMultiDMM, args)
    tmodel = tw.build_model(model_args={"z_dim": 8, "h_dim": 8})
    jparams, jstate = jmodel.init(jax.random.PRNGKey(1))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    t_max, b_dim, n_part = 5, 3, 200
    rng = np.random.RandomState(8)
    inputs = {
        "video": rng.rand(t_max, b_dim, 3, 64, 64).astype(np.float32),
        "person": rng.randint(0, 10, (t_max, b_dim, 1)).astype(np.float32),
        "action": rng.randint(0, 10, (t_max, b_dim, 1)).astype(np.float32)}
    inputs["video"][rng.rand(t_max, b_dim) < 0.4] = np.nan
    inputs["action"][rng.rand(t_max, b_dim) < 0.5] = np.nan
    key = jax.random.PRNGKey(9)
    (ji, jp, jr), _ = jmodel.forward(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()},
        rng=key, sample=False, flt_particles=n_part)
    jeps = np.asarray(jmodel._filter_eps(jax.random.split(key, 4)[1], t_max,
                                         n_part, b_dim, True, False))
    plain_eps = tmodel._filter_eps

    def filter_eps(gen, t_len, n, b, do_sample, sample_init, device):
        if do_sample:
            assert (t_len, n, b) == (t_max, n_part, b_dim)
            return t(jeps)
        return plain_eps(gen, t_len, n, b, do_sample, sample_init, device)

    monkeypatch.setattr(tmodel, "_filter_eps", filter_eps)
    with torch.no_grad():
        (ti, tp_, tr), _ = tmodel.forward(
            tparams, tstate, {m: t(v) for m, v in inputs.items()},
            sample=False, flt_particles=n_part)
    for g, e in zip((*ti, *tp_), (*ji, *jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)
    for m in tmodel.modalities:
        for g, e in zip(tr[m], jr[m]):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                       atol=1e-5)
