"""The port's grouped filtering pass and the ragged, merged and unfused
branches of ``MultiDMM.step`` against the JAX package's, on the same
weights and noise: ``z_filter_grouped`` with injected ``eps``; each
branch's loss, gradients and state in MAP mode and with the same filter
noise drawn on both sides (the ragged branch on the image model, for its
BatchNorm state; the merged and unfused ones on the MLP model, which
compiles in seconds on the JAX side); and the port's step with
``ragged_mode_scans`` (a hint the port accepts: its ragged pass is the
two-scan loop) against its two-scan step, as tests/test_fused_step.py
holds the JAX one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM

from test_torch_dmm import REC_MULTS, _image_batch, _image_models
from torch_parity import (assert_trees_close, grads_of, port_tree, t,
                          with_grad)

T, B, Z, H = 7, 5, 16, 12
MODS, DIMS = ["a", "b", "c"], [4, 6, 2]


@pytest.fixture(scope="module")
def mlp_models():
    jmodel = JMultiDMM(MODS, DIMS, z_dim=Z, h_dim=H, use_pallas=False,
                       scan_unroll=1)
    tmodel = TMultiDMM(MODS, DIMS, z_dim=Z, h_dim=H)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, tparams, tstate, jstate


def _mlp_batch(seed):
    """Targets are the full batch; inputs have 30% of steps deleted."""
    rng = np.random.RandomState(seed)
    targets = {m: rng.randn(T, B, d).astype(np.float32)
               for m, d in zip(MODS, DIMS)}
    inputs = {m: x.copy() for m, x in targets.items()}
    for x in inputs.values():
        x[rng.rand(T, B) < 0.3] = np.nan
    return inputs, targets, np.ones((T, B, 1), np.float32)


def _experts(seed, n_exp=3):
    rng = np.random.RandomState(seed)
    zm = rng.randn(n_exp, T, B, Z).astype(np.float32)
    zs = (rng.rand(n_exp, T, B, Z) + 0.3).astype(np.float32)
    zk = (rng.rand(n_exp, T, B) > 0.3).astype(np.float32)
    return zm, zs, zk


@pytest.mark.parametrize("k_groups", [(1, 3), (2, 3)])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_z_filter_grouped_matches_jax(mlp_models, direction, k_groups):
    """rtol 1e-5 / atol 1e-6 against the JAX ragged ``lax.scan``."""
    jmodel, tmodel, jparams, tparams, _, _ = mlp_models
    zm, zs, zk = _experts(1)
    eps = np.random.RandomState(2).randn(T, sum(k_groups), B,
                                         Z).astype(np.float32)
    exp = jmodel.z_filter_grouped(jparams, zm, zs, zk, jnp.asarray(eps),
                                  k_groups, direction=direction)
    got = tmodel.z_filter_grouped(tparams, t(zm), t(zs), t(zk), t(eps),
                                  k_groups, direction=direction)
    for g, e in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2])):
        assert g.shape == (len(k_groups), T, B, Z)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-6)


def test_z_filter_grouped_equals_per_group_z_filter(mlp_models):
    """Group g of the ragged pass is ``z_filter`` on its slice of the
    noise, bit for bit."""
    _, tmodel, _, tparams, _, _ = mlp_models
    zm, zs, zk = (t(x) for x in _experts(3))
    eps = t(np.random.RandomState(4).randn(T, 6, B, Z).astype(np.float32))
    infer, prior, samples = tmodel.z_filter_grouped(
        tparams, zm, zs, zk, eps, (1, 5), direction="bwd")
    for g, (s, e) in enumerate(((0, 1), (1, 6))):
        gi, gp, gs = tmodel.z_filter(tparams, zm, zs, zk, direction="bwd",
                                     eps=eps[:, s:e])
        for a, b in zip((*gi, *gp, gs), (infer[0][g], infer[1][g],
                                         prior[0][g], prior[1][g],
                                         samples[g])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="particles"):
        tmodel.z_filter_grouped(tparams, zm, zs, zk, eps, (1, 3))


# ---------------------------------------------------------------------------
# The step's branches against the JAX package's
# ---------------------------------------------------------------------------

class Noise:
    """The filtering passes' noise, drawn from one numpy stream in the
    order the passes ask for it; one instance per side, same seed."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.shapes = []

    def draw(self, t_max, k, b_dim, z_dim, do_sample, sample_init):
        if do_sample:
            eps = self.rng.randn(t_max, k, b_dim, z_dim)
        else:
            eps = np.zeros((t_max, 1, b_dim, z_dim))
            if sample_init:
                eps[0] = self.rng.randn(1, b_dim, z_dim)
        self.shapes.append(eps.shape)
        return eps.astype(np.float32)


def _inject(monkeypatch, jmodel, tmodel, seed):
    jn, tn = Noise(seed), Noise(seed)
    z = tmodel.z_dim
    monkeypatch.setattr(jmodel, "_filter_eps", lambda rng, t_, k, b, ds, si:
                        jnp.asarray(jn.draw(t_, k, b, z, ds, si)))
    monkeypatch.setattr(tmodel, "_filter_eps",
                        lambda gen, t_, k, b, ds, si, device:
                        t(tn.draw(t_, k, b, z, ds, si)))
    return jn, tn


BRANCHES = {"ragged": dict(ragged_mode_scans=True),
            "merge": dict(merge_mode_scans=True),
            "unfused": dict(fused=False)}
MLP_REC_MULTS = {"a": 0.5, "b": 0.2, "c": 1.0}


@pytest.fixture(scope="module")
def image_models():
    return _image_models()


@pytest.mark.parametrize("noise", ["map", "injected"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_branch_matches_jax(image_models, mlp_models, monkeypatch,
                                 branch, noise):
    """Loss (rtol 1e-4), max-abs-normalised gradients (rtol 5e-3 / atol
    5e-4) and state (rtol 1e-4 / atol 1e-5) of the step, the ragged
    branch on the image + label model (BatchNorm state), the others on
    the MLP model; first deterministic (``sample=False``, one particle),
    then sampled (three s-mode particles) with the same filter noise on
    both sides; prior matching off (its rollout noise is drawn inside the
    JAX step)."""
    if branch == "ragged":
        jmodel, tmodel, jparams, jstate = image_models
        inputs, targets, mask = _image_batch(8)
        rec_mults = REC_MULTS
    else:
        jmodel, tmodel, jparams, _, _, jstate = mlp_models
        inputs, targets, mask = _mlp_batch(8)
        rec_mults = MLP_REC_MULTS
    kw = dict(BRANCHES[branch], uni_loss=True, match_mult=0.0,
              flt_particles=1)
    if noise == "map":
        kw.update(sample=False, train_particles=1)
    else:
        kw.update(sample=True, train_particles=3)
        jn, tn = _inject(monkeypatch, jmodel, tmodel, seed=5)
    jx = lambda d: {m: jnp.asarray(v) for m, v in d.items()}  # noqa: E731

    def jloss(p):
        return jmodel.step(p, jstate, jx(inputs), jnp.asarray(mask), 0.5,
                           rec_mults, jax.random.PRNGKey(2),
                           targets=jx(targets), train=True, **kw)

    (jl, jnew), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, tnew = tmodel.step(tparams, tstate, {m: t(v) for m, v in
                                             inputs.items()}, t(mask), 0.5,
                           rec_mults, torch.Generator().manual_seed(0),
                           targets={m: t(v) for m, v in targets.items()},
                           train=True, **kw)
    tl.backward()
    if noise == "injected":
        assert tn.shapes == jn.shapes and len(tn.shapes) >= 3
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    exp_g, exp_state = port_tree(jg, jnew, tmodel)
    assert_trees_close(exp_g, grads_of(tparams), rtol=5e-3, atol=5e-4,
                       normalise=True)
    if branch == "ragged":  # the MLP model has no BatchNorm state
        assert_trees_close(exp_state, tnew, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sample,flt_particles",
                         [(True, 1), (False, 1), (True, 3)])
def test_ragged_step_matches_two_scan_step(mlp_models, sample,
                                           flt_particles):
    """The port's step with ``ragged_mode_scans`` against its two-scan
    step under one generator seed (the same noise,
    tests/test_fused_step.py:163): loss and gradients within rtol 5e-4 /
    atol 1e-5."""
    _, tmodel, _, tparams, tstate, _ = mlp_models
    rng = np.random.RandomState(6)
    inputs = {}
    for m, d in zip(MODS, DIMS):
        x = rng.randn(T, B, d).astype(np.float32)
        x[rng.rand(T, B) < 0.3] = np.nan
        inputs[m] = t(x)
    mask = torch.ones((T, B, 1))
    kw = dict(targets=inputs, uni_loss=True, sample=sample, match_mult=0.01,
              train_particles=7, flt_particles=flt_particles)
    out = []
    for ragged in (False, True):
        params = with_grad(tparams)
        loss, _ = tmodel.step(params, tstate, inputs, mask, 0.7,
                              MLP_REC_MULTS,
                              torch.Generator().manual_seed(9),
                              ragged_mode_scans=ragged, **kw)
        loss.backward()
        out.append((loss.item(), grads_of(params)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    assert_trees_close(out[0][1], out[1][1], rtol=5e-4, atol=1e-5)
