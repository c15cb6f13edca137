"""The port's MultiDMM and training step against the JAX package's:
``z_filter`` in both directions with injected noise (against the
``lax.scan`` path and the interpret-mode Pallas kernel path), ``forward``
in all four modes in MAP mode, ``step`` loss, gradients and BatchNorm
state, and three optimizer steps of the trainer."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.models import codecs as tc
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM
from multimodal_dmm_tpu_torch.parallel import Mesh
from multimodal_dmm_tpu_torch.training.trainer import Trainer
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

from torch_parity import (assert_trees_close, grads_of, port_tree, t,
                          with_grad)

T, B, Z, H = 7, 5, 16, 12
MODS, DIMS = ["a", "b"], [4, 6]


@pytest.fixture(scope="module")
def mlp_models():
    jbase = JMultiDMM(MODS, DIMS, z_dim=Z, h_dim=H, use_pallas=False,
                      use_scan_kernel=False)
    jkern = JMultiDMM(MODS, DIMS, z_dim=Z, h_dim=H, use_pallas=False,
                      use_scan_kernel=True)
    jkern._scan_kernel_interpret = True
    tmodel = TMultiDMM(MODS, DIMS, z_dim=Z, h_dim=H)
    jparams, jstate = jbase.init(jax.random.PRNGKey(0))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return jbase, jkern, tmodel, jparams, jstate, tparams, tstate


def _mlp_inputs(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for m, d in zip(MODS, DIMS):
        x = rng.randn(T, B, d).astype(np.float32)
        x[rng.rand(T, B) < 0.3] = np.nan
        out[m] = x
    return out


@pytest.mark.parametrize("jax_path", ["scan", "kernel_interpret"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_z_filter_with_injected_eps(mlp_models, jax_path, direction):
    jbase, jkern, tmodel, jparams, _, tparams, _ = mlp_models
    jmodel = jbase if jax_path == "scan" else jkern
    rng = np.random.RandomState(2)
    n_exp, k = 3, 4
    zm = rng.randn(n_exp, T, B, Z).astype(np.float32)
    zs = (rng.rand(n_exp, T, B, Z) + 0.3).astype(np.float32)
    zk = (rng.rand(n_exp, T, B) > 0.3).astype(np.float32)
    eps = rng.randn(T, k, B, Z).astype(np.float32)
    exp = jmodel.z_filter(jparams, zm, zs, zk, None, direction=direction,
                          eps=jnp.asarray(eps))
    got = tmodel.z_filter(tparams, t(zm), t(zs), t(zk), direction=direction,
                          eps=t(eps))
    for g, e in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["bfilter", "ffilter", "fsmooth",
                                  "bsmooth"])
def test_forward_map_all_modes(mlp_models, mode):
    jbase, _, tmodel, jparams, jstate, tparams, tstate = mlp_models
    inputs = _mlp_inputs(1)
    (ji, jp, jr), _ = jbase.forward(jparams, jstate,
                                    {m: jnp.asarray(v) for m, v in
                                     inputs.items()},
                                    rng=jax.random.PRNGKey(3), mode=mode,
                                    sample=False)
    (ti, tp_, tr), _ = tmodel.forward(tparams, tstate,
                                      {m: t(v) for m, v in inputs.items()},
                                      mode=mode, sample=False)
    for g, e in zip((*ti, *tp_), (*ji, *jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)
    for m in MODS:
        for g, e in zip(tr[m], jr[m]):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# The training step on a small image + label model (deterministic config)
# ---------------------------------------------------------------------------

STEP_T, STEP_B = 6, 4
STEP_ARGS = dict(uni_loss=True, sample=False, match_mult=0.0,
                 train_particles=1, flt_particles=1)
REC_MULTS = {"video": 1.0, "label": 2.0}


def _image_models():
    kw = dict(img_size=8, n_kernels=8)
    jmodel = JMultiDMM(
        ["video", "label"], [(3, 8, 8), 4], dists=["Bernoulli",
                                                   "Categorical"],
        encoders={"video": jc.image_encoder_codec(8, **kw)},
        decoders={"video": jc.image_decoder_codec(8, **kw)},
        z_dim=8, h_dim=8)
    tmodel = TMultiDMM(
        ["video", "label"], [(3, 8, 8), 4], dists=["Bernoulli",
                                                   "Categorical"],
        encoders={"video": tc.image_encoder_codec(8, **kw)},
        decoders={"video": tc.image_decoder_codec(8, **kw)},
        z_dim=8, h_dim=8)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(1))
    return jmodel, tmodel, jparams, jstate


def _image_batch(seed):
    """Targets are the full batch; inputs have 20% of frames deleted."""
    rng = np.random.RandomState(seed)
    video = (rng.rand(STEP_T, STEP_B, 3, 8, 8) > 0.5).astype(np.float32)
    label = rng.randint(0, 4, (STEP_T, STEP_B, 1)).astype(np.float32)
    targets = {"video": video, "label": label}
    inputs = {"video": video.copy(), "label": label.copy()}
    inputs["video"][rng.rand(STEP_T, STEP_B) < 0.2] = np.nan
    mask = np.ones((STEP_T, STEP_B, 1), np.float32)
    return inputs, targets, mask


@pytest.fixture(scope="module")
def image_models():
    return _image_models()


def test_step_loss_grads_and_bn_state(image_models):
    jmodel, tmodel, jparams, jstate = image_models
    inputs, targets, mask = _image_batch(7)
    jx = lambda d: {m: jnp.asarray(v) for m, v in d.items()}  # noqa: E731

    def jloss(p):
        return jmodel.step(p, jstate, jx(inputs), jnp.asarray(mask), 0.5,
                           REC_MULTS, jax.random.PRNGKey(2),
                           targets=jx(targets), train=True, **STEP_ARGS)

    (jl, jnew), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, tnew = tmodel.step(tparams, tstate, {m: t(v) for m, v in
                                             inputs.items()}, t(mask), 0.5,
                           REC_MULTS, None,
                           targets={m: t(v) for m, v in targets.items()},
                           train=True, **STEP_ARGS)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    exp_g, exp_state = port_tree(jg, jnew, tmodel)
    assert_trees_close(exp_g, grads_of(tparams), rtol=5e-3, atol=5e-4,
                       normalise=True)
    assert_trees_close(exp_state, tnew, rtol=1e-4, atol=1e-5)


def test_trainer_three_steps_match_optax(image_models):
    """Three steps of the port's Adam + L2 + skip-non-finite chain equal
    optax's add_decayed_weights + adam under apply_if_finite."""
    jmodel, tmodel, jparams, jstate = image_models
    lr, wd = 5e-4, 1e-4
    tx = optax.apply_if_finite(optax.chain(optax.add_decayed_weights(wd),
                                           optax.adam(lr)), 10 ** 6)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    trainer = Trainer(tmodel, lr=lr, w_decay=wd, rec_mults=REC_MULTS,
                      train_args=STEP_ARGS, params=tparams, state=tstate,
                      device="cpu")
    params, state, opt_state = jparams, jstate, tx.init(jparams)

    @jax.jit
    def jax_step(params, state, opt_state, inputs, targets, mask):
        def loss_fn(p):
            loss, new_state = jmodel.step(
                p, state, inputs, mask, 1.0, REC_MULTS,
                jax.random.PRNGKey(0), targets=targets, train=True,
                **STEP_ARGS)
            return loss / jnp.sum(mask), (loss, new_state)

        grads, (loss, new_state) = jax.grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_state, new_opt,
                loss)

    for i in range(3):
        inputs, targets, mask = _image_batch(10 + i)
        n_data = float(mask.sum())
        params, state, opt_state, jl = jax_step(
            params, state, opt_state,
            {m: jnp.asarray(v) for m, v in inputs.items()},
            {m: jnp.asarray(v) for m, v in targets.items()},
            jnp.asarray(mask))
        tl, applied = trainer.train_step(
            {m: t(v) for m, v in inputs.items()},
            {m: t(v) for m, v in targets.items()}, t(mask), 1.0, n_data)
        assert applied
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    exp_p, exp_s = port_tree(params, state, tmodel)
    # The conv/deconv biases that feed a training-mode BatchNorm have a
    # gradient that is zero up to rounding noise in both frameworks, and
    # Adam moves a weight by about lr per step whatever its gradient's
    # size: those biases may differ by up to 2 * lr per step.
    pre_bn = {(side, "video", conv, i, "b") for side, conv in
              (("enc", "convs"), ("dec", "deconvs")) for i in (0, 1)}
    exp_leaves = dict(tree_leaves_with_path(exp_p))
    for path, got in tree_leaves_with_path(trainer.params):
        np.testing.assert_allclose(
            got.detach().numpy(), exp_leaves[path].numpy(), rtol=1e-4,
            atol=6 * lr if path in pre_bn else 1e-5, err_msg=str(path))
    assert_trees_close(exp_s, trainer.state, rtol=1e-4, atol=1e-5)


def test_nonfinite_gradient_skips_update(image_models):
    _, tmodel, jparams, jstate = image_models
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    trainer = Trainer(tmodel, lr=1e-3, params=tparams, state=tstate,
                      device="cpu")
    before = [p.detach().clone() for p in trainer.leaves]
    for p in trainer.leaves:
        p.grad = torch.ones_like(p)
    trainer.leaves[3].grad[0] = float("nan")
    assert trainer.apply_gradients() is False
    assert trainer.optimizer.state == {} or all(
        "step" not in s for s in trainer.optimizer.state.values())
    for a, b in zip(before, trainer.leaves):
        assert torch.equal(a, b.detach())
    trainer.leaves[3].grad[0] = 1.0
    assert trainer.apply_gradients() is True
    assert not torch.equal(before[3], trainer.leaves[3].detach())


@pytest.mark.parametrize("branch", ["ragged_mode_scans", "merge_mode_scans",
                                    "unfused", "set_variant_mesh"])
def test_unported_branches_raise(mlp_models, branch):
    """The step's branches, all ported now: the merged and unfused ones,
    and ``ragged_mode_scans``, which is accepted (the two-scan loop
    computes the ragged pass; tests/test_torch_ragged.py holds all three
    against the JAX package), give a finite loss here. Under
    ``set_variant_mesh`` (a 2-D mesh) each model rank runs its share of
    the stacked variant rows, and model rank 0 alone adds the prior
    matching: with MAP filtering the two shares' losses add up to the
    whole step's (tests/test_torch_parallel.py runs the ranks)."""
    _, _, tmodel, _, _, tparams, tstate = mlp_models
    inputs = {m: t(v) for m, v in _mlp_inputs(4).items()}
    mask = torch.ones((T, B, 1))
    if branch == "set_variant_mesh":
        kw = dict(train_particles=1, sample=False)
        whole, _ = tmodel.step(tparams, tstate, inputs, mask, 1.0, {},
                               torch.Generator().manual_seed(0), **kw)
        shares = []
        for rank in range(2):
            mesh = Mesh.__new__(Mesh)
            mesh.n_data, mesh.n_model = 1, 2
            mesh.data_index, mesh.model_index = 0, rank
            tmodel.set_variant_mesh(mesh)
            try:
                shares.append(tmodel.step(
                    tparams, tstate, inputs, mask, 1.0, {},
                    torch.Generator().manual_seed(0), **kw)[0])
            finally:
                tmodel.set_variant_mesh(None)
        assert torch.isfinite(whole) and all(s != 0 for s in shares)
        torch.testing.assert_close(shares[0] + shares[1], whole, rtol=1e-5,
                                   atol=0.0)
        return
    kw = {"unfused": {"fused": False}}.get(branch, {branch: True})
    loss, _ = tmodel.step(tparams, tstate, inputs, mask, 1.0, {},
                          torch.Generator().manual_seed(0),
                          train_particles=3, **kw)
    assert torch.isfinite(loss)
