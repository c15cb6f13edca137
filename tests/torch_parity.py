"""Helpers shared by the tests that hold the PyTorch port against the
JAX package: trees of numpy arrays carried across, and comparisons of
trees with the port's layouts."""

import numpy as np
import jax
import torch

from multimodal_dmm_tpu_torch.convert import params_from_jax
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path, tree_map


def np_tree(tree):
    """A JAX pytree as nested dicts/lists of numpy arrays (scalars kept)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, tree)


def port_tree(jparams, jstate, model):
    """The port's (params, state) on the CPU from JAX trees."""
    return params_from_jax(np_tree(jparams), np_tree(jstate), model,
                           device="cpu")


def with_grad(tree):
    return tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


def t(x):
    return torch.tensor(np.asarray(x))


def assert_trees_close(expected, got, rtol, atol, normalise=False):
    """Compare two port-layout trees leaf by leaf (same paths); with
    ``normalise`` each leaf pair is divided by the expected leaf's
    max-abs first. A leaf whose max-abs is below 1e-5 of the tree's
    largest is a structurally zero gradient (a bias feeding a
    training-mode BatchNorm, whose gradient is rounding noise in both
    frameworks) and is divided by the tree's largest max-abs instead."""
    exp_leaves = dict(tree_leaves_with_path(expected))
    got_leaves = dict(tree_leaves_with_path(got))
    assert exp_leaves.keys() == got_leaves.keys()
    top = max(float(e.detach().abs().max()) for e in exp_leaves.values())
    for path, e in exp_leaves.items():
        e = e.detach().numpy()
        g = got_leaves[path].detach().numpy()
        scale = 1.0
        if normalise:
            scale = np.abs(e).max()
            scale = (top if scale < 1e-5 * top else scale) + 1e-6
        np.testing.assert_allclose(g / scale, e / scale, rtol=rtol,
                                   atol=atol, err_msg=str(path))


def grads_of(tree):
    return tree_map(lambda x: x.grad if x.grad is not None
                    else torch.zeros_like(x), tree)


def weizmann_step(model_args, zh=32, t_dim=6, b_dim=4):
    """Loss and gradients of the Weizmann model's MAP step (full-size image
    codecs, latent width ``zh``, the app's ``model_args`` besides) in JAX
    and in the port, on one batch and the same weights: ((jax loss,
    grads), (port loss, grads)), the grads as {path: array} in the port's
    layout."""
    import types
    import jax.numpy as jnp
    from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer
    from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
    from multimodal_dmm_tpu_torch.apps import weizmann as tw
    mods = ["video", "person", "action"]
    model_args = dict(model_args, z_dim=zh, h_dim=zh)
    args = types.SimpleNamespace(model_args=dict(model_args), model="dmm",
                                 modalities=mods)
    jmodel = WeizmannTrainer.build_model(None, JMultiDMM, args)
    tmodel = tw.build_model(mods, dict(model_args))
    rng = np.random.RandomState(3)
    targets = {
        "video": (rng.rand(t_dim, b_dim, 3, 64, 64) > 0.5).astype(
            np.float32),
        "person": rng.randint(0, 9, (t_dim, b_dim, 1)).astype(np.float32),
        "action": rng.randint(0, 10, (t_dim, b_dim, 1)).astype(np.float32)}
    inputs = {m: v.copy() for m, v in targets.items()}
    inputs["video"][rng.rand(t_dim, b_dim) < 0.3] = np.nan
    mask = np.ones((t_dim, b_dim, 1), np.float32)
    rec_mults = {"video": 1.0, "person": 10.0, "action": 10.0}
    kw = dict(sample=False, train_particles=1, match_mult=0.0,
              uni_loss=True, train=True)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    jx = lambda d: {m: jnp.asarray(v) for m, v in d.items()}  # noqa: E731

    def jloss(p):
        return jmodel.step(p, jstate, jx(inputs), jnp.asarray(mask), 1.0,
                           rec_mults, jax.random.PRNGKey(2),
                           targets=jx(targets), **kw)

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, _ = tmodel.step(tparams, tstate, {m: t(v) for m, v in inputs.items()},
                        t(mask), 1.0, rec_mults,
                        torch.Generator().manual_seed(0),
                        targets={m: t(v) for m, v in targets.items()}, **kw)
    tl.backward()
    exp_g, _ = port_tree(jg, jstate, tmodel)
    leaves = lambda g: {p: v.detach().numpy()  # noqa: E731
                        for p, v in tree_leaves_with_path(g)}
    return ((float(jl), leaves(exp_g)),
            (tl.item(), leaves(grads_of(tparams))))


def leaf_errors(got, exp):
    """{path: relative Frobenius error} of ``got`` against ``exp``, leaves
    that are rounding noise (under 1e-5 of the largest, such as the bias
    of a convolution that feeds a training-mode BatchNorm) left out."""
    top = max(np.abs(e).max() for e in exp.values())
    return {p: float(np.linalg.norm(got[p] - e) / np.linalg.norm(e))
            for p, e in exp.items() if np.abs(e).max() >= 1e-5 * top}
