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
