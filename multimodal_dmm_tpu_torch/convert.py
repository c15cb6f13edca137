"""Carry weights and Adam moments between the JAX package's trees and the
port's.

``params_from_jax(params, state, model)`` takes the JAX (params, state)
pytrees as nested dicts/lists of numpy arrays (BatchNorm state keeps its
scalar ``eps``/``momentum`` leaves as they are) and returns the port's
trees of tensors; ``params_to_jax`` is the way back, to numpy trees in the
JAX layout. ``adam_to_jax`` / ``load_adam`` carry ``torch.optim.Adam``'s
per-leaf state to and from the moments of optax's ``ScaleByAdamState``
(``count``, ``mu``, ``nu``, trees in the params' JAX layout), and
``optax_adam_moments`` finds that state in a pickled optax optimizer
state. Nothing here imports JAX or optax. Layout changes:

- linear ``w`` (in, out) -> (out, in), GTF layers included;
- conv ``w`` HWIO -> OIHW, and 1-D WIO -> (out, in, k);
- deconv ``w``: the JAX package stores the spatially flipped HWIO (WIO)
  kernel of the equivalent input-dilated forward convolution;
  ``ConvTranspose2d`` wants (in, out, kH, kW) unflipped,
  ``ConvTranspose1d`` (in, out, k);
- embeddings, biases, BatchNorm scale/bias/running mean/var, the global
  prior ``z0_mean``/``z0_log_std``, the GRUs' weights (``w_ih`` (in, 3H),
  ``w_hh`` (H, 3H), which the port keeps in the JAX layout) and initial
  states ``h0`` are copied as they are.
"""

import numpy as np
import torch

from . import resolve_device
from .tree import tree_leaves_with_path, tree_map_with_path


def _convert_leaf(path, x):
    x = np.asarray(x, dtype=np.float32)
    if path and path[-1] == "w":
        if "deconvs" in path:
            if x.ndim == 3:
                return np.ascontiguousarray(x[::-1].transpose(1, 2, 0))
            return np.ascontiguousarray(
                x[::-1, ::-1].transpose(2, 3, 0, 1))
        if "convs" in path:
            if x.ndim == 3:
                return np.ascontiguousarray(x.transpose(2, 1, 0))
            return np.ascontiguousarray(x.transpose(3, 2, 0, 1))
        if len(path) >= 2 and path[-2] == "embed":
            return x
        if x.ndim == 2:
            return np.ascontiguousarray(x.T)
    return x


def tree_from_jax(tree, device, path=()):
    """Convert one JAX subtree whose position in the model tree is
    ``path`` (the mapping of a leaf depends on its path)."""
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, device, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device, path + (i,))
                for i, v in enumerate(tree)]
    if path and path[-1] in ("eps", "momentum"):
        return float(tree)  # BatchNorm's scalar hyper-parameters
    return torch.from_numpy(_convert_leaf(path, tree).copy()).to(device)


def params_from_jax(params, state, model, device="cuda"):
    """(params, state) of the port from the JAX package's trees for
    ``model`` (the port's MultiDMM, MultiDKS or MultiVRNN); each leaf's
    mapping is decided by its path (the GRUs' ``w_ih``/``w_hh`` keep the
    JAX layout)."""
    dev = resolve_device(device)
    for tree in (params, state):
        for side in ("enc", "dec"):
            if side in tree and set(tree[side]) != set(model.modalities):
                raise ValueError(
                    "JAX tree has %s modalities %s, the model has %s"
                    % (side, sorted(tree[side]), sorted(model.modalities)))
    return tree_from_jax(params, dev), tree_from_jax(state, dev)


def _leaf_to_jax(path, x):
    """The inverse of ``_convert_leaf``."""
    x = x.detach().cpu().numpy()
    if path and path[-1] == "w":
        if "deconvs" in path:
            if x.ndim == 3:
                return np.ascontiguousarray(x.transpose(2, 0, 1)[::-1])
            return np.ascontiguousarray(x.transpose(2, 3, 0, 1)[::-1, ::-1])
        if "convs" in path:
            if x.ndim == 3:
                return np.ascontiguousarray(x.transpose(2, 1, 0))
            return np.ascontiguousarray(x.transpose(2, 3, 1, 0))
        if len(path) >= 2 and path[-2] == "embed":
            return x.copy()
        if x.ndim == 2:
            return np.ascontiguousarray(x.T)
    return x.copy()


def tree_to_jax(tree, path=()):
    """A port subtree at ``path`` as a numpy tree in the JAX layout; the
    BatchNorm scalars become 0-d arrays, as the JAX package saves them."""
    if isinstance(tree, dict):
        return {k: tree_to_jax(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_jax(v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        return _leaf_to_jax(path, tree)
    return np.asarray(tree)


def params_to_jax(params, state):
    """The port's (params, state) as the JAX package's numpy trees."""
    return tree_to_jax(params), tree_to_jax(state)


def adam_to_jax(adam_states, params):
    """``torch.optim.Adam``'s per-leaf state (``adam_states``: {path of a
    leaf of ``params``: its state}, leaves without state left out) as
    optax's Adam moments: {"count": steps taken, "mu": first moments,
    "nu": second moments}, trees in the JAX layout (zeros where a leaf has
    no state)."""
    steps = {int(s["step"]) for s in adam_states.values()}
    if len(steps) > 1:
        raise ValueError("Adam state has leaves at different steps %s"
                         % sorted(steps))

    def moment(key):
        def get(path, p):
            s = adam_states.get(path)
            return (s[key] if s else torch.zeros_like(p)).detach()
        return tree_to_jax(tree_map_with_path(get, params))
    return {"count": np.asarray(steps.pop() if steps else 0, np.int32),
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def load_adam(optimizer, params, count, mu, nu):
    """Set ``optimizer``'s per-leaf state from optax's Adam moments (trees
    in the JAX layout, as ``adam_to_jax`` gives them); a count of 0
    clears it."""
    optimizer.state.clear()
    if int(count) == 0:
        return
    leaves = dict(tree_leaves_with_path(params))
    dev = next(iter(leaves.values())).device
    mu_t, nu_t = (dict(tree_leaves_with_path(tree_from_jax(m, dev)))
                  for m in (mu, nu))
    for path, p in leaves.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(int(count)), dtype=torch.float32),
            "exp_avg": mu_t[path].reshape(p.shape).clone(),
            "exp_avg_sq": nu_t[path].reshape(p.shape).clone()}


def optax_adam_moments(opt_state):
    """(count, mu, nu) of the first ``ScaleByAdamState`` in an optax
    optimizer state (optax's own classes or the stand-ins that
    ``training.checkpoint`` unpickles them as), or None."""
    if type(opt_state).__name__ == "ScaleByAdamState":
        return tuple(opt_state[:3])
    if isinstance(opt_state, dict):
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        for x in opt_state:
            found = optax_adam_moments(x)
            if found is not None:
                return found
    return None
