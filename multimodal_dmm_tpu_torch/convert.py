"""Carry weights from the JAX package's trees to the port's.

``params_from_jax(params, state, model)`` takes the JAX (params, state)
pytrees as nested dicts/lists of numpy arrays (BatchNorm state keeps its
scalar ``eps``/``momentum`` leaves as they are) and returns the port's
trees of tensors. It imports no JAX. Layout changes:

- linear ``w`` (in, out) -> (out, in), GTF layers included;
- conv ``w`` HWIO -> OIHW;
- deconv ``w``: the JAX package stores the spatially flipped HWIO kernel
  of the equivalent input-dilated forward convolution; ``ConvTranspose2d``
  wants (in, out, kH, kW) unflipped;
- embeddings, biases, BatchNorm scale/bias/running mean/var and the global
  prior ``z0_mean``/``z0_log_std`` are copied as they are.
"""

import numpy as np
import torch

from . import resolve_device


def _convert_leaf(path, x):
    x = np.asarray(x, dtype=np.float32)
    if path and path[-1] == "w":
        if "deconvs" in path:
            return np.ascontiguousarray(
                x[::-1, ::-1].transpose(2, 3, 0, 1))
        if "convs" in path:
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
    ``model`` (the port's MultiDMM); each leaf's mapping is decided by
    its path."""
    dev = resolve_device(device)
    for tree in (params, state):
        for side in ("enc", "dec"):
            if set(tree[side]) != set(model.modalities):
                raise ValueError(
                    "JAX tree has %s modalities %s, the model has %s"
                    % (side, sorted(tree[side]), sorted(model.modalities)))
    return tree_from_jax(params, dev), tree_from_jax(state, dev)
