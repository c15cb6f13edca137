"""Codec interface and shared model helpers (counterpart of
multimodal_dmm_tpu/models/base.py).

A codec is ``init(gen) -> (params, state)`` plus
``apply(params, state, x, train) -> (output, new_state)``; models treat
MLP heads and conv stacks alike through it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import nn as tnn


class Codec:
    """Uniform encoder/decoder interface."""

    def __init__(self, init, apply):
        self.init = init
        self.apply = apply


def mlp_gaussian_codec(in_dim, out_dim, h_dim, min_std=1e-3):
    """Default Gaussian MLP codec."""
    def init(gen):
        return tnn.gaussian_mlp_init(gen, in_dim, out_dim, h_dim), {}

    def apply(params, state, x, train):
        return tnn.gaussian_mlp_apply(params, x, min_std), state
    return Codec(init, apply)


def mlp_categorical_codec(in_dim, out_dim, h_dim):
    """Default categorical MLP decoder head."""
    def init(gen):
        return tnn.categorical_mlp_init(gen, in_dim, out_dim, h_dim), {}

    def apply(params, state, x, train):
        return tnn.categorical_mlp_apply(params, x), state
    return Codec(init, apply)


def embed_gaussian_codec(num_embeddings, z_dim, h_dim, min_std=1e-3):
    """Embedding -> ReLU -> Gaussian MLP encoder for label inputs."""
    def init(gen):
        return {"embed": tnn.embedding_init(gen, num_embeddings, h_dim),
                "head": tnn.gaussian_mlp_init(gen, h_dim, z_dim,
                                              h_dim)}, {}

    def apply(params, state, x, train):
        # x: (N, 1) float labels, already zero-filled where missing.
        idx = x.reshape(x.shape[0]).to(torch.int64)
        h = F.relu(tnn.embedding_apply(params["embed"], idx))
        return tnn.gaussian_mlp_apply(params["head"], h, min_std), state
    return Codec(init, apply)


class ModelBase:
    """Helpers shared by the multimodal models."""

    def _dim_of(self, m):
        d = self.dims[m]
        return int(np.prod(d)) if isinstance(d, (tuple, list)) else int(d)

    def _nan_fill_missing(self, inputs, t_max, b_dim, native_mods=(),
                          device=None):
        """A dict covering every modality; absent ones become NaN tensors
        (so their expert masks are zero), in the encoder-native trailing
        layout for modalities in ``native_mods``."""
        full = {}
        for m in self.modalities:
            if m in inputs:
                full[m] = inputs[m]
                continue
            if self.dists[m] == "Categorical":
                shape = (t_max, b_dim, 1)
            else:
                d = self.dims[m]
                dims = (tuple(d) if isinstance(d, (tuple, list))
                        else (int(d),))
                perm = getattr(self.enc[m], "raw_perm", None)
                if m in native_mods and perm is not None:
                    dims = tuple(dims[p] for p in perm)
                shape = (t_max, b_dim) + dims
            full[m] = torch.full(shape, float("nan"), dtype=torch.float32,
                                 device=device)
        return full
