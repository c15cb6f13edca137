"""Codec interface and shared model helpers (counterpart of
multimodal_dmm_tpu/models/base.py).

A codec is ``init(gen) -> (params, state)`` plus
``apply(params, state, x, train) -> (output, new_state)``; models treat
MLP heads and conv stacks alike through it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import losses
from ..ops.poe import mean_of_experts, product_of_experts
from . import nn as tnn


def randn_cols(gen, shape, device, dtype=torch.float32, axis=None):
    """``torch.randn(shape)`` drawn from ``gen``; ``axis`` names the draw's
    axis of the batch's columns (None: it has none). In a data-parallel
    step ``gen`` is a ``parallel.ColumnNoise``, which draws at the global
    batch's shape and keeps this rank's columns."""
    if gen is None or isinstance(gen, torch.Generator):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return gen.randn(shape, device, dtype, axis=axis)


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
    """The multimodal training objective and helpers shared by the
    models."""

    @staticmethod
    def product_of_experts(mean, std, mask=None, eps=1e-8):
        return product_of_experts(mean, std, mask, eps)

    @staticmethod
    def mean_of_experts(mean, std, mask=None):
        return mean_of_experts(mean, std, mask)

    def native_input_perms(self):
        """Trailing-dim permutations for the modalities whose training
        batches the step takes in the codec-native layout: none here
        (``MultiDMM`` overrides)."""
        return {}

    def step(self, params, state, inputs, mask, kld_mult, rec_mults, gen,
             targets=None, uni_loss=True, train=True, **kwargs):
        """The unfused objective: the joint ELBO (with more than one
        modality) plus one unimodal ELBO per modality in ``inputs``, each
        from its own ``forward(train=train, **kwargs)``, in that order.
        Returns (loss, new_state)."""
        inputs = {m: inputs[m] for m in inputs if m in self.modalities}
        if targets is None:
            targets = inputs
        loss = 0.0
        variants = [(inputs, targets)] if len(self.modalities) > 1 else []
        if uni_loss:
            variants += [({m: inputs[m]}, {m: targets[m]})
                         for m in self.modalities if m in inputs]
        for var, var_targets in variants:
            (infer, prior, recon), state = self.forward(
                params, state, var, gen=gen, train=train, **kwargs)
            loss = loss + self.loss(var_targets, infer, prior, recon, mask,
                                    kld_mult, rec_mults)
        return loss, state

    def loss(self, inputs, infer, prior, recon, mask=None, kld_mult=1.0,
             rec_mults=None, avg=False):
        """kld_mult * KLD + sum over modalities of rec_mults[m] * NLL_m;
        divided by the number of observed steps when ``avg``."""
        total = kld_mult * self.kld_loss(infer, prior, mask)
        total = total + self.rec_loss(inputs, recon, mask, rec_mults)
        if avg:
            n_data = (torch.sum(mask) if mask is not None else
                      np.prod(tuple(inputs[self.modalities[-1]].shape[:2])))
            total = total / n_data
        return total

    def kld_loss(self, infer, prior, mask=None):
        return losses.kld_gauss(infer[0], infer[1], prior[0], prior[1], mask)

    def rec_loss(self, inputs, recon, mask=None, rec_mults=None):
        """Masked NLL of each modality in ``inputs`` under its
        distribution, weighted by ``rec_mults`` (default 1; 0 skips)."""
        rec_mults = rec_mults or {}
        loss = 0.0
        for m in self.modalities:
            if m not in inputs:
                continue
            mult = rec_mults.get(m, 1.0)
            if mult == 0:
                continue
            if self.dists[m] == "Bernoulli":
                loss = loss + mult * losses.nll_bernoulli(recon[m][0],
                                                          inputs[m], mask)
            elif self.dists[m] == "Categorical":
                loss = loss + mult * losses.nll_categorical(recon[m][0],
                                                            inputs[m], mask)
            elif self.dists[m] == "Normal":
                loss = loss + mult * losses.nll_gauss(recon[m][0],
                                                      recon[m][1], inputs[m],
                                                      mask)
        return loss

    @staticmethod
    def sample_gauss(gen, mean, std, shape=None):
        """Reparameterised Gaussian sample: eps * std + mean, eps drawn
        from ``gen`` with ``shape`` (default ``mean``'s), whose axis 0 is
        the batch's (``randn_cols``)."""
        eps = randn_cols(gen, tuple(mean.shape) if shape is None else shape,
                         mean.device, dtype=mean.dtype, axis=0)
        return eps * std + mean

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
