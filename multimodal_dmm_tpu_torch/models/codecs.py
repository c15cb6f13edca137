"""Image codecs (counterpart of the image half of
multimodal_dmm_tpu/models/codecs.py).

The data contract at the codec boundary is the JAX package's: images are
channel-first ``(N, C, H, W)`` at ``apply``; ``apply_native`` takes the
channels-last ``(N, H, W, C)`` layout the training batches may be stored
in; ``apply_logits`` returns pre-sigmoid activations in that same
channels-last layout (``raw_perm`` maps edge dims to it). Internally the
convolutions run NCHW, PyTorch's layout, in float32, or with
``compute_dtype`` (the ``bf16`` model arg) in that dtype with float32
weights, biases, BatchNorm and heads, as the JAX package's codecs do.
"""

import torch
import torch.nn.functional as F

from . import nn as tnn
from .base import Codec

# Edge layout (C, H, W) -> native (H, W, C) on the trailing dims.
IMAGE_RAW_PERM = (1, 2, 0)


def _chans_enc(n_channels, n_kernels, n_layers):
    return [n_channels] + [n_kernels // 2 ** (n_layers - 1 - l)
                           for l in range(n_layers)]


def image_encoder_init(gen, z_dim, gauss_out=True, img_size=64,
                       n_channels=3, n_kernels=64, n_layers=3):
    feat_dim = (img_size // 2 ** n_layers) ** 2 * n_kernels
    chans = _chans_enc(n_channels, n_kernels, n_layers)
    convs, bns, bn_states = [], [], []
    for l in range(n_layers):
        convs.append(tnn.conv2d_init(gen, chans[l], chans[l + 1], ksize=3,
                                     xavier=True))
        if l < n_layers - 1:  # the last conv has no BN/ReLU
            bn_p, bn_s = tnn.batchnorm_init(chans[l + 1])
            bns.append(bn_p)
            bn_states.append(bn_s)
    params = {"convs": convs, "bns": bns}
    if gauss_out:
        params["to_mean"] = tnn.linear_init(gen, feat_dim, z_dim,
                                            xavier=True)
        params["to_std"] = tnn.linear_init(gen, feat_dim, z_dim,
                                           xavier=True)
    return params, {"bns": bn_states}


def image_encoder_apply(params, state, x, train, gauss_out=True,
                        compute_dtype=None):
    """x: (N, C, H, W) -> ((mean, std) or feats (N, feat_dim), state)."""
    h = x
    n_layers = len(params["convs"])
    new_bns = []
    for l in range(n_layers):
        h = tnn.conv2d_apply(params["convs"][l], h, stride=2, padding=1,
                             compute_dtype=compute_dtype)
        if l < n_layers - 1:
            h, bn_s = tnn.batchnorm_apply(params["bns"][l],
                                          state["bns"][l], h, train)
            new_bns.append(bn_s)
            h = F.relu(h)
    feats = h.reshape(h.shape[0], -1)  # NCHW flatten order
    new_state = {"bns": new_bns}
    if not gauss_out:
        return feats, new_state
    z_mean = tnn.linear_apply(params["to_mean"], feats)
    z_std = F.softplus(tnn.linear_apply(params["to_std"], feats))
    return (z_mean, z_std), new_state


def image_decoder_init(gen, z_dim, img_size=64, n_channels=3,
                       n_kernels=64, n_layers=3):
    feat_dim = (img_size // 2 ** n_layers) ** 2 * n_kernels
    chans = [n_kernels // 2 ** l for l in range(n_layers)] + [n_channels]
    params = {"z_to_feat": tnn.linear_init(gen, z_dim, feat_dim,
                                           xavier=True)}
    deconvs, bns, bn_states = [], [], []
    for l in range(n_layers):
        deconvs.append(tnn.deconv2d_init(gen, chans[l], chans[l + 1],
                                         ksize=4, xavier=True))
        if l < n_layers - 1:
            bn_p, bn_s = tnn.batchnorm_init(chans[l + 1])
            bns.append(bn_p)
            bn_states.append(bn_s)
    params["deconvs"] = deconvs
    params["bns"] = bns
    return params, {"bns": bn_states}


def image_decoder_apply(params, state, z, train, feat_shape, logits=False,
                        compute_dtype=None):
    """z: (N, z_dim) -> ((probs (N, C, H, W),), state); with ``logits``
    the pre-sigmoid activations in channels-last (N, H, W, C)."""
    feats = F.relu(tnn.linear_apply(params["z_to_feat"], z))
    h = feats.reshape((-1,) + tuple(feat_shape))
    n_layers = len(params["deconvs"])
    new_bns = []
    for l in range(n_layers):
        h = tnn.deconv2d_apply(params["deconvs"][l], h, stride=2,
                               padding=1, compute_dtype=compute_dtype)
        if l < n_layers - 1:
            h, bn_s = tnn.batchnorm_apply(params["bns"][l],
                                          state["bns"][l], h, train)
            new_bns.append(bn_s)
            h = F.relu(h)
    if logits:
        h = h.permute(0, 2, 3, 1)
    else:
        h = torch.sigmoid(h)
    return (h,), {"bns": new_bns}


def image_encoder_codec(z_dim, gauss_out=True, img_size=64, n_channels=3,
                        n_kernels=64, n_layers=3, compute_dtype=None):
    """Conv image encoder as a Codec."""
    def init(gen):
        return image_encoder_init(gen, z_dim, gauss_out, img_size,
                                  n_channels, n_kernels, n_layers)

    def apply(params, state, x, train):
        return image_encoder_apply(params, state, x, train, gauss_out,
                                   compute_dtype)

    def apply_native(params, state, x, train):
        """x channels-last (N, H, W, C)."""
        return image_encoder_apply(params, state, x.permute(0, 3, 1, 2),
                                   train, gauss_out, compute_dtype)

    codec = Codec(init, apply)
    codec.feat_dim = (img_size // 2 ** n_layers) ** 2 * n_kernels
    codec.apply_native = apply_native
    codec.raw_perm = IMAGE_RAW_PERM
    return codec


def image_decoder_codec(z_dim, img_size=64, n_channels=3, n_kernels=64,
                        n_layers=3, compute_dtype=None):
    """Deconv image decoder as a Codec."""
    fs = img_size // 2 ** n_layers
    feat_shape = (n_kernels, fs, fs)

    def init(gen):
        return image_decoder_init(gen, z_dim, img_size, n_channels,
                                  n_kernels, n_layers)

    def apply(params, state, z, train):
        return image_decoder_apply(params, state, z, train, feat_shape,
                                   compute_dtype=compute_dtype)

    def apply_logits(params, state, z, train):
        return image_decoder_apply(params, state, z, train, feat_shape,
                                   logits=True, compute_dtype=compute_dtype)

    codec = Codec(init, apply)
    codec.apply_logits = apply_logits
    codec.raw_perm = IMAGE_RAW_PERM
    return codec
