"""Image and audio codecs (counterpart of
multimodal_dmm_tpu/models/codecs.py).

The data contract at the codec boundary is the JAX package's: images are
channel-first ``(N, C, H, W)`` and audio slices ``(N, 2 n_frames,
n_freqs)`` at ``apply``; ``apply_native`` takes the channels-last layout
the training batches may be stored in (``(N, H, W, C)``, ``(N, n_freqs,
2 n_frames)``); ``apply_logits`` returns pre-sigmoid activations in that
same channels-last layout (``raw_perm`` maps edge dims to it).
Internally the convolutions run channel-first (NCHW, NCW), PyTorch's
layout, in float32, or with ``compute_dtype`` (the ``bf16`` model arg)
in that dtype with float32 weights, biases, BatchNorm and heads, as the
JAX package's codecs do.
"""

import torch
import torch.nn.functional as F

from . import nn as tnn
from .base import Codec

# Edge layout (C, H, W) -> native (H, W, C) on the trailing dims.
IMAGE_RAW_PERM = (1, 2, 0)
# Edge layout (C, W) -> native (W, C) on the trailing dims.
AUDIO_RAW_PERM = (1, 0)

# (conv init, conv apply, deconv init, deconv apply, deconv kernel size)
_IMAGE_OPS = (tnn.conv2d_init, tnn.conv2d_apply, tnn.deconv2d_init,
              tnn.deconv2d_apply, 4)
_AUDIO_OPS = (tnn.conv1d_init, tnn.conv1d_apply, tnn.deconv1d_init,
              tnn.deconv1d_apply, 3)


def _chans_enc(n_channels, n_kernels, n_layers):
    return [n_channels] + [n_kernels // 2 ** (n_layers - 1 - l)
                           for l in range(n_layers)]


def _encoder_init(gen, ops, z_dim, gauss_out, n_channels, n_kernels,
                  n_layers, feat_dim):
    chans = _chans_enc(n_channels, n_kernels, n_layers)
    convs, bns, bn_states = [], [], []
    for l in range(n_layers):
        convs.append(ops[0](gen, chans[l], chans[l + 1], ksize=3,
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


def _encoder_apply(ops, params, state, x, train, gauss_out, compute_dtype):
    """x channel-first -> ((mean, std) or feats (N, feat_dim), state)."""
    h = x
    n_layers = len(params["convs"])
    new_bns = []
    for l in range(n_layers):
        h = ops[1](params["convs"][l], h, stride=2, padding=1,
                   compute_dtype=compute_dtype)
        if l < n_layers - 1:
            h, bn_s = tnn.batchnorm_relu_apply(params["bns"][l],
                                               state["bns"][l], h, train)
            new_bns.append(bn_s)
    feats = h.reshape(h.shape[0], -1)  # channel-major flatten order
    new_state = {"bns": new_bns}
    if not gauss_out:
        return feats, new_state
    z_mean = tnn.linear_apply(params["to_mean"], feats)
    z_std = F.softplus(tnn.linear_apply(params["to_std"], feats))
    return (z_mean, z_std), new_state


def _decoder_init(gen, ops, z_dim, n_channels, n_kernels, n_layers,
                  feat_dim):
    chans = [n_kernels // 2 ** l for l in range(n_layers)] + [n_channels]
    params = {"z_to_feat": tnn.linear_init(gen, z_dim, feat_dim,
                                           xavier=True)}
    deconvs, bns, bn_states = [], [], []
    for l in range(n_layers):
        deconvs.append(ops[2](gen, chans[l], chans[l + 1], ksize=ops[4],
                              xavier=True))
        if l < n_layers - 1:
            bn_p, bn_s = tnn.batchnorm_init(chans[l + 1])
            bns.append(bn_p)
            bn_states.append(bn_s)
    params["deconvs"] = deconvs
    params["bns"] = bns
    return params, {"bns": bn_states}


def _decoder_apply(ops, params, state, z, train, feat_shape, logits,
                   compute_dtype):
    """z: (N, z_dim) -> ((probs, channel-first),), state); with
    ``logits`` the pre-sigmoid activations, channels-last."""
    feats = F.relu(tnn.linear_apply(params["z_to_feat"], z))
    h = feats.reshape((-1,) + tuple(feat_shape))
    n_layers = len(params["deconvs"])
    new_bns = []
    for l in range(n_layers):
        h = ops[3](params["deconvs"][l], h, stride=2, padding=1,
                   compute_dtype=compute_dtype)
        if l < n_layers - 1:
            h, bn_s = tnn.batchnorm_relu_apply(params["bns"][l],
                                               state["bns"][l], h, train)
            new_bns.append(bn_s)
    if logits:
        h = h.permute((0,) + tuple(range(2, h.dim())) + (1,))
    else:
        h = torch.sigmoid(h)
    return (h,), {"bns": new_bns}


def _encoder_codec(ops, raw_perm, feat_dim, z_dim, gauss_out, n_channels,
                   n_kernels, n_layers, compute_dtype):
    def init(gen):
        return _encoder_init(gen, ops, z_dim, gauss_out, n_channels,
                             n_kernels, n_layers, feat_dim)

    def apply(params, state, x, train):
        return _encoder_apply(ops, params, state, x, train, gauss_out,
                              compute_dtype)

    def apply_native(params, state, x, train):
        """x channels-last."""
        perm = (0, x.dim() - 1) + tuple(range(1, x.dim() - 1))
        return apply(params, state, x.permute(perm), train)

    codec = Codec(init, apply)
    codec.feat_dim = feat_dim
    codec.apply_native = apply_native
    codec.raw_perm = raw_perm
    return codec


def _decoder_codec(ops, raw_perm, feat_shape, z_dim, n_channels, n_kernels,
                   n_layers, compute_dtype):
    feat_dim = 1
    for s in feat_shape:
        feat_dim *= s

    def init(gen):
        return _decoder_init(gen, ops, z_dim, n_channels, n_kernels,
                             n_layers, feat_dim)

    def apply(params, state, z, train):
        return _decoder_apply(ops, params, state, z, train, feat_shape,
                              False, compute_dtype)

    def apply_logits(params, state, z, train):
        return _decoder_apply(ops, params, state, z, train, feat_shape,
                              True, compute_dtype)

    codec = Codec(init, apply)
    codec.apply_logits = apply_logits
    codec.raw_perm = raw_perm
    return codec


def image_encoder_codec(z_dim, gauss_out=True, img_size=64, n_channels=3,
                        n_kernels=64, n_layers=3, compute_dtype=None):
    """Conv image encoder as a Codec: (N, C, H, W) -> (mean, std) or the
    conv features (``feat_dim``, for DKS)."""
    feat_dim = (img_size // 2 ** n_layers) ** 2 * n_kernels
    return _encoder_codec(_IMAGE_OPS, IMAGE_RAW_PERM, feat_dim, z_dim,
                          gauss_out, n_channels, n_kernels, n_layers,
                          compute_dtype)


def image_decoder_codec(z_dim, img_size=64, n_channels=3, n_kernels=64,
                        n_layers=3, compute_dtype=None):
    """Deconv image decoder as a Codec: (N, z_dim) -> probs (N, C, H,
    W)."""
    fs = img_size // 2 ** n_layers
    return _decoder_codec(_IMAGE_OPS, IMAGE_RAW_PERM, (n_kernels, fs, fs),
                          z_dim, n_channels, n_kernels, n_layers,
                          compute_dtype)


def _audio_feat_size(n_freqs, n_layers):
    """Frequency bins after ``n_layers`` stride-2 convolutions (k = 3,
    padding 1): 1281 -> 641 -> 321 -> 161."""
    return (n_freqs - 1) // 2 ** n_layers + 1


def audio_encoder_codec(z_dim, gauss_out=True, n_freqs=1281, n_frames=5,
                        n_kernels=16, n_layers=3, compute_dtype=None):
    """1-D conv audio encoder as a Codec: spectrogram slices (N, 2
    n_frames, n_freqs) (log-magnitude and phase of ``n_frames`` STFT
    frames as channels) -> (mean, std) or the conv features."""
    feat_dim = _audio_feat_size(n_freqs, n_layers) * n_kernels
    return _encoder_codec(_AUDIO_OPS, AUDIO_RAW_PERM, feat_dim, z_dim,
                          gauss_out, n_frames * 2, n_kernels, n_layers,
                          compute_dtype)


def audio_decoder_codec(z_dim, n_freqs=1281, n_frames=5, n_kernels=16,
                        n_layers=3, compute_dtype=None):
    """1-D deconv audio decoder as a Codec: (N, z_dim) -> probs (N, 2
    n_frames, n_freqs)."""
    feat_shape = (n_kernels, _audio_feat_size(n_freqs, n_layers))
    return _decoder_codec(_AUDIO_OPS, AUDIO_RAW_PERM, feat_shape, z_dim,
                          n_frames * 2, n_kernels, n_layers, compute_dtype)
