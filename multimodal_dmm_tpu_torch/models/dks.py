"""The multimodal Deep Kalman Smoother, the paper's RNN-smoother baseline
(counterpart of multimodal_dmm_tpu/models/dks.py).

One GRU inference network per modality, run forward or backward in time
(``rnn_dir``), that either freezes its state on unobserved steps
(``rnn_skip``) or reads zeros there; a combiner MLP q(z_t | z_{t-1}, h_t
[, features_t]); one forward GTF transition prior. The four baselines of
the trainer's ``--method`` are (rnn_dir, rnn_skip) in {bwd, fwd} x {mask,
skip}. Both time loops (the GRU passes and the sampling pass) are Python
loops of plain tensor ops: the JAX package runs them as ``lax.scan``s and
no Pallas kernel, so the port has no kernel for them. Training goes
through ``ModelBase.step``.
"""

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..tree import tree_map
from . import nn as tnn
from .base import (Codec, ModelBase, mlp_categorical_codec,
                   mlp_gaussian_codec)


def _mlp_feature_codec(in_dim, h_dim):
    """Linear + ReLU feature encoder."""
    def init(gen):
        return tnn.linear_init(gen, in_dim, h_dim), {}

    def apply(params, state, x, train):
        return F.relu(tnn.linear_apply(params, x)), state
    codec = Codec(init, apply)
    codec.feat_dim = h_dim
    return codec


def _embed_feature_codec(num_embeddings, h_dim):
    """Embedding -> ReLU -> Linear -> ReLU feature encoder for label
    inputs."""
    def init(gen):
        return {"embed": tnn.embedding_init(gen, num_embeddings, h_dim),
                "lin": tnn.linear_init(gen, h_dim, h_dim)}, {}

    def apply(params, state, x, train):
        idx = x.reshape(x.shape[0]).to(torch.int64)
        h = F.relu(tnn.embedding_apply(params["embed"], idx))
        return F.relu(tnn.linear_apply(params["lin"], h)), state
    codec = Codec(init, apply)
    codec.feat_dim = h_dim
    return codec


class MultiDKS(ModelBase):
    """Multimodal deep Kalman smoother."""

    def __init__(self, modalities, dims, dists=None, encoders=None,
                 decoders=None, h_dim=32, z_dim=32, z0_mean=0.0, z0_std=1.0,
                 min_std=1e-3, feat_to_z=True, rnn_dir="bwd", rnn_skip=True,
                 rnn_layers=1, rnn_bias=True):
        self.modalities = list(modalities)
        self.n_mods = len(self.modalities)
        self.dims = dict(zip(self.modalities, dims))
        self.h_dim = h_dim
        self.z_dim = z_dim
        if dists is None:
            dists = ["Normal"] * self.n_mods
        self.dists = dict(zip(self.modalities, dists))
        self.min_std = min_std
        self.feat_to_z = feat_to_z
        self.rnn_dir = rnn_dir
        self.rnn_skip = rnn_skip
        self.rnn_layers = rnn_layers
        self.rnn_bias = rnn_bias
        # The global prior is fixed, not learned.
        self.z0_mean = float(z0_mean)
        self.z0_std = float(z0_std)
        self.enc, self.dec = {}, {}
        for m in self.modalities:
            if self.dists[m] == "Categorical":
                self.enc[m] = _embed_feature_codec(self._dim_of(m), h_dim)
                self.dec[m] = mlp_categorical_codec(z_dim, self._dim_of(m),
                                                    h_dim)
            else:
                self.enc[m] = _mlp_feature_codec(self._dim_of(m), h_dim)
                self.dec[m] = mlp_gaussian_codec(z_dim, self._dim_of(m),
                                                 h_dim)
        for given, target in ((encoders, self.enc), (decoders, self.dec)):
            if given is not None:
                if isinstance(given, list):
                    given = dict(zip(self.modalities, given))
                target.update(given)
        self.feat_dims = {m: getattr(self.enc[m], "feat_dim", h_dim)
                          for m in self.modalities}

    def init(self, seed, device="cuda"):
        """(params, state) trees drawn from a CPU generator seeded with
        ``seed``, then placed on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {"enc": {}, "dec": {}, "rnn": {}, "h0": {}}
        state = {"enc": {}, "dec": {}}
        for m in self.modalities:
            params["enc"][m], state["enc"][m] = self.enc[m].init(gen)
            params["dec"][m], state["dec"][m] = self.dec[m].init(gen)
            params["rnn"][m] = tnn.gru_init(gen, self.feat_dims[m],
                                            self.h_dim, self.rnn_layers,
                                            self.rnn_bias)
            params["h0"][m] = torch.zeros((self.rnn_layers, 1, self.h_dim))
        params["fwd"] = tnn.gtf_init(gen, self.z_dim, self.h_dim)
        comb_dim = self.z_dim + self.n_mods * self.h_dim
        if self.feat_to_z:
            comb_dim += sum(self.feat_dims[m] for m in self.modalities)
        params["combiner"] = tnn.gaussian_mlp_init(gen, comb_dim, self.z_dim,
                                                   self.h_dim)
        to_dev = lambda x: x.to(dev)  # noqa: E731
        return tree_map(to_dev, params), tree_map(to_dev, state)

    # -- inference networks ---------------------------------------------------

    def _encode_feats(self, params, state, inputs, t_max, b_dim, device,
                      train):
        """Features (T, B, F_m) and step masks (T, B) per modality; NaN
        entries read as 0, and an absent modality is all zeros with an
        all-zero mask."""
        feats, masks = {}, {}
        new_state = dict(state)
        for m in self.modalities:
            if m in inputs:
                x = inputs[m]
                masks[m] = ~torch.isnan(x.reshape(t_max, b_dim, -1)).any(-1)
                x = torch.nan_to_num(x, nan=0.0)
            else:
                d = self.dims[m]
                trail = ((1,) if self.dists[m] == "Categorical" else
                         tuple(d) if isinstance(d, (tuple, list))
                         else (int(d),))
                x = torch.zeros((t_max, b_dim) + trail, device=device)
                masks[m] = torch.zeros((t_max, b_dim), dtype=torch.bool,
                                       device=device)
            f, new_state[m] = self.enc[m].apply(
                params["enc"][m], state[m],
                x.reshape((t_max * b_dim,) + tuple(x.shape[2:])), train)
            feats[m] = f.reshape(t_max, b_dim, -1)
        return feats, masks, new_state

    def _rnn_pass(self, params, feats, masks, b_dim):
        """Each modality's GRU over its features in ``rnn_dir`` order (with
        ``rnn_skip``, the state is held over unobserved steps); the top
        layer's states (T, B, n_mods * H) in original time order."""
        t_max = next(iter(feats.values())).shape[0]
        steps = (range(t_max - 1, -1, -1) if self.rnn_dir == "bwd"
                 else range(t_max))
        outs = []
        for m in self.modalities:
            p = params["rnn"][m]
            h = params["h0"][m].expand(self.rnn_layers, b_dim, self.h_dim)
            mask = masks[m].to(feats[m].dtype)
            seq = [None] * t_max
            for t in steps:
                h_next = tnn.gru_step(p, feats[m][t], h)
                if self.rnn_skip:
                    m_b = mask[t][None, :, None]
                    h_next = m_b * h_next + (1 - m_b) * h
                h = h_next
                seq[t] = h[-1]
            outs.append(torch.stack(seq))
        return torch.cat(outs, dim=-1)

    # -- forward --------------------------------------------------------------

    def forward(self, params, state, inputs, gen=None, lengths=None,
                sample=True, sample_init=False, train=False, **kwargs):
        """Structured inference. Returns ((infer, prior, recon),
        new_state); the BFVI-only evaluation arguments are accepted and
        ignored. After the last step at which every modality is observed
        (``t_stop``), the posterior is the prior; at t = 0 the combiner
        sees z_prev = z0_mean."""
        some = inputs[list(inputs.keys())[0]]
        t_max, b_dim = some.shape[:2]
        dev = some.device
        inputs = {m: inputs[m] for m in inputs if m in self.modalities}
        feats, masks, enc_state = self._encode_feats(
            params, state["enc"], inputs, t_max, b_dim, dev, train)
        h_out = self._rnn_pass(params, feats, masks, b_dim)
        if self.feat_to_z:
            feat_cat = torch.cat([feats[m] for m in self.modalities], -1)
        else:
            feat_cat = h_out.new_zeros((t_max, b_dim, 0))
        mask_all = torch.stack([masks[m] for m in self.modalities]).all(0)
        t_idx = torch.arange(t_max, device=dev)[:, None]
        t_stop = (t_idx * mask_all.to(torch.int64)).max(0).values  # (B,)
        live = (t_idx <= t_stop[None]).to(h_out.dtype)[..., None]

        z0_mean = torch.full((b_dim, self.z_dim), self.z0_mean, device=dev)
        z0_std = torch.full((b_dim, self.z_dim), self.z0_std, device=dev)
        outs = [[] for _ in range(5)]
        z_prev = z0_mean
        for t in range(t_max):
            if t == 0:
                prior_mean, prior_std = z0_mean, z0_std
            else:
                prior_mean, prior_std = tnn.gtf_apply(params["fwd"], z_prev,
                                                      self.min_std)
            im, istd = tnn.gaussian_mlp_apply(
                params["combiner"],
                torch.cat([z_prev, h_out[t], feat_cat[t]], -1))
            infer_mean = im * live[t] + prior_mean * (1 - live[t])
            infer_std = istd * live[t] + prior_std * (1 - live[t])
            if sample or (sample_init and t == 0):
                z_t = self.sample_gauss(gen, infer_mean, infer_std)
            else:
                z_t = infer_mean
            for lst, v in zip(outs, (prior_mean, prior_std, infer_mean,
                                     infer_std, z_t)):
                lst.append(v)
            z_prev = z_t
        p_mean, p_std, i_mean, i_std, z_samples = (torch.stack(v)
                                                   for v in outs)
        recon, dec_state = self._decode(params["dec"], state["dec"],
                                        z_samples, train)
        return ((i_mean, i_std), (p_mean, p_std), recon), {
            "enc": enc_state, "dec": dec_state}

    def _decode(self, params, state, z, train):
        t_max, b_dim = z.shape[:2]
        flat = z.reshape(t_max * b_dim, self.z_dim)
        recon = {}
        new_state = dict(state)
        for m in self.modalities:
            out, new_state[m] = self.dec[m].apply(params[m], state[m], flat,
                                                  train)
            recon[m] = tuple(r.reshape((t_max, b_dim) + tuple(r.shape[1:]))
                             for r in out)
        return recon, new_state

    def sample(self, params, state, t_max, b_dim, gen):
        """Ancestral generation from the transition prior."""
        dev = params["fwd"]["z_lin"]["w"].device
        mean = torch.full((b_dim, self.z_dim), self.z0_mean, device=dev)
        std = torch.full((b_dim, self.z_dim), self.z0_std, device=dev)
        zs = []
        for t in range(t_max):
            if t > 0:
                mean, std = tnn.gtf_apply(params["fwd"], zs[-1], self.min_std)
            zs.append(self.sample_gauss(gen, mean, std))
        recon, _ = self._decode(params["dec"], state["dec"], torch.stack(zs),
                                train=False)
        return recon
