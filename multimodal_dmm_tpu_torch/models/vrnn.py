"""The multimodal Variational RNN baseline (counterpart of
multimodal_dmm_tpu/models/vrnn.py).

A shared GRU state h; per step a prior MLP p(z_t | h), one encoder
q(z | phi(x_m), h) per modality fused with the prior by a product of
experts, a sample (or the mean), decoders conditioned on (phi(z), h), and
the recurrence h' = GRU(phi(z), h), or with ``recur_mode='use_inputs'``
GRU([phi(x_m) for each m] + phi(z), h), where missing entries of a present
modality are imputed from the step's reconstruction (gradients flow
through them) and an absent modality is its detached reconstruction.
``recon`` is ``{modality: (mean, std)}``, as the JAX package normalises
it. The time loop is a Python loop of plain tensor ops (the JAX package's
``lax.scan``, no Pallas kernel). Training goes through
``ModelBase.step``.
"""

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..tree import tree_map
from . import nn as tnn
from .base import ModelBase


class MultiVRNN(ModelBase):
    """Multimodal variational recurrent neural network."""

    def __init__(self, modalities, dims, dists=None, encoders=None,
                 decoders=None, h_dim=16, z_dim=16, z0_mean=0.0, z0_std=1.0,
                 n_layers=1, bias=True, recur_mode="no_inputs"):
        # encoders and decoders: the model's own MLPs are the codecs; the
        # apps' codecs are accepted and not used, as in the JAX package.
        del encoders, decoders
        self.modalities = list(modalities)
        self.n_mods = len(self.modalities)
        self.dims = dict(zip(self.modalities, dims))
        self.h_dim = h_dim
        self.z_dim = z_dim
        self.n_layers = n_layers
        self.bias = bias
        self.recur_mode = recur_mode
        if dists is None:
            dists = ["Normal"] * self.n_mods
        self.dists = dict(zip(self.modalities, dists))
        other = [m for m in self.modalities if self.dists[m] != "Normal"]
        if other:
            # Its encoders read the raw values and its decoders are
            # Gaussian MLPs over the flattened modality: the JAX package's
            # MultiVRNN fails on label and image modalities at its first
            # step (a label is one value, not its dim; a flat image
            # reconstruction does not broadcast against the image).
            raise ValueError("MultiVRNN models Normal modalities only; %s "
                             "are not" % (other,))
        self.z0_mean = float(z0_mean)
        self.z0_std = float(z0_std)

    def init(self, seed, device="cuda"):
        """(params, state) trees drawn from a CPU generator seeded with
        ``seed``, then placed on ``device``; the state is empty."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {"phi": {}, "enc": {}, "dec": {}}
        for m in self.modalities:
            params["phi"][m] = tnn.linear_init(gen, self._dim_of(m),
                                               self.h_dim)
            params["enc"][m] = tnn.gaussian_mlp_init(gen, 2 * self.h_dim,
                                                     self.z_dim, self.h_dim)
            params["dec"][m] = tnn.gaussian_mlp_init(gen, 2 * self.h_dim,
                                                     self._dim_of(m),
                                                     self.h_dim)
        params["phi_z"] = tnn.linear_init(gen, self.z_dim, self.h_dim)
        params["prior"] = tnn.gaussian_mlp_init(gen, self.h_dim, self.z_dim,
                                                self.h_dim)
        rnn_in = ((self.n_mods + 1) * self.h_dim
                  if self.recur_mode == "use_inputs" else self.h_dim)
        params["rnn"] = tnn.gru_init(gen, rnn_in, self.h_dim, self.n_layers,
                                     self.bias)
        params["h0"] = torch.zeros((self.n_layers, 1, self.h_dim))
        return tree_map(lambda x: x.to(dev), params), {}

    def _phi(self, params, m, x):
        return F.relu(tnn.linear_apply(params["phi"][m], x))

    def _recur_input(self, params, phi_z, rec, xs=None, nans=None):
        """The GRU's input: phi(z), or with ``use_inputs`` each modality's
        phi of its data (missing entries imputed from ``rec``; an absent
        modality is its detached reconstruction) followed by phi(z)."""
        if self.recur_mode != "use_inputs":
            return phi_z
        phis = []
        for m in self.modalities:
            if xs is not None and m in xs:
                x_imp = torch.where(nans[m], rec[m][0], xs[m])
            else:
                x_imp = rec[m][0].detach()
            phis.append(self._phi(params, m, x_imp))
        return torch.cat(phis + [phi_z], -1)

    def _prior(self, params, h_top, t, z0_mean, z0_std):
        if t == 0:
            return z0_mean, z0_std
        return tnn.gaussian_mlp_apply(params["prior"], h_top)

    def forward(self, params, state, inputs, gen=None, lengths=None,
                sample=True, train=False, **kwargs):
        """One pass over time. Returns ((infer, prior, recon), state); the
        BFVI-only evaluation arguments are accepted and ignored."""
        some = inputs[list(inputs.keys())[0]]
        t_max, b_dim = some.shape[:2]
        dev = some.device
        present = [m for m in self.modalities if m in inputs]
        xs, masks, nans = {}, {}, {}
        for m in present:
            x = inputs[m].reshape(t_max, b_dim, -1)
            nans[m] = torch.isnan(x)
            masks[m] = ~nans[m].any(-1)
            xs[m] = torch.where(nans[m], torch.zeros_like(x), x)
        z0_mean = torch.full((b_dim, self.z_dim), self.z0_mean, device=dev)
        z0_std = torch.full((b_dim, self.z_dim), self.z0_std, device=dev)
        ones = torch.ones((b_dim,), dtype=torch.bool, device=dev)
        h = params["h0"].expand(self.n_layers, b_dim, self.h_dim)
        outs = [[] for _ in range(4)]
        recs = {m: [] for m in self.modalities}
        for t in range(t_max):
            h_top = h[-1]
            prior_mean, prior_std = self._prior(params, h_top, t, z0_mean,
                                                z0_std)
            e_means, e_stds, e_masks = [prior_mean], [prior_std], [ones]
            for m in present:
                em, es = tnn.gaussian_mlp_apply(
                    params["enc"][m],
                    torch.cat([self._phi(params, m, xs[m][t]), h_top], -1))
                e_means.append(em)
                e_stds.append(es)
                e_masks.append(masks[m][t])
            infer_mean, infer_std = self.product_of_experts(
                torch.stack(e_means), torch.stack(e_stds),
                torch.stack(e_masks))
            zq = (self.sample_gauss(gen, infer_mean, infer_std) if sample
                  else infer_mean)
            phi_z = F.relu(tnn.linear_apply(params["phi_z"], zq))
            dec_in = torch.cat([phi_z, h_top], -1)
            rec = {m: tnn.gaussian_mlp_apply(params["dec"][m], dec_in)
                   for m in self.modalities}
            rnn_in = self._recur_input(
                params, phi_z, rec, {m: xs[m][t] for m in present},
                {m: nans[m][t] for m in present})
            h = tnn.gru_step(params["rnn"], rnn_in, h)
            for lst, v in zip(outs, (prior_mean, prior_std, infer_mean,
                                     infer_std)):
                lst.append(v)
            for m in self.modalities:
                recs[m].append(rec[m])
        p_mean, p_std, i_mean, i_std = (torch.stack(v) for v in outs)
        recon = {m: tuple(torch.stack(v) for v in zip(*recs[m]))
                 for m in self.modalities}
        return ((i_mean, i_std), (p_mean, p_std), recon), state

    def sample(self, params, state, t_max, b_dim, gen):
        """Unconditional generation."""
        dev = params["h0"].device
        z0_mean = torch.full((b_dim, self.z_dim), self.z0_mean, device=dev)
        z0_std = torch.full((b_dim, self.z_dim), self.z0_std, device=dev)
        h = params["h0"].expand(self.n_layers, b_dim, self.h_dim)
        recs = {m: [] for m in self.modalities}
        for t in range(t_max):
            h_top = h[-1]
            mean, std = self._prior(params, h_top, t, z0_mean, z0_std)
            phi_z = F.relu(tnn.linear_apply(params["phi_z"],
                                            self.sample_gauss(gen, mean, std)))
            dec_in = torch.cat([phi_z, h_top], -1)
            rec = {m: tnn.gaussian_mlp_apply(params["dec"][m], dec_in)
                   for m in self.modalities}
            h = tnn.gru_step(params["rnn"], self._recur_input(params, phi_z,
                                                              rec), h)
            for m in self.modalities:
                recs[m].append(rec[m])
        return {m: tuple(torch.stack(v) for v in zip(*recs[m]))
                for m in self.modalities}
