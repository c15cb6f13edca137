"""Multimodal Deep Markov Model with BFVI (counterpart of
multimodal_dmm_tpu/models/dmm.py).

Every filtering pass runs through the fused scan of
``ops/cuda/bfvi_scan.py`` except the gradient-free, sampled passes of
``forward(train=False)`` (the 200-particle evaluation filter), which step
through ``_z_next`` and the fused PoE + sampling cell of
``ops/cuda/poe_cell.py`` one time step at a time, as the JAX package's
``z_filter`` does with ``use_pallas``. Either way the CUDA kernels run for
tensors on the GPU and their plain PyTorch versions for tensors on the
CPU. The training objective is by
default the fused one: encode once, stack the joint and unimodal variants
into one (V*B) batch, run each objective mode's filtering (and smoothing)
passes over it, decode only the active variant rows. Its two modes'
filtering passes may also share one scan of 2*V*B columns with the f-mode
noise broadcast to the s-mode's particle count (``merge_mode_scans``);
``fused=False`` is the unfused composition of separate forwards
(``ModelBase.step``). Either way each mode decodes separately, f-mode
first, so BatchNorm's running statistics move in the same sequence.
``ragged_mode_scans`` is accepted as a scheduling hint with no effect: the
JAX package's ragged-K pass computes what one filtering pass per particle
group computes (``z_filter_grouped``, kept with that API), and that is
the two-scan step's loop, so the step runs the loop (which the JAX
dispatch also prefers over ``merge_mode_scans`` when both are set).

Noise is drawn outside the kernels from an explicit ``torch.Generator``
(on the tensors' device), in this order per ``step``: the forward and
backward prior-matching rollouts, then the f-mode filtering pass, then
the s-mode filtering pass, then the s-mode smoothing pass. The merged
pass draws the f-mode group's noise, then the s-mode group's, then the
smoothing pass's: the order of the two-scan step, so the same generator
gives both the same noise. ``z_filter`` and ``z_filter_grouped`` also take
injected ``eps``.

``bf16_gtf=True`` runs every GTF product in bfloat16 where the JAX
package's ``lax.scan`` path does (its ``_packed_trans``): the filtering
scans through the kernels' bfloat16 variants (``bfvi_scan(bf16=True)``),
the rollouts' ``_z_next`` through ``nn.gtf_apply_packed`` and the
evaluation filter's steps through ``nn.gtf_products``, both on weights
packed in bfloat16. The parameters stay float32.
"""

import numpy as np
import torch

from .. import resolve_device
from ..ops import losses
from ..ops.cuda.bfvi_scan import bfvi_scan
from ..ops.cuda.poe_cell import poe_sample_cell, poe_sample_step
from ..ops.poe import (product_of_experts, product_of_experts_pair,
                       mean_of_experts)
from ..parallel.mesh import ColumnNoise, SyncStats
from ..training.diagnostics import span
from ..tree import tree_map
from . import nn as tnn
from .base import (ModelBase, embed_gaussian_codec, mlp_categorical_codec,
                   mlp_gaussian_codec, randn_cols)


class MultiDMM(ModelBase):
    """Multimodal deep Markov model with bidirectional factorized
    variational inference."""

    def __init__(self, modalities, dims, dists=None, encoders=None,
                 decoders=None, h_dim=32, z_dim=32, z0_mean=0.0, z0_std=1.0,
                 min_std=1e-3, use_pallas="auto", scan_unroll="auto",
                 use_scan_kernel=False, bf16_gtf=False):
        # use_pallas, scan_unroll and use_scan_kernel schedule the JAX
        # package's passes; here the CUDA kernels always run on the GPU,
        # so they are accepted and have no effect.
        del use_pallas, scan_unroll, use_scan_kernel
        self.bf16_gtf = bool(bf16_gtf)
        self.modalities = list(modalities)
        self.n_mods = len(self.modalities)
        self.dims = dict(zip(self.modalities, dims))
        self.h_dim = h_dim
        self.z_dim = z_dim
        if dists is None:
            dists = ["Normal"] * self.n_mods
        self.dists = dict(zip(self.modalities, dists))
        self.z0_mean_init = z0_mean
        self.z0_std_init = z0_std
        self.min_std = min_std
        # True runs the filtering passes through the scan's and the cell's
        # plain PyTorch versions on any device, "bwd" only the scan's
        # backward, to hold the CUDA kernels against them
        # (ops/cuda/bfvi_scan.bfvi_scan, ops/cuda/poe_cell.poe_sample_cell).
        self.plain_scan = False
        # The 2-D mesh whose model axis splits the fused objective's
        # stacked variant rows (set_variant_mesh); None: this process
        # runs all of them.
        self.vb_mesh = None
        self.enc, self.dec = {}, {}
        for m in self.modalities:
            if self.dists[m] == "Categorical":
                self.enc[m] = embed_gaussian_codec(self._dim_of(m), z_dim,
                                                   h_dim)
                self.dec[m] = mlp_categorical_codec(z_dim, self._dim_of(m),
                                                    h_dim)
            else:
                self.enc[m] = mlp_gaussian_codec(self._dim_of(m), z_dim,
                                                 h_dim)
                self.dec[m] = mlp_gaussian_codec(z_dim, self._dim_of(m),
                                                 h_dim)
        for given, target in ((encoders, self.enc), (decoders, self.dec)):
            if given is not None:
                if isinstance(given, list):
                    given = dict(zip(self.modalities, given))
                target.update(given)

    # -- parameters -----------------------------------------------------------

    def init(self, seed, device="cuda"):
        """(params, state) trees drawn from a CPU generator seeded with
        ``seed``, then placed on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {"enc": {}, "dec": {}}
        state = {"enc": {}, "dec": {}}
        for m in self.modalities:
            params["enc"][m], state["enc"][m] = self.enc[m].init(gen)
        for m in self.modalities:
            params["dec"][m], state["dec"][m] = self.dec[m].init(gen)
        params["trans"] = {"fwd": tnn.gtf_init(gen, self.z_dim, self.h_dim),
                           "bwd": tnn.gtf_init(gen, self.z_dim, self.h_dim)}
        params["z0_mean"] = torch.full((1, self.z_dim), float(self.z0_mean_init))
        params["z0_log_std"] = torch.log(
            torch.full((1, self.z_dim), float(self.z0_std_init)))
        to_dev = lambda x: x.to(dev)  # noqa: E731
        return tree_map(to_dev, params), tree_map(to_dev, state)

    def prior_params(self, params, shape):
        """Global prior broadcast to ``shape[:-1] + (z_dim,)``."""
        target = tuple(shape[:-1]) + (self.z_dim,)
        mean = params["z0_mean"][0].expand(target)
        std = (torch.exp(params["z0_log_std"][0]) + self.min_std).expand(
            target)
        return mean, std

    # -- encode / decode ------------------------------------------------------

    def encode(self, params, state, inputs, train=False, combine=False,
               native=()):
        """Per-modality experts + NaN-derived masks. Returns
        ((M, T, B, z) mean/std, (M, T, B) mask), new encoder state.
        Modalities in ``native`` arrive channels-last and go through
        ``enc.apply_native``."""
        t_max, b_dim = inputs[self.modalities[0]].shape[:2]
        z_mean, z_std, masks = [], [], []
        new_state = dict(state)
        for m in self.modalities:
            x = inputs[m]
            nan = torch.isnan(x)
            masks.append(~nan.reshape(t_max * b_dim, -1).any(dim=-1))
            x_flat = torch.where(nan, torch.zeros_like(x), x).reshape(
                (t_max * b_dim,) + tuple(x.shape[2:]))
            enc_apply = (self.enc[m].apply_native if m in native
                         else self.enc[m].apply)
            (m_mean, m_std), new_state[m] = enc_apply(
                params["enc"][m], state[m], x_flat, train)
            z_mean.append(m_mean.reshape(t_max, b_dim, -1))
            z_std.append(m_std.reshape(t_max, b_dim, -1))
        z_mean = torch.stack(z_mean)
        z_std = torch.stack(z_std)
        masks = torch.stack(masks).reshape(self.n_mods, t_max, b_dim)
        if combine:
            z_mean, z_std = product_of_experts(z_mean, z_std, masks)
            masks = masks.any(dim=0)
        return (z_mean, z_std, masks), new_state

    def decode(self, params, state, z, train=False):
        """z: (T, B, z_dim) -> dict of (T, B, ...) parameter tuples."""
        t_max, b_dim = z.shape[:2]
        flat = z.reshape(t_max * b_dim, self.z_dim)
        recon = {}
        new_state = dict(state)
        for m in self.modalities:
            out, new_state[m] = self.dec[m].apply(params["dec"][m], state[m],
                                                  flat, train)
            recon[m] = tuple(r.reshape((t_max, b_dim) + tuple(r.shape[1:]))
                             for r in out)
        return recon, new_state

    def native_input_perms(self):
        """Trailing-dim permutations (edge -> codec-native) for the
        Bernoulli modalities whose encoder takes native input and whose
        decoder's logits come out in the same native layout."""
        out = {}
        for m in self.modalities:
            enc, dec = self.enc[m], self.dec[m]
            perm = getattr(enc, "raw_perm", None)
            if (self.dists[m] == "Bernoulli" and perm is not None
                    and getattr(dec, "raw_perm", None) == tuple(perm)
                    and hasattr(enc, "apply_native")
                    and hasattr(dec, "apply_logits")):
                out[m] = tuple(perm)
        return out

    # -- latent dynamics ------------------------------------------------------

    def _packed_trans(self, params, direction):
        """The transition of ``direction`` packed for a time loop, its
        weights cast to bfloat16 with ``bf16_gtf`` (``nn.gtf_pack``)."""
        dt = torch.bfloat16 if self.bf16_gtf else None
        return tnn.gtf_pack(params["trans"][direction], compute_dtype=dt)

    def _z_next(self, trans, z, glb_mean, glb_std):
        """p(z_next | z) from particles z (K, B, D): PoE(global prior,
        GTF(z_k)) per particle, then the moment-matched mixture; ``trans``
        from ``_packed_trans``."""
        q_mean, q_std = tnn.gtf_apply_packed(trans, z, self.min_std)
        pp_mean, pp_std = product_of_experts_pair(glb_mean, glb_std, q_mean,
                                                  q_std)
        return mean_of_experts(pp_mean, pp_std)

    def _filter_eps(self, gen, t_max, n_particles, b_dim, do_sample,
                    sample_init, device):
        """The filtering pass's noise (T, K, B, D)."""
        if do_sample:
            return randn_cols(gen, (t_max, n_particles, b_dim, self.z_dim),
                              device, axis=2)
        eps = torch.zeros((t_max, 1, b_dim, self.z_dim), device=device)
        if sample_init:
            eps[0] = randn_cols(gen, (1, b_dim, self.z_dim), device, axis=1)
        return eps

    def z_filter(self, params, z_mean, z_std, z_masks, gen=None,
                 direction="fwd", sample=True, n_particles=1,
                 sample_init=False, eps=None, use_cell=False):
        """Filtering pass. z_mean/z_std: (M', T, B, D); z_masks:
        (M', T, B). Returns (infer, prior, samples) in original time
        order. ``eps``: optional noise (T, K, B, D) in scan time order
        (already flipped for a backward pass); ``gen`` is then unused.
        ``use_cell``: a sampled pass (``sample or n_particles > 1``) steps
        through the PoE + sampling cell instead of the scan; gradient-free
        (``_cell_filter``)."""
        t_max, b_dim = z_mean.shape[1:3]
        glb_mean, glb_std = self.prior_params(params, (b_dim, self.z_dim))
        xs_mean = z_mean.transpose(0, 1)
        xs_std = z_std.transpose(0, 1)
        xs_mask = z_masks.transpose(0, 1)
        if direction == "bwd":
            xs_mean, xs_std, xs_mask = (torch.flip(x, [0]) for x in
                                        (xs_mean, xs_std, xs_mask))
        do_sample = sample or n_particles > 1
        if eps is None:
            eps = self._filter_eps(gen, t_max, n_particles, b_dim,
                                   do_sample, sample_init, z_mean.device)
        if use_cell and do_sample:
            outs = self._cell_filter(self._packed_trans(params, direction),
                                     xs_mean, xs_std, xs_mask, glb_mean,
                                     glb_std, eps)
        else:
            outs = bfvi_scan(xs_mean, xs_std, xs_mask, glb_mean, glb_std,
                             params["trans"][direction], eps, self.min_std,
                             plain=self.plain_scan, bf16=self.bf16_gtf)
        if direction == "bwd":
            outs = tuple(torch.flip(x, [0]) for x in outs)
        p_mean, p_std, i_mean, i_std, samples = outs
        return (i_mean, i_std), (p_mean, p_std), samples

    def _cell_filter(self, trans, xs_mean, xs_std, xs_mask, glb_mean,
                     glb_std, eps):
        """The filtering loop in scan time order, one step at a time under
        the packed transition ``trans``: at t = 0 ``poe_sample_cell`` on
        the global prior, at each later step ``nn.gtf_products`` of the K
        particles and ``poe_sample_step`` (the transition's tail, the
        conditional prior of ``_z_next`` and the cell, one launch on the
        GPU). The outputs go into (T, B, D) buffers, the particles into two
        (K, B, D) buffers in turn. Returns (prior_mean, prior_std,
        infer_mean, infer_std, samples), each (T, B, D)."""
        # One copy (or cast) each instead of one per step.
        xs_mean, xs_std, glb_mean, glb_std, eps = (
            x.contiguous() for x in (xs_mean, xs_std, glb_mean, glb_std,
                                     eps))
        xs_mask = xs_mask.to(torch.float32).contiguous()
        t_max = xs_mean.shape[0]
        plain = self.plain_scan is True
        opts = dict(dtype=torch.float32, device=eps.device)
        p_mean, p_std, i_mean, i_std, smp = (
            torch.empty((t_max,) + tuple(glb_mean.shape), **opts)
            for _ in range(5))
        zs = [torch.empty(eps.shape[1:], **opts) for _ in range(2)]
        p_mean[0].copy_(glb_mean)
        p_std[0].copy_(glb_std)
        poe_sample_cell(glb_mean, glb_std, xs_mean[0], xs_std[0], xs_mask[0],
                        eps[0], plain=plain,
                        out=(i_mean[0], i_std[0], zs[0], smp[0]))
        for t in range(1, t_max):
            poe_sample_step(tnn.gtf_products(trans, zs[(t - 1) % 2]),
                            glb_mean, glb_std, xs_mean[t], xs_std[t],
                            xs_mask[t], eps[t], self.min_std, plain=plain,
                            out=(p_mean[t], p_std[t], i_mean[t], i_std[t],
                                 zs[t % 2], smp[t]))
        return p_mean, p_std, i_mean, i_std, smp

    def z_filter_grouped(self, params, z_mean, z_std, z_masks, eps,
                         k_groups, direction="fwd"):
        """Several filtering passes over the same experts with particle
        counts ``k_groups`` (ragged K): group g runs ``z_filter`` on its
        slice of ``eps`` (T, sum K, B, D, scan time order), which is what
        the JAX package's one ragged scan computes group by group. Returns
        (infer, prior, samples) stacked on a leading group axis, (G, T, B,
        D) each, in original time order."""
        bounds = np.cumsum((0,) + tuple(int(k) for k in k_groups))
        if eps.shape[1] != bounds[-1]:
            raise ValueError("eps has %d particles, k_groups %s sum to %d"
                             % (eps.shape[1], tuple(k_groups), bounds[-1]))
        outs = [self.z_filter(params, z_mean, z_std, z_masks,
                              direction=direction, eps=eps[:, s:e])
                for s, e in zip(bounds[:-1], bounds[1:])]
        stack = lambda i, j=None: torch.stack(  # noqa: E731
            [o[i] if j is None else o[i][j] for o in outs])
        return ((stack(0, 0), stack(0, 1)), (stack(1, 0), stack(1, 1)),
                stack(2))

    def z_sample(self, params, t_max, b_dim, gen, direction="fwd",
                 sample=True, n_particles=1, z_init=None, inclusive=False):
        """Ancestral rollout of the latent chain."""
        glb_mean, glb_std = self.prior_params(params, (b_dim, self.z_dim))
        mean_t, std_t = (glb_mean, glb_std) if z_init is None else z_init
        n_steps = t_max - int(inclusive)
        trans = self._packed_trans(params, direction)
        dev = glb_mean.device
        shape = (n_steps, n_particles, mean_t.shape[0], self.z_dim)
        if sample or n_particles > 1:
            eps = randn_cols(gen, shape, dev)
        else:
            eps = torch.zeros((n_steps, 1) + shape[2:], device=dev)
        means, stds = [], []
        for t in range(n_steps):
            z_t = mean_t + std_t * eps[t]
            mean_t, std_t = self._z_next(trans, z_t, glb_mean, glb_std)
            means.append(mean_t)
            stds.append(std_t)
        if inclusive:
            means.insert(0, glb_mean if z_init is None else z_init[0])
            stds.insert(0, glb_std if z_init is None else z_init[1])
        means, stds = torch.stack(means), torch.stack(stds)
        if direction == "bwd":
            means, stds = torch.flip(means, [0]), torch.flip(stds, [0])
        return means, stds

    # -- forward --------------------------------------------------------------

    def _smooth_experts(self, params, zm, zs, om, flt_prior):
        """Append the filter-prior and inverse-global-prior experts for a
        smoothing pass."""
        t_max, b_dim = zm.shape[1:3]
        glb_mean, glb_std = self.prior_params(params,
                                              (t_max, b_dim, self.z_dim))
        ones = torch.ones((t_max, b_dim), device=zm.device)
        flt_mask = ones.clone()
        flt_mask[-1] = 0.0
        flt_mean, flt_std = flt_prior
        return (torch.cat([zm, flt_mean[None], glb_mean[None]]),
                torch.cat([zs, flt_std[None], -glb_std[None]]),
                torch.cat([om, flt_mask[None], ones[None]]))

    def forward(self, params, state, inputs, gen=None, lengths=None,
                mode="fsmooth", sample=True, sample_init=False,
                flt_particles=1, smt_particles=1, train=False):
        """BFVI forward. Returns ((infer, prior, recon), new_state). With
        ``train=False`` its sampled passes take the gradient-free cell path
        (``z_filter(use_cell=True)``): call it under ``torch.no_grad()``."""
        some = inputs[list(inputs.keys())[0]]
        t_max, b_dim = some.shape[:2]
        full = self._nan_fill_missing(inputs, t_max, b_dim,
                                      device=some.device)
        with span("mdmm/dmm.encode"):
            (obs_mean, obs_std, obs_mask), enc_state = self.encode(
                params, state["enc"], full, train)
        obs_mask = obs_mask.to(torch.float32)
        direction = "fwd" if mode in ("ffilter", "bsmooth") else "bwd"
        flt_init = sample_init if mode in ("ffilter", "bfilter") else False
        with span("mdmm/dmm.filter"):
            infer, prior, z_samples = self.z_filter(
                params, obs_mean, obs_std, obs_mask, gen,
                direction=direction, sample=sample,
                n_particles=flt_particles, sample_init=flt_init,
                use_cell=not train)
        if mode in ("fsmooth", "bsmooth"):
            direction = "fwd" if mode == "fsmooth" else "bwd"
            with span("mdmm/dmm.smooth"):
                szm, szs, som = self._smooth_experts(
                    params, obs_mean, obs_std, obs_mask, prior)
                infer, prior, z_samples = self.z_filter(
                    params, szm, szs, som, gen, direction=direction,
                    sample=sample, n_particles=smt_particles,
                    sample_init=sample_init, use_cell=not train)
        with span("mdmm/dmm.decode"):
            recon, dec_state = self.decode(params, state["dec"], z_samples,
                                           train)
        return (infer, prior, recon), {"enc": enc_state, "dec": dec_state}

    def sample(self, params, state, t_max, b_dim, gen, direction="fwd"):
        """Unconditional generation."""
        z_mean, _ = self.z_sample(params, t_max, b_dim, gen, direction,
                                  sample=True)
        recon, _ = self.decode(params, state["dec"], z_mean, train=False)
        return recon

    def set_variant_mesh(self, mesh):
        """Split the fused objective's stacked variant rows over the model
        axis of ``mesh`` (``parallel.make_mesh_2d``), None to run them all.
        Under it, rank (d, m) of a data-parallel step runs the scans and
        decoders of its share of the V variants (``Mesh.variant_rows``)
        on its columns; its encoder's BatchNorm statistics are those of
        its data group (the M model ranks of one data index hold the same
        columns), its decoders' those of all ranks; model rank 0 alone
        adds the prior-matching term."""
        self.vb_mesh = mesh

    def _variant_rows(self, v_dim):
        """This process's rows of ``v_dim`` stacked variants."""
        if self.vb_mesh is None:
            return list(range(v_dim))
        return self.vb_mesh.variant_rows(v_dim)

    # -- objective ------------------------------------------------------------

    def kld_prior(self, params, gen, n_particles, direction="fwd"):
        """KL(p(z) || E[p(z'|z)]) prior-matching regularizer."""
        glb_mean, glb_std = self.prior_params(params, (1, 1, self.z_dim))
        nxt_mean, nxt_std = self.z_sample(params, 1, 1, gen, direction,
                                          sample=True,
                                          n_particles=n_particles)
        return losses.kld_gauss(glb_mean, glb_std, nxt_mean, nxt_std)

    def step(self, params, state, inputs, mask, kld_mult, rec_mults, gen,
             targets=None, uni_loss=True, train=True, fused=True, **kwargs):
        """Training objective: match_mult * kld_mult * sum(mask) * (fwd +
        bwd prior matching) + f_mult * ELBO(f_mode) + s_mult *
        ELBO(s_mode with train_particles filter particles), each mode's
        joint and unimodal ELBOs computed over one stacked variant batch.
        Returns (loss, new_state)."""
        f_mode = kwargs.pop("f_mode", "bfilter")
        s_mode = kwargs.pop("s_mode", "fsmooth")
        f_mult = kwargs.pop("f_mult", 0.5)
        s_mult = kwargs.pop("s_mult", 0.5)
        match_mult = kwargs.pop("match_mult", 0.01)
        train_particles = kwargs.pop("train_particles", 25)
        match_particles = kwargs.pop("match_particles", 50)
        kwargs.pop("mode", None)
        flt_particles = kwargs.pop("flt_particles", 1)
        kwargs.pop("smt_particles", None)
        sample = kwargs.pop("sample", True)
        merge_mode_scans = kwargs.pop("merge_mode_scans", False)
        ragged_mode_scans = kwargs.pop("ragged_mode_scans", False)
        native_mods = tuple(kwargs.pop("native_mods", ()))

        mesh = self.vb_mesh
        loss = 0.0
        if match_mult > 0:
            msum = torch.sum(mask).to(torch.float32)
            for direction in ("fwd", "bwd"):
                # Drawn on every model rank, so their generators stay
                # alike; counted once per column block.
                kld = self.kld_prior(params, gen, match_particles, direction)
                if mesh is None or mesh.model_index == 0:
                    loss = loss + match_mult * kld_mult * msum * kld

        if not fused:
            if mesh is not None:
                raise ValueError("a 2-D mesh splits the fused objective's "
                                 "stacked variants; fused: false has none")
            if native_mods:
                raise ValueError("native_mods requires the fused step (the "
                                 "unfused composition takes edge layout)")
            for mult, mode, fp in ((f_mult, f_mode, flt_particles),
                                   (s_mult, s_mode, train_particles)):
                mode_loss, state = ModelBase.step(
                    self, params, state, inputs, mask, kld_mult, rec_mults,
                    gen, targets=targets, uni_loss=uni_loss, train=train,
                    mode=mode, flt_particles=fp, sample=sample, **kwargs)
                loss = loss + mult * mode_loss
            return loss, state

        inputs = {m: inputs[m] for m in inputs if m in self.modalities}
        if targets is None:
            targets = inputs
        some = inputs[list(inputs.keys())[0]]
        t_max, b_dim = some.shape[:2]
        full = self._nan_fill_missing(inputs, t_max, b_dim,
                                      native_mods=native_mods,
                                      device=some.device)
        enc_train = train
        if mesh is not None and isinstance(train, SyncStats):
            enc_train = SyncStats(mesh.data_group)
        with span("mdmm/dmm.encode"):
            (obs_mean, obs_std, obs_mask), enc_state = self.encode(
                params, state["enc"], full, enc_train, native=native_mods)
        # Variant expert-presence patterns (V, M): the joint row (when
        # there is more than one modality), then one row per modality
        # present in the inputs.
        rows = []
        if self.n_mods > 1:
            rows.append(np.ones((self.n_mods,), np.float32))
        if uni_loss:
            rows += [np.eye(self.n_mods, dtype=np.float32)[i]
                     for i, m in enumerate(self.modalities) if m in inputs]
        vmat = np.stack(rows)
        if isinstance(gen, ColumnNoise):  # a data-parallel step's
            gen = gen.stacked(len(vmat))

        dec_state = state["dec"]
        fdir = "fwd" if f_mode in ("ffilter", "bsmooth") else "bwd"
        sdir = "fwd" if s_mode in ("ffilter", "bsmooth") else "bwd"
        two_modes = (f_mode in ("ffilter", "bfilter")
                     and s_mode in ("fsmooth", "bsmooth") and fdir == sdir
                     and not kwargs.get("sample_init", False))
        # The ragged pass is the loop below (module docstring); it still
        # takes precedence over the merged pass, as in the JAX dispatch.
        can_ragged = ragged_mode_scans and two_modes
        can_merge = (merge_mode_scans and two_modes and not can_ragged
                     and flt_particles in (1, train_particles))
        if can_merge:
            f_loss, s_loss, dec_state = self._fused_two_mode_losses(
                params, dec_state, obs_mean, obs_std, obs_mask, vmat,
                targets, mask, kld_mult, rec_mults, gen, f_mode=f_mode,
                s_mode=s_mode, flt_particles=flt_particles,
                train_particles=train_particles, sample=sample,
                train=train, native_mods=native_mods, **kwargs)
            loss = loss + f_mult * f_loss + s_mult * s_loss
            return loss, {"enc": enc_state, "dec": dec_state}

        for mult, mode, fp in ((f_mult, f_mode, flt_particles),
                               (s_mult, s_mode, train_particles)):
            mode_loss, dec_state = self._fused_mode_loss(
                params, dec_state, obs_mean, obs_std, obs_mask, vmat,
                targets, mask, kld_mult, rec_mults, gen, mode=mode,
                sample=sample, flt_particles=fp, train=train,
                native_mods=native_mods, **kwargs)
            loss = loss + mult * mode_loss
        return loss, {"enc": enc_state, "dec": dec_state}

    def _variant_experts(self, obs_mean, obs_std, obs_mask, vmat):
        """Stack this process's rows of the V loss variants
        (``_variant_rows``) into one (V*B) batch: per-variant expert masks
        (M, T, V*B) and the experts tiled over V."""
        n_mods, t_max, b_dim, z_dim = obs_mean.shape
        vmat = vmat[self._variant_rows(vmat.shape[0])]
        v_dim = vmat.shape[0]
        with span("mdmm/sync.variant_mask"):
            vm = torch.as_tensor(vmat.T, device=obs_mean.device)  # (M, V)
        om = (obs_mask.to(torch.float32)[:, :, None, :]
              * vm[:, None, :, None]).reshape(n_mods, t_max, v_dim * b_dim)

        def tile(x):
            return x[:, :, None].expand(n_mods, t_max, v_dim, b_dim,
                                        z_dim).reshape(n_mods, t_max,
                                                       v_dim * b_dim, z_dim)
        return tile(obs_mean), tile(obs_std), om

    def _fused_mode_loss(self, params, dec_state, obs_mean, obs_std,
                         obs_mask, vmat, targets, mask, kld_mult, rec_mults,
                         gen, mode, sample, flt_particles, smt_particles=1,
                         sample_init=False, train=True, native_mods=()):
        """One inference mode's joint + unimodal losses in a single
        forward over the stacked variant batch."""
        zm, zs, om = self._variant_experts(obs_mean, obs_std, obs_mask,
                                           vmat)
        direction = "fwd" if mode in ("ffilter", "bsmooth") else "bwd"
        flt_init = sample_init if mode in ("ffilter", "bfilter") else False
        infer, prior, z_samples = self.z_filter(
            params, zm, zs, om, gen, direction=direction, sample=sample,
            n_particles=flt_particles, sample_init=flt_init)
        if mode in ("fsmooth", "bsmooth"):
            direction = "fwd" if mode == "fsmooth" else "bwd"
            szm, szs, som = self._smooth_experts(params, zm, zs, om, prior)
            infer, prior, z_samples = self.z_filter(
                params, szm, szs, som, gen, direction=direction,
                sample=sample, n_particles=smt_particles,
                sample_init=sample_init)
        return self._variant_objective(
            params, dec_state, infer, prior, z_samples, vmat, targets, mask,
            kld_mult, rec_mults, train, native_mods=native_mods)

    def _fused_two_mode_losses(self, params, dec_state, obs_mean, obs_std,
                               obs_mask, vmat, targets, mask, kld_mult,
                               rec_mults, gen, f_mode, s_mode, flt_particles,
                               train_particles, sample, smt_particles=1,
                               sample_init=False, train=True,
                               native_mods=()):
        """Both modes' filtering passes in one scan of 2*V*B columns at the
        larger particle count, the f-mode noise broadcast over it, so each
        f-mode particle follows the same trajectory (the JAX package's
        ``merge_mode_scans``, exact up to the rounding of the particle
        mean); then the s-mode's smoothing pass and the two modes'
        objectives."""
        t_max = obs_mean.shape[1]
        zm, zs, om = self._variant_experts(obs_mean, obs_std, obs_mask,
                                           vmat)
        vb = zm.shape[2]
        direction = "fwd" if f_mode in ("ffilter", "bsmooth") else "bwd"
        dev = zm.device
        eps_f = self._filter_eps(gen, t_max, flt_particles, vb,
                                 sample or flt_particles > 1, False, dev)
        eps_s = self._filter_eps(gen, t_max, train_particles, vb,
                                 sample or train_particles > 1, False, dev)
        k_dim = max(eps_f.shape[1], eps_s.shape[1])
        shape = (t_max, k_dim, vb, self.z_dim)
        eps = torch.cat([eps_f.expand(shape), eps_s.expand(shape)], dim=2)
        two = lambda x: torch.cat([x, x], dim=2)  # noqa: E731
        infer, prior, z_samples = self.z_filter(
            params, two(zm), two(zs), two(om), direction=direction, eps=eps)
        f_infer = (infer[0][:, :vb], infer[1][:, :vb])
        f_prior = (prior[0][:, :vb], prior[1][:, :vb])
        f_samples = z_samples[:, :vb]
        s_prior = (prior[0][:, vb:], prior[1][:, vb:])

        s_direction = "fwd" if s_mode == "fsmooth" else "bwd"
        szm, szs, som = self._smooth_experts(params, zm, zs, om, s_prior)
        s_infer, s_prior, s_samples = self.z_filter(
            params, szm, szs, som, gen, direction=s_direction, sample=sample,
            n_particles=smt_particles, sample_init=sample_init)
        f_loss, dec_state = self._variant_objective(
            params, dec_state, f_infer, f_prior, f_samples, vmat, targets,
            mask, kld_mult, rec_mults, train, native_mods=native_mods)
        s_loss, dec_state = self._variant_objective(
            params, dec_state, s_infer, s_prior, s_samples, vmat, targets,
            mask, kld_mult, rec_mults, train, native_mods=native_mods)
        return f_loss, s_loss, dec_state

    def _variant_objective(self, params, dec_state, infer, prior, z_samples,
                           vmat, targets, mask, kld_mult, rec_mults, train,
                           native_mods=()):
        """Decode + KLD + weighted reconstruction over the stacked variant
        batch (this process's rows of it, ``_variant_rows``). Each modality
        decodes only its active variant rows (BatchNorm statistics therefore
        cover T*A*B rows), none where this process has no active row of a
        modality that another has (so that every rank of a mesh meets the
        same BatchNorm reductions); Bernoulli modalities go through the
        decoder's logits and the fused logit BCE."""
        all_rows = vmat
        vmat = vmat[self._variant_rows(vmat.shape[0])]
        v_dim = vmat.shape[0]
        t_max, b_dim = mask.shape[:2]
        mask_f = mask.to(torch.float32)
        mask_v = mask_f[:, None].expand(
            (t_max, v_dim) + tuple(mask.shape[1:])).reshape(
            (t_max, v_dim * b_dim) + tuple(mask.shape[2:]))
        loss = kld_mult * losses.kld_gauss(infer[0], infer[1], prior[0],
                                           prior[1], mask_v)
        z_v = z_samples.reshape(t_max, v_dim, b_dim, self.z_dim)
        new_dec_state = dict(dec_state)
        for i, m in enumerate(self.modalities):
            active = np.nonzero(vmat[:, i])[0].tolist()
            if not all_rows[:, i].any():
                continue
            a_dim = len(active)
            # A list index goes to the device as a copy that waits.
            with span("mdmm/sync.variant_rows"):
                za = z_v[:, active].reshape(t_max * a_dim * b_dim,
                                            self.z_dim)
            dec = self.dec[m]
            use_logits = (self.dists[m] == "Bernoulli"
                          and hasattr(dec, "apply_logits"))
            apply = dec.apply_logits if use_logits else dec.apply
            out, new_dec_state[m] = apply(params["dec"][m], dec_state[m],
                                          za, train)
            if m not in targets:
                continue
            mult = rec_mults.get(m, 1.0) if rec_mults else 1.0
            if mult == 0:
                continue
            x = targets[m]
            raw_perm = getattr(dec, "raw_perm", None)
            if m in native_mods:
                if not use_logits:
                    raise ValueError("native_mods modality %r has no logits "
                                     "decode path" % (m,))
            elif use_logits and raw_perm is not None:
                x = x.permute((0, 1) + tuple(2 + p for p in raw_perm))
            lm_a = mask_f.reshape((t_max, 1, b_dim) + (1,) * (x.dim() - 3)
                                  + (1,))
            rec = tuple(r.reshape((t_max, a_dim, b_dim) + tuple(r.shape[1:]))
                        for r in out)
            if use_logits:
                obs = ~torch.isnan(x)
                xs = torch.where(obs, x, torch.zeros_like(x))[:, None]
                cm = obs.to(torch.float32)[:, None] * lm_a
                loss = loss + mult * losses.bce_logits_masked_sum(rec[0], xs,
                                                                  cm)
                continue
            xa = x[:, None]
            if self.dists[m] == "Bernoulli":
                loss = loss + mult * losses.nll_bernoulli(rec[0], xa, lm_a)
            elif self.dists[m] == "Categorical":
                labels = xa.expand((t_max, a_dim) + tuple(x.shape[1:]))
                loss = loss + mult * losses.nll_categorical(rec[0], labels,
                                                            lm_a)
            else:
                loss = loss + mult * losses.nll_gauss(rec[0], rec[1], xa,
                                                      lm_a)
        return loss, new_dec_state
