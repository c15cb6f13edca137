"""The plain reference of the multimodal DMM with BFVI, in plain PyTorch.

It follows the published model (Tan et al., "Factorized Inference in Deep
Markov Models for Incomplete Multimodal Time Series", AAAI 2020, and the
authors' ztangent/multimodal-dmm code): per-modality encoders give
Gaussian experts, a filtering pass runs the gated transition on K
particles, fuses each particle's transition with the global prior, mixes
the particles by moment matching, fuses the mixture with the masked
experts (signed precisions, so an inverse expert cancels one) and samples;
a smoothing pass adds the filter's prior and the inverse global prior as
experts. The objective sums the prior-matching terms of the two rollout
directions and the ELBOs of the joint and unimodal variants under a
filtering and a smoothing mode.

Everything runs as plain ``torch`` operations on whatever device the
tensors are on, in the channel-first (edge) layout, with autograd for the
gradients. Nothing here imports the program under test: the
configuration's file says which codecs and widths to build, and the
benchmark hands this module the same weights, data and generator seeds it
hands the program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8
PREC_FLOOR = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# ---------------------------------------------------------------------------
# Parameter specifications: (kind, shape, bound) leaves
# ---------------------------------------------------------------------------

def _lin(n_in, n_out, xavier=False):
    bound = (math.sqrt(6.0 / (n_in + n_out)) if xavier
             else 1.0 / math.sqrt(n_in))
    return {"w": ("u", (n_out, n_in), bound),
            "b": ("u", (n_out,), 1.0 / math.sqrt(n_in))}


def _conv(c_in, c_out, k, n_dims):
    """A convolution's weight (c_out, c_in, k...), xavier; its bias
    1/sqrt(fan_in)."""
    fan_in, fan_out = c_in * k ** n_dims, c_out * k ** n_dims
    return {"w": ("u", (c_out, c_in) + (k,) * n_dims,
                  math.sqrt(6.0 / (fan_in + fan_out))),
            "b": ("u", (c_out,), 1.0 / math.sqrt(fan_in))}


def _deconv(c_in, c_out, k, n_dims):
    """A transposed convolution's weight (c_in, c_out, k...), xavier with
    fan_in = c_in k^n, bias 1/sqrt(fan_out)."""
    fan_in, fan_out = c_in * k ** n_dims, c_out * k ** n_dims
    return {"w": ("u", (c_in, c_out) + (k,) * n_dims,
                  math.sqrt(6.0 / (fan_in + fan_out))),
            "b": ("u", (c_out,), 1.0 / math.sqrt(fan_out))}


def _bn(c):
    return ({"scale": ("c", (c,), 1.0), "bias": ("c", (c,), 0.0)},
            {"mean": ("c", (c,), 0.0), "var": ("c", (c,), 1.0),
             "eps": BN_EPS, "momentum": BN_MOMENTUM})


def _gauss_mlp(n_in, n_out, h):
    return {"in_to_h": _lin(n_in, h), "h_to_mean": _lin(h, n_out),
            "h_to_std": _lin(h, n_out)}


def conv_geometry(mod):
    """(n_dims, channels, in size, deconv kernel, feature shape) of a conv
    codec: images 64x64 with 4-wide deconvolutions, audio slices of
    ``n_freqs`` bins with 3-wide ones."""
    n_layers, n_k = mod["n_layers"], mod["n_kernels"]
    if mod["codec"] == "image":
        c, size = mod["dims"][0], mod["dims"][1]
        fs = size // 2 ** n_layers
        return 2, c, size, 4, (n_k, fs, fs)
    c, size = mod["dims"][0], mod["dims"][1]
    fs = (size - 1) // 2 ** n_layers + 1
    return 1, c, size, 3, (n_k, fs)


def _conv_codecs(mod, z_dim):
    n_dims, c, _, k_dec, feat_shape = conv_geometry(mod)
    n_layers, n_k = mod["n_layers"], mod["n_kernels"]
    feat_dim = int(np.prod(feat_shape))
    chans = [c] + [n_k // 2 ** (n_layers - 1 - l) for l in range(n_layers)]
    enc = {"convs": [_conv(chans[l], chans[l + 1], 3, n_dims)
                     for l in range(n_layers)], "bns": []}
    enc_state = {"bns": []}
    for l in range(n_layers - 1):
        p, s = _bn(chans[l + 1])
        enc["bns"].append(p)
        enc_state["bns"].append(s)
    enc["to_mean"] = _lin(feat_dim, z_dim, xavier=True)
    enc["to_std"] = _lin(feat_dim, z_dim, xavier=True)
    chans = [n_k // 2 ** l for l in range(n_layers)] + [c]
    dec = {"z_to_feat": _lin(z_dim, feat_dim, xavier=True),
           "deconvs": [_deconv(chans[l], chans[l + 1], k_dec, n_dims)
                       for l in range(n_layers)], "bns": []}
    dec_state = {"bns": []}
    for l in range(n_layers - 1):
        p, s = _bn(chans[l + 1])
        dec["bns"].append(p)
        dec_state["bns"].append(s)
    return enc, enc_state, dec, dec_state


def param_specs(cfg):
    """(params, state) trees of the configuration with ``(kind, shape,
    bound)`` leaves: "u" uniform in [-bound, bound], "n" standard normal,
    "c" the constant ``bound``."""
    z, h = cfg["z_dim"], cfg["h_dim"]
    params = {"enc": {}, "dec": {}}
    state = {"enc": {}, "dec": {}}
    for mod in cfg["modalities"]:
        m = mod["name"]
        if mod["dist"] == "Categorical":
            params["enc"][m] = {"embed": {"w": ("n", (mod["dims"], h), 1.0)},
                                "head": _gauss_mlp(h, z, h)}
            params["dec"][m] = {"in_to_h": _lin(z, h),
                                "h_to_out": _lin(h, mod["dims"])}
            state["enc"][m], state["dec"][m] = {}, {}
        else:
            (params["enc"][m], state["enc"][m], params["dec"][m],
             state["dec"][m]) = _conv_codecs(mod, z)
    gtf = {"gate_1": _lin(z, h), "gate_2": _lin(h, z), "z_lin": _lin(z, z),
           "nonlin_1": _lin(z, h), "nonlin_2": _lin(h, z),
           "z_to_std": _lin(z, z)}
    params["trans"] = {"fwd": gtf, "bwd": dict(gtf)}
    params["z0_mean"] = ("c", (1, z), 0.0)
    params["z0_log_std"] = ("c", (1, z), 0.0)
    return params, state


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _conv_op(n_dims, transposed):
    if n_dims == 2:
        return F.conv_transpose2d if transposed else F.conv2d
    return F.conv_transpose1d if transposed else F.conv1d


def _batchnorm(p, s, x, train):
    if train:
        return F.batch_norm(x, None, None, p["scale"], p["bias"],
                            training=True, eps=s["eps"])
    return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"],
                        training=False, eps=s["eps"])


def encode_conv(mod, p, s, x, train):
    """x (N, C, ...) -> (mean, std) (N, z)."""
    conv = _conv_op(conv_geometry(mod)[0], False)
    h = x
    n_layers = len(p["convs"])
    for l in range(n_layers):
        h = conv(h, p["convs"][l]["w"], p["convs"][l]["b"], stride=2,
                 padding=1)
        if l < n_layers - 1:
            h = F.relu(_batchnorm(p["bns"][l], s["bns"][l], h, train))
    feats = h.reshape(h.shape[0], -1)
    return (F.linear(feats, p["to_mean"]["w"], p["to_mean"]["b"]),
            F.softplus(F.linear(feats, p["to_std"]["w"], p["to_std"]["b"])))


def decode_conv(mod, p, s, z, train):
    """z (N, z_dim) -> pre-sigmoid logits (N, C, ...)."""
    n_dims, _, _, _, feat_shape = conv_geometry(mod)
    deconv = _conv_op(n_dims, True)
    h = F.relu(F.linear(z, p["z_to_feat"]["w"], p["z_to_feat"]["b"]))
    h = h.reshape((-1,) + tuple(feat_shape))
    n_layers = len(p["deconvs"])
    for l in range(n_layers):
        h = deconv(h, p["deconvs"][l]["w"], p["deconvs"][l]["b"], stride=2,
                   padding=1)
        if l < n_layers - 1:
            h = F.relu(_batchnorm(p["bns"][l], s["bns"][l], h, train))
    return h


def _gauss_mlp_apply(p, x, min_std):
    h = F.relu(F.linear(x, p["in_to_h"]["w"], p["in_to_h"]["b"]))
    return (F.linear(h, p["h_to_mean"]["w"], p["h_to_mean"]["b"]),
            F.softplus(F.linear(h, p["h_to_std"]["w"], p["h_to_std"]["b"]))
            + min_std)


def encode_label(p, x, min_std):
    idx = x.reshape(x.shape[0]).to(torch.int64)
    return _gauss_mlp_apply(p["head"], F.relu(p["embed"]["w"][idx]), min_std)


def decode_label(p, z):
    h = F.relu(F.linear(z, p["in_to_h"]["w"], p["in_to_h"]["b"]))
    return torch.softmax(F.linear(h, p["h_to_out"]["w"], p["h_to_out"]["b"]),
                         dim=-1)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _bmask(mask, ndim):
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - mask.dim()))


def kld_gauss(m1, s1, m2, s2, mask=None):
    """Masked sum of KL(N(m1, s1) || N(m2, s2)), stds clamped to [1e-6,
    1e6], the mean gap to +-1e15."""
    if mask is not None:
        shape = torch.broadcast_shapes(m1.shape, s1.shape, m2.shape,
                                       s2.shape)
        keep = _bmask(mask, len(shape)) > 0
        zero = torch.zeros((), dtype=m1.dtype, device=m1.device)
        one = torch.ones((), dtype=s1.dtype, device=s1.device)
        m1, m2 = torch.where(keep, m1, zero), torch.where(keep, m2, zero)
        s1, s2 = torch.where(keep, s1, one), torch.where(keep, s2, one)
    s1, s2 = torch.clamp(s1, 1e-6, 1e6), torch.clamp(s2, 1e-6, 1e6)
    diff = torch.clamp(m1 - m2, -1e15, 1e15)
    return 0.5 * torch.sum(2 * torch.log(s2) - 2 * torch.log(s1)
                           + (s1 * s1 + diff * diff) / (s2 * s2) - 1)


def bce_logits(logits, x, mask):
    """Masked sum of the Bernoulli NLL of pre-sigmoid ``logits``, each log
    clamped at -100; ``mask`` 0/1 broadcasts to ``x``."""
    obs = ~torch.isnan(x)
    xs = torch.where(obs, x, torch.zeros_like(x))
    m = obs.to(logits.dtype) * mask
    nll = -(xs * torch.clamp(-F.softplus(-logits), min=-100.0)
            + (1.0 - xs) * torch.clamp(-F.softplus(logits), min=-100.0))
    return torch.sum(torch.where(m > 0, nll, torch.zeros_like(nll)) * m)


def nll_bernoulli(theta, x, mask):
    """Masked sum of the Bernoulli NLL of probabilities ``theta``, as
    torch's BCE clamps its logs."""
    m = (~torch.isnan(x)).to(x.dtype) * _bmask(mask, x.dim()).to(x.dtype)
    xs = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    theta = torch.where(m > 0, theta, torch.full_like(theta, 0.5))
    nll = -(xs * torch.clamp(torch.log(theta), min=-100.0)
            + (1.0 - xs) * torch.clamp(torch.log1p(-theta), min=-100.0))
    return torch.sum(nll * m)


def nll_categorical(probs, x, mask):
    """The authors' categorical term: ``-p[target]`` summed over observed
    steps; ``x`` (..., 1) float labels."""
    m = (~torch.isnan(x)).to(x.dtype) * _bmask(mask, x.dim()).to(x.dtype)
    labels = torch.where(torch.isnan(x), torch.zeros_like(x), x).to(
        torch.int64)
    labels = labels.expand(tuple(probs.shape[:-1]) + (1,))
    p = torch.gather(probs, -1, labels)
    p = torch.where(m > 0, p, torch.zeros_like(p))
    return torch.sum(-p * m)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

def gtf(p, z, min_std):
    """The gated transition on particles z (..., D)."""
    lin = lambda name, x: F.linear(x, p[name]["w"], p[name]["b"])  # noqa
    gate = torch.sigmoid(lin("gate_2", F.relu(lin("gate_1", z))))
    z_nonlin = lin("nonlin_2", F.relu(lin("nonlin_1", z)))
    z_std = F.softplus(lin("z_to_std", z_nonlin)) + min_std
    return (1 - gate) * lin("z_lin", z) + gate * z_nonlin, z_std


def transition_prior(p, z, glb_mean, glb_std, min_std):
    """p(z_next | particles z (K, B, D)): each particle's transition fused
    with the global prior, then the particles' moment-matched mixture."""
    q_mean, q_std = gtf(p, z, min_std)
    p1 = 1.0 / (glb_std * glb_std + EPS)
    p2 = 1.0 / (q_std * q_std + EPS)
    den = p1 + p2
    pp_mean = (glb_mean * p1 + q_mean * p2) / den
    pp_var = 1.0 / den
    mean = pp_mean.mean(0)
    var = pp_var.mean(0) + (pp_mean * pp_mean).mean(0) - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def fuse_experts(prior_mean, prior_std, obs_mean, obs_std, obs_mask):
    """PoE of a prior and M masked experts with signed stds (M, B, D); a
    total precision under 1e-6 gives mean 0 and std 1e3."""
    zero = torch.zeros((), dtype=prior_mean.dtype, device=prior_mean.device)
    num = prior_mean / (prior_std * prior_std + EPS)
    den = 1.0 / (prior_std * prior_std + EPS)
    for m in range(obs_mean.shape[0]):
        keep = obs_mask[m].unsqueeze(-1) > 0
        prec = torch.where(keep, torch.sign(obs_std[m])
                           / (obs_std[m] * obs_std[m] + EPS), zero)
        num = num + torch.where(keep, obs_mean[m] * prec, zero)
        den = den + prec
    low = den < PREC_FLOOR
    safe = torch.where(low, torch.ones_like(den), den)
    return (torch.where(low, zero, num / safe),
            torch.where(low, torch.full_like(safe, PREC_FLOOR ** -0.5),
                        torch.rsqrt(safe)))


def filter_pass(p_trans, glb_mean, glb_std, obs_mean, obs_std, obs_mask, eps,
                min_std, backward):
    """One filtering pass over experts (M, T, B, D) with noise (T, K, B,
    D) in the pass's own time order. Returns (prior_mean, prior_std,
    infer_mean, infer_std, particle-mean sample), each (T, B, D) in the
    data's time order."""
    xs = [x.transpose(0, 1) for x in (obs_mean, obs_std, obs_mask)]
    if backward:
        xs = [torch.flip(x, [0]) for x in xs]
    outs = [[] for _ in range(5)]
    z = None
    for t in range(xs[0].shape[0]):
        if t == 0:
            pm, ps = glb_mean, glb_std
        else:
            pm, ps = transition_prior(p_trans, z, glb_mean, glb_std, min_std)
        im, ist = fuse_experts(pm, ps, xs[0][t], xs[1][t], xs[2][t])
        z = im + eps[t] * ist
        for lst, v in zip(outs, (pm, ps, im, ist, z.mean(0))):
            lst.append(v)
    outs = [torch.stack(v) for v in outs]
    if backward:
        outs = [torch.flip(v, [0]) for v in outs]
    return outs


class Reference:
    """The model of one configuration (``configs/<name>.json``) over a
    weight tree shaped by ``param_specs``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.mods = cfg["modalities"]
        self.names = [m["name"] for m in self.mods]
        self.z_dim = cfg["z_dim"]
        self.min_std = cfg["min_std"]

    def prior(self, params, lead):
        mean = params["z0_mean"][0].expand(tuple(lead) + (self.z_dim,))
        std = (torch.exp(params["z0_log_std"][0]) + self.min_std).expand(
            tuple(lead) + (self.z_dim,))
        return mean, std

    def encode(self, params, state, inputs, train):
        """inputs {m: (T, B, ...)} with NaN where missing -> experts (M, T,
        B, D) and masks (M, T, B)."""
        means, stds, masks = [], [], []
        for mod in self.mods:
            m = mod["name"]
            x = inputs[m]
            t_max, b_dim = x.shape[:2]
            nan = torch.isnan(x)
            masks.append(~nan.reshape(t_max * b_dim, -1).any(-1))
            flat = torch.where(nan, torch.zeros_like(x), x).reshape(
                (t_max * b_dim,) + tuple(x.shape[2:]))
            if mod["dist"] == "Categorical":
                mean, std = encode_label(params["enc"][m], flat, self.min_std)
            else:
                mean, std = encode_conv(mod, params["enc"][m],
                                        state["enc"][m], flat, train)
            means.append(mean.reshape(t_max, b_dim, -1))
            stds.append(std.reshape(t_max, b_dim, -1))
        t_max, b_dim = means[0].shape[:2]
        return (torch.stack(means), torch.stack(stds),
                torch.stack(masks).reshape(len(self.mods), t_max, b_dim).to(
                    torch.float32))

    def decode(self, params, state, mod, z, train, logits):
        m = mod["name"]
        if mod["dist"] == "Categorical":
            return decode_label(params["dec"][m], z)
        out = decode_conv(mod, params["dec"][m], state["dec"][m], z, train)
        return out if logits else torch.sigmoid(out)

    def filter(self, params, obs_mean, obs_std, obs_mask, eps, backward):
        glb_mean, glb_std = self.prior(params, obs_mean.shape[2:3])
        return filter_pass(params["trans"]["bwd" if backward else "fwd"],
                           glb_mean, glb_std, obs_mean, obs_std, obs_mask,
                           eps, self.min_std, backward)

    def smooth_experts(self, params, zm, zs, om, flt_prior):
        t_max, b_dim = zm.shape[1:3]
        glb_mean, glb_std = self.prior(params, (t_max, b_dim))
        ones = torch.ones((t_max, b_dim), device=zm.device)
        flt_mask = ones.clone()
        flt_mask[-1] = 0.0
        return (torch.cat([zm, flt_prior[0][None], glb_mean[None]]),
                torch.cat([zs, flt_prior[1][None], -glb_std[None]]),
                torch.cat([om, flt_mask[None], ones[None]]))

    # -- the training objective ----------------------------------------------

    def kld_prior(self, params, gen, n_particles, backward):
        glb_mean, glb_std = self.prior(params, (1,))
        eps = torch.randn((1, n_particles, 1, self.z_dim), generator=gen,
                          device=glb_mean.device)
        z = glb_mean + glb_std * eps[0]
        nxt = transition_prior(params["trans"]["bwd" if backward else "fwd"],
                               z, glb_mean, glb_std, self.min_std)
        g_mean, g_std = self.prior(params, (1, 1))
        return kld_gauss(g_mean, g_std, nxt[0][None], nxt[1][None])

    def step_loss(self, params, state, inputs, targets, mask, kld_mult, gen):
        """The summed training objective of one batch: inputs and targets
        {m: (T, B, ...)} (NaN where missing), mask (T, B, 1); noise from
        ``gen`` in the order: the forward and backward rollouts, the
        filtering mode's pass, the smoothing mode's filtering pass, its
        smoothing pass."""
        tr = self.cfg["train"]
        dev = mask.device
        loss = 0.0
        msum = torch.sum(mask)
        for backward in (False, True):
            loss = loss + (tr["match_mult"] * kld_mult * msum
                           * self.kld_prior(params, gen,
                                            tr["match_particles"], backward))
        obs_mean, obs_std, obs_mask = self.encode(params, state, inputs, True)
        n_mods, t_max, b_dim, z_dim = obs_mean.shape
        rows = [np.ones((n_mods,), np.float32)] if n_mods > 1 else []
        rows += [np.eye(n_mods, dtype=np.float32)[i] for i in range(n_mods)]
        vmat = np.stack(rows)
        v_dim = len(vmat)
        vm = torch.as_tensor(vmat.T, device=dev)
        om = (obs_mask[:, :, None, :] * vm[:, None, :, None]).reshape(
            n_mods, t_max, v_dim * b_dim)
        tile = lambda x: x[:, :, None].expand(  # noqa: E731
            n_mods, t_max, v_dim, b_dim, z_dim).reshape(
            n_mods, t_max, v_dim * b_dim, z_dim)
        zm, zs = tile(obs_mean), tile(obs_std)
        vb = v_dim * b_dim
        for mult, mode, k in ((tr["f_mult"], tr["f_mode"],
                               tr["flt_particles"]),
                              (tr["s_mult"], tr["s_mode"],
                               tr["train_particles"])):
            backward = mode in ("bfilter", "fsmooth")
            eps = torch.randn((t_max, k, vb, z_dim), generator=gen,
                              device=dev)
            outs = self.filter(params, zm, zs, om, eps, backward)
            if mode in ("fsmooth", "bsmooth"):
                szm, szs, som = self.smooth_experts(params, zm, zs, om,
                                                    outs[:2])
                eps = torch.randn((t_max, 1, vb, z_dim), generator=gen,
                                  device=dev)
                outs = self.filter(params, szm, szs, som, eps,
                                   mode == "bsmooth")
            loss = loss + mult * self.variant_objective(
                params, state, outs, vmat, targets, mask, kld_mult)
        return loss

    def variant_objective(self, params, state, outs, vmat, targets, mask,
                          kld_mult):
        prior_mean, prior_std, infer_mean, infer_std, z = outs
        v_dim = len(vmat)
        t_max, b_dim = mask.shape[:2]
        mask_v = mask[:, None].expand(t_max, v_dim, b_dim, 1).reshape(
            t_max, v_dim * b_dim, 1)
        loss = kld_mult * kld_gauss(infer_mean, infer_std, prior_mean,
                                    prior_std, mask_v)
        z_v = z.reshape(t_max, v_dim, b_dim, self.z_dim)
        rec_mults = self.cfg["train"]["rec_mults"]
        for i, mod in enumerate(self.mods):
            active = np.nonzero(vmat[:, i])[0].tolist()
            a_dim = len(active)
            za = z_v[:, active].reshape(t_max * a_dim * b_dim, self.z_dim)
            out = self.decode(params, state, mod, za, True, logits=True)
            x = targets[mod["name"]][:, None]
            out = out.reshape((t_max, a_dim, b_dim) + tuple(out.shape[1:]))
            lm = _bmask(mask[:, None, :, 0], x.dim())
            mult = rec_mults[mod["name"]]
            if mod["dist"] == "Categorical":
                labels = x.expand((t_max, a_dim) + tuple(x.shape[2:]))
                loss = loss + mult * nll_categorical(out, labels, lm)
            else:
                loss = loss + mult * bce_logits(out, x, lm)
        return loss

    # -- the evaluation -------------------------------------------------------

    def eval_forward(self, params, state, inputs, gen):
        """The evaluation's forward without gradients: a sampled filtering
        pass of ``flt_particles`` particles, then (``fsmooth``) the MAP
        smoothing pass, and the decoders' probabilities."""
        ev = self.cfg["eval"]
        obs_mean, obs_std, obs_mask = self.encode(params, state, inputs,
                                                  False)
        n_mods, t_max, b_dim, z_dim = obs_mean.shape
        dev = obs_mean.device
        mode = ev["mode"]
        eps = torch.randn((t_max, ev["flt_particles"], b_dim, z_dim),
                          generator=gen, device=dev)
        outs = self.filter(params, obs_mean, obs_std, obs_mask, eps,
                           mode in ("bfilter", "fsmooth"))
        if mode in ("fsmooth", "bsmooth"):
            szm, szs, som = self.smooth_experts(params, obs_mean, obs_std,
                                                obs_mask, outs[:2])
            outs = self.filter(params, szm, szs, som,
                               torch.zeros((t_max, 1, b_dim, z_dim),
                                           device=dev), mode == "bsmooth")
        flat = outs[4].reshape(t_max * b_dim, z_dim)
        recon = {}
        for mod in self.mods:
            r = self.decode(params, state, mod, flat, False, logits=False)
            recon[mod["name"]] = r.reshape((t_max, b_dim)
                                           + tuple(r.shape[1:]))
        return outs, recon
