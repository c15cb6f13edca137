"""The BFVI filtering scan: CUDA kernels for Hopper, their plain PyTorch
versions, and the ``autograd.Function`` that joins them.

Counterpart of multimodal_dmm_tpu/ops/pallas/bfvi_scan.py. One call runs
the whole T-step filtering loop of one direction (callers flip time for
backward passes). Each step: the GTF transition on K particles, a
per-particle PoE with the global prior, a moment-matched mixture over K
(the global prior itself at t = 0), a masked signed-precision PoE with
the M observation experts (floor 1e-6), then z = mu + eps * sigma.

Shapes: obs_mean/obs_std (T, M, B, D), obs_mask (T, M, B), glb_mean/
glb_std (B, D), eps (T, K, B, D); ``gtf`` is the dict of six linear
layers in PyTorch layout (w (out, in), b (out,)). Outputs: prior mean/
std, inference mean/std and the particle-mean sample, each (T, B, D),
plus the particle trajectory z_traj (T, K, B, D) that the backward reads.

- ``bfvi_scan_fwd_ref`` / ``bfvi_scan_bwd_ref``: plain versions; the
  backward transcribes the TPU kernel's hand-derived VJP, including its
  two quirks: the per-particle PoE has no NaN exclusion, and the backward
  floors the mixture variance at 1e-8 before ``sqrt`` where the forward
  floors it at 0. ``bfvi_scan_bwd_ref_on_masks`` runs the plain backward
  on the ReLU masks that the backward kernel found in the GTF's first
  layers, to hold the kernel to it element by element.
- ``bfvi_scan_fwd_cuda`` / ``bfvi_scan_bwd_cuda``: launch the kernels of
  ``csrc/bfvi_scan.cu`` (cooperative launches whose products run on the
  tensor cores in 3xTF32, ``csrc/tf32x3.cuh``); the backward writes, for
  every particle row of every step, the activations and cotangents that
  the weight gradients are products of, and ``gtf_wgrad_cuda`` (plain
  version ``gtf_wgrad_ref``) forms those products. Each wrapper counts
  its launches in ``.launches``. The kernels read the GTF weights in
  PyTorch's layout; the wrapper only joins gate_1, nonlin_1 and z_lin
  into one (2H + D, D) matrix.
- ``bfvi_scan``: differentiable entry. CPU tensors go through the plain
  pair, CUDA tensors through the kernels; there is no fallback between
  them. To hold the kernels against the plain pair on the GPU, the caller
  may ask for the plain pair (``plain=True``) or for the plain backward
  after the forward kernel (``plain="bwd"``). ``obs_mask`` and ``eps``
  get no gradient.
"""

import ctypes
import types

import torch
import torch.nn.functional as F

from ...models.nn import GTF_LAYERS, gtf_apply
from . import _build

EPS = 1e-8
PREC_FLOOR = 1e-6
# The particle counts the kernels take: the filtering passes of the
# training step and the MAP smoothing pass use 1 and 25; the evaluation's
# 200-particle pass goes through the cell kernel (poe_cell.py).
MAX_K = 32


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _poe_obs(prior_mean, prior_std, obs_mean, obs_std, obs_mask):
    """PoE of [positive-std prior; M signed-std masked experts];
    obs_*: (M, B, D), obs_mask: (M, B)."""
    zero = torch.zeros((), dtype=prior_mean.dtype, device=prior_mean.device)
    prec_p = 1.0 / (prior_std * prior_std + EPS)
    num = prior_mean * prec_p
    den = prec_p
    for m in range(obs_mean.shape[0]):
        mk = obs_mask[m].unsqueeze(-1) > 0
        var = obs_std[m] * obs_std[m] + EPS
        prec = torch.where(mk, torch.sign(obs_std[m]) / var, zero)
        num = num + torch.where(mk, obs_mean[m] * prec, zero)
        den = den + prec
    low = den < PREC_FLOOR
    safe = torch.where(low, torch.ones_like(den), den)
    mean = torch.where(low, zero, num / safe)
    std = torch.where(low, torch.full_like(safe, 1e3), torch.rsqrt(safe))
    return mean, std


def bfvi_scan_fwd_ref(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                      eps, min_std):
    """Plain forward: a Python loop over t. Returns (prior_mean,
    prior_std, infer_mean, infer_std, samples, z_traj)."""
    t_max = obs_mean.shape[0]
    obs_mask = obs_mask.to(obs_mean.dtype)
    p1 = 1.0 / (glb_std * glb_std + EPS)
    z = None
    outs = [[] for _ in range(6)]
    for t in range(t_max):
        if t == 0:
            prior_mean, prior_std = glb_mean, glb_std
        else:
            q_mean, q_std = gtf_apply(gtf, z, min_std)
            p2 = 1.0 / (q_std * q_std + EPS)
            den2 = p1 + p2
            pp_mean = (glb_mean * p1 + q_mean * p2) / den2
            pp_std = torch.rsqrt(den2)
            prior_mean = pp_mean.mean(0)
            var = ((pp_std * pp_std).mean(0) + (pp_mean * pp_mean).mean(0)
                   - prior_mean * prior_mean)
            prior_std = torch.sqrt(torch.clamp(var, min=0.0))
        infer_mean, infer_std = _poe_obs(prior_mean, prior_std, obs_mean[t],
                                         obs_std[t], obs_mask[t])
        z = infer_mean + eps[t] * infer_std
        for lst, v in zip(outs, (prior_mean, prior_std, infer_mean,
                                 infer_std, z.mean(0), z)):
            lst.append(v)
    return tuple(torch.stack(v) for v in outs)


def bfvi_scan_bwd_ref(res, cots, min_std):
    """Plain backward: the TPU kernel's hand-derived reverse-time VJP in
    tensor ops. ``res`` = (obs_mean, obs_std, obs_mask, glb_mean,
    glb_std, gtf, eps, z_traj, prior_mean, prior_std); ``cots`` = the
    five output cotangents. Returns (d_obs_mean, d_obs_std, d_glb_mean,
    d_glb_std, d_gtf) with d_gtf in PyTorch layout. As in the kernels,
    the weight gradients are formed after the loop (``gtf_wgrad_ref``)
    from the activations and cotangents of every step."""
    (obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps, z_traj,
     prior_mean, prior_std) = res
    g_pm, g_ps, g_im, g_is, g_smp = cots
    t_max, n_exp = obs_mean.shape[:2]
    k = eps.shape[1]
    zero = torch.zeros((), dtype=obs_mean.dtype, device=obs_mean.device)
    mask = obs_mask.unsqueeze(-1) > 0
    sgn = torch.sign(obs_std)
    var_o = obs_std * obs_std + EPS
    prec_o = sgn / var_o
    p1 = 1.0 / (glb_std * glb_std + EPS)
    w = {n: gtf[n]["w"] for n in GTF_LAYERS}
    b = {n: gtf[n]["b"] for n in GTF_LAYERS}

    d_obs_mean = torch.zeros_like(obs_mean)
    d_obs_std = torch.zeros_like(obs_std)
    d_glb_mean = torch.zeros_like(glb_mean)
    d_glb_std = torch.zeros_like(glb_std)
    gz = torch.zeros_like(eps[0])
    xs, ys = [None] * t_max, [None] * t_max  # per step t >= 1: (K, B, .)

    for t in reversed(range(t_max)):
        prior_m, prior_s = prior_mean[t], prior_std[t]
        var_p = prior_s * prior_s + EPS
        prec_p = 1.0 / var_p
        num, den = prior_m * prec_p, prec_p
        for m in range(n_exp):
            prec = torch.where(mask[t, m], prec_o[t, m], zero)
            num = num + torch.where(mask[t, m], obs_mean[t, m] * prec, zero)
            den = den + prec
        low = den < PREC_FLOOR
        safe = torch.where(low, torch.ones_like(den), den)

        gz_tot = gz + g_smp[t] / k
        gim = g_im[t] + gz_tot.sum(0)
        gis = g_is[t] + (gz_tot * eps[t]).sum(0)
        d_num = torch.where(low, zero, gim / safe)
        d_den = torch.where(low, zero, -gim * num / (safe * safe)
                            - 0.5 * gis * safe ** -1.5)
        for m in range(n_exp):
            d_prec = torch.where(mask[t, m], d_num * obs_mean[t, m] + d_den,
                                 zero)
            d_obs_mean[t, m] = torch.where(mask[t, m], d_num * prec_o[t, m],
                                           zero)
            d_obs_std[t, m] = d_prec * (-2.0 * sgn[t, m] * obs_std[t, m]
                                        / (var_o[t, m] * var_o[t, m]))
        d_prior_m = d_num * prec_p + g_pm[t]
        d_prior_s = ((d_num * prior_m + d_den)
                     * (-2.0 * prior_s / (var_p * var_p)) + g_ps[t])
        if t == 0:  # the global prior was the prior at t = 0
            d_glb_mean += d_prior_m
            d_glb_std += d_prior_s
            break

        # Recompute the transition on z_{t-1}.
        z_prev = z_traj[t - 1]
        a1 = F.linear(z_prev, w["gate_1"], b["gate_1"])
        h1 = F.relu(a1)
        gate = torch.sigmoid(F.linear(h1, w["gate_2"], b["gate_2"]))
        z_lin = F.linear(z_prev, w["z_lin"], b["z_lin"])
        b1 = F.linear(z_prev, w["nonlin_1"], b["nonlin_1"])
        hn = F.relu(b1)
        z_non = F.linear(hn, w["nonlin_2"], b["nonlin_2"])
        s_raw = F.linear(z_non, w["z_to_std"], b["z_to_std"])
        q_std = F.softplus(s_raw) + min_std
        q_mean = (1 - gate) * z_lin + gate * z_non
        p2 = 1.0 / (q_std * q_std + EPS)
        den2 = p1 + p2
        num2 = glb_mean * p1 + q_mean * p2
        ppm = num2 / den2
        pps = torch.rsqrt(den2)
        mu = ppm.mean(0)

        # Mixture VJP (variance floored at EPS, as in the TPU kernel).
        var = (pps * pps).mean(0) + (ppm * ppm).mean(0) - mu * mu
        ps_val = torch.sqrt(torch.clamp(var, min=EPS))
        d_var = torch.where(var > 0, d_prior_s / (2.0 * ps_val), zero)
        d_ppm = d_prior_m / k + d_var * 2.0 * (ppm - mu) / k
        d_pps = d_var * 2.0 * pps / k

        # PoE2 VJP.
        d_num2 = d_ppm / den2
        d_den2 = -d_ppm * num2 / (den2 * den2) - 0.5 * d_pps * den2 ** -1.5
        d_qm = d_num2 * p2
        d_qs = ((d_num2 * q_mean + d_den2)
                * (-2.0 * q_std / ((q_std * q_std + EPS) ** 2)))
        d_glb_mean += (d_num2 * p1).sum(0)
        d_glb_std += ((d_num2 * glb_mean + d_den2).sum(0)
                      * (-2.0 * glb_std / ((glb_std * glb_std + EPS) ** 2)))

        # GTF VJP.
        d_sraw = d_qs * torch.sigmoid(s_raw)
        d_znon = d_sraw @ w["z_to_std"] + d_qm * gate
        d_zlin = d_qm * (1 - gate)
        d_a2 = d_qm * (z_non - z_lin) * gate * (1 - gate)
        d_a1 = (d_a2 @ w["gate_2"]) * (a1 > 0)
        d_b1 = (d_znon @ w["nonlin_2"]) * (b1 > 0)
        gz = (d_a1 @ w["gate_1"] + d_zlin @ w["z_lin"]
              + d_b1 @ w["nonlin_1"])
        xs[t] = torch.cat([h1, hn, z_non], dim=-1)
        ys[t] = torch.cat([d_a1, d_b1, d_zlin, d_a2, d_znon, d_sraw], dim=-1)

    d = obs_mean.shape[-1]
    h = w["gate_1"].shape[0]
    if t_max > 1:
        xs = torch.stack(xs[1:]).reshape(-1, 2 * h + d)
        ys = torch.stack(ys[1:]).reshape(-1, 2 * h + 4 * d)
    else:
        xs = obs_mean.new_zeros((0, 2 * h + d))
        ys = obs_mean.new_zeros((0, 2 * h + 4 * d))
    return (d_obs_mean, d_obs_std, d_glb_mean, d_glb_std,
            gtf_wgrad_ref(z_traj, xs, ys))


def relu_flip_bound(d):
    """How close to 0, relative to sum_i |z_i w_i| + |b|, the exact
    pre-activation of a GTF first-layer unit with D = ``d`` inputs must
    lie where the backward kernel (3xTF32 on the tensor cores, whose adds
    truncate) and the plain backward (float32) put it on opposite sides
    of its ReLU: twice the worst-case rounding of the (D + 1)-term sum at
    truncation's unit 2^-23, plus the split's 3 * 2^-22 a product."""
    return 2.0 * (d + 7) * 2.0 ** -23


def bfvi_scan_bwd_ref_on_masks(res, cots, min_std, xs):
    """``bfvi_scan_bwd_ref`` with the ReLU masks of the GTF first layers
    (gate_1, nonlin_1) taken from ``xs``, the rows that the backward kernel
    wrote (a unit is on where its h1 or hn there is > 0), instead of from
    the plain pre-activations; everything else as computed there. Where the
    two masks differ the pre-activation is within rounding of 0, and each
    such flip would move one row of the layer's weight gradient by one
    sample's whole term; on the kernel's masks the plain backward can be
    held to the kernel element by element.

    Returns (the outputs of ``bfvi_scan_bwd_ref``, margins): margins maps
    gate_1 and nonlin_1 to the exact (float64) |pre-activation| / (sum_i
    |z_i w_i| + |b|) at each unit where the masks differ, to be held
    within ``relu_flip_bound(D)``."""
    global F
    z_traj, gtf = res[7], res[5]
    t_max, k, b_dim, d = z_traj.shape
    h = gtf["gate_1"]["w"].shape[0]
    rows = xs.reshape(t_max - 1, k, b_dim, -1) if t_max > 1 else None
    first = {id(gtf[n]["w"]): (n, i * h) for i, n in
             enumerate(("gate_1", "nonlin_1"))}
    margins = {"gate_1": [], "nonlin_1": []}
    plain_f = F

    def linear(x, w, b):
        out = plain_f.linear(x, w, b)
        if id(w) not in first:
            return out
        name, col = first[id(w)]
        t1 = (x.storage_offset() - z_traj.storage_offset()) // (k * b_dim * d)
        on = rows[t1, ..., col:col + h] > 0
        flip = on != (out > 0)
        if bool(flip.any()):
            x64, w64, b64 = x.double(), w.double(), b.double()
            exact = plain_f.linear(x64, w64, b64).abs()
            scale = plain_f.linear(x64.abs(), w64.abs(), b64.abs())
            margins[name].append((exact / scale)[flip])
        return torch.where(on, out.clamp(min=torch.finfo(out.dtype).tiny),
                           out.clamp(max=0.0))

    F = types.SimpleNamespace(linear=linear, relu=plain_f.relu,
                              softplus=plain_f.softplus)
    try:
        outs = bfvi_scan_bwd_ref(res, cots, min_std)
    finally:
        F = plain_f
    none = torch.zeros((0,), dtype=torch.float64, device=z_traj.device)
    return outs, {n: torch.cat(v) if v else none for n, v in margins.items()}


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("bfvi_scan")
    if not getattr(lib, "_bfvi_typed", False):
        lib.bfvi_scan_fwd.argtypes = ([_P] * 22 + [_I] * 6
                                      + [ctypes.c_float, _P])
        lib.bfvi_scan_fwd.restype = _I
        lib.bfvi_scan_bwd.argtypes = ([_P] * 30 + [_I] * 6
                                      + [ctypes.c_float, _P])
        lib.bfvi_scan_bwd.restype = _I
        lib.gtf_wgrad.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.gtf_wgrad.restype = _I
        lib._bfvi_typed = True
    return lib


def _dims(obs_mean, eps, gtf):
    t_max, n_exp, b_dim, d = obs_mean.shape
    return t_max, n_exp, b_dim, eps.shape[1], d, gtf["gate_1"]["w"].shape[0]


def _check_tensor(name, x, shape):
    if not x.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % name)
    if x.dtype != torch.float32:
        raise ValueError("%s must be float32, got %s" % (name, x.dtype))
    if tuple(x.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(x.shape), tuple(shape)))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _check_sizes(k, d, h):
    if not 1 <= k <= MAX_K:
        raise ValueError("the scan kernels take 1 <= K <= %d particles, "
                         "got K = %d" % (MAX_K, k))
    if d % 4 or h % 4:
        raise ValueError("the scan kernels need z_dim and h_dim divisible "
                         "by 4, got %d and %d" % (d, h))


def _kernel_weights(gtf):
    """The kernels' weights, in PyTorch's (out, in) layout: [w1, b1, wg2,
    bg2, wn2, bn2, ws, bs] with w1 = [gate_1; nonlin_1; z_lin]."""
    out = [torch.cat([gtf[n]["w"] for n in ("gate_1", "nonlin_1", "z_lin")]),
           torch.cat([gtf[n]["b"] for n in ("gate_1", "nonlin_1", "z_lin")])]
    for name in ("gate_2", "nonlin_2", "z_to_std"):
        out += [gtf[name]["w"], gtf[name]["b"]]
    return out


def _barrier(device):
    """The arrival counter of a launch's grid barriers, zeroed."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _check_gtf(gtf, d, h):
    shapes = {"gate_1": (h, d), "gate_2": (d, h), "z_lin": (d, d),
              "nonlin_1": (h, d), "nonlin_2": (d, h), "z_to_std": (d, d)}
    for name, shape in shapes.items():
        _check_tensor(name + ".w", gtf[name]["w"], shape)
        _check_tensor(name + ".b", gtf[name]["b"], shape[:1])


def _check_inputs(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                  eps):
    t_max, n_exp, b_dim, k, d, h = _dims(obs_mean, eps, gtf)
    _check_tensor("obs_mean", obs_mean, (t_max, n_exp, b_dim, d))
    _check_tensor("obs_std", obs_std, (t_max, n_exp, b_dim, d))
    _check_tensor("obs_mask", obs_mask, (t_max, n_exp, b_dim))
    _check_tensor("glb_mean", glb_mean, (b_dim, d))
    _check_tensor("glb_std", glb_std, (b_dim, d))
    _check_tensor("eps", eps, (t_max, k, b_dim, d))
    _check_gtf(gtf, d, h)
    return t_max, n_exp, b_dim, k, d, h


def bfvi_scan_fwd_cuda(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                       eps, min_std):
    """Launch the forward kernel on the current stream; same outputs as
    ``bfvi_scan_fwd_ref``."""
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    _check_sizes(k, d, h)
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    outs = [torch.empty((t_max, b_dim, d), **opts) for _ in range(5)]
    outs.append(torch.empty((t_max, k, b_dim, d), **opts))
    work = torch.empty((k * b_dim, 2 * h + 4 * d), **opts)
    stream = torch.cuda.current_stream(obs_mean.device).cuda_stream
    rc = _lib().bfvi_scan_fwd(
        *[_ptr(x) for x in [obs_mean, obs_std, obs_mask, glb_mean, glb_std]
          + _kernel_weights(gtf) + [eps] + outs
          + [work, _barrier(obs_mean.device)]],
        t_max, n_exp, b_dim, k, d, h, float(min_std),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("bfvi_scan_fwd kernel launch failed: CUDA error "
                           "%d" % rc)
    bfvi_scan_fwd_cuda.launches += 1
    return tuple(outs)


bfvi_scan_fwd_cuda.launches = 0


def partial_size(d, h):
    """Floats in one weight-gradient partial: dW1 (D x (2H+D)), db1,
    dWg2, dbg2, dWn2, dbn2, dWs, dbs."""
    la = 2 * h + d
    return d * la + la + 2 * (h * d + d) + d * d + d


def bfvi_scan_bwd_cuda(res, cots, min_std):
    """Launch the backward scan kernel on the current stream, then the
    weight-gradient kernel on the rows it wrote (``gtf_wgrad_cuda``);
    same outputs as ``bfvi_scan_bwd_ref``."""
    (obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps, z_traj,
     prior_mean, prior_std) = res
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    _check_sizes(k, d, h)
    _check_tensor("z_traj", z_traj, (t_max, k, b_dim, d))
    for name, x in zip(("prior_mean", "prior_std", "g_prior_mean",
                        "g_prior_std", "g_infer_mean", "g_infer_std",
                        "g_samples"), (prior_mean, prior_std) + tuple(cots)):
        _check_tensor(name, x, (t_max, b_dim, d))
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    d_obs_mean = torch.empty_like(obs_mean)
    d_obs_std = torch.empty_like(obs_std)
    d_glb_mean = torch.zeros((b_dim, d), **opts)
    d_glb_std = torch.zeros((b_dim, d), **opts)
    n_rows = (t_max - 1) * k * b_dim
    xs = torch.empty((n_rows, 2 * h + d), **opts)
    ys = torch.empty((n_rows, 2 * h + 4 * d), **opts)
    gz = torch.zeros((3, k * b_dim, d), **opts)
    stream = torch.cuda.current_stream(obs_mean.device).cuda_stream
    rc = _lib().bfvi_scan_bwd(
        *[_ptr(x) for x in [obs_mean, obs_std, obs_mask, glb_mean, glb_std]
          + _kernel_weights(gtf) + [eps, z_traj, prior_mean, prior_std]
          + list(cots) + [d_obs_mean, d_obs_std, d_glb_mean, d_glb_std,
                          xs, ys, gz, _barrier(obs_mean.device)]],
        t_max, n_exp, b_dim, k, d, h, float(min_std),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("bfvi_scan_bwd kernel launch failed: CUDA error "
                           "%d" % rc)
    bfvi_scan_bwd_cuda.launches += 1
    if bfvi_scan_bwd_cuda.rows is not None:
        bfvi_scan_bwd_cuda.rows.append(xs)
    return (d_obs_mean, d_obs_std, d_glb_mean, d_glb_std,
            gtf_wgrad_cuda(z_traj, xs, ys))


bfvi_scan_bwd_cuda.launches = 0
# A list to which each launch appends the xs rows it wrote (their h1 and
# hn hold the kernel's ReLU masks, for bfvi_scan_bwd_ref_on_masks), or
# None.
bfvi_scan_bwd_cuda.rows = None


# Row ranges that the weight-gradient kernel splits its rows into, each
# with its own partial: the 48 output tiles of D = H = 256 times 11 are
# 528 CTAs, two full waves of two CTAs on each of the H100's 132 SMs.
WGRAD_SPLITS = 11


def _wgrad_dims(z_traj, xs):
    t_max, k, b_dim, d = z_traj.shape
    return (t_max - 1) * k * b_dim, d, (xs.shape[1] - d) // 2


def gtf_wgrad_ref(z_traj, xs, ys):
    """Plain version of ``gtf_wgrad_cuda``: the GTF weight gradients, in
    PyTorch layout, as products over the backward's rows. Row
    ((t-1) K + k) B + b of xs = [h1 | hn | z_nonlin] and of ys = [d_a1 |
    d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw] belong to particle k of
    column b at step t >= 1, whose input z_traj[t-1, k, b] is the same
    row of z_traj."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    z = z_traj.reshape(-1, d)[:n_rows]
    y1, d_a2, d_znon, d_sraw = torch.split(ys, [2 * h + d, d, d, d], dim=1)
    h1, hn, z_non = torch.split(xs, [h, h, d], dim=1)
    dw1, db1 = y1.t() @ z, y1.sum(0)
    return {
        "gate_1": {"w": dw1[:h], "b": db1[:h]},
        "nonlin_1": {"w": dw1[h:2 * h], "b": db1[h:2 * h]},
        "z_lin": {"w": dw1[2 * h:], "b": db1[2 * h:]},
        "gate_2": {"w": d_a2.t() @ h1, "b": d_a2.sum(0)},
        "nonlin_2": {"w": d_znon.t() @ hn, "b": d_znon.sum(0)},
        "z_to_std": {"w": d_sraw.t() @ z_non, "b": d_sraw.sum(0)},
    }


def gtf_wgrad_cuda(z_traj, xs, ys):
    """Launch the weight-gradient kernel on the current stream and sum its
    partials in a fixed order; same outputs as ``gtf_wgrad_ref``."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    _check_tensor("z_traj", z_traj, tuple(z_traj.shape))
    _check_tensor("xs", xs, (n_rows, 2 * h + d))
    _check_tensor("ys", ys, (n_rows, 2 * h + 4 * d))
    partial = torch.empty((WGRAD_SPLITS, partial_size(d, h)),
                          dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _lib().gtf_wgrad(_ptr(z_traj), _ptr(xs), _ptr(ys), _ptr(partial),
                          WGRAD_SPLITS, n_rows, d, h, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("gtf_wgrad kernel launch failed: CUDA error %d"
                           % rc)
    gtf_wgrad_cuda.launches += 1
    return unpack_partial(partial.sum(0), d, h)


gtf_wgrad_cuda.launches = 0


def unpack_partial(tot, d, h):
    """Split a summed partial into PyTorch-layout GTF gradients."""
    la = 2 * h + d
    sizes = [d * la, la, h * d, d, h * d, d, d * d, d]
    dw1, db1, dwg2, dbg2, dwn2, dbn2, dws, dbs = torch.split(tot, sizes)
    dw1 = dw1.reshape(d, la).t()
    return {
        "gate_1": {"w": dw1[:h], "b": db1[:h]},
        "nonlin_1": {"w": dw1[h:2 * h], "b": db1[h:2 * h]},
        "z_lin": {"w": dw1[2 * h:], "b": db1[2 * h:]},
        "gate_2": {"w": dwg2.reshape(h, d).t(), "b": dbg2},
        "nonlin_2": {"w": dwn2.reshape(h, d).t(), "b": dbn2},
        "z_to_std": {"w": dws.reshape(d, d).t(), "b": dbs},
    }


# ---------------------------------------------------------------------------
# Differentiable entry
# ---------------------------------------------------------------------------

def _gtf_from_flat(wb):
    return {n: {"w": wb[2 * i], "b": wb[2 * i + 1]}
            for i, n in enumerate(GTF_LAYERS)}


class _BfviScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, min_std, plain, obs_mean, obs_std, obs_mask,
                glb_mean, glb_std, eps, *wb):
        gtf = _gtf_from_flat(wb)
        kernel = obs_mean.is_cuda and plain is not True
        fwd = bfvi_scan_fwd_cuda if kernel else bfvi_scan_fwd_ref
        outs = fwd(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps,
                   min_std)
        ctx.min_std = min_std
        ctx.kernel = kernel and not plain
        ctx.save_for_backward(obs_mean, obs_std, obs_mask, glb_mean,
                              glb_std, eps, outs[5], outs[0], outs[1], *wb)
        return outs[:5]

    @staticmethod
    def backward(ctx, *grads):
        (obs_mean, obs_std, obs_mask, glb_mean, glb_std, eps, z_traj,
         prior_mean, prior_std, *wb) = ctx.saved_tensors
        cots = tuple(torch.zeros_like(prior_mean) if g is None
                     else g.contiguous() for g in grads)
        res = (obs_mean, obs_std, obs_mask, glb_mean, glb_std,
               _gtf_from_flat(wb), eps, z_traj, prior_mean, prior_std)
        bwd = bfvi_scan_bwd_cuda if ctx.kernel else bfvi_scan_bwd_ref
        d_om, d_os, d_gm, d_gs, d_gtf = bwd(res, cots, ctx.min_std)
        flat = []
        for name in GTF_LAYERS:
            flat += [d_gtf[name]["w"], d_gtf[name]["b"]]
        return (None, None, d_om, d_os, None, d_gm, d_gs, None) + tuple(flat)


def bfvi_scan(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps,
              min_std, plain=False):
    """Differentiable fused filtering loop. Returns (prior_mean,
    prior_std, infer_mean, infer_std, samples), each (T, B, D).
    ``plain=True`` runs the plain versions on any device and
    ``plain="bwd"`` only the backward, to hold the kernels against them
    on the GPU."""
    if plain not in (False, True, "bwd"):
        raise ValueError("plain must be False, True or 'bwd', got %r"
                         % (plain,))
    wb = []
    for name in GTF_LAYERS:
        wb += [gtf[name]["w"].contiguous(), gtf[name]["b"].contiguous()]
    return _BfviScan.apply(
        float(min_std), plain, obs_mean.contiguous(),
        obs_std.contiguous(),
        obs_mask.to(torch.float32).contiguous(), glb_mean.contiguous(),
        glb_std.contiguous(), eps.contiguous(), *wb)
