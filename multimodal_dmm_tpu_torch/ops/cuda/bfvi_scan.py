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
  its launches in ``.launches``. With ``bf16=True`` each wrapper launches
  the kernel's bfloat16 variant instead (``*_bf16_kernel`` of
  ``csrc/bfvi_scan_bf16.cu``: one mma.sync m16n8k16 bf16 pass a product,
  ``csrc/tf32x3.cuh``) and counts it in ``.launches_bf16``. The kernels
  read the GTF weights in
  PyTorch's layout; the wrapper joins gate_1, nonlin_1 and z_lin into
  one (2H + D, D) matrix and, where D or H is no multiple of 4 (the
  spirals model's D = 5), zero-pads every operand to the next multiple
  of 4 and slices the outputs back (``_check_sizes``).
- ``bfvi_scan``: differentiable entry. CPU tensors go through the plain
  pair, CUDA tensors through the kernels; there is no fallback between
  them. To hold the kernels against the plain pair on the GPU, the caller
  may ask for the plain pair (``plain=True``) or for the plain backward
  after the forward kernel (``plain="bwd"``). ``obs_mask`` and ``eps``
  get no gradient.

``bf16=True`` everywhere is the JAX package's ``MultiDMM(bf16_gtf=True)``
(its ``lax.scan`` path): every GTF product takes its operands rounded to
bfloat16, sums them in float32 and rounds its output to bfloat16 before
the float32 bias (``models.nn.linear_cd``); in the backward each
cotangent is rounded to bfloat16 before its transposed product, whose
output is rounded too. The weight gradients are products of the
bfloat16-rounded activations and cotangents summed in float32 over all
rows at once, where JAX rounds each step's product to bfloat16 and sums
the steps in bfloat16 (ROADMAP.md, Queue C); the bias gradients sum the
float32 cotangents, as JAX's do.
"""

import ctypes

import torch
import torch.nn.functional as F

from ...models.nn import (GTF_LAYERS, gtf_apply, gtf_apply_packed,
                          gtf_pack, linear_cd, round_to)
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


def _rb(x):
    return round_to(x, torch.bfloat16)


def bfvi_scan_fwd_ref(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                      eps, min_std, bf16=False):
    """Plain forward: a Python loop over t. Returns (prior_mean,
    prior_std, infer_mean, infer_std, samples, z_traj). ``bf16``: the GTF
    products with the JAX package's bfloat16 rounding points."""
    t_max = obs_mean.shape[0]
    obs_mask = obs_mask.to(obs_mean.dtype)
    p1 = 1.0 / (glb_std * glb_std + EPS)
    z = None
    outs = [[] for _ in range(6)]
    packed = gtf_pack(gtf, torch.bfloat16) if bf16 else None
    for t in range(t_max):
        if t == 0:
            prior_mean, prior_std = glb_mean, glb_std
        else:
            q_mean, q_std = (gtf_apply_packed(packed, z, min_std) if bf16
                             else gtf_apply(gtf, z, min_std))
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


def _layer(x, w, b, bf16):
    """A GTF layer's pre-activation x w^T + b; with ``bf16`` the product
    of the bfloat16-rounded operands, summed in float32, rounded to
    bfloat16 before the float32 bias (``nn.linear_cd``)."""
    if not bf16:
        return linear_cd(x, w, b)
    return linear_cd(x, w.to(torch.bfloat16), b, torch.bfloat16)


def _cot_product(c, w, bf16):
    """c @ w, a cotangent through a layer's weight (out, in); with
    ``bf16`` the cotangent and the weight rounded to bfloat16 and the
    product's output too."""
    if not bf16:
        return c @ w
    return _rb(_rb(c) @ _rb(w))


def bfvi_scan_bwd_ref(res, cots, min_std, bf16=False):
    """Plain backward: the TPU kernel's hand-derived reverse-time VJP in
    tensor ops. ``res`` = (obs_mean, obs_std, obs_mask, glb_mean,
    glb_std, gtf, eps, z_traj, prior_mean, prior_std); ``cots`` = the
    five output cotangents. Returns (d_obs_mean, d_obs_std, d_glb_mean,
    d_glb_std, d_gtf) with d_gtf in PyTorch layout. As in the kernels,
    the weight gradients are formed after the loop (``gtf_wgrad_ref``)
    from the activations and cotangents of every step. ``bf16``: the GTF
    products and their transposes with the JAX package's bfloat16
    rounding points (module docstring)."""
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
        a1 = _layer(z_prev, w["gate_1"], b["gate_1"], bf16)
        h1 = F.relu(a1)
        gate = torch.sigmoid(_layer(h1, w["gate_2"], b["gate_2"], bf16))
        z_lin = _layer(z_prev, w["z_lin"], b["z_lin"], bf16)
        b1 = _layer(z_prev, w["nonlin_1"], b["nonlin_1"], bf16)
        hn = F.relu(b1)
        z_non = _layer(hn, w["nonlin_2"], b["nonlin_2"], bf16)
        s_raw = _layer(z_non, w["z_to_std"], b["z_to_std"], bf16)
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
        d_znon = _cot_product(d_sraw, w["z_to_std"], bf16) + d_qm * gate
        d_zlin = d_qm * (1 - gate)
        d_a2 = d_qm * (z_non - z_lin) * gate * (1 - gate)
        d_a1 = _cot_product(d_a2, w["gate_2"], bf16) * (a1 > 0)
        d_b1 = _cot_product(d_znon, w["nonlin_2"], bf16) * (b1 > 0)
        if bf16:  # one product over the packed [gate_1; nonlin_1; z_lin]
            gz = _cot_product(
                torch.cat([d_a1, d_b1, d_zlin], dim=-1),
                torch.cat([w["gate_1"], w["nonlin_1"], w["z_lin"]]), True)
        else:
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
            gtf_wgrad_ref(z_traj, xs, ys, bf16))


def relu_flip_bound(d, bf16=False):
    """How close to 0, relative to sum_i |z_i w_i| + |b|, the exact
    pre-activation of a GTF first-layer unit with D = ``d`` inputs must
    lie where the backward kernel (3xTF32 on the tensor cores, whose adds
    truncate) and the plain backward (float32) put it on opposite sides
    of its ReLU: twice the worst-case rounding of the (D + 1)-term sum at
    truncation's unit 2^-23, plus the split's 3 * 2^-22 a product. With
    ``bf16`` (z and w the bfloat16-rounded operands, whose products are
    exact) each side also rounds the product's sum to bfloat16 before the
    bias, up to 2^-8 of it: twice that more."""
    f32 = 2.0 * (d + 7) * 2.0 ** -23
    return f32 + 2.0 * 2.0 ** -8 if bf16 else f32


def bfvi_scan_bwd_ref_on_masks(res, cots, min_std, xs, bf16=False):
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
    within ``relu_flip_bound(D, bf16)``; with ``bf16``, of the
    bfloat16-rounded z and w."""
    global _layer
    z_traj, gtf = res[7], res[5]
    t_max, k, b_dim, d = z_traj.shape
    h = gtf["gate_1"]["w"].shape[0]
    rows = xs.reshape(t_max - 1, k, b_dim, -1) if t_max > 1 else None
    first = {id(gtf[n]["w"]): (n, i * h) for i, n in
             enumerate(("gate_1", "nonlin_1"))}
    margins = {"gate_1": [], "nonlin_1": []}
    plain_layer = _layer

    def layer(x, w, b, bf16):
        out = plain_layer(x, w, b, bf16)
        if id(w) not in first:
            return out
        name, col = first[id(w)]
        t1 = (x.storage_offset() - z_traj.storage_offset()) // (k * b_dim * d)
        on = rows[t1, ..., col:col + h] > 0
        flip = on != (out > 0)
        if bool(flip.any()):
            xr, wr = (_rb(x), _rb(w)) if bf16 else (x, w)
            x64, w64, b64 = xr.double(), wr.double(), b.double()
            exact = F.linear(x64, w64, b64).abs()
            scale = F.linear(x64.abs(), w64.abs(), b64.abs())
            margins[name].append((exact / scale)[flip])
        return torch.where(on, out.clamp(min=torch.finfo(out.dtype).tiny),
                           out.clamp(max=0.0))

    _layer = layer
    try:
        outs = bfvi_scan_bwd_ref(res, cots, min_std, bf16)
    finally:
        _layer = plain_layer
    none = torch.zeros((0,), dtype=torch.float64, device=z_traj.device)
    return outs, {n: torch.cat(v) if v else none for n, v in margins.items()}


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(bf16=False):
    """The kernels' library: the float32 kernels, or with ``bf16`` their
    bfloat16 variants (``csrc/bfvi_scan_bf16.cu``), with the same C entry
    points."""
    lib = _build.load("bfvi_scan_bf16" if bf16 else "bfvi_scan")
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
    """Raise unless 1 <= K <= MAX_K; return the widths (D', H') that the
    kernels run at: D and H rounded up to multiples of 4, for the 16-byte
    rows of their tile loads (``csrc/tf32x3.cuh``)."""
    if not 1 <= k <= MAX_K:
        raise ValueError("the scan kernels take 1 <= K <= %d particles, "
                         "got K = %d" % (MAX_K, k))
    return _padded(d), _padded(h)


def _padded(n):
    return -(-n // 4) * 4


# Zero-padding to the kernels' widths. A padded input dim meets only zero
# weights, so the real dims never see the padded ones; the padded dims
# carry mean 0, std 1 (global prior, experts, the recomputed prior std)
# and zero noise, trajectories and cotangents, so they stay finite (the
# transition's std there is softplus(0) + min_std) and their cotangents
# stay 0. The real outputs equal the unpadded computation up to summation
# order.

def _pad_last(x, width, value=0.0):
    """``x`` with its last dim padded to ``width`` with ``value``."""
    n = x.shape[-1]
    if n == width:
        return x
    out = x.new_full(tuple(x.shape[:-1]) + (width,), value)
    out[..., :n] = x
    return out


def _pad_blocks(x, sizes, widths):
    """The column blocks of ``x`` (of ``sizes``) each padded with zeros to
    its entry of ``widths``."""
    if tuple(sizes) == tuple(widths):
        return x
    return torch.cat([_pad_last(b, w) for b, w in
                      zip(torch.split(x, list(sizes), dim=-1), widths)], -1)


def _unpad_blocks(x, sizes, widths):
    """The inverse of ``_pad_blocks``: the real columns of each block."""
    if tuple(sizes) == tuple(widths):
        return x
    return torch.cat([b[..., :n] for b, n in
                      zip(torch.split(x, list(widths), dim=-1), sizes)], -1)


def _gtf_shapes(d, h):
    return {"gate_1": (h, d), "gate_2": (d, h), "z_lin": (d, d),
            "nonlin_1": (h, d), "nonlin_2": (d, h), "z_to_std": (d, d)}


def _unpad_gtf(grads, d, h):
    """GTF weight gradients at the padded widths, sliced to (D, H)."""
    out = {}
    for name, (n_out, n_in) in _gtf_shapes(d, h).items():
        out[name] = {"w": grads[name]["w"][:n_out, :n_in].contiguous(),
                     "b": grads[name]["b"][:n_out].contiguous()}
    return out


def _pad_gtf(gtf, dp, hp):
    """The six GTF layers zero-padded to (D', H')."""
    out = {}
    for name, shape in _gtf_shapes(dp, hp).items():
        w, b = gtf[name]["w"], gtf[name]["b"]
        if tuple(w.shape) != shape:
            wp = w.new_zeros(shape)
            wp[:w.shape[0], :w.shape[1]] = w
            w, b = wp, _pad_last(b, shape[0])
        out[name] = {"w": w, "b": b}
    return out


def _pad_scan_inputs(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                    eps, dp, hp):
    """The forward scan's inputs padded to (D', H') as the kernels get
    them: ([obs_mean, obs_std, obs_mask, glb_mean, glb_std], gtf, eps)."""
    return ([_pad_last(obs_mean, dp), _pad_last(obs_std, dp, 1.0), obs_mask,
             _pad_last(glb_mean, dp), _pad_last(glb_std, dp, 1.0)],
            _pad_gtf(gtf, dp, hp), _pad_last(eps, dp))


def _pad_bwd_inputs(res, cots, dp, hp):
    """The backward scan's ``res`` and ``cots`` padded to (D', H')."""
    x, gtf, eps = _pad_scan_inputs(*res[:7], dp, hp)
    z_traj, prior_mean, prior_std = res[7:]
    res = tuple(x) + (gtf, eps, _pad_last(z_traj, dp),
                      _pad_last(prior_mean, dp),
                      _pad_last(prior_std, dp, 1.0))
    return res, [_pad_last(c, dp) for c in cots]


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
    for name, shape in _gtf_shapes(d, h).items():
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


def _count(wrapper, bf16):
    """One launch of ``wrapper``'s kernel, on its route's counter."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def bfvi_scan_fwd_cuda(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                       eps, min_std, bf16=False):
    """Launch the forward kernel (its bfloat16 variant with ``bf16``) on
    the current stream, at widths padded to multiples of 4
    (``_check_sizes``); same outputs as ``bfvi_scan_fwd_ref``."""
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    dp, hp = _check_sizes(k, d, h)
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    outs = [torch.empty((t_max, b_dim, dp), **opts) for _ in range(5)]
    outs.append(torch.empty((t_max, k, b_dim, dp), **opts))
    work = torch.empty((k * b_dim, 2 * hp + 4 * dp), **opts)
    x, gtf, eps = _pad_scan_inputs(obs_mean, obs_std, obs_mask, glb_mean,
                                  glb_std, gtf, eps, dp, hp)
    stream = torch.cuda.current_stream(obs_mean.device).cuda_stream
    rc = _lib(bf16).bfvi_scan_fwd(
        *[_ptr(v) for v in x + _kernel_weights(gtf) + [eps] + outs
          + [work, _barrier(obs_mean.device)]],
        t_max, n_exp, b_dim, k, dp, hp, float(min_std),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("bfvi_scan_fwd%s kernel launch failed: CUDA "
                           "error %d" % ("_bf16" if bf16 else "", rc))
    _count(bfvi_scan_fwd_cuda, bf16)
    if dp != d:
        outs = [o[..., :d].contiguous() for o in outs]
    return tuple(outs)


bfvi_scan_fwd_cuda.launches = bfvi_scan_fwd_cuda.launches_bf16 = 0


def partial_size(d, h):
    """Floats in one weight-gradient partial: dW1 (D x (2H+D)), db1,
    dWg2, dbg2, dWn2, dbn2, dWs, dbs."""
    la = 2 * h + d
    return d * la + la + 2 * (h * d + d) + d * d + d


def bfvi_scan_bwd_cuda(res, cots, min_std, bf16=False):
    """Launch the backward scan kernel on the current stream, then the
    weight-gradient kernel on the rows it wrote (their bfloat16 variants
    with ``bf16``), at widths padded to multiples of 4; same outputs as
    ``bfvi_scan_bwd_ref``."""
    (obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps, z_traj,
     prior_mean, prior_std) = res
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    dp, hp = _check_sizes(k, d, h)
    _check_tensor("z_traj", z_traj, (t_max, k, b_dim, d))
    for name, x in zip(("prior_mean", "prior_std", "g_prior_mean",
                        "g_prior_std", "g_infer_mean", "g_infer_std",
                        "g_samples"), (prior_mean, prior_std) + tuple(cots)):
        _check_tensor(name, x, (t_max, b_dim, d))
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    d_obs_mean = torch.empty((t_max, n_exp, b_dim, dp), **opts)
    d_obs_std = torch.empty((t_max, n_exp, b_dim, dp), **opts)
    d_glb_mean = torch.zeros((b_dim, dp), **opts)
    d_glb_std = torch.zeros((b_dim, dp), **opts)
    n_rows = (t_max - 1) * k * b_dim
    xs = torch.empty((n_rows, 2 * hp + dp), **opts)
    ys = torch.empty((n_rows, 2 * hp + 4 * dp), **opts)
    gz = torch.zeros((3, k * b_dim, dp), **opts)
    res, cots = _pad_bwd_inputs(res, cots, dp, hp)
    z_traj = res[7]
    x = (list(res[:5]) + _kernel_weights(res[5]) + list(res[6:])
         + list(cots))
    stream = torch.cuda.current_stream(obs_mean.device).cuda_stream
    rc = _lib(bf16).bfvi_scan_bwd(
        *[_ptr(v) for v in x + [d_obs_mean, d_obs_std, d_glb_mean,
                                d_glb_std, xs, ys, gz,
                                _barrier(obs_mean.device)]],
        t_max, n_exp, b_dim, k, dp, hp, float(min_std),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("bfvi_scan_bwd%s kernel launch failed: CUDA "
                           "error %d" % ("_bf16" if bf16 else "", rc))
    _count(bfvi_scan_bwd_cuda, bf16)
    if bfvi_scan_bwd_cuda.rows is not None:
        bfvi_scan_bwd_cuda.rows.append(
            _unpad_blocks(xs, (h, h, d), (hp, hp, dp)))
    d_gtf = _gtf_wgrad_launch(z_traj, xs, ys, n_rows, dp, hp, bf16)
    outs = (d_obs_mean, d_obs_std, d_glb_mean, d_glb_std)
    if dp != d:
        outs = tuple(o[..., :d].contiguous() for o in outs)
    if (dp, hp) != (d, h):
        d_gtf = _unpad_gtf(d_gtf, d, h)
    return outs + (d_gtf,)


bfvi_scan_bwd_cuda.launches = bfvi_scan_bwd_cuda.launches_bf16 = 0
# A list to which each launch (of either variant) appends the xs rows it
# wrote, at the real widths (their h1 and hn hold the kernel's ReLU masks,
# for bfvi_scan_bwd_ref_on_masks), or None.
bfvi_scan_bwd_cuda.rows = None



# The weight-gradient kernel's CTAs: its output tiles (128 x 64, the
# LargePromoted shape of csrc/tf32x3.cuh) times the row ranges it splits
# the rows into, each with its own partial. 528 CTAs are two full waves of
# two CTAs on each of the H100's 132 SMs: at D = H = 256 the 48 tiles
# times 11 ranges; at the spirals widths (D = 8 padded, H = 20) 4 tiles
# times 132 ranges, where 11 ranges left most SMs idle while each CTA
# summed 67,500 rows.
WGRAD_CTAS = 528
WGRAD_TILE = (128, 64)


def wgrad_splits(d, h):
    """The row ranges of the weight-gradient kernel at widths (D, H)."""
    la = 2 * h + d
    tiles = sum(-(-m // WGRAD_TILE[0]) * -(-n // WGRAD_TILE[1])
                for m, n in ((d, la), (h, d), (h, d), (d, d)))
    return -(-WGRAD_CTAS // tiles)


def _wgrad_dims(z_traj, xs):
    t_max, k, b_dim, d = z_traj.shape
    return (t_max - 1) * k * b_dim, d, (xs.shape[1] - d) // 2


def gtf_wgrad_ref(z_traj, xs, ys, bf16=False):
    """Plain version of ``gtf_wgrad_cuda``: the GTF weight gradients, in
    PyTorch layout, as products over the backward's rows. Row
    ((t-1) K + k) B + b of xs = [h1 | hn | z_nonlin] and of ys = [d_a1 |
    d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw] belong to particle k of
    column b at step t >= 1, whose input z_traj[t-1, k, b] is the same
    row of z_traj. ``bf16``: the weight gradients are products of the
    bfloat16-rounded rows (summed in float32); the bias gradients sum the
    float32 cotangents."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    z = z_traj.reshape(-1, d)[:n_rows]
    y1, d_a2, d_znon, d_sraw = torch.split(ys, [2 * h + d, d, d, d], dim=1)
    h1, hn, z_non = torch.split(xs, [h, h, d], dim=1)
    r = _rb if bf16 else (lambda x: x)
    dw1, db1 = r(y1).t() @ r(z), y1.sum(0)
    return {
        "gate_1": {"w": dw1[:h], "b": db1[:h]},
        "nonlin_1": {"w": dw1[h:2 * h], "b": db1[h:2 * h]},
        "z_lin": {"w": dw1[2 * h:], "b": db1[2 * h:]},
        "gate_2": {"w": r(d_a2).t() @ r(h1), "b": d_a2.sum(0)},
        "nonlin_2": {"w": r(d_znon).t() @ r(hn), "b": d_znon.sum(0)},
        "z_to_std": {"w": r(d_sraw).t() @ r(z_non), "b": d_sraw.sum(0)},
    }


def _gtf_wgrad_launch(z_traj, xs, ys, n_rows, d, h, bf16):
    """Launch the weight-gradient kernel (its bfloat16 variant with
    ``bf16``) on rows at widths (D, H) that are multiples of 4 and sum its
    partials in a fixed order."""
    splits = wgrad_splits(d, h)
    partial = torch.empty((splits, partial_size(d, h)), dtype=torch.float32,
                          device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _lib(bf16).gtf_wgrad(_ptr(z_traj), _ptr(xs), _ptr(ys),
                              _ptr(partial), splits, n_rows, d, h,
                              ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("gtf_wgrad%s kernel launch failed: CUDA error %d"
                           % ("_bf16" if bf16 else "", rc))
    _count(gtf_wgrad_cuda, bf16)
    return unpack_partial(partial.sum(0), d, h)


def gtf_wgrad_cuda(z_traj, xs, ys, bf16=False):
    """Launch the weight-gradient kernel (its bfloat16 variant with
    ``bf16``) on the current stream, at widths padded to multiples of 4;
    same outputs as ``gtf_wgrad_ref``."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    _check_tensor("z_traj", z_traj, tuple(z_traj.shape))
    _check_tensor("xs", xs, (n_rows, 2 * h + d))
    _check_tensor("ys", ys, (n_rows, 2 * h + 4 * d))
    dp, hp = _padded(d), _padded(h)
    grads = _gtf_wgrad_launch(
        _pad_last(z_traj, dp), _pad_blocks(xs, (h, h, d), (hp, hp, dp)),
        _pad_blocks(ys, (h, h) + (d,) * 4, (hp, hp) + (dp,) * 4), n_rows,
        dp, hp, bf16)
    return grads if (dp, hp) == (d, h) else _unpad_gtf(grads, d, h)


gtf_wgrad_cuda.launches = gtf_wgrad_cuda.launches_bf16 = 0


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
    def forward(ctx, min_std, plain, bf16, obs_mean, obs_std, obs_mask,
                glb_mean, glb_std, eps, *wb):
        gtf = _gtf_from_flat(wb)
        kernel = obs_mean.is_cuda and plain is not True
        fwd = bfvi_scan_fwd_cuda if kernel else bfvi_scan_fwd_ref
        outs = fwd(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps,
                   min_std, bf16=bf16)
        ctx.min_std = min_std
        ctx.bf16 = bf16
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
        d_om, d_os, d_gm, d_gs, d_gtf = bwd(res, cots, ctx.min_std,
                                            bf16=ctx.bf16)
        flat = []
        for name in GTF_LAYERS:
            flat += [d_gtf[name]["w"], d_gtf[name]["b"]]
        return ((None, None, None, d_om, d_os, None, d_gm, d_gs, None)
                + tuple(flat))


def bfvi_scan(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps,
              min_std, plain=False, bf16=False):
    """Differentiable fused filtering loop. Returns (prior_mean,
    prior_std, infer_mean, infer_std, samples), each (T, B, D).
    ``plain=True`` runs the plain versions on any device and
    ``plain="bwd"`` only the backward, to hold the kernels against them
    on the GPU. ``bf16``: the GTF products in bfloat16 (module
    docstring), through the kernels' bfloat16 variants on the GPU."""
    if plain not in (False, True, "bwd"):
        raise ValueError("plain must be False, True or 'bwd', got %r"
                         % (plain,))
    wb = []
    for name in GTF_LAYERS:
        wb += [gtf[name]["w"].contiguous(), gtf[name]["b"].contiguous()]
    return _BfviScan.apply(
        float(min_std), plain, bool(bf16), obs_mean.contiguous(),
        obs_std.contiguous(),
        obs_mask.to(torch.float32).contiguous(), glb_mean.contiguous(),
        glb_std.contiguous(), eps.contiguous(), *wb)
