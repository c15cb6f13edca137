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
- ``bfvi_scan_fwd_cuda`` / ``bfvi_scan_bwd_cuda``: launch the float32
  scan kernels on the route that ``f32_scan_plan`` chooses by shape before
  any launch: the column route (``csrc/f32_scan.cuh``: one CTA owns whole
  batch columns for the whole time loop, weights in shared memory, f32
  FMA, no grid barrier) for narrow transitions, counted in
  ``.launches_column``; the wgmma route (``csrc/f32_scan.cuh``: a
  cooperative grid, products on wgmma in 3xTF32 with the weights' TF32
  images of ``f32_pack`` fed by TMA) for every other shape,
  ``.launches_wgmma``. The tiled kernels (``csrc/bfvi_scan.cu``, products on
  the tile engine of ``csrc/tf32x3.cuh``), the route "tiled", run only
  where a caller names it (``route="tiled"``, ``f32_route``): the
  reference the new routes are timed against, ``.launches_tiled``;
  ``.launches`` counts all three. The backward writes, for every particle row
  of every step, the activations and cotangents that the weight gradients are
  products of, and ``gtf_wgrad_cuda`` (plain version ``gtf_wgrad_ref``) forms
  those products on the route that ``f32_wgrad_plan`` chooses by shape
  (``csrc/f32_wgrad.cuh``): "narrow" (D and H up to 32, at most
  ``WGRAD_NARROW_MAX_BLOCKS`` 4 x 4 blocks of outputs: one pass over the
  rows streamed by 1-D TMA, f32 FMA into 4 x 4 register blocks) or "wgmma"
  (every other shape: TMA-fed wgmma in 3xTF32, the B operand converted to
  K-major TF32 images in shared memory), counted in ``.launches_narrow``
  and ``.launches_wgmma``; the tile engine's kernel, the route "tiled"
  (``.launches_tiled``), runs where a caller names it (and under the
  backward scan's tiled route). With ``bf16=True`` the scan wrappers
  launch the kernels' bfloat16 variants instead (``csrc/bfvi_scan_bf16.cu``)
  on the route that ``bf16_scan_plan`` chooses by shape before any launch:
  the cluster route, the two scans of ``csrc/bf16_scan.cuh`` (one thread
  block cluster per group of batch columns, weights resident in shared
  memory as bfloat16, wgmma, no grid barrier) on the weight images of
  ``bf16_pack``, counted in ``.launches_bf16``; or, where no cluster plan
  fits (wide operands, K > 64 particles), the wgmma route,
  ``*_bf16_wgmma_kernel`` (``csrc/f32_scan.cuh``: the float32 wgmma
  route's grid and phases with bf16 ``wgmma`` products on the bfloat16
  weight images of ``bf16_wgmma_pack``), counted in
  ``.launches_bf16_wgmma``. The tiled bf16 kernels
  (``*_bf16_tiled_kernel``, ``csrc/bfvi_scan.cuh`` on the tile engine's
  bf16 route, ``csrc/tf32x3.cuh``), the route "tiled", run only where a
  caller names it (``route="tiled"`` with ``bf16``, ``bf16_route``): the
  twin that the wgmma route is timed against, ``.launches_bf16_tiled``.
  Every bf16 backward writes the weight gradients' rows in bfloat16 and
  the f32 sums of its cotangents for the bias gradients, from which
  ``gtf_wgrad_bf16_cuda`` (``csrc/wgrad_bf16.cuh``, TMA and wgmma; plain
  version ``gtf_wgrad_bf16_ref``) forms the weight gradients. The float32
  kernels read the GTF weights in PyTorch's layout; the wrapper joins
  gate_1, nonlin_1 and z_lin into one (2H + D, D) matrix and, where D or H
  is no multiple of 4 (the spirals model's D = 5), zero-pads every operand
  to the next multiple of 4 (of 16 on the bf16 routes) and slices the
  outputs back (``_check_sizes``). Every route takes any D and H and up to
  ``MAX_K`` particles.
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

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ...models.nn import (GTF_LAYERS, gtf_apply, gtf_apply_packed,
                          gtf_pack, linear_cd, round_to)
from . import _build

EPS = 1e-8
PREC_FLOOR = 1e-6
# The most particles the scan kernels take, on every route: the training
# step's filtering passes use 1 and 25 by default (``train_particles``), the
# MAP smoothing pass 1; the evaluation's 200-particle pass goes through the
# cell kernel (poe_cell.py). Nothing in the kernels is sized by K (the f32
# kernels and the bf16 wgmma and tiled routes walk a column's particles in
# chunks, the cluster route takes K <= 64); the limit is what the card
# tests check.
MAX_K = 256
# Partials of the bias gradients' sums that the bf16 wgmma and tiled
# backwards write (chunks of a step's rows; csrc/bfvi_scan.cuh,
# emit_bf16_rows).
BIAS_CHUNKS = 32


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
_LL = ctypes.c_longlong


def _lib(bf16=False):
    """The kernels' library: the float32 kernels, or with ``bf16`` their
    bfloat16 variants (``csrc/bfvi_scan_bf16.cu``), with the same C entry
    points."""
    lib = _build.load("bfvi_scan_bf16" if bf16 else "bfvi_scan")
    if not getattr(lib, "_bfvi_typed", False):
        # The bf16 scans take their weight images and launch plan after
        # the float32 kernels' arguments (csrc/bf16_scan.cuh).
        lib.bfvi_scan_fwd.argtypes = ([_P] * 22 + [_I] * 6
                                      + [ctypes.c_float, _P]
                                      + ([_P, _I, _P] if bf16 else []))
        lib.bfvi_scan_fwd.restype = _I
        lib.bfvi_scan_bwd.argtypes = ([_P] * 30 + [_I] * 6
                                      + [ctypes.c_float, _P]
                                      + ([_P, _I, _P, _I, _P] + [_P] * 5
                                         if bf16 else []))
        lib.bfvi_scan_bwd.restype = _I
        if bf16:
            lib.bfvi_scan_bf16_max_clusters.argtypes = [_I] * 3
            lib.bfvi_scan_bf16_max_clusters.restype = _I
            # The tiled route: the float32 kernels' arguments, then the
            # forward's rows; the backward's bf16 rows and bias partials.
            lib.bfvi_scan_fwd_tiled.argtypes = ([_P] * 22 + [_I] * 6
                                                + [ctypes.c_float, _P, _P])
            lib.bfvi_scan_fwd_tiled.restype = _I
            lib.bfvi_scan_bwd_tiled.argtypes = ([_P] * 30 + [_I] * 6
                                                + [ctypes.c_float, _P]
                                                + [_P] * 4 + [_I])
            lib.bfvi_scan_bwd_tiled.restype = _I
            lib.gtf_wgrad_bf16.argtypes = ([_P] * 4 + [_I, _P, _P]
                                           + [_I] * 3 + [_P])
            lib.gtf_wgrad_bf16.restype = _I
            lib.gtf_wgrad_bf16_partial_floats.argtypes = [_I] * 3
            lib.gtf_wgrad_bf16_partial_floats.restype = ctypes.c_longlong
        else:
            lib.gtf_wgrad.argtypes = [_P] * 4 + [_I] * 4 + [_P]
            lib.gtf_wgrad.restype = _I
        lib._bfvi_typed = True
    return lib


def _f32_lib():
    """The float32 scans' column and wgmma routes and the bf16 scans'
    wgmma route (``csrc/f32_scan.cu``): the C entry points of
    ``csrc/bfvi_scan.cu``'s scans with their routes' arguments after
    them."""
    lib = _build.load("f32_scan")
    if not getattr(lib, "_bfvi_typed", False):
        fwd, bwd = [_P] * 22 + [_I] * 6, [_P] * 30 + [_I] * 6
        tail = [ctypes.c_float, _P]
        lib.bfvi_scan_fwd_wgmma.argtypes = fwd + tail + [_P, _P, _LL]
        lib.bfvi_scan_bwd_wgmma.argtypes = bwd + tail + [_P, _LL, _P, _LL]
        lib.bfvi_scan_fwd_column.argtypes = fwd + tail + [_P, _I]
        lib.bfvi_scan_bwd_column.argtypes = bwd + tail + [_I]
        # The bf16 wgmma route (bf16_gtf): the rows, the bf16 rows and bias
        # partials as the tiled bf16 entries take them, then the images.
        lib.bfvi_scan_fwd_bf16_wgmma.argtypes = fwd + tail + [_P, _P, _LL]
        lib.bfvi_scan_bwd_bf16_wgmma.argtypes = (bwd + tail + [_P] * 4
                                                 + [_I, _P, _LL, _P, _LL])
        for fn in (lib.bfvi_scan_fwd_wgmma, lib.bfvi_scan_bwd_wgmma,
                   lib.bfvi_scan_fwd_column, lib.bfvi_scan_bwd_column,
                   lib.bfvi_scan_fwd_bf16_wgmma,
                   lib.bfvi_scan_bwd_bf16_wgmma):
            fn.restype = _I
        lib._bfvi_typed = True
    return lib


def _wgrad_lib():
    """The float32 weight gradients' narrow and wgmma routes
    (``csrc/f32_wgrad.cu``)."""
    lib = _build.load("f32_wgrad")
    if not getattr(lib, "_bfvi_typed", False):
        lib.gtf_wgrad_narrow.argtypes = [_P] * 4 + [_I] * 10 + [_P]
        lib.gtf_wgrad_wgmma.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.gtf_wgrad_narrow.restype = lib.gtf_wgrad_wgmma.restype = _I
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


def _check_sizes(k, d, h, bf16=False):
    """Raise unless 1 <= K <= MAX_K; return the widths (D', H') that the
    kernels run at: D and H rounded up to multiples of 4, for the 16-byte
    rows of their tile loads (``csrc/tf32x3.cuh``); with ``bf16`` to
    multiples of 16, the depth of one wgmma step (``csrc/bf16_scan.cuh``,
    ``csrc/wgrad_bf16.cuh``; the wgmma and tiled routes take them too). Every width
    has a bf16 route (``bf16_scan_plan``)."""
    if not 1 <= k <= MAX_K:
        raise ValueError("the scan kernels take 1 <= K <= %d particles, "
                         "got K = %d" % (MAX_K, k))
    if not bf16:
        return _padded(d), _padded(h)
    return _padded(d, 16), _padded(h, 16)


def _padded(n, m=4):
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# The bf16 scans' launch plan and weight images (csrc/bf16_scan.cuh)
# ---------------------------------------------------------------------------

# Dynamic shared memory a CTA may use on the H100 (232,448 bytes), less
# the kernels' static mbarrier and its alignment.
BF16_SMEM_LIMIT = 232448 - 64
BF16_SMS = 132        # the H100's SMs, for the plan's estimate of waves
BF16_SM_SMEM = 233472  # shared memory of an SM, 1 KB of it kept per CTA
TILE_ROWS = 64        # wgmma's M: a cluster's particle rows
MAX_CLUSTER = 8


def bf16_cluster(d, h):
    """CTAs a cluster at padded widths (D, H), multiples of 16: the most,
    up to 8, that cut both D and H into slices of a multiple of 8 columns
    (wgmma's N)."""
    return max(c for c in range(1, MAX_CLUSTER + 1)
               if (d // 8) % c == 0 and (h // 8) % c == 0)


def _nslab(k):
    return -(-k // 64)


def bf16_layout(backward, d, h, c, rb, resident):
    """``make_layout`` of csrc/bf16_scan.cuh: the weight matrices (rows,
    depth, byte offset), their bytes, and a CTA's shared-memory bytes."""
    ds, hs, la = d // c, h // c, 2 * h + d
    if backward:
        wn, wk, bk = (ds, ds, hs, hs), (la, d, d, d), (2 * d, d, la)
        if d <= h:  # [d_a2 | d_sraw] shares [d_a1 | d_b1 | d_zlin]'s columns
            bk = bk[1:]
        loc = rb * (ds * 6 + hs * 2)
    else:
        wn, wk, bk = (2 * hs + ds, ds, ds, ds), (d, h, h, d), (d, d, 2 * h)
        loc = 4 * rb * ds * 2
    offs, off = [], 0
    for n, k in zip(wn, wk):
        offs.append(off)
        off += _nslab(k) * n * 128
    wbytes = off
    # streamed: a slot of 64 weight rows (the widest chunk) a warpgroup
    total = (wbytes if resident else 2 * 64 * 128)
    total += sum(_nslab(k) * rb * 128 for k in bk)
    bias = 0 if backward else (2 * hs + 4 * ds) * 4
    total += (-(-loc // 1024) * 1024 + max(bias, (TILE_ROWS - rb) * 128)
              + 1024)
    return {"wn": wn, "wk": wk, "w": tuple(offs), "wbytes": wbytes,
            "total": total}


def bf16_smem(backward, d, h, c, rb, resident):
    """A CTA's shared-memory bytes (``smem_bytes`` of the kernels): the
    backward runs the forward's layout in its recompute."""
    f = bf16_layout(False, d, h, c, rb, resident)["total"]
    if not backward:
        return f
    return max(f, bf16_layout(True, d, h, c, rb, resident)["total"])


def _cluster_plan(k, b_dim, d, h, backward):
    """``bf16_scan_plan``'s cluster route in one direction, or None where
    not even one column fits."""
    c = bf16_cluster(d, h)
    most = min(TILE_ROWS // k, b_dim, max(1, 1024 // (d // c)))
    for resident in (True, False):
        for cols in range(most, 0, -1):
            rb = -(-cols * k // 8) * 8
            smem = bf16_smem(backward, d, h, c, rb, resident)
            if smem > BF16_SMEM_LIMIT:
                continue
            groups = -(-b_dim // cols)
            per_sm = BF16_SM_SMEM // (smem + 1024)
            at_once = max(1, BF16_SMS * per_sm // c)
            return {"route": "cluster", "cols": cols, "cluster": c,
                    "rows": rb, "resident": resident, "smem": smem,
                    "groups": groups, "ctas": groups * c,
                    "waves": -(-groups // at_once)}
    return None


def bf16_scan_plan(k, b_dim, d, h, backward=False):
    """The route and launch of a bf16 scan kernel at K particles,
    ``b_dim`` batch columns and padded widths (D, H), chosen by shape
    before any launch.

    ``route`` "cluster" (``csrc/bf16_scan.cuh``): clusters of ``cluster``
    CTAs, each over ``cols`` columns (``rows`` = cols K rounded up to 8, at
    most one 64-row wgmma tile), weights ``resident`` in shared memory
    where they fit, up to those that the 256 threads of the elementwise
    phase take in one pass (four d each: more would lengthen every step).
    ``smem`` is a CTA's dynamic shared memory, ``waves`` the rounds of
    clusters on 132 SMs (an estimate: the card's GPCs may hold fewer
    clusters at once). Taken where both directions have such a plan, so
    that the backward's recompute runs the forward's products.

    ``route`` "wgmma" (``csrc/f32_scan.cuh``, the bf16 engine): where
    either direction has none, as where a column's K particles exceed one
    64-row tile or the gathered full-width operands and weight slices
    exceed a CTA's shared memory (wide D or H, or widths that split into
    few CTAs). A cooperative grid of one CTA on each of the card's SMs
    (``ctas``, an estimate: the launch takes the card's own count),
    ``threads`` (two consumer warpgroups and a TMA producer warp), a ring
    of ``stages`` 64-deep bf16 weight stages in ``smem`` bytes; one wave.
    ``bias_chunks``: the partials of the bias gradients' sums that its
    backward writes.

    The plan never gives the route "tiled" (the tiled bf16 kernels on
    the tile engine): it runs where a caller names it (``_bf16_plan``'s
    ``route``)."""
    plans = [_cluster_plan(k, b_dim, d, h, bw) for bw in (False, True)]
    if None in plans:
        return _bf16_wgmma_plan()
    return plans[int(bool(backward))]


def _bf16_wgmma_plan():
    return dict(_wgmma_plan(), stages=BF16_WGMMA_STAGES,
                smem=BF16_WGMMA_SMEM, bias_chunks=BIAS_CHUNKS)


_FORCED_BF16_ROUTE = []


@contextlib.contextmanager
def bf16_route(route):
    """``f32_route`` for the bf16 scans: within the block, every bf16 scan
    that ``bfvi_scan`` starts takes ``route`` ("cluster", "wgmma" or
    "tiled") instead of the plan's, forward and backward alike."""
    if route not in BF16_ROUTES:
        raise ValueError("no bf16 scan route %r" % (route,))
    _FORCED_BF16_ROUTE.append(route)
    try:
        yield
    finally:
        _FORCED_BF16_ROUTE.pop()


def _bf16_plan(k, b_dim, d, h, backward, route=None):
    """``bf16_scan_plan``'s plan, or with ``route`` that route's plan at
    this shape: the cluster route where no cluster holds a column raises
    (the others take every shape)."""
    if route is None:
        return bf16_scan_plan(k, b_dim, d, h, backward)
    if route == "cluster":
        plans = [_cluster_plan(k, b_dim, d, h, bw) for bw in (False, True)]
        if None in plans:
            raise ValueError("the bf16 cluster route holds no column at "
                             "K = %d, D = %d, H = %d" % (k, d, h))
        return plans[int(bool(backward))]
    if route == "wgmma":
        return _bf16_wgmma_plan()
    if route == "tiled":
        return {"route": "tiled", "bias_chunks": BIAS_CHUNKS}
    raise ValueError("no bf16 scan route %r" % (route,))


def _swizzled(mats, fill):
    """(C, N, K) weight rows (or their indices) laid out as C images in the
    128-byte swizzle of csrc/bf16_scan.cuh: 64-deep slabs of N rows of 64
    values, the 8-value chunk j of row n at j ^ (n % 8); depth past K
    holds ``fill``."""
    c, n, k = mats.shape
    ns = _nslab(k)
    x = mats.new_full((c, n, ns * 64), fill)
    x[..., :k] = mats
    x = x.reshape(c, n, ns, 8, 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(n, device=mats.device)
    src = (torch.arange(8, device=mats.device)[None, :] ^ (rows[:, None] % 8))
    out = torch.gather(x, 3, src[None, None, :, :, None].expand(
        c, ns, n, 8, 8))
    return out.reshape(c, -1)


def _image_mats(w, d, h, backward):
    """The four (C, N, K) matrices of the images, from the six weights
    ``w`` (values or their indices) in PyTorch layout."""
    c = bf16_cluster(d, h)
    if backward:
        w1 = torch.cat([w["gate_1"], w["nonlin_1"], w["z_lin"]])
        mats = [w1.t(), w["z_to_std"].t(), w["gate_2"].t(),
                w["nonlin_2"].t()]
    else:
        mats = [torch.cat([w["gate_1"].reshape(c, h // c, d),
                           w["nonlin_1"].reshape(c, h // c, d),
                           w["z_lin"].reshape(c, d // c, d)], 1),
                w["gate_2"], w["nonlin_2"], w["z_to_std"]]
    return [m.reshape(c, -1, m.shape[-1]) for m in mats]


_PACK_INDEX = {}


def _pack_index(d, h, backward, device):
    """For each bf16 word of the images, its index in the six weights
    flattened in GTF_LAYERS order, or one past them (a zero); cached."""
    key = (d, h, bool(backward), str(device))
    if key not in _PACK_INDEX:
        shapes, w, n = _gtf_shapes(d, h), {}, 0
        for name in GTF_LAYERS:
            rows, cols = shapes[name]
            w[name] = torch.arange(n, n + rows * cols).reshape(rows, cols)
            n += rows * cols
        _PACK_INDEX[key] = torch.cat(
            [_swizzled(m, n) for m in _image_mats(w, d, h, backward)],
            1).to(device)
    return _PACK_INDEX[key]


def bf16_pack(gtf, d, h, backward=False):
    """The bf16 scan kernels' weights at padded widths (D, H): for each CTA
    rank j of a cluster, the bfloat16 image of its slices (int16 words),
    (C, bytes / 2). Forward: the rows of w1 = [gate_1; nonlin_1; z_lin]
    that give its H-slices of gate_1 and nonlin_1 and its D-slice of z_lin,
    then its D-slices of gate_2, nonlin_2 and z_to_std. Backward: the
    columns of the same matrices (the transposed weights' rows) for its
    output slices of the input-gradient products: w1's D-slice (2H + D
    deep), z_to_std's D-slice, gate_2's and nonlin_2's H-slices. Each value
    is the weight rounded to bfloat16, as ``nn.gtf_pack`` rounds it. One
    gather through a cached index, then the cast."""
    w = [gtf[n]["w"].detach().reshape(-1) for n in GTF_LAYERS]
    flat = torch.cat(w + [w[0].new_zeros(1)])
    idx = _pack_index(d, h, backward, flat.device)
    return flat[idx].to(torch.bfloat16).view(torch.int16)


class Bf16Pack:
    """The bf16 cluster route's weight images of one set of GTF weights at
    padded widths, the forward's made at once, the backward's at first
    use, so that an autograd call packs once and its backward reuses the
    pack."""

    def __init__(self, gtf, d, h):
        self.gtf, self.d, self.h = gtf, d, h
        self.images = {False: bf16_pack(gtf, d, h)}

    def image(self, backward):
        if backward not in self.images:
            self.images[backward] = bf16_pack(self.gtf, self.d, self.h,
                                              backward)
        return self.images[backward]


# ---------------------------------------------------------------------------
# The float32 scans' launch plan and weight images (csrc/f32_scan.cuh)
# ---------------------------------------------------------------------------

F32_SMS = 132            # the H100's SMs, for the plan's estimate of waves
F32_SMEM_LIMIT = 232448  # dynamic shared memory a CTA may use on the H100
F32_SM_SMEM = 233472     # shared memory of an SM, 1 KB of it kept per CTA
# The column route (csrc/f32_scan.cuh, kColThreads and its launch bounds):
# 128 threads a CTA, at most 4 CTAs an SM by registers; widths up to
# COLUMN_MAX_WIDTH. Its products are FMA chains, one thread an output, so
# a step's time grows with D H: on the H100 it is 3-4x faster than the
# tiled route at the spirals widths (D = 8, H = 20), level with the wgmma
# route at D = H = 32 and 2x slower at D = H = 64 (PERF.md, section 6;
# chip_smoke.py phase 16 (a') times the routes there and at D = 32, H =
# 256). The wgmma route beat the tiled one at every such shape.
COLUMN_THREADS = 128
COLUMN_CTAS_PER_SM = 4
COLUMN_MAX_WIDTH = 32
# The wgmma route (kWgThreads, kStages, kMaxBN, kImgRows): two consumer
# warpgroups and a producer warp, a ring of 8 stages of 64 weight rows hi
# and lo, and the elementwise phases' 3 KB; one CTA an SM.
WGMMA_THREADS = 288
WGMMA_STAGES = 8
IMG_ROWS = 64    # image rows are padded to the widest tile
WGMMA_SMEM = WGMMA_STAGES * 2 * IMG_ROWS * 128 + 3 * 2 * 128 * 4 + 1024
SLAB = 32        # depth of one 128-byte swizzled row
# The bf16 wgmma route (kBStages, kBSlab, kBImgRows, kBWgSmem): 5 stages
# of one 64-deep bf16 slab of 128 weight rows, 16 KB each, a warpgroup's
# two 8 KB stages of A in bf16 and three 16 KB slots of A in f32, then the
# elementwise phases' 3 KB; image rows padded to the widest tile, 128.
BF16_WGMMA_STAGES = 5
BF16_SLAB = 64
BF16_IMG_ROWS = 128
BF16_WGMMA_SMEM = (BF16_WGMMA_STAGES * 16384 + 4 * 8192 + 2 * 3 * 16384
                   + 3072 + 1024)
BF16_ROUTES = ("cluster", "wgmma", "tiled")


def column_smem(backward, rows, d, h):
    """A column CTA's dynamic shared-memory bytes for ``rows`` particle
    rows at padded widths (D, H) (``col_smem_bytes`` of the kernels): the
    GTF weights and biases, then per row the forward's z and work rows, or
    the backward walk's xs, ys and z cotangent."""
    la = 2 * h + d
    lw = la + 3 * d
    weights = la * d + la + 2 * (d * h + d) + d * d + d
    per_row = max(d + lw, la + lw + d) if backward else d + lw
    return 4 * (weights + rows * per_row)


def _column_plan(k, b_dim, d, h, backward, max_width=COLUMN_MAX_WIDTH):
    """The column route in one direction: the fewest columns a CTA that
    put every column in one wave of the card (or, where none does, the
    fewest waves), or None where the widths exceed ``max_width`` (None:
    no cap, for a named route) or not even one column fits a CTA's shared
    memory."""
    if max_width is not None and max(d, h) > max_width:
        return None
    best = None
    for cols in range(1, b_dim + 1):
        smem = column_smem(backward, cols * k, d, h)
        if smem > F32_SMEM_LIMIT:
            break
        per_sm = min(COLUMN_CTAS_PER_SM, F32_SM_SMEM // (smem + 1024))
        ctas = -(-b_dim // cols)
        plan = {"route": "column", "cols": cols, "rows": cols * k,
                "ctas": ctas, "threads": COLUMN_THREADS, "smem": smem,
                "waves": -(-ctas // (F32_SMS * per_sm))}
        if best is None or plan["waves"] < best["waves"]:
            best = plan
        if plan["waves"] == 1:
            break
    return best


def _wgmma_plan():
    return {"route": "wgmma", "ctas": F32_SMS, "threads": WGMMA_THREADS,
            "smem": WGMMA_SMEM, "stages": WGMMA_STAGES, "waves": 1}


def _tiled_plan():
    return {"route": "tiled", "waves": 1}


def f32_scan_plan(k, b_dim, d, h, backward=False):
    """The route and launch of a float32 scan kernel at K particles,
    ``b_dim`` batch columns and padded widths (D, H), chosen by shape
    before any launch.

    ``route`` "column" (``csrc/f32_scan.cuh``): CTAs of 128 threads, each
    owning ``cols`` whole columns (``rows`` = cols K particle rows) for the
    whole time loop, weights and activations in ``smem`` bytes of shared
    memory, no grid barrier; ``ctas`` CTAs in ``waves`` rounds of the card
    (at most 4 CTAs an SM). Taken where D and H are at most
    COLUMN_MAX_WIDTH (32) and both directions have such a plan, so that
    the backward's recompute runs the forward's products.

    ``route`` "wgmma" (``csrc/f32_scan.cuh``): a cooperative grid of one
    CTA on each of the card's SMs (``ctas``, an estimate: the launch takes
    the card's own count), ``threads`` (two consumer warpgroups and a TMA
    producer warp), a ring of ``stages`` weight stages in ``smem`` bytes;
    one wave by construction. Taken for every other shape: any D, H and
    K.

    The plan never gives the route "tiled" (the tile engine's kernels):
    it runs where a caller names it (``_f32_plan``'s ``route``)."""
    plans = [_column_plan(k, b_dim, d, h, bw) for bw in (False, True)]
    if None not in plans:
        return plans[int(bool(backward))]
    return _wgmma_plan()


_FORCED_ROUTE = []


@contextlib.contextmanager
def f32_route(route):
    """For tests and chip_smoke.py: within the block, every float32 scan
    that ``bfvi_scan`` (the autograd entry) starts takes ``route``
    ("column", "wgmma" or "tiled") instead of the plan's, forward and
    backward alike (the backward takes the route its forward took, inside
    the block or not). The wrappers themselves take a route only as their
    ``route`` argument."""
    if route not in ("column", "wgmma", "tiled"):
        raise ValueError("no float32 scan route %r" % (route,))
    _FORCED_ROUTE.append(route)
    try:
        yield
    finally:
        _FORCED_ROUTE.pop()


def _f32_plan(k, b_dim, d, h, backward, route=None):
    """``f32_scan_plan``'s plan, or with ``route`` that route's plan at
    this shape: a launch whose shape ``route`` does not take raises (the
    column route, at any width, where no CTA holds a column; the others
    take every shape)."""
    if route is None:
        return f32_scan_plan(k, b_dim, d, h, backward)
    if route == "column":
        plan = _column_plan(k, b_dim, d, h, backward, max_width=None)
        if plan is None:
            raise ValueError("the column route takes no column at K = %d, "
                             "D = %d, H = %d" % (k, d, h))
        return plan
    if route == "wgmma":
        return _wgmma_plan()
    if route == "tiled":
        return _tiled_plan()
    raise ValueError("no float32 scan route %r" % (route,))


def tf32_round(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f32_mats(w, backward):
    """The (N, K) matrices of one direction's image, from the six weights
    ``w`` (values or their indices) in PyTorch layout, in the kernels'
    order (f32scan::W1 ... ZL_T): the forward's products read w1 = [gate_1;
    nonlin_1; z_lin], gate_2, nonlin_2 and z_to_std as they are, the
    backward's the transposes of z_to_std, gate_2, nonlin_2, gate_1,
    nonlin_1 and z_lin."""
    if backward:
        return [w[n].t() for n in ("z_to_std", "gate_2", "nonlin_2",
                                   "gate_1", "nonlin_1", "z_lin")]
    return [torch.cat([w["gate_1"], w["nonlin_1"], w["z_lin"]]),
            w["gate_2"], w["nonlin_2"], w["z_to_std"]]


def _slab_order():
    """Position L of a 32-deep slab's row holds depth j(L): the wgmma step
    i = L // 8 reads column p = L % 8 of its 8-deep step, and the thread
    that holds column p and p + 4 of A loads 8 consecutive values of a row,
    so j = 8 (p % 4) + 2 i + p // 4."""
    pos = torch.arange(SLAB)
    i, p = pos // 8, pos % 8
    return 8 * (p % 4) + 2 * i + p // 4


def _swizzled_slabs(m, fill, order, row_pad, chunk):
    """One (N, K) matrix (or its indices) as a wgmma route's image: slabs
    of S = len(order) depths, ceil(K / S) of them, of N rows padded to
    ``row_pad``, each row's S values in ``order`` (position L holds depth
    order[L] of the slab) and its 16-byte chunks (``chunk`` values) in the
    128-byte swizzle (chunk c of row n at c ^ (n % 8)); ``fill`` past N
    and K."""
    n, k = m.shape
    slab = len(order)
    ns, npad = -(-k // slab), -(-n // row_pad) * row_pad
    full = m.new_full((npad, ns * slab), fill)
    full[:n, :k] = m
    kk = (slab * torch.arange(ns)[:, None] + order[None, :]).to(m.device)
    src = full[:, kk].permute(1, 0, 2)  # (slab, row, L)
    rows = torch.arange(npad, device=m.device)[:, None]
    phys = torch.arange(slab, device=m.device)[None, :]
    logical = ((phys // chunk) ^ (rows % 8)) * chunk + phys % chunk  # inverse
    return torch.gather(src, 2, logical[None].expand(ns, npad, slab)).reshape(-1)


def _f32_mat_image(m, fill):
    """The float32 wgmma route's image of one matrix: 32-deep slabs in
    ``_slab_order``, rows padded to IMG_ROWS, 4 floats a chunk."""
    return _swizzled_slabs(m, fill, _slab_order(), IMG_ROWS, 4)


_INDEX = {}


def _image_index(d, h, backward, device, mat_image):
    """For each value of one direction's image (``mat_image`` of each
    matrix of ``_f32_mats``), its index in the six weights flattened in
    GTF_LAYERS order, or one past them (a zero); cached."""
    key = (mat_image.__name__, d, h, bool(backward), str(device))
    if key not in _INDEX:
        shapes, w, n = _gtf_shapes(d, h), {}, 0
        for name in GTF_LAYERS:
            rows, cols = shapes[name]
            w[name] = torch.arange(n, n + rows * cols).reshape(rows, cols)
            n += rows * cols
        _INDEX[key] = torch.cat(
            [mat_image(m, n) for m in _f32_mats(w, backward)]).to(device)
    return _INDEX[key]


def f32_pack(gtf, d, h, backward=False):
    """The wgmma route's weight image of one direction at padded widths
    (D, H), float32: the TF32 high
    parts of every matrix of ``_f32_mats``, then their low parts, hi =
    tf32(w) and lo = tf32(w - hi), each matrix laid out by
    ``_f32_mat_image``. One gather through a cached index."""
    w = [gtf[n]["w"].detach().reshape(-1) for n in GTF_LAYERS]
    flat = torch.cat(w + [w[0].new_zeros(1)])
    vals = flat[_image_index(d, h, backward, flat.device, _f32_mat_image)]
    hi = tf32_round(vals)
    return torch.cat([hi, tf32_round(vals - hi)])


class F32Pack:
    """The wgmma route's images of one set of GTF weights at padded widths,
    the forward's made at once, the backward's at first use, so that an
    autograd call packs once and its backward reuses the pack."""

    def __init__(self, gtf, d, h):
        self.gtf, self.d, self.h = gtf, d, h
        self.images = {False: self._pack(gtf, d, h)}

    @staticmethod
    def _pack(*args):
        return f32_pack(*args)

    def image(self, backward):
        if backward not in self.images:
            self.images[backward] = self._pack(self.gtf, self.d, self.h,
                                               backward)
        return self.images[backward]


def _bf16_step_order():
    """Position p of a 64-deep bf16 slab's row holds depth j(p): the
    wgmma step i = p // 16 reads column w = p % 16 of its 16-deep step,
    and the thread q that holds columns 2q, 2q + 1 and 2q + 8, 2q + 9 of
    A loads the 4 consecutive depths 16 i + 4 q + (0..3) of a row, so
    j = 16 i + 4 ((w % 8) // 2) + 2 (w // 8) + w % 2: a permutation within
    each step's 16 depths."""
    pos = torch.arange(BF16_SLAB)
    i, w = pos // 16, pos % 16
    return 16 * i + 4 * ((w % 8) // 2) + 2 * (w // 8) + w % 2


def _bf16_mat_image(m, fill):
    """The bf16 wgmma route's image of one matrix: 64-deep slabs in
    ``_bf16_step_order``, rows padded to BF16_IMG_ROWS, 8 bf16 values a
    chunk."""
    return _swizzled_slabs(m, fill, _bf16_step_order(), BF16_IMG_ROWS, 8)


def bf16_wgmma_pack(gtf, d, h, backward=False):
    """The bf16 wgmma route's weight image of one direction at padded
    widths (D, H), multiples of 16: the matrices of ``_f32_mats`` (the
    forward's W as it is, (out, in); the backward's the transposes), each
    laid out by ``_bf16_mat_image``, every value the weight rounded to
    bfloat16 as ``nn.gtf_pack`` rounds it (int16 words). One gather
    through a cached index, then the cast."""
    w = [gtf[n]["w"].detach().reshape(-1) for n in GTF_LAYERS]
    flat = torch.cat(w + [w[0].new_zeros(1)])
    idx = _image_index(d, h, backward, flat.device, _bf16_mat_image)
    return flat[idx].to(torch.bfloat16).view(torch.int16)


class Bf16WgPack(F32Pack):
    """The bf16 wgmma route's images (``bf16_wgmma_pack``) of one set of
    GTF weights, packed as ``F32Pack`` packs: one pack an autograd
    call."""

    @staticmethod
    def _pack(*args):
        return bf16_wgmma_pack(*args)


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
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _plan_args(plan):
    """The C array of a cluster-route launch's plan: [columns a cluster,
    CTAs a cluster, rows a tile, resident, shared-memory bytes]."""
    return (ctypes.c_int * 5)(plan["cols"], plan["cluster"], plan["rows"],
                              int(plan["resident"]), plan["smem"])


def _images(pack, gtf, d, h, cls=None):
    """``pack`` (a ``Bf16Pack``, or ``cls``, of ``gtf`` at widths (D, H)),
    or one made here."""
    cls = Bf16Pack if cls is None else cls
    if pack is None:
        return cls(gtf, d, h)
    if type(pack) is not cls or (pack.d, pack.h) != (d, h):
        raise ValueError("the pack is a %s at widths (%d, %d), the launch "
                         "needs a %s at (%d, %d)" % (type(pack).__name__,
                                                     pack.d, pack.h,
                                                     cls.__name__, d, h))
    return pack


def _image_args(pack, backward):
    img = pack.image(backward)
    return [ctypes.c_void_p(img.data_ptr()), img.shape[1] * 2]


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


# A scan wrapper's launch counter by (bf16, route): the float32 scan's
# three routes (``f32_scan_plan``) and the bf16 scan's three
# (``bf16_scan_plan``). ``.launches`` counts the float32 scan on any route.
_COUNTERS = {(False, "column"): "launches_column",
             (False, "wgmma"): "launches_wgmma",
             (False, "tiled"): "launches_tiled",
             (True, "cluster"): "launches_bf16",
             (True, "wgmma"): "launches_bf16_wgmma",
             (True, "tiled"): "launches_bf16_tiled"}


def _count(wrapper, bf16, route):
    """One launch of ``wrapper``'s kernel, on its route's counter (and on
    ``.launches`` for the float32 routes)."""
    name = _COUNTERS[(bool(bf16), route)]
    setattr(wrapper, name, getattr(wrapper, name) + 1)
    if not bf16:
        wrapper.launches += 1


def _route(k, b_dim, dp, hp, bf16, backward, route=None):
    """(route, plan) of a scan launch: the bf16 plan's, or the float32
    plan's (``route``: the route of either named by the caller)."""
    plan = (_bf16_plan(k, b_dim, dp, hp, backward, route) if bf16
            else _f32_plan(k, b_dim, dp, hp, backward, route))
    return plan["route"], plan


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (what, rc))


def bfvi_scan_fwd_cuda(obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf,
                       eps, min_std, bf16=False, *, pack=None, route=None):
    """Launch the forward kernel on the route of ``f32_scan_plan`` (with
    ``bf16`` its bfloat16 variant on the route of ``bf16_scan_plan``) on
    the current stream, at widths padded to multiples of 4 (16 with
    ``bf16``, ``_check_sizes``); same outputs as ``bfvi_scan_fwd_ref``.
    ``pack``: the weight images of ``gtf`` at the padded widths, a
    ``Bf16Pack`` for the bf16 cluster route, a ``Bf16WgPack`` for the bf16
    wgmma route or an ``F32Pack`` for the float32 wgmma route, made here
    if None. ``route``: a route in place of the plan's (float32: "column",
    "wgmma" or "tiled"; with ``bf16``: "cluster", "wgmma" or "tiled"), to
    time or test one route beside another."""
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    dp, hp = _check_sizes(k, d, h, bf16)
    route, plan = _route(k, b_dim, dp, hp, bf16, False, route)
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    outs = [torch.empty((t_max, b_dim, dp), **opts) for _ in range(5)]
    outs.append(torch.empty((t_max, k, b_dim, dp), **opts))
    x, gtf, eps = _pad_scan_inputs(obs_mean, obs_std, obs_mask, glb_mean,
                                  glb_std, gtf, eps, dp, hp)
    args = x + _kernel_weights(gtf) + [eps] + outs
    dims = (t_max, n_exp, b_dim, k, dp, hp, float(min_std),
            _stream(obs_mean))
    # (getattr: a caller may stand a recording wrapper in for this one)
    keep = getattr(bfvi_scan_fwd_cuda, "rows", None)
    if not bf16 and route == "tiled":
        keep = None  # the float32 tiled kernel writes no rows
    rows = None
    if keep is not None:
        rows = torch.empty(((t_max - 1) * k * b_dim, 2 * hp + dp), **opts)
    work = None
    if route in ("tiled", "wgmma"):
        work = [torch.empty((k * b_dim, 2 * hp + 4 * dp), **opts),
                _barrier(obs_mean.device)]
    if bf16 and route == "cluster":
        pack = _images(pack, gtf, dp, hp)
        rc = _lib(True).bfvi_scan_fwd(
            *[_ptr(v) for v in args + [rows, None]], *dims,
            *_image_args(pack, False), _plan_args(plan))
    elif bf16 and route == "wgmma":
        img = _images(pack, gtf, dp, hp, Bf16WgPack).image(False)
        rc = _f32_lib().bfvi_scan_fwd_bf16_wgmma(
            *[_ptr(v) for v in args + work], *dims, _ptr(rows), _ptr(img),
            img.numel())
    elif bf16:
        rc = _lib(True).bfvi_scan_fwd_tiled(
            *[_ptr(v) for v in args + work], *dims, _ptr(rows))
    elif route == "wgmma":
        img = _images(pack, gtf, dp, hp, F32Pack).image(False)
        rc = _f32_lib().bfvi_scan_fwd_wgmma(
            *[_ptr(v) for v in args + work], *dims, _ptr(rows), _ptr(img),
            img.numel())
    elif route == "column":
        rc = _f32_lib().bfvi_scan_fwd_column(
            *[_ptr(v) for v in args + [None, None]], *dims, _ptr(rows),
            plan["cols"])
    else:
        rc = _lib().bfvi_scan_fwd(*[_ptr(v) for v in args + work], *dims)
    _raise_on(rc, "bfvi_scan_fwd (%s%s)" % ("bf16 " if bf16 else "", route))
    _count(bfvi_scan_fwd_cuda, bf16, route)
    if rows is not None:
        rows = _unpad_blocks(rows, (h, h, d), (hp, hp, dp))
        keep.append(_rb(rows) if bf16 else rows)
    if dp != d:
        outs = [o[..., :d].contiguous() for o in outs]
    return tuple(outs)


for _name in ("launches",) + tuple(_COUNTERS.values()):
    setattr(bfvi_scan_fwd_cuda, _name, 0)
# A list to which each launch on the bf16 routes and the float32 column and
# wgmma routes appends the rows [h1 | hn | z_nonlin] of its own transition
# (laid out as the backward's xs, at the real widths; on the bf16 routes
# rounded to bfloat16), or None: the backward's recompute must give the
# same rows bit for bit.
bfvi_scan_fwd_cuda.rows = None


def partial_size(d, h):
    """Floats in one weight-gradient partial: dW1 (D x (2H+D)), db1,
    dWg2, dbg2, dWn2, dbn2, dWs, dbs."""
    la = 2 * h + d
    return d * la + la + 2 * (h * d + d) + d * d + d


def bfvi_scan_bwd_cuda(res, cots, min_std, bf16=False, *, pack=None,
                       route=None):
    """Launch the backward scan kernel on the route of ``f32_scan_plan`` on
    the current stream, then the weight-gradient kernel on the rows it
    wrote (with ``bf16`` the
    bfloat16 variants: the scan on the route of ``bf16_scan_plan``, which
    writes its rows in bfloat16 and the bias gradients' f32 sums, and
    ``gtf_wgrad_bf16_cuda``'s kernel), at widths padded to multiples of 4
    (16 with ``bf16``); same outputs as ``bfvi_scan_bwd_ref``. ``pack`` and
    ``route`` as in ``bfvi_scan_fwd_cuda``; the float32 weight gradients
    take ``f32_wgrad_plan``'s route, or the tiled kernel with
    ``route="tiled"``."""
    (obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps, z_traj,
     prior_mean, prior_std) = res
    t_max, n_exp, b_dim, k, d, h = _check_inputs(
        obs_mean, obs_std, obs_mask, glb_mean, glb_std, gtf, eps)
    dp, hp = _check_sizes(k, d, h, bf16)
    route, plan = _route(k, b_dim, dp, hp, bf16, True, route)
    _check_tensor("z_traj", z_traj, (t_max, k, b_dim, d))
    for name, x in zip(("prior_mean", "prior_std", "g_prior_mean",
                        "g_prior_std", "g_infer_mean", "g_infer_std",
                        "g_samples"), (prior_mean, prior_std) + tuple(cots)):
        _check_tensor(name, x, (t_max, b_dim, d))
    dev = obs_mean.device
    opts = dict(dtype=torch.float32, device=dev)
    d_obs_mean = torch.empty((t_max, n_exp, b_dim, dp), **opts)
    d_obs_std = torch.empty((t_max, n_exp, b_dim, dp), **opts)
    d_glb_mean = torch.zeros((b_dim, dp), **opts)
    d_glb_std = torch.zeros((b_dim, dp), **opts)
    n_rows = (t_max - 1) * k * b_dim
    lx, ly = 2 * hp + dp, 2 * hp + 4 * dp
    # float32 rows: the kernels' own (the cluster route keeps only ys's
    # pre-activations there and writes no xs)
    xs = torch.empty((0 if route == "cluster" else n_rows, lx), **opts)
    ys = torch.empty((n_rows, ly), **opts)
    res, cots = _pad_bwd_inputs(res, cots, dp, hp)
    z_traj = res[7]
    args = (list(res[:5]) + _kernel_weights(res[5]) + list(res[6:])
            + list(cots) + [d_obs_mean, d_obs_std, d_glb_mean, d_glb_std,
                            xs, ys])
    dims = (t_max, n_exp, b_dim, k, dp, hp, float(min_std), _stream(xs))
    if bf16:  # the weight gradients' rows, and the bias gradients' sums
        bfo = dict(dtype=torch.bfloat16, device=dev)
        rows = [torch.empty((n_rows, w), **bfo) for w in (dp, lx, ly)]
        n_bp = plan["groups"] if route == "cluster" else plan["bias_chunks"]
        bias_part = torch.zeros((n_bp, ly), **opts)
    if bf16 and route == "cluster":
        pack = _images(pack, res[5], dp, hp)
        ds, hs = dp // plan["cluster"], hp // plan["cluster"]
        bacc = torch.empty((plan["ctas"], plan["rows"] * (2 * hs + ds)
                            + plan["cols"] * 3 * ds), **opts)
        rc = _lib(True).bfvi_scan_bwd(
            *[_ptr(v) for v in args + [None, None]], *dims,
            *_image_args(pack, True), *_image_args(pack, False),
            _plan_args(plan), *[_ptr(v) for v in (rows[1], rows[2], rows[0],
                                                  bacc, bias_part)])
    elif route == "column":
        rc = _f32_lib().bfvi_scan_bwd_column(
            *[_ptr(v) for v in args + [None, None]], *dims, plan["cols"])
    else:
        gz = torch.zeros((3, k * b_dim, dp), **opts)
        tail = []
        if bf16:
            tail = [_ptr(v) for v in (rows[1], rows[2], rows[0], bias_part)]
            tail.append(n_bp)
            if route == "wgmma":
                pack = _images(pack, res[5], dp, hp, Bf16WgPack)
                tail += [_ptr(pack.image(False)), pack.image(False).numel(),
                         _ptr(pack.image(True)), pack.image(True).numel()]
                fn = _f32_lib().bfvi_scan_bwd_bf16_wgmma
            else:
                fn = _lib(True).bfvi_scan_bwd_tiled
        elif route == "wgmma":
            pack = _images(pack, res[5], dp, hp, F32Pack)
            tail = [_ptr(pack.image(False)), pack.image(False).numel(),
                    _ptr(pack.image(True)), pack.image(True).numel()]
            fn = _f32_lib().bfvi_scan_bwd_wgmma
        else:
            fn = _lib().bfvi_scan_bwd
        rc = fn(*[_ptr(v) for v in args + [gz, _barrier(dev)]], *dims,
                *tail)
    _raise_on(rc, "bfvi_scan_bwd (%s%s)" % ("bf16 " if bf16 else "", route))
    _count(bfvi_scan_bwd_cuda, bf16, route)
    if bfvi_scan_bwd_cuda.rows is not None:
        bfvi_scan_bwd_cuda.rows.append(_unpad_blocks(
            rows[1].to(torch.float32) if bf16 else xs, (h, h, d),
            (hp, hp, dp)))
    if bf16:
        d_gtf = _gtf_wgrad_bf16_launch(*rows, bias_part, dp, hp)
    else:
        # the tiled weight-gradient kernel where the tiled scan is named
        d_gtf = _gtf_wgrad_launch(z_traj, xs, ys, n_rows, dp, hp,
                                  "tiled" if route == "tiled" else None)
    outs = (d_obs_mean, d_obs_std, d_glb_mean, d_glb_std)
    if dp != d:
        outs = tuple(o[..., :d].contiguous() for o in outs)
    if (dp, hp) != (d, h):
        d_gtf = _unpad_gtf(d_gtf, d, h)
    return outs + (d_gtf,)


for _name in ("launches",) + tuple(_COUNTERS.values()):
    setattr(bfvi_scan_bwd_cuda, _name, 0)
# A list to which each launch (of any route) appends the xs rows it wrote
# (the float32 kernel's, the bf16 routes' bfloat16 rows as float32), at the
# real widths, or None: their h1 and hn hold the kernel's ReLU masks, for
# bfvi_scan_bwd_ref_on_masks (a positive float32 value stays positive in
# bfloat16, which has float32's exponent range).
bfvi_scan_bwd_cuda.rows = None


# The float32 weight gradients' routes, chosen by ``f32_wgrad_plan`` from
# the padded widths before the launch (csrc/f32_wgrad.cuh): "narrow" and
# "wgmma". The tiled gtf_wgrad_kernel (csrc/bfvi_scan.cu, the tile engine's
# 128 x 64 tiles on mma.sync), the route "tiled", is planned for no shape:
# it runs where a caller names it (``route="tiled"``; the backward scan's
# ``route="tiled"``, and so ``f32_route("tiled")``), the twin that the new
# routes are timed against. Its CTAs: the output tiles times the row ranges
# it splits the rows into, each with its own partial; 528 CTAs are two full
# waves of two CTAs on each of the H100's 132 SMs.
WGRAD_CTAS = 528
WGRAD_TILE = (128, 64)
# The narrow route (kNarrowThreads, kNarrowStages): CTAs of at most 512
# threads, each thread one 4 x 4 block of outputs (``narrow_blocks``), a
# ring of three stages of rows of at most 32 KB (and 64 rows), two CTAs an
# SM. The plan takes it where D and H are at most WGRAD_NARROW_MAX_WIDTH
# and its blocks number at most WGRAD_NARROW_MAX_BLOCKS: on the H100, at
# 60,000 rows (K = 25, 100 columns), its time grows with its blocks while
# the wgmma route's stays at about 0.045 ms, and the two cross between 296
# blocks (D = 32, H = 16: narrow 9 % ahead) and 304 (D = 24, H = 32: wgmma
# 3 % ahead); at D = H = 28 and 32 (336 and 432 blocks) wgmma is 7-10 %
# ahead, at D = 8, H = 32 (96 blocks) narrow 1.7x (PERF.md, chip_smoke.py
# phase 16 (a')).
WGRAD_NARROW_MAX_WIDTH = 32
WGRAD_NARROW_MAX_BLOCKS = 296
WGRAD_NARROW_THREADS = 512
WGRAD_NARROW_RING = 3
WGRAD_NARROW_STAGE_BYTES = 32768
WGRAD_NARROW_MAX_ROWS = 64
WGRAD_NARROW_MAX_GROUPS = 8
WGRAD_NARROW_CTAS_PER_SM = 2
# The wgmma route (kWgThreads, kWgRows, kWgStages, kWgSmem, kUnitRows): two
# warpgroups, 32-row stages (one TF32 slab), a ring of four stages of eight
# 4 KB boxes and two B images of 32 KB (hi and lo), one CTA an SM; units of
# 128 output rows by a tile of up to 128 columns, times the row splits of
# at most two waves.
WGRAD_WGMMA_THREADS = 256
WGRAD_WGMMA_ROWS = 32
WGRAD_WGMMA_RING = 4
WGRAD_WGMMA_SMEM = WGRAD_WGMMA_RING * 8 * 4096 + 4 * 128 * 128 + 1024
WGRAD_UNIT_ROWS = 128
WGRAD_MAX_WAVES = 2
WGRAD_ROUTES = ("narrow", "wgmma", "tiled")


def wgrad_splits(d, h):
    """The row ranges of the tiled weight-gradient kernel at widths
    (D, H)."""
    la = 2 * h + d
    tiles = sum(-(-m // WGRAD_TILE[0]) * -(-n // WGRAD_TILE[1])
                for m, n in ((d, la), (h, d), (h, d), (d, d)))
    return -(-WGRAD_CTAS // tiles)


def narrow_blocks(d, h):
    """The narrow route's blocks at padded widths (D, H): the 4 x 4 blocks
    of dW1 (D x (2H + D)), dWg2 and dWn2 (H x D) and dWs (D x D), then the
    2H + 4D bias sums in blocks of 4 (``narrow_blocks`` of the kernel)."""
    la = 2 * h + d
    return ((d // 4) * (la // 4) + 2 * (h // 4) * (d // 4) + (d // 4) ** 2
            + (la + 3 * d) // 4)


def _narrow_wgrad_plan(d, h, n_rows):
    """The narrow route at padded widths (D, H) over ``n_rows`` rows, or
    None where three stages of one row each exceed a CTA's shared memory."""
    la = 2 * h + d
    row_bytes = 4 * (d + la + la + 3 * d)
    rows = max(1, min(WGRAD_NARROW_MAX_ROWS,
                      WGRAD_NARROW_STAGE_BYTES // row_bytes))
    blocks = narrow_blocks(d, h)
    chunks = -(-blocks // WGRAD_NARROW_THREADS)
    per_chunk = -(-blocks // chunks)
    groups = max(1, min(WGRAD_NARROW_MAX_GROUPS,
                        WGRAD_NARROW_THREADS // per_chunk))
    threads = 32 * -(-per_chunk * groups // 32)
    smem = max(WGRAD_NARROW_RING * rows * row_bytes, 64 * threads)
    if smem > F32_SMEM_LIMIT:
        return None
    per_sm = min(WGRAD_NARROW_CTAS_PER_SM, F32_SM_SMEM // (smem + 1024))
    stages = -(-n_rows // rows)
    splits = max(1, min(stages, F32_SMS * per_sm // chunks))
    return {"route": "narrow", "rows": rows, "stages": stages,
            "splits": splits, "chunks": chunks, "per_chunk": per_chunk,
            "groups": groups, "threads": threads, "smem": smem,
            "ctas": chunks * splits,
            "waves": -(-chunks * splits // (F32_SMS * per_sm))}


def _tile_width(n):
    return 32 if n <= 32 else 64 if n <= 64 else 128


def _wgmma_jobs(d, h):
    """(M, N) of the wgmma route's four products at padded widths (D, H):
    M the gradient's out side (the cotangent columns), N its in side."""
    la = 2 * h + d
    return ((la, d), (d, h), (d, h), (d, d))


def _wgmma_wgrad_plan(d, h, n_rows):
    """The wgmma route at padded widths (D, H) over ``n_rows`` rows: units
    of 128 output rows by a tile of 32, 64 or 128 columns, times the row
    splits whose waves (one CTA an SM) leave the fewest SMs idle, at most
    WGRAD_MAX_WAVES waves (fewest splits on a tie)."""
    units = sum(-(-m // WGRAD_UNIT_ROWS) * -(-n // _tile_width(n))
                for m, n in _wgmma_jobs(d, h))
    stages = -(-n_rows // WGRAD_WGMMA_ROWS)
    most = max(1, min(max(stages, 1), WGRAD_MAX_WAVES * F32_SMS // units))
    best = 1
    for s in range(2, most + 1):
        # waves / splits, compared without rounding
        if -(-units * s // F32_SMS) * best < -(-units * best // F32_SMS) * s:
            best = s
    return {"route": "wgmma", "units": units, "rows": WGRAD_WGMMA_ROWS,
            "stages": stages, "splits": best, "ctas": units * best,
            "threads": WGRAD_WGMMA_THREADS, "smem": WGRAD_WGMMA_SMEM,
            "waves": -(-units * best // F32_SMS)}


def f32_wgrad_plan(d, h, n_rows):
    """The route and launch of the float32 weight gradients over
    ``n_rows`` rows at padded widths (D, H), chosen by shape before the
    launch; ``splits`` partials of ``partial_size(d, h)`` floats, which the
    wrapper sums in order.

    ``route`` "narrow" (``csrc/f32_wgrad.cuh``): ``ctas`` CTAs of
    ``threads``, ``chunks`` per row range (one where D, H are narrow)
    times ``splits`` contiguous ranges of ``stages`` of ``rows`` rows each,
    in one wave of two CTAs an SM; each thread one 4 x 4 block of outputs,
    ``groups`` threads a block, each taking every ``groups``-th row of a
    stage; ``smem`` bytes of shared memory. Taken where D and H are at most
    WGRAD_NARROW_MAX_WIDTH and ``narrow_blocks`` at most
    WGRAD_NARROW_MAX_BLOCKS.

    ``route`` "wgmma" (``csrc/f32_wgrad.cuh``): ``units`` (two 64-row
    wgmma tiles of one product) times ``splits`` row ranges of 32-row
    stages, one CTA of ``threads`` (two warpgroups) an SM, in ``waves``
    waves. Taken for every other shape.

    The plan never gives the route "tiled" (the tile engine's kernel): it runs where
    a caller names it (``_f32_wgrad_plan``'s ``route``)."""
    if (max(d, h) <= WGRAD_NARROW_MAX_WIDTH
            and narrow_blocks(d, h) <= WGRAD_NARROW_MAX_BLOCKS):
        plan = _narrow_wgrad_plan(d, h, n_rows)
        if plan is not None:
            return plan
    return _wgmma_wgrad_plan(d, h, n_rows)


def _f32_wgrad_plan(d, h, n_rows, route=None):
    """``f32_wgrad_plan``'s plan, or with ``route`` that route's plan: the
    narrow route at a width whose stages no CTA holds raises."""
    if route is None:
        return f32_wgrad_plan(d, h, n_rows)
    if route == "narrow":
        plan = _narrow_wgrad_plan(d, h, n_rows)
        if plan is None:
            raise ValueError("the narrow weight-gradient route takes no "
                             "stage at D = %d, H = %d" % (d, h))
        return plan
    if route == "wgmma":
        return _wgmma_wgrad_plan(d, h, n_rows)
    if route == "tiled":
        return {"route": "tiled", "splits": wgrad_splits(d, h)}
    raise ValueError("no float32 weight-gradient route %r" % (route,))


def _wgrad_dims(z_traj, xs):
    t_max, k, b_dim, d = z_traj.shape
    return (t_max - 1) * k * b_dim, d, (xs.shape[1] - d) // 2


def _wgrad_grads(dw1, db1, dwg2, dbg2, dwn2, dbn2, dws, dbs, h):
    return {
        "gate_1": {"w": dw1[:h], "b": db1[:h]},
        "nonlin_1": {"w": dw1[h:2 * h], "b": db1[h:2 * h]},
        "z_lin": {"w": dw1[2 * h:], "b": db1[2 * h:]},
        "gate_2": {"w": dwg2, "b": dbg2},
        "nonlin_2": {"w": dwn2, "b": dbn2},
        "z_to_std": {"w": dws, "b": dbs},
    }


def gtf_wgrad_ref(z_traj, xs, ys, bf16=False):
    """Plain version of ``gtf_wgrad_cuda``: the GTF weight gradients, in
    PyTorch layout, as products over the backward's rows. Row
    ((t-1) K + k) B + b of xs = [h1 | hn | z_nonlin] and of ys = [d_a1 |
    d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw] belong to particle k of
    column b at step t >= 1, whose input z_traj[t-1, k, b] is the same
    row of z_traj. ``bf16``: the weight gradients are products of the
    bfloat16-rounded rows (summed in float32); the bias gradients sum the
    float32 cotangents (``gtf_wgrad_bf16_ref`` takes the same rows in the
    bf16 kernel's form)."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    z = z_traj.reshape(-1, d)[:n_rows]
    y1, d_a2, d_znon, d_sraw = torch.split(ys, [2 * h + d, d, d, d], dim=1)
    h1, hn, z_non = torch.split(xs, [h, h, d], dim=1)
    r = _rb if bf16 else (lambda x: x)
    return _wgrad_grads(r(y1).t() @ r(z), y1.sum(0),
                        r(d_a2).t() @ r(h1), d_a2.sum(0),
                        r(d_znon).t() @ r(hn), d_znon.sum(0),
                        r(d_sraw).t() @ r(z_non), d_sraw.sum(0), h)


def gtf_wgrad_bf16_ref(zs, xs, ys, bias_part):
    """Plain version of ``gtf_wgrad_bf16_cuda``: ``gtf_wgrad_ref(...,
    bf16=True)`` on the rows in the form that the bf16 backward scans write
    them. zs (R, D), xs (R, 2H + D) and ys (R, 2H + 4D) in bfloat16, the
    rounded rows; ``bias_part`` (P, 2H + 4D) float32, P partials of the
    float32 cotangents' sums, which the bias gradients add in order. The
    products are those of ``gtf_wgrad_ref`` on the same values."""
    d = zs.shape[1]
    h = (xs.shape[1] - d) // 2
    f = lambda x: x.to(torch.float32)  # noqa: E731
    y1, d_a2, d_znon, d_sraw = (f(b) for b in torch.split(
        ys, [2 * h + d, d, d, d], dim=1))
    h1, hn, z_non = (f(b) for b in torch.split(xs, [h, h, d], dim=1))
    db1, dbg2, dbn2, dbs = torch.split(bias_part.sum(0),
                                       [2 * h + d, d, d, d])
    return _wgrad_grads(y1.t() @ f(zs), db1, d_a2.t() @ h1, dbg2,
                        d_znon.t() @ hn, dbn2, d_sraw.t() @ z_non, dbs, h)


def _gtf_wgrad_launch(z_traj, xs, ys, n_rows, d, h, route=None):
    """Launch the float32 weight-gradient kernel of ``route`` (by default
    ``f32_wgrad_plan``'s) on rows at widths (D, H) that are multiples of 4
    and sum its partials in a fixed order."""
    plan = _f32_wgrad_plan(d, h, n_rows, route)
    route = plan["route"]
    partial = torch.empty((plan["splits"], partial_size(d, h)),
                          dtype=torch.float32, device=xs.device)
    if route == "tiled":
        rc = _lib().gtf_wgrad(_ptr(z_traj), _ptr(xs), _ptr(ys), _ptr(partial),
                              plan["splits"], n_rows, d, h, _stream(xs))
    elif n_rows == 0:  # nothing to launch: the sums are 0
        return unpack_partial(partial.zero_().sum(0), d, h)
    elif route == "narrow":
        rc = _wgrad_lib().gtf_wgrad_narrow(
            _ptr(z_traj), _ptr(xs), _ptr(ys), _ptr(partial), n_rows, d, h,
            *[plan[k] for k in ("rows", "splits", "chunks", "per_chunk",
                                "groups", "threads", "smem")], _stream(xs))
    else:
        rc = _wgrad_lib().gtf_wgrad_wgmma(
            _ptr(z_traj), _ptr(xs), _ptr(ys), _ptr(partial), n_rows, d, h,
            plan["units"], plan["splits"], _stream(xs))
    _raise_on(rc, "gtf_wgrad (%s)" % route)
    gtf_wgrad_cuda.launches += 1
    name = "launches_" + route
    setattr(gtf_wgrad_cuda, name, getattr(gtf_wgrad_cuda, name) + 1)
    return unpack_partial(partial.sum(0), d, h)


def gtf_wgrad_cuda(z_traj, xs, ys, route=None):
    """Launch the float32 weight-gradient kernel on the current stream, on
    the route of ``f32_wgrad_plan`` (or ``route``: "narrow", "wgmma" or
    "tiled"), at widths padded to multiples of 4; same outputs as
    ``gtf_wgrad_ref``."""
    n_rows, d, h = _wgrad_dims(z_traj, xs)
    _check_tensor("z_traj", z_traj, tuple(z_traj.shape))
    _check_tensor("xs", xs, (n_rows, 2 * h + d))
    _check_tensor("ys", ys, (n_rows, 2 * h + 4 * d))
    dp, hp = _padded(d), _padded(h)
    grads = _gtf_wgrad_launch(
        _pad_last(z_traj, dp), _pad_blocks(xs, (h, h, d), (hp, hp, dp)),
        _pad_blocks(ys, (h, h) + (d,) * 4, (hp, hp) + (dp,) * 4), n_rows,
        dp, hp, route)
    return grads if (dp, hp) == (d, h) else _unpad_gtf(grads, d, h)


# ``.launches`` counts the float32 weight gradients on every route, and
# ``.launches_<route>`` each route's own.
for _name in ("launches",) + tuple("launches_" + r for r in WGRAD_ROUTES):
    setattr(gtf_wgrad_cuda, _name, 0)


def unpack_partial(tot, d, h):
    """Split a summed partial into PyTorch-layout GTF gradients."""
    la = 2 * h + d
    sizes = [d * la, la, h * d, d, h * d, d, d * d, d]
    dw1, db1, dwg2, dbg2, dwn2, dbn2, dws, dbs = torch.split(tot, sizes)
    return _wgrad_grads(dw1.reshape(d, la).t(), db1, dwg2.reshape(h, d).t(),
                        dbg2, dwn2.reshape(h, d).t(), dbn2,
                        dws.reshape(d, d).t(), dbs, h)


def _gtf_wgrad_bf16_launch(zs, xs, ys, bias_part, d, h):
    """Launch the bf16 weight-gradient kernel and its reduction on bf16
    rows at widths (D, H) that are multiples of 16."""
    n_rows = zs.shape[0]
    la = 2 * h + d
    n_w = la * d + 2 * d * h + d * d
    lib = _lib(True)
    opts = dict(dtype=torch.float32, device=zs.device)
    # The kernel's row splits (its choice) and their partials.
    partial = torch.empty(lib.gtf_wgrad_bf16_partial_floats(n_rows, d, h),
                          **opts)
    out = torch.empty(n_w + la + 3 * d, **opts)
    rc = lib.gtf_wgrad_bf16(
        _ptr(zs), _ptr(xs), _ptr(ys), _ptr(bias_part), bias_part.shape[0],
        _ptr(partial), _ptr(out), n_rows, d, h, _stream(zs))
    _raise_on(rc, "gtf_wgrad_bf16")
    gtf_wgrad_bf16_cuda.launches += 1
    dw1, dwg2, dwn2, dws, db1, dbg2, dbn2, dbs = torch.split(
        out, [la * d, d * h, d * h, d * d, la, d, d, d])
    return _wgrad_grads(dw1.view(la, d), db1, dwg2.view(d, h), dbg2,
                        dwn2.view(d, h), dbn2, dws.view(d, d), dbs, h)


def _check_bf16_rows(name, x, shape):
    if not x.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % name)
    if x.dtype != torch.bfloat16:
        raise ValueError("%s must be bfloat16, got %s" % (name, x.dtype))
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError("%s must be contiguous of shape %s, got %s"
                         % (name, tuple(shape), tuple(x.shape)))


def gtf_wgrad_bf16_cuda(zs, xs, ys, bias_part):
    """Launch the bf16 weight-gradient kernel (``gtf_wgrad_bf16_kernel``)
    on the current stream, on rows in the form of ``gtf_wgrad_bf16_ref``,
    at widths padded to multiples of 16; same outputs."""
    n_rows, d = zs.shape
    h = (xs.shape[1] - d) // 2
    _check_bf16_rows("zs", zs, (n_rows, d))
    _check_bf16_rows("xs", xs, (n_rows, 2 * h + d))
    _check_bf16_rows("ys", ys, (n_rows, 2 * h + 4 * d))
    _check_tensor("bias_part", bias_part, (bias_part.shape[0], 2 * h + 4 * d))
    dp, hp = _padded(d, 16), _padded(h, 16)
    y_blocks = ((h, h) + (d,) * 4, (hp, hp) + (dp,) * 4)
    grads = _gtf_wgrad_bf16_launch(
        _pad_last(zs, dp), _pad_blocks(xs, (h, h, d), (hp, hp, dp)),
        _pad_blocks(ys, *y_blocks), _pad_blocks(bias_part, *y_blocks), dp, hp)
    return grads if (dp, hp) == (d, h) else _unpad_gtf(grads, d, h)


gtf_wgrad_bf16_cuda.launches = 0


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
        ctx.pack = ctx.route = None
        if kernel:
            # The route, named once for the forward and the backward
            # (f32_route's or bf16_route's, else the plan's), and the
            # cluster and wgmma routes' weight images: one pack for both.
            kw = {}
            forced = _FORCED_BF16_ROUTE if bf16 else _FORCED_ROUTE
            if forced:
                ctx.route = kw["route"] = forced[-1]
            d, h = obs_mean.shape[-1], gtf["gate_1"]["w"].shape[0]
            k, b_dim = eps.shape[1], obs_mean.shape[2]
            dp, hp = _check_sizes(k, d, h, bf16)
            route = _route(k, b_dim, dp, hp, bf16, False, ctx.route)[0]
            cls = {(True, "cluster"): Bf16Pack, (True, "wgmma"): Bf16WgPack,
                   (False, "wgmma"): F32Pack}.get((bf16, route))
            if cls is not None:
                ctx.pack = kw["pack"] = cls(_pad_gtf(gtf, dp, hp), dp, hp)
            outs = bfvi_scan_fwd_cuda(obs_mean, obs_std, obs_mask, glb_mean,
                                      glb_std, gtf, eps, min_std, bf16, **kw)
        else:
            outs = bfvi_scan_fwd_ref(obs_mean, obs_std, obs_mask, glb_mean,
                                     glb_std, gtf, eps, min_std, bf16=bf16)
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
        if ctx.kernel:
            kw = {"pack": ctx.pack, "route": ctx.route}
            d_om, d_os, d_gm, d_gs, d_gtf = bfvi_scan_bwd_cuda(
                res, cots, ctx.min_std, ctx.bf16, **kw)
        else:
            d_om, d_os, d_gm, d_gs, d_gtf = bfvi_scan_bwd_ref(
                res, cots, ctx.min_std, bf16=ctx.bf16)
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
