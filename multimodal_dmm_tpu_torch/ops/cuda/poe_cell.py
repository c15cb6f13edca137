"""One step of the evaluation's sampled filtering pass: two CUDA kernels
for Hopper, their plain PyTorch versions, and the entries that pick
between them by device.

Counterpart of multimodal_dmm_tpu/ops/pallas/poe_cell.py and of the
elementwise part of the JAX package's ``MultiDMM._z_next``. Both run on
gradient-free paths (evaluation), as the TPU kernel does: there is no
autograd rule.

- The cell (``poe_sample_cell*``): given the prior (B, D), M masked,
  signed-std observation experts (M, B, D) with their mask (M, B), and
  noise eps (K, B, D), the precision-space product of experts (infer
  mean/std), the K particles z_k = mean + eps_k * std and their mean.
  ``poe_sample_cell_ref`` is the JAX package's composite
  (``_xla_composite``): ``product_of_experts`` over [prior; experts].
- The step (``poe_sample_step*``): from the four product outputs of the
  previous particles (``models.nn.gtf_products``), the transition's
  elementwise tail (``gtf_tail``), the pair PoE of each particle's
  transition with the global prior, their moment-matched mixture over the
  K particles (the conditional prior of ``MultiDMM._z_next``), then the
  cell on that prior. ``poe_sample_step_ref`` chains the functions that
  ``_z_next`` calls and ``poe_sample_cell_ref``.
- ``*_cuda`` launch ``poe_sample_cell_kernel`` and
  ``poe_sample_step_kernel`` of ``csrc/poe_cell.cu`` (one thread block
  cluster a batch column, on the plan of ``poe_plan``) and count their
  launches in ``.launches``. The kernels take the prior's std as
  non-negative, as the TPU kernel does, where the composite takes its
  sign: the two agree wherever the prior's std is positive. (A mixture
  whose variance rounds to 0 gives a prior std of 0: the kernels, like the
  TPU kernel, then give the prior the precision 1e8, the composite 0.)
- ``poe_sample_cell`` and ``poe_sample_step``: CPU tensors go through the
  plain version, CUDA tensors through the kernel; there is no fallback
  between them. ``plain=True`` runs the plain version on any device, to
  hold the kernel against it on the GPU. They raise if an input requires
  grad while autograd records (outside ``torch.no_grad()``). ``out``, a
  tuple of tensors of the outputs' shapes, receives the outputs.
"""

import ctypes

import torch

from ...models.nn import gtf_tail
from ..poe import mean_of_experts, product_of_experts, product_of_experts_pair
from . import _build
from .bfvi_scan import _check_tensor, _ptr

# The launch plan (csrc/poe_cell.cu): THREADS a CTA, clusters of up to
# MAX_CLUSTER CTAs a batch column, each CTA staging about CTA_BYTES of a
# column's rows, within the card's SMEM_LIMIT bytes of shared memory a CTA.
THREADS = 256
MAX_CLUSTER = 8
CTA_BYTES = 32 * 1024
SMEM_LIMIT = 232448
# The widest D whose one staged row of each tensor, sums and prior fit.
MAX_D = 4096


def _smem_bytes(step, d, groups, kb):
    """Shared memory of a CTA (``smem_bytes`` of csrc/poe_cell.cu)."""
    rows = 4 if step else 1
    floats = rows * kb * d + 4 * groups * d + 4 * d + 2 * kb
    return -(-4 * floats // 16) * 16 + 16


def poe_plan(k, b_dim, d, step):
    """The kernels' launch plan, chosen by shape: ``cluster`` CTAs a batch
    column (enough that each stages about CTA_BYTES of the column's rows,
    at most MAX_CLUSTER and K), ``per_cta`` particles a CTA (the last CTA
    takes the rest), ``chunk`` of them staged at once (all, where they fit
    in SMEM_LIMIT), ``lanes`` = min(D, THREADS) threads a row and
    ``groups`` of them a CTA (each sums its own rows), ``smem`` bytes."""
    if not (k >= 1 and b_dim >= 1 and 1 <= d <= MAX_D):
        raise ValueError("the cell kernels take K >= 1, B >= 1 and 1 <= D "
                         "<= %d, got K = %d, B = %d, D = %d"
                         % (MAX_D, k, b_dim, d))
    rows = 4 if step else 1
    cluster = max(1, min(MAX_CLUSTER, k,
                         -(-rows * k * d * 4 // CTA_BYTES)))
    per_cta = -(-k // cluster)
    cluster = -(-k // per_cta)
    lanes = min(d, THREADS)
    groups = THREADS // lanes
    chunk = per_cta
    while _smem_bytes(step, d, groups, chunk) > SMEM_LIMIT:
        chunk -= 1
    return {"cluster": cluster, "per_cta": per_cta, "chunk": chunk,
            "lanes": lanes, "groups": groups,
            "smem": _smem_bytes(step, d, groups, chunk)}


def _plan_array(plan, tma):
    return (ctypes.c_int * 7)(plan["cluster"], plan["per_cta"],
                              plan["chunk"], plan["groups"], plan["lanes"],
                              plan["smem"], int(tma))


def _tma_ok(d, rows):
    """Whether every staged row is a 16-byte aligned run of 16-byte
    multiples: ``rows`` is a list of (tensor, row stride in floats)."""
    return d % 4 == 0 and all(x.data_ptr() % 16 == 0 and ld % 4 == 0
                              for x, ld in rows)


def _lib():
    lib = _build.load("poe_cell")
    if not getattr(lib, "_poe_typed", False):
        lib.poe_sample_cell.argtypes = ([ctypes.c_void_p] * 10
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 2)
        lib.poe_sample_cell.restype = ctypes.c_int
        lib.poe_sample_step.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        lib.poe_sample_step.restype = ctypes.c_int
        lib._poe_typed = True
    return lib


def _outputs(out, shapes, like):
    """``out`` checked against ``shapes``, or new tensors of them."""
    if out is None:
        return tuple(torch.empty(s, dtype=torch.float32, device=like.device)
                     for s in shapes)
    for i, (x, s) in enumerate(zip(out, shapes)):
        _check_tensor("out[%d]" % i, x, s)
    return tuple(out)


def _into(res, out):
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def _refuse_grad(name, args):
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        raise ValueError("%s has no gradient; call it on tensors that do "
                         "not require grad (under torch.no_grad())" % name)


# ---------------------------------------------------------------------------
# The cell
# ---------------------------------------------------------------------------

def poe_sample_cell_ref(prior_mean, prior_std, obs_mean, obs_std, mask, eps):
    """Plain version. Returns (infer_mean, infer_std, z, sample)."""
    ones = torch.ones((1,) + tuple(mask.shape[1:]), dtype=mask.dtype,
                      device=mask.device)
    infer_mean, infer_std = product_of_experts(
        torch.cat([prior_mean[None], obs_mean]),
        torch.cat([prior_std[None], obs_std]), torch.cat([ones, mask]))
    z = infer_mean[None] + eps * infer_std[None]
    return infer_mean, infer_std, z, z.mean(0)


def poe_sample_cell_cuda(prior_mean, prior_std, obs_mean, obs_std, mask,
                         eps, out=None):
    """Launch ``poe_sample_cell_kernel`` on the current stream; same outputs
    as ``poe_sample_cell_ref``. ``mask`` is float32 (M, B); every input is
    contiguous."""
    n_exp, b_dim, d = obs_mean.shape
    k = eps.shape[0]
    _check_tensor("prior_mean", prior_mean, (b_dim, d))
    _check_tensor("prior_std", prior_std, (b_dim, d))
    _check_tensor("obs_mean", obs_mean, (n_exp, b_dim, d))
    _check_tensor("obs_std", obs_std, (n_exp, b_dim, d))
    _check_tensor("mask", mask, (n_exp, b_dim))
    _check_tensor("eps", eps, (k, b_dim, d))
    plan = poe_plan(k, b_dim, d, step=False)
    outs = _outputs(out, ((b_dim, d), (b_dim, d), (k, b_dim, d), (b_dim, d)),
                    eps)
    stream = torch.cuda.current_stream(eps.device).cuda_stream
    rc = _lib().poe_sample_cell(
        *[_ptr(x) for x in (prior_mean, prior_std, obs_mean, obs_std, mask,
                            eps) + outs],
        n_exp, b_dim, k, d, _plan_array(plan, _tma_ok(d, [(eps, d)])),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("poe_sample_cell kernel launch failed: CUDA "
                           "error %d" % rc)
    poe_sample_cell_cuda.launches += 1
    return outs


poe_sample_cell_cuda.launches = 0


def poe_sample_cell(prior_mean, prior_std, obs_mean, obs_std, mask, eps,
                    plain=False, out=None):
    """Fused PoE + sampling of one step. Returns (infer_mean, infer_std,
    z, sample). Gradient-free: raises if an input requires grad while
    autograd records."""
    args = (prior_mean, prior_std, obs_mean, obs_std, mask, eps)
    _refuse_grad("poe_sample_cell", args)
    if plain or not eps.is_cuda:
        return _into(poe_sample_cell_ref(*args), out)
    return poe_sample_cell_cuda(
        *[x.contiguous() for x in args[:4]],
        mask.to(torch.float32).contiguous(), eps.contiguous(), out=out)


# ---------------------------------------------------------------------------
# The step: the transition's tail, the prior's PoE and mixture, the cell
# ---------------------------------------------------------------------------

def poe_sample_step_ref(prods, glb_mean, glb_std, obs_mean, obs_std, mask,
                        eps, min_std):
    """Plain version: ``gtf_tail`` of the products ``prods`` (z_lin,
    gate_pre, z_nonlin, std_pre, each (K, B, D)), ``product_of_experts_pair``
    with the global prior, ``mean_of_experts`` over the particles (the
    prior), then ``poe_sample_cell_ref``. Returns (prior_mean, prior_std,
    infer_mean, infer_std, z, sample)."""
    q_mean, q_std = gtf_tail(*prods, min_std)
    pp_mean, pp_std = product_of_experts_pair(glb_mean, glb_std, q_mean,
                                              q_std)
    prior_mean, prior_std = mean_of_experts(pp_mean, pp_std)
    return (prior_mean, prior_std) + poe_sample_cell_ref(
        prior_mean, prior_std, obs_mean, obs_std, mask, eps)


def _row_stride(name, x, shape):
    """The row stride of a (K, B, D) tensor whose rows are D contiguous
    floats at a common stride (a view of a wider output); raises for any
    other layout."""
    k, b_dim, d = shape
    if (x.dtype != torch.float32 or not x.is_cuda or tuple(x.shape) != shape
            or x.stride(2) != 1 or x.stride(0) != b_dim * x.stride(1)
            or x.stride(1) < d):
        raise ValueError("%s: expected float32 CUDA rows of shape %s at one "
                         "stride, got %s %s strides %s on %s"
                         % (name, shape, x.dtype, tuple(x.shape), x.stride(),
                            x.device))
    return x.stride(1)


def poe_sample_step_cuda(prods, glb_mean, glb_std, obs_mean, obs_std, mask,
                         eps, min_std, out=None):
    """Launch ``poe_sample_step_kernel`` on the current stream; same outputs
    as ``poe_sample_step_ref``. ``z_lin`` may be a view whose rows lie at a
    common stride (``gtf_products``' slice of the first product); the rest
    is contiguous, ``mask`` float32 (M, B)."""
    z_lin, gate_pre, z_nonlin, std_pre = prods
    n_exp, b_dim, d = obs_mean.shape
    k = eps.shape[0]
    shape = (k, b_dim, d)
    ld = _row_stride("z_lin", z_lin, shape)
    for name, x in (("gate_pre", gate_pre), ("z_nonlin", z_nonlin),
                    ("std_pre", std_pre), ("eps", eps)):
        _check_tensor(name, x, shape)
    _check_tensor("glb_mean", glb_mean, (b_dim, d))
    _check_tensor("glb_std", glb_std, (b_dim, d))
    _check_tensor("obs_mean", obs_mean, (n_exp, b_dim, d))
    _check_tensor("obs_std", obs_std, (n_exp, b_dim, d))
    _check_tensor("mask", mask, (n_exp, b_dim))
    plan = poe_plan(k, b_dim, d, step=True)
    outs = _outputs(out, ((b_dim, d),) * 4 + (shape, (b_dim, d)), eps)
    tma = _tma_ok(d, [(z_lin, ld), (gate_pre, d), (z_nonlin, d),
                      (std_pre, d), (eps, d)])
    stream = torch.cuda.current_stream(eps.device).cuda_stream
    rc = _lib().poe_sample_step(
        _ptr(z_lin), ld,
        *[_ptr(x) for x in (gate_pre, z_nonlin, std_pre, glb_mean, glb_std,
                            obs_mean, obs_std, mask, eps) + outs],
        float(min_std), n_exp, b_dim, k, d, _plan_array(plan, tma),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("poe_sample_step kernel launch failed: CUDA "
                           "error %d" % rc)
    poe_sample_step_cuda.launches += 1
    return outs


poe_sample_step_cuda.launches = 0


def poe_sample_step(prods, glb_mean, glb_std, obs_mean, obs_std, mask, eps,
                    min_std, plain=False, out=None):
    """One later step of the sampled filtering pass from the previous
    particles' products ``prods`` (``gtf_products``). Returns (prior_mean,
    prior_std, infer_mean, infer_std, z, sample). Gradient-free: raises if
    an input requires grad while autograd records."""
    args = tuple(prods) + (glb_mean, glb_std, obs_mean, obs_std, mask, eps)
    _refuse_grad("poe_sample_step", args)
    if plain or not eps.is_cuda:
        return _into(poe_sample_step_ref(prods, glb_mean, glb_std, obs_mean,
                                         obs_std, mask, eps, min_std), out)
    z_lin = prods[0]
    if z_lin.stride(-1) != 1 or z_lin.stride(0) != z_lin.shape[1] * \
            z_lin.stride(1):
        z_lin = z_lin.contiguous()
    return poe_sample_step_cuda(
        (z_lin,) + tuple(x.contiguous() for x in prods[1:]),
        *[x.contiguous() for x in (glb_mean, glb_std, obs_mean, obs_std)],
        mask.to(torch.float32).contiguous(), eps.contiguous(), min_std,
        out=out)
