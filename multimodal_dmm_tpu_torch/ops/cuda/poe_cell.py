"""The fused PoE + particle-sampling cell of one filtering step: a CUDA
kernel for Hopper, its plain PyTorch version, and the entry that picks
between them by device.

Counterpart of multimodal_dmm_tpu/ops/pallas/poe_cell.py. Given the
conditional prior (B, D), M masked, signed-std observation experts
(M, B, D) with their mask (M, B), and noise eps (K, B, D), one call
computes the precision-space product of experts (infer mean/std), the K
particles z_k = mean + eps_k * std and their mean. It runs on
gradient-free paths (evaluation), as the TPU kernel does: there is no
autograd rule.

- ``poe_sample_cell_ref``: plain version, the JAX package's composite
  (``_xla_composite``): ``product_of_experts`` over [prior; experts].
- ``poe_sample_cell_cuda``: launches ``poe_sample_cell_kernel`` of
  ``csrc/poe_cell.cu``; counts its launches in ``.launches``. The kernel
  takes the prior's std as positive, as the TPU kernel does; the
  composite takes its sign. The two agree wherever the prior's std is
  positive, which the filtering pass guarantees.
- ``poe_sample_cell``: CPU tensors go through the plain version, CUDA
  tensors through the kernel; there is no fallback between them.
  ``plain=True`` runs the plain version on any device, to hold the kernel
  against it on the GPU. It raises if an input requires grad while
  autograd records (outside ``torch.no_grad()``).
"""

import ctypes

import torch

from ..poe import product_of_experts
from . import _build
from .bfvi_scan import _check_tensor, _ptr


def poe_sample_cell_ref(prior_mean, prior_std, obs_mean, obs_std, mask, eps):
    """Plain version. Returns (infer_mean, infer_std, z, sample)."""
    ones = torch.ones((1,) + tuple(mask.shape[1:]), dtype=mask.dtype,
                      device=mask.device)
    infer_mean, infer_std = product_of_experts(
        torch.cat([prior_mean[None], obs_mean]),
        torch.cat([prior_std[None], obs_std]), torch.cat([ones, mask]))
    z = infer_mean[None] + eps * infer_std[None]
    return infer_mean, infer_std, z, z.mean(0)


def _lib():
    lib = _build.load("poe_cell")
    if not getattr(lib, "_poe_typed", False):
        lib.poe_sample_cell.argtypes = ([ctypes.c_void_p] * 10
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
        lib.poe_sample_cell.restype = ctypes.c_int
        lib._poe_typed = True
    return lib


def poe_sample_cell_cuda(prior_mean, prior_std, obs_mean, obs_std, mask,
                         eps):
    """Launch the kernel on the current stream; same outputs as
    ``poe_sample_cell_ref``. ``mask`` is float32 (M, B)."""
    n_exp, b_dim, d = obs_mean.shape
    k = eps.shape[0]
    _check_tensor("prior_mean", prior_mean, (b_dim, d))
    _check_tensor("prior_std", prior_std, (b_dim, d))
    _check_tensor("obs_mean", obs_mean, (n_exp, b_dim, d))
    _check_tensor("obs_std", obs_std, (n_exp, b_dim, d))
    _check_tensor("mask", mask, (n_exp, b_dim))
    _check_tensor("eps", eps, (k, b_dim, d))
    if k < 1:
        raise ValueError("eps must hold at least one particle")
    opts = dict(dtype=torch.float32, device=obs_mean.device)
    infer_mean = torch.empty((b_dim, d), **opts)
    infer_std = torch.empty((b_dim, d), **opts)
    z = torch.empty((k, b_dim, d), **opts)
    sample = torch.empty((b_dim, d), **opts)
    stream = torch.cuda.current_stream(obs_mean.device).cuda_stream
    rc = _lib().poe_sample_cell(
        *[_ptr(x) for x in (prior_mean, prior_std, obs_mean, obs_std, mask,
                            eps, infer_mean, infer_std, z, sample)],
        n_exp, b_dim, k, d, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("poe_sample_cell kernel launch failed: CUDA "
                           "error %d" % rc)
    poe_sample_cell_cuda.launches += 1
    return infer_mean, infer_std, z, sample


poe_sample_cell_cuda.launches = 0


def poe_sample_cell(prior_mean, prior_std, obs_mean, obs_std, mask, eps,
                    plain=False):
    """Fused PoE + sampling of one step. Returns (infer_mean, infer_std,
    z, sample). Gradient-free: raises if an input requires grad while
    autograd records."""
    args = (prior_mean, prior_std, obs_mean, obs_std, mask, eps)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        raise ValueError("poe_sample_cell has no gradient; call it on "
                         "tensors that do not require grad (under "
                         "torch.no_grad())")
    if plain or not obs_mean.is_cuda:
        return poe_sample_cell_ref(*args)
    return poe_sample_cell_cuda(
        *[x.contiguous() for x in args[:4]],
        mask.to(torch.float32).contiguous(), eps.contiguous())
