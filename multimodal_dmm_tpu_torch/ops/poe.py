"""Masked Gaussian expert fusion in precision space (counterpart of
multimodal_dmm_tpu/ops/poe.py).

- ``product_of_experts``: an expert with a negative std contributes
  negative precision (an inverse expert, used to cancel the global prior
  in the smoothing pass); masked experts are excluded with ``where`` so
  NaNs never leak; a total precision below ``PREC_FLOOR`` means "no
  information" and gives mean 0, std ``PREC_FLOOR ** -0.5`` (1e3).
- ``mean_of_experts``: moment-matched mixture, uniform over all M experts.

The expert axis is 0 and the latent axis is last.
"""

import torch

PREC_FLOOR = 1e-6


def product_of_experts(mean, std, mask=None, eps=1e-8):
    """Fuse Gaussian experts along axis 0; returns (mean, std) of shape
    ``mean.shape[1:]``. ``mask`` (M, ...) selects the participants; when
    None, experts with a NaN anywhere in their std are excluded."""
    var = std * std + eps
    prec = torch.sign(std) / var
    if mask is None:
        mask = ~torch.isnan(var).any(dim=-1)
    keep = (mask.to(mean.dtype) > 0).unsqueeze(-1)
    prec = torch.where(keep, prec, torch.zeros_like(prec))
    mean = torch.where(keep, mean, torch.zeros_like(mean))
    num = torch.sum(mean * prec, dim=0)
    denom = torch.sum(prec, dim=0)
    return _floor(num, denom)


def _floor(num, denom):
    low = denom < PREC_FLOOR
    safe = torch.where(low, torch.ones_like(denom), denom)
    product_mean = torch.where(low, torch.zeros_like(num), num / safe)
    product_std = torch.where(low, torch.full_like(safe, PREC_FLOOR ** -0.5),
                              safe ** -0.5)
    return product_mean, product_std


def product_of_experts_pair(mean_1, std_1, mean_2, std_2, eps=1e-8):
    """Two-expert ``product_of_experts`` (mask=None) without stacking the
    experts; the first may be a broadcast global prior."""
    var_1 = std_1 * std_1 + eps
    var_2 = std_2 * std_2 + eps
    ok_1 = ~torch.isnan(var_1).any(dim=-1, keepdim=True)
    ok_2 = ~torch.isnan(var_2).any(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=mean_2.dtype, device=mean_2.device)
    prec_1 = torch.where(ok_1, torch.sign(std_1) / var_1, zero)
    prec_2 = torch.where(ok_2, torch.sign(std_2) / var_2, zero)
    num = (torch.where(ok_1, mean_1, zero) * prec_1
           + torch.where(ok_2, mean_2, zero) * prec_2)
    return _floor(num, prec_1 + prec_2)


def mean_of_experts(mean, std, mask=None):
    """Moment-matched mixture along axis 0; masked experts contribute
    zero moments but still count in the 1/M weight."""
    if mask is None:
        mask = ~torch.isnan(std).any(dim=-1)
    keep = (mask.to(mean.dtype) > 0).unsqueeze(-1)
    mean = torch.where(keep, mean, torch.zeros_like(mean))
    var = torch.where(keep, std * std, torch.zeros_like(std))
    sum_mean = torch.mean(mean, dim=0)
    sum_var = (torch.mean(var, dim=0) + torch.mean(mean * mean, dim=0)
               - sum_mean * sum_mean)
    return sum_mean, torch.sqrt(torch.clamp(sum_var, min=0.0))
