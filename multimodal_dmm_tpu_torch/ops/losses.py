"""Masked, summed losses (counterpart of multimodal_dmm_tpu/ops/losses.py).

Every NLL combines the sequence-length mask with a per-element not-NaN
mask and is a sum, not a mean (the trainer divides by the number of
observed steps). Masked elements are excluded with ``where`` before the
math, so non-finite values there never reach the sum or its gradient.
``nll_categorical`` keeps the reference's ``-p[target]`` form.
"""

import math

import torch
import torch.nn.functional as F


def _broadcast_mask(mask, x):
    """Right-pad ``mask`` with singleton dims to ``x``'s rank."""
    extra = x.dim() - mask.dim()
    if extra > 0:
        mask = mask.reshape(tuple(mask.shape) + (1,) * extra)
    return mask


def _combined_mask(x, mask):
    obs = (~torch.isnan(x)).to(x.dtype)
    if mask is None:
        return obs
    return obs * _broadcast_mask(mask, x).to(x.dtype)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def kld_gauss(mean_1, std_1, mean_2, std_2, mask=None):
    """KL(N(mean_1, std_1) || N(mean_2, std_2)), masked sum, with the
    JAX package's clamps (stds to [1e-6, 1e6], mean gap to +-1e15)."""
    if mask is not None:
        shape = torch.broadcast_shapes(mean_1.shape, std_1.shape,
                                       mean_2.shape, std_2.shape)
        m = _broadcast_mask(mask, torch.empty(shape, device="meta")) > 0
        one = torch.ones((), dtype=std_1.dtype, device=std_1.device)
        mean_1 = torch.where(m, mean_1, _zero(mean_1))
        mean_2 = torch.where(m, mean_2, _zero(mean_2))
        std_1 = torch.where(m, std_1, one)
        std_2 = torch.where(m, std_2, one)
    std_1 = torch.clamp(std_1, 1e-6, 1e6)
    std_2 = torch.clamp(std_2, 1e-6, 1e6)
    diff = torch.clamp(mean_1 - mean_2, -1e15, 1e15)
    kld_element = (2 * torch.log(std_2) - 2 * torch.log(std_1)
                   + (std_1 * std_1 + diff * diff) / (std_2 * std_2) - 1)
    return 0.5 * torch.sum(kld_element)


def nll_bernoulli(theta, x, mask=None):
    """Bernoulli NLL with torch-BCE log clamping at -100."""
    m = _combined_mask(x, mask)
    xs = torch.where(torch.isnan(x), _zero(x), x)
    theta = torch.where(m > 0, theta, torch.full_like(theta, 0.5))
    log_t = torch.clamp(torch.log(theta), min=-100.0)
    log_1mt = torch.clamp(torch.log1p(-theta), min=-100.0)
    nll = -(xs * log_t + (1.0 - xs) * log_1mt)
    return torch.sum(nll * m)


def nll_bernoulli_logits(logits, x, mask=None):
    """Bernoulli NLL from pre-sigmoid logits: log sigma(l) = -softplus(-l),
    log(1 - sigma(l)) = -softplus(l), each clamped at -100."""
    m = _combined_mask(x, mask)
    xs = torch.where(torch.isnan(x), _zero(x), x)
    log_t = torch.clamp(-F.softplus(-logits), min=-100.0)
    log_1mt = torch.clamp(-F.softplus(logits), min=-100.0)
    nll = -(xs * log_t + (1.0 - xs) * log_1mt)
    nll = torch.where(m > 0, nll, _zero(nll))
    return torch.sum(nll * m)


class _BceLogitsMaskedSum(torch.autograd.Function):
    """Masked-sum logit BCE whose backward is the closed form
    ``sigma(l) - x``, recomputed from the saved inputs (no image-sized
    intermediates are kept for the backward)."""

    @staticmethod
    def forward(ctx, lg, xs, cm):
        ctx.save_for_backward(lg, xs, cm)
        nll = -(xs * torch.clamp(-F.softplus(-lg), min=-100.0)
                + (1.0 - xs) * torch.clamp(-F.softplus(lg), min=-100.0))
        nll = torch.where(cm > 0, nll, _zero(nll))
        return torch.sum(nll * cm)

    @staticmethod
    def backward(ctx, ct):
        lg, xs, cm = ctx.saved_tensors
        sig = torch.sigmoid(lg)
        # The -100 clamp zeroes each term's gradient where it binds.
        dnll = ((1.0 - xs) * sig * (lg < 100.0)
                - xs * (1.0 - sig) * (lg > -100.0))
        dnll = torch.where(cm > 0, dnll, _zero(dnll))
        dlg = (ct * cm * dnll).to(lg.dtype)
        if dlg.shape != lg.shape:
            dlg = dlg.expand(lg.shape)
        return dlg, None, None


def bce_logits_masked_sum(lg, xs, cm):
    """lg: (T, A, B, ...) logits; xs: (T, 1, B, ...) NaN-cleaned targets;
    cm: (T, 1, B, ...) combined 0/1 mask. Targets and mask get no
    gradient."""
    return _BceLogitsMaskedSum.apply(lg, xs, cm)


def nll_categorical(probs, x, mask=None):
    """Reference quirk: ``-p[target]`` summed over observed steps.
    probs: (..., K); x: (..., 1) or (...) float labels (NaN = missing)."""
    if x.dim() == probs.dim() - 1:
        x = x.unsqueeze(-1)
    m = _combined_mask(x, mask)
    labels = torch.where(torch.isnan(x), _zero(x), x).to(torch.int64)
    labels = labels.expand(tuple(probs.shape[:-1]) + (labels.shape[-1],))
    p_target = torch.gather(probs, -1, labels)
    p_target = torch.where(m > 0, p_target, _zero(p_target))
    return torch.sum(-p_target * m)


def nll_gauss(mean, std, x, mask=None):
    """Gaussian NLL, masked sum."""
    m = _combined_mask(x, mask)
    xs = torch.where(torch.isnan(x), _zero(x), x)
    mean = torch.where(m > 0, mean, _zero(mean))
    std = torch.where(m > 0, std, torch.ones_like(std))
    mean = torch.clamp(mean, -1e15, 1e15)
    std = torch.clamp(std, 1e-6, 1e6)
    nll = (0.5 * ((xs - mean) / std) ** 2 + torch.log(std)
           + 0.5 * math.log(2 * math.pi))
    return torch.sum(nll * m)
