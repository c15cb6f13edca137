"""SSIM (structural similarity) per image (counterpart of
multimodal_dmm_tpu/ops/ssim.py).

A separable 1-D Gaussian blur with valid padding, applied once to the
five channel groups (X, Y, X^2, Y^2, XY) as one depthwise convolution
per direction, then the per-image mean over C*H*W. Defaults: win_size
11, win_sigma 1.5, data_range 1.0, K1 0.01, K2 0.03.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_kernel_1d(size, sigma):
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def _blur(x, win):
    """Depthwise valid-padding separable blur. x: (N, C, H, W)."""
    c, k = x.shape[1], win.shape[0]
    out = F.conv2d(x, win.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(out, win.reshape(1, 1, k, 1).repeat(c, 1, 1, 1),
                    groups=c)


def eval_ssim(x, y, win_size=11, win_sigma=1.5, data_range=1.0,
              size_average=False, full=False):
    """SSIM per image of two (N, C, H, W) batches."""
    if x.dim() != 4 or y.dim() != 4:
        raise ValueError("Input images must be 4-d tensors.")
    if x.shape != y.shape:
        raise ValueError("Input images must have the same dimensions.")
    if win_size % 2 != 1:
        raise ValueError("Window size must be odd.")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gauss_kernel_1d(win_size, win_sigma).to(device=x.device,
                                                   dtype=x.dtype)
    out = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=1), win)
    mu1, mu2, s1_sq, s2_sq, s12 = torch.chunk(out, 5, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1_sq = s1_sq - mu1_sq
    s2_sq = s2_sq - mu2_sq
    s12 = s12 - mu1_mu2
    cs_map = (2 * s12 + c2) / (s1_sq + s2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    ssim_val = ssim_map.mean(dim=(1, 2, 3))
    cs = cs_map.mean(dim=(1, 2, 3))
    if size_average:
        ssim_val, cs = ssim_val.mean(), cs.mean()
    if full:
        return ssim_val, cs
    return ssim_val
