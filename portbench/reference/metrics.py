"""The evaluation's metrics in plain PyTorch: per batch the summed KL and
reconstruction terms, and per sequence the time averages of what each
modality's ``eval_metrics`` in the configuration names (``mse``, ``ssim``
or ``accuracy``, under the summary key that the app reports it by); then
the summary that the evaluation reports (means and standard deviations
over the real sequences, sums divided by the number of real steps)."""

import numpy as np
import torch
import torch.nn.functional as F

from .model import kld_gauss, nll_bernoulli, nll_categorical


def _gauss_window(size, sigma, device):
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device)


def ssim(x, y, win_size=11, win_sigma=1.5, data_range=1.0):
    """SSIM of each image of two (N, C, H, W) batches: a separable Gaussian
    blur with valid padding, the mean of the SSIM map over C, H, W."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    win = _gauss_window(win_size, win_sigma, x.device)
    c = x.shape[1]

    def blur(v):
        v = F.conv2d(v, win.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
        return F.conv2d(v, win.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1),
                        groups=c)
    mu1, mu2 = blur(x), blur(y)
    s1 = blur(x * x) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return (((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs).mean(
        dim=(1, 2, 3))


def _time_avg(val, mask, lengths):
    val = torch.where(mask[..., 0] > 0, val, torch.zeros_like(val))
    return val.sum(dim=0) / torch.clamp(lengths, min=1.0)


def batch_metrics(cfg, outs, recon, targets, mask, lengths):
    """{name: summed scalar or (B,) per-sequence values} of one batch."""
    prior_mean, prior_std, infer_mean, infer_std, _ = outs
    rec_mults = cfg["train"]["rec_mults"]
    mets = {"kld_loss": kld_gauss(infer_mean, infer_std, prior_mean,
                                  prior_std, mask)}
    rec = 0.0
    for mod in cfg["modalities"]:
        m = mod["name"]
        if mod["dist"] == "Categorical":
            rec = rec + rec_mults[m] * nll_categorical(recon[m], targets[m],
                                                       mask[..., 0])
        else:
            rec = rec + rec_mults[m] * nll_bernoulli(recon[m], targets[m],
                                                     mask[..., 0])
    mets["rec_loss"] = rec
    t_max, b_dim = mask.shape[:2]
    for mod in cfg["modalities"]:
        m = mod["name"]
        tgt = torch.nan_to_num(targets[m])
        r = recon[m]
        for kind, key in mod.get("eval_metrics", {}).items():
            if kind == "accuracy":
                hit = r.argmax(dim=-1) == tgt[..., 0].to(torch.int64)
                val = hit.to(torch.float32)
            elif kind == "mse":
                val = ((r - tgt) ** 2 / np.prod(tuple(r.shape[2:]))).sum(
                    dim=tuple(range(2, r.dim())))
            elif kind == "ssim":
                val = ssim(r.reshape((-1,) + tuple(r.shape[2:])),
                           tgt.reshape((-1,) + tuple(tgt.shape[2:]))
                           ).reshape(t_max, b_dim)
            else:
                raise ValueError("no evaluation metric %r" % kind)
            mets[key] = _time_avg(val, mask, lengths)
    return mets


def summarize(mets, n_real, n_frames):
    """The summary of one batch: each per-sequence metric's mean and std
    over the ``n_real`` real columns, each sum over ``n_frames``."""
    out = {}
    for k, v in mets.items():
        v = v.detach().cpu().numpy()
        if v.ndim == 0:
            out[k] = float(v) / n_frames
        else:
            out[k] = float(np.mean(v[:n_real]))
            out[k + "_std"] = float(np.std(v[:n_real]))
    return out
