"""The precision argument for the scan kernels' 3xTF32 products, on the
CPU: TF32 rounding emulated in torch, the forward scan's plain version run
at Weizmann width with its GTF products split into three TF32 passes, and
held to plain float32 within the tolerance the kernels are held to on the
card. One-pass TF32, which the kernels do not use, is printed beside it."""

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

T, M, B, K, D, H = 4, 3, 3, 25, 256, 256
MIN_STD = 1e-3
FWD_TOL = dict(rtol=5e-4, atol=5e-5)  # chip_smoke.py: kernel vs plain
NAMES = ["prior_mean", "prior_std", "infer_mean", "infer_std", "samples",
         "z_traj"]


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_linear(passes):
    """``linear_apply`` with its product in TF32: one pass (hi * hi) or
    three (lo * hi + hi * lo + hi * hi). A product of two TF32 values is
    exact in float32, so only the float32 sums round, as on the card."""
    def linear(p, x):
        w = p["w"]
        x_hi, w_hi = tf32(x), tf32(w)
        y = F.linear(x_hi, w_hi)
        if passes == 3:
            x_lo, w_lo = tf32(x - x_hi), tf32(w - w_hi)
            y = (F.linear(x_lo, w_hi) + F.linear(x_hi, w_lo)) + y
        return y + p["b"]
    return linear


def gtf_apply_with(linear):
    def gtf_apply(p, z, min_std=0.0):
        gate = torch.sigmoid(linear(p["gate_2"],
                                    F.relu(linear(p["gate_1"], z))))
        z_lin = linear(p["z_lin"], z)
        z_nonlin = linear(p["nonlin_2"], F.relu(linear(p["nonlin_1"], z)))
        z_std = F.softplus(linear(p["z_to_std"], z_nonlin)) + min_std
        return (1 - gate) * z_lin + gate * z_nonlin, z_std
    return gtf_apply


def _inputs():
    gtf = tnn.gtf_init(torch.Generator().manual_seed(0), D, H)
    rng = np.random.RandomState(0)
    arrays = [rng.randn(T, M, B, D), 0.1 + rng.rand(T, M, B, D),
              rng.rand(T, M, B) > 0.1, np.zeros((B, D)),
              np.full((B, D), 1.001), rng.randn(T, K, B, D)]
    x = [torch.tensor(np.asarray(a, np.float32)) for a in arrays]
    return x[:5], gtf, x[5]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0], dtype=torch.float32)
    got = tf32(x)
    exp = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                        -(1.0 + 2.0 ** -10), 3.0])
    assert torch.equal(got, exp)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    hi = tf32(y)
    assert torch.equal(tf32(hi), hi)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11


def test_three_pass_tf32_scan_matches_float32(monkeypatch):
    x, gtf, eps = _inputs()
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)
    errs = {}
    for passes in (1, 3):
        monkeypatch.setattr(tscan, "gtf_apply",
                            gtf_apply_with(split_linear(passes)))
        got = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)
        errs[passes] = {name: float((g - e).abs().max())
                        for name, g, e in zip(NAMES, got, exp)}
        if passes == 3:
            for name, g, e in zip(NAMES, got, exp):
                np.testing.assert_allclose(g.numpy(), e.numpy(), **FWD_TOL,
                                           err_msg=name)
    print("max abs error against float32, 1-pass TF32: %s; 3-pass: %s"
          % (errs[1], errs[3]))
