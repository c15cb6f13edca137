"""The port's CUDA scan kernels against their plain PyTorch versions.

These need a GPU and skip without one. The file imports neither JAX nor
the JAX package, so on a machine without JAX it runs on its own:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

pytestmark = pytest.mark.cuda

MIN_STD = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, t_max=6, n_exp=3, b_dim=7, d=32, h=24, k=4, seed=2):
    gen = torch.Generator().manual_seed(seed)
    gtf = {n: {kk: v.to(dev) for kk, v in p.items()}
           for n, p in tnn.gtf_init(gen, d, h).items()}
    rng = np.random.RandomState(seed)
    obs_std = (rng.rand(t_max, n_exp, b_dim, d) + 0.2).astype(np.float32)
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)  # a signed expert
    arrays = [rng.randn(t_max, n_exp, b_dim, d), obs_std,
              rng.rand(t_max, n_exp, b_dim) > 0.4,
              rng.randn(b_dim, d) * 0.1, rng.rand(b_dim, d) * 0.5 + 0.7,
              rng.randn(t_max, k, b_dim, d) * 0.5]
    x = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]
    cots = [torch.tensor(rng.randn(t_max, b_dim, d).astype(np.float32),
                         device=dev) for _ in range(5)]
    return x[:5], gtf, x[5], cots


def _assert_grads(got, exp, err):
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    scale = np.abs(exp).max() + 1e-6
    np.testing.assert_allclose(got / scale, exp / scale, rtol=1e-3,
                               atol=1e-3, err_msg=err)


@pytest.mark.parametrize("k", [1, 4, 25])
def test_kernels_match_plain_versions(dev, k):
    x, gtf, eps, cots = _inputs(dev, k=k)
    got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=str(i))
    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    got = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    ref = tscan.bfvi_scan_bwd_ref(res, cots, MIN_STD)
    for i in range(4):
        _assert_grads(got[i], ref[i], str(i))
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            _assert_grads(got[4][name][kk], ref[4][name][kk], name + kk)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_z_filter_cuda_matches_cpu(dev, direction):
    """The model's filtering pass on the GPU (kernels) equals the same
    pass on the CPU (plain versions), values and gradients."""
    model = MultiDMM(["a", "b"], [4, 6], z_dim=32, h_dim=24)
    rng = np.random.RandomState(3)
    zm = rng.randn(2, 6, 5, 32).astype(np.float32)
    zs = (rng.rand(2, 6, 5, 32) + 0.3).astype(np.float32)
    zk = (rng.rand(2, 6, 5) > 0.3).astype(np.float32)
    eps = rng.randn(6, 3, 5, 32).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        params, _ = model.init(0, device=device)
        leaves = [params["z0_mean"], params["trans"][direction]["gate_1"]["w"]]
        for p in leaves:
            p.requires_grad_(True)
        zm_t = torch.tensor(zm, device=device, requires_grad=True)
        (im, istd), (pm, ps), smp = model.z_filter(
            params, zm_t, torch.tensor(zs, device=device),
            torch.tensor(zk, device=device), direction=direction,
            eps=torch.tensor(eps, device=device))
        (im.sum() + istd.sum() + pm.sum() + (smp ** 2).sum()).backward()
        results.append([im, istd, pm, ps, smp, zm_t.grad]
                       + [p.grad for p in leaves])
    for i, (c, g) in enumerate(zip(*results)):
        _assert_grads(g.detach(), c.detach(), str(i))
