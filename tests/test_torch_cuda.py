"""The port's CUDA kernels (the filtering scan and the PoE + sampling
cell) against their plain PyTorch versions.

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
from multimodal_dmm_tpu_torch.ops.cuda import poe_cell as tcell

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


# B = 7 and 45 give K B rows that are no multiple of the kernels' row
# tiles: 16 below 1,024 rows, 64 from there where 128-row tiles would be
# too few (K = 32, B = 45 is 1,440 rows); 128-row tiles run in the
# Weizmann-width case's recomputed transition and in the weight gradients.
@pytest.mark.parametrize("b_dim", [7, 45])
@pytest.mark.parametrize("k", [1, 4, 25, 32])
def test_kernels_match_plain_versions(dev, k, b_dim):
    _check_against_plain(*_inputs(dev, k=k, b_dim=b_dim))


def test_kernels_match_plain_versions_at_weizmann_width(dev):
    """D = H = 256, K = 25: 1,250 rows a step (64-row tiles), 3,750 rows
    in the backward's batched recompute (128-row tiles)."""
    _check_against_plain(*_inputs(dev, t_max=4, b_dim=50, d=256, h=256,
                                  k=25))


def test_kernels_match_plain_versions_at_merged_width(dev):
    """The merged step's scan: K = 25 over 2 V B = 200 columns at the
    Weizmann width, T = 25 (5,000 rows a step, more tiles than the
    cooperative grid holds at once)."""
    _check_against_plain(*_inputs(dev, t_max=25, b_dim=200, d=256, h=256,
                                  k=25))


# Widths that are no multiple of 4 run zero-padded to the next one: the
# spirals model's D = 5, H = 20, and D = 7, H = 13 (both padded).
@pytest.mark.parametrize("d,h", [(5, 20), (7, 13)])
@pytest.mark.parametrize("k", [1, 25])
def test_kernels_match_plain_versions_at_unaligned_widths(dev, k, d, h):
    _check_against_plain(*_inputs(dev, t_max=10, b_dim=45, d=d, h=h, k=k))


def test_kernels_match_plain_versions_at_spirals_shapes(dev):
    """The spirals training step's K = 25 filtering pass: T = 100, 3 V B =
    300 columns, M = 2, D = 5, H = 20."""
    _check_against_plain(*_inputs(dev, t_max=100, n_exp=2, b_dim=300, d=5,
                                  h=20, k=25))


@pytest.mark.parametrize("n_exp,k", [(2, 1), (2, 25), (4, 1)])
def test_kernels_match_plain_versions_at_vidtimit_shapes(dev, n_exp, k):
    """The VidTIMIT model's three passes ((M, K) = (2, 1), (2, 25), (4,
    1): video and audio, the smoothing pass with two more experts) at T =
    80, V B = 75 columns (three variants of 25), D = H = 256."""
    _check_against_plain(*_inputs(dev, t_max=80, n_exp=n_exp, b_dim=75,
                                  d=256, h=256, k=k))


@pytest.mark.parametrize("d,h", [(5, 20), (7, 13)])
def test_weight_gradient_kernel_at_unaligned_widths(dev, d, h):
    """``gtf_wgrad_cuda`` alone on rows at the real widths."""
    x, gtf, eps, _ = _inputs(dev, t_max=6, b_dim=13, d=d, h=h, k=3)
    z_traj = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)[5]
    n_rows = 5 * 3 * 13
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((n_rows, 2 * h + d), generator=gen, device=dev)
    ys = torch.randn((n_rows, 2 * h + 4 * d), generator=gen, device=dev)
    got = tscan.gtf_wgrad_cuda(z_traj, xs, ys)
    exp = tscan.gtf_wgrad_ref(z_traj, xs, ys)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert got[name][kk].shape == exp[name][kk].shape
            _assert_grads(got[name][kk], exp[name][kk], name + kk)


def test_backward_is_deterministic(dev):
    """No float atomics: two runs of the backward agree bit for bit."""
    x, gtf, eps, cots = _inputs(dev, t_max=5, b_dim=45, k=25)
    outs = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD)
    res = tuple(x) + (gtf, eps, outs[5], outs[0], outs[1])
    first = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    second = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    for i in range(4):
        assert torch.equal(first[i], second[i]), i
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert torch.equal(first[4][name][kk], second[4][name][kk]), name


def _check_against_plain(x, gtf, eps, cots):
    """The forward kernel against the plain forward; the backward kernel
    against the plain backward on the kernel's ReLU masks in the GTF's
    first layers, each unit where those differ from the plain masks
    within rounding of 0 (as chip_smoke.py's phase 3)."""
    got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=str(i))
    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    tscan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        got = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    finally:
        tscan.bfvi_scan_bwd_cuda.rows = None
    ref, margins = tscan.bfvi_scan_bwd_ref_on_masks(res, cots, MIN_STD,
                                                    rows[0])
    bound = tscan.relu_flip_bound(x[0].shape[-1])
    for name, m in margins.items():
        assert bool((m <= bound).all()), (name, m.max().item(), bound)
    for i in range(4):
        _assert_grads(got[i], ref[i], str(i))
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            _assert_grads(got[4][name][kk], ref[4][name][kk], name + kk)


# The bf16 variants against the bf16 plain versions (chip_smoke.py's
# BF16_TOL and BF16_GRAD_RTOL): the Small (K = 1, B = 7), Medium (1,125 rows
# a step) and Large tiles, the Weizmann width, and the spirals widths padded
# to D = 8, whose 8- and 20-deep products end inside one 16-deep step.
@pytest.mark.parametrize("t_max,b_dim,d,h,k", [
    (6, 7, 32, 24, 1), (6, 45, 32, 24, 25), (4, 50, 256, 256, 25),
    (10, 45, 5, 20, 25)])
def test_bf16_kernels_match_plain_versions(dev, t_max, b_dim, d, h, k):
    x, gtf, eps, cots = _inputs(dev, t_max=t_max, b_dim=b_dim, d=d, h=h, k=k)
    got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, bf16=True)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD, bf16=True)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=5e-2, atol=5e-2, err_msg=str(i))
    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    tscan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        got = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True)
    finally:
        tscan.bfvi_scan_bwd_cuda.rows = None
    again = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True)
    ref, margins = tscan.bfvi_scan_bwd_ref_on_masks(res, cots, MIN_STD,
                                                    rows[0], bf16=True)
    bound = tscan.relu_flip_bound(d, bf16=True)
    for name, m in margins.items():
        assert bool((m <= bound).all()), (name, m.max().item(), bound)
    pairs = list(zip(got[:4], ref[:4], again[:4]))
    pairs += [(got[4][n][kk], ref[4][n][kk], again[4][n][kk])
              for n in tscan.GTF_LAYERS for kk in ("w", "b")]
    for g, e, g2 in pairs:
        assert torch.equal(g, g2)
        assert ((g - e).norm() / e.norm()).item() <= 0.25


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


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_grouped_filter_cuda_matches_cpu(dev, direction):
    """The grouped pass (``z_filter_grouped``, one launch of the scan
    kernels per particle group, K = 1 and 25) on the GPU equals the CPU's
    plain versions, values and gradients."""
    model = MultiDMM(["a", "b"], [4, 6], z_dim=32, h_dim=24)
    rng = np.random.RandomState(4)
    zm = rng.randn(2, 6, 5, 32).astype(np.float32)
    zs = (rng.rand(2, 6, 5, 32) + 0.3).astype(np.float32)
    zk = (rng.rand(2, 6, 5) > 0.3).astype(np.float32)
    eps = rng.randn(6, 26, 5, 32).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        params, _ = model.init(0, device=device)
        w = params["trans"][direction]["gate_1"]["w"].requires_grad_(True)
        zm_t = torch.tensor(zm, device=device, requires_grad=True)
        before = tscan.bfvi_scan_fwd_cuda.launches
        (im, istd), (pm, ps), smp = model.z_filter_grouped(
            params, zm_t, torch.tensor(zs, device=device),
            torch.tensor(zk, device=device),
            torch.tensor(eps, device=device), (1, 25), direction=direction)
        assert tscan.bfvi_scan_fwd_cuda.launches - before == (
            2 if device == dev else 0)
        (im.sum() + istd.sum() + pm[1].sum() + (smp ** 2).sum()).backward()
        results.append([im, istd, pm, ps, smp, zm_t.grad, w.grad])
    for i, (c, g) in enumerate(zip(*results)):
        _assert_grads(g.detach(), c.detach(), str(i))


@pytest.mark.parametrize("b_dim,d,k", [(13, 5, 1), (13, 130, 200),
                                       (13, 5, 200), (13, 130, 1)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cell_kernel_matches_plain_version(dev, b_dim, d, k, inverse):
    """Odd shapes (B = 13, D = 5 and 130, K = 1 and 200); rtol/atol 1e-5,
    1e-4 with an inverse expert, as tests/test_pallas_cell.py."""
    rng = np.random.RandomState(b_dim + d + k)
    m = 4
    obs_std = (rng.rand(m, b_dim, d) + 0.2).astype(np.float32)
    mask = rng.rand(m, b_dim) > 0.4
    if inverse:
        obs_std[-1] = -obs_std[-1]
        mask[-1] = True
    arrays = [rng.randn(b_dim, d), rng.rand(b_dim, d) + 0.2,
              rng.randn(m, b_dim, d), obs_std, mask,
              rng.randn(k, b_dim, d)]
    x = [torch.tensor(np.asarray(a, np.float32), device=dev)
         for a in arrays]
    before = tcell.poe_sample_cell_cuda.launches
    got = tcell.poe_sample_cell(*x)
    assert tcell.poe_sample_cell_cuda.launches == before + 1
    exp = tcell.poe_sample_cell_ref(*x)
    tol = 1e-4 if inverse else 1e-5
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=str(i))


@pytest.mark.parametrize("d", [5, 7])
def test_cell_kernel_at_spirals_shapes(dev, d):
    """The spirals evaluation's 200-particle filter step: (M, K, B) = (2,
    200, 100), D = 5 (and 7)."""
    rng = np.random.RandomState(d)
    arrays = [rng.randn(100, d), rng.rand(100, d) + 0.2,
              rng.randn(2, 100, d), rng.rand(2, 100, d) + 0.2,
              rng.rand(2, 100) > 0.4, rng.randn(200, 100, d)]
    x = [torch.tensor(np.asarray(a, np.float32), device=dev)
         for a in arrays]
    got = tcell.poe_sample_cell(*x)
    exp = tcell.poe_sample_cell_ref(*x)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


def test_cell_kernel_at_vidtimit_shape(dev):
    """The VidTIMIT evaluation's 200-particle filter step: (M, K, B, D) =
    (2, 200, 25, 256)."""
    rng = np.random.RandomState(11)
    arrays = [rng.randn(25, 256), rng.rand(25, 256) + 0.2,
              rng.randn(2, 25, 256), rng.rand(2, 25, 256) + 0.2,
              rng.rand(2, 25) > 0.4, rng.randn(200, 25, 256)]
    x = [torch.tensor(np.asarray(a, np.float32), device=dev)
         for a in arrays]
    got = tcell.poe_sample_cell(*x)
    exp = tcell.poe_sample_cell_ref(*x)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_cell_path_z_filter_cuda_matches_cpu(dev, direction):
    """The filtering pass's cell path (200 particles) on the GPU (cell
    kernel) equals the same pass on the CPU (plain version)."""
    model = MultiDMM(["a", "b"], [4, 6], z_dim=32, h_dim=24)
    rng = np.random.RandomState(4)
    zm = rng.randn(2, 6, 5, 32).astype(np.float32)
    zs = (rng.rand(2, 6, 5, 32) + 0.3).astype(np.float32)
    zk = (rng.rand(2, 6, 5) > 0.3).astype(np.float32)
    eps = rng.randn(6, 200, 5, 32).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        params, _ = model.init(0, device=device)
        before = tcell.poe_sample_cell_cuda.launches
        with torch.no_grad():
            (im, istd), (pm, ps), smp = model.z_filter(
                params, *[torch.tensor(a, device=device)
                          for a in (zm, zs, zk)], direction=direction,
                n_particles=200, eps=torch.tensor(eps, device=device),
                use_cell=True)
        launched = tcell.poe_sample_cell_cuda.launches - before
        assert launched == (6 if device == dev else 0)
        results.append([im, istd, pm, ps, smp])
    for i, (c, g) in enumerate(zip(*results)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=str(i))
