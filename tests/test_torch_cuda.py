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
# chip_smoke.py's BF16_GTF_RFRO and BF16_GTF_SEPARATION: each output of a
# bf16 scan within these of its bf16 plain version in relative Frobenius
# norm, and the float32 kernel's at least SEPARATION times farther from
# it, so that a kernel that skipped the bf16 rounding fails.
BF16_RFRO = {"fwd": 1e-3, "bwd": 3e-3}
BF16_SEPARATION = 3.0


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


# Past 32 particles: nothing in the float32 kernels is sized by K (they walk
# a column's particles in chunks of 8 on two lanes).
@pytest.mark.parametrize("k", [33, 50, 100, 256])
def test_kernels_match_plain_versions_past_32_particles(dev, k):
    before = tscan.bfvi_scan_bwd_cuda.launches
    _check_against_plain(*_inputs(dev, t_max=4, b_dim=9, k=k))
    assert tscan.bfvi_scan_bwd_cuda.launches == before + 1


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


# The float32 weight gradients on each route (None: the plan's; the narrow
# and wgmma routes named, whatever the plan gives the shape; the tiled
# kernel) at unaligned and aligned widths, narrow and wide, at K = 1 (T =
# 6, 13 columns: 65 rows) and K = 25 (T = 25, 100 columns: 60,000 rows,
# several stages a CTA on every route): equal to the plain version, two
# runs bit for bit, one launch on the route's counter.
@pytest.mark.parametrize("route", [None, "narrow", "wgmma", "tiled"])
@pytest.mark.parametrize("k,t_max,b_dim", [(1, 6, 13), (25, 25, 100)])
@pytest.mark.parametrize("d,h", [(5, 20), (7, 13), (8, 20), (32, 32),
                                 (64, 64), (32, 256), (256, 256)])
def test_weight_gradient_kernel_at_unaligned_widths(dev, d, h, k, t_max,
                                                    b_dim, route):
    """``gtf_wgrad_cuda`` alone on rows at the real widths."""
    gen = torch.Generator(device=dev).manual_seed(d + h + k)
    n_rows = (t_max - 1) * k * b_dim
    z_traj = torch.randn((t_max, k, b_dim, d), generator=gen, device=dev)
    xs = torch.randn((n_rows, 2 * h + d), generator=gen, device=dev)
    ys = torch.randn((n_rows, 2 * h + 4 * d), generator=gen, device=dev)
    dp, hp = tscan._padded(d), tscan._padded(h)
    want = route or tscan.f32_wgrad_plan(dp, hp, n_rows)["route"]
    assert want != "tiled" or route == "tiled"
    fn = tscan.gtf_wgrad_cuda
    before = (fn.launches, getattr(fn, "launches_" + want))
    got = fn(z_traj, xs, ys, route=route)
    again = fn(z_traj, xs, ys, route=route)
    assert (fn.launches, getattr(fn, "launches_" + want)) == (
        before[0] + 2, before[1] + 2)
    exp = tscan.gtf_wgrad_ref(z_traj, xs, ys)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert got[name][kk].shape == exp[name][kk].shape
            _assert_grads(got[name][kk], exp[name][kk], name + kk)
            assert torch.equal(got[name][kk], again[name][kk]), name + kk


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


# Each float32 route at the widths that the plan gives it (the column route
# at the spirals model's D = 5, H = 20 and at D = 12, H = 20, both padded to
# multiples of 4; the wgmma route at the Weizmann width, at D = 464, whose
# depth ends inside a 32-deep slab, at a narrow D beside a wide H and at
# D = 44, H = 36, between the column route's widths and 64), at K = 1, 4,
# 25 and 50, against the plain versions at the unchanged tolerances; each
# route counts its own launches.
@pytest.mark.parametrize("k", [1, 4, 25, 50])
@pytest.mark.parametrize("d,h,route", [(5, 20, "column"), (12, 20, "column"),
                                       (256, 256, "wgmma"),
                                       (464, 256, "wgmma"),
                                       (32, 256, "wgmma"),
                                       (44, 36, "wgmma")])
def test_f32_routes_match_plain_versions(dev, d, h, route, k):
    x, gtf, eps, cots = _inputs(dev, t_max=4, b_dim=9, d=d, h=h, k=k)
    dp, hp = tscan._check_sizes(k, d, h)
    for backward in (False, True):
        assert tscan.f32_scan_plan(k, 9, dp, hp, backward)["route"] == route
    wrappers = (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda)
    name = "launches_" + route
    before = [getattr(f, name) for f in wrappers]
    _check_against_plain(x, gtf, eps, cots)
    assert [getattr(f, name) for f in wrappers] == [before[0] + 1,
                                                    before[1] + 1]


@pytest.mark.parametrize("d,h,k", [(5, 20, 25), (12, 20, 4), (256, 256, 25),
                                   (256, 256, 50), (464, 256, 1)])
def test_f32_recompute_equals_forward_and_runs_agree(dev, d, h, k):
    """On the column and wgmma routes the backward's recomputed transition
    (its xs rows h1, hn, z_nonlin) equals the forward kernel's own bit for
    bit (one product routine and one order of depth for both), and two
    backward runs agree bit for bit (no float atomics)."""
    x, gtf, eps, cots = _inputs(dev, t_max=5, b_dim=9, d=d, h=h, k=k)
    tscan.bfvi_scan_fwd_cuda.rows = fwd_rows = []
    tscan.bfvi_scan_bwd_cuda.rows = bwd_rows = []
    try:
        got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD)
        res = tuple(x) + (gtf, eps, got[5], got[0], got[1])
        first = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    finally:
        tscan.bfvi_scan_fwd_cuda.rows = tscan.bfvi_scan_bwd_cuda.rows = None
    second = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
    assert fwd_rows[0].shape == bwd_rows[0].shape == (4 * k * 9, 2 * h + d)
    assert torch.equal(fwd_rows[0], bwd_rows[0])
    for i in range(4):
        assert torch.equal(first[i], second[i]), i
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert torch.equal(first[4][name][kk], second[4][name][kk]), name


# The tiled kernels, the route "tiled" (the tile engine's, which the plan no
# longer gives: the reference that the new routes are timed against), named
# by the caller at shapes of both new routes: D = 32 beside H = 256, K = 256
# columns that no column CTA holds, the spirals widths and the Weizmann
# width.
@pytest.mark.parametrize("d,h,k,planned", [(32, 256, 4, "wgmma"),
                                           (32, 24, 256, "wgmma"),
                                           (5, 20, 25, "column"),
                                           (256, 256, 25, "wgmma")])
def test_tiled_route_matches_plain_versions(dev, d, h, k, planned):
    x, gtf, eps, cots = _inputs(dev, t_max=4, b_dim=9, d=d, h=h, k=k)
    dp, hp = tscan._check_sizes(k, d, h)
    assert tscan.f32_scan_plan(k, 9, dp, hp)["route"] == planned
    wrappers = (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda)
    before = [f.launches_tiled for f in wrappers]
    _check_against_plain(x, gtf, eps, cots, route="tiled")
    assert [f.launches_tiled for f in wrappers] == [before[0] + 1,
                                                    before[1] + 1]


def test_autograd_backward_takes_the_forward_route(dev):
    """``f32_route`` names the route for the scans that ``bfvi_scan``
    starts in its block; the backward runs on the route its forward took,
    though it runs after the block, and gives the gradients of the plan's
    route within BWD_TOL."""
    x, gtf, eps, _ = _inputs(dev, t_max=4, b_dim=9, d=5, h=20, k=4)
    wrappers = (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda)

    def grads(route):
        leaves = [v.clone().requires_grad_(True) for v in (x[0], x[1])]
        if route is None:
            outs = tscan.bfvi_scan(*leaves, *x[2:], gtf, eps, MIN_STD)
        else:
            with tscan.f32_route(route):
                outs = tscan.bfvi_scan(*leaves, *x[2:], gtf, eps, MIN_STD)
        sum(o.sum() for o in outs).backward()
        return [v.grad for v in leaves]

    before = [(f.launches_tiled, f.launches_column) for f in wrappers]
    forced = grads("tiled")
    after = [(f.launches_tiled, f.launches_column) for f in wrappers]
    assert after == [(b[0] + 1, b[1]) for b in before]
    planned = grads(None)
    assert [f.launches_column for f in wrappers] == [a[1] + 1 for a in after]
    for g, e in zip(forced, planned):
        _assert_grads(g, e, "tiled against column")


def _check_against_plain(x, gtf, eps, cots, route=None):
    """The forward kernel against the plain forward; the backward kernel
    against the plain backward on the kernel's ReLU masks in the GTF's
    first layers, each unit where those differ from the plain masks
    within rounding of 0 (as chip_smoke.py's phase 3); ``route``: the
    float32 route in place of the plan's."""
    got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, route=route)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=str(i))
    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    tscan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        got = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, route=route)
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
# BF16_TOL and BF16_GRAD_RTOL), on the plans of ops/cuda/bfvi_scan.py:
# K = 1 with 7 columns, K = 25 in clusters of two columns, the Weizmann
# width (clusters of 8 CTAs), and widths that the bf16 route pads to
# multiples of 16: the spirals model's D = 5, H = 20 (run as 16 and 32, two
# CTAs a cluster), D = 12, H = 20 (the same) and D = 48, H = 40 (48 and
# 48: six CTAs a cluster); D = H = 512 streams its weights.
@pytest.mark.parametrize("t_max,b_dim,d,h,k", [
    (6, 7, 32, 24, 1), (6, 45, 32, 24, 25), (4, 50, 256, 256, 25),
    (10, 45, 5, 20, 25), (6, 45, 12, 20, 25), (6, 45, 12, 20, 1),
    (5, 13, 48, 40, 25), (3, 9, 512, 512, 25), (3, 70, 512, 512, 1)])
def test_bf16_kernels_match_plain_versions(dev, t_max, b_dim, d, h, k):
    _check_bf16_against_plain(
        *_inputs(dev, t_max=t_max, b_dim=b_dim, d=d, h=h, k=k))


# Each bf16 route at the shapes that need it: widths whose operands no
# cluster holds (464 and 592 split into clusters of two CTAs; 768), and K
# past one 64-row wgmma tile (100 at D = H = 256, 65 at the spirals widths
# run as 16 and 32), on the wgmma route; K = 50 on the cluster route (one
# column a cluster). The plan chooses the route; each route counts its own
# launches. The tiled route runs where named (the twin of the wgmma
# route).
BF16_WGMMA_SHAPES = [(9, 464, 256, 25), (9, 592, 592, 25), (9, 768, 768, 25),
                     (20, 256, 256, 100), (13, 5, 20, 65)]


@pytest.mark.parametrize("b_dim,d,h,k,route", [
    s + ("wgmma",) for s in BF16_WGMMA_SHAPES] + [
    (20, 256, 256, 50, "cluster"), (9, 768, 768, 25, "tiled"),
    (20, 256, 256, 100, "tiled")])
def test_bf16_routes_match_plain_versions(dev, b_dim, d, h, k, route):
    dp, hp = tscan._check_sizes(k, d, h, bf16=True)
    named = route if route == "tiled" else None
    assert tscan.bf16_scan_plan(k, b_dim, dp, hp)["route"] == (
        "wgmma" if named else route)
    name = tscan._COUNTERS[(True, route)]
    before = [getattr(f, name) for f in (tscan.bfvi_scan_fwd_cuda,
                                         tscan.bfvi_scan_bwd_cuda)]
    _check_bf16_against_plain(
        *_inputs(dev, t_max=4, b_dim=b_dim, d=d, h=h, k=k), tight=True,
        route=named)
    after = [getattr(f, name) for f in (tscan.bfvi_scan_fwd_cuda,
                                        tscan.bfvi_scan_bwd_cuda)]
    assert after == [before[0] + 1, before[1] + 2]


@pytest.mark.parametrize("b_dim,d,h,k", BF16_WGMMA_SHAPES)
def test_bf16_wgmma_route_runs_agree_and_recompute_equals_forward(
        dev, b_dim, d, h, k):
    """The bf16 wgmma kernels: two forward runs and two backward runs
    give the same bits, and the backward's recomputed transition (its
    xs rows, in bfloat16) equals the forward's own rows bit for bit."""
    x, gtf, eps, cots = _inputs(dev, t_max=4, b_dim=b_dim, d=d, h=h, k=k)
    before = tscan.bfvi_scan_fwd_cuda.launches_bf16_wgmma
    tscan.bfvi_scan_fwd_cuda.rows = fwd_rows = []
    tscan.bfvi_scan_bwd_cuda.rows = bwd_rows = []
    try:
        got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, bf16=True)
        res = tuple(x) + (gtf, eps, got[5], got[0], got[1])
        g_bwd = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True)
    finally:
        tscan.bfvi_scan_fwd_cuda.rows = tscan.bfvi_scan_bwd_cuda.rows = None
    assert tscan.bfvi_scan_fwd_cuda.launches_bf16_wgmma == before + 1
    again = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, bf16=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    g_again = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True)
    for a, b in zip(g_bwd[:4], g_again[:4]):
        assert torch.equal(a, b)
    for n in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert torch.equal(g_bwd[4][n][kk], g_again[4][n][kk]), (n, kk)
    assert fwd_rows[0].shape == bwd_rows[0].shape == (3 * k * b_dim,
                                                      2 * h + d)
    assert torch.equal(fwd_rows[0], bwd_rows[0])


def test_bf16_autograd_takes_the_named_route(dev):
    """``bfvi_scan`` with ``bf16`` under ``bf16_route("tiled")`` runs the
    forward and its backward on the tiled kernels, and the plan's wgmma
    route without it; the two agree as each agrees with the plain
    versions."""
    x, gtf, eps, cots = _inputs(dev, t_max=4, b_dim=9, d=64, h=48, k=100)
    wrappers = (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda)

    def grads():
        obs = [v.clone().requires_grad_() for v in x[:2]]
        out = tscan.bfvi_scan(obs[0], obs[1], *x[2:], gtf, eps, MIN_STD,
                              bf16=True)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        return [o.grad for o in obs]
    before = [(f.launches_bf16_tiled, f.launches_bf16_wgmma)
              for f in wrappers]
    with tscan.bf16_route("tiled"):
        tiled = grads()
    mid = [(f.launches_bf16_tiled, f.launches_bf16_wgmma) for f in wrappers]
    planned = grads()
    after = [(f.launches_bf16_tiled, f.launches_bf16_wgmma)
             for f in wrappers]
    assert mid == [(b[0] + 1, b[1]) for b in before]
    assert after == [(m[0], m[1] + 1) for m in mid]
    for g, e in zip(tiled, planned):
        assert ((g - e).norm() / e.norm()).item() <= 0.25


def _rel_fro(got, exp):
    return ((got - exp).norm() / (exp.norm() + 1e-30)).item()


def _hold_bf16(direction, got, ctrl, exp):
    """Each bf16 output of ``got`` within BF16_RFRO[direction] of ``exp``
    (the bf16 plain version's) in relative Frobenius norm, and the float32
    kernel's (``ctrl``) at least BF16_SEPARATION times farther."""
    for i, (g, c, e) in enumerate(zip(got, ctrl, exp)):
        err = _rel_fro(g, e)
        assert err <= BF16_RFRO[direction], (direction, i, err)
        assert _rel_fro(c, e) >= BF16_SEPARATION * max(err, 1e-7), (
            direction, i, err, _rel_fro(c, e))


def _check_bf16_against_plain(x, gtf, eps, cots, tight=False, route=None):
    """The bf16 variants against the bf16 plain versions: the forward at
    BF16_TOL, the backward (on its own ReLU masks, each flip within the
    rounding bound) within BF16_GRAD_RTOL in relative Frobenius norm and
    equal to a second run bit for bit. With ``tight``, every output also
    within BF16_RFRO, with the float32 kernels as the control
    (``_hold_bf16``). ``route``: a bf16 route named in place of the
    plan's."""
    d = x[0].shape[-1]
    got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, bf16=True,
                                   route=route)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, MIN_STD, bf16=True)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=5e-2, atol=5e-2, err_msg=str(i))
    if tight:
        _hold_bf16("fwd", got, tscan.bfvi_scan_fwd_cuda(*x, gtf, eps,
                                                        MIN_STD), exp)
    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    tscan.bfvi_scan_bwd_cuda.rows = rows = []
    try:
        got = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True,
                                       route=route)
    finally:
        tscan.bfvi_scan_bwd_cuda.rows = None
    again = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True,
                                     route=route)
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
    if tight:
        ctrl = tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD)
        ctrl = list(ctrl[:4]) + [ctrl[4][n][kk] for n in tscan.GTF_LAYERS
                                 for kk in ("w", "b")]
        _hold_bf16("bwd", [g for g, _, _ in pairs], ctrl,
                   [e for _, e, _ in pairs])


def _bf16_rows(dev, n_rows, d, h, n_parts=3, seed=0):
    """Rows as the bf16 backward writes them (bfloat16 images of float32
    rows; xs >= 0 as after the ReLUs) and ``n_parts`` partials of the
    float32 cotangents' sums."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    zs, xs, ys = (torch.randn((n_rows, w), generator=gen, device=dev)
                  for w in (d, 2 * h + d, 2 * h + 4 * d))
    parts = torch.stack([c.sum(0) for c in ys.chunk(n_parts)])
    bf = lambda v: v.to(torch.bfloat16)  # noqa: E731
    return bf(zs), bf(xs.abs()), bf(ys), parts


# The bf16 weight-gradient kernel (TMA, wgmma) at the training step's
# launches: Weizmann (T = 25, 100 columns: K = 25 and K = 1), VidTIMIT (T
# = 80, 75 columns, K = 25), the spirals shapes (T = 100, 300 columns, D =
# 5, H = 20 run as 16 and 32); and unaligned widths and row counts.
@pytest.mark.parametrize("n_rows,d,h", [
    (24 * 25 * 100, 256, 256), (24 * 100, 256, 256), (79 * 25 * 75, 256, 256),
    (99 * 25 * 300, 5, 20), (1000, 7, 13), (333, 48, 40), (150, 464, 256),
    (64, 768, 768)])
def test_bf16_weight_gradient_kernel(dev, n_rows, d, h):
    """Against ``gtf_wgrad_bf16_ref`` within 1e-5 in relative Frobenius norm
    (weights: the same exact products in another f32 order; biases: the
    same partials added in order), and two calls bit for bit."""
    rows = _bf16_rows(dev, n_rows, d, h)
    before = tscan.gtf_wgrad_bf16_cuda.launches
    got = tscan.gtf_wgrad_bf16_cuda(*rows)
    again = tscan.gtf_wgrad_bf16_cuda(*rows)
    assert tscan.gtf_wgrad_bf16_cuda.launches == before + 2
    exp = tscan.gtf_wgrad_bf16_ref(*rows)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            g, e = got[name][kk], exp[name][kk]
            assert g.shape == e.shape
            assert torch.equal(g, again[name][kk]), (name, kk)
            assert ((g - e).norm() / e.norm()).item() <= 1e-5, (name, kk)


@pytest.mark.parametrize("d,h,k", [(32, 24, 25), (256, 256, 25),
                                   (5, 20, 1), (512, 512, 25),
                                   (768, 768, 25), (32, 24, 100)])
def test_bf16_recompute_equals_forward(dev, d, h, k):
    """The bf16 backward's recomputed transition (its xs rows: h1, hn,
    z_nonlin, in bfloat16) equals the forward kernel's own rounded alike,
    bit for bit, on either route: one product routine and one K-order for
    both, so no ReLU or gate can flip between them."""
    x, gtf, eps, cots = _inputs(dev, t_max=5, b_dim=9, d=d, h=h, k=k)
    tscan.bfvi_scan_fwd_cuda.rows = fwd_rows = []
    tscan.bfvi_scan_bwd_cuda.rows = bwd_rows = []
    try:
        got = tscan.bfvi_scan_fwd_cuda(*x, gtf, eps, MIN_STD, bf16=True)
        res = tuple(x) + (gtf, eps, got[5], got[0], got[1])
        tscan.bfvi_scan_bwd_cuda(res, cots, MIN_STD, bf16=True)
    finally:
        tscan.bfvi_scan_fwd_cuda.rows = tscan.bfvi_scan_bwd_cuda.rows = None
    assert fwd_rows[0].shape == bwd_rows[0].shape == (4 * k * 9, 2 * h + d)
    assert torch.equal(fwd_rows[0], bwd_rows[0])


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
    """The filtering pass's cell path (200 particles) on the GPU (the cell
    kernel at its first step, the step kernel at the five others) equals
    the same pass on the CPU (plain versions)."""
    model = MultiDMM(["a", "b"], [4, 6], z_dim=32, h_dim=24)
    rng = np.random.RandomState(4)
    zm = rng.randn(2, 6, 5, 32).astype(np.float32)
    zs = (rng.rand(2, 6, 5, 32) + 0.3).astype(np.float32)
    zk = (rng.rand(2, 6, 5) > 0.3).astype(np.float32)
    eps = rng.randn(6, 200, 5, 32).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        params, _ = model.init(0, device=device)
        before = (tcell.poe_sample_cell_cuda.launches,
                  tcell.poe_sample_step_cuda.launches)
        with torch.no_grad():
            (im, istd), (pm, ps), smp = model.z_filter(
                params, *[torch.tensor(a, device=device)
                          for a in (zm, zs, zk)], direction=direction,
                n_particles=200, eps=torch.tensor(eps, device=device),
                use_cell=True)
        launched = (tcell.poe_sample_cell_cuda.launches - before[0],
                    tcell.poe_sample_step_cuda.launches - before[1])
        assert launched == ((1, 5) if device == dev else (0, 0))
        results.append([im, istd, pm, ps, smp])
    for i, (c, g) in enumerate(zip(*results)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=str(i))


def _step_inputs(dev, n_exp, k, b_dim, d, h, seed, nan_rows=False,
                 inverse=False):
    """One later filter step's inputs: ``gtf_products`` of K particles
    under a transition at (D, H) (z_lin a view of rows of 2H + D), a
    global prior broadcast to (B, D), experts (with ``inverse`` the last
    one the smoothing pass's inverse expert), mask, eps."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    gtf = {n: {kk: v.to(dev) for kk, v in p.items()}
           for n, p in tnn.gtf_init(gen, d, h).items()}
    z = torch.tensor(rng.randn(k, b_dim, d).astype(np.float32), device=dev)
    prods = tnn.gtf_products(tnn.gtf_pack(gtf), z)
    if nan_rows:
        prods[3][0, 0, d - 1] = float("nan")
        prods[3][k - 1, b_dim - 1, 0] = float("nan")
    obs_std = (rng.rand(n_exp, b_dim, d) + 0.2).astype(np.float32)
    mask = rng.rand(n_exp, b_dim) > 0.4
    if inverse:
        obs_std[-1] = -obs_std[-1] - 2.0
        mask[-1] = True
    arrays = [np.tile(rng.randn(1, d), (b_dim, 1)),
              np.tile(rng.rand(1, d) + 0.5, (b_dim, 1)),
              rng.randn(n_exp, b_dim, d), obs_std, mask,
              rng.randn(k, b_dim, d)]
    return [prods] + [torch.tensor(np.asarray(a, np.float32), device=dev)
                      for a in arrays]


# Odd and edge shapes (M, K, B, D, H): D no multiple of 4 and rows that
# are (elements copied by the threads) or are not (one TMA copy a row)
# 16-byte runs, D = 1, D above a CTA's 256 threads, K = 1 and 256, no
# expert, and D = 4096, whose rows a CTA stages one at a time.
STEP_SHAPES = [(3, 200, 13, 130, 24), (2, 7, 5, 8, 3), (2, 256, 3, 1, 4),
               (3, 1, 25, 256, 256), (0, 50, 4, 300, 16),
               (2, 200, 100, 5, 20), (1, 200, 2, 4096, 8)]


@pytest.mark.parametrize("n_exp,k,b_dim,d,h", STEP_SHAPES)
@pytest.mark.parametrize("nan_rows", [False, True])
def test_step_kernel_matches_plain_version(dev, n_exp, k, b_dim, d, h,
                                           nan_rows):
    """``poe_sample_step`` on the GPU against its plain version; rtol/atol
    1e-5, as the cell's; two launches agree bit for bit."""
    prods, *x = _step_inputs(dev, n_exp, k, b_dim, d, h, k + d, nan_rows)
    before = tcell.poe_sample_step_cuda.launches
    got = tcell.poe_sample_step(prods, *x, MIN_STD)
    again = tcell.poe_sample_step(prods, *x, MIN_STD)
    assert tcell.poe_sample_step_cuda.launches == before + 2
    exp = tcell.poe_sample_step_ref(prods, *x, MIN_STD)
    for i, (g, a, e) in enumerate(zip(got, again, exp)):
        assert g.shape == e.shape
        assert torch.equal(g, a), i
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


def test_step_kernel_with_the_inverse_expert(dev):
    """The step with the smoothing pass's inverse expert among the
    observations: rtol/atol 1e-4, as the cell's."""
    prods, *x = _step_inputs(dev, 4, 25, 13, 32, 24, 5, inverse=True)
    got = tcell.poe_sample_step(prods, *x, MIN_STD)
    exp = tcell.poe_sample_step_ref(prods, *x, MIN_STD)
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=str(i))


def test_step_kernel_writes_into_given_outputs(dev):
    """``out=`` receives the outputs (views into a pass's (T, B, D)
    buffers), as ``_cell_filter`` hands them over."""
    prods, *x = _step_inputs(dev, 2, 9, 6, 16, 8, 3)
    bufs = [torch.full((3, 6, 16), 7.0, device=dev) for _ in range(5)]
    z = torch.empty((9, 6, 16), device=dev)
    out = (bufs[0][1], bufs[1][1], bufs[2][1], bufs[3][1], z, bufs[4][1])
    got = tcell.poe_sample_step(prods, *x, MIN_STD, out=out)
    exp = tcell.poe_sample_step(prods, *x, MIN_STD)
    for g, o, e in zip(got, out, exp):
        assert g is o and torch.equal(g, e)
    for b in bufs:
        assert bool((b[0] == 7.0).all()) and bool((b[2] == 7.0).all())
