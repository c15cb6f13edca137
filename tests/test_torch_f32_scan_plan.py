"""The float32 scan kernels' launch plan, padding and weight images, on the
CPU (csrc/f32_scan.cuh runs only on the card; what chooses its route and
lays out its operands is Python that runs here).

- ``f32_scan_plan`` at every shape the port launches and at every width
  and K of tests/test_torch_scan_limits.py: the column or the wgmma route
  for each (never the tiled kernels, which run only where a caller
  names them), each CTA within the H100's 232,448 bytes of shared memory,
  the Weizmann K = 25 launch in one wave.
- ``f32_pack``'s images hold tf32(w) and tf32(w - tf32(w)) (the emulated
  split of tests/test_torch_tf32_split.py) of every weight at the place
  the kernels read it, in both directions' layouts; and the wgmma route's
  fragments of A, read as the kernel reads them, times those images give
  the products.
- Zero-padding to multiples of 4 leaks nothing: the plain versions on
  padded inputs against JAX's ``bfvi_scan_ref`` and its gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.ops.pallas import bfvi_scan as jscan
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from test_torch_scan_limits import K_CASES, _widths
from test_torch_tf32_split import tf32
from torch_parity import np_tree, t
from multimodal_dmm_tpu_torch.convert import tree_from_jax

SMEM_PER_CTA = 232448  # the H100's shared memory a CTA may use
MIN_STD = 1e-3

# (K, columns, D, H) -> the route of both directions: the main path's
# float32 scan launches.
MAIN_PATH = {
    # Weizmann's step: T = 25, V B = 100 columns, (M, K) = (3, 1), (3, 25),
    # (5, 1); its evaluation's MAP smoothing pass (T = 56, B = 25, K = 1).
    "weizmann_k1": ((1, 100, 256, 256), "wgmma"),
    "weizmann_k25": ((25, 100, 256, 256), "wgmma"),
    "weizmann_smoothing": ((1, 25, 256, 256), "wgmma"),
    # Spirals: T = 100, 300 columns at z = 5, h = 20; its smoothing pass
    # (B = 100, K = 1).
    "spirals_k1": ((1, 300, 5, 20), "column"),
    "spirals_k25": ((25, 300, 5, 20), "column"),
    "spirals_smoothing": ((1, 100, 5, 20), "column"),
    # VidTIMIT: T = 80, 75 columns, (M, K) = (2, 1), (2, 25), (4, 1); its
    # smoothing pass (B = 25, K = 1).
    "vidtimit_k1": ((1, 75, 256, 256), "wgmma"),
    "vidtimit_k25": ((25, 75, 256, 256), "wgmma"),
    "vidtimit_smoothing": ((1, 25, 256, 256), "wgmma"),
    # The K = 50 step (train_particles: 50) and the largest K.
    "weizmann_k50": ((50, 100, 256, 256), "wgmma"),
    "weizmann_k256": ((256, 25, 256, 256), "wgmma"),
}


def _check_plan(plan, k, b_dim, dp, hp, backward):
    assert plan["route"] in ("column", "wgmma")
    assert plan["waves"] >= 1
    if plan["route"] == "column":
        cols = plan["cols"]
        assert dp <= tscan.COLUMN_MAX_WIDTH and hp <= tscan.COLUMN_MAX_WIDTH
        assert 1 <= cols <= b_dim and plan["rows"] == cols * k
        assert plan["ctas"] == -(-b_dim // cols)
        assert plan["smem"] == tscan.column_smem(backward, cols * k, dp, hp)
        assert plan["smem"] <= SMEM_PER_CTA
        # Every column in exactly one CTA: CTA c holds [c cols, min(B,
        # (c + 1) cols)), as the kernels compute it.
        owner = np.full(b_dim, -1)
        for c in range(plan["ctas"]):
            n = min(cols, b_dim - c * cols)
            assert n >= 1 and (owner[c * cols:c * cols + n] == -1).all()
            owner[c * cols:c * cols + n] = c
        assert (owner >= 0).all()
    else:
        assert plan["smem"] <= SMEM_PER_CTA and plan["waves"] == 1


@pytest.mark.parametrize("name", sorted(MAIN_PATH))
def test_main_path_takes_a_new_route(name):
    (k, b_dim, d, h), route = MAIN_PATH[name]
    dp, hp = tscan._check_sizes(k, d, h)
    for backward in (False, True):
        plan = tscan.f32_scan_plan(k, b_dim, dp, hp, backward)
        assert plan["route"] == route, (name, backward, plan)
        _check_plan(plan, k, b_dim, dp, hp, backward)
        assert plan["waves"] == 1, plan


def test_plan_numbers_at_the_main_shapes():
    """Weizmann's K = 25 launch walks its time loop in one wave (one CTA
    on each SM); spirals gives each CTA one column (25 rows at K = 25),
    300 CTAs, one wave of at most 4 CTAs on each of 132 SMs."""
    p = tscan.f32_scan_plan(25, 100, 256, 256)
    assert (p["ctas"], p["threads"], p["waves"]) == (132, 288, 1)
    assert p["smem"] == 8 * 16384 + 3072 + 1024
    for backward in (False, True):
        p = tscan.f32_scan_plan(25, 300, 8, 20, backward)
        assert (p["cols"], p["rows"], p["ctas"], p["waves"]) == (1, 25, 300,
                                                                 1)
    # Where one column fits but not all columns in one wave, a CTA takes
    # more columns.
    p = tscan.f32_scan_plan(25, 1000, 8, 20)
    assert (p["route"], p["cols"], p["ctas"], p["waves"]) == ("column", 2,
                                                              500, 1)


@pytest.mark.parametrize("k", K_CASES)
def test_plan_names_a_route_for_every_width(k):
    """A route for every padded width of tests/test_torch_scan_limits.py
    (1-1,024 beside 256, equal widths, the wide transitions) at each K; the
    column route exactly where both directions have a column plan, the
    wgmma route everywhere else."""
    seen = set()
    for d, h in _widths():
        dp, hp = tscan._check_sizes(k, d, h)
        if (dp, hp) in seen:
            continue
        seen.add((dp, hp))
        fwd = tscan.f32_scan_plan(k, 100, dp, hp)
        bwd = tscan.f32_scan_plan(k, 100, dp, hp, backward=True)
        assert fwd["route"] == bwd["route"], (dp, hp)
        both = all(tscan._column_plan(k, 100, dp, hp, bw) is not None
                   for bw in (False, True))
        assert fwd["route"] == ("column" if both else "wgmma"), (dp, hp)
        _check_plan(fwd, k, 100, dp, hp, False)
        _check_plan(bwd, k, 100, dp, hp, True)
    assert tscan.f32_scan_plan(k, 100, 256, 256)["route"] == "wgmma"


def test_forced_route_and_counters():
    """A route named by the caller replaces the plan's, and a launch whose
    shape the column route does not take raises; ``f32_route`` holds its
    route (for ``bfvi_scan``) only inside its block and takes no other
    name; every route has its own counter on both wrappers."""
    assert tscan._route(25, 300, 8, 20, False, False, "tiled")[0] == "tiled"
    assert tscan._route(25, 300, 8, 20, False, True, "wgmma")[0] == "wgmma"
    assert tscan._route(1, 100, 64, 64, False, False)[0] == "wgmma"
    # past COLUMN_MAX_WIDTH, where a CTA holds a column
    assert tscan._route(1, 100, 64, 64, False, False, "column")[0] == "column"
    with pytest.raises(ValueError, match="column route"):
        tscan._route(25, 100, 256, 256, False, False, "column")
    with pytest.raises(ValueError, match="no float32 scan route"):
        tscan._route(25, 300, 8, 20, False, False, "fast")
    with pytest.raises(ValueError, match="bf16"):
        tscan._route(25, 300, 16, 32, True, False, "column")
    with tscan.f32_route("tiled"):
        with tscan.f32_route("wgmma"):
            assert tscan._FORCED_ROUTE == ["tiled", "wgmma"]
        assert tscan._FORCED_ROUTE == ["tiled"]
        # the wrappers' own plan is not moved by the block
        assert tscan._route(25, 300, 8, 20, False, False)[0] == "column"
    assert tscan._FORCED_ROUTE == []
    with pytest.raises(ValueError):
        with tscan.f32_route("fast"):
            pass
    assert tscan._FORCED_ROUTE == []
    for fn in (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda):
        for name in ("launches", "launches_column", "launches_wgmma",
                     "launches_tiled", "launches_bf16",
                     "launches_bf16_wgmma", "launches_bf16_tiled"):
            assert isinstance(getattr(fn, name), int), name


def _mats(gtf, backward):
    w = {n: gtf[n]["w"] for n in tscan.GTF_LAYERS}
    return tscan._f32_mats(w, backward)


def _unpack(img, shapes):
    """The (hi, lo) (N, K) matrices of an image, each value read where the
    kernels read it: slab s of N rows padded to 64, row n, logical
    position L (step L // 8, column L % 8) at 16-byte chunk (L // 4) ^ (n %
    8), holding depth 32 s + order[L]."""
    half = img.numel() // 2
    order = tscan._slab_order()
    out, off = [], 0
    for n_rows, k_depth in shapes:
        ns, npad = -(-k_depth // 32), -(-n_rows // 64) * 64
        n = torch.arange(n_rows)[:, None]
        k = torch.arange(k_depth)[None, :]
        s, j = k // 32, k % 32
        pos = torch.argsort(order)[j]  # the logical position of depth j
        phys = ((pos // 4) ^ (n % 8)) * 4 + pos % 4
        idx = off + (s * npad + n) * 32 + phys
        out.append((img[idx], img[half + idx]))
        # Past N and K the image holds zeros.
        mask = torch.ones(ns * npad * 32, dtype=torch.bool)
        mask[(idx - off).reshape(-1)] = False
        block = img[off:off + ns * npad * 32]
        assert not block[mask].any() and not img[half + off:][
            :ns * npad * 32][mask].any()
        off += ns * npad * 32
    assert 2 * off == img.numel()
    return out


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("d,h", [(8, 20), (64, 64), (256, 256), (464, 256)])
def test_images_hold_the_emulated_split(d, h, backward):
    """Each matrix of the image, read at the kernels' positions, is
    tf32(w) (hi) and tf32(w - tf32(w)) (lo) of the weights bit for bit,
    the emulated split of tests/test_torch_tf32_split.py."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(5), d, h)
    img = tscan.f32_pack(gtf, d, h, backward)
    mats = _mats(gtf, backward)
    shapes = [tuple(m.shape) for m in mats]
    la = 2 * h + d
    want = ([(la, d), (d, h), (d, h), (d, d)] if not backward else
            [(d, d), (h, d), (h, d), (d, h), (d, h), (d, d)])
    assert shapes == want
    for m, (hi, lo) in zip(mats, _unpack(img, shapes)):
        assert torch.equal(hi, tf32(m))
        assert torch.equal(lo, tf32(m - tf32(m)))
        assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    pack = tscan.F32Pack(gtf, d, h)
    assert torch.equal(pack.image(backward), img)


def _wgmma_emulated(a, hi, lo, n_rows, k_depth, npad):
    """What the wgmma route's consumer computes for A (M x K) against one
    matrix image (hi, lo halves of one matrix, slab-major): per 32-deep
    slab, per 8-deep step i, the A fragment of thread column q is A[r][32 s
    + 8 q + 2 i] (a[0], a[1]) and A[r][32 s + 8 q + 2 i + 1] (a[2], a[3]),
    the wgmma's columns q and q + 4, against B's logical positions 8 i + q
    and 8 i + q + 4 of the swizzled rows. Three passes, in float64."""
    ns = -(-k_depth // 32)
    a = torch.nn.functional.pad(a, (0, ns * 32 - k_depth)).double()
    a_hi = tf32(a.float()).double()
    a_lo = tf32((a - a_hi).float()).double()
    n = torch.arange(npad)[:, None]
    acc = torch.zeros((a.shape[0], npad), dtype=torch.float64)
    for s in range(ns):
        for i in range(4):
            for p in range(8):
                q, half = p % 4, p // 4
                col = 32 * s + 8 * q + 2 * i + half  # A's depth
                pos = torch.full_like(n, 8 * i + p)
                phys = ((pos // 4) ^ (n % 8)) * 4 + pos % 4
                idx = ((s * npad + n) * 32 + phys).reshape(-1)
                b_hi, b_lo = hi[idx].double(), lo[idx].double()
                acc += (a_lo[:, col:col + 1] * b_hi[None]
                        + a_hi[:, col:col + 1] * b_lo[None]
                        + a_hi[:, col:col + 1] * b_hi[None])
    return acc[:, :n_rows]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_fragments_times_images_give_the_products(backward):
    """The order of depth in the images matches the order in which a
    consumer thread reads A (8 consecutive values of a row a slab): A times
    each matrix through the emulated fragments and images equals A @ W^T
    (the forward's products) and A @ W (the backward's) to f32 accuracy,
    at depths that end inside a slab."""
    d, h = 20, 44
    gtf = tnn.gtf_init(torch.Generator().manual_seed(6), d, h)
    img = tscan.f32_pack(gtf, d, h, backward)
    half = img.numel() // 2
    gen = torch.Generator().manual_seed(7)
    off = 0
    for m in _mats(gtf, backward):
        n_rows, k_depth = m.shape
        ns, npad = -(-k_depth // 32), -(-n_rows // 64) * 64
        size = ns * npad * 32
        a = torch.randn((9, k_depth), generator=gen)
        got = _wgmma_emulated(a, img[off:off + size],
                              img[half + off:half + off + size], n_rows,
                              k_depth, npad)
        exp = a.double() @ m.double().t()
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-6,
                                   atol=1e-6)
        off += size


def _jax_case(d, h, k, seed):
    gtf = jnn.gtf_init(jax.random.PRNGKey(seed), d, h)
    rng = np.random.RandomState(seed)
    tm, n_exp, bm = 6, 3, 5
    obs_std = (rng.rand(tm, n_exp, bm, d) + 0.2).astype(np.float32)
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)  # a signed expert
    x = [rng.randn(tm, n_exp, bm, d).astype(np.float32), obs_std,
         (rng.rand(tm, n_exp, bm) > 0.4).astype(np.float32),
         (rng.randn(bm, d) * 0.1).astype(np.float32),
         (rng.rand(bm, d) * 0.5 + 0.7).astype(np.float32)]
    eps = (rng.randn(tm, k, bm, d) * 0.5).astype(np.float32)
    cots = [rng.randn(tm, bm, d).astype(np.float32) for _ in range(5)]
    return gtf, x, eps, cots


@pytest.mark.parametrize("d,h", [(5, 20), (12, 20)])
def test_padding_to_4_leaks_nothing(d, h):
    """The float32 routes run at widths padded to multiples of 4: the plain
    forward and backward on the inputs zero-padded as the wrapper pads them
    agree with JAX's ``bfvi_scan_ref`` and its gradient on the unpadded
    inputs, and the padded dims' cotangents stay 0."""
    k = 25
    dp, hp = tscan._check_sizes(k, d, h)
    assert (dp, hp) == (-(-d // 4) * 4, 20)
    assert tscan.f32_scan_plan(k, 5, dp, hp)["route"] == "column"
    gtf, x, eps, cots = _jax_case(d, h, k, 3)
    exp = jscan.bfvi_scan_ref(*x, gtf, eps, MIN_STD)
    tg = tree_from_jax(np_tree({"trans": gtf}), "cpu")["trans"]
    xp, gtf_p, eps_p = tscan._pad_scan_inputs(*map(t, x), tg, t(eps), dp, hp)
    got = tscan.bfvi_scan_fwd_ref(*xp, gtf_p, eps_p, MIN_STD)
    for g, e in zip(got, exp):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g[..., :d].numpy(), np.asarray(e),
                                   rtol=2e-4, atol=2e-5)

    def loss(om, os_, gm, gs, g):
        outs = jscan.bfvi_scan_ref(om, os_, x[2], gm, gs, g, eps, MIN_STD)
        return sum(jnp.sum(o * c) for o, c in zip(outs[:5], cots))

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x[0], x[1], x[3], x[4], gtf)
    outs = tscan.bfvi_scan_fwd_ref(*map(t, x), tg, t(eps), MIN_STD)
    res = tuple(map(t, x)) + (tg, t(eps), outs[5], outs[0], outs[1])
    got_b = tscan.bfvi_scan_bwd_ref(
        *tscan._pad_bwd_inputs(res, [t(c) for c in cots], dp, hp), MIN_STD)
    for g, e in zip(got_b[:4], (jg[0], jg[1], jg[2], jg[3])):
        e = np.asarray(e)
        scale = np.abs(e).max() + 1e-6
        np.testing.assert_allclose(g[..., :d].numpy() / scale, e / scale,
                                   rtol=2e-3, atol=2e-4)
        assert not g[..., d:].any()  # the padded dims' cotangents stay 0
    d_gtf = tscan._unpad_gtf(got_b[4], d, h)
    for name in tscan.GTF_LAYERS:
        for kk, tr in (("w", True), ("b", False)):
            e = np.asarray(jg[4][name][kk])
            g = d_gtf[name][kk].numpy()
            g = g.T if tr else g
            scale = np.abs(e).max() + 1e-6
            np.testing.assert_allclose(g / scale, e / scale, rtol=2e-3,
                                       atol=2e-4, err_msg=name + "." + kk)


def test_autograd_packs_once(monkeypatch):
    """An ``F32Pack`` makes the forward's image at once and the backward's
    at its first use, once."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(4), 64, 64)
    calls = []
    real = tscan.f32_pack
    monkeypatch.setattr(tscan, "f32_pack",
                        lambda *a, **kw: calls.append(a[3:]) or real(*a, **kw))
    pack = tscan.F32Pack(gtf, 64, 64)
    assert pack.image(False) is pack.image(False)
    assert pack.image(True) is pack.image(True)
    assert calls == [(), (True,)]
