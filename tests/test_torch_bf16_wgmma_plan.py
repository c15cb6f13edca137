"""The bf16 scans' wgmma route (``csrc/f32_scan.cuh``'s bf16 engine), on
the CPU: the kernels run only on the card; what chooses their route and
lays out their weights is Python that runs here, and the order in which
they sum is emulated here.

- ``bf16_scan_plan`` gives every shape with D, H up to 1,024 and K from 1
  to 256 the cluster route or the wgmma route (the wgmma route exactly
  where either direction has no cluster plan), never the tiled
  kernels, which run only where a caller names them (``bf16_route``, the
  wrappers' ``route``).
- ``bf16_wgmma_pack``'s images, read where the kernels read them, are the
  weights rounded to bfloat16 in both directions' layouts, zeros past N
  and K.
- A torch emulation of the route's products (the fragments of A as a
  consumer thread reads them, the images' stages as the producer copies
  them, slab after slab and each slab's 16-deep steps in order, each
  step's exact products added to the f32 sum, the sum rounded to
  bfloat16) gives the same bits on every tile width and row tiling the
  route uses, so the backward's recompute over all (T - 1) K B rows
  equals the forward's transition; and it holds the plain bf16 product
  within one bfloat16 ulp, 1e-3 in relative Frobenius norm (chip_smoke.py's
  BF16_GTF_RFRO of the forward).
- A shape that moved from the tiled route to the wgmma route (T = 4, D =
  16, H = 32, K = 65): the port's plain bf16 ``z_filter`` against JAX's
  ``bf16_gtf`` ``lax.scan`` path, at tests/test_torch_bf16_gtf.py's
  tolerances.
"""

import pytest
import torch

from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from test_torch_bf16_gtf import ONE_ULP
from test_torch_scan_limits import _widths, z_filter_against_jax

ROUTE_KS = (1, 25, 64, 65, 100, 256)


def _routes(k, d, h):
    fwd = tscan.bf16_scan_plan(k, 100, d, h)
    bwd = tscan.bf16_scan_plan(k, 100, d, h, backward=True)
    assert fwd["route"] == bwd["route"], (k, d, h)
    clusters = all(tscan._cluster_plan(k, 100, d, h, bw) is not None
                   for bw in (False, True))
    assert fwd["route"] == ("cluster" if clusters else "wgmma"), (k, d, h)
    if fwd["route"] == "wgmma":
        for p in (fwd, bwd):
            assert (p["ctas"], p["threads"], p["stages"], p["waves"]) == (
                tscan.F32_SMS, tscan.WGMMA_THREADS, tscan.BF16_WGMMA_STAGES,
                1)
            assert p["smem"] == tscan.BF16_WGMMA_SMEM <= tscan.BF16_SMEM_LIMIT
            assert p["bias_chunks"] == tscan.BIAS_CHUNKS
    return fwd["route"]


@pytest.mark.parametrize("k", ROUTE_KS)
def test_plan_gives_cluster_or_wgmma_at_every_width(k):
    """Every pair of padded widths 16-1,024 (multiples of 16) at K: the
    cluster route where both directions have a cluster plan, the wgmma
    route everywhere else; no K > 64 on the cluster route."""
    routes = {}
    for d in range(16, 1025, 16):
        for h in range(16, 1025, 16):
            routes[(d, h)] = _routes(k, d, h)
    assert set(routes.values()) <= {"cluster", "wgmma"}
    if k > tscan.TILE_ROWS:
        assert set(routes.values()) == {"wgmma"}
    else:
        assert routes[(256, 256)] == "cluster"
    if k == 25:  # what the tiled route took before: wide transitions
        for dh in ((768, 768), (1024, 1024), (464, 256), (592, 592)):
            assert routes[dh] == "wgmma", dh


def test_plan_gives_cluster_or_wgmma_at_every_k():
    """K from 1 to 256 at the widths of tests/test_torch_scan_limits.py
    (every width beside 256, equal widths, the wide transitions), padded
    to multiples of 16."""
    seen = set()
    for d, h in _widths():
        dp, hp = tscan._check_sizes(1, d, h, bf16=True)
        if (dp, hp) in seen:
            continue
        seen.add((dp, hp))
        for k in range(1, tscan.MAX_K + 1):
            _routes(k, dp, hp)


def test_named_routes_and_counters():
    """The tiled route runs only where named: a route named by the caller
    replaces the plan's (the cluster route where no cluster holds a column
    raises, a float32-only name too); ``bf16_route`` holds its route for
    ``bfvi_scan`` only inside its block; every route has its counter."""
    for k, d, h in ((25, 768, 768), (65, 16, 32), (100, 256, 256)):
        assert tscan._route(k, 9, d, h, True, False)[0] == "wgmma"
        for backward in (False, True):
            assert tscan._route(k, 9, d, h, True, backward,
                                "tiled")[0] == "tiled"
    assert tscan._route(25, 100, 256, 256, True, False, "wgmma")[0] == \
        "wgmma"
    assert tscan._route(25, 100, 256, 256, True, True, "cluster")[0] == \
        "cluster"
    with pytest.raises(ValueError, match="cluster route"):
        tscan._route(100, 25, 256, 256, True, False, "cluster")
    with pytest.raises(ValueError, match="no bf16 scan route"):
        tscan._route(25, 100, 256, 256, True, False, "column")
    with tscan.bf16_route("tiled"):
        with tscan.bf16_route("wgmma"):
            assert tscan._FORCED_BF16_ROUTE == ["tiled", "wgmma"]
        assert tscan._FORCED_BF16_ROUTE == ["tiled"]
        assert tscan._FORCED_ROUTE == []
        assert tscan._route(100, 25, 256, 256, True, False)[0] == "wgmma"
    assert tscan._FORCED_BF16_ROUTE == []
    with pytest.raises(ValueError):
        with tscan.bf16_route("column"):
            pass
    assert tscan._FORCED_BF16_ROUTE == []
    for fn in (tscan.bfvi_scan_fwd_cuda, tscan.bfvi_scan_bwd_cuda):
        assert isinstance(fn.launches_bf16_wgmma, int)
        assert tscan._COUNTERS[(True, "wgmma")] == "launches_bf16_wgmma"


def test_step_order_permutes_within_each_step():
    """Position p of a slab holds a depth of p's own 16-deep step, each
    once: a step sums exactly its 16 depths."""
    order = tscan._bf16_step_order()
    assert sorted(order.tolist()) == list(range(64))
    assert torch.equal(order // 16, torch.arange(64) // 16)


def _mats(gtf, backward):
    w = {n: gtf[n]["w"] for n in tscan.GTF_LAYERS}
    return tscan._f32_mats(w, backward)


def _unpack(img, shapes):
    """The (N, K) matrices of a bf16 image, each value read where the
    kernels read it (slab s of N rows padded to 128, row n, position p
    holding depth 64 s + order[p], at 16-byte chunk (p // 8) ^ (n % 8));
    asserts the image holds zeros everywhere else."""
    order = tscan._bf16_step_order()
    pos_of = torch.argsort(order)  # the position of each depth of a slab
    out, off = [], 0
    for n_rows, k_depth in shapes:
        ns, npad = -(-k_depth // 64), -(-n_rows // 128) * 128
        n = torch.arange(n_rows)[:, None]
        k = torch.arange(k_depth)[None, :]
        pos = pos_of[k % 64]
        phys = ((pos // 8) ^ (n % 8)) * 8 + pos % 8
        idx = off + ((k // 64) * npad + n) * 64 + phys
        out.append(img[idx])
        rest = torch.ones(ns * npad * 64, dtype=torch.bool)
        rest[(idx - off).reshape(-1)] = False
        assert not img[off:off + ns * npad * 64][rest].any()
        off += ns * npad * 64
    assert off == img.numel()
    return out


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("d,h", [(16, 32), (48, 80), (256, 256),
                                 (464, 256), (768, 768)])
def test_images_unpack_to_the_rounded_weights(d, h, backward):
    """Each matrix of the image, read at the kernels' positions, is the
    weight rounded to bfloat16 bit for bit (``nn.gtf_pack``'s rounding):
    the forward's w1 = [gate_1; nonlin_1; z_lin], gate_2, nonlin_2,
    z_to_std as they are, the backward's their transposes; a
    ``Bf16WgPack`` packs once per direction."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(d + h), d, h)
    img = tscan.bf16_wgmma_pack(gtf, d, h, backward)
    assert img.dtype == torch.int16
    mats = _mats(gtf, backward)
    for m, got in zip(mats, _unpack(img.view(torch.bfloat16),
                                    [tuple(m.shape) for m in mats])):
        assert torch.equal(got, m.to(torch.bfloat16))
    pack = tscan.Bf16WgPack(gtf, d, h)
    assert torch.equal(pack.image(backward), img)
    assert pack.image(backward) is pack.image(backward)


def _stage(img_mat, npad, s, n0, bn):
    """The stage that the producer copies for slab s of a tile's rows
    [n0, n0 + bn): bn 128-byte rows of the image, as (bn, 64)."""
    start = (s * npad + n0) * 64
    return img_mat[start:start + bn * 64].reshape(bn, 64)


def emulate_product(a, img_mat, n_rows, k_depth, bn, tile_rows=128):
    """What the route's consumers compute for A (M x K, float32) against
    one matrix's bf16 image, pre-bias: per tile of ``tile_rows`` rows and
    ``bn`` columns, per 64-deep slab s (the stage of ``_stage``), per
    16-deep step i (all four: past K the image and A hold zeros, which
    add exact zeros), the column w of the wgmma takes from a thread of
    column q = (w % 8) // 2 of A its value at depth 64 s + 16 i + 4 q +
    2 (w // 8) + w % 2 (fragments a[0], a[2]), rounded to bfloat16, and
    from the stage's row r the value at logical position 16 i + w in the
    swizzle of row r % 8; the step's 16 exact products are summed in
    float64 and added to the f32 sum (one rounding a step); the sum is
    rounded to bfloat16 (``epi_pair<true>``)."""
    m = a.shape[0]
    npad = -(-n_rows // 128) * 128
    ns = -(-k_depth // 64)
    ab = torch.nn.functional.pad(a, (0, ns * 64 - k_depth)).to(
        torch.bfloat16).double()
    w = torch.arange(16)
    a_depth = 4 * ((w % 8) // 2) + 2 * (w // 8) + w % 2
    out = torch.zeros((m, n_rows), dtype=torch.float32)
    for m0 in range(0, m, tile_rows):
        rows = ab[m0:m0 + tile_rows]
        for n0 in range(0, n_rows, bn):
            acc = torch.zeros((rows.shape[0], bn), dtype=torch.float32)
            r = torch.arange(bn)[:, None]
            for s in range(ns):
                stage = _stage(img_mat, npad, s, n0, bn).double()
                for i in range(4):
                    p = 16 * i + w[None, :]
                    phys = ((p // 8) ^ (r % 8)) * 8 + p % 8
                    b = torch.gather(stage, 1, phys)  # (bn, 16)
                    av = rows[:, 64 * s + 16 * i + a_depth]  # (rows, 16)
                    acc = (acc.double() + av @ b.t()).float()
            n1 = min(n_rows, n0 + bn)
            out[m0:m0 + tile_rows, n0:n1] = acc[:, :n1 - n0]
    return out.to(torch.bfloat16).float()


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("d,h", [(16, 32), (48, 80)])
def test_emulated_order_is_one_on_every_tile_and_holds_the_plain(d, h,
                                                                 backward):
    """Each product of a direction through ``emulate_product``: the same
    bits at every tile width (8-128) and row tiling (128-row tiles of M
    rows, and of a block of them taken alone, as the forward's R rows sit
    in the backward's (T - 1) R), so the recompute equals the forward;
    and within one bfloat16 ulp of the plain bf16 product, 1e-3 in
    relative Frobenius norm, where the plain one sums in another f32
    order."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(7), d, h)
    img = tscan.bf16_wgmma_pack(gtf, d, h, backward).view(torch.bfloat16)
    gen = torch.Generator().manual_seed(8)
    off = 0
    for m in _mats(gtf, backward):
        n_rows, k_depth = m.shape
        size = -(-k_depth // 64) * (-(-n_rows // 128) * 128) * 64
        img_mat = img[off:off + size]
        off += size
        a = torch.randn((300, k_depth), generator=gen)
        base = emulate_product(a, img_mat, n_rows, k_depth, 64)
        for bn in (8, 16, 32, 128):
            assert torch.equal(emulate_product(a, img_mat, n_rows, k_depth,
                                               bn), base), bn
        part = emulate_product(a[128:228], img_mat, n_rows, k_depth, 16)
        assert torch.equal(part, base[128:228])
        rb = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
        plain = rb(rb(a) @ rb(m).t())
        diff = (base - plain).abs()
        assert bool((diff <= ONE_ULP * plain.abs() + 1e-30).all())
        assert ((base - plain).norm() / plain.norm()).item() <= 1e-3


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_z_filter_65_particles_matches_jax(direction):
    """T = 4, D = 16, H = 32, K = 65: a bf16 launch that the plan gave the
    tiled route and now gives the wgmma route; the port's plain bf16
    ``z_filter`` (JAX's noise injected) against JAX's ``bf16_gtf``
    ``lax.scan`` path, outputs and gradients at
    tests/test_torch_bf16_gtf.py's tolerances."""
    k, z, h, t_max = 65, 16, 32, 4
    dp, hp = tscan._check_sizes(k, z, h, bf16=True)
    assert tscan.bf16_scan_plan(k, 5, dp, hp)["route"] == "wgmma"
    assert tscan._bf16_plan(k, 5, dp, hp, False, "tiled")["route"] == "tiled"
    z_filter_against_jax(k, z, h, True, direction, t_max=t_max)
