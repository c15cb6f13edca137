"""The bf16 scan kernels' launch plan, padding and weight images, on the
CPU (csrc/bf16_scan.cuh runs only on the card; what surrounds it is
Python that runs here).

- ``bf16_scan_plan`` at every shape the port launches: each batch column
  in exactly one cluster, a cluster's particle rows within one 64-row
  wgmma tile, at most 8 CTAs a cluster, each CTA within the H100's
  232,448 bytes of shared memory.
- The bf16 route pads D and H to multiples of 16: the plain bf16 forward
  and backward on the padded inputs equal the unpadded ones, and the
  port's filter at those widths agrees with the JAX package's.
- ``bf16_pack``'s images hold each weight rounded to bfloat16 exactly as
  ``nn.gtf_pack`` rounds it, at the swizzled place the kernels read.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from test_torch_bf16_gtf import _models, _rounded
from torch_parity import t

SMEM_PER_CTA = 232448  # the H100's shared memory a CTA may use

# (K, columns, D, H): the launches of the port's paths.
SHAPES = {
    # Weizmann's step: T = 25, V B = 100 columns, (M, K) = (3, 1), (3, 25),
    # (5, 1); its evaluation's MAP smoothing pass (B = 25, K = 1).
    "weizmann_k1": (1, 100, 256, 256),
    "weizmann_k25": (25, 100, 256, 256),
    "weizmann_smoothing": (1, 25, 256, 256),
    # VidTIMIT: T = 80, 75 columns, (M, K) = (2, 1), (2, 25), (4, 1).
    "vidtimit_k1": (1, 75, 256, 256),
    "vidtimit_k25": (25, 75, 256, 256),
    # Spirals: 300 columns at z = 5, h = 20.
    "spirals_k1": (1, 300, 5, 20),
    "spirals_k25": (25, 300, 5, 20),
    # The merged step's scan (2 V B columns) and the largest K.
    "merged_k25": (25, 200, 256, 256),
    "k32": (32, 45, 32, 24),
    # The widest the wrapper takes, and unaligned widths.
    "wide_k1": (1, 100, 512, 512),
    "wide_k25": (25, 100, 512, 512),
    "wide_k32": (32, 7, 512, 512),
    "unaligned_5_20_k1": (1, 45, 5, 20),
    "unaligned_5_20_k25": (25, 45, 5, 20),
    "unaligned_7_13_k1": (1, 45, 7, 13),
    "unaligned_7_13_k25": (25, 45, 7, 13),
    "narrow_b7": (1, 7, 32, 24),
}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_columns_and_fits(name, backward):
    k, b_dim, d, h = SHAPES[name]
    dp, hp = tscan._check_sizes(k, d, h, bf16=True)
    assert dp % 16 == 0 and hp % 16 == 0 and dp >= d and hp >= h
    assert dp - d < 16 and hp - h < 16
    plan = tscan.bf16_scan_plan(k, b_dim, dp, hp, backward)
    cols, c, rows = plan["cols"], plan["cluster"], plan["rows"]
    # Every column lies in exactly one group: group g holds
    # [g cols, min(B, (g + 1) cols)), as the kernels compute it.
    owner = np.full(b_dim, -1)
    for g in range(plan["groups"]):
        c0 = g * cols
        n = min(cols, b_dim - c0)
        assert n >= 1
        assert (owner[c0:c0 + n] == -1).all()
        owner[c0:c0 + n] = g
    assert (owner >= 0).all()
    # A group's particle rows fit its tile: one 64-row wgmma tile,
    # rows a multiple of 8 (the swizzle's row group).
    assert cols * k <= rows <= tscan.TILE_ROWS and rows % 8 == 0
    assert 1 <= c <= 8 and plan["ctas"] == plan["groups"] * c
    assert (dp // c) % 8 == 0 and (hp // c) % 8 == 0
    assert plan["smem"] <= SMEM_PER_CTA
    assert plan["smem"] == tscan.bf16_smem(backward, dp, hp, c, rows,
                                           plan["resident"])
    assert plan["waves"] >= 1
    # The elementwise phase is one pass of 256 threads, four d each; and
    # the most columns that fit: one more would not.
    assert cols == 1 or cols * (dp // c) <= 4 * 256
    most = min(tscan.TILE_ROWS // k, b_dim, 4 * 256 // (dp // c))
    if cols < most:
        more = -(-(cols + 1) * k // 8) * 8
        assert tscan.bf16_smem(backward, dp, hp, c, more,
                               plan["resident"]) > tscan.BF16_SMEM_LIMIT


def test_plan_routes():
    """The Weizmann widths keep the weights resident; D = H = 512 streams
    them; the plan's numbers at Weizmann's K = 25 launches."""
    fwd = tscan.bf16_scan_plan(25, 100, 256, 256)
    bwd = tscan.bf16_scan_plan(25, 100, 256, 256, backward=True)
    assert fwd["resident"] and bwd["resident"]
    assert (fwd["cols"], fwd["cluster"], fwd["rows"], fwd["groups"]) == (
        2, 8, 56, 50)
    # The backward's [d_a2 | d_sraw] shares [d_a1 | d_b1 | d_zlin]'s
    # columns (D <= H), so it holds two columns a cluster too.
    assert (bwd["cols"], bwd["rows"], bwd["groups"]) == (2, 56, 50)
    assert bwd["smem"] == fwd["smem"] == 229376
    for backward in (False, True):
        assert not tscan.bf16_scan_plan(25, 100, 512, 512,
                                        backward)["resident"]
    # The spirals widths: two CTAs a cluster (D' = 16).
    assert tscan.bf16_scan_plan(25, 300, 16, 32)["cluster"] == 2


def test_plan_refuses_what_fits_nowhere():
    """What no cluster holds, a column's K = 25 particles at D = H = 1,024
    or K = 65 particles (more than one 64-row wgmma tile), takes the wgmma
    route in both directions instead of raising; K = 0 and K past MAX_K
    still raise."""
    assert tscan._check_sizes(25, 1024, 1024, bf16=True) == (1024, 1024)
    for backward in (False, True):
        for k, d in ((25, 1024), (65, 256)):
            assert tscan.bf16_scan_plan(k, 100, d, d, backward)["route"] \
                == "wgmma"
            assert tscan._route(k, 100, d, d, True, backward, "tiled")[0] \
                == "tiled"
        assert tscan.bf16_scan_plan(25, 100, 256, 256, backward)["route"] \
            == "cluster"
    for k in (0, tscan.MAX_K + 1):
        with pytest.raises(ValueError, match="particles"):
            tscan._check_sizes(k, 256, 256, bf16=True)
    # The float32 route keeps its multiples of 4.
    assert tscan._check_sizes(25, 5, 20) == (8, 20)
    assert tscan._check_sizes(25, 5, 20, bf16=True) == (16, 32)


def _scan_inputs(rng, t_max, b_dim, d, k, n_exp=2):
    obs_std = (rng.rand(t_max, n_exp, b_dim, d) + 0.2).astype(np.float32)
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)  # a signed expert
    arrays = [rng.randn(t_max, n_exp, b_dim, d), obs_std,
              rng.rand(t_max, n_exp, b_dim) > 0.3,
              rng.randn(b_dim, d) * 0.1, rng.rand(b_dim, d) * 0.5 + 0.7,
              rng.randn(t_max, k, b_dim, d) * 0.5]
    x = [t(np.asarray(a, np.float32)) for a in arrays]
    cots = [t(rng.randn(t_max, b_dim, d).astype(np.float32))
            for _ in range(5)]
    return x[:5], x[5], cots


@pytest.mark.parametrize("d,h", [(5, 20), (12, 20)])
def test_padding_to_16_leaks_nothing(d, h):
    """The plain bf16 forward and backward on inputs zero-padded to the
    bf16 route's widths (multiples of 16) equal the unpadded ones (a zero
    operand adds an exact 0 to every product's sum; the padded dims carry
    mean 0, std 1 and zero cotangents); and at these widths the port's
    bf16 filter agrees with the JAX package's."""
    jmodel, tmodel, jparams, tparams = _models(d, h)
    rng = np.random.RandomState(11)
    tb, bb = 7, 5
    zm = rng.randn(2, tb, bb, d).astype(np.float32)
    zs = (rng.rand(2, tb, bb, d) + 0.3).astype(np.float32)
    zk = (rng.rand(2, tb, bb) > 0.3).astype(np.float32)
    eps = rng.randn(tb, 25, bb, d).astype(np.float32)
    exp, f32 = (m.z_filter(jparams, zm, zs, zk, None, direction="bwd",
                           eps=jnp.asarray(eps))
                for m in (jmodel, _models(d, h, False)[0]))
    with torch.no_grad():
        got = tmodel.z_filter(tparams, t(zm), t(zs), t(zk), direction="bwd",
                              eps=t(eps))
    for g, e, f in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2]),
                       (*f32[0], *f32[1], f32[2])):
        _rounded(g.numpy(), e, f)

    gtf = tparams["trans"]["fwd"]
    x, eps_t, cots = _scan_inputs(rng, 6, 9, d, 25)
    dp, hp = tscan._check_sizes(25, d, h, bf16=True)
    assert (dp, hp) == (16, 32)
    outs = tscan.bfvi_scan_fwd_ref(*x, gtf, eps_t, 1e-3, bf16=True)
    xp, gtf_p, eps_p = tscan._pad_scan_inputs(*x, gtf, eps_t, dp, hp)
    outs_p = tscan.bfvi_scan_fwd_ref(*xp, gtf_p, eps_p, 1e-3, bf16=True)
    for g, e in zip(outs_p, outs):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g[..., :d].numpy(), e.numpy(), rtol=1e-6,
                                   atol=1e-6)
    res = tuple(x) + (gtf, eps_t, outs[5], outs[0], outs[1])
    exp_b = tscan.bfvi_scan_bwd_ref(res, cots, 1e-3, bf16=True)
    got_b = tscan.bfvi_scan_bwd_ref(*tscan._pad_bwd_inputs(res, cots, dp, hp),
                                    1e-3, bf16=True)
    for g, e in zip(got_b[:4], exp_b[:4]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g[..., :d].numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert not g[..., d:].any()  # the padded dims' cotangents stay 0
    got_w = tscan._unpad_gtf(got_b[4], d, h)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            e = exp_b[4][name][kk]
            np.testing.assert_allclose(got_w[name][kk].numpy(), e.numpy(),
                                       rtol=1e-5,
                                       atol=1e-6 * float(e.abs().max()))


def _swizzled(img, n_rows, k_depth, off):
    """The (C, N, K) bf16 matrix at byte ``off`` of each CTA's image, each
    value read where the kernels read it: 64-deep slabs of ``n_rows``
    rows of 128 bytes, 16-byte chunk j of row n at j ^ (n % 8)."""
    n = torch.arange(n_rows)[:, None]
    k = torch.arange(k_depth)[None, :]
    words = (off // 2 + (k // 64) * n_rows * 64 + n * 64
             + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8)
    return img[:, words.reshape(-1)].contiguous().view(torch.bfloat16) \
        .float().reshape(img.shape[0], n_rows, k_depth)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("d,h", [(16, 32), (32, 48), (256, 256)])
def test_pack_equals_gtf_pack_rounding(d, h, backward):
    """Each CTA's image holds its slices of ``nn.gtf_pack(gtf, bf16)``'s
    weights (forward: rows of w1 = [gate_1; nonlin_1; z_lin] and of w2, w3;
    backward: their columns), bit for bit, each at the swizzled place
    csrc/bf16_scan.cuh reads."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(3), d, h)
    pk = tnn.gtf_pack(gtf, torch.bfloat16)
    w1, (wg2, wn2), ws = pk["w1"], pk["w2"], pk["w3"]
    c = tscan.bf16_cluster(d, h)
    ds, hs = d // c, h // c
    if backward:
        mats = [[w1[:, j * ds:(j + 1) * ds].t() for j in range(c)],
                [ws[:, j * ds:(j + 1) * ds].t() for j in range(c)],
                [wg2[:, j * hs:(j + 1) * hs].t() for j in range(c)],
                [wn2[:, j * hs:(j + 1) * hs].t() for j in range(c)]]
    else:
        mats = [[torch.cat([w1[j * hs:(j + 1) * hs],
                            w1[h + j * hs:h + (j + 1) * hs],
                            w1[2 * h + j * ds:2 * h + (j + 1) * ds]])
                 for j in range(c)]]
        mats += [[w[j * ds:(j + 1) * ds] for j in range(c)]
                 for w in (wg2, wn2, ws)]
    img = tscan.bf16_pack(gtf, d, h, backward)
    lay = tscan.bf16_layout(backward, d, h, c, 8, True)
    assert img.dtype == torch.int16 and img.shape == (c, lay["wbytes"] // 2)
    for m, (per_rank, n_rows, k_depth, off) in enumerate(
            zip(mats, lay["wn"], lay["wk"], lay["w"])):
        want = torch.stack([w.to(torch.float32) for w in per_rank])
        assert want.shape == (c, n_rows, k_depth)
        assert torch.equal(_swizzled(img, n_rows, k_depth, off), want), m


def test_autograd_packs_once(monkeypatch):
    """A ``Bf16Pack`` makes the forward's image at once and the backward's
    at its first use, once."""
    gtf = tnn.gtf_init(torch.Generator().manual_seed(4), 16, 32)
    calls = []
    real = tscan.bf16_pack
    monkeypatch.setattr(tscan, "bf16_pack",
                        lambda *a, **kw: calls.append(a[3:]) or real(*a, **kw))
    pack = tscan.Bf16Pack(gtf, 16, 32)
    assert pack.image(False) is pack.image(False)
    assert pack.image(True) is pack.image(True)
    assert calls == [(), (True,)]
