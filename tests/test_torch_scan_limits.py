"""The scan kernels take every width and particle count that the JAX
package's filter takes, on the CPU (the kernels run only on the card;
what chooses their route and pads their inputs is Python that runs here).

- ``_check_sizes`` accepts, on the float32 and the bf16 routes, every
  width up to 1,024 at K from 1 to 256, and ``bf16_scan_plan`` names a
  route for each: the cluster route where both directions fit one
  cluster's shared memory, the wgmma route elsewhere (the tiled route
  where a caller names it).
- The port's ``z_filter`` with 50 particles matches the JAX package's, in
  float32 and with ``bf16_gtf``, outputs and gradients, at the tolerances
  of tests/test_torch_bfvi_scan.py and tests/test_torch_bf16_gtf.py.
- ``gtf_wgrad_bf16_ref``, the bf16 weight-gradient kernel's input form
  (rows in bfloat16, partials of the float32 bias sums), equals
  ``gtf_wgrad_ref(..., bf16=True)`` on the same rows bit for bit.
- Zero-padding to the bf16 wgmma and tiled routes' widths leaks nothing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from test_torch_bf16_gtf import WGRAD_RTOL, _models, _port_trans, _rounded
from torch_parity import t, with_grad

K_CASES = (1, 25, 32, 33, 50, 64, 65, 100, 256)
WIDE = ((464, 256), (592, 592), (768, 768), (256, 1024))
T, B = 7, 5


def _widths():
    """(D, H) pairs: every width 1-1,024 beside 256 on either side, equal
    widths, and wide transitions that no cluster holds at some K."""
    out = set(WIDE)
    for w in range(1, 1025):
        out.update({(w, 256), (256, w)})
    for w in range(16, 1025, 16):
        out.add((w, w))
    return sorted(out)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", K_CASES)
def test_check_sizes_takes_every_width_and_k(k, bf16):
    m = 16 if bf16 else 4
    for d, h in _widths():
        dp, hp = tscan._check_sizes(k, d, h, bf16)
        assert dp % m == 0 and hp % m == 0, (d, h)
        assert d <= dp < d + m and h <= hp < h + m, (d, h)


@pytest.mark.parametrize("k", K_CASES)
def test_plan_names_its_route(k):
    """A route for every padded width 16-1,024 (z = h, and either at 256)
    and for the wide transitions; the cluster route exactly where both
    directions have a cluster plan (no K > 64: a column's particles in
    one 64-row tile), each cluster plan within one CTA's shared memory;
    the wgmma route everywhere else, the tiled route only where named."""
    routes = {}
    for d, h in _widths():
        dp, hp = tscan._check_sizes(k, d, h, bf16=True)
        if (dp, hp) in routes:
            continue
        fwd = tscan.bf16_scan_plan(k, 100, dp, hp)
        bwd = tscan.bf16_scan_plan(k, 100, dp, hp, backward=True)
        assert fwd["route"] == bwd["route"] in ("cluster", "wgmma")
        both = all(tscan._cluster_plan(k, 100, dp, hp, bw) is not None
                   for bw in (False, True))
        assert (fwd["route"] == "cluster") == both, (dp, hp)
        if fwd["route"] == "cluster":
            for p in (fwd, bwd):
                assert p["cols"] * k <= p["rows"] <= tscan.TILE_ROWS
                assert p["smem"] <= tscan.BF16_SMEM_LIMIT
        else:
            assert fwd["bias_chunks"] == tscan.BIAS_CHUNKS
            named = tscan._bf16_plan(k, 100, dp, hp, False, "tiled")
            assert named["route"] == "tiled"
            assert named["bias_chunks"] == tscan.BIAS_CHUNKS
        routes[(dp, hp)] = fwd["route"]
    if k > tscan.TILE_ROWS:
        assert set(routes.values()) == {"wgmma"}
    if k == 25:  # widths whose operands no cluster holds at K = 25
        for d, h in WIDE[:3]:
            assert routes[(d, h)] == "wgmma", (d, h)
    if k <= 25:
        assert routes[(256, 256)] == "cluster"


def _filter_case(rng, k, z, t_max=T):
    zm = rng.randn(3, t_max, B, z).astype(np.float32)
    zs = (rng.rand(3, t_max, B, z) + 0.3).astype(np.float32)
    zk = (rng.rand(3, t_max, B) > 0.3).astype(np.float32)
    eps = rng.randn(t_max, k, B, z).astype(np.float32)
    cots = [rng.randn(t_max, B, z).astype(np.float32) for _ in range(5)]
    return zm, zs, zk, eps, cots


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_gtf"])
def test_z_filter_50_particles_matches_jax(bf16, direction):
    """``z_filter`` with ``train_particles = 50``'s K and JAX's noise
    injected, narrow widths: the outputs and the gradients of a fixed
    linear function of them (the experts' and the transition's), against
    ``jax.grad`` of the JAX package's filter. float32: outputs at rtol
    1e-4, atol 1e-5 (tests/test_torch_dmm.py), gradients at rtol 2e-3,
    atol 2e-4 of their largest value (tests/test_torch_bfvi_scan.py).
    ``bf16_gtf``: tests/test_torch_bf16_gtf.py's, outputs and input
    gradients within one bfloat16 ulp with JAX's float32 result far
    farther (``_rounded``), each weight leaf within WGRAD_RTOL."""
    z_filter_against_jax(50, 16, 12, bf16, direction)


def z_filter_against_jax(k, z, hd, bf16, direction, t_max=T):
    """The check of ``test_z_filter_50_particles_matches_jax`` at K
    particles, widths (z, hd) and ``t_max`` steps."""
    rng = np.random.RandomState(50)
    zm, zs, zk, eps, cots = _filter_case(rng, k, z, t_max)
    jout, jgrads = {}, {}
    for b in (False, True):
        jmodel, tmodel, jparams, tparams = _models(z, hd, b)

        def jloss(p, a, s):
            out = jmodel.z_filter(p, a, s, zk, None, direction=direction,
                                  eps=jnp.asarray(eps))
            out = (*out[0], *out[1], out[2])
            return sum(jnp.sum(c * v) for c, v in zip(cots, out)), out

        (_, jout[b]), jgrads[b] = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(jparams, zm, zs)
        if b == bf16:
            port = tmodel, tparams
    tmodel, tparams = port
    tp = with_grad(tparams)
    tzm, tzs = t(zm).requires_grad_(), t(zs).requires_grad_()
    out = tmodel.z_filter(tp, tzm, tzs, t(zk), direction=direction,
                          eps=t(eps))
    out = (*out[0], *out[1], out[2])
    sum((t(c) * v).sum() for c, v in zip(cots, out)).backward()
    jtrans = _port_trans(jgrads[bf16][0])[direction]
    weights = [(tp["trans"][direction][name][kk].grad.numpy(),
                jtrans[name][kk].numpy(), (name, kk))
               for name in jtrans for kk in ("w", "b")]
    if bf16:
        for g, e, f in zip(out, jout[True], jout[False]):
            _rounded(g.detach().numpy(), e, f)
        for i, g in ((1, tzm.grad), (2, tzs.grad)):
            e, f = jgrads[True][i], jgrads[False][i]
            _rounded(g.numpy(), e, f, np.abs(np.asarray(e)).max())
        for got, exp, leaf in weights:
            assert _fro(got, exp) <= WGRAD_RTOL, leaf
        return
    for g, e in zip(out, jout[False]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(e),
                                   rtol=1e-4, atol=1e-5)
    grads = [(tzm.grad.numpy(), jgrads[False][1], "obs_mean"),
             (tzs.grad.numpy(), jgrads[False][2], "obs_std")] + weights
    for got, exp, leaf in grads:
        exp = np.asarray(exp)
        scale = np.abs(exp).max() + 1e-6
        np.testing.assert_allclose(got / scale, exp / scale, rtol=2e-3,
                                   atol=2e-4, err_msg=str(leaf))


def _rows(rng, n_rows, d, h):
    z = t(rng.randn(n_rows, d).astype(np.float32))
    xs = t(np.abs(rng.randn(n_rows, 2 * h + d)).astype(np.float32))
    ys = t(rng.randn(n_rows, 2 * h + 4 * d).astype(np.float32))
    return z, xs, ys


def _bias_part(ys, d, h):
    """One partial of the float32 cotangents' sums, as ``gtf_wgrad_ref``
    takes them (each block's sum over the rows)."""
    return torch.cat([b.sum(0) for b in torch.split(
        ys, [2 * h + d, d, d, d], dim=1)])[None]


@pytest.mark.parametrize("d,h", [(16, 12), (5, 20), (256, 256)])
def test_wgrad_bf16_form_equals_old_form(d, h):
    """The bf16 kernel's input form, rows in bfloat16 and the bias sums as
    partials, gives ``gtf_wgrad_ref(..., bf16=True)``'s gradients bit for
    bit on the same rows; with the sums cut into partials, the bias
    gradients to float32 rounding."""
    rng = np.random.RandomState(d + h)
    n_rows = 3 * 7 * 5
    z, xs, ys = _rows(rng, n_rows, d, h)
    z_traj = torch.cat([z, torch.zeros(7 * 5, d)]).reshape(4, 7, 5, d)
    old = tscan.gtf_wgrad_ref(z_traj, xs, ys, bf16=True)
    bf = lambda x: x.to(torch.bfloat16)  # noqa: E731
    new = tscan.gtf_wgrad_bf16_ref(bf(z), bf(xs), bf(ys),
                                   _bias_part(ys, d, h))
    parts = torch.cat([_bias_part(c, d, h) for c in torch.split(ys, 40)])
    split = tscan.gtf_wgrad_bf16_ref(bf(z), bf(xs), bf(ys), parts)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            assert new[name][kk].shape == old[name][kk].shape
            assert torch.equal(new[name][kk], old[name][kk]), (name, kk)
        assert torch.equal(split[name]["w"], old[name]["w"])
        torch.testing.assert_close(split[name]["b"], old[name]["b"],
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d,h", [(5, 20), (12, 20)])
def test_tiled_route_padding_leaks_nothing(d, h):
    """At K = 65, which the wgmma route takes (and the tiled route, where
    named), padded as both pad: the plain bf16 forward and
    backward on the inputs zero-padded to its widths (multiples of 16)
    equal the unpadded ones; and the bf16 weight-gradient form on the rows
    and bias partials padded as the wrapper pads them (``_pad_blocks``)
    equals the unpadded one (a zero operand adds an exact 0 to every
    product's sum)."""
    k = 65
    dp, hp = tscan._check_sizes(k, d, h, bf16=True)
    assert (dp, hp) == (16, 32)
    assert tscan.bf16_scan_plan(k, 9, dp, hp)["route"] == "wgmma"
    assert tscan._bf16_plan(k, 9, dp, hp, False, "tiled")["route"] == "tiled"
    rng = np.random.RandomState(d)
    gtf = _models(d, h)[3]["trans"]["fwd"]
    n_exp, tm, bm = 2, 5, 3
    obs_std = (rng.rand(tm, n_exp, bm, d) + 0.2).astype(np.float32)
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)
    x = [t(np.asarray(a, np.float32)) for a in (
        rng.randn(tm, n_exp, bm, d), obs_std, rng.rand(tm, n_exp, bm) > 0.3,
        rng.randn(bm, d) * 0.1, rng.rand(bm, d) * 0.5 + 0.7)]
    eps = t(rng.randn(tm, k, bm, d).astype(np.float32))
    cots = [t(rng.randn(tm, bm, d).astype(np.float32)) for _ in range(5)]
    outs = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3, bf16=True)
    xp, gtf_p, eps_p = tscan._pad_scan_inputs(*x, gtf, eps, dp, hp)
    outs_p = tscan.bfvi_scan_fwd_ref(*xp, gtf_p, eps_p, 1e-3, bf16=True)
    for g, e in zip(outs_p, outs):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g[..., :d].numpy(), e.numpy(), rtol=1e-6,
                                   atol=1e-6)
    res = tuple(x) + (gtf, eps, outs[5], outs[0], outs[1])
    exp_b = tscan.bfvi_scan_bwd_ref(res, cots, 1e-3, bf16=True)
    got_b = tscan.bfvi_scan_bwd_ref(*tscan._pad_bwd_inputs(res, cots, dp, hp),
                                    1e-3, bf16=True)
    for g, e in zip(got_b[:4], exp_b[:4]):
        np.testing.assert_allclose(g[..., :d].numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert not g[..., d:].any()

    z, xs, ys = _rows(rng, 4 * k * bm, d, h)
    bf = lambda v: v.to(torch.bfloat16)  # noqa: E731
    parts = torch.cat([_bias_part(c, d, h) for c in torch.split(ys, 100)])
    exp_w = tscan.gtf_wgrad_bf16_ref(bf(z), bf(xs), bf(ys), parts)
    blocks = ((h, h) + (d,) * 4, (hp, hp) + (dp,) * 4)
    got_w = tscan._unpad_gtf(tscan.gtf_wgrad_bf16_ref(
        tscan._pad_last(bf(z), dp),
        tscan._pad_blocks(bf(xs), (h, h, d), (hp, hp, dp)),
        tscan._pad_blocks(bf(ys), *blocks),
        tscan._pad_blocks(parts, *blocks)), d, h)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            e = exp_w[name][kk]
            np.testing.assert_allclose(got_w[name][kk].numpy(), e.numpy(),
                                       rtol=1e-5,
                                       atol=1e-6 * float(e.abs().max()))
