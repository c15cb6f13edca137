"""The port's ``bf16_gtf`` (the GTF products in bfloat16) against the JAX
package's ``MultiDMM(bf16_gtf=True)`` on its ``lax.scan`` path, on the
CPU: the port's plain versions (``nn.gtf_apply_packed`` on weights packed
in bfloat16, the scan's plain forward and backward with ``bf16=True``) on
the same numpy inputs and weights carried across by ``convert``.

Tolerances. Both frameworks round at the same points (operands and
product outputs to bfloat16, to nearest even; f32 sums, biases and
elementwise ops), so they differ only where an f32 sum lies at a bfloat16
rounding midpoint and the two summation orders round it one bfloat16 ulp
apart: outputs and input gradients within ONE_ULP (2^-7, relative and
absolute on unit-scale values); measured about 1e-6 here. So that these
checks tell a port that rounds from one that does not, JAX's float32
result on the same inputs must lie SEPARATION (20) times farther from
JAX's bf16 result, in relative Frobenius norm, than the port does
(``_rounded``; measured 105 to 2.7e4 times, where a port that skipped
the rounding would read about 1 and one that skipped half of the
rounding points about 2). The weight
gradients differ on purpose: JAX rounds each step's weight-gradient
product to bfloat16 and sums the steps in bfloat16, the port sums all
rows in float32 (ROADMAP.md, Queue C); each weight leaf within
WGRAD_RTOL in relative Frobenius norm (measured 2.7e-3 to 4.2e-3, the
size of the bfloat16 running sum's error, which is also the size of the
bfloat16 effect on them, so they cannot show the rounding; the outputs
and input gradients do). The Weizmann step: the loss
within STEP_LOSS_RTOL, each leaf within BF16_GRAD_RTOL of JAX's bf16
step, and each framework's ``bf16_gtf`` step within BF16_GRAD_RTOL of its
own float32 step (chip_smoke.py's bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.convert import tree_from_jax
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from torch_parity import (leaf_errors, np_tree, port_tree, t, weizmann_step,
                          with_grad)

ONE_ULP = 2.0 ** -7
SEPARATION = 20.0
WGRAD_RTOL = 1e-2
STEP_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 0.25
T, B = 7, 5
MODS, DIMS = ["a", "b"], [4, 6]


def _models(z, h, bf16=True):
    jmodel = JMultiDMM(MODS, DIMS, z_dim=z, h_dim=h, use_pallas=False,
                       use_scan_kernel=False, bf16_gtf=bf16)
    tmodel = TMultiDMM(MODS, DIMS, z_dim=z, h_dim=h, bf16_gtf=bf16)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, _ = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, tparams


def _close(got, exp, scale=1.0):
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(exp) / scale, rtol=ONE_ULP,
                               atol=ONE_ULP)


def _rounded(got, exp, f32, scale=1.0):
    """``got`` (the port's bf16 result) within ONE_ULP of ``exp`` (JAX's),
    and JAX's float32 result ``f32`` SEPARATION times farther from
    ``exp`` than ``got`` is in relative Frobenius norm (the port's error
    floored at 1e-7), so the rounding is applied."""
    got, exp, f32 = (np.asarray(v) / scale for v in (got, exp, f32))
    _close(got, exp)
    err = float(np.linalg.norm(got - exp) / np.linalg.norm(exp))
    moved = float(np.linalg.norm(f32 - exp) / np.linalg.norm(exp))
    assert moved > SEPARATION * max(err, 1e-7), (err, moved)


def _port_trans(jgrads):
    """The transition's leaves of a JAX gradient tree, in the port's
    layout."""
    return tree_from_jax(np_tree({"trans": jgrads["trans"]}), "cpu")["trans"]


def test_gtf_apply_packed_bf16_matches_jax():
    """The packed bf16 transition at the Weizmann width on 2,500 particle
    rows, elementwise; and it differs from the f32 transition by far more
    than the two frameworks differ, so the rounding is applied."""
    _, _, jparams, tparams = _models(256, 256)
    z = np.random.RandomState(0).randn(25, 100, 256).astype(np.float32)
    jp = jnn.gtf_pack(jparams["trans"]["fwd"], compute_dtype=jnp.bfloat16)
    exp = jnn.gtf_apply_packed(jp, jnp.asarray(z), 1e-3)
    got = tnn.gtf_apply_packed(
        tnn.gtf_pack(tparams["trans"]["fwd"], torch.bfloat16), t(z), 1e-3)
    f32 = tnn.gtf_apply_packed(tnn.gtf_pack(tparams["trans"]["fwd"]), t(z),
                               1e-3)
    for g, e, f in zip(got, exp, f32):
        assert g.dtype == torch.float32
        _close(g.numpy(), e)
        err = float(np.abs(g.numpy() - np.asarray(e)).max())
        moved = float((g - f).abs().max())
        print("bf16 port vs JAX %.3g; bf16 vs f32 %.3g" % (err, moved))
        assert moved > 100 * max(err, 1e-6)


@pytest.mark.parametrize("k", [1, 25])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_z_filter_bf16_outputs_and_grads_match_jax(k, direction):
    """``z_filter`` with JAX's noise injected: the outputs, and the
    gradients of a fixed linear function of them (``jax.grad`` against
    autograd through the plain backward), of the experts and of the
    transition. Also prints each weight leaf's error of the port's and of
    JAX's bf16 gradients against JAX's f32 gradient (ROADMAP.md, Queue
    C)."""
    rng = np.random.RandomState(2 + k)
    z = 16
    zm = rng.randn(3, T, B, z).astype(np.float32)
    zs = (rng.rand(3, T, B, z) + 0.3).astype(np.float32)
    zk = (rng.rand(3, T, B) > 0.3).astype(np.float32)
    eps = rng.randn(T, k, B, z).astype(np.float32)
    cots = [rng.randn(T, B, z).astype(np.float32) for _ in range(5)]
    jout, jgrads = {}, {}
    for bf16 in (False, True):
        jmodel, tmodel, jparams, tparams = _models(z, 12, bf16)

        def jloss(p, a, b):
            out = jmodel.z_filter(p, a, b, zk, None, direction=direction,
                                  eps=jnp.asarray(eps))
            out = (*out[0], *out[1], out[2])
            return sum(jnp.sum(c * v) for c, v in zip(cots, out)), out

        (_, jout[bf16]), jgrads[bf16] = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(jparams, zm, zs)
    tp = with_grad(tparams)
    tzm, tzs = t(zm).requires_grad_(), t(zs).requires_grad_()
    out = tmodel.z_filter(tp, tzm, tzs, t(zk), direction=direction,
                          eps=t(eps))
    out = (*out[0], *out[1], out[2])
    sum((t(c) * v).sum() for c, v in zip(cots, out)).backward()
    for g, e, f in zip(out, jout[True], jout[False]):
        _rounded(g.detach().numpy(), e, f)
    for i, g in ((1, tzm.grad), (2, tzs.grad)):
        e, f = jgrads[True][i], jgrads[False][i]
        _rounded(g.numpy(), e, f, np.abs(np.asarray(e)).max())
    j16, j32 = (_port_trans(jgrads[b][0])[direction] for b in (True, False))
    for name in j16:
        for kk in ("w", "b"):
            got = tp["trans"][direction][name][kk].grad.numpy()
            e16, e32 = j16[name][kk].numpy(), j32[name][kk].numpy()
            fro = lambda a, b: float(np.linalg.norm(a - b)  # noqa: E731
                                     / np.linalg.norm(b))
            print("%s.%s: port bf16 vs JAX bf16 %.2e; vs JAX f32: port bf16 "
                  "%.2e, JAX bf16 %.2e" % (name, kk, fro(got, e16),
                                           fro(got, e32), fro(e16, e32)))
            assert fro(got, e16) <= WGRAD_RTOL, (name, kk)


def test_z_filter_grouped_bf16_matches_jax():
    """The ragged pass (particle groups 1 and 4) with injected noise."""
    jmodel, tmodel, jparams, tparams = _models(16, 12)
    rng = np.random.RandomState(4)
    zm = rng.randn(3, T, B, 16).astype(np.float32)
    zs = (rng.rand(3, T, B, 16) + 0.3).astype(np.float32)
    zk = (rng.rand(3, T, B) > 0.3).astype(np.float32)
    eps = rng.randn(T, 5, B, 16).astype(np.float32)
    exp, f32 = (m.z_filter_grouped(jparams, zm, zs, zk, jnp.asarray(eps),
                                   (1, 4), direction="bwd")
                for m in (jmodel, _models(16, 12, False)[0]))
    with torch.no_grad():
        got = tmodel.z_filter_grouped(tparams, t(zm), t(zs), t(zk), t(eps),
                                      (1, 4), direction="bwd")
    for g, e, f in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2]),
                       (*f32[0], *f32[1], f32[2])):
        _rounded(g.numpy(), e, f)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_rollout_and_z_next_bf16_match_jax(direction):
    """The prior-matching rollout without sampling (``z_sample(sample=
    False)``, T = 6 steps), and ``_z_next`` on 50 given particles, the
    rollout's step when it samples."""
    jmodel, tmodel, jparams, tparams = _models(16, 12)
    j32 = _models(16, 12, False)[0]
    exp, f32 = (m.z_sample(jparams, 6, B, jax.random.PRNGKey(1), direction,
                           sample=False) for m in (jmodel, j32))
    with torch.no_grad():
        got = tmodel.z_sample(tparams, 6, B, None, direction, sample=False)
    for g, e, f in zip(got, exp, f32):
        _rounded(g.numpy(), e, f)
    z = np.random.RandomState(5).randn(50, B, 16).astype(np.float32)
    glb = jmodel.prior_params(jparams, (B, 16))
    exp, f32 = (m._z_next(m._packed_trans(jparams, direction),
                          jnp.asarray(z), *glb) for m in (jmodel, j32))
    with torch.no_grad():
        got = tmodel._z_next(tmodel._packed_trans(tparams, direction), t(z),
                             *tmodel.prior_params(tparams, (B, 16)))
    for g, e, f in zip(got, exp, f32):
        _rounded(g.numpy(), e, f)


def test_spirals_widths_bf16_match_jax_and_padding_leaks_nothing():
    """At the spirals model's widths (z = 5, h = 20): ``z_filter`` against
    JAX; and the scan's plain bf16 forward and backward on the inputs
    zero-padded to D = 8, as the kernels get them, equal the unpadded
    ones (a zero operand adds an exact 0 to every bf16 product's sum)."""
    jmodel, tmodel, jparams, tparams = _models(5, 20)
    rng = np.random.RandomState(6)
    zm = rng.randn(2, T, B, 5).astype(np.float32)
    zs = (rng.rand(2, T, B, 5) + 0.3).astype(np.float32)
    zk = (rng.rand(2, T, B) > 0.3).astype(np.float32)
    eps = rng.randn(T, 25, B, 5).astype(np.float32)
    exp, f32 = (m.z_filter(jparams, zm, zs, zk, None, direction="bwd",
                           eps=jnp.asarray(eps))
                for m in (jmodel, _models(5, 20, False)[0]))
    with torch.no_grad():
        got = tmodel.z_filter(tparams, t(zm), t(zs), t(zk), direction="bwd",
                              eps=t(eps))
    for g, e, f in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2]),
                       (*f32[0], *f32[1], f32[2])):
        _rounded(g.numpy(), e, f)

    gtf = tparams["trans"]["fwd"]
    x = [t(zm).transpose(0, 1).contiguous(), t(zs).transpose(0, 1)
         .contiguous(), t(zk).transpose(0, 1).contiguous(),
         torch.zeros(B, 5), torch.full((B, 5), 1.001)]
    outs = tscan.bfvi_scan_fwd_ref(*x, gtf, t(eps), 1e-3, bf16=True)
    dp, hp = tscan._check_sizes(25, 5, 20)
    xp, gtf_p, eps_p = tscan._pad_scan_inputs(*x, gtf, t(eps), dp, hp)
    outs_p = tscan.bfvi_scan_fwd_ref(*xp, gtf_p, eps_p, 1e-3, bf16=True)
    for g, e in zip(outs_p, outs):
        np.testing.assert_allclose(g[..., :5].numpy(), e.numpy(), rtol=1e-6,
                                   atol=1e-6)
    cots = [t(rng.randn(T, B, 5).astype(np.float32)) for _ in range(5)]
    res = tuple(x) + (gtf, t(eps), outs[5], outs[0], outs[1])
    exp_b = tscan.bfvi_scan_bwd_ref(res, cots, 1e-3, bf16=True)
    got_b = tscan.bfvi_scan_bwd_ref(*tscan._pad_bwd_inputs(res, cots, dp, hp),
                                    1e-3, bf16=True)
    for g, e in zip(got_b[:4], exp_b[:4]):
        np.testing.assert_allclose(g[..., :5].numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-6)
    got_w = tscan._unpad_gtf(got_b[4], 5, 20)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            e = exp_b[4][name][kk]
            np.testing.assert_allclose(got_w[name][kk].numpy(), e.numpy(),
                                       rtol=1e-5,
                                       atol=1e-6 * float(e.abs().max()))


def test_weizmann_step_bf16_gtf_matches_jax():
    """The Weizmann MAP step with ``bf16_gtf`` (full-size image codecs,
    z = h = 32) against the JAX package's: the loss within
    STEP_LOSS_RTOL, each gradient leaf within BF16_GRAD_RTOL; and each
    framework's ``bf16_gtf`` step within BF16_GRAD_RTOL of its float32
    step, leaf by leaf. The largest errors are printed."""
    (jl16, jg16), (tl16, tg16) = weizmann_step({"bf16_gtf": True})
    (jl32, jg32), (tl32, tg32) = weizmann_step({"bf16_gtf": False})
    print("loss: port %.8g, JAX %.8g (bf16_gtf); f32 %.8g, %.8g"
          % (tl16, jl16, tl32, jl32))
    np.testing.assert_allclose(tl16, jl16, rtol=STEP_LOSS_RTOL)
    assert tl16 != tl32 and jl16 != jl32
    for name, got, exp in (("port bf16_gtf vs JAX bf16_gtf", tg16, jg16),
                           ("JAX bf16_gtf vs JAX f32", jg16, jg32),
                           ("port bf16_gtf vs port f32", tg16, tg32)):
        err = leaf_errors(got, exp)
        worst = max(err, key=err.get)
        print("%s: largest leaf error %.3g at %s"
              % (name, err[worst], "/".join(map(str, worst))))
        assert err[worst] <= BF16_GRAD_RTOL, (name, worst, err[worst])
