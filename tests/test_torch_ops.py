"""The port's expert fusion, losses and schedules against the JAX
package's (ops/poe.py, ops/losses.py, ops/schedules.py) on the same
numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.ops import losses as jl
from multimodal_dmm_tpu.ops import poe as jp
from multimodal_dmm_tpu.ops.schedules import anneal as j_anneal
from multimodal_dmm_tpu_torch.ops import losses as tl
from multimodal_dmm_tpu_torch.ops import poe as tp
from multimodal_dmm_tpu_torch.ops.schedules import anneal as t_anneal

from torch_parity import t

RTOL, ATOL = 1e-5, 1e-6


def _experts(seed=0, m=4, b=5, d=7):
    rng = np.random.RandomState(seed)
    mean = rng.randn(m, b, d).astype(np.float32)
    std = (rng.rand(m, b, d) + 0.1).astype(np.float32)
    std[1] *= -0.5  # an inverse expert
    mask = rng.rand(m, b) > 0.3
    mean[~mask] = np.nan  # excluded experts may hold NaN
    return mean, std, mask


def _close(got, exp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("use_mask", [True, False])
def test_product_of_experts(use_mask):
    mean, std, mask = _experts()
    if not use_mask:
        std[~mask] = np.nan  # mask=None excludes NaN-std experts
    m_arg = mask if use_mask else None
    exp = jp.product_of_experts(jnp.asarray(mean), jnp.asarray(std),
                                None if m_arg is None else jnp.asarray(m_arg))
    got = tp.product_of_experts(t(mean), t(std),
                                None if m_arg is None else t(m_arg))
    _close(got[0], exp[0], rtol=1e-4)
    _close(got[1], exp[1], rtol=1e-4)


def test_inverse_expert_cancels():
    """[e0, e1, inverse-e1] gives e0."""
    rng = np.random.RandomState(3)
    e_mean = rng.randn(2, 4, 6).astype(np.float32)
    e_std = (rng.rand(2, 4, 6) + 0.5).astype(np.float32)
    mean = np.concatenate([e_mean, e_mean[1:]])
    std = np.concatenate([e_std, -e_std[1:]])
    got_m, got_s = tp.product_of_experts(t(mean), t(std))
    np.testing.assert_allclose(got_m.numpy(), e_mean[0], atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), e_std[0], rtol=1e-5,
                               atol=1e-6)


def test_prec_floor():
    """A total precision below 1e-6 gives mean 0 and std 1e3."""
    mean = np.ones((2, 1, 3), np.float32)
    std = np.array([[[1.0] * 3], [[-1.0] * 3]], np.float32)
    got_m, got_s = tp.product_of_experts(t(mean), t(std))
    np.testing.assert_array_equal(got_m.numpy(), 0.0)
    np.testing.assert_allclose(got_s.numpy(), 1e3)


def test_product_of_experts_pair_and_mean_of_experts():
    mean, std, mask = _experts(1)
    std = np.abs(std)
    mean = np.nan_to_num(mean)
    exp = jp.product_of_experts_pair(mean[0], std[0], mean[1:], std[1:])
    got = tp.product_of_experts_pair(t(mean[0]), t(std[0]), t(mean[1:]),
                                     t(std[1:]))
    for g, e in zip(got, exp):
        _close(g, e, rtol=1e-4)
    exp = jp.mean_of_experts(jnp.asarray(mean), jnp.asarray(std),
                             jnp.asarray(mask))
    got = tp.mean_of_experts(t(mean), t(std), t(mask))
    for g, e in zip(got, exp):
        _close(g, e, rtol=1e-4)


def _targets(seed, shape, nan_frac=0.2):
    rng = np.random.RandomState(seed)
    x = (rng.rand(*shape) > 0.5).astype(np.float32)
    x[rng.rand(*shape) < nan_frac] = np.nan
    mask = (rng.rand(*shape[:2], 1) > 0.2).astype(np.float32)
    return rng, x, mask


def test_kld_gauss():
    rng = np.random.RandomState(4)
    a = [rng.randn(5, 3, 4).astype(np.float32) for _ in range(2)]
    s = [(rng.rand(5, 3, 4) + 0.1).astype(np.float32) for _ in range(2)]
    mask = (rng.rand(5, 3, 1) > 0.3).astype(np.float32)
    a[0][mask[..., 0] == 0] = np.inf  # masked positions may be non-finite
    exp = jl.kld_gauss(a[0], s[0], a[1], s[1], mask)
    got = tl.kld_gauss(t(a[0]), t(s[0]), t(a[1]), t(s[1]), t(mask))
    _close(got, exp, rtol=1e-5)


def test_bernoulli_losses_and_grads():
    rng, x, mask = _targets(5, (4, 3, 6))
    logits = rng.randn(4, 3, 6).astype(np.float32) * 3
    probs = 1 / (1 + np.exp(-logits))
    _close(tl.nll_bernoulli(t(probs), t(x), t(mask)),
           jl.nll_bernoulli(probs, x, mask), rtol=1e-5)
    lg_t = t(logits).requires_grad_()
    got = tl.nll_bernoulli_logits(lg_t, t(x), t(mask))
    got.backward()
    exp, exp_g = jax.value_and_grad(jl.nll_bernoulli_logits)(
        jnp.asarray(logits), jnp.asarray(x), jnp.asarray(mask))
    _close(got, exp, rtol=1e-5)
    _close(lg_t.grad, exp_g, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(lg_t.grad).all()


def test_bce_logits_masked_sum_value_and_grad():
    """The autograd.Function equals the JAX custom VJP, and its gradient
    is finite where the masked targets are NaN."""
    rng, x, mask = _targets(6, (4, 1, 3, 6))
    lg = rng.randn(4, 2, 3, 6).astype(np.float32) * 4
    lg[0, 0, 0, 0] = 150.0  # clamp region
    obs = ~np.isnan(x)
    xs = np.where(obs, x, 0.0).astype(np.float32)
    cm = (obs * mask[:, None]).astype(np.float32)
    cm = np.broadcast_to(cm, x.shape).copy()
    exp, exp_g = jax.value_and_grad(jl.bce_logits_masked_sum)(
        jnp.asarray(lg), jnp.asarray(xs), jnp.asarray(cm))
    lg_t = t(lg).requires_grad_()
    got = tl.bce_logits_masked_sum(lg_t, t(xs), t(cm))
    got.backward()
    _close(got, exp, rtol=1e-5)
    _close(lg_t.grad, exp_g, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(lg_t.grad).all()


def test_categorical_and_gauss_losses_with_nan_targets():
    rng = np.random.RandomState(7)
    probs = rng.rand(5, 3, 4).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels = rng.randint(0, 4, (5, 3, 1)).astype(np.float32)
    labels[1, 2] = np.nan
    mask = (rng.rand(5, 3, 1) > 0.2).astype(np.float32)
    _close(tl.nll_categorical(t(probs), t(labels), t(mask)),
           jl.nll_categorical(probs, labels, mask))
    mean = rng.randn(5, 3, 4).astype(np.float32)
    std = (rng.rand(5, 3, 4) + 0.2).astype(np.float32)
    x = rng.randn(5, 3, 4).astype(np.float32)
    x[0, 0] = np.nan
    mean_t = t(mean).requires_grad_()
    got = tl.nll_gauss(mean_t, t(std), t(x), t(mask))
    got.backward()
    _close(got, jl.nll_gauss(mean, std, x, mask), rtol=1e-5)
    assert torch.isfinite(mean_t.grad).all()


@pytest.mark.parametrize("step", [0, 10, 99, 100, 250])
def test_anneal(step):
    assert t_anneal(0.0, 1.0, step, 100) == pytest.approx(
        j_anneal(0.0, 1.0, step, 100))
