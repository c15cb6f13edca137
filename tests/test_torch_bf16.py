"""The port's bfloat16 codecs (``compute_dtype``, the Weizmann ``bf16``
model arg) against the JAX package's bf16 codecs on the same weights and
inputs, at the loose tolerances of tests/test_tpu_lane.py:116-119 (rtol
0.05 / atol 0.05); outputs stay float32."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer
from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.convert import tree_from_jax
from multimodal_dmm_tpu_torch.models import codecs as tc
from multimodal_dmm_tpu_torch.models import nn as tnn

from torch_parity import (leaf_errors, np_tree, port_tree, t,
                          weizmann_step)

TOL = dict(rtol=0.05, atol=0.05)
KW = dict(img_size=32, n_kernels=16)


def _close(got, exp):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **TOL)


def _images(seed, n=4, c=3, size=32):
    return np.random.RandomState(seed).rand(n, c, size, size).astype(
        np.float32)


def test_conv2d_bf16():
    p = jnn.conv2d_init(jax.random.PRNGKey(2), 3, 5)
    x = _images(3, size=8)
    exp = jnn.conv2d_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           compute_dtype=jnp.bfloat16)
    tp = tree_from_jax(np_tree({"convs": [p]}), "cpu")["convs"][0]
    got = tnn.conv2d_apply(tp, t(x), compute_dtype=torch.bfloat16)
    _close(got.permute(0, 2, 3, 1), exp)


def test_deconv2d_bf16():
    p = jnn.deconv2d_init(jax.random.PRNGKey(4), 6, 3)
    x = np.random.RandomState(5).randn(2, 6, 4, 4).astype(np.float32)
    exp = jnn.deconv2d_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             compute_dtype=jnp.bfloat16)
    tp = tree_from_jax(np_tree({"deconvs": [p]}), "cpu")["deconvs"][0]
    got = tnn.deconv2d_apply(tp, t(x), compute_dtype=torch.bfloat16)
    _close(got.permute(0, 2, 3, 1), exp)


@pytest.mark.parametrize("train", [False, True])
def test_image_encoder_bf16(train):
    jenc = jc.image_encoder_codec(8, compute_dtype=jnp.bfloat16, **KW)
    tenc = tc.image_encoder_codec(8, compute_dtype=torch.bfloat16, **KW)
    params, state = jenc.init(jax.random.PRNGKey(0))
    x = _images(1)
    (jm, js), jstate = jenc.apply(params, state, jnp.asarray(x), train)
    tp, ts = (tree_from_jax(np_tree(tr), "cpu", ("enc", "video"))
              for tr in (params, state))
    (tm, tsd), tstate = tenc.apply(tp, ts, t(x), train)
    _close(tm, jm)
    _close(tsd, js)
    for a, b in zip(tstate["bns"], jstate["bns"]):
        _close(a["mean"], b["mean"])
        _close(a["var"], b["var"])


@pytest.mark.parametrize("logits", [False, True])
def test_image_decoder_bf16(logits):
    jdec = jc.image_decoder_codec(8, compute_dtype=jnp.bfloat16, **KW)
    tdec = tc.image_decoder_codec(8, compute_dtype=torch.bfloat16, **KW)
    params, state = jdec.init(jax.random.PRNGKey(1))
    z = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    japply = jdec.apply_logits if logits else jdec.apply
    tapply = tdec.apply_logits if logits else tdec.apply
    (jout,), _ = japply(params, state, jnp.asarray(z), False)
    tp, ts = (tree_from_jax(np_tree(tr), "cpu", ("dec", "video"))
              for tr in (params, state))
    (tout,), _ = tapply(tp, ts, t(z), False)
    _close(tout, jout)


def test_bf16_codecs_round_differently_from_f32():
    """The bf16 path really runs in bfloat16: it is near the float32
    encoder's output, but not equal to it."""
    enc16 = tc.image_encoder_codec(8, compute_dtype=torch.bfloat16, **KW)
    enc32 = tc.image_encoder_codec(8, **KW)
    params, state = enc32.init(torch.Generator().manual_seed(0))
    x = t(_images(4))
    (m16, _), _ = enc16.apply(params, state, x, False)
    (m32, _), _ = enc32.apply(params, state, x, False)
    np.testing.assert_allclose(m16.numpy(), m32.numpy(), **TOL)
    assert not torch.equal(m16, m32)


@pytest.mark.parametrize("bf16", [False, True])
def test_weizmann_model_bf16_map_forward(bf16):
    """``build_model``'s ``bf16`` arg against the JAX app's: the full-size
    image codecs at narrow latent widths, MAP ``fsmooth`` forward."""
    model_args = {"z_dim": 8, "h_dim": 8, "bf16": bf16}
    args = types.SimpleNamespace(model_args=model_args, model="dmm",
                                 modalities=["video", "person", "action"])
    jmodel = WeizmannTrainer.build_model(None, JMultiDMM, args)
    tmodel = tw.build_model(args.modalities, model_args)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    rng = np.random.RandomState(3)
    inputs = {"video": rng.rand(3, 2, 3, 64, 64).astype(np.float32),
              "person": rng.randint(0, 10, (3, 2, 1)).astype(np.float32),
              "action": rng.randint(0, 10, (3, 2, 1)).astype(np.float32)}
    inputs["video"][1, 0] = np.nan
    (ji, _, jr), _ = jmodel.forward(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()},
        rng=jax.random.PRNGKey(1), mode="fsmooth", sample=False)
    with torch.no_grad():
        (ti, _, tr), _ = tmodel.forward(
            tparams, tstate, {m: t(v) for m, v in inputs.items()},
            mode="fsmooth", sample=False)
    _close(ti[0], ji[0])
    _close(ti[1], ji[1])
    for m in inputs:
        _close(tr[m][0], jr[m][0])


# A leaf of the bf16 step's gradient against the f32 step's, in relative
# Frobenius norm (chip_smoke.py's BF16_GRAD_RTOL): bf16 cotangents move the
# transition's weight gradients by several per cent in both frameworks.
BF16_GRAD_RTOL = 0.25


def test_weizmann_step_bf16_matches_jax():
    """The bf16 step (MAP, edge layout) against the JAX package's: loss
    within rtol 1e-4, each gradient leaf within BF16_GRAD_RTOL. Both
    frameworks' bf16 steps also stay within BF16_GRAD_RTOL of their f32
    steps, leaf by leaf; the largest of those errors are printed (the
    transition's weights, several per cent in each)."""
    (jl16, jg16), (tl16, tg16) = weizmann_step({"bf16": True})
    (jl32, jg32), (tl32, tg32) = weizmann_step({"bf16": False})
    np.testing.assert_allclose(tl16, jl16, rtol=1e-4)
    for name, got, exp in (("port bf16 vs JAX bf16", tg16, jg16),
                           ("JAX bf16 vs JAX f32", jg16, jg32),
                           ("port bf16 vs port f32", tg16, tg32)):
        err = leaf_errors(got, exp)
        worst = max(err, key=err.get)
        print("%s: largest leaf error %.3g at %s"
              % (name, err[worst], "/".join(map(str, worst))))
        assert err[worst] <= BF16_GRAD_RTOL, (name, worst, err[worst])
