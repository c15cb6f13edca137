"""The port's NN core and image codecs against the JAX package's
(models/nn.py, models/codecs.py), with the JAX weights carried across
by ``convert.tree_from_jax``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu_torch.convert import tree_from_jax
from multimodal_dmm_tpu_torch.models import codecs as tc
from multimodal_dmm_tpu_torch.models import nn as tnn

from torch_parity import np_tree, t

RTOL, ATOL = 1e-4, 1e-5


def _port(tree, path=()):
    return tree_from_jax(np_tree(tree), "cpu", path)


def _close(got, exp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("packed", [False, True])
def test_gtf(packed):
    z_dim, h_dim = 12, 20
    p = jnn.gtf_init(jax.random.PRNGKey(0), z_dim, h_dim)
    z = np.random.RandomState(1).randn(3, 5, z_dim).astype(np.float32)
    exp = jnn.gtf_apply(p, jnp.asarray(z), 1e-3)
    tp = _port(p)
    got = (tnn.gtf_apply_packed(tnn.gtf_pack(tp), t(z), 1e-3) if packed
           else tnn.gtf_apply(tp, t(z), 1e-3))
    _close(got[0], exp[0])
    _close(got[1], exp[1])


def test_conv2d():
    p = jnn.conv2d_init(jax.random.PRNGKey(2), 3, 5)
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    exp = jnn.conv2d_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = tnn.conv2d_apply(_port({"convs": [p]})["convs"][0], t(x))
    assert tuple(got.shape) == (2, 5, 4, 4)
    _close(got.permute(0, 2, 3, 1), exp)


@pytest.mark.parametrize("size", [2, 3, 4])
def test_deconv2d(size):
    p = jnn.deconv2d_init(jax.random.PRNGKey(4), 6, 3)
    x = np.random.RandomState(5).randn(2, 6, size, size).astype(np.float32)
    exp = jnn.deconv2d_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = tnn.deconv2d_apply(_port({"deconvs": [p]})["deconvs"][0], t(x))
    out = (size - 1) * 2 - 2 * 1 + 4  # (i - 1) * s - 2p + k
    assert tuple(got.shape) == (2, 3, out, out)
    _close(got.permute(0, 2, 3, 1), exp)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_with_running_state(train):
    jp, js = jnn.batchnorm_init(4)
    rng = np.random.RandomState(6)
    js = dict(js, mean=jnp.asarray(rng.randn(4).astype(np.float32)),
              var=jnp.asarray((rng.rand(4) + 0.5).astype(np.float32)))
    jp = {"scale": jnp.asarray(rng.rand(4).astype(np.float32) + 0.5),
          "bias": jnp.asarray(rng.randn(4).astype(np.float32))}
    x = (rng.randn(6, 4, 3, 3) * 2 + 1).astype(np.float32)
    exp, exp_s = jnn.batchnorm_apply(jp, js, jnp.asarray(
        x.transpose(0, 2, 3, 1)), train)
    got, got_s = tnn.batchnorm_apply(_port(jp), _port(js), t(x), train)
    _close(got.permute(0, 2, 3, 1), exp)
    _close(got_s["mean"], exp_s["mean"])
    _close(got_s["var"], exp_s["var"])
    assert got_s["eps"] == 1e-5 and got_s["momentum"] == 0.1


@pytest.fixture(scope="module")
def image_codecs():
    kw = dict(img_size=8, n_kernels=8)
    jenc = jc.image_encoder_codec(6, **kw)
    jdec = jc.image_decoder_codec(6, **kw)
    ep, es = jenc.init(jax.random.PRNGKey(7))
    dp, ds = jdec.init(jax.random.PRNGKey(8))
    tenc = tc.image_encoder_codec(6, **kw)
    tdec = tc.image_decoder_codec(6, **kw)
    return (jenc, jdec, ep, es, dp, ds, tenc, tdec)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_image_encoder(image_codecs, native, train):
    jenc, _, ep, es, _, _, tenc, _ = image_codecs
    x = np.random.RandomState(9).rand(5, 3, 8, 8).astype(np.float32)
    if native:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    japply = jenc.apply_native if native else jenc.apply
    tapply = tenc.apply_native if native else tenc.apply
    (jm, js), jst = japply(ep, es, jnp.asarray(x), train)
    (tm, ts), tst = tapply(_port(ep), _port(es), t(x), train)
    _close(tm, jm)
    _close(ts, js)
    for a, b in zip(tst["bns"], jst["bns"]):
        _close(a["mean"], b["mean"])
        _close(a["var"], b["var"])
    assert tenc.raw_perm == jenc.raw_perm


@pytest.mark.parametrize("logits", [False, True])
def test_image_decoder(image_codecs, logits):
    _, jdec, _, _, dp, ds, _, tdec = image_codecs
    z = np.random.RandomState(10).randn(5, 6).astype(np.float32)
    japply = jdec.apply_logits if logits else jdec.apply
    tapply = tdec.apply_logits if logits else tdec.apply
    (jo,), jst = japply(dp, ds, jnp.asarray(z), True)
    (to,), tst = tapply(_port(dp), _port(ds), t(z), True)
    assert tuple(to.shape) == jo.shape
    _close(to, jo)
    for a, b in zip(tst["bns"], jst["bns"]):
        _close(a["var"], b["var"])
    assert tdec.raw_perm == jdec.raw_perm
