"""The port's NN core and image codecs against the JAX package's
(models/nn.py, models/codecs.py), with the JAX weights carried across
by ``convert.tree_from_jax``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu_torch.convert import tree_from_jax
from multimodal_dmm_tpu_torch.models import codecs as tc
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bn_relu as tbn

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


def _bn_inputs(seed, c=4, spatial=(3, 3)):
    jp, js = jnn.batchnorm_init(c)
    rng = np.random.RandomState(seed)
    js = dict(js, mean=jnp.asarray(rng.randn(c).astype(np.float32)),
              var=jnp.asarray((rng.rand(c) + 0.5).astype(np.float32)))
    jp = {"scale": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5),
          "bias": jnp.asarray(rng.randn(c).astype(np.float32))}
    x = (rng.randn(6, c, *spatial) * 2 + 0.5).astype(np.float32)
    return jp, js, x


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_relu_matches_plain_and_jax(train):
    """On the CPU ``batchnorm_relu_apply`` is ``F.relu`` of
    ``batchnorm_apply`` exactly, and the JAX package's BatchNorm + ReLU to
    float32 rounding, in training and in evaluation."""
    jp, js, x = _bn_inputs(11)
    exp, exp_s = jnn.batchnorm_apply(jp, js, jnp.asarray(
        x.transpose(0, 2, 3, 1)), train)
    got, got_s = tnn.batchnorm_relu_apply(_port(jp), _port(js), t(x), train)
    plain, plain_s = tnn.batchnorm_apply(_port(jp), _port(js), t(x), train)
    assert torch.equal(got, torch.relu(plain))
    for key in ("mean", "var"):
        assert torch.equal(got_s[key], plain_s[key])
        _close(got_s[key], exp_s[key])
    assert (got > 0).any() and (got == 0).any()
    _close(got.permute(0, 2, 3, 1), jax.nn.relu(exp))


class _OneRank:
    """A ``parallel.SyncStats`` over a single rank: the sum over the ranks
    of a tensor is the tensor."""

    @staticmethod
    def all_reduce(x):
        return x


@pytest.mark.parametrize("spatial", [(3, 3), (7,)])
def test_batchnorm_relu_sync_stats_branch_unchanged(spatial):
    """Under ``SyncStats`` ``batchnorm_relu_apply`` is ``F.relu`` of
    ``batchnorm_apply``'s data-parallel branch (``_global_batchnorm``) bit
    for bit, gradients included; over one rank that branch gives the
    single-process BatchNorm."""
    jp, js, x = _bn_inputs(12, spatial=spatial)
    outs = []
    for fn, train in ((tnn.batchnorm_relu_apply, _OneRank()),
                      (tnn.batchnorm_apply, _OneRank()),
                      (tnn.batchnorm_apply, True)):
        p = {k: v.clone().requires_grad_(True)
             for k, v in _port(jp).items()}
        xg = t(x).requires_grad_(True)
        out, state = fn(p, _port(js), xg, train)
        if fn is tnn.batchnorm_apply:
            out = torch.relu(out)
        out.backward(torch.ones_like(out))
        outs.append((out, state, xg.grad, p["scale"].grad, p["bias"].grad))
    (got, got_s, *got_g), (exp, exp_s, *exp_g), single = outs
    assert torch.equal(got, exp)
    for a, b in zip(got_g, exp_g):
        assert torch.equal(a, b)
    for key in ("mean", "var"):
        assert torch.equal(got_s[key], exp_s[key])
    _close(got, single[0].detach())
    for a, b in zip(got_g, single[2:]):
        _close(a, b)


# (channels, spatial sizes) of the codecs' BatchNorm sites: the video
# codecs' 16 x 32 x 32 and 32 x 16 x 16, the audio codecs' 4 x 641 and 8 x
# 321.
BN_SITES = {"video16": (16, (32, 32)), "video32": (32, (16, 16)),
            "audio4": (4, (641,)), "audio8": (8, (321,))}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("site", sorted(BN_SITES))
def test_batchnorm_relu_cpu_at_every_site(site, channels_last, train):
    """On the CPU, at each codec site's channels and spatial sizes and in
    both layouts the convolutions give, ``batchnorm_relu_apply`` is
    ``F.relu`` of ``batchnorm_apply`` bit for bit: output, running state
    and the gradients of x, scale and bias."""
    c, spatial = BN_SITES[site]
    jp, js, x = _bn_inputs(13, c=c, spatial=spatial)
    xt = t(x[:3])
    if channels_last:
        perm = (0,) + tuple(range(2, xt.dim())) + (1,)
        xt = xt.permute(perm).contiguous().permute(
            [perm.index(d) for d in range(xt.dim())])
        assert tbn.channels_last_layout(xt) is True
    outs = []
    for relu_fn in (True, False):
        p = {k: v.clone().requires_grad_(True)
             for k, v in _port(jp).items()}
        xg = xt.clone().requires_grad_(True)
        if relu_fn:
            out, state = tnn.batchnorm_relu_apply(p, _port(js), xg, train)
        else:
            out, state = tnn.batchnorm_apply(p, _port(js), xg, train)
            out = torch.relu(out)
        out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape))
        outs.append((out, state["mean"], state["var"], xg.grad,
                     p["scale"].grad, p["bias"].grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (outs[0][0] == 0).any() and (outs[0][0] > 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("entry", ["fwd", "bwd", "train"])
def test_bn_relu_kernels_refuse_cpu_tensors(entry, dtype):
    """The kernels' entries take float32 CUDA tensors alone and raise for
    any other, before anything is built or launched."""
    x = torch.ones(2, 4, 3, dtype=dtype)
    v = torch.ones(4, dtype=dtype)
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        if entry == "fwd":
            tbn.bn_relu_fwd_cuda(x, v, v, v, v, 1e-5, 0.1)
        elif entry == "bwd":
            tbn.bn_relu_bwd_cuda(x, x, v, v, v, v)
        else:
            tbn.bn_relu_train_cuda(x, v, v, v, v, 1e-5, 0.1)


def test_bn_relu_layouts():
    """The kernels take a contiguous x (False) and a dense channels-last
    one (True) as they are, and name any other layout (None)."""
    x = torch.zeros(5, 4, 6, 7)
    assert tbn.channels_last_layout(x) is False
    assert tbn.channels_last_layout(
        x.to(memory_format=torch.channels_last)) is True
    a = torch.zeros(5, 9, 4).permute(0, 2, 1)  # (N, C, W), C fastest
    assert tbn.channels_last_layout(a) is True
    assert tbn.channels_last_layout(x.transpose(0, 1)) is None
    assert tbn.channels_last_layout(x[:, :, ::2]) is None
    assert tbn.channels_last_layout(torch.zeros(5, 1, 3)
                                    .permute(0, 2, 1)) is False
