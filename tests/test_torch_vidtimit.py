"""The port's VidTIMIT app against the JAX package's: the 1-D
convolutions (float32 and bfloat16), the audio codecs, the 1-D layouts of
``convert`` and checkpoints in both directions, the spectrogram transform
and the fixture generator, the dataset and its sa1/sa2 split, ``eval_ccc``,
the audio-video model's MAP forward and fused step, the app's metrics,
and its command line on the CPU. The same numpy inputs and the JAX
weights (``convert.params_from_jax``) go through both packages.

Tolerances: float32 layers and codecs rtol 1e-4 / atol 1e-5; bfloat16 at
tests/test_tpu_lane.py:116-119's rtol 0.05 / atol 0.05; the spectrogram
transform 1e-6; the step's loss rtol 1e-4 and its gradients, each leaf
divided by its largest value, rtol 5e-3 / atol 5e-4; metrics rtol 1e-4 /
atol 1e-6."""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.apps.vidtimit import VidTIMITTrainer as JTrainer
from multimodal_dmm_tpu.data import vidtimit as jvid
from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models import get_model as jget_model
from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.ops.metrics import eval_ccc as jccc
from multimodal_dmm_tpu.training import checkpoint as jck
from multimodal_dmm_tpu_torch.apps import vidtimit as tv
from multimodal_dmm_tpu_torch.convert import params_to_jax, tree_from_jax
from multimodal_dmm_tpu_torch.data import vidtimit as tvid
from multimodal_dmm_tpu_torch.models import codecs as tc
from multimodal_dmm_tpu_torch.models import get_model as tget_model
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.metrics import eval_ccc
from multimodal_dmm_tpu_torch.training import checkpoint as tck
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

from test_torch_ragged import _inject
from torch_parity import (assert_trees_close, grads_of, np_tree, port_tree,
                          t, with_grad)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)
GRAD = dict(rtol=5e-3, atol=5e-4)
METRIC = dict(rtol=1e-4, atol=1e-6)
MODS = ["video", "audio"]
ZH = 8          # the model tests' latent and hidden widths
T, B = 4, 3     # the model tests' batch


def _close(got, exp, tol=F32):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **tol)


def _port(tree, path=()):
    return tree_from_jax(np_tree(tree), "cpu", path)


# ---------------------------------------------------------------------------
# 1-D convolutions and the audio codecs
# ---------------------------------------------------------------------------

# (JAX init, JAX apply, port apply, tree key, c_in, c_out, width, out width)
LAYERS = {"conv": (jnn.conv1d_init, jnn.conv1d_apply, tnn.conv1d_apply,
                   "convs", 10, 4, 1281, 641),
          "deconv": (jnn.deconv1d_init, jnn.deconv1d_apply,
                     tnn.deconv1d_apply, "deconvs", 16, 8, 161, 321)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_conv1d_layers_match_jax(layer, bf16):
    """The audio codecs' first layers at their widths: 1281 -> 641 and
    161 -> 321 (out = 2 in - 1, no output padding)."""
    jinit, japply, tapply, key, c_in, c_out, w, w_out = LAYERS[layer]
    p = jinit(jax.random.PRNGKey(3), c_in, c_out)
    x = np.random.RandomState(4).randn(2, c_in, w).astype(np.float32)
    exp = japply(p, jnp.asarray(x.transpose(0, 2, 1)),
                 compute_dtype=jnp.bfloat16 if bf16 else None)
    tp = _port({key: [p]})[key][0]
    got = tapply(tp, t(x), compute_dtype=torch.bfloat16 if bf16 else None)
    assert tuple(got.shape) == (2, c_out, w_out)
    _close(got.permute(0, 2, 1), exp, BF16 if bf16 else F32)
    # The port's initialiser draws PyTorch's layout of the same shape.
    own = {"conv": tnn.conv1d_init, "deconv": tnn.deconv1d_init}[layer](
        torch.Generator().manual_seed(0), c_in, c_out)
    assert own["w"].shape == tp["w"].shape


def _audio_batch(seed, n=5):
    return np.random.RandomState(seed).rand(n, 10, 1281).astype(np.float32)


def _perturbed_bn_state(state, seed):
    """A running state away from its init (mean 0, var 1), so that
    evaluation-mode BatchNorm is tested on real statistics."""
    rng = np.random.RandomState(seed)
    bns = [dict(s, mean=jnp.asarray(rng.randn(*np.shape(s["mean"]))
                                    .astype(np.float32) * 0.1),
                var=jnp.asarray(rng.rand(*np.shape(s["var"]))
                                .astype(np.float32) + 0.5))
           for s in state["bns"]]
    return {"bns": bns}


@pytest.mark.parametrize("native", [False, True], ids=["edge", "native"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("gauss_out", [True, False], ids=["gauss", "feats"])
def test_audio_encoder_matches_jax(gauss_out, train, native):
    """Output (the Gaussian heads or DKS's 161 x 16 features) and the
    BatchNorm running state; ``apply_native`` takes (N, 1281, 10)."""
    jenc = jc.audio_encoder_codec(ZH, gauss_out)
    tenc = tc.audio_encoder_codec(ZH, gauss_out)
    assert tenc.feat_dim == jenc.feat_dim == 161 * 16
    assert tenc.raw_perm == jenc.raw_perm == (1, 0)
    params, state = jenc.init(jax.random.PRNGKey(5))
    state = _perturbed_bn_state(state, 6)
    x = _audio_batch(7)
    if native:
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    japply = jenc.apply_native if native else jenc.apply
    tapply = tenc.apply_native if native else tenc.apply
    jout, jstate = japply(params, state, jnp.asarray(x), train)
    tout, tstate = tapply(_port(params, ("enc", "audio")),
                          _port(state, ("enc", "audio")), t(x), train)
    if gauss_out:
        _close(tout[0], jout[0])
        _close(tout[1], jout[1])
    else:
        assert tuple(tout.shape) == (5, 161 * 16)
        _close(tout, jout)
    for a, b in zip(tstate["bns"], jstate["bns"]):
        _close(a["mean"], b["mean"])
        _close(a["var"], b["var"])


@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_audio_decoder_matches_jax(train, logits):
    """Probabilities (N, 10, 1281), or the pre-sigmoid logits in the
    native (N, 1281, 10) layout, and the running state."""
    jdec = jc.audio_decoder_codec(ZH)
    tdec = tc.audio_decoder_codec(ZH)
    params, state = jdec.init(jax.random.PRNGKey(8))
    state = _perturbed_bn_state(state, 9)
    z = np.random.RandomState(10).randn(4, ZH).astype(np.float32)
    japply = jdec.apply_logits if logits else jdec.apply
    tapply = tdec.apply_logits if logits else tdec.apply
    (jout,), jstate = japply(params, state, jnp.asarray(z), train)
    (tout,), tstate = tapply(_port(params, ("dec", "audio")),
                             _port(state, ("dec", "audio")), t(z), train)
    assert tuple(tout.shape) == ((4, 1281, 10) if logits else (4, 10, 1281))
    _close(tout, jout)
    for a, b in zip(tstate["bns"], jstate["bns"]):
        _close(a["mean"], b["mean"])
        _close(a["var"], b["var"])


def test_audio_codecs_bf16_match_jax():
    """``compute_dtype`` bfloat16 on both sides; outputs stay float32."""
    jenc = jc.audio_encoder_codec(ZH, compute_dtype=jnp.bfloat16)
    tenc = tc.audio_encoder_codec(ZH, compute_dtype=torch.bfloat16)
    jdec = jc.audio_decoder_codec(ZH, compute_dtype=jnp.bfloat16)
    tdec = tc.audio_decoder_codec(ZH, compute_dtype=torch.bfloat16)
    ep, es = jenc.init(jax.random.PRNGKey(11))
    dp, ds = jdec.init(jax.random.PRNGKey(12))
    x = _audio_batch(13)
    (jm, js), _ = jenc.apply(ep, es, jnp.asarray(x), True)
    (tm, tsd), _ = tenc.apply(_port(ep, ("enc", "audio")),
                              _port(es, ("enc", "audio")), t(x), True)
    _close(tm, jm, BF16)
    _close(tsd, js, BF16)
    z = np.random.RandomState(14).randn(4, ZH).astype(np.float32)
    (jout,), _ = jdec.apply_logits(dp, ds, jnp.asarray(z), False)
    (tout,), _ = tdec.apply_logits(_port(dp, ("dec", "audio")),
                                   _port(ds, ("dec", "audio")), t(z), False)
    _close(tout, jout, BF16)


# ---------------------------------------------------------------------------
# The app's model, its tree, its checkpoints
# ---------------------------------------------------------------------------

def _jax_model(model="dmm", model_args=None):
    args = types.SimpleNamespace(
        model_args=dict(model_args or {"z_dim": ZH, "h_dim": ZH}),
        model=model, modalities=MODS)
    return JTrainer.build_model(None, jget_model(model), args)


@pytest.fixture(scope="module")
def models():
    """The app's BFVI model at z = h = 8 (full-size codecs) in both
    packages, JAX's weights, and the port's copy of them."""
    jmodel = _jax_model()
    tmodel = tv.build_model(MODS, {"z_dim": ZH, "h_dim": ZH})
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, jstate, tparams, tstate


def _leaves_equal(got, exp):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(exp))
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(exp)):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_array_equal(x, y)


def test_params_round_trip_through_the_port(models):
    """``params_to_jax(params_from_jax(x)) == x`` bit for bit on the app's
    tree (the 1-D conv and deconv kernels among them), and the converted
    tree has the port's own shapes (the DKS tree's leaves are covered by
    tests/test_torch_structure.py)."""
    _, tmodel, jparams, jstate, _, _ = models
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    for got, exp in zip(params_to_jax(tparams, tstate), (jparams, jstate)):
        _leaves_equal(got, np_tree(exp))
    own_p, _ = tmodel.init(0, device="cpu")
    for side, key in (("enc", "convs"), ("dec", "deconvs")):
        for a, b in zip(tparams[side]["audio"][key],
                        own_p[side]["audio"][key]):
            assert a["w"].shape == b["w"].shape and a["w"].dim() == 3


def _batch(seed, t_dim=T, b_dim=B):
    """Binary video and audio targets; inputs with 30 % of steps deleted
    per modality."""
    rng = np.random.RandomState(seed)
    targets = {
        "video": (rng.rand(t_dim, b_dim, 3, 64, 64) > 0.5).astype(np.float32),
        "audio": rng.rand(t_dim, b_dim, 10, 1281).astype(np.float32)}
    inputs = {m: v.copy() for m, v in targets.items()}
    for v in inputs.values():
        v[rng.rand(t_dim, b_dim) < 0.3] = np.nan
    return inputs, targets, np.ones((t_dim, b_dim, 1), np.float32)


def _map_forward(jmodel, tmodel, jparams, jstate, tparams, tstate, inputs):
    (ji, jp, jr), _ = jax.jit(lambda p, s, x: jmodel.forward(
        p, s, x, rng=jax.random.PRNGKey(0), mode="fsmooth", sample=False))(
        jparams, jstate, {m: jnp.asarray(v) for m, v in inputs.items()})
    with torch.no_grad():
        (ti, tp, tr), _ = tmodel.forward(
            tparams, tstate, {m: t(v) for m, v in inputs.items()},
            mode="fsmooth", sample=False)
    return (ji, jp, jr), (ti, tp, tr)


def test_jax_checkpoint_loads_into_port_and_back(models, tmp_path):
    """A JAX-written checkpoint restores the port's trainer (its MAP
    forward then equals JAX's); the port's checkpoint of those weights
    reads back in the JAX package equal to the JAX trees."""
    jmodel, tmodel, jparams, jstate, _, _ = models
    path = str(tmp_path / "jax.pth")
    jck.save_checkpoint(path, MODS, jparams, jstate)
    trainer = tv.VidTIMITTrainer(tmodel, lr=5e-4, seed=3, device="cpu")
    trainer.restore(tck.load_checkpoint(path))
    inputs, _, _ = _batch(2)
    (ji, _, jr), (ti, _, tr) = _map_forward(
        jmodel, tmodel, jparams, jstate, trainer.params, trainer.state,
        inputs)
    _close(ti[0], ji[0])
    for m in MODS:
        _close(tr[m][0], jr[m][0])
    out = str(tmp_path / "port.pth")
    trainer.save_checkpoint(MODS, out, extra={"epoch": 1})
    ck = jck.load_checkpoint(out)
    assert ck["format"] == 2 and ck["modalities"] == MODS
    _leaves_equal(ck["params"], np_tree(jparams))
    _leaves_equal(ck["state"], np_tree(jstate))


@pytest.mark.parametrize("absent", [(), ("audio",), ("video",)],
                         ids=["both", "no_audio", "no_video"])
def test_map_forward_matches_jax(models, absent):
    """The MAP forward (fsmooth) with both modalities, or one absent
    (NaN-filled at the model's edge)."""
    jmodel, tmodel, jparams, jstate, tparams, tstate = models
    inputs, _, _ = _batch(3)
    inputs = {m: v for m, v in inputs.items() if m not in absent}
    (ji, jp, jr), (ti, tp, tr) = _map_forward(
        jmodel, tmodel, jparams, jstate, tparams, tstate, inputs)
    for g, e in zip((*ti, *tp), (*ji, *jp)):
        _close(g, e)
    for m in MODS:
        _close(tr[m][0], jr[m][0])


@pytest.fixture(scope="module")
def narrow_models():
    """The app's model structure (conv video and 1-D conv audio codecs,
    both Bernoulli, z = h = 8) at narrow codec widths: 8x8 video, 33
    frequency bins (33 -> 17 -> 9 -> 5). At the app's widths a step's
    loss sums 25,098 Bernoulli terms a step and column, and its weight
    gradients are sums with heavy cancellation: JAX's own jitted and
    eager gradients differ there by up to 5e-3 in relative Frobenius
    norm (the first video convolution), beyond the elementwise
    tolerance, so the step's gradients are compared here."""
    kw = {"video": dict(img_size=8, n_kernels=8),
          "audio": dict(n_freqs=33)}
    dims = [(3, 8, 8), (10, 33)]
    out = []
    for pkg, codecs, cls in ((jc, jc, jget_model("dmm")),
                             (tc, tc, tget_model("dmm"))):
        out.append(cls(
            MODS, dims, dists=["Bernoulli", "Bernoulli"],
            encoders={"video": codecs.image_encoder_codec(ZH, **kw["video"]),
                      "audio": codecs.audio_encoder_codec(ZH,
                                                          **kw["audio"])},
            decoders={"video": codecs.image_decoder_codec(ZH, **kw["video"]),
                      "audio": codecs.audio_decoder_codec(ZH,
                                                          **kw["audio"])},
            z_dim=ZH, h_dim=ZH))
    jmodel, tmodel = out
    jparams, jstate = jmodel.init(jax.random.PRNGKey(6))
    return jmodel, tmodel, jparams, jstate


def _narrow_batch(seed):
    rng = np.random.RandomState(seed)
    targets = {
        "video": (rng.rand(T, B, 3, 8, 8) > 0.5).astype(np.float32),
        "audio": rng.rand(T, B, 10, 33).astype(np.float32)}
    inputs = {m: v.copy() for m, v in targets.items()}
    for v in inputs.values():
        v[rng.rand(T, B) < 0.3] = np.nan
    return inputs, targets, np.ones((T, B, 1), np.float32)


def _steps(jmodel, tmodel, jparams, jstate, inputs, targets, mask, **kw):
    """One step of each package on JAX's weights: ((JAX loss, grads,
    state) in the port's layout, (port loss, grads, state))."""
    jx = lambda d: {m: jnp.asarray(v) for m, v in d.items()}  # noqa: E731

    def jloss(p):
        return jmodel.step(p, jstate, jx(inputs), jnp.asarray(mask), 0.5,
                           tv.DEFAULTS["rec_mults"], jax.random.PRNGKey(2),
                           targets=jx(targets), train=True, **kw)

    (jl, jnew), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, tnew = tmodel.step(tparams, tstate, {m: t(v) for m, v in
                                             inputs.items()}, t(mask), 0.5,
                           tv.DEFAULTS["rec_mults"],
                           torch.Generator().manual_seed(0),
                           targets={m: t(v) for m, v in targets.items()},
                           train=True, **kw)
    tl.backward()
    exp_g, exp_state = port_tree(jg, jnew, tmodel)
    return (float(jl), exp_g, exp_state), (tl.item(), grads_of(tparams),
                                           tnew)


STEP_KW = dict(uni_loss=True, match_mult=0.0, flt_particles=1, sample=True,
               train_particles=3)


@pytest.mark.parametrize("layout", ["edge", "native", "native_no_audio"])
def test_fused_step_matches_jax(narrow_models, monkeypatch, layout):
    """The fused objective (joint + two unimodal variants: V B = 3 B
    columns), sampled with JAX's filter noise injected on both sides
    (three s-mode particles), prior matching off: loss, gradients and
    BatchNorm state. ``native`` feeds both modalities in the
    codec-native layout (``native_mods``), as the device loader stores
    them; ``native_no_audio`` leaves audio out of the inputs, so the
    model NaN-fills it in the native (W, C) layout."""
    jmodel, tmodel, jparams, jstate = narrow_models
    inputs, targets, mask = _narrow_batch(4)
    kw = dict(STEP_KW)
    if layout != "edge":
        perms = tmodel.native_input_perms()
        assert perms == {"video": (1, 2, 0), "audio": (1, 0)}
        kw["native_mods"] = ("video", "audio")
        for d in (inputs, targets):
            for m, perm in perms.items():
                d[m] = np.ascontiguousarray(
                    d[m].transpose((0, 1) + tuple(2 + p for p in perm)))
        if layout == "native_no_audio":
            del inputs["audio"], targets["audio"]
    jn, tn = _inject(monkeypatch, jmodel, tmodel, seed=5)
    (jl, jg, jstate_new), (tl, tg, tstate_new) = _steps(
        jmodel, tmodel, jparams, jstate, inputs, targets, mask, **kw)
    assert tn.shapes == jn.shapes and len(tn.shapes) >= 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_trees_close(jg, tg, normalise=True, **GRAD)
    assert_trees_close(jstate_new, tstate_new, rtol=1e-4, atol=1e-5)


def test_fused_step_loss_at_the_apps_widths(models, monkeypatch):
    """The app's model (full-size codecs, z = h = 8) in the same sampled
    step: the loss within rtol 1e-4, every gradient finite."""
    jmodel, tmodel, jparams, jstate, _, _ = models
    inputs, targets, mask = _batch(4)
    _inject(monkeypatch, jmodel, tmodel, seed=5)
    (jl, _, _), (tl, tg, _) = _steps(jmodel, tmodel, jparams, jstate,
                                     inputs, targets, mask, **STEP_KW)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for _, g in tree_leaves_with_path(tg):
        assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_eval_ccc_matches_jax():
    rng = np.random.RandomState(0)
    y = rng.randn(200)
    assert abs(eval_ccc(y, y) - 1.0) < 1e-9
    assert eval_ccc(y, -y) < 0
    assert eval_ccc(y, y + 2.0) < 0.5
    for seed in range(3):
        a, b = np.random.RandomState(seed + 1).randn(2, 50)
        assert eval_ccc(a, a + b) == jccc(a, a + b)


def _metric_inputs(models, seed):
    """A batch of B = 4 columns, one a ghost (length 0), with
    probabilities for the reconstructions and random posteriors."""
    jmodel, tmodel, _, _, _, _ = models
    rng = np.random.RandomState(seed)
    t_dim, b_dim, lengths = 5, 4, [5, 4, 2]
    _, targets, _ = _batch(seed, t_dim, b_dim)
    targets["video"] = targets["video"].copy()
    for m in MODS:
        for b, n in enumerate(lengths + [0]):
            targets[m][n:, b] = np.nan
    mask = np.zeros((t_dim, b_dim, 1), np.float32)
    for b, n in enumerate(lengths):
        mask[:n, b] = 1.0
    recon = {m: (np.clip(rng.rand(*targets[m].shape), 0.01, 0.99)
                 .astype(np.float32),) for m in MODS}
    z = [rng.randn(t_dim, b_dim, ZH).astype(np.float32),
         (rng.rand(t_dim, b_dim, ZH) + 0.5).astype(np.float32)]
    prior = [rng.randn(t_dim, b_dim, ZH).astype(np.float32),
             (rng.rand(t_dim, b_dim, ZH) + 0.5).astype(np.float32)]
    return jmodel, tmodel, z, prior, recon, targets, mask, lengths


def _metrics_close(got, exp):
    assert sorted(got) == sorted(exp) == ["a_mse", "kld_loss", "rec_loss",
                                          "ssim", "v_mse"]
    for k in exp:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(exp[k], np.float64),
                                   err_msg=k, **METRIC)


def test_compute_metrics_device_matches_jax(models):
    """The device path's per-batch metrics: summed KLD and
    reconstruction loss, per-sequence video MSE, SSIM and audio MSE
    (ghost columns divide by 1)."""
    jmodel, tmodel, z, prior, recon, targets, mask, lengths = \
        _metric_inputs(models, 20)
    lengths_pad = np.array(lengths + [0], np.float32)
    rec_mults = {"video": 1.0, "audio": 0.5}
    exp = jax.jit(lambda *a: JTrainer.compute_metrics_device(
        None, jmodel, *a, rec_mults))(
        [jnp.asarray(x) for x in z], [jnp.asarray(x) for x in prior],
        {m: (jnp.asarray(r[0]),) for m, r in recon.items()},
        {m: jnp.asarray(v) for m, v in targets.items()}, jnp.asarray(mask),
        jnp.asarray(lengths_pad))
    got = tv.VidTIMITTrainer.compute_metrics_device(
        None, tmodel, [t(x) for x in z], [t(x) for x in prior],
        {m: (t(r[0]),) for m, r in recon.items()},
        {m: t(v) for m, v in targets.items()}, t(mask), t(lengths_pad),
        rec_mults)
    _metrics_close({k: v.numpy() for k, v in got.items()},
                   {k: np.asarray(v) for k, v in exp.items()})


def test_compute_metrics_matches_jax(models, monkeypatch):
    """The host path: per-sequence lists in input order, with
    ``args.rec_mults``. (The JAX app's SSIM is jitted here, the same
    function compiled, not dispatched op by op.)"""
    import multimodal_dmm_tpu.apps.vidtimit as japp
    monkeypatch.setattr(japp, "eval_ssim", jax.jit(japp.eval_ssim))
    jmodel, tmodel, z, prior, recon, targets, mask, lengths = \
        _metric_inputs(models, 21)
    order = [2, 0, 1]
    args = types.SimpleNamespace(rec_mults={"video": 1.0, "audio": 2.0})
    exp = JTrainer.compute_metrics(
        None, jmodel, [jnp.asarray(x) for x in z],
        [jnp.asarray(x) for x in prior], recon, targets, mask, lengths,
        order, args)
    trainer = tv.VidTIMITTrainer(tmodel, lr=5e-4, device="cpu")
    got = trainer.compute_metrics(
        tmodel, [t(x) for x in z], [t(x) for x in prior],
        {m: (t(r[0]),) for m, r in recon.items()}, targets, mask, lengths,
        order, args)
    for k in ("v_mse", "ssim", "a_mse"):
        assert len(got[k]) == len(exp[k]) == 3
    _metrics_close(got, exp)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_spectrogram_transform_matches_jax():
    """``wav_to_spec`` and ``spec_to_wav`` give the JAX package's arrays
    to 1e-6, and the round trip reconstructs the waveform."""
    rate = tvid.audio_rate
    ts = np.arange(rate // 2) / rate
    wav = (np.sin(2 * np.pi * 220 * ts)
           + 0.5 * np.sin(2 * np.pi * 440 * ts)).astype(np.float32)
    spec = tvid.wav_to_spec(wav, rate)
    assert spec.shape[1:] == (10, 1281)
    np.testing.assert_allclose(spec, jvid.wav_to_spec(wav, rate), rtol=1e-6,
                               atol=1e-6)
    rec = tvid.spec_to_wav(spec, rate)
    np.testing.assert_allclose(rec, jvid.spec_to_wav(spec, rate), rtol=1e-6,
                               atol=1e-6)
    err = np.abs(rec[2560:len(wav) - 2560] - wav[2560:len(wav) - 2560])
    assert err.mean() < 0.05


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """The same fixture written by each package (2 subjects x 3
    sentences, 20-30 steps)."""
    dirs = {}
    for name, gen in (("port", tvid.gen_synthetic),
                      ("jax", jvid.gen_synthetic)):
        dirs[name] = str(tmp_path_factory.mktemp("vidtimit_" + name))
        gen(dirs[name], n_subjects=2, n_sentences=3, t_range=(20, 30))
    return dirs


def test_gen_synthetic_writes_the_jax_packages_bytes(fixture_dirs):
    for sub in ("audio", "video"):
        names = sorted(os.listdir(os.path.join(fixture_dirs["jax"], sub)))
        assert names == sorted(os.listdir(os.path.join(fixture_dirs["port"],
                                                       sub)))
        assert len(names) == 6
        for n in names:
            with open(os.path.join(fixture_dirs["jax"], sub, n), "rb") as f:
                want = f.read()
            with open(os.path.join(fixture_dirs["port"], sub, n), "rb") as f:
                assert f.read() == want, (sub, n)


def test_dataset_layout_and_split_match_jax(fixture_dirs):
    """Six sequences, audio T + 1 frames on disk truncated to the video's
    T; test set sa1/sa2 (4), train the rest (2); the port's items equal
    the JAX package's."""
    d = fixture_dirs["port"]
    ds = tvid.VidTIMITDataset(d, item_as_dict=True)
    jds = jvid.VidTIMITDataset(d, item_as_dict=True)
    assert len(ds) == 6 and ds.modalities == ["audio", "video"]
    assert ds.seq_ids == jds.seq_ids and ds.lengths == jds.lengths
    for i in range(len(ds)):
        item, jitem = ds[i], jds[i]
        n = item["length"]
        assert item["video"].shape == (n, 3, 64, 64)
        assert item["audio"].shape == (n, 10, 1281)
        assert ds.orig["audio"][i].shape[0] == n + 1
        for m in ("audio", "video"):
            np.testing.assert_array_equal(item[m], jitem[m])
    train = ds.select([None, ["sa1", "sa2"]], invert=True)
    test = ds.select([None, ["sa1", "sa2"]])
    jtest = jds.select([None, ["sa1", "sa2"]])
    assert len(test) == 4 and len(train) == 2
    assert test.seq_ids == jtest.seq_ids
    assert {s[1] for s in train.seq_ids} == {"si1"}
    for m in ("audio", "video"):
        for a, b in zip(test.data[m], jtest.data[m]):
            np.testing.assert_array_equal(a, b)


def test_missing_corpus_raises_and_names_the_fixture(tmp_path):
    """Where the JAX package would download the corpus, the port
    raises."""
    with pytest.raises(FileNotFoundError, match="gen_synthetic"):
        tvid.VidTIMITDataset(str(tmp_path / "none"))
    os.makedirs(tmp_path / "empty" / "audio")
    os.makedirs(tmp_path / "empty" / "video")
    with pytest.raises(FileNotFoundError, match="gen_synthetic"):
        tvid.VidTIMITDataset(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def jax_evaluation(models, fixture_dirs):
    """The fixture's test set and the JAX package's device evaluation of
    it, one sequence a batch (the summary)."""
    from multimodal_dmm_tpu.training import eval_engine as jengine
    jmodel, _, jparams, jstate, _, _ = models
    data = tvid.VidTIMITDataset(fixture_dirs["port"], item_as_dict=True)
    test = data.select([None, ["sa1", "sa2"]])
    rec_mults = dict(tv.DEFAULTS["rec_mults"])
    batches = jengine.DeviceEvalData(test, MODS, 1).batches
    assert [b.mask.shape[0] for b in batches] == [25, 29, 20, 29]
    forward = jax.jit(lambda p, s, x: jmodel.forward(
        p, s, x, rng=jax.random.PRNGKey(0), sample=False)[0])
    metric_kernel = jax.jit(lambda *a: JTrainer.compute_metrics_device(
        None, jmodel, *a, rec_mults))
    metrics, n_steps = None, 0
    for b in batches:
        infer, prior, recon = forward(jparams, jstate, {
            m: b.targets[m] for m in MODS})
        out = metric_kernel(infer, prior, recon, b.targets, b.mask,
                            b.lengths_dev)
        out = {k: float(v) if np.ndim(v) == 0 else
               [np.asarray(v)[i] for i in b.order] for k, v in out.items()}
        metrics = out if metrics is None else {
            k: metrics[k] + out[k] for k in metrics}
        n_steps += sum(b.lengths)
    return test, JTrainer.summarize_metrics(None, metrics, n_steps)


@pytest.mark.parametrize("path", ["device", "host"])
def test_evaluate_matches_jax_task_eval(models, jax_evaluation, path):
    """``VidTIMITTrainer.evaluate`` over the fixture's test set (sa1/sa2,
    four sequences of 20-29 steps) one sequence a batch, each batch
    collated to its own length (25, 29, 20, 29), with the app's task (no
    deletion) and MAP
    inference, against the JAX package's device evaluation of the same
    batches (compose, forward, ``compute_metrics_device``, the summed
    reduction, ``summarize_metrics``): every summary value within rtol
    1e-4 / atol 1e-5. ``host`` runs the port's host path
    (``collect_results``)."""
    from multimodal_dmm_tpu_torch.training.loader import BatchLoader
    _, tmodel, _, _, tparams, tstate = models
    test, exp = jax_evaluation
    trainer = tv.VidTIMITTrainer(tmodel, lr=5e-4, params=tparams,
                                 state=tstate, device="cpu")
    args = tv.eval_namespace(None)
    _, got = trainer.evaluate(BatchLoader(test, 1), args,
                              collect_results=path == "host")
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The command line on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """param_hist.tsv goes to the working directory."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _argv(data_dir, save_dir, *extra):
    return ["--device", "cpu", "--data_dir", data_dir, "--save_dir",
            str(save_dir), "--eval_args", "{flt_particles: 4}",
            "--split", "10", "--batch_size", "4", "--seed", "3"] + list(extra)


# --method replaces --model_args: the DKS baseline runs at z = h = 256.
CLI = {"bfvi": ["--method", "bfvi", "--model_args", "{z_dim: 8, h_dim: 8}",
                "--train_args", "{train_particles: 3, match_particles: 4}"],
       "bfvi_bf16_gtf": ["--method", "bfvi", "--model_args",
                         "{z_dim: 8, h_dim: 8, bf16: true, bf16_gtf: true}",
                         "--train_args",
                         "{train_particles: 3, match_particles: 4}"],
       "f_mask": ["--method", "f-mask"]}


@pytest.mark.parametrize("config", sorted(CLI))
def test_cli_trains_checkpoints_and_evaluates(fixture_dirs, in_tmp, config):
    """One epoch with an evaluation; best.pth, epoch_1.pth, last.pth;
    then ``--load last.pth --evaluate`` twice under one seed, identical
    finite metrics."""
    data, save = fixture_dirs["port"], in_tmp / "save"
    hist = tv.main(_argv(data, save, *CLI[config], "--epochs", "1",
                         "--eval_freq", "1", "--save_freq", "1"))
    assert len(hist["epoch_loss"]) == 1
    assert np.all(np.isfinite(hist["epoch_loss"]))
    assert np.isfinite(hist["eval"][0]["a_mse"])
    names = sorted(p.name for p in save.iterdir())
    assert names == ["best.pth", "epoch_1.pth", "last.pth"]
    ck = tck.load_checkpoint(str(save / "epoch_1.pth"))
    assert ck["modalities"] == MODS and ck["epoch"] == 1
    assert ck["params"]["enc"]["audio"]["convs"][0]["w"].shape == (3, 10, 4)
    runs = [tv.main(_argv(data, save, *CLI[config], "--load",
                          str(save / "last.pth"), "--evaluate",
                          "--save_args", "{skip: true}"))
            for _ in range(2)]
    for i in range(2):
        a, b = dict(runs[0][i]), dict(runs[1][i])
        assert a.keys() == b.keys()
        for k in ("kld_loss", "rec_loss", "v_mse", "ssim", "a_mse"):
            assert np.isfinite(a[k]) and a[k] == b[k], k
        assert 0.0 <= a["ssim"] <= 1.0


def test_cli_vrnn_raises(fixture_dirs, in_tmp):
    """The JAX VRNN fails at its first step on this app's Bernoulli
    video and audio; the port's refuses them at construction."""
    with pytest.raises(ValueError, match="Normal modalities only"):
        tv.main(_argv(fixture_dirs["port"], in_tmp / "save", "--model",
                      "vrnn", "--epochs", "1"))


def test_flag_surface_is_the_jax_apps():
    """The same flags with the same defaults, except --device (cuda)."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}
    port, ref = actions(tv.VidTIMITTrainer.parser), actions(JTrainer.parser)
    assert port.keys() == ref.keys()
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        if dest != "device":
            assert b.default == a.default, dest
    assert port["device"].default == "cuda"
    assert tv.W_DECAY == ref["w_decay"].default
    ns = tv.eval_namespace("bfvi")
    assert ns.eval_args == {"flt_particles": 200} and ns.drop_frac == 0.0
