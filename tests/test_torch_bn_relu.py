"""The training BatchNorm + ReLU kernels (``ops/cuda/bn_relu.py``,
``csrc/bn_relu.cu``) against the plain path, at every BatchNorm site of
the Weizmann and VidTIMIT codecs, in both layouts the convolutions give.

The kernels and the plain path (``F.relu(batchnorm_apply(...))``, cuDNN
on the card) are each held to the same function computed in float64 from
the same float32 input, the backward on the ReLU mask the kernel's own y
shows (an element whose pre-activation lies within rounding of 0 may take
either side, in either float32 path). These need a GPU and skip without
one; the file imports neither JAX nor the JAX package, so on a machine
without JAX it runs on its own: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_bn_relu.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bn_relu as tbn

pytestmark = pytest.mark.cuda

EPS, MOMENTUM = 1e-5, 0.1
# (channels, spatial sizes) of each BatchNorm site: the Weizmann video
# codecs' 16 x 32 x 32 and 32 x 16 x 16, the VidTIMIT audio codecs' 4 x
# 641 and 8 x 321 (its video codecs are Weizmann's).
SITES = {"video16": (16, (32, 32)), "video32": (32, (16, 16)),
         "audio4": (4, (641,)), "audio8": (8, (321,))}
# 625 rows: the encoder (T 25 x B 25); 1,250: a decoder (two variant
# rows a step); 7 rows leave ragged chunks, and with audio4 an odd size.
ROWS = [625, 1250]
# Largest error of each output over its scale, against float64. The
# sums run in float32 over up to 1.28 M elements a channel, in blocks of
# about 80 a thread and then fixed trees: a few 1e-7 of the sum of the
# terms' magnitudes; y, dx and the running state take that relative error
# of the statistics, times a few roundings each. The limits leave a
# factor of about 10 over what such sums give.
TOL = {"y": 2e-6, "mean": 2e-6, "inv_std": 2e-6, "new_mean": 2e-6,
       "new_var": 2e-6, "dx": 2e-5, "dgamma": 1e-5, "dbeta": 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, rows, c, spatial, channels_last, seed=0, constant=False):
    """x (rows, C, *spatial) with a mean and scale of its own a channel
    (so pre-activations fall on both sides of 0), gamma, beta, the running
    state and dy, all float32 on ``dev``; x channels-last if asked."""
    rng = np.random.RandomState(seed)
    shape = (rows, c) + tuple(spatial)
    bshape = (1, c) + (1,) * len(spatial)
    x = (rng.randn(*shape) * rng.uniform(0.2, 3.0, bshape)
         + rng.uniform(-2.0, 2.0, bshape))
    if constant:
        x[:, 0] = 0.7
    vecs = [rng.uniform(0.5, 1.5, c), rng.uniform(-0.5, 0.5, c),
            rng.randn(c) * 0.1, rng.uniform(0.5, 2.0, c)]
    dy = rng.randn(*shape)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    x, dy = t(x), t(dy)
    if channels_last:
        perm = (0,) + tuple(range(2, x.dim())) + (1,)
        inv = [perm.index(d) for d in range(x.dim())]
        x = x.permute(perm).contiguous().permute(inv)
        dy = dy.permute(perm).contiguous().permute(inv)
        assert tbn.channels_last_layout(x) is True
    return x, [t(v) for v in vecs], dy


def _reference(x, gamma, beta, run_mean, run_var, dy, mask):
    """The function in float64: y, the saved statistics, the new running
    state and, on ``mask`` (where the pre-activation is taken as > 0),
    dx, dgamma and dbeta; with each sum's scale (sum of magnitudes)."""
    x, dy = x.double(), dy.double()
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    n = x.numel() // x.shape[1]
    var, mean = torch.var_mean(x, dim=axes, correction=0)
    inv = 1.0 / torch.sqrt(var + EPS)
    g, b = gamma.double(), beta.double()
    xhat = (x - mean.reshape(shape)) * inv.reshape(shape)
    y = torch.relu(xhat * g.reshape(shape) + b.reshape(shape))
    d = torch.where(mask, dy, torch.zeros_like(dy))
    dbeta, dgamma = d.sum(axes), (d * xhat).sum(axes)
    dx = (g * inv).reshape(shape) * (
        d - (dbeta.reshape(shape) + xhat * dgamma.reshape(shape)) / n)
    out = {"y": y, "mean": mean, "inv_std": inv,
           "new_mean": (1 - MOMENTUM) * run_mean.double() + MOMENTUM * mean,
           "new_var": ((1 - MOMENTUM) * run_var.double()
                       + MOMENTUM * var * n / (n - 1)),
           "dx": dx, "dgamma": dgamma, "dbeta": dbeta}
    scale = {k: v.abs().max() for k, v in out.items()}
    scale["dgamma"] = (d * xhat).abs().sum(axes).max()
    scale["dbeta"] = d.abs().sum(axes).max()
    return out, scale


def _errors(got, ref, scale):
    return {k: float((got[k].double() - ref[k]).abs().max()
                     / max(float(scale[k]), 1e-30)) for k in got}


def _kernel_outputs(x, vecs, dy):
    gamma, beta, run_mean, run_var = vecs
    y, mean, inv, new_mean, new_var = tbn.bn_relu_fwd_cuda(
        x, gamma, beta, run_mean, run_var, EPS, MOMENTUM)
    dx, dgamma, dbeta = tbn.bn_relu_bwd_cuda(dy, x, gamma, beta, mean, inv)
    return {"y": y, "mean": mean, "inv_std": inv, "new_mean": new_mean,
            "new_var": new_var, "dx": dx, "dgamma": dgamma, "dbeta": dbeta}


def _plain_outputs(x, vecs, dy):
    """The plain path on the card (cuDNN's BatchNorm, var_mean, F.relu),
    with autograd."""
    gamma, beta, run_mean, run_var = [v.clone() for v in vecs]
    xg = x.detach().clone().requires_grad_(True)
    gamma.requires_grad_(True)
    beta.requires_grad_(True)
    state = {"mean": run_mean, "var": run_var, "eps": EPS,
             "momentum": MOMENTUM}
    out, new_state = tnn.batchnorm_apply({"scale": gamma, "bias": beta},
                                         state, xg, True)
    y = F.relu(out)
    y.backward(dy)
    return {"y": y.detach(), "new_mean": new_state["mean"],
            "new_var": new_state["var"], "dx": xg.grad,
            "dgamma": gamma.grad, "dbeta": beta.grad}


def _check_site(dev, rows, c, spatial, channels_last, constant=False):
    x, vecs, dy = _inputs(dev, rows, c, spatial, channels_last,
                          constant=constant)
    got = _kernel_outputs(x, vecs, dy)
    assert got["y"].stride() == x.stride()
    assert got["dx"].stride() == x.stride()
    ref, scale = _reference(x, *vecs, dy, got["y"] > 0)
    err = _errors(got, ref, scale)
    plain = _errors(_plain_outputs(x, vecs, dy), ref, scale)
    bad = {k: (e, TOL[k], plain.get(k)) for k, e in err.items()
           if not e <= TOL[k]}
    assert not bad, "kernel error, limit, plain path's error: %s" % bad
    # The kernel's mask differs from float64's only within rounding of 0.
    pre = ((x.double() - ref["mean"].reshape((1, -1) + (1,) * (x.dim() - 2)))
           * (vecs[0].double() * ref["inv_std"]).reshape(
               (1, -1) + (1,) * (x.dim() - 2))
           + vecs[1].double().reshape((1, -1) + (1,) * (x.dim() - 2)))
    flips = (got["y"] > 0) != (pre > 0)
    if flips.any():
        assert float(pre[flips].abs().max()) < 1e-5
    return got


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("site", sorted(SITES))
def test_kernels_match_float64_at_every_site(dev, site, rows,
                                             channels_last):
    c, spatial = SITES[site]
    _check_site(dev, rows, c, spatial, channels_last)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("site", ["video16", "audio4"])
def test_constant_channel_and_ragged_rows(dev, site, channels_last):
    """Channel 0 constant (variance exactly 0: its y is relu(beta) and
    its xhat 0), at 7 rows: chunks end mid-plane, and audio4's 7 x 4 x 641
    elements are no multiple of 4 (the apply kernels load by floats)."""
    c, spatial = SITES[site]
    got = _check_site(dev, 7, c, spatial, channels_last, constant=True)
    assert float(got["mean"][0]) == np.float32(0.7)
    assert float(got["inv_std"][0]) == np.float32(1) / np.sqrt(
        np.float32(EPS))


@pytest.mark.parametrize("channels_last", [False, True])
def test_two_runs_agree_bit_for_bit(dev, channels_last):
    x, vecs, dy = _inputs(dev, 1250, 4, (641,), channels_last, seed=3)
    a = _kernel_outputs(x, vecs, dy)
    b = _kernel_outputs(x, vecs, dy)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_streams_at_once_agree_with_one(dev):
    """Sites launched on two streams at once, each stream with its own
    workspace (ticket counters and partials), give what they give one
    after another on one stream, bit for bit: a counter shared across the
    streams would let a block merge partials not yet written."""
    sites = [_inputs(dev, 1250, 4, (641,), False, seed=5),
             _inputs(dev, 625, 16, (32, 32), True, seed=6)]
    exp = [_kernel_outputs(*site) for site in sites]
    streams = [torch.cuda.Stream(device=dev) for _ in sites]
    torch.cuda.synchronize()
    for _ in range(20):
        got = [None] * len(sites)
        for i, (site, stream) in enumerate(zip(sites, streams)):
            with torch.cuda.stream(stream):
                got[i] = _kernel_outputs(*site)
        torch.cuda.synchronize()
        for g, e in zip(got, exp):
            for k in e:
                assert torch.equal(g[k], e[k]), k


# Reduction blocks an SM of the plan (csrc/bn_relu.cu: kMinBlocks), and
# the bytes of a partial and of the ticket counters in the workspace.
BLOCKS_PER_SM = 4
PARTIAL_BYTES, TICKET_BYTES = 12, 4096


@pytest.mark.parametrize("shape", [(625, 16, 32, 32), (1250, 32, 16, 16),
                                   (625, 4, 641), (1250, 8, 321),
                                   (7, 4, 641), (3, 10, 5, 7), (2, 1, 9),
                                   (1, 256, 3), (5, 300, 2), (4, 1024, 1)])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("sms", [132, 1])
def test_bn_relu_plan_covers_every_row(dev, shape, channels_last, sms):
    """The kernels' launch plan (csrc/bn_relu.cu: ``make_plan``) covers
    every row of every channel once, with as many chunks as the card has
    room for, and its partials fit the stream's workspace."""
    n, c, s = shape[0], shape[1], int(np.prod(shape[2:]))
    if channels_last and c > tbn.THREADS:
        with pytest.raises(ValueError, match="no plan"):
            tbn.bn_relu_plan(n, c, s, True, sms, 1)
        return
    plan = tbn.bn_relu_plan(n, c, s, channels_last, sms, 4 if (
        n * c * s) % 4 == 0 else 1)
    rows = n * s
    assert plan["chunks"] * plan["chunk_len"] >= rows
    assert (plan["chunks"] - 1) * plan["chunk_len"] < rows
    assert 1 <= plan["chunks"] <= 65535 and plan["apply_blocks"] >= 1
    blocks = plan["chunks"] * (1 if channels_last else c)
    assert blocks < sms * BLOCKS_PER_SM + c
    assert plan["partials"] == plan["chunks"] * c
    assert (TICKET_BYTES + plan["partials"] * PARTIAL_BYTES
            <= tbn.workspace_bytes(sms))
    if channels_last:
        assert plan["threads"] % c == 0
        assert tbn.THREADS - c < plan["threads"] <= tbn.THREADS
    else:
        assert plan["threads"] == tbn.THREADS


def test_bn_relu_plan_fills_the_card_at_the_codec_sites(dev):
    """At the apps' sites (channels-last only in the encoders' first two
    sites of the video codec, as the card shows) every reduction has at
    least three blocks an SM of the H100's 132 (four, less the chunks'
    rounding)."""
    for n, c, s, cl in ((625, 16, 1024, True), (625, 32, 256, True),
                        (1250, 32, 256, False), (1250, 16, 1024, False),
                        (625, 4, 641, False), (625, 8, 321, False),
                        (1250, 8, 321, False), (1250, 4, 641, False)):
        plan = tbn.bn_relu_plan(n, c, s, cl, 132, 1)
        blocks = plan["chunks"] * (1 if cl else c)
        assert blocks >= 132 * 3, (n, c, s, plan)


def test_autograd_entry_and_the_codec_api(dev):
    """``batchnorm_relu_apply`` on a CUDA tensor goes through the kernels
    (four launches with the backward) and returns the kernels' outputs;
    the input state is not modified; evaluation and SyncStats take the
    plain path (no launch); another dtype raises."""
    x, (gamma, beta, run_mean, run_var), dy = _inputs(dev, 25, 16, (8, 8),
                                                      True)
    p = {"scale": gamma.clone().requires_grad_(True),
         "bias": beta.clone().requires_grad_(True)}
    state = {"mean": run_mean.clone(), "var": run_var.clone(), "eps": EPS,
             "momentum": MOMENTUM}
    xg = x.clone().requires_grad_(True)
    before = tbn.bn_relu_train_cuda.launches
    y, new_state = tnn.batchnorm_relu_apply(p, state, xg, True)
    y.backward(dy)
    assert tbn.bn_relu_train_cuda.launches == before + 4
    exp = _kernel_outputs(x, (gamma, beta, run_mean, run_var), dy)
    for k, v in (("y", y), ("new_mean", new_state["mean"]),
                 ("new_var", new_state["var"]), ("dx", xg.grad),
                 ("dgamma", p["scale"].grad), ("dbeta", p["bias"].grad)):
        assert torch.equal(v, exp[k]), k
    assert torch.equal(state["mean"], run_mean)
    assert torch.equal(state["var"], run_var)
    assert new_state["eps"] == EPS and new_state["momentum"] == MOMENTUM

    class Sync:
        @staticmethod
        def all_reduce(t):
            return t
    before = tbn.bn_relu_train_cuda.launches
    for train in (False, Sync()):
        out, _ = tnn.batchnorm_relu_apply(p, state, x, train)
        exp, _ = tnn.batchnorm_apply(p, state, x, train)
        assert torch.equal(out, F.relu(exp))
    assert tbn.bn_relu_train_cuda.launches == before
    with pytest.raises(ValueError, match="float32"):
        tnn.batchnorm_relu_apply(p, state, x.double(), True)


def _batch(dev, dims, seed=0, t_max=25, b_dim=25):
    rng = np.random.RandomState(seed)
    targets = {m: torch.tensor(rng.rand(t_max, b_dim, *d).astype(np.float32),
                               device=dev) for m, d in dims.items()}
    inputs = {m: v.clone() for m, v in targets.items()}
    return inputs, targets, torch.ones((t_max, b_dim, 1), device=dev)


@pytest.mark.parametrize("app", ["weizmann", "vidtimit"])
def test_launches_a_training_step(dev, app, monkeypatch):
    """One training step at the app's widths, video (and audio) in the
    codec-native layout as the device loader stores them: every BatchNorm
    site goes through the kernels, four launches each (Weizmann 6 sites,
    24 launches; VidTIMIT 12, 48), each x in a layout the kernels take as
    it is."""
    import importlib
    mod = importlib.import_module("multimodal_dmm_tpu_torch.apps." + app)
    trainer = mod.make_trainer(seed=1, device=dev)
    model = trainer.model
    dims = ({"video": (3, 64, 64)} if app == "weizmann"
            else {"video": (3, 64, 64), "audio": (10, 1281)})
    inputs, targets, mask = _batch(dev, dims)
    if app == "weizmann":
        rng = np.random.RandomState(1)
        for m in ("person", "action"):
            targets[m] = inputs[m] = torch.tensor(
                rng.randint(0, 10, (25, 25, 1)).astype(np.float32),
                device=dev)
    perms = model.native_input_perms()
    for batch in (inputs, targets):
        for m, perm in perms.items():
            batch[m] = batch[m].permute(
                (0, 1) + tuple(2 + p for p in perm)).contiguous()
    seen = []
    real = tnn.bn_relu_train_cuda

    def recorded(x, *args):
        seen.append((tuple(x.shape), tbn.channels_last_layout(x)))
        return real(x, *args)
    monkeypatch.setattr(tnn, "bn_relu_train_cuda", recorded)
    gen = torch.Generator(device=dev).manual_seed(1)
    before = tbn.bn_relu_train_cuda.launches
    loss, _ = model.step(trainer.params, trainer.state, inputs, mask, 1.0,
                         trainer.rec_mults, gen, targets=targets, train=True,
                         native_mods=tuple(perms))
    loss.backward()
    torch.cuda.synchronize()
    sites = 6 if app == "weizmann" else 12
    print("%s sites (shape, channels-last): %s" % (app, seen))
    assert len(seen) == sites
    assert all(layout is not None for _, layout in seen)
    assert tbn.bn_relu_train_cuda.launches == before + 4 * sites
