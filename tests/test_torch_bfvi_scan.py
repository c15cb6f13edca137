"""The filtering scan's plain PyTorch versions against the JAX package's
reference and its Pallas kernels (interpret mode), the autograd.Function
on CPU tensors against torch autograd. (The CUDA kernels against the
plain versions: tests/test_torch_cuda.py.)"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.ops.pallas import bfvi_scan as jscan
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from torch_parity import np_tree, t
from multimodal_dmm_tpu_torch.convert import tree_from_jax

T, M, B, D, H, K = 6, 3, 5, 16, 12, 3
MIN_STD = 1e-3
NAMES = ["prior_mean", "prior_std", "infer_mean", "infer_std", "samples",
         "z_traj"]


def make_inputs(seed=1, k=K, b=B, d=D, h=H):
    gtf = jnn.gtf_init(jax.random.PRNGKey(seed), d, h)
    rng = np.random.RandomState(seed)
    obs_mean = rng.randn(T, M, b, d).astype(np.float32)
    obs_std = (rng.rand(T, M, b, d) + 0.2).astype(np.float32)
    # A signed (inverse) expert, wide enough to keep the PoE well
    # conditioned at these tolerances.
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)
    obs_mask = (rng.rand(T, M, b) > 0.4).astype(np.float32)
    glb_mean = (rng.randn(b, d) * 0.1).astype(np.float32)
    glb_std = (rng.rand(b, d) * 0.5 + 0.7).astype(np.float32)
    eps = (rng.randn(T, k, b, d) * 0.5).astype(np.float32)
    cots = [rng.randn(T, b, d).astype(np.float32) for _ in range(5)]
    return gtf, [obs_mean, obs_std, obs_mask, glb_mean, glb_std], eps, cots


def port_gtf(gtf):
    return tree_from_jax(np_tree({"trans": gtf}), "cpu")["trans"]


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_fwd_ref_matches_jax(case, oracle):
    gtf, x, eps, _ = case
    if oracle == "ref":
        exp = jscan.bfvi_scan_ref(*x, gtf, eps, MIN_STD)
    else:
        exp = jscan.bfvi_scan_pallas(*x, gtf, eps, MIN_STD, interpret=True)
    got = tscan.bfvi_scan_fwd_ref(*map(t, x), port_gtf(gtf), t(eps),
                                  MIN_STD)
    for name, g, e in zip(NAMES, got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def _assert_grads(got, exp, err):
    scale = np.abs(exp).max() + 1e-6
    np.testing.assert_allclose(got / scale, exp / scale, rtol=2e-3,
                               atol=2e-4, err_msg=err)


def _check_bwd(got, exp_in, exp_gtf):
    """exp_* in JAX layout: gtf weights (in, out)."""
    for name, g, e in zip(["d_obs_mean", "d_obs_std", "d_glb_mean",
                           "d_glb_std"], got[:4], exp_in):
        _assert_grads(g.numpy(), np.asarray(e), name)
    for name in tscan.GTF_LAYERS:
        _assert_grads(got[4][name]["w"].numpy().T,
                      np.asarray(exp_gtf[name]["w"]), name + ".w")
        _assert_grads(got[4][name]["b"].numpy(),
                      np.asarray(exp_gtf[name]["b"]), name + ".b")


def test_bwd_ref_matches_pallas_bwd_interpret(case):
    gtf, x, eps, cots = case
    outs = jscan.bfvi_scan_pallas(*x, gtf, eps, MIN_STD, interpret=True)
    res = tuple(x) + (gtf, eps, outs[5], outs[0], outs[1])
    exp = jscan.bfvi_scan_pallas_bwd(res, cots, MIN_STD, None, True)
    tres = tuple(map(t, x)) + (port_gtf(gtf), t(eps)) + tuple(
        t(outs[i]) for i in (5, 0, 1))
    got = tscan.bfvi_scan_bwd_ref(tres, [t(c) for c in cots], MIN_STD)
    _check_bwd(got, exp[:4], exp[4])


def test_bwd_ref_matches_jax_grad_of_ref(case):
    gtf, x, eps, cots = case

    def loss(om, os_, gm, gs, g):
        outs = jscan.bfvi_scan_ref(om, os_, x[2], gm, gs, g, eps, MIN_STD)
        return sum(jnp.sum(o * c) for o, c in zip(outs[:5], cots))

    exp = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x[0], x[1], x[3], x[4],
                                                  gtf)
    outs = tscan.bfvi_scan_fwd_ref(*map(t, x), port_gtf(gtf), t(eps),
                                   MIN_STD)
    tres = tuple(map(t, x)) + (port_gtf(gtf), t(eps), outs[5], outs[0],
                               outs[1])
    got = tscan.bfvi_scan_bwd_ref(tres, [t(c) for c in cots], MIN_STD)
    _check_bwd(got, exp[:4], exp[4])


def _grads_through(fn, x, gtf, eps, cots):
    leaves = [t(v).requires_grad_() for v in (x[0], x[1], x[3], x[4])]
    tg = {n: {k: v.clone().requires_grad_() for k, v in d.items()}
          for n, d in port_gtf(gtf).items()}
    outs = fn(leaves[0], leaves[1], t(x[2]), leaves[2], leaves[3], tg,
              t(eps), MIN_STD)
    sum((o * t(c)).sum() for o, c in zip(outs[:5], cots)).backward()
    return [v.grad for v in leaves] + [tg[n][k].grad for n in tscan.GTF_LAYERS
                                       for k in ("w", "b")]


def test_autograd_function_on_cpu_matches_autograd_of_ref(case):
    gtf, x, eps, cots = case
    got = _grads_through(tscan.bfvi_scan, x, gtf, eps, cots)
    exp = _grads_through(tscan.bfvi_scan_fwd_ref, x, gtf, eps, cots)
    for i, (g, e) in enumerate(zip(got, exp)):
        _assert_grads(g.numpy(), e.numpy(), str(i))


def _plain_rows(res):
    """The xs rows of bfvi_scan_bwd_ref's own first layers (h1, hn; zeros
    for z_nonlin), from the same F.linear calls as the plain backward."""
    z_traj, gtf = res[7], res[5]
    rows = []
    for tt in range(1, z_traj.shape[0]):
        acts = [torch.relu(torch.nn.functional.linear(
            z_traj[tt - 1], gtf[n]["w"], gtf[n]["b"]))
            for n in ("gate_1", "nonlin_1")]
        rows.append(torch.cat(acts + [torch.zeros_like(z_traj[0])], -1))
    return torch.stack(rows).reshape(-1, 2 * H + D)


@pytest.fixture(scope="module")
def bwd_case(case):
    gtf, x, eps, cots = case
    outs = tscan.bfvi_scan_fwd_ref(*map(t, x), port_gtf(gtf), t(eps),
                                   MIN_STD)
    res = tuple(map(t, x)) + (port_gtf(gtf), t(eps), outs[5], outs[0],
                              outs[1])
    return res, [t(c) for c in cots]


def _flat(outs):
    return list(outs[:4]) + [outs[4][n][kk] for n in tscan.GTF_LAYERS
                             for kk in ("w", "b")]


def test_bwd_ref_on_its_own_masks_is_bwd_ref(bwd_case):
    res, cots = bwd_case
    got, margins = tscan.bfvi_scan_bwd_ref_on_masks(res, cots, MIN_STD,
                                                    _plain_rows(res))
    exp = tscan.bfvi_scan_bwd_ref(res, cots, MIN_STD)
    assert all(torch.equal(g, e) for g, e in zip(_flat(got), _flat(exp)))
    assert all(m.numel() == 0 for m in margins.values())


def test_bwd_ref_on_masks_takes_and_reports_a_flip(bwd_case):
    """A unit that the rows turn on, at the last step, is on in the plain
    backward: its weight-gradient row moves, and the flip is reported with
    its exact pre-activation's margin."""
    res, cots = bwd_case
    z_traj, gtf = res[7], res[5]
    w, b = gtf["gate_1"]["w"], gtf["gate_1"]["b"]
    pre = torch.nn.functional.linear(z_traj[-2], w, b)  # step T - 1
    kk, bb, j = [int(i) for i in np.argwhere(pre.numpy() < 0)[0]]
    rows = _plain_rows(res)
    rows.reshape(T - 1, K, B, -1)[-1, kk, bb, j] = 1e-7
    got, margins = tscan.bfvi_scan_bwd_ref_on_masks(res, cots, MIN_STD,
                                                    rows)
    exp = tscan.bfvi_scan_bwd_ref(res, cots, MIN_STD)
    z64, w64, b64 = z_traj[-2, kk, bb].double(), w[j].double(), b[j].double()
    margin = abs(z64 @ w64 + b64) / ((z64.abs() @ w64.abs()) + b64.abs())
    assert margins["nonlin_1"].numel() == 0
    np.testing.assert_allclose(margins["gate_1"].numpy(), [margin.item()],
                               rtol=1e-12)
    moved = (got[4]["gate_1"]["w"] != exp[4]["gate_1"]["w"]).any(-1)
    assert moved[j]
    assert margin > tscan.relu_flip_bound(D)  # a real unit, far from 0


def test_kernel_wrappers_refuse_cpu_tensors(case):
    """No quiet fallback: the CUDA wrappers raise on CPU tensors."""
    gtf, x, eps, cots = case
    outs = tscan.bfvi_scan_fwd_ref(*map(t, x), port_gtf(gtf), t(eps),
                                   MIN_STD)
    res = tuple(map(t, x)) + (port_gtf(gtf), t(eps), outs[5], outs[0],
                              outs[1])
    n_rows = (T - 1) * K * B
    with pytest.raises(ValueError, match="CUDA"):
        tscan.bfvi_scan_fwd_cuda(*map(t, x), port_gtf(gtf), t(eps), MIN_STD)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.bfvi_scan_bwd_cuda(res, [t(c) for c in cots], MIN_STD)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.gtf_wgrad_cuda(outs[5], torch.zeros((n_rows, 2 * H + D)),
                             torch.zeros((n_rows, 2 * H + 4 * D)))


def test_kernel_size_limits_stated():
    """The kernels keep activations in device memory and walk a column's
    particles in chunks, so neither K nor the widths are bound by shared
    memory: the wrapper takes 1 <= K <= MAX_K (at least 256) at any width;
    the 16-byte rows of their tile loads want widths that are multiples of
    4, which the wrapper pads other widths to. K = 0 and K past MAX_K
    raise."""
    assert tscan.MAX_K >= 256
    for k in (0, tscan.MAX_K + 1):
        with pytest.raises(ValueError, match="particles"):
            tscan._check_sizes(k, 256, 256)
    assert tscan._check_sizes(4, 30, 24) == (32, 24)
    assert tscan._check_sizes(4, 5, 20) == (8, 20)
    assert tscan._check_sizes(tscan.MAX_K, 512, 512) == (512, 512)
    assert tscan._check_sizes(33, 1024, 1021) == (1024, 1024)
