"""The evaluation filter's step against the JAX package, on the CPU: the
transition split at its products (``gtf_products`` + ``gtf_tail``), the
step's plain version ``poe_sample_step_ref`` against JAX's ``_z_next``
followed by the Pallas cell (interpret mode, D = 128) or its XLA
composite (D = 5), particle rows with a NaN in their product outputs, the
cell path of ``z_filter`` against JAX's ``z_filter`` with injected noise,
the kernels' launch plan and their order of summation emulated.

Tolerances. float32: rtol = atol = 1e-5 (CELL_TOL of chip_smoke.py and
tests/test_pallas_cell.py), 1e-4 with the smoothing pass's inverse
expert, whose cancelling precisions amplify the products' rounding, as
tests/test_pallas_cell.py holds the two JAX paths; the whole filter
rtol 1e-4 / atol 1e-5 as tests/test_torch_poe_cell.py. ``bf16_gtf``:
ONE_ULP (2^-7), as tests/test_torch_bf16_gtf.py: the two frameworks
round the products to bfloat16 at the same points and differ only where
an f32 sum lies at a rounding midpoint.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.models import nn as jnn
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu.ops.pallas.poe_cell import (_xla_composite,
                                                    poe_sample_cell as jcell)
from multimodal_dmm_tpu.ops.poe import (mean_of_experts as jmoe,
                                        product_of_experts_pair as jpair)
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM
from multimodal_dmm_tpu_torch.ops.cuda import poe_cell as tcell
from multimodal_dmm_tpu_torch.ops.poe import (mean_of_experts,
                                              product_of_experts_pair)

from torch_parity import port_tree, t

CELL_TOL = 1e-5
INVERSE_TOL = 1e-4
ONE_ULP = 2.0 ** -7
MIN_STD = 1e-3
MODS, DIMS = ["a", "b"], [4, 6]


@functools.lru_cache(maxsize=None)
def _models(z, h, bf16=False):
    """Both frameworks' models at (z, h) with JAX's weights carried across
    (cached: no test changes them)."""
    jmodel = JMultiDMM(MODS, DIMS, z_dim=z, h_dim=h, use_pallas=False,
                       use_scan_kernel=False, bf16_gtf=bf16)
    tmodel = TMultiDMM(MODS, DIMS, z_dim=z, h_dim=h, bf16_gtf=bf16)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    tparams, _ = port_tree(jparams, jstate, tmodel)
    return jmodel, tmodel, jparams, tparams


# ---------------------------------------------------------------------------
# (a) the transition split at its products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_gtf_products_and_tail_match_jax(bf16):
    """``gtf_tail(gtf_products(pk, z))`` against JAX's ``gtf_apply_packed``
    at z = 32, h = 24 on 7 x 5 particle rows (f32 at CELL_TOL, bf16 at
    ONE_ULP), and bit for bit the port's own ``gtf_apply_packed``; z_lin
    is a view of the first product's rows of 2H + D."""
    _, _, jparams, tparams = _models(32, 24, bf16)
    z = np.random.RandomState(1).randn(7, 5, 32).astype(np.float32)
    jp = jnn.gtf_pack(jparams["trans"]["fwd"],
                      compute_dtype=jnp.bfloat16 if bf16 else None)
    exp = jnn.gtf_apply_packed(jp, jnp.asarray(z), MIN_STD)
    pk = tnn.gtf_pack(tparams["trans"]["fwd"],
                      torch.bfloat16 if bf16 else None)
    prods = tnn.gtf_products(pk, t(z))
    assert prods[0].stride() == (5 * (2 * 24 + 32), 2 * 24 + 32, 1)
    got = tnn.gtf_tail(*prods, MIN_STD)
    tol = ONE_ULP if bf16 else CELL_TOL
    for g, e, own in zip(got, exp, tnn.gtf_apply_packed(pk, t(z), MIN_STD)):
        assert torch.equal(g, own)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# (b) the step's plain version against JAX's _z_next and the cell
# ---------------------------------------------------------------------------

def _step_case(d, h, m, k, b, seed, masked=False, inverse=False,
               bf16=False):
    """A step's inputs on both sides: particles z (K, B, D), experts,
    mask (``masked``: expert 0 masked out in every column; ``inverse``:
    the last expert the smoothing pass's inverse global prior), eps."""
    jmodel, tmodel, jparams, tparams = _models(d, h, bf16)
    rng = np.random.RandomState(seed)
    z = rng.randn(k, b, d).astype(np.float32)
    obs_mean = rng.randn(m, b, d).astype(np.float32)
    obs_std = (rng.rand(m, b, d) + 0.2).astype(np.float32)
    mask = rng.rand(m, b) > 0.3
    if masked:
        mask[0] = False
    if inverse:
        obs_std[-1] = -(obs_std[-1] + 1.0)
        mask[-1] = True
    eps = rng.randn(k, b, d).astype(np.float32)
    return (jmodel, tmodel, jparams, tparams), (z, obs_mean, obs_std, mask,
                                                eps)


def _jax_step(models, arrays, d, direction="fwd", pallas=True):
    jmodel, _, jparams, _ = models
    z, obs_mean, obs_std, mask, eps = arrays
    b = z.shape[1]
    glb_mean, glb_std = jmodel.prior_params(jparams, (b, d))
    trans = jmodel._packed_trans(jparams, direction)
    pm, ps = jmodel._z_next(trans, jnp.asarray(z), glb_mean, glb_std)
    args = (pm, ps, jnp.asarray(obs_mean), jnp.asarray(obs_std),
            jnp.asarray(mask), jnp.asarray(eps))
    cell = (jcell(*args, use_pallas=True, interpret=True) if pallas
            else _xla_composite(*args))
    return (pm, ps) + tuple(cell)


def _port_step(models, arrays, d, direction="fwd"):
    _, tmodel, _, tparams = models
    z, obs_mean, obs_std, mask, eps = arrays
    b = z.shape[1]
    glb_mean, glb_std = tmodel.prior_params(tparams, (b, d))
    prods = tnn.gtf_products(tmodel._packed_trans(tparams, direction), t(z))
    return tcell.poe_sample_step_ref(prods, glb_mean, glb_std, t(obs_mean),
                                     t(obs_std), t(mask), t(eps), MIN_STD)


STEP_CASES = {  # (M, K, masked, inverse)
    "m2_k7": (2, 7, False, False), "m3_k7": (3, 7, False, False),
    "m3_k1": (3, 1, False, False), "m2_k1_masked": (2, 1, True, False),
    "m3_k7_masked": (3, 7, True, False),
    "m3_k7_inverse": (3, 7, False, True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("d", [128, 5])
def test_step_ref_matches_jax_z_next_and_cell(case, d):
    """D = 128, B = 8 against ``_z_next`` and the Pallas cell in interpret
    mode; D = 5 against ``_z_next`` and the XLA composite (the Pallas cell
    takes D % 128 == 0 only). Each of the six outputs at CELL_TOL
    (INVERSE_TOL with the inverse expert)."""
    m, k, masked, inverse = STEP_CASES[case]
    b = 8 if d == 128 else 5
    models, arrays = _step_case(d, 24, m, k, b, 10 + m + k, masked, inverse)
    exp = _jax_step(models, arrays, d, pallas=d == 128)
    got = _port_step(models, arrays, d)
    tol = INVERSE_TOL if inverse else CELL_TOL
    for i, (g, e) in enumerate(zip(got, exp)):
        assert tuple(g.shape) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=tol,
                                   atol=tol, err_msg=str(i))


@pytest.mark.parametrize("k", [1, 7])
def test_step_ref_bf16_matches_jax(k):
    """With ``bf16_gtf``: the products rounded to bfloat16 on both sides,
    the step's outputs within ONE_ULP; the backward transition."""
    models, arrays = _step_case(16, 12, 3, k, 5, 30 + k, bf16=True)
    exp = _jax_step(models, arrays, 16, "bwd", pallas=False)
    got = _port_step(models, arrays, 16, "bwd")
    for i, (g, e) in enumerate(zip(got, exp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=ONE_ULP,
                                   atol=ONE_ULP, err_msg=str(i))


# ---------------------------------------------------------------------------
# (c) particle rows with a NaN in their product outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["std_pre", "z_lin"])
def test_nan_rows_match_jax_pair_and_mixture(where):
    """A NaN in a particle row's std pre-activation drops that row from the
    pair PoE (the global prior alone stands for it); a NaN in its z_lin
    leaks into its pair mean and the mixture's mean, as in JAX. The
    prior against JAX's ``product_of_experts_pair`` and
    ``mean_of_experts`` on the same rows (NaNs equal), at CELL_TOL."""
    d, k, b = 16, 7, 5
    models, arrays = _step_case(d, 12, 2, k, b, 40)
    _, tmodel, _, tparams = models
    z, obs_mean, obs_std, mask, eps = arrays
    prods = list(tnn.gtf_products(tmodel._packed_trans(tparams, "fwd"),
                                  t(z)))
    slot = 3 if where == "std_pre" else 0
    prods[slot] = prods[slot].clone()
    prods[slot][2, 1, 3] = float("nan")
    prods[slot][6, 4, 0] = float("nan")
    glb_mean, glb_std = tmodel.prior_params(tparams, (b, d))
    got = tcell.poe_sample_step_ref(prods, glb_mean, glb_std, t(obs_mean),
                                    t(obs_std), t(mask), t(eps), MIN_STD)
    q_mean, q_std = tnn.gtf_tail(*prods, MIN_STD)
    pm, ps = jpair(jnp.asarray(glb_mean.numpy()), jnp.asarray(
        glb_std.numpy()), jnp.asarray(q_mean.numpy()),
        jnp.asarray(q_std.numpy()))
    exp = jmoe(pm, ps)
    for g, e in zip(got[:2], exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=CELL_TOL,
                                   atol=CELL_TOL)
    nan_cols = np.isnan(got[0].numpy()).any(axis=1)
    if where == "std_pre":
        assert not nan_cols.any()
        # The dropped rows' pair is the global prior alone.
        pp_mean, pp_std = product_of_experts_pair(glb_mean, glb_std, q_mean,
                                                  q_std)
        np.testing.assert_array_equal(pp_std[2, 1].numpy(),
                                      glb_std[1].numpy())
    else:
        assert list(np.flatnonzero(nan_cols)) == [1, 4]


# ---------------------------------------------------------------------------
# (d) the cell path of z_filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_cell_path_z_filter_matches_jax(direction, k, bf16):
    """``z_filter(use_cell=True)`` (the cell at t = 0, ``gtf_products`` and
    ``poe_sample_step`` after) against JAX's ``z_filter`` with the same
    noise, T = 6, B = 5, z = 16, h = 12: rtol 1e-4 / atol 1e-5 in float32
    as tests/test_torch_poe_cell.py, ONE_ULP with ``bf16_gtf``."""
    jmodel, tmodel, jparams, tparams = _models(16, 12, bf16)
    rng = np.random.RandomState(50 + k)
    zm = rng.randn(3, 6, 5, 16).astype(np.float32)
    zs = (rng.rand(3, 6, 5, 16) + 0.3).astype(np.float32)
    zk = (rng.rand(3, 6, 5) > 0.3).astype(np.float32)
    eps = np.asarray(jmodel._filter_eps(jax.random.PRNGKey(k), 6, k, 5,
                                        True, False))
    exp = jmodel.z_filter(jparams, zm, zs, zk, None, direction=direction,
                          n_particles=k, eps=jnp.asarray(eps),
                          use_pallas=True)
    with torch.no_grad():
        got = tmodel.z_filter(tparams, t(zm), t(zs), t(zk),
                              direction=direction, n_particles=k,
                              eps=t(eps), use_cell=True)
    rtol, atol = (ONE_ULP, ONE_ULP) if bf16 else (1e-4, 1e-5)
    for g, e in zip((*got[0], *got[1], got[2]), (*exp[0], *exp[1], exp[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=rtol,
                                   atol=atol)


def test_cell_path_plain_flag_gives_the_plain_step():
    """``plain_scan = True`` takes the plain versions on any device: on
    the CPU the same numbers, the kernels' counts untouched."""
    _, tmodel, _, tparams = _models(16, 12)
    rng = np.random.RandomState(60)
    args = (t(rng.randn(2, 4, 3, 16).astype(np.float32)),
            t((rng.rand(2, 4, 3, 16) + 0.3).astype(np.float32)),
            t(rng.rand(2, 4, 3) > 0.3))
    eps = t(rng.randn(4, 9, 3, 16).astype(np.float32))
    before = (tcell.poe_sample_cell_cuda.launches,
              tcell.poe_sample_step_cuda.launches)
    outs = []
    for plain in (False, True):
        tmodel.plain_scan = plain
        with torch.no_grad():
            outs.append(tmodel.z_filter(tparams, *args, n_particles=9,
                                        eps=eps, use_cell=True))
    tmodel.plain_scan = False
    for g, e in zip((*outs[0][0], *outs[0][1], outs[0][2]),
                    (*outs[1][0], *outs[1][1], outs[1][2])):
        assert torch.equal(g, e)
    assert before == (tcell.poe_sample_cell_cuda.launches,
                      tcell.poe_sample_step_cuda.launches)


# ---------------------------------------------------------------------------
# The entry
# ---------------------------------------------------------------------------

def test_step_entry_on_cpu_is_the_plain_version():
    """On CPU tensors the entry is the plain version (``out=`` receives it);
    it raises under autograd; the CUDA wrapper refuses CPU tensors (no
    fallback); nothing is launched."""
    models, arrays = _step_case(8, 6, 2, 3, 4, 70)
    _, tmodel, _, tparams = models
    z, obs_mean, obs_std, mask, eps = arrays
    prods = tnn.gtf_products(tmodel._packed_trans(tparams, "fwd"), t(z))
    glb = tmodel.prior_params(tparams, (4, 8))
    args = (prods, *glb, t(obs_mean), t(obs_std), t(mask), t(eps), MIN_STD)
    exp = tcell.poe_sample_step_ref(*args)
    out = tuple(torch.empty_like(e) for e in exp)
    got = tcell.poe_sample_step(*args, out=out)
    for g, o, e in zip(got, out, exp):
        assert g is o and torch.equal(g, e)
    with pytest.raises(ValueError, match="no gradient"):
        tcell.poe_sample_step(prods, glb[0].clone().requires_grad_(True),
                              *args[2:])
    with pytest.raises(ValueError, match="CUDA"):
        tcell.poe_sample_step_cuda(*args)
    assert tcell.poe_sample_step_cuda.launches == 0


# ---------------------------------------------------------------------------
# (e) the launch plan and the kernels' order of summation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [True, False])
def test_plan_covers_every_shape(step):
    """Every K to 256, widths to MAX_D, odd B: the clusters cover the K
    particles with no empty CTA, the staged chunk fits the shared memory,
    and the lanes and groups are those of the kernel's threads."""
    for k in list(range(1, 20)) + [25, 64, 65, 100, 199, 200, 256]:
        for d in (1, 5, 8, 130, 256, 300, 768, 1024, 4096):
            for b_dim in (1, 13, 25, 100):
                p = tcell.poe_plan(k, b_dim, d, step)
                c, kc = p["cluster"], p["per_cta"]
                assert 1 <= c <= tcell.MAX_CLUSTER and c <= k
                assert (c - 1) * kc < k <= c * kc
                assert 1 <= p["chunk"] <= kc
                assert p["smem"] <= tcell.SMEM_LIMIT
                assert p["smem"] == tcell._smem_bytes(step, d, p["groups"],
                                                      p["chunk"])
                assert p["lanes"] == min(d, tcell.THREADS)
                assert p["groups"] == tcell.THREADS // p["lanes"]
    with pytest.raises(ValueError):
        tcell.poe_plan(0, 25, 256, step)
    with pytest.raises(ValueError):
        tcell.poe_plan(200, 25, tcell.MAX_D + 1, step)


def test_plan_at_the_apps_shapes():
    """The evaluation's 200-particle steps: Weizmann and VidTIMIT (B = 25,
    D = 256) in clusters of 8 CTAs of 25 particles, all staged, two CTAs
    an SM (at most half of the SM's 228 KB each); spirals (B = 100, D = 5)
    one CTA a column."""
    p = tcell.poe_plan(200, 25, 256, True)
    assert (p["cluster"], p["per_cta"], p["chunk"]) == (8, 25, 25)
    assert p["smem"] + 1024 <= 233472 // 2
    p = tcell.poe_plan(200, 100, 5, True)
    assert (p["cluster"], p["per_cta"], p["groups"]) == (1, 200, 51)


def _kernel_sum(x, plan):
    """The kernels' sum over the particles (axis 0 of ``x``), emulated in
    float32: in each CTA r of the cluster, each group g of threads adds
    its rows g, g + G, ... of each staged chunk in order onto a running
    sum; the groups' sums are added in order; then the CTAs' in rank
    order from 0."""
    k = x.shape[0]
    c, kc, kb, groups = (plan["cluster"], plan["per_cta"], plan["chunk"],
                         plan["groups"])
    total = torch.zeros(x.shape[1:])
    for r in range(c):
        k0 = r * kc
        n = min(k, k0 + kc) - k0
        acc = [torch.zeros(x.shape[1:]) for _ in range(groups)]
        for c0 in range(0, n, kb):
            nr = min(kb, n - c0)
            for g in range(groups):
                for i in range(g, nr, groups):
                    acc[g] = acc[g] + x[k0 + c0 + i]
        part = acc[0]
        for g in range(1, groups):
            part = part + acc[g]
        total = total + part
    return total


@pytest.mark.parametrize("k,b_dim,d,h", [(200, 25, 256, 256),
                                         (200, 100, 5, 20),
                                         (25, 13, 130, 24)])
def test_kernel_order_of_summation(k, b_dim, d, h):
    """The mixture's moments and the sample in the kernels' order of
    summation against ``mean_of_experts`` and ``z.mean(0)`` on the same
    pair-PoE rows, at the evaluation's shapes (a GTF at the app's widths
    on particles z ~ N(0, 1)): within CELL_TOL, the tolerance that the
    card holds the kernels to; the largest differences are printed."""
    gen = torch.Generator().manual_seed(k + d)
    pk = tnn.gtf_pack(tnn.gtf_init(gen, d, h))
    z = torch.randn((k, b_dim, d), generator=gen)
    q_mean, q_std = tnn.gtf_tail(*tnn.gtf_products(pk, z), MIN_STD)
    glb_mean = torch.zeros((b_dim, d))
    glb_std = torch.full((b_dim, d), 1.0 + MIN_STD)
    pm, ps = product_of_experts_pair(glb_mean, glb_std, q_mean, q_std)
    exp_mean, exp_std = mean_of_experts(pm, ps)
    plan = tcell.poe_plan(k, b_dim, d, step=True)
    mean = _kernel_sum(pm, plan) / k
    var = (_kernel_sum(ps * ps, plan) / k + _kernel_sum(pm * pm, plan) / k
           - mean * mean)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    eps = torch.randn((k, b_dim, d), generator=gen)
    zk = exp_mean[None] + eps * exp_std[None]
    sample = _kernel_sum(zk, tcell.poe_plan(k, b_dim, d, step=True)) / k
    for name, g, e in (("prior mean", mean, exp_mean),
                       ("prior std", std, exp_std),
                       ("sample", sample, zk.mean(0))):
        err = float((g - e).abs().max())
        print("%s: the kernels' order against torch's, max abs %.3g"
              % (name, err))
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=CELL_TOL,
                                   atol=CELL_TOL)
