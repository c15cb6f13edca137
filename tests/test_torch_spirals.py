"""The port's spirals app against the JAX package's: the corpus (the same
bytes from both generators, read by either loader, without pandas on the
port's side), the ``--method`` remap of both apps, the BFVI step at the
spirals widths (z = 5, h = 20), the scan kernels' zero-padding to their
widths (on the plain versions), the command line on the CPU for BFVI, a
DKS baseline and the VRNN, and DKS and VRNN checkpoints evaluated across
the two packages to the same MAP metrics."""

import filecmp
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.apps.spirals import SpiralsTrainer as JSpirals
from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer as JWeizmann
from multimodal_dmm_tpu.data import spirals as jsp
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.apps import spirals as ts
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.data import spirals as tsp
from multimodal_dmm_tpu_torch.models import nn as tnn
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan
from multimodal_dmm_tpu_torch.training import checkpoint as tck

from torch_parity import (assert_trees_close, grads_of, port_tree, t,
                          with_grad)

MODS = ["spiral-x", "spiral-y"]


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """param_hist.tsv goes to the working directory."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spirals_data"))
    tsp.gen_dataset(n_examples=14, n_train=8, timesteps=16, data_dir=d)
    return d


# ---------------------------------------------------------------------------
# The corpus
# ---------------------------------------------------------------------------

def test_corpus_bytes_and_loaders(tmp_path, monkeypatch):
    """The full corpus (1,000 spirals, 600 / 400): the port writes the JAX
    package's bytes; the port's loader, with pandas unavailable, reads the
    generator's float64 values bit for bit from either corpus; the JAX
    loader (pandas' default parser, which is not round-trip exact: a few
    units in the last place of float64) agrees to 1e-14."""
    jsp.gen_dataset(data_dir=str(tmp_path / "jax"))
    tsp.gen_dataset(data_dir=str(tmp_path / "port"))
    for sub, n in (("train", 600), ("test", 400)):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == n
        _, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "jax" / sub, tmp_path / "port" / sub, names,
            shallow=False)
        assert not mismatch and not errors

    _, spirals = tsp.gen_spirals()
    monkeypatch.setitem(sys.modules, "pandas", None)
    port = tsp.SpiralsDataset(MODS, str(tmp_path / "jax"), "test",
                              truncate=True, item_as_dict=True)
    monkeypatch.delitem(sys.modules, "pandas")
    jax_set = jsp.SpiralsDataset(MODS, str(tmp_path / "port"), "test",
                                 truncate=True, item_as_dict=True)
    assert port.seq_ids == jax_set.seq_ids and len(port) == 400
    assert port.modalities == jax_set.modalities == MODS + ["metadata"]
    cols = {"spiral-x": [2], "spiral-y": [3], "metadata": [0, 1, 4, 5, 6, 7]}
    for i, (seq_id,) in enumerate(port.seq_ids):
        exp = spirals[int(seq_id)]
        for m, c in cols.items():
            np.testing.assert_array_equal(port.data[m][i], exp[:, c])
            np.testing.assert_allclose(jax_set.data[m][i], exp[:, c],
                                       rtol=1e-14, atol=1e-15)


def test_csv_table_selects_and_drops(tmp_path):
    from multimodal_dmm_tpu_torch.data.multiseq import CsvTable
    path = tmp_path / "t.tsv"
    path.write_text("a\tb\tc\n1.5\t-2e-05\t3\n0.1\t4\t5\n")
    tab = CsvTable.read(str(path), sep="\t")
    np.testing.assert_array_equal(np.array(tab.select(["c", "a"])),
                                  [[3.0, 1.5], [5.0, 0.1]])
    assert tab.drop(["b"]).columns == ["a", "c"]
    assert np.array(tab)[0, 1] == -2e-05


# ---------------------------------------------------------------------------
# The --method remap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["spirals", "weizmann"])
@pytest.mark.parametrize("method", [None, "bfvi", "b-mask", "f-mask",
                                    "b-skip", "f-skip", "nonsense"])
def test_method_remap_matches_jax(app, method):
    """The port's ``pre_build_args`` leaves the same args as the JAX app's
    (model, model_args, train_args, eval_args, batch_sz_eval)."""
    jcls, tcls = {"spirals": (JSpirals, ts.SpiralsTrainer),
                  "weizmann": (JWeizmann, tw.WeizmannTrainer)}[app]
    argv = ["--model_args", "{z_dim: 8}", "--train_args",
            "{train_particles: 3}", "--eval_args", "{smt_particles: 2}"]
    if method is not None:
        argv += ["--method", method]
    jargs = jcls.parser.parse_args(argv)
    targs = tcls.parser.parse_args(argv)
    jargs = object.__new__(jcls).pre_build_args(jargs)
    targs = tcls.pre_build_args(targs)
    for key in ("model", "model_args", "train_args", "eval_args",
                "batch_sz_eval"):
        assert getattr(targs, key) == getattr(jargs, key), key


# ---------------------------------------------------------------------------
# The BFVI step at the spirals widths
# ---------------------------------------------------------------------------

def _spirals_batch(seed, t_max=12, b_dim=5):
    rng = np.random.RandomState(seed)
    targets = {m: rng.randn(t_max, b_dim, 1).astype(np.float32)
               for m in MODS}
    inputs = {m: v.copy() for m, v in targets.items()}
    for v in inputs.values():
        v[rng.rand(t_max, b_dim) < 0.3] = np.nan
    mask = np.ones((t_max, b_dim, 1), np.float32)
    mask[9:, 1] = 0.0
    return inputs, targets, mask


def test_bfvi_step_at_spirals_width_matches_jax():
    """The app's model (z = 5, h = 20): the fused step's loss and
    gradients (MAP passes, joint and unimodal ELBOs, prior matching off)."""
    args = types.SimpleNamespace(modalities=MODS, model_args={},
                                 model="dmm")
    jmodel = JSpirals.build_model(None, JMultiDMM, args)
    tmodel = ts.build_model(MODS)
    assert (tmodel.z_dim, tmodel.h_dim) == (jmodel.z_dim, jmodel.h_dim) \
        == (5, 20)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(4))
    inputs, targets, mask = _spirals_batch(6)
    rec_mults = {m: 0.5 for m in MODS}
    kw = dict(uni_loss=True, sample=False, match_mult=0.0,
              train_particles=1, flt_particles=1)

    def jloss(p):
        return jmodel.step(p, jstate,
                           {m: jnp.asarray(v) for m, v in inputs.items()},
                           jnp.asarray(mask), 0.5, rec_mults,
                           jax.random.PRNGKey(2),
                           targets={m: jnp.asarray(v)
                                    for m, v in targets.items()},
                           train=True, **kw)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    tparams = with_grad(tparams)
    tl, _ = tmodel.step(tparams, tstate, {m: t(v) for m, v in inputs.items()},
                        t(mask), 0.5, rec_mults, None,
                        targets={m: t(v) for m, v in targets.items()},
                        train=True, **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    exp_g, _ = port_tree(jg, jstate, tmodel)
    assert_trees_close(exp_g, grads_of(tparams), rtol=5e-3, atol=5e-4,
                       normalise=True)


# ---------------------------------------------------------------------------
# The scan kernels' padding, on the plain versions
# ---------------------------------------------------------------------------

def _scan_inputs(d, h, t_max=7, n_exp=4, b_dim=5, k=3):
    rng = np.random.RandomState(d + h)
    obs_std = (rng.rand(t_max, n_exp, b_dim, d) + 0.2).astype(np.float32)
    obs_std[:, -1] = -(obs_std[:, -1] + 2.0)  # an inverse expert
    arrays = [rng.randn(t_max, n_exp, b_dim, d), obs_std,
              rng.rand(t_max, n_exp, b_dim) > 0.4,
              rng.randn(b_dim, d) * 0.1, rng.rand(b_dim, d) * 0.5 + 0.7,
              rng.randn(t_max, k, b_dim, d)]
    x = [torch.tensor(np.asarray(a, np.float32)) for a in arrays]
    gtf = tnn.gtf_init(torch.Generator().manual_seed(d), d, h)
    cots = [torch.tensor(rng.randn(t_max, b_dim, d).astype(np.float32))
            for _ in range(5)]
    return x[:5], gtf, x[5], cots


@pytest.mark.parametrize("d,h", [(5, 20), (7, 13)])
def test_padding_to_kernel_widths_leaks_nothing(d, h):
    """The plain forward and backward on the inputs zero-padded as the CUDA
    wrappers pad them give, on the real dims, the unpadded results (up to
    summation order), and finite values on the padded ones; the weight
    gradients of padded rows equal those of the real rows."""
    x, gtf, eps, cots = _scan_inputs(d, h)
    dp, hp = tscan._check_sizes(eps.shape[1], d, h)
    assert dp % 4 == 0 and hp % 4 == 0 and (dp, hp) != (d, h)
    exp = tscan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3)
    x_p, gtf_p, eps_p = tscan._pad_scan_inputs(*x, gtf, eps, dp, hp)
    got = tscan.bfvi_scan_fwd_ref(*x_p, gtf_p, eps_p, 1e-3)
    for g, e in zip(got, exp):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g[..., :d].numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[5][..., d:].numpy(), 0.0)

    res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
    e_b = tscan.bfvi_scan_bwd_ref(res, cots, 1e-3)
    g_b = tscan.bfvi_scan_bwd_ref(*tscan._pad_bwd_inputs(res, cots, dp, hp),
                                  1e-3)
    for g, e in zip(g_b[:4], e_b[:4]):
        np.testing.assert_array_equal(g[..., d:].numpy(), 0.0)
        _close_normalised(g[..., :d], e)
    g_w = tscan._unpad_gtf(g_b[4], d, h)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            _close_normalised(g_w[name][kk], e_b[4][name][kk])

    # The rows of the weight-gradient kernel, padded block by block.
    n_rows = (eps.shape[0] - 1) * eps.shape[1] * eps.shape[2]
    rng = np.random.RandomState(0)
    xs = torch.tensor(rng.randn(n_rows, 2 * h + d).astype(np.float32))
    ys = torch.tensor(rng.randn(n_rows, 2 * h + 4 * d).astype(np.float32))
    xs_p = tscan._pad_blocks(xs, (h, h, d), (hp, hp, dp))
    ys_p = tscan._pad_blocks(ys, (h, h) + (d,) * 4, (hp, hp) + (dp,) * 4)
    assert torch.equal(tscan._unpad_blocks(xs_p, (h, h, d), (hp, hp, dp)),
                       xs)
    w_p = tscan._unpad_gtf(tscan.gtf_wgrad_ref(tscan._pad_last(exp[5], dp),
                                               xs_p, ys_p), d, h)
    w_e = tscan.gtf_wgrad_ref(exp[5], xs, ys)
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            _close_normalised(w_p[name][kk], w_e[name][kk])


def _close_normalised(got, exp):
    scale = float(exp.abs().max()) + 1e-6
    np.testing.assert_allclose(got.numpy() / scale, exp.numpy() / scale,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def _argv(data_dir, save_dir, *extra):
    return ["--device", "cpu", "--data_dir", data_dir, "--save_dir",
            str(save_dir), "--batch_size", "4", "--seed", "3",
            "--train_args", "{train_particles: 3, match_particles: 4}",
            "--eval_args", "{flt_particles: 4}"] + list(extra)


@pytest.mark.parametrize("flags", [["--method", "bfvi"],
                                   ["--method", "bfvi", "--model_args",
                                    "{bf16_gtf: true}"],
                                   ["--method", "b-skip"],
                                   ["--model", "vrnn"]],
                         ids=["bfvi", "bfvi_bf16_gtf", "b-skip", "vrnn"])
def test_cli_trains_and_evaluates(tiny_env, tmp_path, flags):
    save = tmp_path / "save"
    hist = ts.main(_argv(tiny_env, save, "--epochs", "2", "--eval_freq", "1",
                         "--save_freq", "1", *flags))
    assert len(hist["epoch_loss"]) == 2
    assert np.all(np.isfinite(hist["epoch_loss"]))
    assert all(np.isfinite(e["mse"]) for e in hist["eval"])
    assert sorted(p.name for p in save.iterdir()) == [
        "best.pth", "epoch_1.pth", "epoch_2.pth", "last.pth"]
    assert tck.load_checkpoint(str(save / "last.pth"))["modalities"] == MODS
    runs = [ts.main(_argv(tiny_env, save, "--load", str(save / "last.pth"),
                          "--evaluate", *flags)) for _ in range(2)]
    for i in range(2):
        a, b = dict(runs[0][i]), dict(runs[1][i])
        assert a.keys() == b.keys() >= {"kld_loss", "rec_loss", "mse",
                                        "mse_std"}
        assert all(np.isfinite(v) for v in a.values())
        np.testing.assert_array_equal([a[k] for k in sorted(a)],
                                      [b[k] for k in sorted(a)])


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("flags", [["--method", "b-skip"],
                                   ["--model", "vrnn"]],
                         ids=["dks", "vrnn"])
def test_checkpoint_evaluates_to_the_same_map_metrics(tiny_env, tmp_path,
                                                      flags, writer):
    """A checkpoint written by one package, evaluated by both (MAP passes,
    the app's kept segment with no random deletion): the same metrics."""
    path = str(tmp_path / "ck.pth")
    common = ["--data_dir", tiny_env, "--save_dir", str(tmp_path / "s"),
              "--batch_size", "4", "--drop_frac", "0"] + flags
    if writer == "jax":
        jtrainer = JSpirals(JSpirals.parser.parse_args(common))
        jtrainer.save_checkpoint(MODS, path)
    else:
        targs = ts.SpiralsTrainer.parser.parse_args(common + ["--device",
                                                              "cpu"])
        ts.SpiralsTrainer.from_args(targs).save_checkpoint(MODS, path)
    evaluate = common + ["--load", path, "--evaluate", "--save_args",
                         "{skip: true}"]
    jargs = JSpirals.parser.parse_args(evaluate)
    exp = JSpirals(jargs).run_eval(jargs)
    got = ts.main(evaluate + ["--device", "cpu"])
    for e, g in zip(exp, got):
        assert e.keys() == g.keys()
        for k in e:
            np.testing.assert_allclose(g[k], e[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
