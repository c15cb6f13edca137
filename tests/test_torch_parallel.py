"""Data parallelism in the port (``multimodal_dmm_tpu_torch/parallel``) on
the CPU: gloo ranks started by the port's launcher against the JAX
package's single-device step, as tests/test_parallel.py holds the JAX
mesh path against it, on the same numpy inputs and the JAX weights
(``convert.params_from_jax``).

- The MAP step (``sample: false, match_mult: 0, train_particles: 1``) of
  the two-modality model of tests/test_parallel.py (T, B, Z, H = 12, 8, 4,
  8) under ``--mesh`` 2, 4 and 2x2: the loss at rtol 2e-5 and every
  updated leaf at that test's rtol 1e-4 / atol 1e-6.
- The same with the Weizmann modalities at narrow widths (8x8 video
  through the conv codecs with BatchNorm, person and action, z = h = 8,
  some columns masked) under 2 and 2x2, so that BatchNorm's global
  statistics and running state are held: the loss at rtol 2e-5, the
  gradients (each leaf over its largest value, as
  tests/test_torch_vidtimit.py compares them) and the BatchNorm state at
  rtol 1e-4 / atol 1e-5, every updated leaf at rtol 1e-4 / atol 1e-6
  except the convolution biases that feed a BatchNorm: their gradient is
  rounding noise in both packages, so Adam's first step moves them by
  the sign of that noise.
- Sampled steps (two of them, prior matching on) under 2 and 2x2, the
  same with the two modes' filtering passes merged into one scan
  (``merge_mode_scans``), and the DKS and VRNN baselines' sampled steps
  under 2, against the port's
  own single process with the same seed (JAX cannot share the noise):
  the ranks draw each noise tensor at the global shape and keep their
  columns, and the prior-matching term is counted once, so only the
  order of the sums differs: the losses at rtol 1e-5, the gradients and
  BatchNorm state as above.
- The command line: one MAP epoch of ``apps.spirals --device cpu --mesh
  2`` (and ``2x2``) gives the single-process epoch loss at rtol 2e-5, and
  rank 0 alone writes the checkpoints and param_hist.tsv.
- The refusals of the JAX trainer, and a trial (``Trainer.tune``) under a
  mesh.

Every process group has a timeout (``torch_parallel_ranks.TIMEOUT``), so
that a hung collective fails the test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from multimodal_dmm_tpu.models import codecs as jc
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu_torch.apps import spirals as ts
from multimodal_dmm_tpu_torch.data import spirals as tsp
from multimodal_dmm_tpu_torch.parallel import (ColumnNoise, Mesh, launch,
                                               parse_mesh, shard_batch)
from multimodal_dmm_tpu_torch.tree import tree_leaves_with_path

import torch_parallel_ranks as ranks
from torch_parity import assert_trees_close, port_tree

T, B = 12, 8
WZ_T = 5
MAP = {"train_particles": 1, "match_particles": 2, "match_mult": 0.0,
       "sample": False}
SAMPLED = {"train_particles": 3, "match_particles": 4}
MLP_MULTS = {"a": 1.0, "b": 1.0}
WZ_MULTS = {"video": 1.0, "person": 10.0, "action": 10.0}
JAX_TOL = dict(rtol=1e-4, atol=1e-6)    # tests/test_parallel.py's
GRAD = dict(rtol=1e-4, atol=1e-5)
# The jobs each mesh's ranks run (in one launch per mesh).
MESH_JOBS = {"2": ("mlp_map", "wz_map", "wz_sampled", "wz_merged",
                   "dks_sampled", "vrnn_sampled"),
             "4": ("mlp_map",),
             "2x2": ("mlp_map", "wz_map", "wz_sampled", "wz_merged")}


def _mlp_batch(seed):
    rng = np.random.RandomState(seed)
    batch = {m: rng.randn(T, B, d).astype(np.float32)
             for m, d in zip(ranks.MLP_MODS, ranks.MLP_DIMS)}
    return batch, batch, np.ones((T, B, 1), np.float32)


def _wz_batch(seed):
    """Weizmann-shaped (T, B) = (5, 8): binary 8x8 video with 30 % of the
    frames deleted, labels; two columns end after 3 steps."""
    rng = np.random.RandomState(seed)
    targets = {
        "video": (rng.rand(WZ_T, B, 3, 8, 8) > 0.5).astype(np.float32),
        "person": rng.randint(0, 10, (WZ_T, B, 1)).astype(np.float32),
        "action": rng.randint(0, 10, (WZ_T, B, 1)).astype(np.float32)}
    inputs = {m: v.copy() for m, v in targets.items()}
    inputs["video"][rng.rand(WZ_T, B) < 0.3] = np.nan
    mask = np.ones((WZ_T, B, 1), np.float32)
    mask[3:, -2:] = 0.0
    return inputs, targets, mask


def _jax_wz_model():
    kw = dict(img_size=8, n_kernels=8)
    return JMultiDMM(
        ranks.WZ_MODS, ranks.WZ_DIMS, dists=ranks.WZ_DISTS,
        encoders={"video": jc.image_encoder_codec(ranks.ZH, **kw)},
        decoders={"video": jc.image_decoder_codec(ranks.ZH, **kw)},
        z_dim=ranks.ZH, h_dim=ranks.ZH)


def _jax_step(jmodel, jparams, jstate, batch, rec_mults, kld_mult):
    """The JAX package's single-device MAP step, as tests/test_parallel.py
    takes it (jitted): (loss, gradients, updated params, new state)."""
    inputs, targets, mask = batch
    jx = lambda d: {m: jnp.asarray(v) for m, v in d.items()}  # noqa: E731

    def loss_fn(p):
        loss, new_state = jmodel.step(
            p, jstate, jx(inputs), jnp.asarray(mask), kld_mult, rec_mults,
            jax.random.PRNGKey(7), targets=jx(targets), train=True, **MAP)
        return loss / float(mask.sum()), (loss, new_state)

    grads, (loss, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jparams)
    opt = optax.chain(optax.add_decayed_weights(1e-4), optax.adam(1e-3))
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    return (float(loss), grads, optax.apply_updates(jparams, updates),
            new_state)


@pytest.fixture(scope="module")
def cases():
    """name -> (the job's ``train_steps`` arguments, what it is held to):
    the JAX step's (loss, grads, params, state) in the port's layout, or
    the port's own single process."""
    out = {}
    jmlp = JMultiDMM(ranks.MLP_MODS, ranks.MLP_DIMS, z_dim=4, h_dim=8)
    jp, js = jmlp.init(jax.random.PRNGKey(0))
    mlp = ranks.build("mlp")
    batch = _mlp_batch(0)
    loss, g, p, s = _jax_step(jmlp, jp, js, batch, MLP_MULTS, 1.0)
    params, state = port_tree(jp, js, mlp)
    out["mlp_map"] = (dict(name="mlp", params=params, state=state,
                           batches=[batch + (1.0,)], train_args=MAP,
                           rec_mults=MLP_MULTS),
                      (loss,) + port_tree(g, js, mlp)[:1]
                      + port_tree(p, s, mlp))

    jwz = _jax_wz_model()
    jp, js = jwz.init(jax.random.PRNGKey(6))
    wz = ranks.build("weizmann")
    batch = _wz_batch(1)
    loss, g, p, s = _jax_step(jwz, jp, js, batch, WZ_MULTS, 0.5)
    params, state = port_tree(jp, js, wz)
    out["wz_map"] = (dict(name="weizmann", params=params, state=state,
                          batches=[batch + (0.5,)], train_args=MAP,
                          rec_mults=WZ_MULTS),
                     (loss,) + port_tree(g, js, wz)[:1]
                     + port_tree(p, s, wz))

    merged = dict(SAMPLED, merge_mode_scans=True)
    for name, model, make, mults, train_args in (
            ("wz_sampled", "weizmann", _wz_batch, WZ_MULTS, SAMPLED),
            ("wz_merged", "weizmann", _wz_batch, WZ_MULTS, merged),
            ("dks_sampled", "dks", _mlp_batch, MLP_MULTS, {}),
            ("vrnn_sampled", "vrnn", _mlp_batch, MLP_MULTS, {})):
        params, state = ranks.build(model).init(3, device="cpu")
        job = dict(name=model, params=params, state=state,
                   batches=[make(2) + (0.5,), make(3) + (0.7,)],
                   train_args=train_args, rec_mults=mults, seed=11)
        out[name] = (job, ranks.train_steps(mesh="1", **job))
    return out


@pytest.fixture(scope="module")
def mesh_runs(cases):
    """mesh -> [each rank's {job: result}], each mesh launched once."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            n_data, n_model = parse_mesh(mesh)
            jobs = [(name, cases[name][0]) for name in MESH_JOBS[mesh]]
            runs[mesh] = launch(ranks.run_jobs, ["cpu"] * (n_data * n_model),
                                "gloo", args=(jobs, mesh),
                                timeout=ranks.TIMEOUT)
        return runs[mesh]
    return get


def _t(tree):
    """A tree of numpy arrays as one of tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.as_tensor(tree) if isinstance(tree, np.ndarray) else tree


def _leaves(tree):
    return dict(tree_leaves_with_path(_t(tree)))


def _same_on_every_rank(outs, job):
    """The replicas stay bit-identical: every rank's updated parameters
    and BatchNorm state equal rank 0's."""
    for key in ("params", "state"):
        first = _leaves(outs[0][job][key])
        for out in outs[1:]:
            for path, leaf in _leaves(out[job][key]).items():
                assert torch.equal(leaf, first[path]), (key, path)


def _updated_leaves_close(got, exp, skip=()):
    got, exp = _leaves(got), _leaves(exp)
    assert got.keys() == exp.keys()
    for path in exp:
        if path not in skip:
            np.testing.assert_allclose(got[path].numpy(), exp[path].numpy(),
                                       err_msg=str(path), **JAX_TOL)


@pytest.mark.parametrize("mesh", ["2", "4", "2x2"])
def test_map_step_matches_jax(mesh_runs, cases, mesh):
    outs = mesh_runs(mesh)
    loss, _, params, _ = cases["mlp_map"][1]
    got = outs[0]["mlp_map"]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=2e-5)
    _updated_leaves_close(got["params"], params)
    _same_on_every_rank(outs, "mlp_map")


def _bn_fed_biases(tree):
    """The bias paths of the convolutions whose output goes to a
    BatchNorm (every layer of a codec but its last)."""
    out = []
    for path, _ in tree_leaves_with_path(_t(tree)):
        if (len(path) == 5 and path[-1] == "b"
                and path[2] in ("convs", "deconvs")):
            n_bns = len(tree[path[0]][path[1]]["bns"])
            if path[3] < n_bns:
                out.append(path)
    return out


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_map_step_with_batchnorm_matches_jax(mesh_runs, cases, mesh):
    outs = mesh_runs(mesh)
    loss, grads, params, state = cases["wz_map"][1]
    got = outs[0]["wz_map"]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=2e-5)
    assert_trees_close(grads, _t(got["grads"]), normalise=True, **GRAD)
    assert_trees_close(state, _t(got["state"]), rtol=1e-4, atol=1e-5)
    noise = _bn_fed_biases(got["params"])
    assert len(noise) == 4
    _updated_leaves_close(got["params"], params, skip=noise)
    _same_on_every_rank(outs, "wz_map")


@pytest.mark.parametrize("mesh,job", [("2", "wz_sampled"),
                                      ("2x2", "wz_sampled"),
                                      ("2", "wz_merged"),
                                      ("2x2", "wz_merged"),
                                      ("2", "dks_sampled"),
                                      ("2", "vrnn_sampled")])
def test_sampled_steps_match_the_single_process(mesh_runs, cases, mesh,
                                                job):
    exp = cases[job][1]
    got = mesh_runs(mesh)[0][job]
    np.testing.assert_allclose(got["losses"], exp["losses"], rtol=1e-5)
    assert_trees_close(_t(exp["grads"]), _t(got["grads"]), normalise=True,
                       **GRAD)
    if _leaves(exp["state"]):  # BatchNorm's (the DKS and VRNN have none)
        assert_trees_close(_t(exp["state"]), _t(got["state"]), rtol=1e-4,
                           atol=1e-5)
    _same_on_every_rank(mesh_runs(mesh), job)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spirals_data"))
    tsp.gen_dataset(n_examples=16, n_train=8, timesteps=16, data_dir=d)
    return d


def _argv(data_dir, save_dir, *extra):
    """One MAP epoch of 8 sequences in one batch, an evaluation and the
    checkpoints."""
    return ["--device", "cpu", "--data_dir", data_dir, "--save_dir",
            str(save_dir), "--epochs", "1", "--batch_size", "8",
            "--burst_frac", "0.0", "--seed", "3", "--eval_freq", "1",
            "--save_freq", "1", "--eval_args", "{flt_particles: 4}",
            "--train_args",
            "{sample: false, match_mult: 0.0, train_particles: 1}"] + list(
                extra)


@pytest.fixture(scope="module")
def single_epoch(corpus, tmp_path_factory):
    """The single-process run's history."""
    tmp = tmp_path_factory.mktemp("single")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        return ts.main(_argv(corpus, tmp / "save"))


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_cli_epoch_matches_the_single_process(corpus, single_epoch,
                                              tmp_path, monkeypatch, mesh):
    monkeypatch.chdir(tmp_path)
    save = tmp_path / "save"
    hist = ts.main(_argv(corpus, save, "--mesh", mesh))
    np.testing.assert_allclose(hist["epoch_loss"], single_epoch["epoch_loss"],
                               rtol=2e-5)
    assert len(hist["eval"]) == 1 and np.isfinite(hist["eval"][0]["mse"])
    assert sorted(p.name for p in save.iterdir()) == [
        "best.pth", "epoch_1.pth", "last.pth"]
    # The header and rank 0's row.
    assert len((tmp_path / "param_hist.tsv").read_text().splitlines()) == 2


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x2", "--method", "b-mask"], "variant"),
    (["--mesh", "2", "--batch_size", "5"], "divisible"),
    (["--mesh", "2", "--device", "cuda"], "needs 2 devices but only 1"),
], ids=["2d-dks", "batch-size", "too-few-cards"])
def test_mesh_refusals(corpus, tmp_path, monkeypatch, flags, match):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--device", "cpu", "--data_dir", corpus, "--save_dir",
            str(tmp_path / "s")] + flags
    with pytest.raises(ValueError, match=match):
        ts.main(argv)


def test_tune_under_a_mesh_runs_the_trial(corpus, tmp_path, monkeypatch):
    """The trial's ranks train and evaluate; rank 0's reports reach the
    caller's reporter, the last one ``done``
    (tests/test_torch_mesh_eval.py holds them to one process)."""
    monkeypatch.chdir(tmp_path)
    rows = []
    ts.SpiralsTrainer.tune({"device": "cpu", "data_dir": corpus,
                            "save_dir": str(tmp_path / "save"), "mesh": "2",
                            "epochs": 1, "eval_freq": 1, "batch_size": 8},
                           lambda **kw: rows.append(kw))
    assert [r["done"] for r in rows] == [False, True]
    assert all(np.isfinite(r["mean_loss"]) for r in rows)
    assert (tmp_path / "save" / "last.pth").exists()


# ---------------------------------------------------------------------------
# The pieces, without a process group
# ---------------------------------------------------------------------------

def _fake_mesh(n_data, n_model, rank):
    mesh = Mesh.__new__(Mesh)
    mesh.n_data, mesh.n_model = n_data, n_model
    mesh.rank = rank
    mesh.data_index, mesh.model_index = divmod(rank, n_model)
    return mesh


def test_parse_mesh():
    assert [parse_mesh(s) for s in ("0", "1", 0, None, "4", "2x2", "4X2")] \
        == [(1, 1), (1, 1), (1, 1), (1, 1), (4, 1), (2, 2), (4, 2)]


def test_variant_rows_split_uneven_and_refuse_empty_shares():
    assert [_fake_mesh(2, 2, r).variant_rows(3) for r in range(4)] == [
        [0, 1], [2], [0, 1], [2]]
    assert _fake_mesh(4, 1, 3).variant_rows(4) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="some would get none"):
        _fake_mesh(1, 4, 0).variant_rows(3)


@pytest.mark.parametrize("n_data,n_model,v_dim", [(4, 1, None), (2, 1, 3),
                                                  (2, 2, 3), (1, 3, 4)])
def test_column_noise_is_the_global_draw_cut(n_data, n_model, v_dim):
    """Each rank's draw is its block of columns (of its variants) of the
    draw at the global shape; the generator moves alike on every rank."""
    b_local, shape = 3, (5, 2, 7)
    v_all = v_dim or 1
    g = torch.Generator().manual_seed(4)
    full = torch.randn((shape[0], shape[1], v_all * n_data * b_local,
                        shape[2]), generator=g)
    full = full.reshape(shape[0], shape[1], v_all, n_data * b_local,
                        shape[2])
    after = torch.randn(3, generator=g)
    for rank in range(n_data * n_model):
        mesh = _fake_mesh(n_data, n_model, rank)
        rows = mesh.variant_rows(v_dim) if v_dim else [0]
        gen = torch.Generator().manual_seed(4)
        noise = ColumnNoise(gen, mesh, b_local)
        if v_dim:
            noise = noise.stacked(v_dim)
        got = noise.randn((shape[0], shape[1], len(rows) * b_local,
                           shape[2]), "cpu", torch.float32, axis=2)
        cols = slice(mesh.data_index * b_local,
                     (mesh.data_index + 1) * b_local)
        exp = full[:, :, rows, cols].reshape(got.shape)
        assert torch.equal(got, exp)
        assert torch.equal(torch.randn(3, generator=gen), after)


def test_shard_batch_takes_a_block_of_columns():
    batch = {"a": torch.arange(2 * 8 * 3.0).reshape(2, 8, 3)}
    mask = torch.ones(2, 8, 1)
    got, m = shard_batch(_fake_mesh(4, 1, 2), batch, mask)
    assert torch.equal(got["a"], batch["a"][:, 4:6]) and m.shape == (2, 2, 1)
    with pytest.raises(ValueError, match="6 columns over 4"):
        shard_batch(_fake_mesh(4, 1, 0), batch, mask[:, :6])
