"""The port's evaluation against the JAX package's: SSIM, the host
collation and deletion operators and ``BatchLoader`` over a synthetic
Weizmann fixture, on-device task composition, and one device-path
``evaluate`` batch of the Weizmann app (a MAP task and the 200-particle
BFVI task) against the JAX task-eval kernel's semantics with the same
weights, state and noise."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodal_dmm_tpu.apps.weizmann import WeizmannTrainer as JWeizmann
from multimodal_dmm_tpu.data import multiseq as jmseq
from multimodal_dmm_tpu.data import weizmann as jweizmann
from multimodal_dmm_tpu.models.dmm import MultiDMM as JMultiDMM
from multimodal_dmm_tpu.ops.ssim import eval_ssim as jssim
from multimodal_dmm_tpu.training import eval_engine as jengine
from multimodal_dmm_tpu.training.loader import BatchLoader as JLoader
from multimodal_dmm_tpu_torch.apps import weizmann as tw
from multimodal_dmm_tpu_torch.data import multiseq as tmseq
from multimodal_dmm_tpu_torch.models.dmm import MultiDMM as TMultiDMM
from multimodal_dmm_tpu_torch.ops.ssim import eval_ssim
from multimodal_dmm_tpu_torch.training import eval_engine as tengine
from multimodal_dmm_tpu_torch.training.loader import BatchLoader

from torch_parity import np_tree, port_tree, t


@pytest.mark.parametrize("shape", [(6, 3, 16, 16), (4, 1, 64, 64)])
def test_ssim_matches_jax(shape):
    """rtol 1e-5 / atol 1e-6: the same f32 blur, summed in another
    order."""
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    for full in (False, True):
        got = eval_ssim(t(x), t(y), full=full)
        exp = jssim(jnp.asarray(x), jnp.asarray(y), full=full)
        for g, e in zip(got if full else (got,), exp if full else (exp,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6)


def _task_batch(rng, t_max=12, b_dim=5, mods=("a", "b")):
    lengths = np.sort(rng.randint(4, t_max + 1, b_dim))[::-1]
    lengths = lengths.astype(np.float32)
    lengths[-1] = 0.0  # a ghost column
    targets = {}
    for m in mods:
        x = rng.randn(t_max, b_dim, 2).astype(np.float32)
        for i, le in enumerate(lengths.astype(int)):
            x[le:, i] = np.nan
        targets[m] = x
    return targets, lengths


@pytest.mark.parametrize("task", [
    dict(start_frac=0.25, stop_frac=0.75),
    dict(start_frac=0.0, stop_frac=0.5, drop_mods=("b",)),
    dict(start_frac=0.5, stop_frac=1.0, keep_mods=("a",)),
])
def test_compose_task_deterministic_equals_jax(task):
    """With ``drop_frac`` 0 the task is deterministic: bit-equal to the
    JAX package's."""
    targets, lengths = _task_batch(np.random.RandomState(1))
    kw = dict(drop_mods=task.get("drop_mods", ()),
              keep_mods=task.get("keep_mods", ()))
    exp = jengine.compose_task(
        {m: jnp.asarray(v) for m, v in targets.items()},
        jnp.asarray(lengths), jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.float32(task["start_frac"]), jnp.float32(task["stop_frac"]),
        **kw)
    got = tengine.compose_task({m: t(v) for m, v in targets.items()},
                               t(lengths), torch.Generator().manual_seed(0),
                               0.0, task["start_frac"], task["stop_frac"],
                               **kw)
    for m in targets:
        np.testing.assert_array_equal(got[m].numpy(), np.asarray(exp[m]))


def test_compose_task_random_deletion_count():
    """Exactly int(drop_frac * L) valid steps deleted per (modality,
    sequence), nothing restored, and the modalities drawn apart."""
    targets, lengths = _task_batch(np.random.RandomState(2), t_max=30,
                                   b_dim=6)
    drop = 0.4
    got = tengine.compose_task({m: t(v) for m, v in targets.items()},
                               t(lengths), torch.Generator().manual_seed(3),
                               drop, 0.0, 1.0)
    gone = {}
    for m in targets:
        was = ~np.isnan(targets[m][..., 0])
        now = ~np.isnan(got[m][..., 0].numpy())
        assert not (now & ~was).any()
        gone[m] = was & ~now
        np.testing.assert_array_equal(
            gone[m].sum(axis=0),
            (np.float32(drop) * lengths).astype(np.int32))
    assert (gone["a"] != gone["b"]).any()


@pytest.fixture(scope="module")
def weizmann_fixture(tmp_path_factory):
    """The JAX package's synthetic Weizmann corpus, small: 2 persons x 3
    actions at 16x16, lengths 5-11."""
    root = tmp_path_factory.mktemp("weizmann")
    jweizmann.gen_synthetic(str(root), persons_subset=["daria", "shahar"],
                            actions_subset=["bend", "jack", "walk"],
                            t_range=(5, 12), img_size=16)
    return jweizmann.WeizmannDataset(str(root), item_as_dict=True)


@pytest.mark.parametrize("kw", [dict(batch_size=4), dict(batch_size=5,
                                                        len_bucket=8),
                                dict(batch_size=4, shuffle=True)])
def test_batch_loader_matches_jax(weizmann_fixture, kw):
    """Same batches, masks, lengths, order and ids as the JAX loader
    (shuffled with the same numpy seed), bit for bit."""
    np.random.seed(11)
    exp = list(JLoader(weizmann_fixture, **kw))
    np.random.seed(11)
    got = list(BatchLoader(weizmann_fixture, **kw))
    assert len(got) == len(exp) == len(BatchLoader(weizmann_fixture, **kw))
    for (gb, gm, gl, go, gi), (eb, em, el, eo, ei) in zip(got, exp):
        assert (gl, go, gi) == (el, eo, ei)
        np.testing.assert_array_equal(gm, em)
        assert gb.keys() == eb.keys()
        for m in eb:
            np.testing.assert_array_equal(gb[m], eb[m])


def test_host_operators_match_jax(weizmann_fixture):
    """``seq_collate_dict``, ``rand_delete`` (same numpy seed),
    ``keep_segment`` and ``seq_decoll_dict``, bit for bit."""
    items = [weizmann_fixture[i] for i in range(5)]
    got = tmseq.seq_collate_dict(items)
    exp = jmseq.seq_collate_dict(items)
    assert got[2:] == exp[2:]
    np.testing.assert_array_equal(got[1], exp[1])
    batch, lengths, order = got[0], got[2], got[3]
    for m in batch:
        np.testing.assert_array_equal(batch[m], exp[0][m])
    np.random.seed(5)
    g_in = tmseq.keep_segment(tmseq.rand_delete(batch, 0.5, lengths), 0.2,
                              0.9, lengths)
    np.random.seed(5)
    e_in = jmseq.keep_segment(jmseq.rand_delete(batch, 0.5, lengths), 0.2,
                              0.9, lengths)
    recon = {"video": (batch["video"], batch["video"] * 0.5)}
    for g, e in ((g_in, e_in),
                 (tmseq.seq_decoll_dict(g_in, lengths, order),
                  jmseq.seq_decoll_dict(e_in, lengths, order)),
                 (tmseq.seq_decoll_dict(recon, lengths, order),
                  jmseq.seq_decoll_dict(recon, lengths, order))):
        assert g.keys() == e.keys()
        for m in g:
            for a, b in zip(g[m] if isinstance(g[m], list) else [g[m]],
                            e[m] if isinstance(e[m], list) else [e[m]]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("avg", [False, True])
def test_model_losses_match_jax(avg):
    """``loss``, ``kld_loss`` and ``rec_loss`` over Normal, Bernoulli and
    Categorical modalities with NaN-missing targets, a length mask and
    one modality's multiplier 0; rtol 1e-5."""
    mods, dims = ["a", "b", "c"], [4, 6, 3]
    dists = ["Normal", "Bernoulli", "Categorical"]
    jmodel = JMultiDMM(mods, dims, dists=dists, z_dim=5, h_dim=7)
    tmodel = TMultiDMM(mods, dims, dists=dists, z_dim=5, h_dim=7)
    rng = np.random.RandomState(6)
    t_max, b_dim = 7, 4
    targets = {"a": rng.randn(t_max, b_dim, 4),
               "b": (rng.rand(t_max, b_dim, 6) > 0.5).astype(float),
               "c": rng.randint(0, 3, (t_max, b_dim, 1)).astype(float)}
    for x in targets.values():
        x[rng.rand(t_max, b_dim) < 0.3] = np.nan
    probs = rng.rand(t_max, b_dim, 3) + 0.1
    recon = {"a": (rng.randn(t_max, b_dim, 4), rng.rand(t_max, b_dim, 4)
                   + 0.2),
             "b": (rng.rand(t_max, b_dim, 6) * 0.9 + 0.05,),
             "c": (probs / probs.sum(-1, keepdims=True),)}
    infer = (rng.randn(t_max, b_dim, 5), rng.rand(t_max, b_dim, 5) + 0.1)
    prior = (rng.randn(t_max, b_dim, 5), rng.rand(t_max, b_dim, 5) + 0.1)
    mask = np.arange(t_max)[:, None, None] < np.array([7, 6, 4, 2])[
        None, :, None]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    tree = (targets, infer, prior, recon)
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(f32(x)), tree)
    ttree = jax.tree_util.tree_map(lambda x: t(f32(x)), tree)
    rec_mults = {"a": 2.0, "b": 0.0, "c": 10.0}
    exp = jmodel.loss(*jtree[:3], jtree[3], jnp.asarray(mask), 0.3,
                      rec_mults, avg=avg)
    got = tmodel.loss(*ttree[:3], ttree[3], t(mask), 0.3, rec_mults, avg=avg)
    np.testing.assert_allclose(float(got), float(exp), rtol=1e-5)
    for name, args in (("kld_loss", (jtree[1], jtree[2])),
                       ("rec_loss", (jtree[0], jtree[3]))):
        targs = (ttree[1], ttree[2]) if name == "kld_loss" else (ttree[0],
                                                                 ttree[3])
        np.testing.assert_allclose(
            float(getattr(tmodel, name)(*targs, t(mask))),
            float(getattr(jmodel, name)(*args, jnp.asarray(mask))),
            rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# One evaluation batch of the Weizmann app against the JAX task eval
# ---------------------------------------------------------------------------

MODS = tw.DEFAULTS["modalities"]
REC_MULTS = {m: tw.DEFAULTS["rec_mults"][m] for m in MODS}


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """The Weizmann model at z = h = 8 with JAX weights and randomised
    BatchNorm running statistics, carried to the port; three 64x64
    synthetic sequences in one batch of 4 (one ghost column)."""
    root = tmp_path_factory.mktemp("weizmann64")
    jweizmann.gen_synthetic(str(root), persons_subset=["shahar"],
                            actions_subset=["bend", "run", "wave1"],
                            t_range=(5, 9))
    data = jweizmann.WeizmannDataset(str(root), item_as_dict=True)
    args = types.SimpleNamespace(model_args={"z_dim": 8, "h_dim": 8},
                                 model="dmm", modalities=MODS)
    jmodel = JWeizmann.build_model(None, JMultiDMM, args)
    tmodel = tw.build_model(model_args={"z_dim": 8, "h_dim": 8})
    jparams, jstate = jmodel.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)

    def bn_stats(tree):
        if isinstance(tree, dict):
            return {k: (rng.randn(*np.shape(v)).astype(np.float32) * 0.2
                        if k == "mean" else
                        (rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
                        if k == "var" else bn_stats(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [bn_stats(v) for v in tree]
        return tree

    jstate = bn_stats(np_tree(jstate))
    tparams, tstate = port_tree(jparams, jstate, tmodel)
    return data, jmodel, tmodel, jparams, jstate, tparams, tstate


def _jax_task_eval(jmodel, jparams, jstate, data, key, task, eval_args,
                   monkey=None):
    """The JAX Trainer's device eval (``_get_task_eval`` and
    ``_evaluate_device``, trainer.py:633-643 and :704-729) for one batch:
    compose, forward, the app's metric kernel, the host reduction and
    ``summarize_metrics``. Returns the summary and the forward's filter
    noise."""
    dev = jengine.DeviceEvalData(data, MODS, 4)
    (b,) = dev.batches
    k1, k2 = jax.random.split(key)
    inputs = jengine.compose_task(
        b.targets, b.lengths_dev, k1, jnp.float32(0.0),
        jnp.float32(task["start_frac"]), jnp.float32(task["stop_frac"]),
        tuple(task["drop_mods"]), (), modalities=MODS)
    (infer, prior, recon), _ = jmodel.forward(jparams, jstate, inputs,
                                              rng=k2, **eval_args)
    out = JWeizmann.compute_metrics_device(None, jmodel, infer, prior,
                                           recon, b.targets, b.mask,
                                           b.lengths_dev, REC_MULTS)
    metrics = {k: float(v) if np.ndim(v) == 0 else
               [np.asarray(v)[i] for i in b.order] for k, v in out.items()}
    t_max, b_dim = b.mask.shape[:2]
    eps = jmodel._filter_eps(jax.random.split(k2, 4)[1], t_max,
                             eval_args.get("flt_particles", 1), b_dim, True,
                             False)
    return JWeizmann.summarize_metrics(None, metrics, sum(b.lengths)), eps


@pytest.mark.parametrize("method", [None, "bfvi"])
def test_device_evaluate_matches_jax_task_eval(eval_setup, monkeypatch,
                                               method):
    """A MAP task (the second half of each sequence deleted) and the
    200-particle BFVI task (action dropped, middle segment kept) on the
    device path of ``WeizmannTrainer.evaluate``, against the JAX task
    eval with the same filter noise. Deterministic tasks, so the inputs
    are the same; every summary value within rtol 1e-4 / atol 1e-5."""
    data, jmodel, tmodel, jparams, jstate, tparams, tstate = eval_setup
    task = (dict(start_frac=0.0, stop_frac=0.5, drop_mods=[])
            if method is None else
            dict(start_frac=0.25, stop_frac=0.75, drop_mods=["action"]))
    args = tw.eval_namespace(method, drop_frac=0.0, **task)
    eval_args = dict({"sample": False}, **args.eval_args)
    exp, jeps = _jax_task_eval(jmodel, jparams, jstate, data,
                               jax.random.PRNGKey(4), task, eval_args)
    if method == "bfvi":
        plain_eps = tmodel._filter_eps

        def filter_eps(gen, t_len, n, b, do_sample, sample_init, device):
            if do_sample:
                assert jeps.shape == (t_len, n, b, tmodel.z_dim)
                return t(np.asarray(jeps))
            return plain_eps(gen, t_len, n, b, do_sample, sample_init,
                             device)
        monkeypatch.setattr(tmodel, "_filter_eps", filter_eps)
    trainer = tw.WeizmannTrainer(tmodel, lr=5e-4, rec_mults=REC_MULTS,
                                 params=tparams, state=tstate, device="cpu")
    _, got = trainer.evaluate(BatchLoader(data, 4), args,
                              collect_results=False)
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_host_evaluate_equals_device_evaluate(eval_setup):
    """On a deterministic MAP task the host path (numpy task composition,
    results collected) gives the device path's summary, and collects the
    sequences' targets, inputs and reconstructions as the JAX host path
    does (``seq_decoll_dict`` with each batch's ``order``)."""
    data, _, tmodel, _, _, tparams, tstate = eval_setup
    trainer = tw.WeizmannTrainer(tmodel, lr=5e-4, rec_mults=REC_MULTS,
                                 params=tparams, state=tstate, device="cpu")
    args = tw.eval_namespace(None, drop_frac=0.0, start_frac=0.25,
                             stop_frac=0.75)
    loader = BatchLoader(data, 2)
    _, dev_summary = trainer.evaluate(loader, args, collect_results=False)
    results, host_summary = trainer.evaluate(loader, args)
    for k in dev_summary:
        np.testing.assert_allclose(host_summary[k], dev_summary[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    exp_ids, exp_video = [], []
    for targets, _, lengths, order, ids in JLoader(data, 2):
        exp_ids += [ids[i] for i in order]
        exp_video += jmseq.seq_decoll_dict(targets, lengths, order)["video"]
    assert results["seq_ids"] == exp_ids
    assert len(results["recon"]["video"]) == len(exp_video) == len(data)
    for i, video in enumerate(exp_video):
        length = len(video)
        np.testing.assert_array_equal(results["targets"]["video"][i], video)
        assert results["recon"]["video"][i].shape == (length, 1, 3, 64, 64)
        assert np.isnan(results["inputs"]["video"][i][:int(0.25 * length)]
                        ).all()
