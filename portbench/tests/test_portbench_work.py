"""The work functions against counts made by hand at small shapes, and the
step's operation count against torch's FlopCounterMode over the plain
reference on the CPU."""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import SEED
from portbench.core.checks import initial_weights, leaves
from portbench.core.data import make_corpus
from portbench.reference.model import Reference
from portbench.reference.replay import EvalBatch, TrainBatches
from portbench.work import kernels as kw
from portbench.work import model_flops as mf


def test_scan_work_by_hand():
    # T = 3, M = 2, B = 1, K = 2, D = 4, H = 8: two steps of two particle
    # rows through 2 (D(2H+D) + 2HD + DD) = 2 (80 + 64 + 16) operations.
    (ff, fb), (bf, bb), (wf, wb) = kw.scan_work([3], 2, 2, 4, 8)
    assert ff == 2 * 2 * 2 * (4 * 20 + 64 + 16) == 1280
    assert bf == 3 * ff and wf == ff
    n_w = 4 * 20 + 64 + 16 + 16 + 12
    obs = 2 * 3 * 2 * 4 + 3 * 2
    assert fb == 4 * (obs + 8 + n_w + 24 + 5 * 12 + 24)
    assert wb == 4 * (4 * (4 + 20 + 32) + n_w)
    assert kw.scan_kernels_work([3], 2, 2, 4, 8) == (ff + 2 * ff, fb + bb)


def test_scan_work_counts_real_steps_and_weights_per_launch():
    # Columns of 3 and 1 steps: two transition steps in all, as one column
    # of 3; the second column adds its observations and state, not rows.
    (ff, fb), _, (wf, wb) = kw.scan_work([3, 1], 2, 2, 4, 8)
    (f1, b1), _, (w1, _) = kw.scan_work([3], 2, 2, 4, 8)
    assert ff == f1 and wf == w1 and fb > b1
    n_w = 4 * 20 + 64 + 16 + 16 + 12
    assert kw.scan_work([3], 2, 2, 4, 8, launches=3)[0][1] == b1 + 4 * 2 * n_w
    # A rectangle of real columns is the launch's whole work.
    assert kw.scan_work([5] * 4, 2, 2, 4, 8)[0][0] == 4 * 4 * 2 * 2 * 160


def test_cell_and_step_work_by_hand():
    # M = 2, K = 3, B = 2, D = 4: 8 (b, d) elements, 24 particle ones.
    assert kw.cell_work(2, 3, 2, 4) == (8 * (8 + 10 + 9),
                                        4 * (16 + 32 + 4 + 24 + 24 + 24))
    assert kw.step_work(2, 3, 2, 4) == (24 * 32 + 8 * 26,
                                        4 * (120 + 24 + 16 + 32 + 4 + 40))


def test_filter_pass_bound_follows_the_running_columns():
    # Lengths 3 and 1: the cell over both columns, then two steps over one.
    expect = (kw.bound_ms(*kw.cell_work(2, 3, 2, 4))
              + 2 * kw.bound_ms(*kw.step_work(2, 3, 1, 4)))
    assert math.isclose(kw.filter_pass_bound_ms([3, 1], 2, 3, 4), expect)


def test_bound_takes_the_larger():
    assert kw.bound_ms(67e9, 1.0) == 1.0
    assert math.isclose(kw.bound_ms(1.0, 3.35e9), 1.0)
    assert math.isclose(kw.bound_ms(165e9, 0, kw.PEAK_F32_PRODUCTS), 1.0)


def test_conv_shapes_follow_the_codecs():
    video = {"codec": "image", "dims": [3, 64, 64], "n_kernels": 64,
             "n_layers": 3}
    audio = {"codec": "audio", "dims": [10, 1281], "n_kernels": 16,
             "n_layers": 3}
    enc, dec = mf._conv_shapes(video)
    assert enc == [(3, 16, 9, 1024), (16, 32, 9, 256), (32, 64, 9, 64)]
    assert dec == [(64, 32, 16, 64), (32, 16, 16, 256), (16, 3, 16, 1024)]
    enc, dec = mf._conv_shapes(audio)
    assert [e[3] for e in enc] == [641, 321, 161]
    assert [d[3] for d in dec] == [161, 321, 641]
    assert mf._feat_dim(video) == 4096 and mf._feat_dim(audio) == 2576


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_train_step_flops_match_the_counter(tiny_cell):
    for name in ("weizmann.train", "vidtimit.train"):
        cfg = tiny_cell(name).cfg
        items = make_corpus(cfg, 3, "cpu", ("train",))["train"]
        names = [m["name"] for m in cfg["modalities"]]
        tr = cfg["train"]
        data = TrainBatches(items, names, tr["batch_size"], 0.2, "cpu")
        inputs, targets, mask, _ = next(data.epoch(SEED))
        params, state = initial_weights(cfg, 5, "cpu")
        for _, p in leaves(params):
            p.requires_grad_(True)
        ref = Reference(cfg)
        gen = torch.Generator().manual_seed(1)

        def step():
            ref.step_loss(params, state, inputs, targets, mask, 1.0,
                          gen).backward()
        t_max, b_dim = mask.shape[:2]
        # Every slot counted as real: the padded launch's whole work.
        assert _counted(step) == mf.train_flops(cfg, [t_max] * b_dim)
        # A padded step or column is no work.
        assert mf.train_flops(cfg, [t_max - 1] * b_dim) < mf.train_flops(
            cfg, [t_max] * b_dim)
        assert mf.train_flops(cfg, [t_max] * (b_dim - 1)) < mf.train_flops(
            cfg, [t_max] * b_dim)


def test_eval_flops_match_the_counter(tiny_cell):
    cfg = tiny_cell("weizmann.eval").cfg
    items = make_corpus(cfg, 3, "cpu", ("test",))["test"]
    names = [m["name"] for m in cfg["modalities"]]
    batch = EvalBatch(items, names, cfg["eval"]["batch_sz_eval"], "cpu")
    params, state = initial_weights(cfg, 5, "cpu")
    ref = Reference(cfg)
    gen = torch.Generator().manual_seed(1)
    inputs = batch.task(gen, 0.5, 0.0, 1.0)

    def forward():
        with torch.no_grad():
            ref.eval_forward(params, state, inputs, gen)
    t_max, b_dim = batch.mask.shape[:2]
    assert _counted(forward) == mf.eval_flops(cfg, [t_max] * b_dim)
    real = [it["length"] for it in items]
    assert len(real) < b_dim
    assert mf.eval_flops(cfg, real) < mf.eval_flops(cfg, [t_max] * b_dim)
