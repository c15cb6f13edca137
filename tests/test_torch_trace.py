"""The port's program spans (``training/diagnostics.py:span``): nothing
without a profiler; under one, each phase of a training step and of an
evaluation once a step or call, nested as the layers nest, as host-only
events; and a span at every host synchronisation.

The file imports neither JAX nor the JAX package, so on the GPU machine
its card tests run on their own: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_trace.py``.
"""

import ast
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import multimodal_dmm_tpu_torch
from multimodal_dmm_tpu_torch.apps.spirals import SpiralsTrainer
from multimodal_dmm_tpu_torch.ops.ssim import eval_ssim
from multimodal_dmm_tpu_torch.training import diagnostics
from multimodal_dmm_tpu_torch.training.device_loader import DeviceTrainData
from multimodal_dmm_tpu_torch.training.diagnostics import span
from multimodal_dmm_tpu_torch.training.loader import BatchLoader

MODS = ["spiral-x", "spiral-y"]
BATCH = 4
PACKAGE = Path(multimodal_dmm_tpu_torch.__file__).parent

# Each span of one training step and of one evaluation call of the
# spirals model (two modalities, so three loss variants): (span, its
# parent among the program's spans, how many a step or a batch). A sync
# span wraps each call that torch.cuda.set_sync_debug_mode reports as
# synchronising on the card.
TRAIN = {
    "device": [("train.batch", "train.epoch", 1),
               ("sync.batch_copy", "train.batch", 2)],
    # Each modality's inputs and targets, and the mask.
    "host": [("train.batch", "train.epoch", 1),
             ("sync.batch_copy", "train.batch", 5)],
}
STEP = [("train.step", "train.epoch", 1),
        ("train.forward", "train.step", 1),
        ("dmm.encode", "train.forward", 1),
        # Each objective mode's variant masks, and each modality's
        # active variant rows in each mode.
        ("sync.variant_mask", "train.forward", 2),
        ("sync.variant_rows", "train.forward", 4),
        ("train.backward", "train.step", 1),
        ("sync.finite", "train.step", 1),
        ("train.optimizer", "train.step", 1),
        ("sync.loss", "train.epoch", 1)]
EVAL = {
    # The three metrics of each batch, read back at the call's end.
    "device": [("eval.task", "eval.call", 1),
               ("eval.metrics", "eval.call", 1),
               ("sync.readback", "eval.call", 3)],
    # The task's inputs; the metrics' targets, mask and lengths and
    # their read-back; each modality's mean and std reconstruction.
    "host": [("eval.task", "eval.call", 1),
             ("sync.batch_copy", "eval.task", 2),
             ("eval.metrics", "eval.call", 1),
             ("sync.batch_copy", "eval.metrics", 4),
             ("sync.readback", "eval.metrics", 3),
             ("sync.readback", "eval.call", 4)],
}
FORWARD = [("eval.forward", "eval.call", 1),
           ("dmm.encode", "eval.forward", 1),
           ("dmm.filter", "eval.forward", 1),
           ("dmm.smooth", "eval.forward", 1),
           ("dmm.decode", "eval.forward", 1)]


def _items(n=6, seed=0):
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        length = int(rng.randint(8, 13))
        item = {m: rng.randn(length, 1).astype(np.float32) for m in MODS}
        item.update(length=length, id=i)
        items.append(item)
    return items


def _trainer(device):
    cls = SpiralsTrainer
    args = cls.parser.parse_args(["--method", "bfvi", "--seed", "3",
                                  "--device", str(device)])
    args.modalities = list(MODS)
    args.batch_size = args.batch_sz_eval = BATCH
    args.train_args = dict(train_particles=3, match_particles=4)
    args.eval_args = dict(flt_particles=5)
    args = cls.pre_build_args(args)
    trainer = cls(cls.build_model(args), lr=args.lr, seed=3, device=device)
    args = trainer.post_build_args(args) or args
    return trainer, args


def _train_loader(trainer, args, loader):
    items = _items()
    if loader == "device":
        return DeviceTrainData(items, MODS, BATCH, args.burst_frac,
                               device=trainer.device)
    return BatchLoader(items, BATCH)


def _mdmm(prof):
    """{event: name} of the program's spans, with each one's nearest
    enclosing span."""
    spans = []
    for e in prof.events():
        if not e.name.startswith("mdmm/"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("mdmm/"):
            parent = parent.cpu_parent
        spans.append((e.name[5:], None if parent is None
                      else parent.name[5:], e))
    return spans


def _expect(table, units):
    out = {}
    for name, parent, n in table:
        out[(name, parent)] = out.get((name, parent), 0) + n * units
    return out


def _counts(spans):
    out = {}
    for name, parent, _ in spans:
        out[(name, parent)] = out.get((name, parent), 0) + 1
    return out


def test_span_without_a_profiler_is_the_shared_null_context():
    first = span("mdmm/train.step")
    assert first is diagnostics.NO_SPAN
    assert span("mdmm/sync.loss") is first
    with first:
        # A profiler started inside a span that was handed out without
        # one finds no event of it.
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(3).sum()
    assert not [e for e in prof.events() if e.name.startswith("mdmm/")]


def test_span_under_a_profiler_is_a_host_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mdmm/outer"):
            with span("mdmm/inner"):
                torch.ones(3).sum()
    spans = _mdmm(prof)
    assert _counts(spans) == {("outer", None): 1, ("inner", "outer"): 1}
    assert not any(e.is_user_annotation for _, _, e in spans)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for _, _, e in spans)


@pytest.mark.parametrize("loader", ["device", "host"])
def test_training_step_spans(loader):
    """One epoch of two steps: every span of the table once a step, the
    epoch's once, each under its parent, none a user annotation."""
    trainer, args = _trainer("cpu")
    train = _train_loader(trainer, args, loader)
    trainer.train(train, 1, args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(train, 2, args)
    steps = len(train)
    spans = _mdmm(prof)
    want = _expect(TRAIN[loader] + STEP, steps)
    want[("train.epoch", None)] = 1
    assert _counts(spans) == want
    assert not any(e.is_user_annotation for _, _, e in spans)


@pytest.mark.parametrize("path", ["device", "host"])
def test_evaluation_spans(path):
    """One evaluation of two batches: the forward's and the task's spans
    once a batch, the call's once, each under its parent."""
    trainer, args = _trainer("cpu")
    loader = BatchLoader(_items(), BATCH)
    collect = path == "host"
    args.visualize = False
    trainer.evaluate(loader, args, collect_results=collect)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.evaluate(loader, args, collect_results=collect)
    spans = _mdmm(prof)
    want = _expect(EVAL[path] + FORWARD, len(loader))
    want[("eval.call", None)] = 1
    assert _counts(spans) == want
    assert not any(e.is_user_annotation for _, _, e in spans)


def test_ssim_window_copy_is_a_sync_span():
    x = torch.rand(2, 1, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eval_ssim(x, x)
    assert _counts(_mdmm(prof)) == {("sync.ssim_window", None): 1}


def test_sync_sites_have_spans():
    """Each synchronising site of the tables is a span of the program's
    source, ``with span("mdmm/sync.<site>")``."""
    rows = STEP + [row for table in (TRAIN, EVAL)
                   for part in table.values() for row in part]
    sites = {name for name, _, _ in rows if name.startswith("sync.")}
    sites.add("sync.ssim_window")
    found = set()
    for path in PACKAGE.rglob("*.py"):
        for _, name in _sync_blocks(path):
            found.add(name)
    assert sites <= found, sites - found


def _sync_blocks(path):
    """[((first line, last line), site)] of the ``with span("mdmm/sync.
    ...")`` blocks of a source file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call)
                    and getattr(call.func, "id", None) == "span"
                    and call.args and isinstance(call.args[0], ast.Constant)
                    and call.args[0].value.startswith("mdmm/sync.")):
                out.append(((node.lineno, node.end_lineno),
                            call.args[0].value[5:]))
    return out


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _device_ops(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _kernels(prof):
    return Counter(e.name for e in _device_ops(prof)
                   if not e.is_user_annotation)


@pytest.mark.cuda
def test_spans_put_nothing_on_the_device(card, monkeypatch):
    """A profiled epoch on the card: no device operation carries a
    program span's name, and the device runs the same operations as with
    every span turned off (the profiler's own annotations of the
    optimizer's step on the device's track left aside)."""
    trainer, args = _trainer(card)
    train = _train_loader(trainer, args, "device")
    trainer.train(train, 1, args)

    def traced(epoch):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train(train, epoch, args)
            torch.cuda.synchronize()
        return prof
    on = traced(2)
    assert any(e.name.startswith("mdmm/") for e in on.events())
    assert not [e.name for e in _device_ops(on)
                if e.name.startswith("mdmm/")]
    monkeypatch.setattr(diagnostics, "_profiling", lambda: False)
    off = traced(3)
    assert not any(e.name.startswith("mdmm/") for e in off.events())
    assert _kernels(on) == _kernels(off)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["train", "eval"])
def test_every_sync_on_the_card_is_in_a_sync_span(card, phase):
    """Under ``set_sync_debug_mode("warn")`` and a profiler, each
    synchronisation that a training epoch or an evaluation makes is
    inside a sync span of the program's source (by its innermost frame in
    the package), and there are as many as the profiler has sync spans."""
    trainer, args = _trainer(card)
    train = _train_loader(trainer, args, "device")
    loader = BatchLoader(_items(), BATCH)

    def run():
        if phase == "train":
            trainer.train(train, 2, args)
        else:
            trainer.evaluate(loader, args, collect_results=False)
    run()
    torch.cuda.synchronize()
    stacks = []

    def keep(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stacks.append(traceback.extract_stack())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    blocks, program = {}, 0
    for stack in stacks:
        frames = [f for f in stack
                  if Path(f.filename).resolve().is_relative_to(PACKAGE)]
        if not frames:
            continue
        program += 1
        where = frames[-1]
        path = Path(where.filename).resolve()
        if path not in blocks:
            blocks[path] = _sync_blocks(path)
        assert any(lo <= where.lineno <= hi
                   for (lo, hi), _ in blocks[path]), (
            "%s:%d synchronises outside a sync span: %s" % (
                path.name, where.lineno, where.line))
    assert program > 0
    assert program == sum(name.startswith("sync.")
                          for name, _, _ in _mdmm(prof))
