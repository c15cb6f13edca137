"""The readers of the program's spans (``core/spans.py`` and the metrics
that use it) on slices built by hand: self time less nested spans, device
idle gaps by where their middle falls, and nothing to read where the
slice has no span or no device operation."""

import pytest

from portbench.core import spans
from portbench.core.spec import reader
from portbench.core.trace import Slice

# Microseconds. Two training steps under one epoch:
#   epoch [0, 200]: batch [10, 20] with its copy [12, 14],
#   step [30, 80] with forward [35, 50] and encode [36, 40] in it,
#   backward [50, 60], finite [60, 65], optimizer [65, 75];
#   loss [85, 90]; a second batch [100, 110] and step [120, 190] with
#   finite [150, 160]; loss [192, 196].
EPOCH = [("mdmm/train.epoch", 0, 200),
         ("mdmm/train.batch", 10, 20), ("mdmm/sync.batch_copy", 12, 14),
         ("mdmm/train.step", 30, 80), ("mdmm/train.forward", 35, 50),
         ("mdmm/dmm.encode", 36, 40), ("mdmm/train.backward", 50, 60),
         ("mdmm/sync.finite", 60, 65), ("mdmm/train.optimizer", 65, 75),
         ("mdmm/sync.loss", 85, 90),
         ("mdmm/train.batch", 100, 110), ("mdmm/train.step", 120, 190),
         ("mdmm/sync.finite", 150, 160), ("mdmm/sync.loss", 192, 196),
         ("aten::mm", 40, 45), ("cudaLaunchKernel", 41, 42)]
# Device operations: gaps (5, 15) middle 10, (25, 140) middle 82.5,
# (145, 150) middle 147.5.
DEVICE = [("k0", 0, 5), ("k1", 15, 25), ("k2", 140, 145), ("k3", 150, 199)]


def _slice(host=EPOCH, device=DEVICE, units=2):
    return Slice(list(device), list(host), 0.0002, units)


def test_total_and_self_time():
    sl = _slice()
    assert spans.total_ms(sl, "train.batch") == pytest.approx(0.020)
    # The epoch less its batches, steps and loss syncs: 200 - (10 + 50
    # + 5 + 10 + 70 + 4) = 51 us.
    assert spans.self_ms(sl, "train.epoch") == pytest.approx(0.051)
    # A step less forward, backward, finite and optimizer (encode lies
    # inside forward), and the second step less its finite sync.
    assert spans.self_ms(sl, "train.step") == pytest.approx(
        (50 - 40 + 70 - 10) / 1e3)
    assert spans.self_ms(sl, "train.forward") == pytest.approx(0.011)


def test_self_time_counts_overlapping_children_once():
    host = [("mdmm/a", 0, 100), ("mdmm/b", 10, 50), ("mdmm/c", 40, 60)]
    assert spans.self_ms(_slice(host), "a") == pytest.approx(0.050)


def test_idle_under_a_span_by_the_gaps_middle():
    sl = _slice()
    # The gap (5, 15) has its middle in the first batch; (25, 140) in
    # the epoch alone (82.5 lies between step and loss); (145, 150) in
    # the second step, before its finite sync.
    assert spans.idle_ms_under(sl, "train.batch") == pytest.approx(0.010)
    assert spans.idle_ms_under(sl, "train.step") == pytest.approx(0.005)
    assert spans.idle_ms_under(sl, "sync.finite") == 0.0
    assert spans.idle_ms_under(sl, "train.epoch") == pytest.approx(0.130)
    assert spans.idle_ms_under(sl, "sync.loss") == 0.0


def test_syncs_are_the_sync_spans():
    assert spans.syncs(_slice()) == [(12, 14), (60, 65), (85, 90),
                                     (150, 160), (192, 196)]


@pytest.mark.parametrize("metric,value", [
    ("driver.host_ms_per_step.train", 0.051 / 2),
    ("loader.host_ms_per_step.train", 0.020 / 2),
    ("optimizer.host_ms_per_step.train", 0.010 / 2),
    ("host.syncs_per_step.train", 5 / 2),
    ("host.sync_ms_per_step.train", 0.026 / 2),
    ("host.syncs_per_eval", 5 / 2),
    ("host.sync_ms_per_eval", 0.026 / 2),
])
def test_count_and_time_readers(metric, value):
    assert reader(metric)({"slice": _slice()}) == pytest.approx(value)


def test_filter_readers():
    host = [("mdmm/eval.call", 0, 100), ("mdmm/eval.forward", 5, 90),
            ("mdmm/dmm.filter", 10, 60), ("mdmm/sync.readback", 92, 99)]
    device = [("k", 0, 12), ("k", 20, 30), ("k", 70, 80), ("Memcpy", 95, 96)]
    sl = _slice(host, device, units=1)
    # Gaps (12, 20) and (30, 70): middles 16 and 50 inside the filter;
    # (80, 95) at 87.5 outside it.
    assert reader("eval_filter.idle_ms_per_eval")({"slice": sl}) == (
        pytest.approx(0.048))
    assert reader("eval_filter.host_ms_per_eval")({"slice": sl}) == (
        pytest.approx(0.050))
    assert reader("host.syncs_per_eval")({"slice": sl}) == 1
    assert reader("host.sync_ms_per_eval")({"slice": sl}) == (
        pytest.approx(0.007))


@pytest.mark.parametrize("metric", [
    "driver.host_ms_per_step.train", "loader.host_ms_per_step.train",
    "optimizer.host_ms_per_step.train", "host.syncs_per_step.train",
    "host.sync_ms_per_step.train", "eval_filter.host_ms_per_eval",
    "eval_filter.idle_ms_per_eval", "host.syncs_per_eval",
    "host.sync_ms_per_eval"])
@pytest.mark.parametrize("case", ["no span", "no device op", "no slice"])
def test_nothing_to_read(metric, case):
    """A program without the spans (the parent of the change that added
    them), a slice traced without a card, and an untraced run read
    None."""
    sl = {"no span": _slice([("aten::mm", 0, 10)]),
          "no device op": _slice(device=[]),
          "no slice": None}[case]
    assert reader(metric)({"slice": sl}) is None
