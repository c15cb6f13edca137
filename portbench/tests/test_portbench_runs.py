"""Whole runs of each cell on the CPU at a tiny size, the program on its
plain PyTorch paths: the drivers, the reference and the comparison, with
the look for a card skipped. A sound run is correct; the control (the
reference in bfloat16 in the program's place) and each fault that a cell
can have, planted under the timed path, are not."""

import itertools
import time

import pytest
import torch

from conftest import SEED
from portbench import run
from portbench.core import checks, program
from portbench.core.common import seeds
from portbench.core.data import make_corpus
from portbench.core.program import trainer_class
from portbench.core.spec import driver

CPU = torch.device("cpu")
DEVICE = {"platform": "gpu", "kind": "none", "count": 1,
          "memory_peak_bytes": 0}


def _run(cell, seconds=0.0, trace=False):
    out = driver(cell.mix["kind"]).run(cell, SEED, seconds, trace, CPU,
                                       time.perf_counter())
    line, _ = run.result_line(cell, out, DEVICE, trace)
    return out, line


@pytest.mark.parametrize("name", ["weizmann.train", "weizmann.eval",
                                  "vidtimit.train"])
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    out, line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    # The CPU has no device trace: only the host clock's metrics.
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end
                                    if m["source"] == "host_clock"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert out.attempted >= 1 and out.failed == 0


def test_traced_run_on_the_cpu_reports_no_device_metric(tiny_cell):
    cell = tiny_cell("weizmann.eval")
    cell.mix = dict(cell.mix, trace_calls=2)
    out, line = _run(cell, trace=True)
    assert line["correct"]
    assert line["metrics"] == {}
    assert line["device"]["busy_s"] == 0


def test_control_is_not_correct(tiny_cell):
    cell = tiny_cell("weizmann.train")
    data_seed, weight_seed, prog_seed = seeds(SEED)
    items = make_corpus(cell.cfg, data_seed, CPU, ("train",))["train"]
    ref = checks.reference_train(cell.cfg, items, weight_seed, prog_seed,
                                 CPU)
    ctrl = checks.reference_train(cell.cfg, items, weight_seed, prog_seed,
                                  CPU, control="bf16")
    numbers = checks.compare_train(ctrl, ref)
    assert not checks.verdict(numbers, cell.limits)[0], numbers


def test_eval_control_is_not_correct(tiny_cell):
    cell = tiny_cell("weizmann.eval")
    data_seed, weight_seed, prog_seed = seeds(SEED)
    items = make_corpus(cell.cfg, data_seed, CPU, ("test",))["test"]
    calls = [3, 5]
    ref = checks.reference_eval(cell.cfg, items, weight_seed, prog_seed, CPU,
                                calls)
    ctrl = checks.reference_eval(cell.cfg, items, weight_seed, prog_seed,
                                 CPU, calls, control="bf16")
    numbers = checks.compare_eval(cell.cfg, ctrl, ref)
    assert not checks.verdict(numbers, cell.limits)[0], numbers


@pytest.mark.parametrize("kind,fault", [
    (kind, fault) for kind in ("train", "eval")
    for fault in driver(kind).FAULTS])
def test_fault_is_not_correct(tiny_cell, kind, fault):
    cell = tiny_cell("weizmann." + kind)
    undo = driver(kind).FAULTS[fault](trainer_class(cell.cfg["app"]),
                                      cell.cfg)
    try:
        _, line = _run(cell)
    finally:
        undo()
    assert not line["correct"], line["checks"]


def test_run_without_a_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "weizmann.train", "--seed", str(SEED),
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card, bench):
    from portbench.core.spec import Cell
    cell = Cell(bench, "weizmann.eval")
    out = driver("eval").run(cell, SEED, 2.0, False, card,
                             time.perf_counter())
    line, _ = run.result_line(cell, out, DEVICE, False)
    assert line["correct"], line["checks"]


def test_config_sections_pass_through_to_the_app(tiny_cell):
    cell = tiny_cell("weizmann.train")
    cfg = cell.cfg
    cfg["model_args"] = {"bf16_gtf": True}
    cfg["train"]["ragged_mode_scans"] = True
    params, state = checks.initial_weights(cfg, 3, CPU)
    trainer, args = program.build(cfg, params, state, 5, CPU)
    assert trainer.model.bf16_gtf
    assert args.train_args["ragged_mode_scans"] is True
    assert args.train_args["train_particles"] == 3
    assert args.batch_size == 4 and args.batch_sz_eval == 4
    assert args.eval_args["flt_particles"] == 5


def test_a_length_table_sets_each_sequence(tiny_cell):
    cfg = tiny_cell("weizmann.eval").cfg
    groups = cfg["data"]["groups"]
    table = {"_".join(ix): 7 + i for i, ix in enumerate(
        itertools.product(*groups.values()))}
    cfg["data"]["length_table"] = table
    items = make_corpus(cfg, 3, CPU, ("test",))["test"]
    assert items
    for it in items:
        assert it["length"] == table["_".join(it["id"])]
        assert len(it["video"]) == it["length"]


def test_a_mix_kind_is_found_by_its_file():
    assert driver("train").run and driver("eval").control
    with pytest.raises(SystemExit):
        driver("no_such_kind")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tf32", "bf16"])
def test_eval_controls_on_the_card_are_not_correct(card, bench, kind):
    from portbench.core.spec import Cell
    cell = Cell(bench, "weizmann.eval")
    numbers, _ = driver("eval").control(cell, SEED, card, kind)
    assert not checks.verdict(numbers, cell.limits)[0], numbers


@pytest.mark.cuda
def test_train_bf16_control_on_the_card_is_not_correct(card, bench):
    from portbench.core.spec import Cell
    cell = Cell(bench, "weizmann.train")
    numbers, _ = driver("train").control(cell, SEED, card, "bf16")
    assert not checks.verdict(numbers, cell.limits)[0], numbers
