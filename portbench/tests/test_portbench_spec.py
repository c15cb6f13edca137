"""BENCHMARK.json against the benchmark's contract, and the files its
names lead to."""

import json
import os
import re

import pytest

from conftest import ROOT
from portbench.core.spec import BENCH_DIR, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# A full check: 2 + 14 runs a cell, each allowed run_seconds + 60, each
# cell 2 x 90 s to compile, 1,200 s spare, within 43,200 s at 24 cells.
MAX_CELLS = 24


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    total = (2 + 14 * MAX_CELLS) * (bench["run_seconds"] + 60) + (
        MAX_CELLS * 180 + 1200)
    assert total <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_cells_files_and_chips(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= MAX_CELLS
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == "portbench/configs/%s.json" % c["name"]
        cfg = json.loads((BENCH_DIR / "configs" / (c["name"] + ".json"))
                         .read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in cells:
        cell = Cell(bench, w["name"])
        assert (BENCH_DIR / "drivers" / (cell.mix["kind"] + ".py")).exists()
        assert cell.limits, "no limits/%s.json" % w["name"]


def test_every_cell_reports_setup_another_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_cells_exist(bench, kind):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[kind]:
        assert set(m.get("workloads", [])) <= cells


def test_per_layer_cells_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        assert (BENCH_DIR / "metrics" / (m["name"] + ".py")).exists()


def test_layers_are_perf_mds_layers(bench):
    """Each metric's layer is a row of PERF.md's table of layers, letter
    for letter."""
    text = open(os.path.join(ROOT, "PERF.md")).read()
    section = text[text.index("## 3. Layers"):text.index("## 4. Cells")]
    rows = {line.split("|")[1].strip() for line in section.splitlines()
            if line.startswith("| ") and not line.startswith("| Layer")}
    assert {m["layer"] for m in bench["per_layer"]} <= rows


def test_roofline_and_mfu_units(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") \
                or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
