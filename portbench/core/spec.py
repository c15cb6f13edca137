"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose sizes are
``configs/<name>.json``, and a traffic mix, ``mixes/<name>.json``, whose
``kind`` names its driver, ``drivers/<kind>.py``. The numbers that decide
``correct`` are held to ``limits/<cell>.json``. A per-layer metric is read
by ``metrics/<metric name>.py``'s ``read(ctx)``.
"""

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(path=None):
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def _json(kind, name):
    return json.loads((BENCH_DIR / kind / (name + ".json")).read_text())


class Cell:
    """One workload of the benchmark with its configuration, mix, limits
    and metrics."""

    def __init__(self, bench, name):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit("no workload %r in BENCHMARK.json" % name)
        self.workload = found[0]
        self.name = name
        self.chips = self.workload["chips"]
        self.cfg = _json("configs", self.workload["config"])
        self.mix = _json("mixes", self.workload["traffic"])
        path = BENCH_DIR / "limits" / (name + ".json")
        self.limits = json.loads(path.read_text()) if path.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def reader(metric_name):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / (metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind):
    """The module ``drivers/<kind>.py`` of a mix's ``kind``."""
    if not (BENCH_DIR / "drivers" / (kind + ".py")).exists():
        raise SystemExit("no driver drivers/%s.py" % kind)
    return importlib.import_module("portbench.drivers." + kind)
