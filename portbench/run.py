"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload weizmann.train --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout on a machine with an NVIDIA GPU. It loads the
cell's configuration and traffic mix (``BENCHMARK.json``), makes the data
and weights from ``--seed``, builds and warms the program
(``multimodal_dmm_tpu_torch``), measures for ``--seconds``, checks what
the timed path produced against the plain reference (``reference/``),
and prints the numbers compared beside their limits as the last lines of
standard error and one JSON object as the last line of standard output.
With ``--trace 1`` a profiled slice follows the window and the line holds
the cell's per-layer metrics instead of its end-to-end ones. Without a
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result; with JAX or the JAX package loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Modules that no run may hold once its window has closed: JAX and the JAX
# package, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_dmm_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in watts from nvidia-smi, None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(cell, out, device_info, trace):
    """The result's JSON object; the checks' numbers come last."""
    from portbench.core.checks import verdict
    from portbench.core.spec import reader
    correct, rows = verdict(out.numbers, cell.limits)
    correct = correct and out.failed == 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.metrics}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device_info}
    sl = out.ctx["slice"]
    if trace and sl is not None:
        line["device"] = dict(device_info, busy_s=sl.busy_s,
                              window_s=sl.window_s)
        line["breakdown"] = {"device_ops": sl.top_device_ops(),
                             "idle_gaps": sl.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.core.spec import Cell, driver, load_benchmark
    cell = Cell(load_benchmark(), args.workload)
    run_cell = driver(cell.mix["kind"]).run

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print("portbench: %s needs %d CUDA device(s); torch sees %d" % (
            cell.name, cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    cfg = cell.cfg["precision"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["cudnn_tf32"]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    trace_path = None
    if args.trace:
        trace_path = Path(os.environ.get("TMPDIR", "/tmp")) / (
            "portbench_%s_%d.json" % (cell.name, args.seed))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START, trace_path)
    found = forbidden_modules()
    if found:
        print("portbench: modules loaded that no run may load: %s"
              % ", ".join(found), file=sys.stderr)
        return 3
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": out.ctx["peak"],
                   "power_limit_w": power_limit_w()}
    line, rows = result_line(cell, out, device_info, bool(args.trace))
    print("set-up seconds at the end of each stage: %s" % json.dumps(
        out.ctx["stages"]), file=sys.stderr)
    print("measured, reported or not: %s" % json.dumps(out.metrics),
          file=sys.stderr)
    unit_s = sorted(out.ctx["unit_s"])
    print("window: %d epochs or calls, seconds each: min %.4f median %.4f "
          "max %.4f" % (len(unit_s), unit_s[0], unit_s[len(unit_s) // 2],
                        unit_s[-1]), file=sys.stderr)
    for name, value, limit in rows:
        print("check %s %r limit %r" % (name, value, limit), file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
