"""Readings from which the limits of ``limits/<cell>.json`` are set.

    python3 portbench/calibrate.py --workload weizmann.train \\
        --sound 12 --control 3 --controls tf32,bf16 --faults 3 --seconds 2

runs on the card, in one process: the program on ``--sound`` seeds
(set-up, a short window, the reference; each run's numbers are the lower
readings), each control of ``--controls`` on ``--control`` seeds (the
reference at that lower precision against the reference in float32: upper
readings) and each fault of the cell's driver (``drivers/<kind>.py``'s
``FAULTS``), planted under the timed path, on ``--faults`` seeds. Each
reading is printed as one JSON line: ``{"kind", "seed", "numbers",
"leaves"}``, where ``leaves`` names, for a training run, the leaf of the
largest gap of the first gradient and of the change, and the median leaf's
gap.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--sound", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--controls", default="tf32,bf16")
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--first_seed", type=int, default=4_100_000_000)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.core.program import trainer_class
    from portbench.core.spec import Cell, driver, load_benchmark
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(load_benchmark(), args.workload)
    cfg = cell.cfg
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["cudnn_tf32"]
    dev = torch.device("cuda", 0)
    drv = driver(cell.mix["kind"])
    seed = args.first_seed

    def emit(what, s, numbers, leaves=None):
        print(json.dumps({"kind": what, "seed": s, "numbers": numbers,
                          "leaves": leaves}), flush=True)

    for _ in range(args.sound):
        seed += 1
        out = drv.run(cell, seed, args.seconds, False, dev,
                      time.perf_counter())
        emit("sound", seed, out.numbers, out.ctx.get("leaves"))
    for kind in filter(None, args.controls.split(",")):
        for _ in range(args.control):
            seed += 1
            numbers, leaves = drv.control(cell, seed, dev, kind)
            emit("control:" + kind, seed, numbers, leaves)
    cls = trainer_class(cfg["app"])
    for name, plant in drv.FAULTS.items():
        for _ in range(args.faults):
            seed += 1
            undo = plant(cls, cfg)
            try:
                out = drv.run(cell, seed, args.seconds, False, dev,
                              time.perf_counter())
            finally:
                undo()
            emit("fault:" + name, seed, out.numbers, out.ctx.get("leaves"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
