"""Weizmann under uniform random deletion 0%-90% × seeds.

Counterpart of multimodal_dmm_tpu/experiments/weizmann_partial.py.
"""

from ..apps.weizmann import WeizmannTrainer
from ._partial_semisup import make_parser, run_grid, analyze_best3

parser = make_parser("weizmann_partial")


def run(args):
    run_grid(args, WeizmannTrainer, "weizmann_tune",
             base_config={
                 "save_freq": 300,
                 "lr": 5e-4,
                 "eval_mods": ['video', 'mask', 'action'],
                 "drop_mods": ['mask', 'action', 'person'],
             },
             corrupt_grid=[{'uniform': f} for f in (
                 args.levels if args.levels is not None
                 else [i / 10 for i in range(10)])])


def analyze(args):
    return analyze_best3(args, 'config:corrupt:uniform',
                         ['ssim', 'action'])


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
