"""Spirals under uniform random deletion 0%-90% × seeds.

Counterpart of multimodal_dmm_tpu/experiments/spirals_partial.py.
"""

from ..apps.spirals import SpiralsTrainer
from ._partial_semisup import make_parser, run_grid, analyze_best3

parser = make_parser("spirals_partial")


def run(args):
    levels = (args.levels if args.levels is not None
              else [i / 10 for i in range(10)])
    run_grid(args, SpiralsTrainer, "spirals_tune",
             base_config={"lr": 5e-3},
             corrupt_grid=[{'uniform': f} for f in levels])


def analyze(args):
    return analyze_best3(args, 'config:corrupt:uniform',
                         ['mse', 'rec_loss'])


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
