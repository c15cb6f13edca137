"""Weizmann semi-supervised: whole-modality (action) deletion grid.

Counterpart of multimodal_dmm_tpu/experiments/weizmann_semisup.py.
"""

from ..apps.weizmann import WeizmannTrainer
from ._partial_semisup import make_parser, run_grid, analyze_best3

parser = make_parser("weizmann_semisup")


def run(args):
    run_grid(args, WeizmannTrainer, "weizmann_tune",
             base_config={
                 "save_freq": 50,
                 "lr": 5e-4,
                 "modalities": ['video', 'action'],
                 "eval_mods": ['video', 'action'],
                 "drop_mods": ['action', 'person'],
             },
             corrupt_grid=[{'semi': f, 'modalities': ['action']}
                           for f in (args.levels if args.levels
                                     is not None
                                     else [i / 10 for i in range(10)])])


def analyze(args):
    return analyze_best3(args, 'config:corrupt:semi',
                         ['ssim', 'action'])


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
