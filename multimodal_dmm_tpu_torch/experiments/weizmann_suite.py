"""Train and compare methods on a suite of inference tasks (Weizmann;
counterpart of multimodal_dmm_tpu/experiments/weizmann_suite.py).

A method × seed grid on video+mask+action (masks and actions dropped at
test); the task suite is recon/half/fwd/bwd (SSIM), mask inference
(m_ssim) and action prediction (accuracy) from video-only inputs.

    python -m multimodal_dmm_tpu_torch.experiments.weizmann_suite \\
        --local_dir DIR --config '{data_dir: D}'
"""

import os

from ..apps.weizmann import WeizmannTrainer
from . import _suite, tune

parser = _suite.make_parser("weizmann_suite")

TASKS = ['recon', 'half', 'fwd', 'bwd', 'mask', 'action']

TASK_ARGS = {
    'recon': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0},
    'half': {'drop_frac': 0.5, 'start_frac': 0.0, 'stop_frac': 1.0},
    'fwd': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 0.75},
    'bwd': {'drop_frac': 0.0, 'start_frac': 0.25, 'stop_frac': 1.0},
    'mask': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0,
             'drop_mods': ['mask', 'action']},
    'action': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0,
               'drop_mods': ['mask', 'action']},
}

TASK_METRIC_NAMES = {
    'recon': 'ssim', 'half': 'ssim', 'fwd': 'ssim', 'bwd': 'ssim',
    'mask': 'm_ssim', 'action': 'action',
}


def run(args):
    _suite.run(args, WeizmannTrainer, "weizmann_tune", {
        "data_dir": os.path.abspath(WeizmannTrainer.defaults['data_dir']),
        "epochs": 500,
        "kld_anneal": 250,
        "save_freq": 50,
        "lr": 5e-4,
        "modalities": ['video', 'mask', 'action'],
        "drop_mods": ['mask', 'action'],
        "seed": tune.grid_search(list(range(args.n_repeats))),
        "method": tune.grid_search(_suite.METHODS),
    })


def analyze(args):
    _suite.analyze(args, evaluate, TASKS, ['mean_loss', 'ssim'])


def evaluate(trial_config, trial_dir):
    return _suite.evaluate(WeizmannTrainer, trial_config, trial_dir, TASKS,
                           TASK_ARGS, TASK_METRIC_NAMES)


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
