"""Train and compare methods on a suite of inference tasks (Spirals;
counterpart of multimodal_dmm_tpu/experiments/spirals_suite.py).

A grid over 5 inference methods × N seeds, then post-hoc analysis that
re-evaluates each trial's best checkpoint on the recon/half/fwd/bwd/condgen
tasks and aggregates per-method CSVs.

    python -m multimodal_dmm_tpu_torch.experiments.spirals_suite \\
        --local_dir DIR --config '{data_dir: D, epochs: 500}'
"""

import os

from ..apps.spirals import SpiralsTrainer
from . import _suite, tune

parser = _suite.make_parser("spirals_suite")

TASKS = ['recon', 'half', 'fwd', 'bwd', 'condgen']

TASK_ARGS = {
    'recon': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0},
    'half': {'drop_frac': 0.5, 'start_frac': 0.0, 'stop_frac': 1.0},
    'fwd': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 0.75},
    'bwd': {'drop_frac': 0.0, 'start_frac': 0.25, 'stop_frac': 1.0},
    'condgen': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 0.25,
                'keep_mods': ['spiral-x']},
}

TASK_METRIC_NAMES = {task: 'mse' for task in TASKS}


def run(args):
    """Runs the method × seed grid."""
    _suite.run(args, SpiralsTrainer, "spirals_tune", {
        "data_dir": os.path.abspath(SpiralsTrainer.defaults['data_dir']),
        "lr": 5e-3,
        "seed": tune.grid_search(list(range(args.n_repeats))),
        "method": tune.grid_search(_suite.METHODS),
    })


def analyze(args):
    """Per-trial best epoch + task-suite evaluation → CSVs."""
    _suite.analyze(args, evaluate, TASKS, ['mean_loss', 'mse'],
                   config_override=True)


def evaluate(trial_config, trial_dir):
    """Evaluate a trial's best model on the inference-task suite."""
    return _suite.evaluate(SpiralsTrainer, trial_config, trial_dir, TASKS,
                           TASK_ARGS, TASK_METRIC_NAMES)


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
