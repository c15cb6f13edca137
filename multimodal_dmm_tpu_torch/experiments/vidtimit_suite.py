"""Train and compare methods on a suite of inference tasks (VidTIMIT;
counterpart of multimodal_dmm_tpu/experiments/vidtimit_suite.py).

The reference ships no VidTIMIT experiment script; this suite extends the
spirals/Weizmann suite pattern to the audio-visual pair: a method × seed
grid on video+audio; the task battery is temporal inference on video SSIM
(recon/half/fwd/bwd, the Weizmann suite's fracs) plus the two cross-modal
directions, a2v (video from audio only, SSIM) and v2a (audio from video
only, audio MSE).

    python -m multimodal_dmm_tpu_torch.experiments.vidtimit_suite \\
        --local_dir DIR --config '{data_dir: D}'
"""

import os

from ..apps.vidtimit import VidTIMITTrainer
from . import _suite, tune

parser = _suite.make_parser("vidtimit_suite")

TASKS = ['recon', 'half', 'fwd', 'bwd', 'a2v', 'v2a']

TASK_ARGS = {
    'recon': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0},
    'half': {'drop_frac': 0.5, 'start_frac': 0.0, 'stop_frac': 1.0},
    'fwd': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 0.75},
    'bwd': {'drop_frac': 0.0, 'start_frac': 0.25, 'stop_frac': 1.0},
    'a2v': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0,
            'drop_mods': ['video']},
    'v2a': {'drop_frac': 0.0, 'start_frac': 0.0, 'stop_frac': 1.0,
            'drop_mods': ['audio']},
}

TASK_METRIC_NAMES = {
    'recon': 'ssim', 'half': 'ssim', 'fwd': 'ssim', 'bwd': 'ssim',
    'a2v': 'ssim', 'v2a': 'a_mse',
}


def run(args):
    _suite.run(args, VidTIMITTrainer, "vidtimit_tune", {
        "data_dir": os.path.abspath(VidTIMITTrainer.defaults['data_dir']),
        "epochs": 500,
        "kld_anneal": 250,
        "save_freq": 50,
        "lr": 5e-4,
        "seed": tune.grid_search(list(range(args.n_repeats))),
        "method": tune.grid_search(_suite.METHODS),
    })


def analyze(args):
    _suite.analyze(args, evaluate, TASKS, ['mean_loss', 'ssim'])


def evaluate(trial_config, trial_dir):
    return _suite.evaluate(VidTIMITTrainer, trial_config, trial_dir, TASKS,
                           TASK_ARGS, TASK_METRIC_NAMES)


if __name__ == "__main__":
    args = parser.parse_args()
    if not args.analyze:
        run(args)
    analyze(args)
