"""Shared machinery for the partial-data and semi-supervised experiment
grids (counterpart of multimodal_dmm_tpu/experiments/_partial_semisup.py).

All four scripts share the same shape: a grid over a corruption level ×
seeds, then "mean/std of the best-3 runs per corruption level" analysis.
``--config`` takes a YAML flow mapping (``training.flow_yaml``, not
PyYAML); the tables are ``table.Table``, not pandas frames.
"""

import argparse
import os

from ..training.flow_yaml import safe_load
from . import tune
from .analysis import ExperimentAnalysis
from .table import EmptyDataError, Table


def make_parser(exp_name):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--analyze', action='store_true', default=False,
                        help='analyze without running experiments')
    parser.add_argument('--n_repeats', type=int, default=10, metavar='N',
                        help='number of repetitions per config set')
    parser.add_argument('--trial_cpus', type=int, default=1, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--trial_gpus', type=int, default=0, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--max_cpus', type=int, default=None,
                        metavar='N', help='(accepted for parity)')
    parser.add_argument('--max_gpus', type=int, default=None,
                        metavar='N', help='(accepted for parity)')
    parser.add_argument('--local_dir', type=str, default="./")
    parser.add_argument('--exp_name', type=str, default=exp_name)
    parser.add_argument('--config', type=safe_load, default={},
                        help='trial configuration arguments as a YAML '
                             'flow mapping')
    parser.add_argument('--no_isolate', action='store_true',
                        default=False,
                        help='run trials in-process instead of one '
                             'subprocess per trial')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='skip trials already completed in '
                             'exp_name (continue an interrupted sweep)')
    parser.add_argument('--levels', type=float, nargs='+', default=None,
                        metavar='F',
                        help='corruption levels to run (default: the '
                             'reference grid 0.0-0.9 in 0.1 steps)')
    return parser


def run_grid(args, trainer_cls, trainable_name, base_config,
             corrupt_grid):
    """Run the corruption-level × seed grid.

    Trials run one subprocess each by default (like the suites);
    ``--no_isolate`` runs them in this process.
    """
    data_dir = os.path.abspath(trainer_cls.defaults['data_dir'])
    config = {"data_dir": data_dir}
    config.update(base_config)
    config["seed"] = tune.grid_search(list(range(args.n_repeats)))
    config["corrupt"] = tune.grid_search(corrupt_grid)
    config.update(args.config)
    tune.register_trainable(trainable_name,
                            lambda c, r: trainer_cls.tune(c, r))
    isolate = None if args.no_isolate else "{}:{}".format(
        trainer_cls.__module__, trainer_cls.__name__)
    ckpts = tune.run(trainable_name, name=args.exp_name, config=config,
                     local_dir=args.local_dir,
                     resources_per_trial={"cpu": args.trial_cpus,
                                          "gpu": args.trial_gpus},
                     isolate=isolate, resume=args.resume)
    tune.exit_on_errors(ckpts, args.exp_name)


def analyze_best3(args, corrupt_key, metric_cols):
    """Mean/std of the best-3 runs per corruption level → CSVs.

    metric_cols: list like ['mse', 'rec_loss'] or ['ssim', 'action'];
    the tables' columns are del_frac, loss, *metric_cols, and the CSVs
    leave out del_frac, as the reference's do (they are written without
    the group index).
    """
    exp_dir = os.path.join(args.local_dir, args.exp_name)
    ea = ExperimentAnalysis(exp_dir)
    df = ea.dataframe().sort_values(['trial_id'])
    best_results = {'del_frac': [], 'loss': []}
    for m in metric_cols:
        best_results[m] = []

    for i, trial in df.iterrows():
        print("Trial:", trial['experiment_tag'])
        try:
            trial_df = ea.trial_dataframe(trial['trial_id'])
        except (ValueError, EmptyDataError, KeyError):
            print("No progress data to read for trial, skipping...")
            continue
        del_frac = trial[corrupt_key]
        best_idx = trial_df.mean_loss.idxmin()
        row = trial_df[['mean_loss'] + metric_cols].iloc[best_idx]
        print("Best loss:", row['mean_loss'])
        best_results['del_frac'].append(del_frac)
        best_results['loss'].append(row['mean_loss'])
        for m in metric_cols:
            best_results[m].append(row[m])

    best_results = Table(best_results).sort_values(by='loss')
    best_results = best_results.groupby('del_frac').head(3)
    best_std = best_results.groupby('del_frac').std()
    best_mean = best_results.groupby('del_frac').mean()
    print('--Mean--')
    print(best_mean)
    print('--Std--')
    print(best_std)
    best_mean.to_csv(os.path.join(exp_dir, 'best_results.csv'),
                     index=False)
    best_std.to_csv(os.path.join(exp_dir, 'best_results_std.csv'),
                    index=False)
    return best_mean, best_std
