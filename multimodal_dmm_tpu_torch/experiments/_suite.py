"""Shared machinery for the three task suites (spirals, Weizmann,
VidTIMIT; counterparts of multimodal_dmm_tpu/experiments/*_suite.py,
whose code this is, once instead of three times).

A suite trains a method × seed grid, then re-evaluates each trial's best
checkpoint on a battery of inference tasks and writes per-method CSVs:
``run_results.csv`` (each method's mean best-epoch metrics),
``task_results.csv`` and ``task_results_std.csv`` (each method's mean task
metric and mean per-sequence std) and ``task_results_runs.csv`` (one row
per trial). ``--config`` takes a YAML flow mapping (``training.flow_yaml``,
not PyYAML); the tables are ``table.Table``, not pandas frames.
"""

import argparse
import copy
import os

from ..training.flow_yaml import safe_load
from . import tune
from .analysis import ExperimentAnalysis
from .table import EmptyDataError, Table

METHODS = ['bfvi', 'b-mask', 'f-mask', 'b-skip', 'f-skip']


def make_parser(exp_name):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--analyze', action='store_true', default=False,
                        help='analyze without running experiments')
    parser.add_argument('--n_repeats', type=int, default=1, metavar='N',
                        help='number of repetitions per config set')
    parser.add_argument('--trial_cpus', type=int, default=1, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--trial_gpus', type=int, default=0, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--max_cpus', type=int, default=None, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--max_gpus', type=int, default=None, metavar='N',
                        help='(accepted for parity)')
    parser.add_argument('--local_dir', type=str, default="./",
                        help='path to trial results')
    parser.add_argument('--exp_name', type=str, default=exp_name,
                        help='experiment name')
    parser.add_argument('--config', type=safe_load, default={},
                        help='trial configuration arguments as a YAML '
                             'flow mapping')
    parser.add_argument('--no_isolate', action='store_true', default=False,
                        help='run trials in-process instead of one fresh '
                             'subprocess per trial')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='skip trials already completed in exp_name '
                             '(continue an interrupted sweep)')
    return parser


def run(args, trainer_cls, trainable_name, config):
    """Runs the method × seed grid: ``config`` (with its grid markers)
    updated from ``--config``, one subprocess per trial unless
    ``--no_isolate``."""
    config = dict(config)
    config.update(args.config)
    tune.register_trainable(trainable_name,
                            lambda c, r: trainer_cls.tune(c, r))
    ckpts = tune.run(trainable_name, name=args.exp_name, config=config,
                     local_dir=args.local_dir,
                     resources_per_trial={"cpu": args.trial_cpus,
                                          "gpu": args.trial_gpus},
                     resume=args.resume,
                     isolate=None if args.no_isolate else "{}:{}".format(
                         trainer_cls.__module__, trainer_cls.__name__))
    tune.exit_on_errors(ckpts, args.exp_name)


def analyze(args, evaluate, tasks, metrics, config_override=False):
    """Per-trial best epoch + task-suite evaluation → CSVs.

    ``evaluate(trial_config, trial_dir)`` returns the task metrics as the
    suites' ``evaluate`` does; ``metrics`` are the progress columns read
    at the best epoch. With ``config_override`` (the spirals suite),
    ``--config`` on ``--analyze`` overrides the stored trial config for
    the re-evaluation only (``'{device: cpu}'`` re-runs the battery on the
    CPU; the training artifacts are untouched).
    """
    exp_dir = os.path.join(args.local_dir, args.exp_name)
    ea = ExperimentAnalysis(exp_dir)
    df = ea.dataframe().sort_values(['trial_id'])

    run_results = {m: [] for m in metrics}
    run_results['method'] = []
    task_results = {task: [] for task in tasks}
    task_results_std = {task: [] for task in tasks}
    task_results['method'] = []
    task_results_std['method'] = []
    # Raw per-trial task metrics (seed-resolved distributions).
    per_seed_rows = []

    for i, trial in df.iterrows():
        print('===')
        print("Trial:", trial['experiment_tag'])
        print('===')
        try:
            trial_df = ea.trial_dataframe(trial['trial_id'])
        except (ValueError, EmptyDataError):
            print("No progress data to read for trial, skipping...")
            continue
        method = trial['method']
        best_idx = trial_df.mean_loss.idxmin()
        trial_results = {m: trial_df[m].iloc[best_idx] for m in metrics}
        print("Best:", ", ".join("{} {}".format(m, trial_results[m])
                                 for m in metrics))
        print("---")
        run_results['method'].append(method)
        for m in metrics:
            run_results[m].append(trial_results[m])

        trial_config = ea._checkpoints[i]['config']
        if config_override:
            trial_config = dict(trial_config)
            trial_config.update(args.config)
        trial_dir = os.path.join(exp_dir,
                                 os.path.basename(trial['logdir']))
        _, _, task_metrics, task_std = evaluate(trial_config, trial_dir)
        task_results['method'].append(method)
        task_results_std['method'].append(method)
        for task in tasks:
            task_results[task].append(task_metrics[task])
            task_results_std[task].append(task_std[task])
        per_seed_rows.append(dict(method=method,
                                  seed=trial_config.get('seed'),
                                  **task_metrics))

    run_results = Table(run_results).groupby('method').mean()
    print(run_results)
    task_results = Table(task_results).groupby('method').mean()
    print(task_results)
    task_results_std = Table(task_results_std).groupby('method').mean()
    print(task_results_std)
    run_results.to_csv(os.path.join(exp_dir, 'run_results.csv'))
    task_results.to_csv(os.path.join(exp_dir, 'task_results.csv'))
    task_results_std.to_csv(
        os.path.join(exp_dir, 'task_results_std.csv'))
    Table(per_seed_rows).to_csv(
        os.path.join(exp_dir, 'task_results_runs.csv'), index=False)


def evaluate(trainer_cls, trial_config, trial_dir, tasks, task_args,
             metric_names):
    """Evaluate a trial's best model on the inference-task battery.
    Returns (train metrics, train stds, test metrics, test stds), each
    {task: value}; the train ones are NaN (only the test set is
    evaluated)."""
    base_args = trainer_cls.parser.parse_args([])
    vars(base_args).update(trial_config)
    base_args.load = os.path.join(trial_dir, base_args.save_dir,
                                  'best.pth')
    # Metrics only: no artifacts, no reconstructions copied to the host.
    base_args.save_args = {'skip': True}
    # The analysis CSVs read the TEST metrics only, so the train set is
    # not evaluated.
    base_args.eval_sets = ['test']
    task_train_metrics, task_train_std = {}, {}
    task_test_metrics, task_test_std = {}, {}
    # One trainer serves every task: the checkpoint, model and data are
    # the same for all, and the device evaluation keeps the eval set on
    # the device between tasks.
    trainer = None
    for task in tasks:
        print("==Inference Task: '{}'==".format(task))
        args = copy.deepcopy(base_args)
        vars(args).update(task_args[task])
        args.save_dir = os.path.join(trial_dir, task + '_save')
        if trainer is None:
            trainer = trainer_cls.from_args(args)
        else:
            # Re-run the arg hooks that building the trainer applies
            # (--method remap incl. bfvi's 200 eval particles, rec_mult
            # scaling) so per-task args match a fresh build.
            args = trainer.pre_build_args(args)
            args = trainer.post_build_args(args)
        train_metrics, test_metrics = trainer.run_eval(args)
        metric_name = metric_names[task]
        task_train_metrics[task] = (float('nan') if train_metrics is None
                                    else train_metrics[metric_name])
        task_test_metrics[task] = test_metrics[metric_name]
        task_train_std[task] = (float('nan') if train_metrics is None
                                else train_metrics[metric_name + '_std'])
        task_test_std[task] = test_metrics[metric_name + '_std']
    return (task_train_metrics, task_train_std,
            task_test_metrics, task_test_std)
