"""The trainer: its command-line flags, the training step and optimizer,
the epoch loop, evaluation, checkpoints and the run entry points
(counterpart of multimodal_dmm_tpu/training/trainer.py).

The optimizer is the JAX package's chain: optional global-norm clipping,
then additive L2 weight decay, then Adam, with an update whose gradients
are not all finite skipped altogether (Adam's moments and step count are
left as they were). Clip + L2 + Adam is ``torch.optim.Adam(weight_decay=
...)`` after ``clip_grad_norm_``, which tests/test_optimizer_parity.py
holds equal to the optax chain.

``Trainer(model, lr, ...)`` holds a model's weights, optimizer and
sampling generator. ``Trainer.from_args(args)`` builds one from the
parsed flags of ``Trainer.parser`` (the JAX package's flag surface, with
``--device`` defaulting to ``cuda``; the dict flags take flow-style YAML
through ``flow_yaml``, not PyYAML): the app's data and model, a checkpoint
from ``--load``, and the derived args. ``run(args)`` then trains
(``run_train``: corruption, split, the device-resident loader with burst
deletion, ``train`` epochs with the KLD anneal and a one-step-delayed loss
readback, evaluation every ``--eval_freq`` epochs, ``best.pth``,
``epoch_N.pth`` and ``last.pth``, ``--resume_trial``) or evaluates
(``--evaluate``: ``run_eval``) or sweeps the epoch checkpoints for the
best (``--find_best``: ``run_find``); ``tune(config, reporter)`` is the
experiment runner's trainable. ``--method`` picks the model as the JAX
package does (``bfvi``: ``dmm``; the four DKS baselines: ``dks`` with
their ``rnn_dir``/``rnn_skip``), and ``--model`` names it in the registry
(``models.get_model``). ``--visualize`` draws the app's storyboards
(``visualize``, matplotlib) and ``--evaluate`` exports the results
(``save_results``, cv2; ``--save_args '{skip: true}'`` skips it).
``--rng_impl``, which chooses one of JAX's PRNGs, raises
``NotImplementedError``. A device-loader failure raises; the host loader
runs only under ``--host_loader``.

``--mesh N`` trains with data parallelism over N ranks, ``--mesh NxM`` over
N data x M model ranks (``MultiDMM`` only: the model ranks split the fused
objective's stacked variants): one process a rank (``main`` starts them
through ``parallel.launch``; rank r on ``cuda:r`` with NCCL, or on the CPU
with gloo under ``--device cpu``), each with the whole training set,
shuffled alike, taking its columns of every global batch
(``parallel.shard_batch``) through ``parallel.make_dp_train_step``, which
computes the single-device step. Every rank evaluates: each evaluation
batch's columns split over the data axis where n_data divides them
(``parallel.eval_columns``), else every rank computes the whole batch; the
noise is drawn at the global shape and cut to the rank's columns, and the
per-sequence metrics (and, on the collect path, the model's outputs) are
gathered to every rank (``parallel.gather_columns``), so that every rank
takes the same best-checkpoint decision. Rank 0 alone writes checkpoints,
results and ``param_hist.tsv``, and prints. ``--evaluate`` and
``--find_best`` under a mesh start the ranks too; ``tune`` under a mesh
starts them and hands rank 0's reports to the caller's reporter.

``evaluate(loader, args)`` composes each eval task (random deletion,
kept segment, dropped and kept modalities), runs the model's forward
without gradients and reduces the app's metrics. With
``collect_results=False`` and an app that has ``compute_metrics_device``,
the eval set is uploaded once and everything per batch stays on the
device until one copy of the per-sequence metrics at the end
(``eval_engine.py``); otherwise the tasks are composed on the host with
numpy. ``args`` is any namespace with ``drop_frac``, ``start_frac``,
``stop_frac``, ``drop_mods``, ``keep_mods``, ``eval_mods``,
``rec_mults``, ``eval_args`` and ``visualize``.

Randomness: ``--seed`` seeds numpy (corruption, the host loader) and the
sampling generator on the device; the device loader's shuffle and bursts
are functions of (seed, epoch); the weights come from a CPU generator
seeded with ``--init_seed`` (default ``--seed``). Checkpoints carry the
generator's state, so a resumed run reproduces the uninterrupted one.
"""

import argparse
import copy
import csv
import os
import re
import signal
import sys
import time
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from .. import not_ported, resolve_device
from ..convert import (adam_to_jax, load_adam, optax_adam_moments,
                       params_from_jax, params_to_jax)
from ..data import multiseq as mseq
from ..models import get_model
from ..ops.schedules import anneal
from ..parallel.mesh import (ColumnNoise, eval_columns, gather_columns,
                             launch, make_2d_train_step, make_dp_train_step,
                             make_mesh, make_mesh_2d, parse_mesh, replicated,
                             shard_batch, sum_over_data)
from ..tree import tree_leaves, tree_leaves_with_path, tree_map
from . import checkpoint as ckpt
from .device_loader import DeviceTrainData
from .diagnostics import StepTimer, plot_grad_flow, profile_ctx, span
from .eval_engine import DeviceEvalData, compose_task
from .flow_yaml import safe_load
from .loader import BatchLoader


def _build_parser():
    """The JAX Trainer's flags, flag for flag."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add = parser.add_argument
    add('--modalities', type=str, nargs='+', default=[], metavar='M',
        help='data modalities')
    add('--model', type=str, default='dmm', metavar='S',
        help='name of model to train (dmm, dks, vrnn)')
    add('--method', type=str, default=None, metavar='S',
        help='inference method: bfvi, b/f-mask, or b/f-skip')
    add('--model_args', type=safe_load, default={}, metavar='DICT',
        help='additional model arguments as a YAML flow mapping')
    add('--train_args', type=safe_load, default={}, metavar='DICT',
        help='additional train arguments as a YAML flow mapping')
    add('--eval_args', type=safe_load, default={}, metavar='DICT',
        help='additional eval. arguments as a YAML flow mapping')
    add('--save_args', type=safe_load, default={}, metavar='DICT',
        help='results saving arguments as a YAML flow mapping '
             '({skip: true}: metrics only)')
    add('--batch_size', type=int, default=100, metavar='N')
    add('--batch_sz_eval', type=int, default=None, metavar='N')
    add('--len_bucket', type=int, default=0, metavar='N',
        help='pad eval batches to multiples of N timesteps (0 = exact '
             'pad)')
    add('--split', type=int, default=1, metavar='N',
        help='split each training sequence into N chunks')
    add('--bylen', action='store_true', default=False,
        help='whether to split by length')
    add('--epochs', type=int, default=100, metavar='N')
    add('--lr', type=float, default=1e-4, metavar='LR')
    add('--w_decay', type=float, default=1e-4, metavar='F')
    add('--clip_grad', type=float, default=None, metavar='F')
    add('--seed', type=int, default=1, metavar='N')
    add('--kld_mult', type=float, default=1.0, metavar='F')
    add('--rec_mults', type=safe_load, default='auto', metavar='DICT')
    add('--kld_anneal', type=int, default=100, metavar='N')
    add('--data_workers', type=int, default=1, metavar='N',
        help='(accepted for parity; the loader is in-process)')
    add('--pin_memory', type=bool, default=True, metavar='B',
        help='(accepted for parity; the training set lives on the '
             'device)')
    add('--no_skip_nonfinite', action='store_true', default=False,
        help='apply optimizer updates even when grads are non-finite')
    add('--host_loader', action='store_true', default=False,
        help='use the host-side numpy batch loader for training instead '
             'of the device-resident one')
    add('--edge_layout', action='store_true', default=False,
        help='store device-loader training batches in the edge layout '
             '(channel-first) instead of the codec-native layout')
    add('--normalize', type=str, default=[], nargs='+', metavar='M')
    add('--corrupt', type=safe_load, default={}, metavar='DICT')
    add('--burst_frac', type=float, default=0.1, metavar='F')
    add('--drop_frac', type=float, default=0.5, metavar='F')
    add('--start_frac', type=float, default=0.25, metavar='F')
    add('--stop_frac', type=float, default=0.75, metavar='F')
    add('--drop_mods', type=str, default=[], nargs='+', metavar='M')
    add('--keep_mods', type=str, default=[], nargs='+', metavar='M')
    add('--eval_mods', type=str, default='all', nargs='+', metavar='M')
    add('--eval_metric', type=str, default='mse', metavar='S')
    add('--viz_metric', type=str, default='mse', metavar='S')
    add('--eval_freq', type=int, default=10, metavar='N')
    add('--save_freq', type=int, default=10, metavar='N')
    add('--load', type=str, default=None, metavar='PATH')
    add('--resume_trial', action='store_true', default=False,
        help='continue an interrupted training run from the latest '
             'epoch_N.pth in save_dir (weights, Adam state, best loss and '
             'the sampling generator are restored, so the resumed run '
             'reproduces the uninterrupted one); also enabled by '
             'MDMM_RESUME_TRIAL=1')
    add('--data_dir', type=str, metavar='DIR')
    add('--save_dir', type=str, metavar='DIR')
    add('--visualize', action='store_true', default=False)
    add('--gradients', action='store_true', default=False,
        help='plot per-layer gradient flow each batch')
    add('--profile_dir', type=str, default=None, metavar='DIR',
        help='write a torch.profiler trace of epoch 2 to this dir and '
             'print per-step timing summaries')
    add('--device', type=str, default='cuda',
        help='torch device (cuda/cpu); cuda raises without a GPU')
    add('--mesh', type=str, default='0', metavar='SPEC',
        help='device mesh: 0/1 = one device; N = data parallelism over N '
             'ranks; NxM = N data x M model ranks (the fused objective\'s '
             'variants split over M); one process and one GPU a rank '
             '(NCCL), or CPU ranks (gloo) with --device cpu')
    add('--anomaly_check', action='store_true', default=False,
        help='enable torch.autograd anomaly detection')
    add('--evaluate', '--test', action='store_true', default=False)
    add('--eval_sets', type=str, nargs='+', metavar='S',
        default=['train', 'test'])
    add('--find_best', action='store_true', default=False)
    add('--rng_impl', type=str, default='threefry2x32',
        choices=['threefry2x32', 'rbg', 'unsafe_rbg'],
        help='the JAX package\'s PRNG choice; the port draws from '
             'torch.Generator and takes only the default')
    add('--init_seed', type=int, default=None, metavar='S',
        help='override the parameter-init stream only (--seed keeps '
             'driving data shuffle, corruption, and model sampling)')
    add('--matmul_precision', type=str, default='default',
        choices=['default', 'bfloat16', 'bfloat16_3x', 'float32',
                 'highest'],
        help='float32 matmul precision: float32/highest = full float32 '
             '(torch "highest", no TF32), bfloat16_3x = torch "high", '
             'bfloat16 = torch "medium"; default leaves torch\'s setting')
    return parser


def _refuse_later_slices(args):
    """Raise for ``--rng_impl``, which the port does not take."""
    if args.rng_impl != "threefry2x32":
        raise not_ported("--rng_impl %s" % args.rng_impl, "JAX's PRNG "
                           "implementations (the port draws from "
                           "torch.Generator)")


_PRECISION = {"float32": "highest", "highest": "highest",
              "bfloat16_3x": "high", "bfloat16": "medium"}


# The inference methods of --method: BFVI and the four DKS baselines.
METHODS = ("bfvi", "b-mask", "f-mask", "b-skip", "f-skip")


def method_model(method, model):
    """The registry name of the model that ``--method`` picks (``bfvi``:
    ``dmm``; the DKS baselines: ``dks``), ``model`` for any other."""
    if method not in METHODS:
        return model
    return "dmm" if method == "bfvi" else "dks"


def _mesh_devices(device, n, spec):
    """The devices and backend of ``--mesh``'s ``n`` ranks: ``cuda:r`` with
    NCCL (raising when fewer cards are visible), or the CPU with gloo."""
    if torch.device(device).type != "cuda":
        return ["cpu"] * n, "gloo"
    avail = torch.cuda.device_count()
    if avail < n:
        raise ValueError("--mesh {} needs {} devices but only {} are "
                         "visible".format(spec, n, avail))
    return ["cuda:%d" % r for r in range(n)], "nccl"


def _plain(x):
    """``x`` with every dict (a summary's defaultdict, whose factory does
    not pickle) made a plain dict."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _main_rank(cls, argv):
    """A rank of ``Trainer.main``, in its process group."""
    return _plain(cls.main(argv))


def _tune_rank(cls, config):
    """A rank of ``Trainer.tune`` under a mesh, in its process group:
    the trial's training run, reporting to a ``_MeshReporter``. Returns
    the reports (rank 0's; the other ranks' are empty)."""
    from ..experiments.tune import StopTrial
    args = cls.tune_args(config)
    trainer = cls.from_args(args)
    reporter = _MeshReporter(trainer.mesh)
    try:
        trainer.run_train(args, reporter)
    except StopTrial:
        pass
    return _plain(reporter.rows)


class _MeshReporter:
    """A trial's reporter on a rank of a mesh: rank 0 keeps each report
    (``rows``) for the caller's reporter, and each report's ``done`` is
    rank 0's on every rank (``broadcast``), so that the ranks stop
    together (``StopTrial``) and none is left in a collective."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rows = []

    def __call__(self, **kwargs):
        from ..experiments.tune import StopTrial
        done = torch.tensor([float(bool(kwargs.get("done")))],
                            device=self.mesh.device)
        dist.broadcast(done, src=0, group=self.mesh.group)
        if self.mesh.rank == 0:
            self.rows.append(dict(kwargs))
        if done.item():
            raise StopTrial()


def _copy_in(x, device):
    """Host data on ``device``. To a GPU, a copy from pageable memory
    waits for the device's stream: a host synchronisation."""
    with span("mdmm/sync.batch_copy"):
        return torch.as_tensor(x, device=device)


def _to_host(x):
    """A tensor's values as a numpy array; from a GPU, the read waits for
    the device: a host synchronisation."""
    with span("mdmm/sync.readback"):
        return x.cpu().numpy()


def summarize(metrics, n_timesteps):
    """An evaluation's summary: the mean and std (``key_std``) of each
    per-sequence metric (a list), each summed metric divided by
    ``n_timesteps``; NaN for a key it does not have."""
    summary = defaultdict(lambda: float("nan"))
    for key, val in metrics.items():
        if isinstance(val, list):
            summary[key] = np.mean(val)
            summary[key + "_std"] = np.std(val)
        else:
            summary[key] = val / n_timesteps
    return summary


def method_eval_args(method, eval_args):
    """The eval args that ``--method`` sets (the JAX Trainer's
    ``pre_build_args``): ``bfvi`` filters with 200 particles unless
    ``eval_args`` says otherwise; the other methods set none."""
    if method == "bfvi" and "flt_particles" not in eval_args:
        return dict(eval_args, flt_particles=200)
    return dict(eval_args)


class Trainer:
    """Holds a model's parameters, state, optimizer and sampling
    generator, and takes training steps.

    ``params``/``state`` default to ``model.init(init_seed or seed)``;
    when given (for example from ``convert.params_from_jax``) they are
    moved to ``device``. ``from_args`` builds one from the command line's
    flags through the app's hooks (``pre_build_args``, ``load_data``,
    ``build_model``, ``post_build_args``).
    """

    parser = _build_parser()

    def __init__(self, model, lr, w_decay=1e-4, clip_grad=None,
                 skip_nonfinite=True, rec_mults=None, train_args=None,
                 seed=1, params=None, state=None, device="cuda",
                 init_seed=None):
        self.device = resolve_device(device)
        self.model = model
        if params is None:
            params, state = model.init(seed if init_seed is None
                                       else init_seed, device=self.device)
        to_dev = lambda x: x.detach().to(self.device).clone()  # noqa: E731
        self.params = tree_map(to_dev, params)
        self.state = tree_map(to_dev, state)
        self.leaves = tree_leaves(self.params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.clip_grad = clip_grad
        self.skip_nonfinite = skip_nonfinite
        self.optimizer = torch.optim.Adam(self.leaves, lr=lr,
                                          weight_decay=w_decay)
        self.rec_mults = dict(rec_mults or {})
        self.train_args = dict(train_args or {})
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._eval_dev_cache = {}  # key -> (dataset, DeviceEvalData)
        # The data-parallel mesh and its step (set_mesh).
        self.mesh = None
        self.mesh_step = None

    @property
    def is_root(self):
        """Whether this process evaluates, prints and writes files: always
        without a mesh, rank 0 under one."""
        return self.mesh is None or self.mesh.rank == 0

    @classmethod
    def from_args(cls, args):
        """A trainer built from ``cls.parser``'s ``args``: the app's data
        (``train_data``, ``test_data``) and model, weights from ``--load``
        (or, with ``--evaluate``, ``save_dir/best.pth``), Adam's moments
        where the checkpoint has them. ``args`` is updated in place as
        the JAX Trainer updates it."""
        # argparse shares its default containers between namespaces: own
        # them before a hook changes one.
        for k, v in list(vars(args).items()):
            if isinstance(v, (dict, list)):
                setattr(args, k, copy.deepcopy(v))
        _refuse_later_slices(args)
        n_data, n_model = cls.check_mesh(args)
        device = resolve_device(args.device)
        np.random.seed(args.seed)
        if args.anomaly_check:
            torch.autograd.set_detect_anomaly(True)
        if args.matmul_precision != "default":
            torch.set_float32_matmul_precision(
                _PRECISION[args.matmul_precision])
            torch.backends.cudnn.allow_tf32 = \
                _PRECISION[args.matmul_precision] != "highest"
        args = cls.pre_build_args(args)
        os.makedirs(args.save_dir, exist_ok=True)

        checkpoint = None
        if args.load is not None:
            checkpoint = ckpt.load_checkpoint(args.load)
        elif args.evaluate:
            checkpoint = ckpt.load_checkpoint(
                os.path.join(args.save_dir, "best.pth"))
        if checkpoint is not None:
            args.modalities = checkpoint["modalities"]

        train_data, test_data = cls.load_data(args.modalities, args)
        print('Constructing model...')
        model = cls.build_model(args)
        trainer = cls(model, lr=args.lr, w_decay=args.w_decay,
                      clip_grad=args.clip_grad,
                      skip_nonfinite=not args.no_skip_nonfinite,
                      seed=args.seed, init_seed=args.init_seed,
                      device=device)
        trainer.train_data, trainer.test_data = train_data, test_data
        print('Number of parameters:',
              sum(p.numel() for p in trainer.leaves))
        if checkpoint is not None:
            trainer.restore(checkpoint, opt=True)
        trainer.post_build_args(args)
        if n_data * n_model > 1:
            trainer.set_mesh(make_mesh(n_data, device) if n_model == 1 else
                             make_mesh_2d(n_data, n_model, device))
            print('Mesh: {} ranks ({} data x {} model)'.format(
                n_data * n_model, n_data, n_model))
        return trainer

    @classmethod
    def check_mesh(cls, args):
        """(n_data, n_model) of ``--mesh``, refused as the JAX trainer
        refuses it: ``ValueError`` for a ``--batch_size`` that n_data does
        not divide and for a 2-D mesh of a model without stacked
        variants."""
        n_data, n_model = parse_mesh(args.mesh)
        if n_data * n_model > 1:
            if args.batch_size % n_data:
                raise ValueError(
                    "--batch_size {} must be divisible by the data axis of "
                    "--mesh {}".format(args.batch_size, args.mesh))
            model = get_model(method_model(args.method, args.model))
            if n_model > 1 and not hasattr(model, "set_variant_mesh"):
                raise ValueError(
                    "--mesh {}: model {} has no stacked-variant axis to "
                    "shard; use --mesh N".format(args.mesh, model.__name__))
        return n_data, n_model

    @classmethod
    def main(cls, argv=None):
        """The command line: parse ``argv``, build the trainer, run it;
        returns what ``run`` returns. Under ``--mesh`` above 1 it first
        starts the ranks, one process each (``parallel.launch``): rank r
        on ``cuda:r`` with NCCL (``ValueError`` when fewer cards are
        visible), or on the CPU with gloo under ``--device cpu``; each
        builds its trainer and runs it (training, ``--evaluate`` or
        ``--find_best``), and rank 0's result is returned."""
        argv = sys.argv[1:] if argv is None else list(argv)
        args = cls.parser.parse_args(argv)
        _refuse_later_slices(args)
        n_data, n_model = parse_mesh(args.mesh)
        ranks = n_data * n_model > 1 and not dist.is_initialized()
        if ranks:
            devices, backend = _mesh_devices(args.device, n_data * n_model,
                                             args.mesh)
        cls.check_mesh(args)
        if ranks:
            return launch(_main_rank, devices, backend, args=(cls, argv))[0]
        return cls.from_args(args).run(args)

    def set_mesh(self, mesh):
        """Train as one rank of ``mesh`` (``parallel.make_mesh`` or
        ``make_mesh_2d``): rank 0's weights, BatchNorm state, Adam state
        and generator state are copied to every rank; ``train_step`` then
        takes this rank's columns (``parallel.shard_batch``) with the
        global batch's ``n_data``, and ``train`` cuts each batch so."""
        self.mesh = mesh
        gen_state = self.gen.get_state()
        replicated(mesh, [self.params, self.state,
                          list(self._adam_states().values()), gen_state])
        self.gen.set_state(gen_state)
        make = make_2d_train_step if mesh.n_model > 1 else make_dp_train_step
        self.mesh_step = make(self, mesh)

    def apply_gradients(self):
        """One optimizer update from the leaves' ``.grad``; returns False
        (and changes nothing) when a gradient is not finite."""
        grads = [p.grad for p in self.leaves]
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            with span("mdmm/sync.finite"):
                finite = bool(finite.all())
            if not finite:
                return False
        with span("mdmm/train.optimizer"):
            if self.clip_grad is not None and self.clip_grad > 0:
                torch.nn.utils.clip_grad_norm_(self.leaves, self.clip_grad)
            self.optimizer.step()
        return True

    def train_step(self, inputs, targets, mask, kld_mult, n_data):
        """loss / n_data -> gradients -> update. Returns (loss, applied):
        the summed (unnormalised) loss as a detached tensor, and whether
        the update was applied. Under a mesh (``set_mesh``) the batch is
        this rank's columns, ``n_data`` the global batch's, and the loss
        that of all ranks (``parallel.make_dp_train_step``)."""
        if self.mesh_step is not None:
            return self.mesh_step(inputs, targets, mask, kld_mult, n_data)
        return self.update(inputs, targets, mask, kld_mult, n_data,
                           self.gen)

    def update(self, inputs, targets, mask, kld_mult, n_data, gen,
               train=True, reduce_grads=None):
        """One update: loss / n_data -> gradients -> ``reduce_grads()``
        (a data-parallel step's sum over the ranks) -> the optimizer;
        ``gen`` and ``train`` go to ``model.step``. Returns (loss,
        applied), as ``train_step``."""
        for p in self.leaves:
            p.grad = None
        with span("mdmm/train.forward"):
            loss, new_state = self.model.step(
                self.params, self.state, inputs, mask, kld_mult,
                self.rec_mults, gen, targets=targets, train=train,
                **self.train_args)
        with span("mdmm/train.backward"):
            (loss / n_data).backward()
        if reduce_grads is not None:
            reduce_grads()
        applied = self.apply_gradients()
        self.state = tree_map(lambda x: x.detach(), new_state)
        return loss.detach(), applied

    # -- the epoch loop -------------------------------------------------------

    def train(self, loader, epoch, args):
        """One epoch of updates over ``loader`` (a ``DeviceTrainData``, or
        a host ``BatchLoader`` whose batches get ``burst_delete``); the
        KLD multiplier anneals linearly over ``kld_anneal`` epochs of
        batches. Each batch's loss is read back only after the next
        batch's step is queued. Returns the epoch's loss per step."""
        with span("mdmm/train.epoch"):
            self.rec_mults = dict(args.rec_mults)
            self.train_args = dict(args.train_args)
            loss_sum, data_num, kld_mult = 0.0, 0, 0.0
            n_batches = len(loader)
            # Per-step device times only for the profiled epoch's summary.
            timer = StepTimer(self.device) if args.profile_dir else None
            pending = None  # (batch number, loss on the device, n steps)

            def drain(p):
                nonlocal loss_sum, data_num
                b_prev, loss_dev, n_prev = p
                with span("mdmm/sync.loss"):
                    loss_sum += float(loss_dev)
                data_num += n_prev
                print('Batch: {:5d}\tLoss: {:10.1f}'.format(
                    b_prev, loss_sum / data_num))

            if isinstance(loader, DeviceTrainData):
                batches = loader.epoch(args.seed * 100003 + epoch)
            else:
                def host_batches():
                    for targets, mask, lengths, _, _ in loader:
                        with span("mdmm/train.batch"):
                            inputs = mseq.burst_delete(
                                targets, args.burst_frac, lengths)
                            batch = (self._to_device(inputs),
                                     self._to_device(targets),
                                     _copy_in(mask, self.device), lengths)
                        yield batch
                batches = host_batches()

            for b_num, (inputs, targets, mask, lengths) in enumerate(
                    batches):
                kld_mult = anneal(0.0, args.kld_mult,
                                  b_num + epoch * n_batches,
                                  args.kld_anneal * n_batches)
                if self.mesh is not None:
                    inputs, _ = shard_batch(self.mesh, inputs, mask)
                    targets, mask = shard_batch(self.mesh, targets, mask)
                if timer is not None:
                    timer.start()
                with span("mdmm/train.step"):
                    loss, _ = self.train_step(inputs, targets, mask,
                                              kld_mult, float(sum(lengths)))
                if timer is not None:
                    timer.stop()
                if args.gradients and self.is_root:
                    plot_grad_flow(tree_map(lambda p: p.grad, self.params),
                                   save_path=os.path.join(args.save_dir,
                                                          'grad_flow.pdf'))
                if pending is not None:
                    drain(pending)
                pending = (b_num, loss, sum(lengths))
            if pending is not None:
                drain(pending)
            if timer is not None:
                print('Step timing:', timer.summary())
            loss = loss_sum / max(data_num, 1)
            print('---')
            print('Epoch: {}\tLoss: {:10.1f}\tKLD-Mult: {:0.3f}'.format(
                epoch, loss, kld_mult))
            return loss

    # -- evaluation -----------------------------------------------------------

    def _to_device(self, batch):
        return {m: _copy_in(batch[m], self.device)
                for m in batch if m in self.model.modalities}

    @staticmethod
    def _eval_config(args):
        """(rec_mults zeroed outside ``eval_mods``, forward kwargs)."""
        rec_mults = dict(args.rec_mults)
        if args.eval_mods != "all":
            for m in rec_mults:
                rec_mults[m] *= float(m in args.eval_mods)
        return rec_mults, dict({"sample": False}, **args.eval_args)

    def _eval_split(self, b_dim):
        """(this rank's columns of a ``b_dim``-column evaluation batch or
        None for all of them, the generator its forward draws from): under
        a mesh whose data axis divides ``b_dim``, a ``ColumnNoise`` that
        draws at the batch's shape and keeps those columns."""
        cols = eval_columns(self.mesh, b_dim)
        if cols is None:
            return None, self.gen
        return cols, ColumnNoise(self.gen, self.mesh, cols.stop - cols.start)

    def evaluate(self, loader, args, collect_results=True):
        """Run the eval task over ``loader``. Returns (results, summary):
        per-sequence targets, inputs and reconstructions in input order
        when ``collect_results``, and ``summarize_metrics``' summary.
        Under a mesh each rank runs the forward on its columns of each
        batch (``_eval_split``), and every rank gets the whole batch's
        outputs and metrics; ``--visualize`` draws on rank 0 alone."""
        with span("mdmm/eval.call"):
            collect_results = collect_results or args.visualize
            if (not collect_results
                    and getattr(self, "compute_metrics_device", None)
                    is not None):
                return self._evaluate_device(loader, args)
            rec_mults, eval_args = self._eval_config(args)
            n_timesteps, metrics = 0, None
            results = {"seq_ids": [], "targets": [], "inputs": [], "recon": []}
            for targets, mask, lengths, order, ids in loader:
                b_dim = mask.shape[1]
                cols, gen = self._eval_split(b_dim)
                with span("mdmm/eval.task"):
                    inputs = mseq.rand_delete(targets, args.drop_frac, lengths)
                    inputs = mseq.keep_segment(inputs, args.start_frac,
                                               args.stop_frac, lengths)
                    for m in args.drop_mods:
                        inputs[m][:] = float("nan")
                    for m in args.keep_mods:
                        inputs[m] = np.array(targets[m], copy=True)
                    dev_inputs = self._to_device(
                        inputs if cols is None else
                        {m: v[:, cols] for m, v in inputs.items()})
                with torch.no_grad(), span("mdmm/eval.forward"):
                    (infer, prior, recon), _ = self.model.forward(
                        self.params, self.state, dev_inputs, gen=gen,
                        **eval_args)
                if cols is not None:
                    gather = lambda x: gather_columns(  # noqa: E731
                        self.mesh, x, cols, b_dim)
                    infer, prior = (tuple(gather(x) for x in xs)
                                    for xs in (infer, prior))
                    recon = {m: tuple(gather(r) for r in rs)
                             for m, rs in recon.items()}
                n_timesteps += sum(lengths)
                with span("mdmm/eval.metrics"):
                    b_metrics = self.compute_metrics(
                        self.model, infer, prior, recon, targets, mask,
                        lengths, order, args, rec_mults=rec_mults)
                metrics = (b_metrics if metrics is None else
                           {k: metrics[k] + b_metrics[k] for k in metrics})
                if collect_results:
                    recon = {m: tuple(_to_host(r) for r in rs)
                             for m, rs in recon.items()}
                    results["seq_ids"] += [ids[i] for i in order]
                    for k, v in (("targets", targets), ("inputs", inputs),
                                 ("recon", recon)):
                        results[k].append(mseq.seq_decoll_dict(v, lengths,
                                                               order))
            if collect_results:
                for k in ("targets", "inputs", "recon"):
                    results[k] = {m: [seq for batch in results[k]
                                      for seq in batch[m]]
                                  for m in results[k][0]}
                if args.visualize and self.is_root:
                    self.visualize(results, metrics[args.viz_metric], args)
            return results, self.summarize_metrics(metrics, n_timesteps)

    def _evaluate_device(self, loader, args):
        """The metrics-only evaluation on the device: the eval set is
        uploaded once per (dataset, batching); per batch the task, the
        forward and the per-sequence metrics run on the device; the
        metrics of all batches come to the host together at the end.
        Under a mesh each rank composes the task and runs the forward and
        the metrics on its columns (``_eval_split``), then the
        per-sequence metrics are gathered and the summed ones summed over
        the data axis."""
        key = (id(loader.dataset), loader.batch_size,
               getattr(loader, "len_bucket", 0))
        cached = self._eval_dev_cache.get(key)
        if cached is None:
            data = DeviceEvalData(loader.dataset, self.model.modalities,
                                  loader.batch_size,
                                  len_bucket=getattr(loader, "len_bucket",
                                                     0),
                                  device=self.device)
            # Holding the dataset keeps its id() from being reused.
            self._eval_dev_cache[key] = (loader.dataset, data)
        else:
            data = cached[1]
        rec_mults, eval_args = self._eval_config(args)
        outs, n_timesteps = [], 0
        with torch.no_grad():
            for b in data.batches:
                b_dim = b.mask.shape[1]
                cols, gen = self._eval_split(b_dim)
                with span("mdmm/eval.task"):
                    inputs = compose_task(
                        b.targets, b.lengths_dev, self.gen, args.drop_frac,
                        args.start_frac, args.stop_frac,
                        tuple(args.drop_mods), tuple(args.keep_mods),
                        modalities=self.model.modalities, cols=cols)
                targets, mask, lengths = b.targets, b.mask, b.lengths_dev
                if cols is not None:
                    targets = {m: v[:, cols] for m, v in targets.items()}
                    mask, lengths = mask[:, cols], lengths[cols]
                with span("mdmm/eval.forward"):
                    (infer, prior, recon), _ = self.model.forward(
                        self.params, self.state, inputs, gen=gen,
                        **eval_args)
                with span("mdmm/eval.metrics"):
                    out = self.compute_metrics_device(
                        self.model, infer, prior, recon, targets, mask,
                        lengths, rec_mults)
                if cols is not None:
                    out = {k: sum_over_data(self.mesh, v) if v.dim() == 0
                           else gather_columns(self.mesh, v, cols, b_dim,
                                               axis=0)
                           for k, v in out.items()}
                outs.append(out)
                n_timesteps += sum(b.lengths)
        outs = [{k: _to_host(v) for k, v in out.items()} for out in outs]
        metrics = None
        for b, out in zip(data.batches, outs):
            # Per-sequence values back in input order, real sequences
            # only (ghost columns lie past them).
            b_metrics = {k: float(v) if v.ndim == 0 else
                         [v[i] for i in b.order] for k, v in out.items()}
            metrics = (b_metrics if metrics is None else
                       {k: metrics[k] + b_metrics[k] for k in metrics})
        return ({"seq_ids": [], "targets": [], "inputs": [], "recon": []},
                self.summarize_metrics(metrics, n_timesteps))

    # -- run entry points -----------------------------------------------------

    def run_eval(self, args):
        """Evaluate on the ``--eval_sets`` (train, test) and hand each
        set's results to the app's ``save_results`` (rank 0's alone under
        a mesh); returns (train metrics, test metrics). ``--save_args
        '{skip: true}'``: metrics only, nothing saved."""
        skip_save = (isinstance(args.save_args, dict)
                     and bool(args.save_args.get('skip')))
        metrics = {}
        for name, data in (('train', self.train_data),
                           ('test', self.test_data)):
            if name not in args.eval_sets:
                continue
            print("--{}--".format("Training" if name == 'train'
                                  else "Testing"))
            loader = BatchLoader(data, batch_size=args.batch_sz_eval,
                                 len_bucket=args.len_bucket)
            args.eval_set = name
            results, metrics[name] = self.evaluate(
                loader, args, collect_results=not skip_save)
            if not skip_save and self.is_root:
                self.save_results(results, args)
        if self.is_root:
            self.save_params(args)
        return metrics.get('train'), metrics.get('test')

    def run_train(self, args, reporter=None):
        """The training run: corrupt and split the training set, train
        ``--epochs`` epochs from the device loader (or, with
        ``--host_loader``, the host loader), evaluate on the test set every
        ``--eval_freq`` epochs, write ``best.pth`` (best ``--eval_metric``
        so far) and ``epoch_N.pth`` every ``--save_freq`` epochs and
        ``last.pth`` at the end. Returns {"epoch_loss": [...], "epoch_s":
        [...] (training, on the host's clock), "eval": [metrics, ...],
        "eval_s": [...], "best_loss": x}. Under a mesh every rank
        evaluates (``evaluate``) and reports to ``reporter``; rank 0 alone
        writes."""
        train_data, test_data = self.train_data, self.test_data
        if 'uniform' in args.corrupt:
            train_data = train_data.corrupt(args.corrupt['uniform'])
        if 'burst' in args.corrupt:
            train_data = train_data.corrupt(args.corrupt['burst'],
                                            mode='burst')
        if 'semi' in args.corrupt:
            train_data = train_data.corrupt(
                args.corrupt['semi'], mode='all_none',
                modalities=args.corrupt['modalities'])
        train_data = train_data.split(args.split, args.bylen)

        args.train_args = {k: v for k, v in args.train_args.items()
                           if k != 'native_mods'}
        if args.host_loader:
            train_loader = BatchLoader(train_data,
                                       batch_size=args.batch_size,
                                       shuffle=True)
        else:
            native = ({} if args.edge_layout
                      else self.model.native_input_perms())
            train_loader = DeviceTrainData(
                train_data, self.model.modalities, args.batch_size,
                args.burst_frac, native_perms=native, device=self.device)
            if native:
                args.train_args['native_mods'] = tuple(
                    m for m in self.model.modalities if m in native)
        test_loader = BatchLoader(test_data, batch_size=args.batch_sz_eval,
                                  len_bucket=args.len_bucket)

        best_loss, best_snapshot = float('inf'), None
        loss, metrics = float('nan'), {}
        history = {"epoch_loss": [], "epoch_s": [], "eval": [],
                   "eval_s": []}
        args.eval_set = None
        start_epoch = 1
        if (args.resume_trial
                or os.environ.get('MDMM_RESUME_TRIAL') == '1'):
            latest, ck = self._latest_epoch_checkpoint(args.save_dir)
            if ck is not None:
                self.restore(ck, opt=True)
                if "torch_gen" in ck:
                    self.gen.set_state(torch.as_tensor(ck["torch_gen"]))
                start_epoch = int(ck.get("epoch", latest)) + 1
                best_loss = float(ck.get("best_loss", best_loss))
                print('--- Resuming from epoch {} checkpoint (best_loss '
                      '{:0.4g}) ---'.format(latest, best_loss))

        # A SIGTERM between writes would lose the pending best snapshot:
        # turn it into an exception so that `finally` writes it first.
        def on_term(signum, frame):
            raise KeyboardInterrupt("SIGTERM")
        try:
            prev_term = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread
            prev_term = None
        try:
            for epoch in range(start_epoch, args.epochs + 1):
                print('---')
                t0 = time.perf_counter()
                with profile_ctx(args.profile_dir if epoch == 2
                                 and self.is_root else None):
                    history["epoch_loss"].append(
                        self.train(train_loader, epoch, args))
                history["epoch_s"].append(time.perf_counter() - t0)
                if epoch % args.eval_freq == 0:
                    t0 = time.perf_counter()
                    _, metrics = self.evaluate(test_loader, args,
                                               collect_results=False)
                    history["eval_s"].append(time.perf_counter() - t0)
                    history["eval"].append(dict(metrics))
                    loss = metrics[args.eval_metric]
                    if loss < best_loss:
                        best_loss = loss
                        # Written every save_freq epochs, not at each
                        # improvement.
                        if self.is_root:
                            best_snapshot = self._snapshot()
                    if reporter is not None:
                        reporter(mean_loss=loss, best_loss=best_loss,
                                 training_iteration=epoch,
                                 done=bool(np.isnan(loss)), **metrics)
                if epoch % args.save_freq == 0 and self.is_root:
                    if best_snapshot is not None:
                        self._write(os.path.join(args.save_dir, "best.pth"),
                                    args.modalities, best_snapshot,
                                    extra={"best_loss": float(best_loss)})
                        best_snapshot = None
                    self.save_checkpoint(
                        args.modalities,
                        os.path.join(args.save_dir,
                                     "epoch_{}.pth".format(epoch)),
                        extra={"epoch": epoch,
                               "best_loss": float(best_loss)})
        finally:
            if best_snapshot is not None:
                self._write(os.path.join(args.save_dir, "best.pth"),
                            args.modalities, best_snapshot,
                            extra={"best_loss": float(best_loss)})
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
        if self.is_root:
            self.save_checkpoint(args.modalities,
                                 os.path.join(args.save_dir, "last.pth"))
            self.save_params(args)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)
        if reporter is not None:
            reporter(mean_loss=loss, best_loss=best_loss,
                     training_iteration=args.epochs, done=True, **metrics)
        history["best_loss"] = best_loss
        return history

    def run_find(self, args):
        """Sweep the saved ``epoch_N.pth`` (every ``--save_freq`` epochs
        up to ``--epochs``) for the best model: each restored without
        Adam's state and evaluated on the test set, ``best.pth`` rewritten
        at each new best ``--eval_metric``; then the best evaluated once
        more. Under a mesh every rank evaluates and rank 0 alone writes.
        Returns (best epoch, its metrics)."""
        test_loader = BatchLoader(self.test_data,
                                  batch_size=args.batch_sz_eval,
                                  len_bucket=args.len_bucket)
        best_loss, best_epoch = float('inf'), -1
        args.eval_set = None
        for epoch in range(args.save_freq, args.epochs + 1, args.save_freq):
            path = os.path.join(args.save_dir, "epoch_{}.pth".format(epoch))
            if not os.path.exists(path):
                continue
            self.restore(ckpt.load_checkpoint(path))
            print('--- Epoch {} ---'.format(epoch))
            _, metrics = self.evaluate(test_loader, args,
                                       collect_results=False)
            loss = metrics[args.eval_metric]
            if loss < best_loss:
                best_loss, best_epoch = loss, epoch
                if self.is_root:
                    self.save_checkpoint(args.modalities, os.path.join(
                        args.save_dir, "best.pth"))
        if self.mesh is not None:  # best.pth is written
            dist.barrier(group=self.mesh.group)
        print('=== Best Epoch : {} ==='.format(best_epoch))
        self.restore(ckpt.load_checkpoint(os.path.join(args.save_dir,
                                                       "best.pth")))
        _, metrics = self.evaluate(test_loader, args)
        if self.is_root:
            self.save_params(args)
        return best_epoch, metrics

    def run(self, args):
        """``run_eval`` with ``--evaluate``, ``run_find`` with
        ``--find_best``, else ``run_train``; returns what it returns."""
        if args.evaluate:
            return self.run_eval(args)
        if args.find_best:
            return self.run_find(args)
        return self.run_train(args)

    @classmethod
    def tune_args(cls, config):
        """The parser's defaults updated from ``config`` (a trial's)."""
        args = cls.parser.parse_args([])
        vars(args).update(config)
        return args

    @classmethod
    def tune(cls, config, reporter):
        """The experiment runner's trainable: a trainer built from
        ``tune_args(config)`` and its training run, reporting to
        ``reporter`` after each evaluation and at the end (numbers only:
        the metrics are numpy or Python floats). Under a ``mesh`` above 1
        it starts the ranks (``parallel.launch``, as ``main`` does), each
        of which trains, evaluates and stops with the others
        (``_MeshReporter``); then it hands rank 0's reports to
        ``reporter`` in their order, so that ``reporter`` writes the
        rows and raises at ``done`` as it does for one process. A rank's
        exception ends the trial: the others are stopped and it is raised
        here."""
        args = cls.tune_args(config)
        n_data, n_model = parse_mesh(args.mesh)
        if n_data * n_model > 1 and not dist.is_initialized():
            devices, backend = _mesh_devices(args.device, n_data * n_model,
                                             args.mesh)
            cls.check_mesh(args)
            rows = launch(_tune_rank, devices, backend,
                          args=(cls, config))[0]
            for row in rows:
                reporter(**row)
            return
        cls.from_args(args).run_train(args, reporter)

    # -- persistence ----------------------------------------------------------

    def save_params(self, args):
        """Append this run's settings to ``param_hist.tsv`` in the working
        directory (the JAX package's columns, written with ``csv``)."""
        fname = 'param_hist.tsv'
        cols = ['save_dir', 'model', 'modalities', 'batch_size', 'split',
                'epochs', 'lr', 'w_decay', 'seed', 'burst_frac', 'kld_mult',
                'rec_mults', 'kld_anneal', 'model_args', 'train_args',
                'eval_args']
        row = [getattr(args, c) for c in cols] + [self.model.h_dim,
                                                   self.model.z_dim]
        header = not os.path.exists(fname)
        with open(fname, 'a', newline='') as f:
            w = csv.writer(f, delimiter='\t')
            if header:
                w.writerow([''] + cols + ['h_dim', 'z_dim'])
            w.writerow([0] + row)

    def load_checkpoint(self, path, device=None):
        """The checkpoint at ``path`` (``checkpoint.load_checkpoint``)."""
        return ckpt.load_checkpoint(path)

    def _adam_states(self):
        """{leaf path: Adam's state} for the leaves that have one."""
        return {path: self.optimizer.state[p]
                for path, p in tree_leaves_with_path(self.params)
                if p in self.optimizer.state}

    def _snapshot(self):
        """(params, state, Adam state) cloned, on the device."""
        clone = lambda x: x.detach().clone()  # noqa: E731
        adam = {path: {k: (v.clone() if torch.is_tensor(v) else v)
                       for k, v in st.items()}
                for path, st in self._adam_states().items()}
        return tree_map(clone, self.params), tree_map(clone, self.state), adam

    @staticmethod
    def _write(path, modalities, snapshot, extra=None):
        """A checkpoint of (params, state, Adam state): params and state in
        the JAX layout, Adam's moments under ``torch_adam``."""
        params, state, adam = snapshot
        jparams, jstate = params_to_jax(params, state)
        ckpt.save_checkpoint(path, modalities, jparams, jstate, extra=dict(
            extra or {}, torch_adam=adam_to_jax(adam, params)))

    def save_checkpoint(self, modalities, path, extra=None):
        """This trainer's checkpoint, with the sampling generator's
        state."""
        self._write(path, modalities,
                    (self.params, self.state, self._adam_states()),
                    extra=dict(extra or {},
                               torch_gen=self.gen.get_state().numpy()))

    def restore(self, checkpoint, opt=False):
        """Weights and BatchNorm state from a checkpoint of either
        package, copied into the leaves that the optimizer holds; with
        ``opt``, also Adam's moments (``torch_adam``, or the JAX
        package's ``opt_state``)."""
        state = checkpoint.get("state")
        if state is None:
            state = params_to_jax(self.params, self.state)[1]
        params, self.state = params_from_jax(checkpoint["params"], state,
                                             self.model, self.device)
        new = dict(tree_leaves_with_path(params))
        with torch.no_grad():
            for path, p in tree_leaves_with_path(self.params):
                p.copy_(new[path].reshape(p.shape))
        if not opt:
            return
        moments = checkpoint.get("torch_adam")
        if moments is not None:
            moments = (moments["count"], moments["mu"], moments["nu"])
        elif "opt_state" in checkpoint:
            moments = optax_adam_moments(checkpoint["opt_state"])
        if moments is not None:
            load_adam(self.optimizer, self.params, *moments)

    @staticmethod
    def _latest_epoch_checkpoint(save_dir):
        """The newest loadable ``epoch_N.pth`` in ``save_dir`` as (N,
        payload), (None, None) when there is none; an unreadable newest
        file (killed mid-write) falls back to the one before."""
        epochs = []
        if os.path.isdir(save_dir):
            for fname in os.listdir(save_dir):
                m = re.fullmatch(r"epoch_(\d+)\.pth", fname)
                if m:
                    epochs.append(int(m.group(1)))
        for n in sorted(epochs, reverse=True):
            path = os.path.join(save_dir, "epoch_{}.pth".format(n))
            try:
                return n, ckpt.load_checkpoint(path)
            except Exception as e:  # noqa: BLE001 -- try the next one
                print("Skipping unreadable checkpoint {} ({!r})"
                      .format(path, e))
        return None, None

    # -- hooks of the apps ----------------------------------------------------

    @classmethod
    def pre_build_args(cls, args):
        """The ``--method`` remap: ``bfvi`` is the ``dmm`` model with 200
        filter particles in evaluation unless ``--eval_args`` sets them;
        ``b-mask``, ``f-mask``, ``b-skip`` and ``f-skip`` are the ``dks``
        model with ``--model_args`` replaced by their ``rnn_dir`` and
        ``rnn_skip``; an unknown method is reported and ignored.
        ``--batch_sz_eval`` defaults to ``--batch_size``."""
        if args.batch_sz_eval is None:
            args.batch_sz_eval = args.batch_size
        if args.method in METHODS:
            print("Setting up '{}' inference method...".format(args.method))
            print("The --model and --model_args flags will be overwritten.")
            args.model = method_model(args.method, args.model)
            if args.model == 'dks':
                args.model_args = {
                    "rnn_skip": 'skip' in args.method,
                    "rnn_dir": 'bwd' if args.method[0] == 'b' else 'fwd',
                }
        elif args.method is not None:
            print("Ignoring unknown inference method '{}'".format(
                args.method))
        args.eval_args = method_eval_args(args.method, args.eval_args)
        return args

    def post_build_args(self, args):
        """Derived args once the model is built (the app's hook)."""
        return args

    @classmethod
    def load_data(cls, modalities, args):
        raise NotImplementedError

    @classmethod
    def build_model(cls, args):
        raise NotImplementedError


    def compute_metrics(self, model, infer, prior, recon, targets, mask,
                        lengths, order, args, rec_mults=None):
        """The host path's metrics of one batch: those of
        ``compute_metrics_device`` with ``args.rec_mults`` (as the JAX
        host path, which does not read ``rec_mults``), per-sequence values as lists in input order."""
        dev = infer[0].device
        b_dim = np.asarray(mask).shape[1]
        lengths_pad = np.zeros((b_dim,), np.float32)
        lengths_pad[:len(lengths)] = lengths
        mets = self.compute_metrics_device(
            model, infer, prior, recon,
            {m: _copy_in(np.asarray(targets[m]), dev) for m in recon},
            _copy_in(np.asarray(mask), dev), _copy_in(lengths_pad, dev),
            args.rec_mults)
        out = {}
        for k, v in mets.items():
            v = _to_host(v)
            out[k] = float(v) if v.ndim == 0 else [v[i] for i in order]
        return out

    def summarize_metrics(self, metrics, n_timesteps):
        raise NotImplementedError

    def visualize(self, results, metric, args):
        raise NotImplementedError

    def save_results(self, results, args):
        raise NotImplementedError
