"""Spirals application: the model, its defaults, data, metrics and command
line (counterpart of multimodal_dmm_tpu/apps/spirals.py).

Two 1-D Normal modalities, the noisy x and y of a 2-D spiral (100 steps;
the corpus of 600 training and 400 test spirals is generated from seed 1
into ``--data_dir`` when it is missing), z = 5, h = 20 for every model.
Metrics: KLD and reconstruction loss, and the per-sequence time-averaged
squared error of the reconstructed (x, y).

    python -m multimodal_dmm_tpu_torch.apps.spirals --data_dir D \\
        --save_dir S --epochs E --method bfvi

runs on the GPU (``--device cpu`` for the CPU); ``--method b-mask``
(``f-mask``, ``b-skip``, ``f-skip``) trains a DKS baseline and ``--model
vrnn`` the VRNN; ``--load S/best.pth --evaluate`` evaluates a checkpoint
(spirals saves no results) and ``--visualize`` draws the best and worst
four fits to ``S/<set>.pdf`` (matplotlib).
"""

import copy
import os

import numpy as np
import torch

from ..data.spirals import SpiralsDataset
from ..models import get_model
from ..ops import losses
from ..training.eval_engine import time_avg_dev
from ..training.trainer import Trainer, summarize

# The app's flag defaults, as the JAX app sets them.
DEFAULTS = {
    'modalities': ['spiral-x', 'spiral-y'],
    'batch_size': 100, 'split': 1, 'bylen': False,
    'epochs': 500, 'lr': 1e-4,
    'kld_anneal': 100, 'burst_frac': 0.1,
    'drop_frac': 0.5, 'start_frac': 0.25, 'stop_frac': 0.75,
    'eval_metric': 'mse', 'viz_metric': 'mse',
    'eval_freq': 10, 'save_freq': 10,
    'data_dir': './data/spirals',
    'save_dir': './spirals_save',
}
DIMS = {'spiral-x': 1, 'spiral-y': 1}


def build_model(modalities=None, model_args=None, model="dmm"):
    """The registry's ``model`` (default MultiDMM) over the 1-D modalities,
    z = 5, h = 20."""
    modalities = list(modalities or DEFAULTS["modalities"])
    return get_model(model)(modalities, dims=[DIMS[m] for m in modalities],
                            z_dim=5, h_dim=20, **(model_args or {}))


class SpiralsTrainer(Trainer):
    """Trainer with the spirals app's defaults, data and metrics."""

    # A deep copy: argparse's copy shares the actions, so set_defaults
    # would reach the base parser.
    parser = copy.deepcopy(Trainer.parser)
    parser.add_argument('--train_subdir', type=str, default='train',
                        metavar='DIR', help='training data subdirectory')
    parser.add_argument('--test_subdir', type=str, default='test',
                        metavar='DIR', help='testing data subdirectory')
    parser.set_defaults(**DEFAULTS)
    # The app's defaults, read by the experiment suites (data_dir).
    defaults = DEFAULTS

    @classmethod
    def build_model(cls, args):
        return build_model(args.modalities, args.model_args, args.model)

    @classmethod
    def pre_build_args(cls, args):
        """The trainer's ``--method`` remap; the DKS baselines neither feed
        the features to the combiner nor add the unimodal ELBOs."""
        args = super().pre_build_args(args)
        if args.method in ('b-skip', 'f-skip', 'b-mask', 'f-mask'):
            args.model_args['feat_to_z'] = False
            args.train_args['uni_loss'] = False
        return args

    def post_build_args(self, args):
        """``--rec_mults auto``: (1 / dim) / n_mods / (1 - the uniform
        corruption) for each modality."""
        if args.rec_mults == 'auto':
            corrupt_mult = 1 / (1 - args.corrupt.get('uniform', 0.0))
            args.rec_mults = {
                m: ((1.0 / self.model._dim_of(m)) / len(args.modalities)
                    * corrupt_mult) for m in args.modalities}
        return args

    @classmethod
    def load_data(cls, modalities, args):
        """``--train_subdir`` and ``--test_subdir`` of ``--data_dir``;
        ``--normalize`` by the training set's statistics."""
        print("Loading data...")
        data_dir = os.path.abspath(args.data_dir)
        train_data, test_data = (
            SpiralsDataset(modalities, data_dir, sub, truncate=True,
                           item_as_dict=True)
            for sub in (args.train_subdir, args.test_subdir))
        print("Done.")
        if len(args.normalize) > 0:
            print("Normalizing ", args.normalize, "...")
            test_data.normalize_(modalities=args.normalize,
                                 ref_data=train_data)
            train_data.normalize_(modalities=args.normalize)
        return train_data, test_data

    def compute_metrics_device(self, model, infer, prior, recon, targets,
                               mask, lengths, rec_mults):
        """Per-batch metrics on the device: summed KLD and reconstruction
        loss, and the (B,) per-sequence time average of the squared error
        of the reconstructed modalities."""
        m_b = mask.bool()
        mets = {
            "kld_loss": losses.kld_gauss(infer[0], infer[1], prior[0],
                                         prior[1], m_b),
            "rec_loss": model.rec_loss({m: targets[m] for m in recon},
                                       recon, m_b, rec_mults),
        }
        mse = 0.0
        for m in recon:
            err = ((recon[m][0] - torch.nan_to_num(targets[m])) ** 2
                   * ~torch.isnan(targets[m]))
            mse = mse + err.sum(dim=tuple(range(2, err.dim())))
        mets["mse"] = time_avg_dev(mse, mask, lengths)
        return mets

    def summarize_metrics(self, metrics, n_timesteps):
        """Means and stds of per-sequence metrics, sums divided by
        ``n_timesteps``; printed as the JAX app prints them."""
        summary = summarize(metrics, n_timesteps)
        print(('Evaluation\tKLD: {:7.1f}\tRecon: {:7.1f}\t' +
               'MSE: {:6.3f} +-{:2.3f}').format(
                   summary['kld_loss'], summary['rec_loss'],
                   summary['mse'], summary['mse_std']))
        return summary

    def visualize(self, results, metric, args):
        """The best four and the worst four fits by ``metric``: the true
        spiral, the observed and the reconstructed points and the 95 %
        ellipses of the reconstruction, written headless (Agg) to
        ``save_dir/<eval set>.pdf`` as the JAX app writes them (nothing
        without an eval set)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from matplotlib.collections import EllipseCollection

        reference = results['targets']
        observed = results['inputs']
        predicted = results['recon']

        sel_idx = np.concatenate((np.argsort(metric)[:4],
                                  np.argsort(metric)[-4:][::-1]))
        fig, axes = plt.subplots(4, 2, figsize=(4, 8),
                                 subplot_kw={'aspect': 'equal'})
        for i, idx in enumerate(sel_idx):
            axis = axes[(i % 4), (i // 4)]
            true = reference['metadata'][idx][:, 0:2]
            data = (reference['spiral-x'][idx], reference['spiral-y'][idx])
            obsv = (observed['spiral-x'][idx], observed['spiral-y'][idx])
            pred = (predicted['spiral-x'][idx][:, 0],
                    predicted['spiral-y'][idx][:, 0])
            rng_ = (predicted['spiral-x'][idx][:, 1],
                    predicted['spiral-y'][idx][:, 1])
            ec = EllipseCollection(
                1.96 * rng_[0], 1.96 * rng_[1], (0,), units='x',
                facecolors=('c',), alpha=0.25,
                offsets=np.column_stack(pred), transOffset=axis.transData)
            axis.add_collection(ec)
            axis.plot(true[:, 0], true[:, 1], 'b-', linewidth=1.5)
            if (np.isnan(obsv[0]) != np.isnan(obsv[1])).any():
                axis.plot(obsv[0], data[1], '<', markersize=2,
                          color='#fe46a5')
                axis.plot(data[0], obsv[1], 'v', markersize=2,
                          color='#fec615')
            axis.plot(obsv[0], obsv[1], 'bo', markersize=3)
            axis.plot(pred[0], pred[1], '-', linewidth=1.5, color='#04d8b2')
            axis.set_xlim(-4, 4)
            axis.set_ylim(-4, 4)
            axis.set_title("Metric = {:0.3f}".format(metric[idx]))
            axis.set_xlabel("Spiral {:03d}".format(idx))
        plt.tight_layout()
        if getattr(args, 'eval_set', None) is not None:
            plt.savefig(os.path.join(args.save_dir, args.eval_set + '.pdf'))
        plt.close(fig)

    def save_results(self, results, args):
        """Nothing to save (the JAX app saves nothing either)."""


def make_trainer(seed=1, device="cuda", model="dmm", model_args=None,
                 train_args=None):
    """The app's model (the registry's ``model``) with weights drawn from
    ``seed``, the app's optimizer defaults (lr 1e-4, L2 1e-4) and its
    automatic rec_mults (1/2 for each of the two 1-D modalities)."""
    built = build_model(model_args=model_args, model=model)
    n_mods = len(built.modalities)
    rec_mults = {m: (1.0 / built._dim_of(m)) / n_mods
                 for m in built.modalities}
    return SpiralsTrainer(built, lr=DEFAULTS["lr"], rec_mults=rec_mults,
                          train_args=train_args, seed=seed, device=device)


def main(argv=None):
    """The command line (``SpiralsTrainer.main``): parse ``argv``, build the
    trainer, run it (under ``--mesh`` above 1, in one process a rank);
    returns what ``run`` returns."""
    return SpiralsTrainer.main(argv)


if __name__ == "__main__":
    main()
