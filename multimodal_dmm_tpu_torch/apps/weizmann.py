"""Weizmann application: the model, the defaults it trains and evaluates
with, its data split, metrics and command line (counterpart of
multimodal_dmm_tpu/apps/weizmann.py).

Video (3x64x64, Bernoulli, conv codecs; ``--model_args '{bf16: true}'``
runs the convolutions in bfloat16) + person and action (10-way
Categorical), z = h = 256. Training holds out the person 'shahar' for
the test set. Metrics: KLD and reconstruction loss, video (and mask) MSE
and SSIM, person and action accuracy over time.

    python -m multimodal_dmm_tpu_torch.apps.weizmann --data_dir D \\
        --save_dir S --epochs E --method bfvi \\
        --model_args '{bf16: true}' --train_args '{ragged_mode_scans: true}'

runs on the GPU (``--device cpu`` for the CPU); ``--load S/best.pth
--evaluate`` evaluates a checkpoint and writes each eval set's
reconstructions as ``S/<set>.avi`` (``save_results``, cv2; ``--save_args
'{skip: true}'``: metrics only), and ``--visualize`` its storyboards as
``S/<set>.pdf`` (matplotlib). The DKS baselines: ``--method b-mask``
(``f-mask``, ``b-skip``, ``f-skip``), over the conv encoder's features.
"""

import copy
import os
import types

import numpy as np
import torch

from ..data import weizmann
from ..models import codecs, get_model
from ..ops import losses
from ..ops.ssim import eval_ssim
from ..training.eval_engine import time_avg_dev
from ..training.trainer import Trainer, method_eval_args, summarize

# The app's flag defaults, as the JAX app sets them.
DEFAULTS = {
    'modalities': ['video', 'person', 'action'],
    'batch_size': 25, 'split': 25, 'bylen': True,
    'epochs': 500, 'lr': 5e-4, 'w_decay': 1e-4,
    'rec_mults': {'video': 1, 'mask': 1, 'person': 10, 'action': 10},
    'kld_anneal': 250, 'burst_frac': 0.2,
    'drop_frac': 0.5, 'start_frac': 0, 'stop_frac': 1,
    'eval_metric': 'rec_loss', 'viz_metric': 'ssim',
    'eval_freq': 10, 'save_freq': 10,
    'data_dir': './data/weizmann',
    'save_dir': './weizmann_save',
}
DIMS = {"video": (3, 64, 64), "mask": (1, 64, 64), "person": 10,
        "action": 10}
DISTS = {"video": "Bernoulli", "mask": "Bernoulli", "person": "Categorical",
         "action": "Categorical"}


def build_model(modalities=None, model_args=None, model="dmm"):
    """The registry's ``model`` (default MultiDMM) with conv codecs for the
    image modalities: Gaussian heads, except for DKS, whose encoders give
    the conv features; ``bf16`` in ``model_args`` runs their convolutions
    in bfloat16 (float32 weights, BatchNorm and heads)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model_args = dict(model_args or {})
    z_dim = model_args.pop("z_dim", 256)
    h_dim = model_args.pop("h_dim", 256)
    gauss_out = model not in ("MultiDKS", "dks")
    dt = torch.bfloat16 if model_args.pop("bf16", False) else None
    encoders = {
        "video": codecs.image_encoder_codec(z_dim, gauss_out,
                                            compute_dtype=dt),
        "mask": codecs.image_encoder_codec(z_dim, gauss_out, n_channels=1,
                                           compute_dtype=dt)}
    decoders = {
        "video": codecs.image_decoder_codec(z_dim, compute_dtype=dt),
        "mask": codecs.image_decoder_codec(z_dim, n_channels=1,
                                           compute_dtype=dt)}
    custom = [m for m in ("video", "mask") if m in modalities]
    return get_model(model)(modalities, dims=[DIMS[m] for m in modalities],
                            dists=[DISTS[m] for m in modalities],
                            encoders={m: encoders[m] for m in custom},
                            decoders={m: decoders[m] for m in custom},
                            z_dim=z_dim, h_dim=h_dim, **model_args)


class WeizmannTrainer(Trainer):
    """Trainer with the Weizmann app's defaults, data split and
    metrics."""

    # A deep copy: argparse's copy shares the actions, so set_defaults
    # would reach the base parser.
    parser = copy.deepcopy(Trainer.parser)
    parser.add_argument('--viz_mod', type=str, default='video',
                        metavar='M', help='image modality to visualize')
    parser.set_defaults(**DEFAULTS)
    # The app's defaults, read by the experiment suites (data_dir).
    defaults = DEFAULTS

    @classmethod
    def build_model(cls, args):
        return build_model(args.modalities, args.model_args, args.model)

    @classmethod
    def pre_build_args(cls, args):
        """The trainer's ``--method`` remap; the DKS baselines feed the
        features to the combiner and add the unimodal ELBOs."""
        args = super().pre_build_args(args)
        if args.method in ("b-skip", "f-skip", "b-mask", "f-mask"):
            args.model_args["feat_to_z"] = True
            args.train_args["uni_loss"] = True
        return args

    @classmethod
    def post_build_args(cls, args):
        """Scale rec_mults by 1 / (1 - the uniform corruption)."""
        corrupt_mult = 1 / (1 - args.corrupt.get('uniform', 0.0))
        args.rec_mults = {m: args.rec_mults[m] * corrupt_mult
                          for m in args.modalities}
        return args

    @classmethod
    def load_data(cls, modalities, args):
        """The set in ``--data_dir``, person 'shahar' held out as the test
        set; ``--normalize`` by the training set's statistics."""
        print("Loading data...")
        all_data = weizmann.WeizmannDataset(os.path.abspath(args.data_dir),
                                            item_as_dict=True)
        train_data = all_data.select([['shahar'], None], invert=True)
        test_data = all_data.select([['shahar'], None])
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
        loss, and (B,) per-sequence time averages of video (and mask) MSE
        and SSIM and of person and action accuracy."""
        t_max, b_dim = mask.shape[:2]
        m_b = mask.bool()
        mets = {
            "kld_loss": losses.kld_gauss(infer[0], infer[1], prior[0],
                                         prior[1], m_b),
            "rec_loss": model.rec_loss({m: targets[m] for m in recon},
                                       recon, m_b, rec_mults),
        }

        def img_metrics(rec, tgt):
            tgt_f = torch.nan_to_num(tgt)
            per_px = (rec - tgt_f) ** 2 / np.prod(tuple(rec.shape[2:]))
            mse = per_px.sum(dim=tuple(range(2, per_px.dim())))
            ssim = eval_ssim(rec.reshape((-1,) + tuple(rec.shape[2:])),
                             tgt_f.reshape((-1,) + tuple(tgt_f.shape[2:])))
            return mse, ssim.reshape(t_max, b_dim)

        for m, key in (("video", ""), ("mask", "m_")):
            if m == "video" or m in recon:
                mse, ssim = img_metrics(recon[m][0], targets[m])
                mets[key + "mse"] = time_avg_dev(mse, mask, lengths)
                mets[key + "ssim"] = time_avg_dev(ssim, mask, lengths)
        for m in ("action", "person"):
            if m not in recon or m not in targets:
                mets[m] = torch.zeros((b_dim,), device=mask.device)
                continue
            correct = (recon[m][0].argmax(dim=-1)
                       == torch.nan_to_num(targets[m])[..., 0].to(
                           torch.int64))
            mets[m] = time_avg_dev(correct.to(torch.float32), mask, lengths)
        return mets

    def summarize_metrics(self, metrics, n_timesteps):
        """Means and stds of per-sequence metrics, sums divided by
        ``n_timesteps``; printed as the JAX app prints them."""
        summary = summarize(metrics, n_timesteps)
        print("Evaluation\tKLD: {:7.1f}\tRecon: {:7.1f}".format(
            summary["kld_loss"], summary["rec_loss"]))
        print("\tVideo\tMSE: {:2.3f} +/- {:2.3f}\tSSIM: {:2.3f} "
              "+/- {:2.3f}".format(summary["mse"], summary["mse_std"],
                                   summary["ssim"], summary["ssim_std"]))
        print("\tMask\tMSE: {:2.3f} +/- {:2.3f}\tSSIM: {:2.3f} "
              "+/- {:2.3f}".format(summary["m_mse"], summary["m_mse_std"],
                                   summary["m_ssim"], summary["m_ssim_std"]))
        print("\t\tAct: {:2.3f} +/- {:2.3f}\tPers: {:2.3f} "
              "+/- {:2.3f}".format(summary["action"], summary["action_std"],
                                   summary["person"], summary["person_std"]))
        return summary

    def visualize(self, results, metric, args):
        """Storyboards of the best and the worst sequence by ``metric``:
        original, observed and reconstructed rows of eight frames of
        ``--viz_mod`` with their action labels, written headless (Agg) to
        ``save_dir/<eval set>.pdf`` as the JAX app writes them."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        reference = results['targets']
        observed = results['inputs']
        predicted = results['recon']
        viz_mod = getattr(args, 'viz_mod', 'video')

        sel_idx = np.concatenate((np.argsort(metric)[-1:][::-1],
                                  np.argsort(metric)[:1]))
        fig, axes = plt.subplots(
            nrows=3 * len(sel_idx), ncols=1,
            figsize=(8, 4 * len(sel_idx) + 0.5),
            subplot_kw={'aspect': 'equal'})

        def stitch(video, times):
            nc = video.shape[1]
            board = [np.hstack([video[t].transpose(1, 2, 0),
                                np.ones((64, 1, nc))]) for t in times]
            return np.squeeze(np.hstack(board))

        def plot_board(axis, board, tick_labels, y_label):
            axis.set_xticks(np.arange(32, 65 * len(tick_labels), 65))
            axis.set_xticklabels(tick_labels)
            axis.set_yticks([])
            if board.ndim == 2:
                axis.imshow(board, cmap='gray')
            else:
                axis.imshow(board)
            axis.set_ylabel(y_label)
            axis.tick_params(length=0)

        for i, idx in enumerate(sel_idx):
            true = reference[viz_mod][idx]
            obsv = observed[viz_mod][idx]
            pred = predicted[viz_mod][idx][:, 0]
            t_act = reference['action'][idx]
            o_act = observed['action'][idx]
            p_act = (predicted['action'][idx][:, 0]
                     if 'action' in predicted else None)

            times = np.linspace(0, len(true) - 1, 8, dtype=int)
            true_board = stitch(true, times)
            obsv_board = stitch(obsv, times)
            pred_board = stitch(np.clip(pred, 0, 1), times)
            obsv_board = np.where(np.isnan(obsv_board), 1.0, obsv_board)

            t_labels = [weizmann.actions[int(t_act[t, 0])] for t in times]
            o_labels = ['' if (o_act[t, 0] != o_act[t, 0]) else
                        weizmann.actions[int(o_act[t, 0])] for t in times]
            if p_act is not None:
                pred_probs = p_act.max(axis=1)
                names = [weizmann.actions[a] for a in p_act.argmax(axis=1)]
                p_labels = ['{} ({:0.1f})'.format(names[t], pred_probs[t])
                            for t in times]
            else:
                p_labels = [''] * len(times)

            plot_board(axes[3 * i], true_board, t_labels, "Original")
            plot_board(axes[3 * i + 1], obsv_board, o_labels, "Observed")
            plot_board(axes[3 * i + 2], pred_board, p_labels,
                       "Reconstructed")
            axes[3 * i].set_title('Metric: {:0.3f}'.format(metric[idx]),
                                  fontdict={'fontsize': 10}, loc='right')
        for ax in axes:
            for spine in ax.spines.values():
                spine.set_visible(False)
        plt.tight_layout()
        if getattr(args, 'eval_set', None) is not None:
            plt.savefig(os.path.join(args.save_dir, args.eval_set + '.pdf'))
        plt.close(fig)

    def save_results(self, results, args):
        """The reconstructed videos as AVI (cv2 ``VideoWriter``, fourcc 0:
        uncompressed), as the JAX app writes them. ``--save_args``:
        ``one_file`` (default true: all sequences in ``filename``, default
        ``<eval set>.avi``; else one ``{person}_{action}.avi`` each),
        ``comparison`` (default true: original, observed and
        reconstructed side by side) and ``labels`` (default true: the
        action and person names on each frame, the predicted ones on the
        reconstruction)."""
        import cv2 as cv
        print("Saving results...")
        reference = results['targets']
        observed = results['inputs']
        predicted = results['recon']

        save_args = {'one_file': True,
                     'filename': str(args.eval_set) + '.avi',
                     'labels': True,
                     'comparison': True}
        save_args.update(args.save_args)

        shape = reference['video'][0].shape[2:4]
        if save_args['comparison']:
            shape = (shape[0] * 3, shape[1])
        fps = weizmann.fps

        if save_args['one_file']:
            path = os.path.join(args.save_dir, save_args['filename'])
            vwriter = cv.VideoWriter(path, 0, fps, shape)

        def preprocess(frame):
            return cv.cvtColor(
                (np.clip(np.nan_to_num(frame), 0, 1) * 255).astype('uint8'),
                cv.COLOR_RGB2BGR)

        def add_label(image, text, pos):
            cv.putText(image, text, pos, cv.FONT_HERSHEY_SIMPLEX, 0.4,
                       (255, 255, 255), 1, cv.LINE_AA)

        for i in range(len(reference['video'])):
            r_vid = reference['video'][i].transpose((0, 2, 3, 1))
            o_vid = observed['video'][i].transpose((0, 2, 3, 1))
            p_vid = predicted['video'][i][:, 0].transpose((0, 2, 3, 1))

            if not save_args['one_file']:
                p_id = reference['person'][i][0]
                a_id = reference['action'][i][0]
                path = '{}_{}.avi'.format(weizmann.persons[int(p_id[0])],
                                          weizmann.actions[int(a_id[0])])
                vwriter = cv.VideoWriter(os.path.join(args.save_dir, path),
                                         0, fps, shape)

            for t in range(len(p_vid)):
                frame = preprocess(p_vid[t])
                if save_args['labels']:
                    if 'action' in predicted:
                        probs = predicted['action'][i][t, 0]
                        add_label(frame,
                                  weizmann.actions[int(np.argmax(probs))],
                                  (2, 10))
                    if 'person' in predicted:
                        probs = predicted['person'][i][t, 0]
                        add_label(frame,
                                  weizmann.persons[int(np.argmax(probs))],
                                  (2, 60))
                if not save_args['comparison']:
                    vwriter.write(frame)
                    continue
                r_frame = preprocess(r_vid[t])
                o_frame = preprocess(o_vid[t])
                if save_args['labels']:
                    r_idx = reference['action'][i][t, 0]
                    o_idx = observed['action'][i][t, 0]
                    add_label(r_frame, weizmann.actions[int(r_idx)], (2, 10))
                    if o_idx == o_idx:
                        add_label(o_frame, weizmann.actions[int(o_idx)],
                                  (2, 10))
                    r_idx = reference['person'][i][t, 0]
                    o_idx = observed['person'][i][t, 0]
                    add_label(r_frame, weizmann.persons[int(r_idx)], (2, 60))
                    if o_idx == o_idx:
                        add_label(o_frame, weizmann.persons[int(o_idx)],
                                  (2, 60))
                vwriter.write(np.hstack([r_frame, o_frame, frame]))
            if not save_args['one_file']:
                vwriter.release()
        if save_args['one_file']:
            vwriter.release()


def make_trainer(seed=1, device="cuda", modalities=None, model_args=None,
                 train_args=None, clip_grad=None, model="dmm"):
    """The Weizmann model (the registry's ``model``) with weights drawn
    from ``seed`` and the app's optimizer defaults (lr 5e-4, L2 1e-4,
    rec_mults 1/10/10)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model = build_model(modalities, model_args, model)
    rec_mults = {m: DEFAULTS["rec_mults"][m] for m in modalities}
    return WeizmannTrainer(model, lr=DEFAULTS["lr"],
                           w_decay=DEFAULTS["w_decay"], clip_grad=clip_grad,
                           rec_mults=rec_mults, train_args=train_args,
                           seed=seed, device=device)


def eval_namespace(method="bfvi", modalities=None, **overrides):
    """The namespace that ``Trainer.evaluate`` reads, with the app's
    defaults: delete half of each sequence's steps at random
    (``drop_frac`` 0.5, whole sequence kept otherwise), drop and keep no
    modality, score every modality, no visualization, and the eval args
    of ``method`` (``bfvi``: 200 filter particles, MAP otherwise)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    ns = dict(drop_frac=DEFAULTS["drop_frac"],
              start_frac=DEFAULTS["start_frac"],
              stop_frac=DEFAULTS["stop_frac"], drop_mods=[], keep_mods=[],
              eval_mods="all", visualize=False, eval_args={},
              rec_mults={m: DEFAULTS["rec_mults"][m] for m in modalities})
    ns.update(overrides)
    ns["eval_args"] = method_eval_args(method, ns["eval_args"])
    return types.SimpleNamespace(**ns)


def main(argv=None):
    """The command line (``WeizmannTrainer.main``): parse ``argv``, build the
    trainer, run it (under ``--mesh`` above 1, in one process a rank);
    returns what ``run`` returns."""
    return WeizmannTrainer.main(argv)


if __name__ == "__main__":
    main()
