"""VidTIMIT application: the audio-video model, the defaults it trains
and evaluates with, its data split, metrics and command line (counterpart
of multimodal_dmm_tpu/apps/vidtimit.py).

Video (3x64x64, conv codecs) and audio (spectrogram slices 10x1281, 1-D
conv codecs), both Bernoulli, z = h = 256; ``--model_args '{bf16:
true}'`` runs the convolutions in bfloat16. The test set is every
subject's sentences sa1 and sa2. Metrics: KLD and reconstruction loss,
video MSE and SSIM and audio MSE over time.

    python -m multimodal_dmm_tpu_torch.apps.vidtimit --data_dir D \\
        --save_dir S --epochs E --method bfvi

runs on the GPU (``--device cpu`` for the CPU); ``--load S/last.pth
--evaluate`` evaluates a checkpoint and writes each eval set's
reconstructions as ``S/<set>.avi`` and ``S/<set>.wav`` (``save_results``:
cv2, and the audio through the inverse STFT and ``scipy.io.wavfile``;
``--save_args '{skip: true}'``: metrics only), and ``--visualize`` its
storyboards and spectrograms as ``S/<set>.pdf`` (matplotlib). The DKS
baselines: ``--method b-mask`` (``f-mask``, ``b-skip``, ``f-skip``), over
the conv encoders' features. ``data.vidtimit.gen_synthetic(D)`` writes an
offline fixture; the corpus is not downloaded here.
"""

import copy
import os
import types

import numpy as np
import torch

from ..data import vidtimit
from ..models import codecs, get_model
from ..ops import losses
from ..ops.ssim import eval_ssim
from ..training.eval_engine import time_avg_dev
from ..training.trainer import Trainer, method_eval_args, summarize

# The app's flag defaults, as the JAX app sets them.
DEFAULTS = {
    'modalities': ['video', 'audio'],
    'batch_size': 25, 'split': 25, 'bylen': True,
    'epochs': 500, 'lr': 5e-4,
    'rec_mults': {'video': 1, 'audio': 1},
    'kld_anneal': 250, 'burst_frac': 0.1,
    'drop_frac': 0.0, 'start_frac': 0, 'stop_frac': 1,
    'eval_metric': 'rec_loss', 'viz_metric': 'ssim',
    'eval_freq': 10, 'save_freq': 10,
    'data_dir': './data/vidTIMIT',
    'save_dir': './vidTIMIT_save',
}
DIMS = {"video": (3, 64, 64), "audio": (10, 1281)}
DISTS = {"video": "Bernoulli", "audio": "Bernoulli"}
# The trainer's --w_decay default: the JAX app does not set its own.
W_DECAY = Trainer.parser.get_default("w_decay")


def build_model(modalities=None, model_args=None, model="dmm"):
    """The registry's ``model`` (default MultiDMM) with the conv image
    codecs for video and the 1-D conv codecs for audio: Gaussian heads,
    except for DKS, whose encoders give the conv features; ``bf16`` in
    ``model_args`` runs their convolutions in bfloat16."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model_args = dict(model_args or {})
    z_dim = model_args.pop("z_dim", 256)
    h_dim = model_args.pop("h_dim", 256)
    gauss_out = model not in ("MultiDKS", "dks")
    dt = torch.bfloat16 if model_args.pop("bf16", False) else None
    encoders = {
        "video": codecs.image_encoder_codec(z_dim, gauss_out,
                                            compute_dtype=dt),
        "audio": codecs.audio_encoder_codec(z_dim, gauss_out,
                                            compute_dtype=dt)}
    decoders = {
        "video": codecs.image_decoder_codec(z_dim, compute_dtype=dt),
        "audio": codecs.audio_decoder_codec(z_dim, compute_dtype=dt)}
    custom = [m for m in ("video", "audio") if m in modalities]
    return get_model(model)(modalities, dims=[DIMS[m] for m in modalities],
                            dists=[DISTS[m] for m in modalities],
                            encoders={m: encoders[m] for m in custom},
                            decoders={m: decoders[m] for m in custom},
                            z_dim=z_dim, h_dim=h_dim, **model_args)


class VidTIMITTrainer(Trainer):
    """Trainer with the VidTIMIT app's defaults, data split and
    metrics."""

    # A deep copy: argparse's copy shares the actions, so set_defaults
    # would reach the base parser.
    parser = copy.deepcopy(Trainer.parser)
    parser.set_defaults(**DEFAULTS)
    # The app's defaults, read by the experiment suites (data_dir).
    defaults = DEFAULTS

    @classmethod
    def build_model(cls, args):
        return build_model(args.modalities, args.model_args, args.model)

    @classmethod
    def pre_build_args(cls, args):
        """The trainer's ``--method`` remap; the DKS baselines add the
        unimodal ELBOs."""
        args = super().pre_build_args(args)
        if args.method in ("b-skip", "f-skip", "b-mask", "f-mask"):
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
        """The set in ``--data_dir``, sentences sa1 and sa2 held out as
        the test set; ``--normalize`` by the training set's statistics."""
        print("Loading data...")
        all_data = vidtimit.VidTIMITDataset(os.path.abspath(args.data_dir),
                                            item_as_dict=True)
        train_data = all_data.select([None, ['sa1', 'sa2']], invert=True)
        test_data = all_data.select([None, ['sa1', 'sa2']])
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
        loss, and (B,) per-sequence time averages of video MSE and SSIM
        and of audio MSE."""
        t_max, b_dim = mask.shape[:2]
        m_b = mask.bool()
        mets = {
            "kld_loss": losses.kld_gauss(infer[0], infer[1], prior[0],
                                         prior[1], m_b),
            "rec_loss": model.rec_loss({m: targets[m] for m in recon},
                                       recon, m_b, rec_mults),
        }

        def mse(rec, tgt):
            per_el = (rec - tgt) ** 2 / np.prod(tuple(rec.shape[2:]))
            return per_el.sum(dim=tuple(range(2, per_el.dim())))

        rec_vid = recon["video"][0]
        tgt_vid = torch.nan_to_num(targets["video"])
        ssim = eval_ssim(rec_vid.reshape((-1,) + tuple(rec_vid.shape[2:])),
                         tgt_vid.reshape((-1,) + tuple(tgt_vid.shape[2:])))
        mets["v_mse"] = time_avg_dev(mse(rec_vid, tgt_vid), mask, lengths)
        mets["ssim"] = time_avg_dev(ssim.reshape(t_max, b_dim), mask,
                                    lengths)
        mets["a_mse"] = time_avg_dev(
            mse(recon["audio"][0], torch.nan_to_num(targets["audio"])),
            mask, lengths)
        return mets

    def summarize_metrics(self, metrics, n_timesteps):
        """Means and stds of per-sequence metrics, sums divided by
        ``n_timesteps``; printed as the JAX app prints them."""
        summary = summarize(metrics, n_timesteps)
        print("Evaluation\tKLD: {:7.1f}\tRecon: {:7.1f}".format(
            summary["kld_loss"], summary["rec_loss"]))
        print("\tVideo\tMSE: {:2.3f} +/- {:2.3f}\tSSIM: {:2.3f} "
              "+/- {:2.3f}".format(summary["v_mse"], summary["v_mse_std"],
                                   summary["ssim"], summary["ssim_std"]))
        print("\tAudio\tMSE: {:2.3f} +/- {:2.3f}".format(
            summary["a_mse"], summary["a_mse_std"]))
        return summary

    def visualize(self, results, metric, args):
        """Storyboards of the best and the worst sequence by ``metric``
        (original, observed and reconstructed rows of eight video frames)
        beside their magnitude spectrograms, written headless (Agg) to
        ``save_dir/<eval set>.pdf`` (``visualize.pdf`` without an eval
        set) as the JAX app writes them."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        reference = results['targets']
        observed = results['inputs']
        predicted = results['recon']

        sel_idx = np.concatenate((np.argsort(metric)[-1:][::-1],
                                  np.argsort(metric)[:1]))
        fig, axes = plt.subplots(nrows=3 * len(sel_idx), ncols=2,
                                 figsize=(12, 4 * len(sel_idx) + 0.5))

        def stitch(video, times):
            nc = video.shape[1]
            board = [np.hstack([video[t].transpose(1, 2, 0),
                                np.ones((64, 1, nc))]) for t in times]
            return np.squeeze(np.hstack(board))

        def plot_board(axis, board, y_label):
            axis.set_xticks([])
            axis.set_yticks([])
            if board.ndim == 2:
                axis.imshow(board, cmap='gray')
            else:
                axis.imshow(board)
            axis.set_ylabel(y_label)

        def plot_spectrogram(axis, audio, y_label):
            audio = audio[:, :audio.shape[1] // 2]
            spec = audio[:, 2, :].T  # the central window of the 5-stack
            axis.imshow(spec, aspect='auto', cmap='gray')
            axis.set_yticks([0, spec.shape[0] // 2, spec.shape[0] - 1])
            axis.set_ylabel(y_label)
            axis.tick_params(length=0)

        for i, idx in enumerate(sel_idx):
            true = reference['video'][idx]
            obsv = observed['video'][idx]
            pred = predicted['video'][idx][:, 0]
            times = np.linspace(0, len(true) - 1, 8, dtype=int)
            true_b = stitch(true, times)
            obsv_b = stitch(obsv, times)
            pred_b = stitch(np.clip(pred, 0, 1), times)
            obsv_b = np.where(np.isnan(obsv_b), 1.0, obsv_b)
            plot_board(axes[3 * i, 0], true_b, "Original")
            plot_board(axes[3 * i + 1, 0], obsv_b, "Observed")
            plot_board(axes[3 * i + 2, 0], pred_b, "Reconstructed")
            axes[3 * i, 0].set_title('Metric: {:0.3f}'.format(metric[idx]),
                                     fontdict={'fontsize': 10}, loc='right')

            t_aud = reference['audio'][idx]
            o_aud = np.array(observed['audio'][idx], copy=True)
            p_aud = predicted['audio'][idx][:, 0]
            o_aud[np.isnan(o_aud)] = 1.0
            plot_spectrogram(axes[3 * i, 1], t_aud, "Original")
            plot_spectrogram(axes[3 * i + 1, 1], o_aud, "Observed")
            plot_spectrogram(axes[3 * i + 2, 1], p_aud, "Reconstructed")

        for ax in axes.ravel():
            for spine in ax.spines.values():
                spine.set_visible(False)
        plt.tight_layout()
        name = getattr(args, 'eval_set', None) or 'visualize'
        plt.savefig(os.path.join(args.save_dir, name + '.pdf'))
        plt.close(fig)

    def save_results(self, results, args):
        """The reconstructions as AVI (cv2 ``VideoWriter``, fourcc 0:
        uncompressed) and WAV (the spectrograms through the inverse STFT,
        ``data.vidtimit.spec_to_wav``, written by ``scipy.io.wavfile``), as
        the JAX app writes them. ``--save_args``: ``one_file`` (default
        true: every sequence in ``filename``.avi/.wav, default the eval
        set's name; else ``{subject}_{sentence}`` each) and
        ``comparison`` (default true: original, observed and
        reconstructed side by side, and their audio one after the
        other)."""
        import cv2 as cv
        import scipy.io.wavfile
        print("Saving results...")
        seq_ids = results['seq_ids']
        reference = results['targets']
        observed = results['inputs']
        predicted = results['recon']

        save_args = {'one_file': True,
                     'filename': str(args.eval_set),
                     'comparison': True}
        save_args.update(args.save_args)

        shape = reference['video'][0].shape[2:4]
        if save_args['comparison']:
            shape = (shape[0] * 3, shape[1])
        fps = vidtimit.fps
        audio_rate = vidtimit.audio_rate

        if save_args['one_file']:
            path = os.path.join(args.save_dir, save_args['filename'])
            vwriter = cv.VideoWriter(path + '.avi', 0, fps, shape)
            wav_all = np.empty((0,), float)

        def preprocess(frame):
            return cv.cvtColor(
                (np.clip(np.nan_to_num(frame), 0, 1) * 255).astype('uint8'),
                cv.COLOR_RGB2BGR)

        for i, seq_id in enumerate(seq_ids):
            r_wav = vidtimit.spec_to_wav(
                np.nan_to_num(reference['audio'][i]), audio_rate)
            o_wav = vidtimit.spec_to_wav(
                np.nan_to_num(observed['audio'][i]), audio_rate)
            p_wav = vidtimit.spec_to_wav(predicted['audio'][i][:, 0],
                                         audio_rate)
            if save_args['comparison']:
                wav = np.concatenate([r_wav, o_wav, p_wav], axis=0)
            else:
                wav = p_wav

            r_vid = reference['video'][i].transpose((0, 2, 3, 1))
            o_vid = observed['video'][i].transpose((0, 2, 3, 1))
            p_vid = predicted['video'][i][:, 0].transpose((0, 2, 3, 1))

            if not save_args['one_file']:
                path = os.path.join(args.save_dir,
                                    '{}_{}'.format(seq_id[0], seq_id[1]))
                vwriter = cv.VideoWriter(path + '.avi', 0, fps, shape)

            for t in range(len(p_vid)):
                frame = preprocess(p_vid[t])
                if not save_args['comparison']:
                    vwriter.write(frame)
                    continue
                vwriter.write(np.hstack([preprocess(r_vid[t]),
                                         preprocess(o_vid[t]), frame]))
            if save_args['one_file']:
                wav_all = np.append(wav_all, wav, axis=0)
            else:
                vwriter.release()
                scipy.io.wavfile.write(path + '.wav', audio_rate, wav)
        if save_args['one_file']:
            vwriter.release()
            scipy.io.wavfile.write(path + '.wav', audio_rate, wav_all)


def make_trainer(seed=1, device="cuda", modalities=None, model_args=None,
                 train_args=None, clip_grad=None, model="dmm"):
    """The VidTIMIT model (the registry's ``model``) with weights drawn
    from ``seed`` and the app's optimizer defaults (lr 5e-4, L2 1e-4,
    rec_mults 1/1)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model = build_model(modalities, model_args, model)
    rec_mults = {m: DEFAULTS["rec_mults"][m] for m in modalities}
    return VidTIMITTrainer(model, lr=DEFAULTS["lr"], w_decay=W_DECAY,
                           clip_grad=clip_grad, rec_mults=rec_mults,
                           train_args=train_args, seed=seed, device=device)


def eval_namespace(method="bfvi", modalities=None, **overrides):
    """The namespace that ``Trainer.evaluate`` reads, with the app's
    defaults: no random deletion (``drop_frac`` 0), the whole sequence
    kept, drop and keep no modality, score every modality, no
    visualization, and the eval args of ``method`` (``bfvi``: 200 filter
    particles, MAP otherwise)."""
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
    """The command line (``VidTIMITTrainer.main``): parse ``argv``, build the
    trainer, run it (under ``--mesh`` above 1, in one process a rank);
    returns what ``run`` returns."""
    return VidTIMITTrainer.main(argv)


if __name__ == "__main__":
    main()
