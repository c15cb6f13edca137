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
--evaluate --save_args '{skip: true}'`` evaluates a checkpoint. The DKS
baselines: ``--method b-mask`` (``f-mask``, ``b-skip``, ``f-skip``), over
the conv encoders' features. ``data.vidtimit.gen_synthetic(D)`` writes an
offline fixture; the corpus is not downloaded here. Visualization and
AVI/WAV export come in a later slice.
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
