"""Weizmann application: the model, the defaults it trains and evaluates
with, and its metrics (counterpart of ``WeizmannTrainer`` in
multimodal_dmm_tpu/apps/weizmann.py).

Video (3x64x64, Bernoulli, conv codecs) + person and action (10-way
Categorical), z = h = 256. Metrics: KLD and reconstruction loss, video
(and mask) MSE and SSIM, person and action accuracy over time. The CLI,
data loading, visualization and video export are not ported yet.
"""

import types
from collections import defaultdict

import numpy as np
import torch

from ..models import codecs
from ..models.dmm import MultiDMM
from ..ops import losses
from ..ops.ssim import eval_ssim
from ..training.eval_engine import time_avg_dev
from ..training.trainer import Trainer, method_eval_args

DEFAULTS = {
    "modalities": ["video", "person", "action"],
    "lr": 5e-4, "w_decay": 1e-4,
    "rec_mults": {"video": 1, "mask": 1, "person": 10, "action": 10},
    "batch_size": 25, "drop_frac": 0.5, "start_frac": 0, "stop_frac": 1,
}
DIMS = {"video": (3, 64, 64), "mask": (1, 64, 64), "person": 10,
        "action": 10}
DISTS = {"video": "Bernoulli", "mask": "Bernoulli", "person": "Categorical",
         "action": "Categorical"}


def build_model(modalities=None, model_args=None):
    """MultiDMM with conv codecs for the image modalities."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model_args = dict(model_args or {})
    z_dim = model_args.pop("z_dim", 256)
    h_dim = model_args.pop("h_dim", 256)
    if model_args.pop("bf16", False):
        raise NotImplementedError("bf16 codecs are not ported yet; they "
                                  "come in a later slice of the port")
    encoders = {"video": codecs.image_encoder_codec(z_dim),
                "mask": codecs.image_encoder_codec(z_dim, n_channels=1)}
    decoders = {"video": codecs.image_decoder_codec(z_dim),
                "mask": codecs.image_decoder_codec(z_dim, n_channels=1)}
    custom = [m for m in ("video", "mask") if m in modalities]
    return MultiDMM(modalities, dims=[DIMS[m] for m in modalities],
                    dists=[DISTS[m] for m in modalities],
                    encoders={m: encoders[m] for m in custom},
                    decoders={m: decoders[m] for m in custom},
                    z_dim=z_dim, h_dim=h_dim, **model_args)


class WeizmannTrainer(Trainer):
    """Trainer with the Weizmann app's metrics."""

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

    def compute_metrics(self, model, infer, prior, recon, targets, mask,
                        lengths, order, args, rec_mults=None):
        """The host path's metrics of one batch: those of
        ``compute_metrics_device`` with ``args.rec_mults`` (as the JAX
        host path, which does not read ``rec_mults``), per-sequence values
        as lists in input order."""
        dev = infer[0].device
        b_dim = np.asarray(mask).shape[1]
        lengths_pad = np.zeros((b_dim,), np.float32)
        lengths_pad[:len(lengths)] = lengths
        mets = self.compute_metrics_device(
            model, infer, prior, recon,
            {m: torch.as_tensor(np.asarray(targets[m]), device=dev)
             for m in recon}, torch.as_tensor(np.asarray(mask), device=dev),
            torch.as_tensor(lengths_pad, device=dev), args.rec_mults)
        out = {}
        for k, v in mets.items():
            v = v.cpu().numpy()
            out[k] = float(v) if v.ndim == 0 else [v[i] for i in order]
        return out

    def summarize_metrics(self, metrics, n_timesteps):
        """Means and stds of per-sequence metrics, sums divided by
        ``n_timesteps``; printed as the JAX app prints them."""
        summary = defaultdict(lambda: float("nan"))
        for key, val in metrics.items():
            if isinstance(val, list):
                summary[key] = np.mean(val)
                summary[key + "_std"] = np.std(val)
            else:
                summary[key] = val / n_timesteps
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


def make_trainer(seed=1, device="cuda", modalities=None, model_args=None,
                 train_args=None, clip_grad=None):
    """The Weizmann model with weights drawn from ``seed`` and the app's
    optimizer defaults (lr 5e-4, L2 1e-4, rec_mults 1/10/10)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model = build_model(modalities, model_args)
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
