"""Weizmann application: the model and the defaults it trains with
(counterpart of ``WeizmannTrainer.build_model`` and its defaults in
multimodal_dmm_tpu/apps/weizmann.py).

Video (3x64x64, Bernoulli, conv codecs) + person and action (10-way
Categorical), z = h = 256. The CLI, data loading and metrics are not
ported yet.
"""

from ..models import codecs
from ..models.dmm import MultiDMM
from ..training.trainer import Trainer

DEFAULTS = {
    "modalities": ["video", "person", "action"],
    "lr": 5e-4, "w_decay": 1e-4,
    "rec_mults": {"video": 1, "mask": 1, "person": 10, "action": 10},
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


def make_trainer(seed=1, device="cuda", modalities=None, model_args=None,
                 train_args=None, clip_grad=None):
    """The Weizmann model with weights drawn from ``seed`` and the app's
    optimizer defaults (lr 5e-4, L2 1e-4, rec_mults 1/10/10)."""
    modalities = list(modalities or DEFAULTS["modalities"])
    model = build_model(modalities, model_args)
    rec_mults = {m: DEFAULTS["rec_mults"][m] for m in modalities}
    return Trainer(model, lr=DEFAULTS["lr"], w_decay=DEFAULTS["w_decay"],
                   clip_grad=clip_grad, rec_mults=rec_mults,
                   train_args=train_args, seed=seed, device=device)
