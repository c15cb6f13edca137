"""The system under test: the port's app trainer for a configuration, built
as its command line builds it, on the benchmark's weights.

The app's parser gives every flag's default; the configuration's stated
values are set on top (so the file is what runs), and the app's hooks
derive the rest (``pre_build_args``: the ``bfvi`` method's model and its
200 evaluation particles; ``post_build_args``: the reconstruction
multipliers). The trainer takes the benchmark's weights instead of drawing
its own.
"""

import importlib

PACKAGE = "multimodal_dmm_tpu_torch"


def trainer_class(app):
    """The app module's trainer class."""
    mod = importlib.import_module("%s.apps.%s" % (PACKAGE, app))
    base = importlib.import_module(PACKAGE + ".training.trainer").Trainer
    found = [v for v in vars(mod).values() if isinstance(v, type)
             and issubclass(v, base) and v is not base]
    if len(found) != 1:
        raise RuntimeError("app %s has %d trainer classes" % (app,
                                                               len(found)))
    return found[0]


def build(cfg, params, state, seed, device):
    """(trainer, args) of the configuration: ``seed`` drives the trainer's
    sampling generator and the loader's shuffles and bursts. Each key of
    the configuration's ``train`` and ``eval`` sections that names a flag
    of the app sets that flag; the others go as they are into
    ``--train_args`` and ``--eval_args``. ``--model_args`` is the file's
    ``model_args`` with its ``z_dim`` and ``h_dim``."""
    cls = trainer_class(cfg["app"])
    args = cls.parser.parse_args(["--method", cfg["method"], "--seed",
                                  str(seed), "--device", str(device)])
    flags = vars(args)
    args.modalities = [m["name"] for m in cfg["modalities"]]
    args.model_args = dict(cfg.get("model_args", {}), z_dim=cfg["z_dim"],
                           h_dim=cfg["h_dim"])
    for section, extra in (("train", "train_args"), ("eval", "eval_args")):
        rest = {}
        for key, value in cfg[section].items():
            if key in flags and key not in ("train_args", "eval_args",
                                            "model_args"):
                setattr(args, key, value)
            else:
                rest[key] = value
        setattr(args, extra, rest)
    args = cls.pre_build_args(args)
    model = cls.build_model(args)
    trainer = cls(model, lr=args.lr, w_decay=args.w_decay,
                  clip_grad=args.clip_grad,
                  skip_nonfinite=not args.no_skip_nonfinite, seed=seed,
                  params=params, state=state, device=device)
    args = trainer.post_build_args(args) or args
    return trainer, args


def train_loader(trainer, args, items):
    """The device-resident training loader over ``items``, in the codec-
    native layout, as the trainer's training run builds it; sets the
    step's ``native_mods``."""
    dl = importlib.import_module(PACKAGE + ".training.device_loader")
    native = trainer.model.native_input_perms()
    loader = dl.DeviceTrainData(items, trainer.model.modalities,
                                args.batch_size, args.burst_frac,
                                native_perms=native, device=trainer.device)
    args.train_args = dict(args.train_args, native_mods=tuple(
        m for m in trainer.model.modalities if m in native))
    return loader


def eval_loader(args, items):
    """The host batch loader of the evaluation set."""
    ld = importlib.import_module(PACKAGE + ".training.loader")
    return ld.BatchLoader(items, batch_size=args.batch_sz_eval,
                          len_bucket=args.len_bucket)
