"""Models: the NN core, codecs, and the model registry of the trainer's
``--model`` flag (counterpart of multimodal_dmm_tpu/models/__init__.py)."""

# Short names of the trainer's --model flag.
names = {"dmm": "MultiDMM", "dks": "MultiDKS", "vrnn": "MultiVRNN"}


def get_model(name):
    """The model class of a short or long name."""
    from .dks import MultiDKS
    from .dmm import MultiDMM
    from .vrnn import MultiVRNN
    classes = {"MultiDMM": MultiDMM, "MultiDKS": MultiDKS,
               "MultiVRNN": MultiVRNN}
    long_name = names.get(name, name)
    if long_name not in classes:
        raise ValueError("Model name not recognized: " + name)
    return classes[long_name]
