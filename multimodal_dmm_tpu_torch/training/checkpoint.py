"""Checkpoints in the JAX package's format (the port's own copy of
multimodal_dmm_tpu/training/checkpoint.py).

A checkpoint is a pickle of a dict of numpy trees: ``format`` (2),
``modalities``, ``params`` and ``state`` in the JAX package's layout
(``convert.params_to_jax``), and extras (``epoch``, ``best_loss``). The
JAX package writes its optax optimizer state under ``opt_state`` and its
sampling key under ``rng``; the port writes its Adam moments under
``torch_adam`` and its generator state under ``torch_gen``, keys that the
JAX package does not read, so each package resumes from its own
checkpoints and evaluates the other's.

Format 1 (no ``format`` key) stored deconvolution kernels as HWOI (WOI);
format 2 stores the spatially flipped HWIO (WIO) kernel of the equivalent
forward convolution. ``load_checkpoint`` converts format 1 on load, the
Adam moments of ``opt_state`` included. JAX-written pickles hold optax
NamedTuples: they unpickle here as stand-in tuples of the same class name
(``optax`` need not be installed).
"""

import pickle

import numpy as np

CHECKPOINT_FORMAT = 2


class OptaxStandIn(tuple):
    """A pickled optax NamedTuple: its fields in order, under its class
    name."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __repr__(self):
        return "%s%s" % (type(self).__name__, tuple.__repr__(self))


_STAND_INS = {}


def _stand_in(module, name):
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = type(name, (OptaxStandIn,), {"__module__": module})
    return _STAND_INS[key]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            return _stand_in(module, name)
        return super().find_class(module, name)


def _flip_deconv_w(w):
    """The format 1 -> 2 kernel permutation."""
    w = np.asarray(w)
    if w.ndim == 4:   # HWOI -> flipped HWIO
        return np.ascontiguousarray(
            np.transpose(w[::-1, ::-1, :, :], (0, 1, 3, 2)))
    if w.ndim == 3:   # WOI -> flipped WIO
        return np.ascontiguousarray(np.transpose(w[::-1, :, :], (0, 2, 1)))
    return w


def _convert_v1(obj):
    """Re-lay-out every ``deconvs`` kernel in a pickled tree (dicts, lists,
    tuples and optax states, whose Adam moments mirror the params)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "deconvs" and isinstance(v, (list, tuple)):
                v = [{kk: (_flip_deconv_w(vv) if kk == "w" else vv)
                      for kk, vv in layer.items()} for layer in v]
            else:
                v = _convert_v1(v)
            out[k] = v
        return out
    if isinstance(obj, tuple):
        vals = [_convert_v1(v) for v in obj]
        if isinstance(obj, OptaxStandIn) or hasattr(obj, "_fields"):
            return type(obj)(*vals)
        return tuple(vals)
    if isinstance(obj, list):
        return [_convert_v1(v) for v in obj]
    return obj


def save_checkpoint(path, modalities, params, state=None, extra=None):
    """Write numpy trees (JAX layout) and ``extra`` keys to ``path``."""
    payload = {"format": CHECKPOINT_FORMAT, "modalities": list(modalities),
               "params": params}
    if state is not None:
        payload["state"] = state
    if extra:
        payload.update(extra)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path):
    """The payload of a checkpoint of either package, in format 2."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("format", 1) < 2:
        for key in ("params", "opt_state"):
            if key in payload:
                payload[key] = _convert_v1(payload[key])
        payload["format"] = CHECKPOINT_FORMAT
    return payload
