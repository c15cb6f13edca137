"""Weights made on the device from the seed, in two large draws.

The configuration's parameter tree comes from ``reference.model.
param_specs``: each uniform leaf takes its slice of one ``torch.rand``
call scaled to its bound (the distributions of the program's own
initialisers), each normal leaf its slice of one ``torch.randn`` call, and
the constants (BatchNorm's scale, shift and running statistics, the global
prior) are filled in. Program and reference get the same trees.
"""

import torch


def _walk(spec, fn):
    if isinstance(spec, dict):
        return {k: _walk(v, fn) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_walk(v, fn) for v in spec]
    if isinstance(spec, tuple) and len(spec) == 3 and isinstance(spec[0],
                                                                 str):
        return fn(spec)
    return spec


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def make_tree(spec, seed, device):
    """The tree of ``spec`` with its leaves drawn from ``seed``."""
    counts = {"u": 0, "n": 0}

    def count(leaf):
        if leaf[0] in counts:
            counts[leaf[0]] += _numel(leaf[1])
        return leaf
    _walk(spec, count)
    gen = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFF)
    pools = {"u": torch.rand((counts["u"],), generator=gen, device=device),
             "n": torch.randn((counts["n"],), generator=gen, device=device)}
    offsets = {"u": 0, "n": 0}

    def fill(leaf):
        kind, shape, bound = leaf
        if kind == "c":
            return torch.full(shape, float(bound), device=device)
        n = _numel(shape)
        x = pools[kind][offsets[kind]:offsets[kind] + n].reshape(shape)
        offsets[kind] += n
        return (x * (2 * bound) - bound) if kind == "u" else x.clone()
    return _walk(spec, fill)
