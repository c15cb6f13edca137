"""Nested-dict parameter trees: the port's stand-in for jax.tree_util.

Leaves are tensors; other values (BatchNorm's scalar ``eps`` and
``momentum``) are carried through unchanged. Dict keys are visited in
sorted order, as jax.tree_util visits them.
"""

import torch


def tree_leaves_with_path(tree, path=()):
    """[(path tuple, tensor)] in a fixed order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_path(v, path + (i,))
        return out
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    return []


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf; other leaves are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def tree_map_with_path(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every tensor leaf; other leaves are
    kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree
