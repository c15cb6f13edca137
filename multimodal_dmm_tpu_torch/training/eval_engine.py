"""Device-resident evaluation: eval sets uploaded once, and eval tasks
composed on the device (counterpart of
multimodal_dmm_tpu/training/eval_engine.py).

- ``DeviceEvalData`` collates an eval set once, with ``BatchLoader``'s
  batching, and keeps the padded target batches on the device.
- ``compose_task`` builds a task's inputs on the device: per (modality,
  sequence) it deletes exactly ``int(drop_frac * L)`` distinct valid
  steps, chosen uniformly from a ``torch.Generator``, then every step
  outside ``[int(start_frac * L), int(stop_frac * L))``, then NaN-fills
  ``drop_mods`` and restores ``keep_mods``. Deterministic tasks
  (``drop_frac`` 0) equal the JAX package's bit for bit; random ones
  draw other numbers from the same distribution.
- ``time_avg_dev`` reduces (T, B) per-step values to per-sequence time
  averages.
"""

import numpy as np
import torch

from .. import resolve_device
from .loader import BatchLoader


class _EvalBatch:
    """One collated eval batch: device targets, mask and padded lengths,
    and the host's lengths, order and ids of the real sequences."""

    __slots__ = ("targets", "mask", "lengths_dev", "lengths", "order",
                 "ids")

    def __init__(self, targets, mask, lengths_dev, lengths, order, ids):
        self.targets = targets
        self.mask = mask
        self.lengths_dev = lengths_dev
        self.lengths = lengths
        self.order = order
        self.ids = ids


class DeviceEvalData:
    """An eval set on ``device`` with the exact ``BatchLoader`` batching."""

    def __init__(self, dataset, modalities, batch_size, len_bucket=0,
                 device="cuda"):
        dev = resolve_device(device)
        loader = BatchLoader(dataset, batch_size=batch_size,
                             len_bucket=len_bucket)
        self.batches = []
        for targets, mask, lengths, order, ids in loader:
            b_dim = mask.shape[1]
            # Ghost columns get length 0: masked out everywhere.
            lengths_pad = np.zeros((b_dim,), np.float32)
            lengths_pad[:len(lengths)] = lengths
            self.batches.append(_EvalBatch(
                {m: torch.as_tensor(targets[m], device=dev)
                 for m in targets if m in modalities},
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(lengths_pad, device=dev),
                list(lengths), list(order), list(ids)))


def time_avg_dev(val, mask, lengths):
    """(T, B) per-step values -> (B,) per-sequence time averages over the
    length mask; ghost columns (length 0) divide by 1."""
    val = torch.where(mask[..., 0].bool(), val, torch.zeros_like(val))
    return val.sum(dim=0) / torch.clamp(lengths, min=1.0)


def compose_task(targets, lengths, gen, drop_frac, start_frac, stop_frac,
                 drop_mods=(), keep_mods=(), modalities=None, cols=None):
    """An eval task's inputs from (T, B, ...) device targets (NaN =
    missing) and (B,) float lengths (0 for ghost columns). The random
    deletion takes, per (modality, sequence), the ``int(drop_frac * L)``
    valid steps with the smallest uniform scores drawn from ``gen``.
    ``cols`` (a slice of the B columns, a rank's under a mesh): the
    scores are drawn for the whole batch and the inputs of those columns
    alone are returned."""
    mods = list(modalities) if modalities is not None else list(targets)
    t_max, b_dim = targets[mods[0]].shape[:2]
    dev = lengths.device
    t_idx = torch.arange(t_max, device=dev)
    valid = t_idx[:, None] < lengths.to(torch.int32)[None, :]   # (T, B)

    n_del = (drop_frac * lengths).to(torch.int32)                # (B,)
    scores = torch.rand((len(mods), t_max, b_dim), generator=gen,
                        device=dev)
    scores = torch.where(valid[None], scores,
                         torch.full_like(scores, float("inf")))
    kth_idx = torch.clamp(n_del - 1, 0, t_max - 1).to(torch.int64)
    kth = torch.gather(torch.sort(scores, dim=1).values, 1,
                       kth_idx[None, None, :].expand(len(mods), 1, b_dim))
    rand_del = (scores <= kth) & (n_del > 0)[None, None, :]

    t_start = (start_frac * lengths).to(torch.int32)
    t_stop = (stop_frac * lengths).to(torch.int32)
    seg_del = ((t_idx[:, None] < t_start[None, :])
               | (t_idx[:, None] >= t_stop[None, :]))              # (T, B)

    if cols is not None:
        valid, rand_del, seg_del = valid[:, cols], rand_del[:, :, cols], \
            seg_del[:, cols]
    inputs = {}
    for mi, m in enumerate(mods):
        if m not in targets:
            continue
        x = targets[m] if cols is None else targets[m][:, cols]
        if m in keep_mods:
            inputs[m] = x
            continue
        if m in drop_mods:
            inputs[m] = torch.full_like(x, float("nan"))
            continue
        dele = (rand_del[mi] | seg_del) & valid
        dele = dele.reshape(tuple(dele.shape) + (1,) * (x.dim() - 2))
        inputs[m] = torch.where(dele, torch.full_like(x, float("nan")), x)
    return inputs
