"""The inputs that the program derives from the benchmark's data, worked
out again in plain PyTorch and NumPy: the training epoch's batches with
their burst deletion, and the evaluation's batch with its task's random
deletion. Each draws from a generator seeded as the program's is, in the
same calls, so that the same seed gives the same batches and the same
deletions.
"""

import numpy as np
import torch

NAN = float("nan")


def sorted_by_length(items):
    """The items longest first, ties in their given order."""
    return sorted(items, key=lambda it: it["length"], reverse=True)


def pad_columns(items, names, t_max, n_cols, device):
    """{m: (t_max, n_cols, ...)} float32 NaN-padded tensors of ``items`` in
    that column order (columns past the items are all NaN)."""
    out = {}
    for m in names:
        dims = tuple(np.asarray(items[0][m]).shape[1:])
        arr = np.full((t_max, n_cols) + dims, np.nan, np.float32)
        for i, it in enumerate(items):
            x = np.asarray(it[m], np.float32)
            arr[:len(x), i] = x
        out[m] = torch.from_numpy(arr).to(device)
    return out


class TrainBatches:
    """The batches of one training epoch: the shuffle of
    ``RandomState(seed).permutation`` cut into sorted batches, short
    batches filled with columns of sequence 0 whose mask is all False, and
    per (modality, column) one burst of ``int(burst_frac * L)`` steps set
    to NaN in the inputs from a start drawn uniformly from a float64
    ``torch.rand`` on a generator seeded with ``seed``."""

    def __init__(self, items, names, batch_size, burst_frac, device):
        self.items = sorted_by_length(items)
        self.names = list(names)
        self.batch_size = batch_size
        self.burst_frac = burst_frac
        self.device = torch.device(device)
        self.lengths = np.array([it["length"] for it in self.items])
        self.t_max = int(self.lengths.max())

    def epoch(self, seed, n_batches=None):
        seed = seed & 0x7FFFFFFF
        perm = np.random.RandomState(seed).permutation(len(self.items))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t_idx = torch.arange(self.t_max, device=self.device)
        for b, start in enumerate(range(0, len(self.items),
                                        self.batch_size)):
            if n_batches is not None and b >= n_batches:
                return
            sel = np.sort(perm[start:start + self.batch_size])
            n_real = len(sel)
            sel = np.concatenate([sel, np.zeros(self.batch_size - n_real,
                                                dtype=sel.dtype)])
            targets = pad_columns([self.items[i] for i in sel], self.names,
                                  self.t_max, self.batch_size, self.device)
            lengths = torch.as_tensor(self.lengths[sel], device=self.device)
            real = torch.arange(self.batch_size, device=self.device) < n_real
            mask = ((t_idx[:, None] < lengths[None, :])
                    & real[None, :])[..., None].to(torch.float32)
            high = torch.clamp(lengths, min=1).to(torch.float64)
            u = torch.rand((len(self.names), self.batch_size), generator=gen,
                           device=self.device, dtype=torch.float64)
            start_t = torch.minimum((u * high).to(torch.int64),
                                    high.to(torch.int64) - 1)
            width = (self.burst_frac * lengths.to(torch.float64)).to(
                torch.int64)
            stop_t = torch.minimum(start_t + width, lengths)
            inputs = {}
            for mi, m in enumerate(self.names):
                burst = ((t_idx[:, None] >= start_t[mi][None, :])
                         & (t_idx[:, None] < stop_t[mi][None, :]))
                x = targets[m]
                burst = burst.reshape(burst.shape + (1,) * (x.dim() - 2))
                inputs[m] = torch.where(burst, torch.full_like(x, NAN), x)
            n_data = float(self.lengths[sel[:n_real]].sum())
            yield inputs, targets, mask, n_data


class EvalBatch:
    """The evaluation set as one batch of ``batch_size`` columns (the real
    sequences longest first, then all-NaN columns of length 0)."""

    def __init__(self, items, names, batch_size, device):
        if len(items) > batch_size:
            raise ValueError("the evaluation set (%d sequences) is larger "
                             "than one batch (%d)" % (len(items), batch_size))
        items = sorted_by_length(items)
        self.n_real = len(items)
        lengths = [it["length"] for it in items]
        self.t_max = max(lengths)
        self.targets = pad_columns(items, names, self.t_max, batch_size,
                                   device)
        pad = np.zeros((batch_size,), np.float32)
        pad[:len(lengths)] = lengths
        self.lengths = torch.as_tensor(pad, device=device)
        self.n_frames = int(sum(lengths))
        t_idx = torch.arange(self.t_max, device=device)
        self.mask = (t_idx[:, None] < self.lengths[None, :]).to(
            torch.float32)[..., None]
        self.names = list(names)

    def task(self, gen, drop_frac, start_frac, stop_frac):
        """The task's inputs: per (modality, column) the ``int(drop_frac *
        L)`` valid steps with the smallest uniform scores deleted, then
        every step outside [int(start_frac L), int(stop_frac L))."""
        t_max, b_dim = self.mask.shape[:2]
        dev = self.lengths.device
        t_idx = torch.arange(t_max, device=dev)
        valid = t_idx[:, None] < self.lengths.to(torch.int32)[None, :]
        n_del = (drop_frac * self.lengths).to(torch.int32)
        scores = torch.rand((len(self.names), t_max, b_dim), generator=gen,
                            device=dev)
        scores = torch.where(valid[None], scores,
                             torch.full_like(scores, float("inf")))
        kth_idx = torch.clamp(n_del - 1, 0, t_max - 1).to(torch.int64)
        kth = torch.gather(torch.sort(scores, dim=1).values, 1,
                           kth_idx[None, None, :].expand(len(self.names), 1,
                                                         b_dim))
        rand_del = (scores <= kth) & (n_del > 0)[None, None, :]
        t_start = (start_frac * self.lengths).to(torch.int32)
        t_stop = (stop_frac * self.lengths).to(torch.int32)
        seg_del = ((t_idx[:, None] < t_start[None, :])
                   | (t_idx[:, None] >= t_stop[None, :]))
        inputs = {}
        for mi, m in enumerate(self.names):
            x = self.targets[m]
            dele = (rand_del[mi] | seg_del) & valid
            dele = dele.reshape(tuple(dele.shape) + (1,) * (x.dim() - 2))
            inputs[m] = torch.where(dele, torch.full_like(x, NAN), x)
        return inputs
