"""Host-side batch loader (counterpart of
multimodal_dmm_tpu/training/loader.py).

Iterates any indexable dataset of dict items (per-modality (L, ...)
arrays plus ``length`` and ``id``) in collated, time-first numpy batches,
optionally shuffled with ``numpy.random``. With ``pad_batch`` the batch
axis is NaN-padded to ``batch_size`` with "ghost" columns of length 0
(all-NaN data, all-False length mask), so they add nothing to summed
losses or metrics; ``lengths``/``order``/``ids`` cover the real
sequences only. ``len_bucket`` rounds each batch's time axis up to a
multiple of itself.
"""

import numpy as np

from ..data import multiseq as mseq


class BatchLoader:
    """Yields (batch, mask, lengths, order, ids) per batch."""

    def __init__(self, dataset, batch_size, shuffle=False, pad_batch=True,
                 max_len=None, len_bucket=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_batch = pad_batch
        self.max_len = max_len
        self.len_bucket = int(len_bucket or 0)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.shuffle(idx)
        for start in range(0, n, self.batch_size):
            items = [self.dataset[int(i)] for i in
                     idx[start:start + self.batch_size]]
            max_len = self.max_len
            if max_len is None and self.len_bucket > 1:
                t_max = max(d["length"] for d in items)
                max_len = -(-t_max // self.len_bucket) * self.len_bucket
            batch, mask, lengths, order, ids = mseq.seq_collate_dict(
                items, max_len=max_len)
            n_real = len(lengths)
            if self.pad_batch and n_real < self.batch_size:
                pad = self.batch_size - n_real
                t_max = mask.shape[0]
                for m in batch:
                    shape = (t_max, pad) + batch[m].shape[2:]
                    batch[m] = np.concatenate(
                        [batch[m], np.full(shape, np.nan, batch[m].dtype)],
                        axis=1)
                mask = np.concatenate(
                    [mask, np.zeros((t_max, pad, 1), mask.dtype)], axis=1)
            yield batch, mask, lengths, order, ids
