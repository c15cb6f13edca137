"""Collation, decollation and deletion operators for batches of
unequal-length multimodal sequences (the port's own copy of the parts of
multimodal_dmm_tpu/data/multiseq.py that evaluation uses).

Batches are time-first: (T, B, ...) float32, NaN where a sequence has no
data (padding or deletion), with a (T, B, 1) bool length mask. Items are
dicts of per-modality (L, ...) arrays plus ``length`` and ``id``. The
deletion operators draw from ``numpy.random``, as the JAX package's do.
"""

import numpy as np


def len_to_mask(lengths, time_first=True, max_len=None):
    """Sequence lengths -> (T, B, 1) bool mask."""
    if max_len is None:
        max_len = max(lengths)
    mask = np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]
    if time_first:
        mask = mask.T
    return mask[..., None]


def pad_and_merge(sequences, max_len=None):
    """NaN-pad unequal-length sequences into a (T, B, ...) float32
    batch."""
    dims = sequences[0].shape[1:]
    lengths = [len(seq) for seq in sequences]
    if max_len is None:
        max_len = max(lengths)
    padded = np.full((max_len, len(sequences)) + tuple(dims), np.nan,
                     dtype=np.float32)
    for i, seq in enumerate(sequences):
        padded[:lengths[i], i] = seq[:lengths[i]]
    return padded


def seq_collate_dict(data, time_first=True, max_len=None):
    """Collate dict items, longest first -> (batch_dict, mask, lengths,
    order, ids); ``order[j]`` is the batch column of item j."""
    batch = {}
    modalities = [k for k in data[0] if k not in ("length", "id")]
    order = sorted(range(len(data)), key=lambda i: data[i]["length"],
                   reverse=True)
    data = [data[i] for i in order]
    lengths = [d["length"] for d in data]
    seq_ids = [d["id"] for d in data]
    for m in modalities:
        m_padded = pad_and_merge([d[m] for d in data],
                                 max_len or max(lengths))
        batch[m] = m_padded if time_first else np.swapaxes(m_padded, 0, 1)
    mask = len_to_mask(lengths, time_first, max_len)
    return batch, mask, lengths, order, seq_ids


def seq_decoll(batch, lengths, order, time_first=True):
    """De-pad a batch (or a tuple of batches, stacked on axis 1) and
    restore the input order."""
    if isinstance(batch, tuple):
        return [np.stack([np.asarray(b)[:lengths[idx], idx] for b in batch],
                         axis=1) for idx in order]
    batch = np.asarray(batch)
    if time_first:
        return [batch[:lengths[idx], idx] for idx in order]
    return [batch[idx, :lengths[idx]] for idx in order]


def seq_decoll_dict(batch_dict, lengths, order, time_first=True):
    return {k: seq_decoll(np.asarray(b) if not isinstance(b, tuple)
                          else tuple(np.asarray(x) for x in b),
                          lengths, order, time_first)
            for k, b in batch_dict.items()}


def func_delete(batch_in, del_func, lengths=None, modalities=None):
    """Copy of the batch with ``del_func(length)`` time indices of each
    sequence set to NaN in ``modalities`` (default all). Ghost columns
    past ``len(lengths)`` are left as they are (all NaN already)."""
    if modalities is None:
        modalities = list(batch_in.keys())
    batch_out = {}
    for m in batch_in.keys():
        batch_out[m] = np.array(batch_in[m], copy=True)
        if m not in modalities:
            continue
        t_max, b_dim = batch_in[m].shape[:2]
        if lengths is None:
            lengths = [t_max] * b_dim
        for b in range(min(b_dim, len(lengths))):
            batch_out[m][del_func(lengths[b]), b] = float("nan")
    return batch_out


def rand_delete(batch_in, del_frac, lengths=None, modalities=None):
    """Delete ``int(del_frac * L)`` distinct random steps per sequence."""
    def del_func(length):
        return np.random.choice(length, int(del_frac * length), False)
    return func_delete(batch_in, del_func, lengths, modalities)


def keep_segment(batch_in, f_start, f_stop, lengths=None, modalities=None):
    """Delete everything outside the [f_start, f_stop) time fraction."""
    def del_func(length):
        t_start, t_stop = int(f_start * length), int(f_stop * length)
        return list(range(0, t_start)) + list(range(t_stop, length))
    return func_delete(batch_in, del_func, lengths, modalities)
