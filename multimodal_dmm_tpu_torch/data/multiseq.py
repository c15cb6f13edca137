"""Multimodal sequence data on the host, in numpy (the port's own copy of
multimodal_dmm_tpu/data/multiseq.py).

- ``MultiseqDataset``: per-modality files matched by regex and loaded
  (``.npy``; ``.csv``/``.tsv`` read with the ``csv`` module into a
  ``CsvTable`` that the preprocessors select and drop columns of),
  resampled to a base rate, with sequence-ID fields as label modalities,
  and its algebra: ``normalize_``, ``split_``, ``corrupt_``, ``select``,
  ``merge``.
- Collation: time-first (T, B, ...) float32 batches, NaN where a sequence
  has no data (padding or deletion), with a (T, B, 1) bool length mask;
  decollation restores the input order.
- The deletion operators (random, burst, kept and deleted segments).

Corruption and deletion draw from ``numpy.random`` in the JAX package's
order, so one numpy seed gives both packages the same data. Padding and
downsampling are plain numpy here (the JAX package may use its C++ host
helpers for them; they compute the same values).
"""

import copy
import csv
import itertools
import os
import re

import numpy as np


class MultiseqDataset:
    """Synchronous multimodal time series, one list of (L, ...) arrays per
    modality."""

    def __init__(self, modalities, dirs, regex, preprocess, rates,
                 base_rate=None, truncate=False, ids_as_mods=(),
                 item_as_dict=False):
        self.modalities = list(modalities)
        n_mods = len(self.modalities)
        self.rates = list(rates) if isinstance(rates, list) \
            else [rates] * n_mods
        self.base_rate = base_rate if base_rate is not None \
            else min(self.rates)
        self.item_as_dict = item_as_dict

        def per_mod(x):
            return dict(zip(self.modalities,
                            x if isinstance(x, list) else [x] * n_mods))
        dirs, regex = per_mod(dirs), per_mod(regex)
        preprocess = per_mod(preprocess if preprocess is not None
                             else (lambda x: x))

        # File names and the sequence IDs that the regex captures.
        paths, seq_ids = {}, {}
        for m in self.modalities:
            paths[m], seq_ids[m] = [], []
            for fn in os.listdir(dirs[m]):
                match = re.match(regex[m], fn)
                if not match:
                    continue
                paths[m].append(os.path.join(dirs[m], fn))
                seq_ids[m].append(match.groups())
            paths[m] = [p for _, p in sorted(zip(seq_ids[m], paths[m]))]
            seq_ids[m].sort()

        self.seq_ids = seq_ids[self.modalities[0]]
        for m in self.modalities:
            if len(paths[m]) != len(self.seq_ids):
                raise Exception("Number of files ({}) do not match."
                                .format(len(paths[m])))
            if seq_ids[m] != self.seq_ids:
                raise Exception("Sequence IDs do not match.")
        self.seq_id_sets = [sorted(set(s)) for s in zip(*self.seq_ids)]
        self.ratios = {m: r / self.base_rate
                       for m, r in zip(self.modalities, self.rates)}

        self.data = {m: [] for m in self.modalities}
        self.orig = {m: [] for m in self.modalities}
        self.lengths = []
        for i in range(len(self.seq_ids)):
            seq_len = float("inf")
            for m in self.modalities:
                d = _load(paths[m][i], preprocess[m]).astype(float)
                self.orig[m].append(d)
                d = resample_to_base(d, self.ratios[m])
                self.data[m].append(d)
                seq_len = min(seq_len, len(d))
            if truncate:
                for m in self.modalities:
                    self.data[m][-1] = self.data[m][-1][:seq_len]
            self.lengths.append(seq_len)

        # Sequence-ID fields as label modalities: the field's index in its
        # sorted set of values, at every step.
        self.ids_as_mods = list(ids_as_mods)
        for m in self.ids_as_mods:
            if m is None:
                continue
            self.modalities.append(m)
            self.rates.append(self.base_rate)
            self.ratios[m] = 1.0
            self.data[m] = []
            self.orig[m] = []
        for seq_id, seq_len in zip(self.seq_ids, self.lengths):
            for k, m in enumerate(self.ids_as_mods):
                if m is None:
                    continue
                d = np.array([[self.seq_id_sets[k].index(seq_id[k])]]
                             * seq_len)
                self.orig[m].append(d)
                self.data[m].append(d.astype(float))

    def __len__(self):
        return len(self.seq_ids)

    def __getitem__(self, i):
        if self.item_as_dict:
            d = {m: self.data[m][i] for m in self.modalities}
            d["length"] = self.lengths[i]
            d["id"] = self.seq_ids[i]
            return d
        return tuple(self.data[m][i] for m in self.modalities)

    # -- statistics -----------------------------------------------------------

    def mean_and_std(self, modalities=None):
        modalities = self.modalities if modalities is None else modalities
        cat = {m: np.concatenate(self.data[m], 0) for m in modalities}
        return ({m: np.nanmean(cat[m], axis=0) for m in modalities},
                {m: np.nanstd(cat[m], axis=0) for m in modalities})

    def max_and_min(self, modalities=None):
        modalities = self.modalities if modalities is None else modalities
        return ({m: np.nanmax(np.stack([a.max(0) for a in self.data[m]]), 0)
                 for m in modalities},
                {m: np.nanmin(np.stack([a.min(0) for a in self.data[m]]), 0)
                 for m in modalities})

    # -- algebra --------------------------------------------------------------

    def normalize_(self, modalities=None, method="meanvar", ref_data=None):
        """Normalise in place by ``ref_data``'s (default: this set's) mean
        and std, or (``method="range"``) to [-1, 1] by its range."""
        modalities = self.modalities if modalities is None else modalities
        ref_data = self if ref_data is None else ref_data
        if method == "range":
            m_max, m_min = ref_data.max_and_min(modalities)
            m_rng = {m: (m_max[m] - m_min[m]) for m in modalities}
            m_rng = {m: m_rng[m] * (m_rng[m] > 0) + 1e-10 * (m_rng[m] <= 0)
                     for m in modalities}
            for m in modalities:
                self.data[m] = [(a - m_min[m]) / m_rng[m] * 2 - 1
                                for a in self.data[m]]
        else:
            m_mean, m_std = ref_data.mean_and_std(modalities)
            for m in modalities:
                self.data[m] = [(a - m_mean[m]) / (m_std[m] + 1e-10)
                                for a in self.data[m]]

    def normalize(self, modalities=None, method="meanvar", ref_data=None):
        dataset = copy.deepcopy(self)
        dataset.normalize_(modalities, method, ref_data)
        return dataset

    def split_(self, n, n_is_len=True):
        """Split each sequence in place: into chunks of ``n`` steps (the
        last one shorter), or (``n_is_len=False``) into ``n`` chunks."""
        if n_is_len:
            split = [list(range(n, l, n)) for l in self.lengths]
        else:
            split = [n for _ in self.lengths]
        for m in self.modalities:
            self.data[m] = list(itertools.chain.from_iterable(
                [np.array_split(a, s, 0)
                 for a, s in zip(self.data[m], split)]))
        if n_is_len:
            self.seq_ids = list(itertools.chain.from_iterable(
                [[i] * (len(s) + 1) for i, s in zip(self.seq_ids, split)]))
        else:
            self.seq_ids = list(itertools.chain.from_iterable(
                [[i] * n for i in self.seq_ids]))
        self.lengths = [len(d) for d in self.data[self.modalities[0]]]

    def split(self, n, n_is_len=True):
        dataset = copy.deepcopy(self)
        dataset.split_(n, n_is_len)
        return dataset

    def corrupt_(self, del_frac, mode="uniform", modalities=None):
        """Delete data in place (NaN), per (modality, sequence):
        ``uniform`` deletes int(del_frac * L) random steps, ``burst`` one
        window of that many steps from a random start, ``all_none`` the
        whole sequence with probability ``del_frac``."""
        modalities = self.modalities if modalities is None else modalities
        if mode == "uniform":
            def del_func(length):
                return np.random.choice(length, int(del_frac * length),
                                        False)
        elif mode == "burst":
            def del_func(length):
                t_start = np.random.randint(length)
                t_stop = min(t_start + int(del_frac * length), length)
                return list(range(t_start, t_stop))
        elif mode == "all_none":
            def del_func(length):
                return ([] if (np.random.random() > del_frac)
                        else list(range(length)))
        else:
            raise ValueError("unknown corrupt mode: " + mode)
        for m in modalities:
            for i in range(len(self.data[m])):
                del_idx = del_func(len(self.data[m][i]))
                self.data[m][i] = np.array(self.data[m][i], copy=True)
                self.data[m][i][del_idx] = float("nan")

    def corrupt(self, del_frac, mode="uniform", modalities=None):
        dataset = copy.deepcopy(self)
        dataset.corrupt_(del_frac, mode, modalities)
        return dataset

    def select(self, seq_ids, invert=False):
        """The sequences whose ID field k is in ``seq_ids[k]`` for every k
        (None: any value); ``invert`` selects the others. Only the
        selected sequences are copied."""
        sel = copy.copy(self)
        for name, value in vars(self).items():
            if name not in ("data", "orig"):
                setattr(sel, name, copy.deepcopy(value))
        seq_ids = list(seq_ids)
        idx = list(range(len(self)))
        for k in range(len(seq_ids)):
            if seq_ids[k] is None:
                seq_ids[k] = self.seq_id_sets[k]
            idx = [i for i, seq_id in enumerate(self.seq_ids)
                   if seq_id[k] in seq_ids[k] and i in idx]
        if invert:
            idx = [i for i in range(len(self)) if i not in idx]
        sel.seq_ids = [sel.seq_ids[i] for i in idx]
        sel.seq_id_sets = [sorted(set(s)) for s in zip(*sel.seq_ids)]
        sel.lengths = [sel.lengths[i] for i in idx]
        sel.data = {m: [copy.deepcopy(self.data[m][i]) for i in idx]
                    for m in self.modalities}
        sel.orig = {m: [copy.deepcopy(self.orig[m][i]) for i in idx
                        if i < len(self.orig[m])]
                    for m in self.modalities}
        return sel

    @classmethod
    def merge(cls, set1, set2):
        """``set1``'s sequences followed by ``set2``'s, at the base rate."""
        if set1.modalities != set2.modalities:
            raise Exception("Modalities need to match.")
        if set1.base_rate != set2.base_rate:
            raise Exception("Base rates need to match.")
        merged = copy.deepcopy(set1)
        merged.orig.clear()
        merged.seq_ids = merged.seq_ids + set2.seq_ids
        merged.seq_id_sets = [
            sorted(set(set1.seq_id_sets[k]) | set(set2.seq_id_sets[k]))
            for k in range(len(set1.seq_id_sets))]
        merged.lengths = merged.lengths + set2.lengths
        merged.rates = [merged.base_rate] * len(merged.modalities)
        merged.ratios = {m: 1.0 for m in merged.modalities}
        for m in merged.modalities:
            merged.data[m] = merged.data[m] + copy.deepcopy(set2.data[m])
        return merged


class CsvTable:
    """A numeric table read from a delimited text file with a header row:
    ``columns`` (names) and ``values`` ((rows, columns) float64, each
    field parsed by ``float``, which reads back exactly the shortest
    round-trip repr that the corpus writers emit). ``np.array(table)``
    gives ``values``."""

    def __init__(self, columns, values):
        self.columns = list(columns)
        self.values = values

    @classmethod
    def read(cls, path, sep=","):
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=sep))
        values = np.array([[float(v) for v in row] for row in rows[1:]],
                          dtype=np.float64).reshape(-1, len(rows[0]))
        return cls(rows[0], values)

    def select(self, names):
        """The columns ``names``, in that order."""
        return CsvTable(names, self.values[:, [self.columns.index(n)
                                               for n in names]])

    def drop(self, names):
        """Every column but ``names``."""
        return self.select([c for c in self.columns if c not in names])

    def __array__(self, dtype=None, copy=None):
        return self.values if dtype is None else self.values.astype(dtype)


def _load(path, preprocess):
    if re.match(r"^.*\.npy", path):
        return np.load(path)
    if re.match(r"^.*\.(csv|txt|tsv)", path):
        sep = "\t" if path.endswith(".tsv") else ","
        return np.array(preprocess(CsvTable.read(path, sep=sep)))
    raise Exception("Unsupported file type: " + path)


def resample_to_base(d, ratio):
    """Resample a sequence to the base rate: average blocks of ``ratio``
    steps to downsample (the remainder averaged into one step), repeat
    each step 1 / ``ratio`` times to upsample."""
    if ratio > 1:
        ratio = int(ratio)
        end = ratio * (len(d) // ratio)
        avg = np.mean(d[:end].reshape(-1, ratio, *d.shape[1:]), 1)
        if end < len(d):
            return np.concatenate([avg, d[end:].mean(axis=0)[np.newaxis]])
        return avg
    return np.repeat(d, int(1.0 / ratio), axis=0)


# ---------------------------------------------------------------------------
# Masks, collation, decollation
# ---------------------------------------------------------------------------

def len_to_mask(lengths, time_first=True, max_len=None):
    """Sequence lengths -> (T, B, 1) bool mask."""
    if max_len is None:
        max_len = max(lengths)
    mask = np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]
    if time_first:
        mask = mask.T
    return mask[..., None]


def mask_to_extent(mask, time_first=True):
    """First and last observed time index per sequence."""
    mask = np.asarray(mask)
    if not time_first:
        mask = np.swapaxes(mask, 0, 1)
    t_max, b_dim = mask.shape[:2]
    idx = np.arange(t_max)[:, None] * np.ones((1, b_dim), dtype=int)
    idx = mask.reshape(t_max, b_dim).astype(int) * idx
    t_stop = idx.max(axis=0)
    idx[idx == 0] = t_max
    return idx.min(axis=0), t_stop


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


def seq_collate(data, time_first=True, max_len=None):
    """Collate tuple items, longest first -> (*batches, mask, lengths);
    a sequence's length is its longest modality's."""
    lengths = np.zeros(len(data), dtype=int)
    data = sorted(data, key=lambda x: len(x[0]), reverse=True)
    cols = list(zip(*data))
    for modality in cols:
        lengths = np.maximum(lengths, [len(seq) for seq in modality])
    lengths = list(lengths)
    padded = []
    for modality in cols:
        m_padded = pad_and_merge(modality, max_len or max(lengths))
        padded.append(m_padded if time_first
                      else np.swapaxes(m_padded, 0, 1))
    return tuple(padded + [len_to_mask(lengths, time_first, max_len),
                           lengths])


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


# ---------------------------------------------------------------------------
# Deletion operators on batches
# ---------------------------------------------------------------------------

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


def burst_delete(batch_in, burst_frac, lengths=None, modalities=None):
    """Delete one window of ``int(burst_frac * L)`` steps per sequence,
    from a random start, clipped to the sequence."""
    def del_func(length):
        t_start = np.random.randint(length)
        t_stop = min(t_start + int(burst_frac * length), length)
        return list(range(t_start, t_stop))
    return func_delete(batch_in, del_func, lengths, modalities)


def keep_segment(batch_in, f_start, f_stop, lengths=None, modalities=None):
    """Delete everything outside the [f_start, f_stop) time fraction."""
    def del_func(length):
        t_start, t_stop = int(f_start * length), int(f_stop * length)
        return list(range(0, t_start)) + list(range(t_stop, length))
    return func_delete(batch_in, del_func, lengths, modalities)


def del_segment(batch_in, f_start, f_stop, lengths=None, modalities=None):
    """Delete the [f_start, f_stop) time fraction."""
    def del_func(length):
        t_start, t_stop = int(f_start * length), int(f_stop * length)
        return list(range(t_start, t_stop))
    return func_delete(batch_in, del_func, lengths, modalities)
