"""Synthetic corpora made from the seed, in bulk on the device.

Each configuration's ``data`` section names a kind and its sizes. The
sequence lengths come from its ``length_table`` (each sequence's id, its
group values joined by ``_``, to its length) where it has one; otherwise
each split's lengths are a fixed multiset spread evenly over the stated
``lengths`` range, dealt to the sequences in an order drawn from the seed.
Either way every seed gives the same amount of work. The content (a square moving
along a path set by the sequence's labels, its colour and the noise drawn
from the seed; for audio, harmonic bands that drift over time) is drawn
for all frames of a split at once and copied to the host once. Items are
what the program's loaders take: ``{modality: (L, ...) float32 array,
"length": L, "id": (...)}``; the training split is cut into chunks of
``split`` steps as the program's ``--split N --bylen`` cuts it.
"""

import numpy as np
import torch


def split_lengths(n, lo, hi):
    """``n`` lengths spread evenly over [lo, hi)."""
    return [lo + (i * (hi - lo)) // n for i in range(n)]


def _frames_index(lengths, device):
    """(sequence index, time index) of every frame of the sequences."""
    lens = torch.as_tensor(lengths, device=device)
    seq = torch.repeat_interleave(torch.arange(len(lengths), device=device),
                                  lens)
    starts = torch.cumsum(lens, 0) - lens
    t = torch.arange(int(lens.sum()), device=device) - starts[seq]
    return seq, t.to(torch.float32)


def _squares(gen, seq, t, path_a, path_b, size, device, moving_x):
    """(N, 3, size, size) frames in [0, 1]: a 12-pixel square of a colour
    drawn per sequence, its corner on paths of the two label phases, plus
    uniform noise of 0.05."""
    n_seq = int(path_a.shape[0])
    color = torch.rand((n_seq, 3), generator=gen, device=device) * 0.8 + 0.2
    span = size - 12
    if moving_x:
        cx = (span * (0.5 + 0.4 * torch.sin(0.2 * t + path_a[seq]))).long()
    else:
        cx = torch.full_like(t, 26).long()
    cy = (span * (0.5 + 0.4 * torch.cos(0.15 * t + path_b[seq]))).long()
    pix = torch.arange(size, device=device)
    in_x = (pix[None, :] >= cx[:, None]) & (pix[None, :] < cx[:, None] + 12)
    in_y = (pix[None, :] >= cy[:, None]) & (pix[None, :] < cy[:, None] + 12)
    square = (in_y[:, :, None] & in_x[:, None, :]).to(torch.float32)
    frames = square[:, None] * color[seq][:, :, None, None]
    noise = torch.rand(frames.shape, generator=gen, device=device) * 0.05
    return torch.clamp(frames + noise, 0.0, 1.0)


def _audio(gen, seq, t, pitch, dims, device):
    """(N, C, F) slices in [0, 1]: harmonic bands at multiples of a pitch
    per sequence whose strength drifts over time, plus noise of 0.05."""
    n_ch, n_freq = dims
    f = torch.arange(n_freq, device=device, dtype=torch.float32)
    ch = torch.arange(n_ch, device=device, dtype=torch.float32)
    period = pitch[seq][:, None, None]
    band = torch.exp(-((torch.remainder(f[None, None, :], period) - 2.0)
                       ** 2) / 4.0)
    level = 0.5 + 0.4 * torch.sin(0.3 * t[:, None, None] + 0.7 * ch[None, :,
                                                                     None])
    noise = torch.rand((len(t), n_ch, n_freq), generator=gen,
                       device=device) * 0.05
    return torch.clamp(band * level + noise, 0.0, 1.0)


def _chunks(item, names, n):
    """``item`` cut into chunks of ``n`` steps, the last one shorter."""
    cuts = list(range(n, item["length"], n))
    parts = {m: np.array_split(item[m], cuts, 0) for m in names}
    return [dict({m: parts[m][j] for m in names},
                 length=len(parts[names[0]][j]), id=item["id"])
            for j in range(len(cuts) + 1)]


def make_corpus(cfg, seed, device, splits=("train", "test")):
    """{split: items} of the configuration's corpus from ``seed`` (each
    split drawn apart, so one can be made without the other); the
    training items cut into ``train.split``-step chunks."""
    spec = cfg["data"]
    groups = spec["groups"]
    keys = list(groups)
    sizes = [len(groups[k]) for k in keys]
    ids = [tuple(ix) for ix in np.ndindex(*sizes)]
    test_key, test_vals = next(iter(spec["test"].items()))
    k_test = keys.index(test_key)
    test_ix = {groups[test_key].index(v) for v in test_vals}
    split_ids = {"train": [i for i in ids if i[k_test] not in test_ix],
                 "test": [i for i in ids if i[k_test] in test_ix]}
    names = [m["name"] for m in cfg["modalities"]]
    corpus = {}
    for k, split in enumerate(("train", "test")):
        if split not in splits:
            continue
        sids = split_ids[split]
        sub = (seed + k) & 0x7FFFFFFF
        rng = np.random.RandomState(sub)
        gen = torch.Generator(device=device).manual_seed(sub)
        lengths = split_lengths(len(sids), *spec.get("lengths", (1, 2)))
        lengths = [lengths[j] for j in rng.permutation(len(sids))]
        if "length_table" in spec:
            lengths = [spec["length_table"]["_".join(
                groups[k][i] for k, i in zip(keys, sid))] for sid in sids]
        seq, t = _frames_index(lengths, device)
        ix = torch.as_tensor(np.array(sids, np.float32), device=device)
        arrays = {}
        for mod in cfg["modalities"]:
            m = mod["name"]
            if mod["dist"] == "Categorical":
                arrays[m] = ix[seq, keys.index(m)][:, None]
            elif mod["codec"] == "image":
                path_a = ix[:, -1] if len(keys) > 1 else ix[:, 0]
                arrays[m] = _squares(gen, seq, t, path_a, ix[:, 0],
                                     mod["dims"][1], device,
                                     moving_x=spec["kind"] == "video_labels")
            else:
                pitch = 6.0 + 0.5 * ix[:, 0] + 0.25 * ix[:, -1]
                arrays[m] = _audio(gen, seq, t, pitch, mod["dims"], device)
        host = {m: a.cpu().numpy() for m, a in arrays.items()}
        del arrays
        bounds = np.cumsum([0] + lengths)
        items = [dict({m: host[m][bounds[j]:bounds[j + 1]] for m in names},
                      length=lengths[j],
                      id=tuple(groups[k][i] for k, i in zip(keys, sids[j])))
                 for j in range(len(sids))]
        if split == "train" and cfg["train"].get("bylen"):
            items = [c for it in items
                     for c in _chunks(it, names, cfg["train"]["split"])]
        corpus[split] = items
    return corpus
