"""The training set resident on the device, with each epoch's shuffle,
batch gathering and burst deletion done there (counterpart of
multimodal_dmm_tpu/training/device_loader.py).

``DeviceTrainData`` NaN-pads every (post-split) training sequence to the
longest and keeps per-modality (T, N, ...) float32 tensors on the device,
sequences sorted longest first so that every batch is sorted by length as
the collate contract wants. Modalities in ``native_perms`` are stored with
their trailing dims permuted into the codec-native layout (video
(C, H, W) -> (H, W, C)), once, so the training step needs no per-step
transpose (the step then gets ``native_mods``).

``epoch(seed)`` yields (inputs, targets, mask, lengths) per batch:

- the batch order is ``np.random.RandomState(seed).permutation``, cut
  into batches whose indices are sorted, as in the JAX package, so both
  give the same batches;
- a batch short of ``batch_size`` is padded with ghost columns that
  gather sequence 0 and get an all-False mask, as in the JAX package;
- the inputs are the targets with one burst per (modality, sequence) set
  to NaN: ``int(burst_frac * L)`` steps from a start uniform in [0, L),
  clipped to the sequence. The starts come from a ``torch.Generator`` on
  the device seeded with ``seed``: the same distribution as the JAX
  package's ``jax.random`` draw, other numbers.
"""

import numpy as np
import torch

from .. import resolve_device
from .diagnostics import span


class DeviceTrainData:
    """A training set on ``device`` and its per-epoch batches."""

    def __init__(self, dataset, modalities, batch_size, burst_frac,
                 native_perms=None, device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.burst_frac = burst_frac
        self.native_perms = dict(native_perms or {})
        self.modalities = list(modalities)
        n = len(dataset)
        items = [dataset[i] for i in range(n)]
        order = sorted(range(n), key=lambda i: items[i]["length"],
                       reverse=True)
        items = [items[i] for i in order]
        self.lengths = np.array([it["length"] for it in items],
                                dtype=np.int64)
        self.n = n
        self.t_max = t_max = int(self.lengths.max())
        self.data = {}
        for m in self.modalities:
            dims = tuple(items[0][m].shape[1:])
            perm = self.native_perms.get(m)
            if perm is not None:
                if len(perm) != len(dims):
                    raise ValueError("native perm %r does not match %s dims "
                                     "%r" % (perm, m, dims))
                dims = tuple(dims[p] for p in perm)
            arr = np.full((t_max, n) + dims, np.nan, np.float32)
            for i, it in enumerate(items):
                x = it[m]
                if perm is not None:
                    x = np.transpose(x, (0,) + tuple(1 + p for p in perm))
                arr[:len(x), i] = x
            self.data[m] = torch.from_numpy(arr).to(self.device)
        self.lengths_dev = torch.as_tensor(self.lengths, device=self.device)

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def gather_and_burst(self, idx, real, gen):
        """(inputs, targets, mask) of the sequences ``idx`` (B,) on the
        device; ``real`` (B,) bool marks the columns that are not ghosts."""
        lengths = self.lengths_dev[idx]
        t_idx = torch.arange(self.t_max, device=self.device)
        mask = ((t_idx[:, None] < lengths[None, :])
                & real[None, :])[..., None]
        high = torch.clamp(lengths, min=1).to(torch.float64)
        u = torch.rand((len(self.modalities), len(idx)), generator=gen,
                       device=self.device, dtype=torch.float64)
        start = torch.minimum((u * high).to(torch.int64),
                              high.to(torch.int64) - 1)
        width = (self.burst_frac * lengths.to(torch.float64)).to(torch.int64)
        stop = torch.minimum(start + width, lengths)
        burst = ((t_idx[None, :, None] >= start[:, None, :])
                 & (t_idx[None, :, None] < stop[:, None, :]))  # (M, T, B)
        inputs, targets = {}, {}
        for mi, m in enumerate(self.modalities):
            x = self.data[m].index_select(1, idx)  # (T, B, ...)
            targets[m] = x
            bm = burst[mi].reshape(burst[mi].shape + (1,) * (x.dim() - 2))
            inputs[m] = torch.where(bm, torch.full_like(x, float("nan")), x)
        return inputs, targets, mask.to(torch.float32)

    def epoch(self, seed):
        """Yield (inputs, targets, mask, lengths) device batches; lengths
        lists the real sequences' lengths."""
        seed = seed & 0x7FFFFFFF
        perm = np.random.RandomState(seed).permutation(self.n)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for start in range(0, self.n, self.batch_size):
            with span("mdmm/train.batch"):
                sel = np.sort(perm[start:start + self.batch_size])
                n_real = len(sel)
                if n_real < self.batch_size:
                    sel = np.concatenate([sel, np.zeros(
                        self.batch_size - n_real, dtype=sel.dtype)])
                # Copies from pageable host memory: each waits for the
                # device's stream.
                with span("mdmm/sync.batch_copy"):
                    real = torch.as_tensor(np.arange(self.batch_size)
                                           < n_real, device=self.device)
                with span("mdmm/sync.batch_copy"):
                    idx = torch.as_tensor(sel, device=self.device)
                inputs, targets, mask = self.gather_and_burst(idx, real, gen)
                batch = (inputs, targets, mask,
                         [int(l) for l in self.lengths[sel[:n_real]]])
            yield batch
