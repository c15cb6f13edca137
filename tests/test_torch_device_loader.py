"""The port's device-resident training loader (training/device_loader.py)
against the JAX package's ``DeviceTrainData`` on the same split fixture:
the same batches in the same order with the same targets, masks and
lengths; each input is its target with one burst per (modality, sequence);
ghost columns are masked out."""

import numpy as np
import pytest
import torch

from multimodal_dmm_tpu.training.device_loader import (
    DeviceTrainData as JDeviceTrainData)
from multimodal_dmm_tpu_torch.data import weizmann as tw
from multimodal_dmm_tpu_torch.training.device_loader import DeviceTrainData

MODS = ["video", "mask", "person", "action"]
BATCH, BURST = 5, 0.3


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("weizmann"))
    tw.gen_synthetic(d, persons_subset=["daria", "eli"],
                     actions_subset=["bend", "run", "walk"],
                     t_range=(8, 20), img_size=8)
    # 6 sequences split into chunks of 5 steps: the last batch of 5 is
    # short and carries ghost columns.
    return tw.WeizmannDataset(d, item_as_dict=True).split(5, True)


def _loaders(train_set, native):
    perms = {"video": (1, 2, 0), "mask": (1, 2, 0)} if native else None
    return (JDeviceTrainData(train_set, MODS, BATCH, BURST,
                             native_perms=perms),
            DeviceTrainData(train_set, MODS, BATCH, BURST,
                            native_perms=perms, device="cpu"))


@pytest.mark.parametrize("native", [False, True])
def test_batches_equal_jax(train_set, native):
    """Batch order, targets, masks and lengths equal the JAX loader's in
    two epochs; inputs equal targets outside the bursts."""
    jl, tl = _loaders(train_set, native)
    assert len(tl) == len(jl) and tl.t_max == jl.t_max
    for epoch in (1, 2):
        seed = 5 * 100003 + epoch
        batches = list(zip(jl.epoch(seed), tl.epoch(seed)))
        assert len(batches) == len(tl)
        for (ji, jt, jmask, jlen), (ti, tt, tmask, tlen) in batches:
            assert tlen == jlen
            np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
            for m in MODS:
                np.testing.assert_array_equal(tt[m].numpy(),
                                              np.asarray(jt[m]))
                keep = ~torch.isnan(ti[m])
                assert torch.equal(ti[m][keep], tt[m][keep])
    if native:
        assert tuple(tt["video"].shape[2:]) == (8, 8, 3)


def _bursts(inputs, targets, m):
    """(B, T) bool: steps of column b deleted in modality m's inputs."""
    x, y = inputs[m], targets[m]
    dims = tuple(range(2, x.dim()))
    deleted = (torch.isnan(x) & ~torch.isnan(y)).any(dim=dims)
    return deleted.T.numpy()


def test_one_burst_per_modality_and_sequence(train_set):
    """Each real column's deleted steps in each modality form one run of
    min(int(burst_frac * L), L - start) steps inside [0, L)."""
    _, tl = _loaders(train_set, False)
    starts = []
    for inputs, targets, mask, lengths in tl.epoch(11):
        for m in MODS:
            deleted = _bursts(inputs, targets, m)
            for b, length in enumerate(lengths):
                steps = np.nonzero(deleted[b])[0]
                width = int(BURST * length)
                if width == 0:
                    assert len(steps) == 0
                    continue
                assert len(steps) >= 1
                start = steps[0]
                assert steps[-1] < length
                np.testing.assert_array_equal(
                    steps, np.arange(start, min(start + width, length)))
                starts.append(start)
    assert len(set(starts)) > 1  # not one start for everything


def test_bursts_follow_the_seed(train_set):
    _, tl = _loaders(train_set, False)
    a, b, c = (list(tl.epoch(s)) for s in (3, 3, 4))
    for (ia, _, _, _), (ib, _, _, _) in zip(a, b):
        for m in MODS:
            assert torch.equal(torch.isnan(ia[m]), torch.isnan(ib[m]))
    assert any(not torch.equal(torch.isnan(x[0]["video"]),
                               torch.isnan(y[0]["video"]))
               for x, y in zip(a, c))


def test_ghost_columns_are_masked(train_set):
    _, tl = _loaders(train_set, False)
    n_ghost = -len(train_set) % BATCH
    assert n_ghost > 0
    *_, (inputs, targets, mask, lengths) = tl.epoch(1)
    assert len(lengths) == BATCH - n_ghost
    assert not mask[:, len(lengths):].any()
    for b, length in enumerate(lengths):
        assert mask[:length, b].all() and not mask[length:, b].any()


def test_native_perm_must_match_dims(train_set):
    with pytest.raises(ValueError, match="native perm"):
        DeviceTrainData(train_set, MODS, BATCH, BURST,
                        native_perms={"person": (1, 0)}, device="cpu")
