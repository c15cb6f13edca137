"""The port's data modules (data/multiseq.py, data/weizmann.py) against
the JAX package's on a ``gen_synthetic`` fixture: loading, the dataset
algebra, collation and the deletion operators give equal arrays under the
same numpy seeds."""

import numpy as np
import pytest

from multimodal_dmm_tpu.data import multiseq as jm
from multimodal_dmm_tpu.data import weizmann as jw
from multimodal_dmm_tpu_torch.data import multiseq as tm
from multimodal_dmm_tpu_torch.data import weizmann as tw

PERSONS = ["daria", "eli", "shahar"]
ACTIONS = ["bend", "run", "wave1"]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """(JAX dataset, port dataset) over the same fixture files."""
    d = str(tmp_path_factory.mktemp("weizmann"))
    tw.gen_synthetic(d, persons_subset=PERSONS, actions_subset=ACTIONS,
                     t_range=(6, 13), img_size=8)
    return (jw.WeizmannDataset(d, item_as_dict=True),
            tw.WeizmannDataset(d, item_as_dict=True))


def assert_same(a, b):
    """Two datasets hold equal sequences, lengths and IDs."""
    assert a.modalities == b.modalities
    assert a.seq_ids == b.seq_ids
    assert a.seq_id_sets == b.seq_id_sets
    assert a.lengths == b.lengths
    for m in a.modalities:
        assert len(a.data[m]) == len(b.data[m])
        for x, y in zip(a.data[m], b.data[m]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_gen_synthetic_writes_the_jax_fixture(tmp_path):
    jw.gen_synthetic(str(tmp_path / "j"), persons_subset=PERSONS[:2],
                     actions_subset=ACTIONS[:2], img_size=8)
    tw.gen_synthetic(str(tmp_path / "t"), persons_subset=PERSONS[:2],
                     actions_subset=ACTIONS[:2], img_size=8)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 8
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "j" / n),
                                      np.load(tmp_path / "t" / n))


def test_load(sets):
    j, t = sets
    assert len(t) == len(PERSONS) * len(ACTIONS)
    assert t.modalities == ["video", "mask", "person", "action"]
    assert_same(j, t)
    for i in (0, len(t) - 1):
        a, b = j[i], t[i]
        assert a.keys() == b.keys() and a["id"] == b["id"]


@pytest.mark.parametrize("invert", [False, True])
def test_select(sets, invert):
    j, t = sets
    assert_same(j.select([["shahar"], None], invert=invert),
                t.select([["shahar"], None], invert=invert))
    assert_same(j.select([None, ["run", "bend"]], invert=invert),
                t.select([None, ["run", "bend"]], invert=invert))


@pytest.mark.parametrize("n,bylen", [(4, True), (3, False)])
def test_split(sets, n, bylen):
    j, t = sets
    assert_same(j.split(n, bylen), t.split(n, bylen))


@pytest.mark.parametrize("method", ["meanvar", "range"])
def test_normalize(sets, method):
    j, t = sets
    jt, tt = (s.select([["shahar"], None], invert=True) for s in sets)
    assert_same(j.normalize(["video"], method, ref_data=jt),
                t.normalize(["video"], method, ref_data=tt))
    assert_same(jt.normalize(["video", "mask"], method),
                tt.normalize(["video", "mask"], method))


@pytest.mark.parametrize("mode,frac,mods", [
    ("uniform", 0.5, None), ("burst", 0.3, None),
    ("all_none", 0.5, ["person"])])
def test_corrupt(sets, mode, frac, mods):
    j, t = sets
    np.random.seed(7)
    a = j.corrupt(frac, mode, mods)
    np.random.seed(7)
    b = t.corrupt(frac, mode, mods)
    assert_same(a, b)
    assert any(np.isnan(x).any() for x in b.data[(mods or ["video"])[0]])
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        t.corrupt(0.5, "nope")


def test_merge_and_statistics(sets):
    j, t = sets
    parts = [(s.select([["shahar"], None]), s.select([["daria"], None]))
             for s in sets]
    assert_same(jm.MultiseqDataset.merge(*parts[0]),
                tm.MultiseqDataset.merge(*parts[1]))
    for fj, ft in ((j.mean_and_std, t.mean_and_std),
                   (j.max_and_min, t.max_and_min)):
        for a, b in zip(fj(["video", "person"]), ft(["video", "person"])):
            for m in a:
                np.testing.assert_array_equal(a[m], b[m])


@pytest.mark.parametrize("ratio", [2, 3, 0.5, 1])
def test_resample_to_base(ratio):
    d = np.random.RandomState(1).rand(11, 3, 2)
    exp = jm.resample_to_base(d, ratio)
    got = tm.resample_to_base(d, ratio)
    assert got.shape == exp.shape
    # The JAX package may average with its C++ host helper: the same sum
    # in another order.
    np.testing.assert_allclose(got, exp, rtol=1e-15, atol=0)


def test_collate_and_decollate(sets):
    _, t = sets
    items = [t[i] for i in (4, 0, 7, 2)]
    exp = jm.seq_collate_dict(items)
    got = tm.seq_collate_dict(items)
    for m in exp[0]:
        assert got[0][m].dtype == np.float32
        np.testing.assert_array_equal(got[0][m], exp[0][m])
    for a, b in zip(got[1:], exp[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batch, mask, lengths, order, _ = got
    for a, b in zip(tm.seq_decoll_dict(batch, lengths, order).values(),
                    jm.seq_decoll_dict(batch, lengths, order).values()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(tm.seq_collate([tuple(s[m] for m in t.modalities)
                                    for s in items]),
                    jm.seq_collate([tuple(s[m] for m in t.modalities)
                                    for s in items])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tm.mask_to_extent(mask)[0],
                                  jm.mask_to_extent(mask)[0])
    np.testing.assert_array_equal(tm.mask_to_extent(mask)[1],
                                  jm.mask_to_extent(mask)[1])
    np.testing.assert_array_equal(tm.len_to_mask([3, 1], max_len=5),
                                  jm.len_to_mask([3, 1], max_len=5))


@pytest.mark.parametrize("op,args", [
    ("rand_delete", (0.5,)), ("burst_delete", (0.3,)),
    ("keep_segment", (0.25, 0.75)), ("del_segment", (0.2, 0.6))])
def test_deletion_operators(sets, op, args):
    _, t = sets
    batch, _, lengths, _, _ = tm.seq_collate_dict([t[i] for i in range(5)])
    # A ghost column past the real sequences is left alone.
    batch = {m: np.concatenate([v, np.full_like(v[:, :1], np.nan)], axis=1)
             for m, v in batch.items()}
    np.random.seed(3)
    exp = getattr(jm, op)(batch, *args, lengths=lengths,
                          modalities=["video", "person"])
    np.random.seed(3)
    got = getattr(tm, op)(batch, *args, lengths=lengths,
                          modalities=["video", "person"])
    for m in batch:
        np.testing.assert_array_equal(got[m], exp[m])
    assert np.isnan(got["video"]).sum() > np.isnan(batch["video"]).sum()
    np.testing.assert_array_equal(got["mask"], batch["mask"])
