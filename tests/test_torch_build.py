"""The port's kernel build names each library by a hash of what it is
built from, so that an edited source or header is rebuilt. No nvcc is
needed: only the names are compared."""

import shutil

from multimodal_dmm_tpu_torch.ops.cuda import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    return csrc


def test_editing_a_header_changes_every_target(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no header"
    before = {name: _build._target(name)[1] for name in _build.SOURCES}
    assert before == {name: _build._target(name)[1]
                      for name in _build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.SOURCES}
    for name in _build.SOURCES:
        assert after[name] != before[name], name


def test_editing_a_source_changes_its_target_only(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {name: _build._target(name)[1] for name in _build.SOURCES}
    src = csrc / _build.SOURCES["bfvi_scan"]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.SOURCES}
    assert after["bfvi_scan"] != before["bfvi_scan"]
    assert after["poe_cell"] == before["poe_cell"]
