"""The port's parser for the command line's dict flags
(training/flow_yaml.py) against ``yaml.safe_load``: every form that the
repo's apps, suites and scripts pass, nested flow collections, scalars of
each YAML 1.1 type, quoting and comments; block forms it does not read
raise."""

import math

import pytest
import yaml

from multimodal_dmm_tpu_torch.training.flow_yaml import YAMLError, safe_load

CASES = [
    "{bf16: true}", "{ragged_mode_scans: true}", "{merge_mode_scans: true}",
    "{fused: false}", "{skip: true}", "{uniform: 0.5}",
    "{ragged_mode_scans: true, flt_particles: 1}",
    "{semi: 0.5, modalities: [spiral-y]}", "{z_dim: 16, h_dim: 16}",
    "{scan_unroll: K}", "{flt_particles: 5}", "auto", "{}", "[]",
    "{video: 1, mask: 1, person: 10, action: 10}",
    "{a: [[1, 2], [3]], b: {c: {d: [x, y]}}}",
    "{i: [0, -3, +4, 1_000, 0x1f, 017, 0b101]}",
    "{f: [2.5, .5, -.5, 1.0e-4, 3., 1e-4, 1e5]}",
    "{x: .inf, y: -.Inf, z: .NaN}",
    "{n: [null, ~, Null], b: [yes, No, on, OFF, True, false]}",
    "{'q': \"x y\", r: 'it''s', s: \"a\\tb\"}",
    "video", "12", "{a, b}", "{a: }", "{url: http://x:8}",
    "{a: b c}", "{k: v # note\n}", "{a: 1} # note", "[a, {b: c}, [d]]",
]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", CASES)
def test_matches_yaml_safe_load(text):
    exp = yaml.safe_load(text)
    got = safe_load(text)
    assert _same(exp, got), (text, exp, got)


@pytest.mark.parametrize("text", ["{a: 1", "[1, 2", "{a: 'x}", "a: 1",
                                  "[a: 1]"])
def test_unread_or_malformed_raises(text):
    with pytest.raises(YAMLError):
        safe_load(text)
