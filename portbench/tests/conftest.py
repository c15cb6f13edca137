"""Fixtures of the benchmark's CPU tests: the repository's root on the
import path, and cells of the benchmark cut to a size the CPU runs in
seconds (the program on its plain PyTorch paths, the reference beside
it). Tests that need the card take ``card`` and skip without one."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core.spec import Cell, load_benchmark  # noqa: E402

# A seed above 2**32, as the benchmark's own seeds may be.
SEED = 2 ** 33 + 5


def tiny(cell):
    """``cell`` with z = h = 8, few and short sequences, small batches and
    particle counts; the codecs' layers keep the app's shapes."""
    cell = copy.copy(cell)
    cfg = cell.cfg = copy.deepcopy(cell.cfg)
    cfg["z_dim"] = cfg["h_dim"] = 8
    cfg["train"].update(batch_size=4, split=5, train_particles=3,
                        match_particles=4)
    cfg["eval"].update(flt_particles=5, batch_sz_eval=4)
    groups = cfg["data"]["groups"]
    first, second = list(groups)
    test_key, test_vals = next(iter(cfg["data"]["test"].items()))
    for key in (first, second):
        vals = groups[key][:3]
        if key == test_key:
            vals = [v for v in groups[key]
                    if v not in test_vals][:2] + test_vals[:1]
        groups[key] = vals
    cfg["data"]["test"] = {test_key: test_vals[:1]}
    cfg["data"]["lengths"] = [8, 12]
    return cell


@pytest.fixture(scope="session")
def bench():
    return load_benchmark()


@pytest.fixture
def tiny_cell(bench):
    return lambda name: tiny(Cell(bench, name))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)
