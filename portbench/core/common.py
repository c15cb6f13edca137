"""What every driver of a traffic mix shares: the run's outcome, the seeds
drawn from ``--seed``, and the device's synchronisation, peak and release.

A mix file's ``kind`` names its driver, ``drivers/<kind>.py``, which gives
``run(cell, seed, seconds, trace, device, t_start, trace_path=None)`` (one
run: set-up, the window, with ``trace`` a profiled slice after it, then the
check), ``control(cell, seed, device, kind)`` (the check's numbers of the
reference put in the program's place at a lower precision) and ``FAULTS``
(each fault that a cell of the kind can have, as a function that plants it
under the timed path and returns its undo).
"""

import contextlib
import gc
import os

import numpy as np
import torch


class Outcome:
    """What one run measured and checked."""

    def __init__(self, metrics, attempted, failed, numbers, ctx):
        self.metrics = metrics      # end-to-end {name: value}
        self.attempted = attempted
        self.failed = failed
        self.numbers = numbers      # {check name: value}
        self.ctx = ctx              # what the per-layer readers take


def seeds(seed):
    """(data, weights, program) seeds drawn from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(3)
    return [int(x) & 0x7FFFFFFF for x in state]


@contextlib.contextmanager
def quiet():
    """The program's prints go nowhere: the result is the last line."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device):
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)


def free():
    """Return the freed program's memory to the device before the
    reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def patch(owner, name, make):
    """Replace ``owner.name`` by ``make(original)``; returns the undo."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    return lambda: setattr(owner, name, orig)
