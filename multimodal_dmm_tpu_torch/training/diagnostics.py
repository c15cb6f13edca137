"""Training diagnostics (counterpart of
multimodal_dmm_tpu/training/diagnostics.py).

- ``grad_stats``: per-leaf mean and max |gradient| and NaN count of a
  gradient tree; ``plot_grad_flow`` draws them as a bar chart
  (``--gradients``; matplotlib is imported only there).
- ``StepTimer``: per-step times, by CUDA events on the GPU (read when the
  summary is asked for, so timing adds no synchronisation to the loop)
  and by the host's clock on the CPU; the epoch loop keeps one under
  ``--profile_dir`` only.
- ``profile_ctx``: a ``torch.profiler`` trace of the block, written as a
  Chrome trace into a directory, with its table of device time per op.
- ``span``: a named host interval of the program's phases (``mdmm/...``)
  in whatever ``torch.profiler`` trace is being recorded, and nothing
  when none is.
"""

import contextlib
import os
import time

import numpy as np
import torch

from ..tree import tree_leaves_with_path

# The gate and the event of ``span``, looked up once.
_profiling = torch._C._autograd._profiler_enabled
_HostEvent = torch._C._profiler._RecordFunctionFast
NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context manager that marks the block as the program phase
    ``name`` in the trace of a running ``torch.profiler``.

    While a profiler records, it is a host-only profiler event on the
    profiler's clock: not a user annotation, so the profiler mirrors
    nothing of it onto the device's track, and it launches and waits for
    nothing. Otherwise it is the shared ``NO_SPAN``: one gate check, no
    clock read, no allocation. Names start with ``mdmm/``; a host
    synchronisation's is ``mdmm/sync.<site>``."""
    if _profiling():
        return _HostEvent(name)
    return NO_SPAN


def grad_stats(grads):
    """[{name, mean_abs, max_abs, n_nan}] per leaf of a gradient tree (a
    leaf without a gradient counts as zeros)."""
    stats = []
    for path, leaf in tree_leaves_with_path(grads):
        a = leaf.detach().cpu().numpy()
        stats.append({
            "name": "/".join(str(p) for p in path),
            "mean_abs": float(np.abs(a).mean()) if a.size else 0.0,
            "max_abs": float(np.abs(a).max()) if a.size else 0.0,
            "n_nan": int(np.isnan(a).sum())})
    return stats


def plot_grad_flow(grads, save_path=None):
    """Bar chart of per-leaf mean |gradient|, leaves with a NaN in red."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = grad_stats(grads)
    names = [s["name"] for s in stats]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.3), 4))
    ax.bar(range(len(names)), [s["mean_abs"] for s in stats],
           color=["r" if s["n_nan"] else "c" for s in stats])
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation="vertical", fontsize=4)
    ax.set_ylabel("average gradient magnitude")
    ax.set_title("Gradient flow (red = contains NaN)")
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path)
    plt.close(fig)
    return stats


class StepTimer:
    """Per-step times: CUDA events around each step on a GPU ``device``,
    the host's clock otherwise."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.events = []
        self.times = []
        self._t0 = None

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((self._t0, end))
        else:
            self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self):
        """{steps, mean_ms, median_ms, p90_ms}; waits for the device."""
        if self.events:
            self.events[-1][1].synchronize()
            self.times += [a.elapsed_time(b) / 1e3 for a, b in self.events]
            self.events = []
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"steps": len(arr), "mean_ms": float(arr.mean() * 1e3),
                "median_ms": float(np.median(arr) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3)}


@contextlib.contextmanager
def profile_ctx(trace_dir=None):
    """Profile the block with ``torch.profiler`` (host and, on a GPU,
    device activity) when ``trace_dir`` is set: ``trace.json`` (Chrome
    trace) and ``ops.txt`` (device time per op) go there."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total" if len(acts) > 1
            else "self_cpu_time_total", row_limit=60))
