"""A torch.profiler slice and what the per-layer readers take from it.

``profile(fn, units, path)`` runs ``fn`` (``units`` steps or evaluations)
under the profiler with the CPU and CUDA activities, synchronised at both
ends, and writes the Chrome trace to ``path``. The resulting ``Slice``
holds the device operations (kernels, copies, fills) with their names and
times, the host operations, the device's busy seconds (the union of its
operations' intervals) and the slice's length on the host clock.
"""

import heapq
import time

import torch

NOT_KERNELS = ("Memcpy", "Memset")


class Slice:
    """The device and host operations of one profiled slice."""

    def __init__(self, device_ops, host_ops, window_s, units):
        self.device_ops = device_ops      # [(name, start_us, end_us)]
        self.host_ops = host_ops          # [(name, start_us, end_us)]
        self.window_s = window_s
        self.units = units
        self.busy_s = sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self):
        spans = sorted((s, e) for _, s, e in self.device_ops)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def kernels(self):
        return [op for op in self.device_ops
                if not op[0].startswith(NOT_KERNELS)]

    def kernel_seconds(self, *parts):
        """Device seconds of the kernels whose name holds one of
        ``parts``."""
        return sum(e - s for n, s, e in self.kernels()
                   if any(p in n for p in parts)) / 1e6

    def top_device_ops(self, n=10):
        by = {}
        for name, s, e in self.device_ops:
            by[name[:160]] = by.get(name[:160], 0.0) + (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The device's idle seconds between its operations, summed by the
        innermost host operation (other than a CUDA runtime call) that was
        running at each gap's middle."""
        busy = self.busy_intervals()
        host = sorted(self.host_ops, key=lambda op: op[1])
        by, active, i = {}, [], 0
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], i))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            over = [host[j] for _, j in active]
            named = [op for op in over if not op[0].startswith("cuda")]
            pick = min(named or over, key=lambda op: op[2] - op[1],
                       default=("(host between operations)", 0, 0))
            by[pick[0][:160]] = by.get(pick[0][:160], 0.0) + (s1 - e0) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def profile(fn, units, path=None):
    """Run ``fn`` under torch.profiler; returns its ``Slice``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    if path is not None:
        prof.export_chrome_trace(str(path))
    dev, host = [], []
    for e in prof.events():
        op = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == torch.autograd.DeviceType.CUDA
         else host).append(op)
    return Slice(dev, host, window_s, units)
