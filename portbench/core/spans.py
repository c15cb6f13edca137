"""The program's own spans in a profiled slice, for the per-layer readers.

The port marks its phases with host-only profiler events named
``mdmm/<phase>`` (``multimodal_dmm_tpu_torch/training/diagnostics.py:
span``), on the profiler's clock, so they sit among the slice's host
operations beside the device's operations. A host synchronisation's span
is ``mdmm/sync.<site>``.

- ``intervals(sl, name)``: the (start, end) microseconds of each span
  ``name``.
- ``total_ms(sl, name)``: their summed length.
- ``self_ms(sl, name)``: their summed length less the part of each that
  the program's other spans inside it cover.
- ``idle_ms_under(sl, name)``: the device's idle gaps (between the union
  of its operations' intervals) whose middle lies inside one of them.
- ``syncs(sl)``: the sync spans.

Each returns None when the slice holds no such span, so a reader finds
nothing to read in a program without them, and when it holds no device
operation: a slice traced without a card gives no reading.
"""

import bisect

PREFIX = "mdmm/"
SYNC = PREFIX + "sync."


def _spans(sl):
    if sl is None or not sl.device_ops:
        return []
    return sorted((s, e, n) for n, s, e in sl.host_ops
                  if n.startswith(PREFIX))


def intervals(sl, name):
    """[(start_us, end_us)] of the spans ``mdmm/<name>``, by start."""
    full = PREFIX + name
    return [(s, e) for s, e, n in _spans(sl) if n == full]


def total_ms(sl, name):
    found = intervals(sl, name)
    if not found:
        return None
    return sum(e - s for s, e in found) / 1e3


def _union(parts):
    """The intervals ``parts`` merged where they overlap, by start."""
    merged = []
    for s, e in sorted(parts):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def self_ms(sl, name):
    found = intervals(sl, name)
    if not found:
        return None
    spans = _spans(sl)
    full = PREFIX + name
    out = 0.0
    for s, e in found:
        # Every other span inside this one; a span of the same name and
        # interval is this one.
        inner = [(cs, ce) for cs, ce, n in spans
                 if s <= cs and ce <= e and not (n == full and cs == s
                                                 and ce == e)]
        out += (e - s) - sum(ie - i_s for i_s, ie in _union(inner))
    return out / 1e3


def idle_ms_under(sl, name):
    found = intervals(sl, name)
    if not found:
        return None
    under = _union(found)
    starts = [s for s, _ in under]
    busy = sl.busy_intervals()
    out = 0.0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= under[i][1]:
            out += s1 - e0
    return out / 1e3


def syncs(sl):
    """[(start_us, end_us)] of every sync span, None if there is none."""
    found = [(s, e) for s, e, n in _spans(sl) if n.startswith(SYNC)]
    return found or None
