"""The traced window: a plain ``torch.profiler`` session over the cell's
units (replays of the captured programs, as users run them), reduced to
device intervals, the device's busy time, and a breakdown by kernel and
by what the host did while the device sat idle."""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


class Trace:
    """Device activities ``(start_s, end_s, name)`` and host operators of
    one profiled window."""

    #: Idle gaps labelled one by one in :meth:`breakdown`.
    LABELLED = 200

    def __init__(self, device_ops, host_ops, t0_us: float, t1_us: float):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.window_s = (t1_us - t0_us) * 1e-6
        self.busy = _union([(a, b) for a, b, _ in device_ops])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.t0, self.t1 = t0_us * 1e-6, t1_us * 1e-6

    def time_by(self, match) -> float:
        """Device seconds of the activities whose name ``match`` accepts."""
        return sum(b - a for a, b, n in self.device_ops if match(n))

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.Counter()
        for a, b, n in self.device_ops:
            by_name[n[:120]] += b - a
        edges = [(self.t0, self.t0)] + self.busy + [(self.t1, self.t1)]
        spans = sorted(((start - end, (start + end) / 2) for (_, end), (
            start, _) in zip(edges, edges[1:]) if start > end), reverse=True)
        # The longest gaps are labelled by the innermost host operator
        # running at their midpoint; the rest are summed unlabelled.
        a = np.asarray([h[0] for h in self.host_ops] or [0.0])
        b = np.asarray([h[1] for h in self.host_ops] or [-1.0])
        names = [h[2] for h in self.host_ops] or [""]
        gaps = collections.Counter()
        for i, (length, mid) in enumerate(spans):
            label = "shorter idle gaps"
            if i < self.LABELLED:
                inside = (a <= mid) & (b >= mid)
                label = "host outside any traced operator"
                if inside.any():
                    j = np.flatnonzero(inside)[np.argmin((b - a)[inside])]
                    label = names[j][:120]
            gaps[label] += length
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def traced(run):
    """``run()`` inside a profiler session: (its result, :class:`Trace`)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            result = run()
        torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "bench.window"
              and e.device_type == torch.autograd.DeviceType.CPU]
    t0 = window[0].time_range.start
    t1 = max(e.time_range.end for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA)
    t1 = max(t1, window[0].time_range.end)
    device_ops, host_ops = [], []
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # The stage ranges' spans on the device timeline are no work.
            if not e.name.startswith(("fdt.", "bench.")):
                device_ops.append(span)
        elif e.name != "bench.window":
            host_ops.append(span)
    if not device_ops:
        raise RuntimeError("the profiler kept no device activity")
    return result, Trace(device_ops, host_ops, t0, t1)
