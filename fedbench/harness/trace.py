"""The traced window: torch.profiler over the window's calls, reduced to the
device-busy seconds, each device operation's seconds, and the idle gaps
between device operations by what the host was doing in them.

Busy seconds are the sum of the device events' own times (copied from
chip_smoke.py's `profiled`): the program runs on one stream, so the sum
is the union.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


def traced(fn):
    """(fn()'s result, {"busy_s", "wall_s", "kernels": {name: s},
    "device_ops": [[name, s]] (10 longest), "idle_gaps": [[host op, s]]
    (10 largest sums)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = defaultdict(float)
    dev, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            kernels[e.name] += us * 1e-6
            dev.append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return out, {"busy_s": sum(kernels.values()), "wall_s": wall,
                 "kernels": dict(kernels),
                 "device_ops": [[k, v] for k, v in top[:10]],
                 "idle_gaps": _idle_gaps(dev, host)}


# A host op that starts this many microseconds before an idle gap may
# still be the one that overlaps it most.
SLACK_US = 1000.0


def _idle_gaps(dev, host):
    """Idle seconds between device operations, summed by the host op that
    overlaps each gap most; "python" where no op ran."""
    if not dev:
        return []
    dev.sort()
    merged = [list(dev[0])]
    for s, e in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host.sort()
    starts = [h[0] for h in host]
    sums = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        best, label = 0.0, "python"
        lo = bisect.bisect_left(starts, a - SLACK_US)
        hi = bisect.bisect_right(starts, b)
        for s, e, name in host[lo:hi]:
            overlap = min(e, b) - max(s, a)
            if overlap > best:
                best, label = overlap, name
        sums[label] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:10]]
