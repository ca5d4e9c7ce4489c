"""The traced window: ``torch.profiler`` over the card, read into the
device's busy time, its kernels by name and its idle gaps.

Only the card's activity is recorded (kernels, copies and memsets, from
CUPTI), so a kernel launched through ``ctypes`` shows as any other.
The host side is the program's own stage spans (``jobs.run_job``),
taken on ``time.time_ns``, the clock the profiler's timestamps use.
"""

import re


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def device_events(prof):
    """Stop ``prof``; its device activities as (name, start ns, end ns),
    in order of start."""
    import torch

    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda ev: ev[1])
    return out


def busy_intervals(events, t0, t1):
    """The union of the events' intervals, clipped to [t0, t1]."""
    merged = []
    for _, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def kernel_seconds(events, pattern):
    """Device seconds of the events whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(e - s for name, s, e in events if rx.search(name)) / 1e9


def _short(name, width=120):
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(events, spans, t0, t1, top=10):
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost program stage open at its middle
    (``host`` where none is)."""
    by_name = {}
    for name, s, e in events:
        by_name[_short(name)] = by_name.get(_short(name), 0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], t0
    for s, e in busy_intervals(events, t0, t1) + [[t1, t1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        open_spans = [sp for sp in spans if sp[1] <= mid < sp[2]]
        label = min(open_spans, key=lambda sp: sp[2] - sp[1])[0] if open_spans else "host"
        named.append([label, (e - s) / 1e9])
    return dict(device_ops=[list(kv) for kv in ops], idle_gaps=named)
