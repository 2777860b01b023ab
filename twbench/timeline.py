"""The device's timeline from a ``torch.profiler`` trace: kernel
intervals, the host's ``tw:*`` ranges, the idle share and the breakdown.

:func:`trace`, :func:`trace_intervals` and :func:`device_timeline` are
frozen copies of ``traceweaver_tpu_torch/obs/profile.py`` (lines 109-197):
a trace of every thread, the raw profiler events read as ``(name,
start_us, end_us)``, and the idle share ``1 - |union of device operations|
/ window``. :func:`by_name` adds the device time a kernel name takes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]


def trace():
    """A profiler of the CPU and the card, recording every thread's ranges
    (the fleet's flow workers run on threads of their own)."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=config)


def trace_intervals(prof) -> Tuple[List[Interval], List[Interval]]:
    """``(device operations, tw ranges)``: every operation the card ran
    (not the device-side copies of annotation ranges) and every host range
    whose name starts with ``tw:``."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        is_device = e.device_type() == DeviceType.CUDA
        if is_device and e.is_user_annotation():
            continue
        if is_device or name.startswith("tw:"):
            lo = e.start_ns() / 1e3
            iv = (name, lo, lo + e.duration_ns() / 1e3)
            (device if is_device else ranges).append(iv)
    return device, ranges


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _host_range_at(t: float, ranges: List[Interval]) -> str:
    """The innermost (shortest) ``tw:*`` range open at time ``t``."""
    inside = [(hi - lo, name) for name, lo, hi in ranges if lo <= t <= hi]
    return min(inside)[1] if inside else "-"


def device_timeline(kernels: List[Interval], ranges: List[Interval], t0: float,
                    t1: float, top: int = 10) -> Dict:
    """Idle share of the window ``[t0, t1]``, its device busy time, and the
    ``top`` longest device operations and idle gaps, each with the host
    range open at its midpoint."""
    wall = t1 - t0
    if wall <= 0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    clipped = [(max(lo, t0), min(hi, t1)) for _, lo, hi in kernels if hi > t0 and lo < t1]
    busy = _union(clipped)
    busy_time = sum(hi - lo for lo, hi in busy)
    gaps, cursor = [], t0
    for lo, hi in busy + [(t1, t1)]:
        if lo > cursor:
            gaps.append((cursor, lo))
        cursor = max(cursor, hi)
    longest_ops = sorted(kernels, key=lambda k: k[2] - k[1], reverse=True)[:top]
    longest_gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    return dict(
        wall=wall, device_busy=busy_time, idle_share=1.0 - busy_time / wall,
        kernels=len(kernels),
        longest_ops=[dict(name=name, dur=hi - lo,
                          host_range=_host_range_at(0.5 * (lo + hi), ranges))
                     for name, lo, hi in longest_ops],
        longest_gaps=[dict(start=lo - t0, dur=hi - lo,
                           host_range=_host_range_at(0.5 * (lo + hi), ranges))
                      for lo, hi in longest_gaps])


def by_name(kernels: List[Interval], t0: float, t1: float) -> Dict[str, Tuple[float, int]]:
    """Device microseconds and launches of each operation name inside
    ``[t0, t1]``."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, lo, hi in kernels:
        if lo >= t0 and hi <= t1:
            out[name][0] += hi - lo
            out[name][1] += 1
    return {k: (v[0], int(v[1])) for k, v in out.items()}
