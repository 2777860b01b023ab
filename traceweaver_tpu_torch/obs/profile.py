"""Profiler hooks (mirrors ``traceweaver_tpu/obs/profile.py:30-96``).

- :func:`annotate`: a named range around a host stage. With profiling
  enabled it is ``torch.profiler.record_function(name)`` (and, on a CUDA
  build, an NVTX range of the same name), so the fleet's and the
  solver's stages (``tw:fleet:dispatch``, ``tw:solve:dispatch``, ...)
  show up in a ``torch.profiler`` trace. Disabled (the default) it is a
  null context: ``record_function`` costs host time on every call even
  with no profiler attached.
- :func:`enable` / :func:`disable` / :func:`profiling`: the switch, an
  explicit call in place of the JAX package's ``TW_PROFILE``.
- :func:`device_memory_families`: scrape-time gauge families of each
  card's allocated, peak and total bytes (``torch.cuda.memory_stats``,
  ``mem_get_info``); empty when profiling is off or there is no card.
- :func:`trace`: a ``torch.profiler.profile`` over the CPU and the card
  that records every thread (the fleet's flow workers launch the
  kernels), and :func:`device_timeline`, which reads a trace's kernels
  and ``tw:*`` ranges into the device's idle share, its longest
  operations and its longest idle gaps.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

_state = {"enabled": False}
_lock = threading.Lock()


def enable() -> None:
    with _lock:
        _state["enabled"] = True


def disable() -> None:
    with _lock:
        _state["enabled"] = False


def enabled() -> bool:
    return _state["enabled"]


@contextmanager
def profiling():
    """Profiling enabled for the duration of the context."""
    with _lock:
        prev = _state["enabled"]
        _state["enabled"] = True
    try:
        yield
    finally:
        with _lock:
            _state["enabled"] = prev


@contextmanager
def annotate(name: str):
    """Named profiler range around a host stage when profiling is
    enabled; a null context otherwise."""
    if not _state["enabled"]:
        yield
        return
    import torch

    # twlint-torch: disable=TW103 — instrumentation only: an NVTX range
    # where there is a card, nothing runs elsewhere because of it
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def device_memory_families() -> List[Tuple[str, str, str,
                                           List[Tuple[Dict[str, str], float]]]]:
    """Collector-style gauge family of each card's memory: bytes
    allocated now (``bytes_in_use``), the peak (``peak_bytes_in_use``)
    and the card's total (``bytes_limit``); empty when profiling is off
    or there is no card."""
    if not _state["enabled"]:
        return []
    import torch

    # twlint-torch: disable=TW103 — instrumentation only: no card, no
    # device memory samples
    if not torch.cuda.is_available():
        return []
    samples: List[Tuple[Dict[str, str], float]] = []
    for dev in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(dev)
        label = f"cuda:{dev}"
        for kind, value in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current", 0)),
                ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak", 0)),
                ("bytes_limit", torch.cuda.mem_get_info(dev)[1])):
            samples.append(({"device": label, "kind": kind}, float(value)))
    return [("tw_device_memory_bytes", "gauge",
             "per-device memory (torch.cuda.memory_stats; profiling enabled)",
             samples)]


def trace():
    """A ``torch.profiler.profile`` of the CPU and, with a card, CUDA
    activity, recording ranges of every thread (``profile_all_threads``:
    the fleet's flow workers run on their own threads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    # twlint-torch: disable=TW103 — instrumentation only: trace the card
    # where there is one
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=activities, experimental_config=config)


def trace_intervals(prof) -> Tuple[List[Tuple[str, float, float]],
                                   List[Tuple[str, float, float]]]:
    """``(device operations, tw ranges)`` of a finished trace, each as
    ``(name, start_us, end_us)`` on the trace's clock: every operation
    the card ran (kernels, copies, sets; not the device-side copies of
    the host's annotation ranges, which span whole stages) and every
    host range whose name starts with ``tw:``. Reads the raw profiler
    events, not ``prof.events()``, whose tree costs tens of microseconds
    per event."""
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


def _host_range_at(t: float, ranges) -> str:
    """The innermost ``tw:*`` range (shortest) open at time ``t``."""
    inside = [(hi - lo, name) for name, lo, hi in ranges if lo <= t <= hi]
    return min(inside)[1] if inside else "-"


def device_timeline(kernels: List[Tuple[str, float, float]],
                    ranges: List[Tuple[str, float, float]],
                    t0: float, t1: float, top: int = 10) -> Dict:
    """The device's idle share over the window ``[t0, t1]`` (one time
    unit throughout, microseconds in a ``torch.profiler`` trace):
    ``1 - |union of kernel intervals| / (t1 - t0)``, the ``top`` longest
    device operations and the ``top`` longest idle gaps (between the
    window's edges and the union's intervals), each with the ``tw:*``
    host range open at its midpoint. ``kernels`` and ``ranges`` are
    ``(name, start, end)``."""
    wall = t1 - t0
    if wall <= 0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    clipped = [(max(lo, t0), min(hi, t1)) for _, lo, hi in kernels
               if hi > t0 and lo < t1]
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
