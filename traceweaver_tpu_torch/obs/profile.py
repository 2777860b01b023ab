"""Profiler hooks (mirrors ``traceweaver_tpu/obs/profile.py:30-96``).

- :func:`annotate`: the one stage scope. Each use takes one
  ``perf_counter`` pair and does three things with it: bills the seconds
  through ``bill(key, seconds)`` (the fleet passes its stats ledger's
  ``add``, so ``obs/`` imports no caller) and appends ``(name, t0, t1)``
  to ``stamps`` when given; with profiling enabled opens a
  ``torch.profiler`` range of the name (and, on a CUDA build, an NVTX
  range of the same name), so the fleet's and the solver's stages
  (``tw:fleet:plan``, ``tw:fleet:pack``, ``tw:fleet:dispatch``,
  ``tw:fleet:decode``, ``tw:solve:dispatch``, ...) show up in a
  ``torch.profiler`` trace; and with a self-tracer installed stamps the
  stage on the window keys it is given (:mod:`.selftrace`). A range
  carries its group's index in the round as its one argument, inherited
  by the scopes nested in it on its thread, so one group's pack,
  dispatch, fetch and decode link across threads (a trace recorded with
  ``record_shapes=True`` shows it as the range's concrete input). The
  wall stamp is taken only with a tracer installed. Disabled (the
  default) the scope opens no range: ``record_function`` costs host time
  on every call even with no profiler attached.
- :func:`enable` / :func:`disable` / :func:`profiling`: the switch, an
  explicit call in place of the JAX package's ``TW_PROFILE``. While it is
  on, a ``gc.callbacks`` hook opens a ``tw:gc:<generation>`` range over
  every collection of generation 1 or 2, so a gap of the card that a
  collection holds is named by it. Generation 0 gets none: a collection
  of it takes tens of microseconds, hundreds of them run a fleet round,
  no long gap comes from one, and a range on each would only slow the
  traced window.
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

import gc
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from traceweaver_tpu_torch.obs import selftrace as _selftrace

_state = {"enabled": False}
_lock = threading.Lock()
# per thread: the group index the open scopes carry, and the open
# garbage-collection range
_local = threading.local()


def _switch(on: bool) -> None:
    """Set the switch, and the gc hook with it (under ``_lock``)."""
    _state["enabled"] = on
    hooked = _gc_range in gc.callbacks
    if on and not hooked:
        gc.callbacks.append(_gc_range)
    elif not on and hooked:
        gc.callbacks.remove(_gc_range)


def enable() -> None:
    with _lock:
        _switch(True)


def disable() -> None:
    with _lock:
        _switch(False)


def enabled() -> bool:
    return _state["enabled"]


@contextmanager
def profiling():
    """Profiling enabled for the duration of the context."""
    with _lock:
        prev = _state["enabled"]
        _switch(True)
    try:
        yield
    finally:
        with _lock:
            _switch(prev)


def _range_open(name: str, group: Optional[int]):
    """Open the profiler range ``name`` (the group index, when there is
    one, as its argument; ``record_function`` would drop a string one)
    and, on a CUDA build, the NVTX range of the same name."""
    import torch

    handle = torch._C._autograd._record_function_with_args_enter(
        name, *(() if group is None else (group,)))
    # twlint-torch: disable=TW103 — instrumentation only: an NVTX range
    # where there is a card, nothing runs elsewhere because of it
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    return handle, nvtx


def _range_close(rng) -> None:
    import torch

    handle, nvtx = rng
    if nvtx:
        torch.cuda.nvtx.range_pop()
    torch._C._autograd._record_function_with_args_exit(handle)


def _gc_range(phase: str, info: Dict) -> None:
    """The ``gc.callbacks`` hook while profiling is on: a
    ``tw:gc:<generation>`` range over each collection of generation 1 or
    2 (a collection starts and stops on one thread)."""
    if phase == "start":
        if info["generation"] >= 1:
            _local.gc = _range_open(f"tw:gc:{info['generation']}", None)
        return
    rng = getattr(_local, "gc", None)
    if rng is not None:
        _local.gc = None
        _range_close(rng)


class Stamp:
    """The ``perf_counter`` stamps of one stage scope, ``t1`` set as it
    closes."""

    __slots__ = ("t0", "t1")

    def __init__(self) -> None:
        self.t0 = self.t1 = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@contextmanager
def annotate(name: str, bill: Optional[Callable[[str, float], None]] = None,
             key: Optional[str] = None, *, group: Optional[int] = None,
             trace_keys: Sequence[str] = (), trace_stage: Optional[str] = None,
             stamps: Optional[List[Tuple[str, float, float]]] = None):
    """The stage scope ``name``; yields its :class:`Stamp`. At its close
    it calls ``bill(key, seconds)`` (both given) and appends ``(name, t0,
    t1)`` to ``stamps`` (given). With profiling enabled it runs inside
    the profiler range ``name`` carrying ``group`` (None: the group of
    the scope it is nested in on this thread, if any). With a self-tracer
    installed it records the stage ``trace_stage`` (None: ``name``) on
    every window key in ``trace_keys``."""
    tracer = _selftrace.active() if trace_keys else None
    w0 = _selftrace.now_us() if tracer is not None else 0.0
    rng = outer = None
    if _state["enabled"]:
        outer = getattr(_local, "group", None)
        _local.group = outer if group is None else group
        rng = _range_open(name, _local.group)
    stamp = Stamp()
    stamp.t0 = time.perf_counter()
    try:
        yield stamp
    finally:
        stamp.t1 = time.perf_counter()
        if rng is not None:
            _range_close(rng)
            _local.group = outer
        if bill is not None and key is not None:
            bill(key, stamp.t1 - stamp.t0)
        if stamps is not None:
            stamps.append((name, stamp.t0, stamp.t1))
        if tracer is not None:
            w1 = _selftrace.now_us()
            for k in trace_keys:
                tracer.stage(k, trace_stage or name, w0, w1)


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(lo, hi)`` intervals as disjoint sorted intervals."""
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


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
    busy = union(clipped)
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
