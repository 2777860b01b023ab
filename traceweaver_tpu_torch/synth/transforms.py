"""Synthetic workload transforms (mirrors
``traceweaver_tpu/synth/transforms.py``).

- :func:`compress_spans` divides each trace's arrival by
  ``compress_factor`` and shifts the whole trace rigidly: higher load.
- :func:`repeat_and_interleave_spans` replicates well-nested requests
  and scatters them uniformly over the compressed time range.
- :func:`create_cache_hits` deletes the true outgoing span of a skewed
  sample of requests on the earliest endpoint (exp2's cache hits). The
  same global ``np.random.seed(10)`` draws and the same per-span
  ``random.randint`` draw as the JAX copy, in the same order, so one
  input gives the same cache hits in both packages. The JAX copy rescans
  every partition for each hit; this one indexes the spans by trace
  once, with the same effect.

Every random draw is the JAX copy's, in its order, so one seed gives one
result in both packages.
"""

from __future__ import annotations

import copy
import random
import string
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from traceweaver_tpu_torch.metrics.accuracy import get_out_eps_in_order
from traceweaver_tpu_torch.spans import SKIP, Span


def _sort_by_trace_id(partitions: Dict[str, List[Span]]) -> None:
    for part in partitions.values():
        part.sort(key=lambda s: s.trace_id)


def _sort_by_time(partitions: Dict[str, List[Span]]) -> None:
    for part in partitions.values():
        part.sort(key=lambda s: (s.start_mus, s.start_mus + s.duration_mus))


def compress_spans(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    repeat_factor: int,
    compress_factor: float,
) -> Tuple[Dict[str, List[Span]], Dict[str, List[Span]]]:
    """Divide arrival times by ``compress_factor``, preserving per-request
    internal offsets. In-place; returns the partitions re-sorted by time.

    Each trace is rebased rigidly: its earliest incoming span's start is
    divided by the factor and every span of the trace shifts by the same
    delta. For the reference's aligned case — exactly one span per trace
    in every partition (its ``repeat_change_spans`` asserts this,
    reference transforms.py:26-29) — this reproduces the reference result
    number-for-number; unlike the reference it is also defined for call
    graphs where a service or endpoint fires several times per trace
    (Alibaba CGs with repeated invocations or ``-loop`` self-call
    remaps), which the index-paired reference transform cannot express.
    """
    if repeat_factor == 1 and compress_factor == 1:
        return in_span_partitions, out_span_partitions

    # trace-id pre-sort keeps the final stable time sort's tie order
    # deterministic (and reference-identical: ms-resolution data often has
    # equal (start, end) pairs after compression)
    _sort_by_trace_id(in_span_partitions)
    _sort_by_trace_id(out_span_partitions)

    assert len(in_span_partitions) == 1
    ep_in, in_spans = next(iter(in_span_partitions.items()))

    # anchor: the earliest incoming span of each trace
    anchor: Dict = {}
    for s in in_spans:
        t = float(s.start_mus)
        if s.trace_id not in anchor or t < anchor[s.trace_id]:
            anchor[s.trace_id] = t
    delta = {
        tid: t0 / compress_factor - t0 for tid, t0 in anchor.items()
    }

    for part in [in_spans, *out_span_partitions.values()]:
        for s in part:
            if s.trace_id not in delta:
                raise AssertionError(
                    f"outgoing span {s.GetId()} belongs to trace "
                    f"{s.trace_id} with no incoming span")
            s.start_mus = s.start_mus + delta[s.trace_id]

    _sort_by_time(in_span_partitions)
    _sort_by_time(out_span_partitions)
    return in_span_partitions, out_span_partitions


def repeat_and_interleave_spans(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    repeat_factor: int,
    compress_factor: float,
) -> Tuple[Dict[str, List[Span]], Dict[str, List[Span]]]:
    """Replicate well-nested requests and scatter them uniformly in time."""
    if repeat_factor <= 1 and compress_factor <= 1:
        return in_span_partitions, out_span_partitions

    assert len(in_span_partitions) == 1
    in_old = copy.deepcopy(in_span_partitions)
    out_old = copy.deepcopy(out_span_partitions)
    ep_in, in_spans = next(iter(in_old.items()))

    span_inds = []
    for ind, in_span in enumerate(in_spans):
        nested = all(
            float(in_span.start_mus) <= float(out_old[ep][ind].start_mus)
            and float(out_old[ep][ind].start_mus) + float(out_old[ep][ind].duration_mus)
            <= float(in_span.start_mus) + float(in_span.duration_mus)
            for ep in out_old
        )
        if nested:
            span_inds.append(ind)

    in_span_partitions[ep_in] = []
    for ep in out_old:
        out_span_partitions[ep] = []

    span_inds = span_inds * repeat_factor
    random.shuffle(span_inds)
    min_t = min(float(s.start_mus) for s in in_spans) / compress_factor
    max_t = max(float(s.start_mus) for s in in_spans) / compress_factor
    start_ts = sorted(random.uniform(min_t, max_t) for _ in span_inds)

    for ind, start_t in zip(span_inds, start_ts):
        trace_id = "".join(
            random.choice(string.ascii_lowercase + string.digits) for _ in range(32)
        )
        in_span = copy.deepcopy(in_spans[ind])
        in_span.start_mus = float(in_span.start_mus)
        offset = start_t - in_span.start_mus
        in_span.trace_id = trace_id
        in_span.start_mus += offset
        in_span_partitions[ep_in].append(in_span)
        for ep in out_old:
            out_span = copy.deepcopy(out_old[ep][ind])
            out_span.start_mus = float(out_span.start_mus) + offset
            out_span.trace_id = trace_id
            out_span_partitions[ep].append(out_span)
    return in_span_partitions, out_span_partitions


def create_cache_hits(
    true_assignments: Dict[str, Dict],
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    cache_rate: float,
) -> Dict[str, Dict]:
    """Simulate cache-served calls on the earliest outgoing endpoint, in
    place: an exponentially skewed sample of requests loses its true
    outgoing span there (ground truth becomes ``SKIP``), its incoming
    span is shortened by that span's duration, and its spans at later
    endpoints start that much earlier. Returns ``true_assignments``."""
    np.random.seed(10)

    eps = get_out_eps_in_order(out_span_partitions)
    chosen_ep = eps[0]

    lambda_parameter = 0.001
    in_ep = next(iter(in_span_partitions))
    num_spans = len(in_span_partitions[in_ep])
    # one discarded exponential batch, then the weighted choice
    np.random.exponential(scale=1 / lambda_parameter, size=int(cache_rate * num_spans))
    p = np.exp(-lambda_parameter * np.arange(num_spans)).astype("float64")
    p = p / np.sum(p)
    unique_indices = set(
        np.random.choice(np.arange(num_spans), size=int(cache_rate * num_spans),
                         replace=False, p=p).tolist())

    in_by_trace = defaultdict(list)
    for part in in_span_partitions.values():
        for span in part:
            in_by_trace[span.trace_id].append(span)
    later_by_trace = defaultdict(list)
    for ep in eps[1:]:
        for span in out_span_partitions[ep]:
            later_by_trace[span.trace_id].append(span)
    chosen_by_id = defaultdict(list)
    for span in out_span_partitions[chosen_ep]:
        chosen_by_id[span.GetId()].append(span)

    removed = set()
    for i, in_span in enumerate(in_span_partitions[in_ep]):
        random.randint(0, 999)  # the reference's draw, kept for its RNG state
        if i not in unique_indices:
            continue
        found = chosen_by_id.get(true_assignments[chosen_ep][in_span.GetId()])
        if not found:
            continue
        cached = found.pop(0)
        true_assignments[chosen_ep][in_span.GetId()] = SKIP
        for span in in_by_trace[in_span.trace_id]:
            span.duration_mus -= cached.duration_mus
        for span in later_by_trace[in_span.trace_id]:
            span.start_mus -= cached.duration_mus
        removed.add(id(cached))
    out_span_partitions[chosen_ep][:] = [
        s for s in out_span_partitions[chosen_ep] if id(s) not in removed]
    return true_assignments
