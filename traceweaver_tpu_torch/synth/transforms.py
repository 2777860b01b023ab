"""Cache-hit injection (mirrors ``traceweaver_tpu/synth/transforms.py
create_cache_hits``, the JAX package's dynamism generator for the exp2
cache-hit workloads).

The same global ``np.random.seed(10)`` draws and the same per-span
``random.randint`` draw as the JAX copy, in the same order, so one input
gives the same cache hits in both packages. The JAX copy rescans every
partition for each hit; this one indexes the spans by trace once, with
the same effect.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List

import numpy as np

from traceweaver_tpu_torch.metrics.accuracy import get_out_eps_in_order
from traceweaver_tpu_torch.spans import SKIP, Span


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
