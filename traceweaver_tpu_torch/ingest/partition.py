"""Per-service span partitioning (mirrors
``traceweaver_tpu/ingest/partition.py``).

For one service: its incoming (server) spans grouped by upstream
endpoint and its outgoing (client) spans by downstream endpoint, each
partition sorted by ``(start, end)`` with one ``lexsort`` over its
columns (the JAX package's ``TW_COLUMNAR`` path, its default). A service
with more than one incoming partition is skipped, as in the reference.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from traceweaver_tpu_torch.spans import Span, SpanArray, TraceStore


def partition_spans_by_endpoint(
    spans: List[Span], endpoint_of: Callable[[Span], str]
) -> Dict[str, List[Span]]:
    partitions: Dict[str, List[Span]] = {}
    for span in spans:
        partitions.setdefault(endpoint_of(span), []).append(span)
    for ep, part in partitions.items():
        arr = SpanArray.from_spans(part)
        order = np.lexsort((arr.end, arr.start))
        if not np.array_equal(order, np.arange(len(part))):
            partitions[ep] = [part[i] for i in order]
    return partitions


@dataclass
class ServiceProblem:
    """One service's assignment problem: ``in_span_partitions`` has one
    key (the upstream endpoint), ``out_span_partitions`` one key per
    downstream endpoint."""

    process: str
    in_span_partitions: Dict[str, List[Span]]
    out_span_partitions: Dict[str, List[Span]]
    skipped: bool = False
    skip_reason: Optional[str] = None

    def columns(self) -> Dict[str, Dict[str, SpanArray]]:
        """Columns of the partitions, built at call time (after any
        in-place span transform)."""
        return {
            "in": {ep: SpanArray.from_spans(part)
                   for ep, part in self.in_span_partitions.items()},
            "out": {ep: SpanArray.from_spans(part)
                    for ep, part in self.out_span_partitions.items()},
        }


def build_service_problem(store: TraceStore, process: str,
                          deepcopy: bool = True) -> ServiceProblem:
    """Partition one service's spans. Deep-copies the span lists by
    default, since load compression and cache hits change spans in
    place."""
    in_spans = store.in_spans_by_process.get(process, [])
    out_spans = store.out_spans_by_process.get(process, [])
    if deepcopy:
        in_spans = copy.deepcopy(in_spans)
        out_spans = copy.deepcopy(out_spans)

    if len(out_spans) == 0:
        return ServiceProblem(process, {}, {}, skipped=True,
                              skip_reason="no outgoing spans")

    in_parts = partition_spans_by_endpoint(
        in_spans, lambda s: s.GetParentProcess(store.all_processes, store.all_spans)
    )
    out_parts = partition_spans_by_endpoint(
        out_spans, lambda s: s.GetChildProcess(store.all_processes, store.all_spans)
    )
    if len(in_parts) > 1:
        return ServiceProblem(process, in_parts, out_parts, skipped=True,
                              skip_reason="multiple incoming partitions")
    return ServiceProblem(process, in_parts, out_parts)
