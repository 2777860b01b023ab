"""Per-dataset repair adapters (mirrors ``traceweaver_tpu/ingest/repair.py``).

Two of the recorded testbeds ship spans in a shape the reconstructor can't
consume directly; these adapters normalise them (reference:
src/trace_reconstructor/ports/python/executor.py:509-633):

- :func:`fix_nodejs` (FIX=0) — the nodejs testbed recorded only one span per
  call, tagged ``client``. Flip those to ``server`` and fabricate the missing
  client half on the caller using the testbed's known topology.
- :func:`fix_media` (FIX=1) — media_microservices traces are re-rooted at the
  ``ComposeReview`` span, same-process parent chains are collapsed, and the
  missing client halves are fabricated from the parent links.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

from traceweaver_tpu_torch.spans import Span, SpanId

# Caller service for each nodejs testbed service (reference executor.py:109-115).
NODEJS_CALLER = {
    "service5": "service3",
    "service4": "service2",
    "service2": "service1",
    "service3": "service1",
    "service1": "init-service",
}


def fix_nodejs(spans: Dict[SpanId, Span], processes: Dict[str, str]) -> Dict[SpanId, Span]:
    """FIX=0: flip client→server; fabricate caller-side client spans.

    Mirrors reference ``FixSpans`` (executor.py:509-538): the fabricated
    client span reuses the server span's timing, lives on the caller's
    process (resolved via the hardcoded topology), and the server span is
    re-parented onto it.
    """
    # service name -> a process id for it (last one seen wins, as in reference)
    service_to_pid: Dict[str, str] = {}
    for span in spans.values():
        service_to_pid[processes[span.process_id]] = span.process_id

    new_spans: Dict[SpanId, Span] = {}
    for span_id, span in spans.items():
        service = processes[span.process_id]
        if span.span_kind == "client":
            span.span_kind = "server"
        elif span.span_kind == "server":
            clone = copy.deepcopy(span)
            original_ref = copy.deepcopy(span.references)
            span.references[0] = (original_ref[0][0], span.sid + "_client")
            clone.sid = clone.sid + "_client"
            clone.process_id = service_to_pid[NODEJS_CALLER[service]]
            clone.span_kind = "client"
            clone.references = original_ref
            new_spans[(clone.trace_id, clone.sid)] = clone

    spans.update(new_spans)
    return spans


def fix_media(
    spans: Dict[SpanId, Span], processes: Dict[str, str]
) -> Tuple[Dict[SpanId, Span], Dict[str, str]]:
    """FIX=1: re-root at ComposeReview and fabricate client halves.

    Mirrors reference ``FixSpans2`` (executor.py:543-633):
    1. delete ComposeReview's ancestor chain; re-point its children at a new
       root id equal to the trace id;
    2. drop spans whose parent lives in the same process (internal spans);
    3. mark every remaining span ``server`` and fabricate a ``client`` copy
       on the parent's process for each non-root span.
    """

    def parent_pid(span_id: SpanId):
        return spans[span_id].process_id if span_id in spans else None

    new_spans = copy.deepcopy(spans)

    def delete_ancestors(span_id: SpanId) -> None:
        if spans[span_id].references:
            delete_ancestors(spans[span_id].references[0])
        del new_spans[span_id]

    for span_id, span in list(spans.items()):
        if span.op_name == "ComposeReview":
            delete_ancestors(span.references[0])
            # children of ComposeReview now reference (trace_id, trace_id)
            for other_id, other in spans.items():
                if other.references and other.references[0] == span_id:
                    new_spans[other_id].references[0] = (other.trace_id, other.trace_id)
            span.sid = span.trace_id
            span.references = []
            new_spans[(span.trace_id, span.sid)] = span
            del new_spans[span_id]

    spans = copy.deepcopy(new_spans)
    for span_id, span in list(spans.items()):
        if span.references:
            pid = parent_pid(span.references[0])
            if pid is not None and pid == span.process_id:
                del new_spans[span_id]

    spans = copy.deepcopy(new_spans)
    fabricated: Dict[SpanId, Span] = {}
    for span in spans.values():
        span.span_kind = "server"
        if span.references:
            clone = copy.deepcopy(span)
            original_ref = copy.deepcopy(span.references)
            span.references[0] = (original_ref[0][0], span.sid + "_client")
            clone.sid = clone.sid + "_client"
            clone.process_id = parent_pid(original_ref[0])
            clone.span_kind = "client"
            clone.references = original_ref
            fabricated[(clone.trace_id, clone.sid)] = clone

    spans.update(fabricated)
    return spans, processes
