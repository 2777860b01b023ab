"""Ground truth and exact-match accuracy (mirrors
``traceweaver_tpu/metrics/accuracy.py``).

- ground truth by trace-ID join, first match wins;
- per-service accuracy: an incoming span counts only if its prediction
  is right at every outgoing endpoint; a span with no truth entry on an
  endpoint has SKIP as its correct prediction.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceweaver_tpu_torch.spans import NA, SKIP, Span, SpanId


def _truth(true_assignments: Dict, ep: str, in_span_id: SpanId):
    return true_assignments[ep].get(in_span_id, SKIP)


def get_out_eps_in_order(out_span_partitions: Dict[str, List[Span]]) -> List[str]:
    """Endpoints ordered by their first span's start time."""
    eps = []
    for ep, spans in out_span_partitions.items():
        assert len(spans) > 0
        eps.append((ep, spans[0].start_mus))
    eps.sort(key=lambda x: x[1])
    return [ep for ep, _ in eps]


def get_ground_truth(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
) -> Dict[str, Dict[SpanId, SpanId]]:
    """Per-endpoint truth via trace-ID join (first match wins)."""
    assert len(in_span_partitions) == 1
    _, in_spans = next(iter(in_span_partitions.items()))
    true_assignments: Dict[str, Dict[SpanId, SpanId]] = {
        ep: {} for ep in out_span_partitions
    }
    for ep, out_spans in out_span_partitions.items():
        by_trace: Dict[str, SpanId] = {}
        for span in out_spans:
            by_trace.setdefault(span.trace_id, span.GetId())
        for in_span in in_spans:
            if in_span.trace_id in by_trace:
                true_assignments[ep][in_span.GetId()] = by_trace[in_span.trace_id]
    return true_assignments


def _normalize_pred(pred_assignments: Dict, ep: str,
                    in_span_id: SpanId) -> Tuple[bool, object]:
    """Unwrap single-element list predictions; a longer list is wrong and
    a missing entry reads as NA."""
    val = pred_assignments[ep].get(in_span_id, NA)
    if isinstance(val, list):
        if len(val) > 1:
            return False, val
        val = val[0]
        pred_assignments[ep][in_span_id] = val
    return True, val


def _span_results(pred_assignments: Dict, true_assignments: Dict,
                  in_span_partitions: Dict[str, List[Span]]):
    """(incoming span id, right at every endpoint?) per incoming span."""
    assert len(in_span_partitions) == 1
    _, in_spans = next(iter(in_span_partitions.items()))
    for in_span in in_spans:
        correct = True
        for ep in true_assignments:
            ok, val = _normalize_pred(pred_assignments, ep, in_span.GetId())
            correct = correct and ok and val == _truth(
                true_assignments, ep, in_span.GetId())
        yield in_span.GetId(), correct


def span_correctness(
    pred_assignments: Dict,
    true_assignments: Dict,
    in_span_partitions: Dict[str, List[Span]],
) -> Dict[SpanId, bool]:
    """Per incoming span: is its prediction right at every endpoint?"""
    return dict(_span_results(pred_assignments, true_assignments,
                              in_span_partitions))


def accuracy_for_service(
    pred_assignments: Dict,
    true_assignments: Dict,
    in_span_partitions: Dict[str, List[Span]],
) -> float:
    results = [c for _, c in _span_results(pred_assignments, true_assignments,
                                           in_span_partitions)]
    return float(sum(results)) / len(results)
