"""Ground truth and exact-match accuracy (mirrors
``traceweaver_tpu/metrics/accuracy.py``).

- ground truth by trace-ID join, first match wins;
- per-service accuracy: an incoming span counts only if its prediction
  is right at every outgoing endpoint; a span with no truth entry on an
  endpoint has SKIP as its correct prediction;
- top-k variants, end-to-end accuracy (a trace counts only if every
  service got every hop right), accuracy in response-time percentile
  bins, and the end-to-end trace lists of the ``e2e_*`` result pickles.
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


def topk_accuracy_for_service(
    pred_topk_assignments: Dict,
    true_assignments: Dict,
    in_span_partitions: Dict[str, List[Span]],
) -> float:
    assert len(in_span_partitions) == 1
    _, in_spans = next(iter(in_span_partitions.items()))
    ep0 = next(iter(true_assignments))
    cnt = 0
    for in_span in in_spans:
        sid = in_span.GetId()
        opts0 = pred_topk_assignments[ep0].get(sid) or [NA]
        for i in range(len(opts0)):
            correct = all(
                (pred_topk_assignments[ep].get(sid) or [NA])[i:i + 1] == [_truth(true_assignments, ep, sid)]
                for ep in true_assignments
            )
            if correct:
                cnt += 1
                break
    return float(cnt) / len(in_spans)


def accuracy_end_to_end(
    pred_assignments_by_process: Dict[str, Dict],
    true_assignments_by_process: Dict[str, Dict],
    in_spans_by_process: Dict[str, List[Span]],
) -> Tuple[Dict[str, bool], float]:
    trace_acc: Dict[str, bool] = {}
    for process in true_assignments_by_process:
        true_assignments = true_assignments_by_process[process]
        pred_assignments = pred_assignments_by_process[process]
        for in_span in in_spans_by_process[process]:
            trace_acc.setdefault(in_span.trace_id, True)
            for ep in true_assignments:
                if _truth(true_assignments, ep, in_span.GetId()) != pred_assignments[ep].get(in_span.GetId(), NA):
                    trace_acc[in_span.trace_id] = False
    correct = sum(trace_acc.values())
    return trace_acc, float(correct) / len(trace_acc)


def topk_accuracy_end_to_end(
    pred_topk_assignments_by_process: Dict[str, Dict],
    true_assignments_by_process: Dict[str, Dict],
    in_spans_by_process: Dict[str, List[Span]],
) -> Tuple[Dict[str, bool], float]:
    trace_acc: Dict[str, bool] = {}
    for i, process in enumerate(true_assignments_by_process):
        true_assignments = true_assignments_by_process[process]
        pred_topk = pred_topk_assignments_by_process[process]
        ep0 = next(iter(true_assignments))
        for in_span in in_spans_by_process[process]:
            sid = in_span.GetId()
            if i != 0 and trace_acc.get(in_span.trace_id) is False:
                continue
            options = pred_topk[ep0].get(sid) or []
            if len(options) < 1:
                trace_acc[in_span.trace_id] = False
                continue
            for j in range(len(options)):
                trace_acc[in_span.trace_id] = all(
                    [_truth(true_assignments, ep, sid)]
                    == (pred_topk[ep].get(sid) or [NA])[j:j + 1]
                    for ep in true_assignments
                )
                if trace_acc[in_span.trace_id]:
                    break
    correct = sum(trace_acc.values())
    return trace_acc, float(correct) / len(trace_acc)


def bin_accuracy_by_response_times(
    trace_acc: Dict[str, bool], all_spans: Dict[SpanId, Span], nbins: int = 10
) -> List[Tuple[float, float, float]]:
    """Accuracy per response-time percentile bin: (percentile, acc, ms)."""
    all_traces = []
    for span in all_spans.values():
        if span.IsRoot():
            all_traces.append(
                (span.duration_mus, span.trace_id, int(trace_acc[span.trace_id]), 1)
            )
    all_traces.sort()
    for i in range(1, len(all_traces)):
        _, _, c, n = all_traces[i - 1]
        t0, s0, c0, n0 = all_traces[i]
        all_traces[i] = (t0, s0, c + c0, n + n0)
    prev_c, prev_n = 0, 0
    out = []
    for b in range(nbins):
        d, _, c, n = all_traces[int((len(all_traces) * (b + 1)) / nbins - 1)]
        c, n = c - prev_c, n - prev_n
        prev_c, prev_n = prev_c + c, prev_n + n
        out.append(((b + 1) * 100 / nbins, c / n, d / 1000.0))
    return out


def construct_end_to_end_traces(
    pred_assignments_by_process: Dict[str, Dict],
    true_assignments_by_process: Dict[str, Dict],
    in_spans_by_process: Dict[str, List[Span]],
    all_spans: Dict[SpanId, Span],
) -> Tuple[Dict[str, List], Dict[str, List]]:
    """Assemble per-trace lists of (true, predicted) spans for the query
    engine; missing predictions become None entries (utils.py:216-252)."""
    true_traces: Dict[str, List] = {}
    pred_traces: Dict[str, List] = {}
    for process in true_assignments_by_process:
        true_assignments = true_assignments_by_process[process]
        pred_assignments = pred_assignments_by_process[process]
        for in_span in in_spans_by_process[process]:
            tid = in_span.trace_id
            if tid not in pred_traces:
                true_traces[tid] = []
                pred_traces[tid] = []
            for ep in true_assignments:
                true_traces[tid].append(all_spans.get(true_assignments[ep][in_span.GetId()]))
                options = pred_assignments[ep].get(in_span.GetId())
                if isinstance(options, list):
                    for option in options:
                        pred_traces[tid].append(all_spans.get(option))
                else:
                    pred_traces[tid].append(all_spans.get(options))
    for traces in (true_traces, pred_traces):
        for tid in traces:
            traces[tid].sort(key=lambda s: float("inf") if s is None else s.start_mus)
    return true_traces, pred_traces
