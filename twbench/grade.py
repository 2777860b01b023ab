"""Grading a round's decoded assignments against the raw spans.

- :func:`truth` joins each incoming span to the outgoing span of its own
  trace on every endpoint, from the trace ids the generator wrote (the
  first match wins, as ``traceweaver_tpu_torch/metrics/accuracy.py
  get_ground_truth``, lines 38-55).
- :func:`accuracy_end_to_end` is a frozen copy of that file's
  ``accuracy_end_to_end`` (lines 128-143): a trace counts only if every
  service got every hop right; a span with no truth on an endpoint has
  SKIP as its answer.
- :func:`decode_faults` counts the answers of one service that no sound
  decode gives: an incoming span with no entry on an endpoint, an answer
  that is neither SKIP, NA (no answer) nor a span of that endpoint, an
  outgoing span given twice. An answer need not lie inside its incoming
  span: a row whose predecessors' answers leave it no feasible column, on
  an endpoint with no skip budget, takes one of its infeasible columns.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from twbench.reference import NA, SKIP


def _span_id(s) -> Tuple[str, str]:
    return (s.trace_id, s.sid)


def truth(in_parts: Dict[str, list], out_parts: Dict[str, list]) -> Dict[str, Dict]:
    (_, in_spans), = in_parts.items()
    out: Dict[str, Dict] = {}
    for ep, spans in out_parts.items():
        by_trace: Dict[str, Tuple[str, str]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, _span_id(s))
        out[ep] = {_span_id(s): by_trace[s.trace_id] for s in in_spans
                   if s.trace_id in by_trace}
    return out


def accuracy_end_to_end(pred_by_process: Dict[str, Dict], true_by_process: Dict[str, Dict],
                        in_spans_by_process: Dict[str, List]) -> float:
    trace_acc: Dict[str, bool] = {}
    for process, true_assignments in true_by_process.items():
        pred = pred_by_process[process]
        for in_span in in_spans_by_process[process]:
            trace_acc.setdefault(in_span.trace_id, True)
            sid = _span_id(in_span)
            for ep in true_assignments:
                if true_assignments[ep].get(sid, SKIP) != pred[ep].get(sid, NA):
                    trace_acc[in_span.trace_id] = False
    return float(sum(trace_acc.values())) / len(trace_acc)


def decode_faults(assignments: Dict[str, Dict], in_parts: Dict[str, list],
                  out_parts: Dict[str, list]) -> int:
    (_, in_spans), = in_parts.items()
    bad = 0
    for ep, spans in out_parts.items():
        got = assignments.get(ep, {})
        by_id = {_span_id(s): s for s in spans}
        used = set()
        for s in in_spans:
            val = got.get(_span_id(s))
            if val == SKIP or val == NA:
                continue
            if val not in by_id or val in used:
                bad += 1
                continue
            used.add(val)
    return bad
