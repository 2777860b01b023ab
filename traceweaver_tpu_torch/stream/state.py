"""Incremental state for the streaming reconstructor (mirrors
``traceweaver_tpu/stream/state.py``).

Three pieces:

- :class:`LiveTraceStore` — the unbounded-stream replacement for the
  batch loader's :class:`~traceweaver_tpu_torch.spans.TraceStore`: spans are
  folded in one event at a time (private copies — replay never mutates
  the source corpus), parent/child links resolve as both ends arrive
  (with a pending index for children that outrun their parents), and
  spans older than a retention horizon are pruned so memory stays bounded
  by window geometry, not stream length.

- :class:`CarriedState` — per-service GMM/score statistics carried
  between windows. A window solved for a service leaves behind its
  refit distributions; the next window warm-starts from them (a
  single-pass solve) instead of re-fitting from scratch — the streaming
  analogue of the batch path's two-pass EM.

- :class:`StreamGrader` — accumulates owned predictions and span
  partitions across windows so the end-of-stream accuracy is computed
  with the *batch* metrics on the *streamed* assignments, making the
  streamed-vs-batch delta an apples-to-apples number.

Every piece holds host objects only (spans, ``EdgeDist`` numpy
statistics, dicts), so a checkpoint pickles no tensor.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set, Tuple

from traceweaver_tpu_torch.spans import Span, SpanId, TraceStore


class LiveTraceStore(TraceStore):
    """A TraceStore grown incrementally from span events."""

    def __init__(self) -> None:
        super().__init__()
        # children that arrived before their parent: parent_id -> [child_id]
        self._pending_children: Dict[SpanId, List[SpanId]] = {}
        self._spans_by_trace: Dict[str, Set[SpanId]] = {}
        self.n_pruned = 0

    def add(self, event) -> Span:
        """Fold one event in; returns the store's private span copy."""
        # private copy: windows/solves must never mutate the replay
        # corpus's span objects (children links differ between the batch
        # loader's view and the live view)
        span = copy.copy(event.span)
        span.children_spans = []
        sid = span.GetId()
        self.all_spans[sid] = span
        if event.trace_id not in self.all_processes:
            self.all_processes[event.trace_id] = dict(event.processes)
        self._spans_by_trace.setdefault(event.trace_id, set()).add(sid)

        # link to parent (or park in the pending index until it arrives)
        if span.references:
            parent_id = span.references[0]
            parent = self.all_spans.get(parent_id)
            if parent is not None:
                parent.AddChild(sid)
            else:
                self._pending_children.setdefault(parent_id, []).append(sid)
        # adopt any children that arrived first
        for child_id in self._pending_children.pop(sid, []):
            span.AddChild(child_id)
        return span

    # -- endpoint resolution (the live analogues of Span.GetChildProcess /
    # GetParentProcess, returning None instead of asserting when the far
    # end has not arrived or was pruned) --------------------------------
    def child_service_of(self, client_span: Span) -> Optional[str]:
        if len(client_span.children_spans) != 1:
            return None
        child = self.all_spans.get(client_span.children_spans[0])
        if child is None:
            return None
        return self.all_processes.get(child.trace_id, {}).get(
            child.process_id)

    def parent_service_of(self, server_span: Span) -> Optional[str]:
        if server_span.IsRoot():
            return "client_" + str(server_span.op_name)
        parent = self.all_spans.get(server_span.references[0])
        if parent is None:
            return None
        return self.all_processes.get(parent.trace_id, {}).get(
            parent.process_id)

    def service_of(self, span: Span) -> Optional[str]:
        return self.all_processes.get(span.trace_id, {}).get(span.process_id)

    # -- retention --------------------------------------------------------
    def prune(self, before_us: float) -> int:
        """Drop spans that ended before ``before_us`` (and trace tables
        that emptied). Returns how many spans were dropped."""
        dropped = 0
        for tid in list(self._spans_by_trace):
            ids = self._spans_by_trace[tid]
            for sid in list(ids):
                span = self.all_spans.get(sid)
                if span is not None and float(span.end_mus) < before_us:
                    del self.all_spans[sid]
                    ids.discard(sid)
                    dropped += 1
            if not ids:
                del self._spans_by_trace[tid]
                self.all_processes.pop(tid, None)
        # pending links whose parent span would already be past retention
        # can never resolve; let them go with the same horizon
        for pid in list(self._pending_children):
            if pid not in self.all_spans:
                kids = [k for k in self._pending_children[pid]
                        if k in self.all_spans]
                if not kids:
                    del self._pending_children[pid]
        self.n_pruned += dropped
        return dropped


class CarriedState:
    """Per-service statistics carried between windows."""

    def __init__(self) -> None:
        # service -> {edge key -> EdgeDist} from the last refit
        self.dists: Dict[str, Dict[Tuple[str, str], object]] = {}
        self.windows_seen: Dict[str, int] = {}

    def get(self, service: str):
        return self.dists.get(service)

    def update(self, service: str, dists) -> None:
        if dists:
            self.dists[service] = dists
        self.windows_seen[service] = self.windows_seen.get(service, 0) + 1


class StreamGrader:
    """Accumulates streamed outputs for end-of-stream batch-metric
    grading. Ground truth is used for GRADING ONLY — nothing here feeds
    back into the solve."""

    def __init__(self) -> None:
        # service -> in_ep -> [owned in spans]
        self._in_parts: Dict[str, Dict[str, List[Span]]] = {}
        # service -> out_ep -> {span id -> span} (deduped across windows)
        self._out_parts: Dict[str, Dict[str, Dict[SpanId, Span]]] = {}
        # service -> out_ep -> {in id -> out id}
        self.pred: Dict[str, Dict[str, Dict]] = {}
        self._seen_in: Dict[str, Set[SpanId]] = {}
        self.skipped_services: Set[str] = set()

    def accumulate(self, service: str, in_ep: str, owned_in: List[Span],
                   out_parts: Dict[str, List[Span]],
                   pred: Dict[str, Dict]) -> None:
        seen = self._seen_in.setdefault(service, set())
        dst_in = self._in_parts.setdefault(service, {}).setdefault(in_ep, [])
        fresh = [s for s in owned_in if s.GetId() not in seen]
        dst_in.extend(fresh)
        seen.update(s.GetId() for s in fresh)
        dst_out = self._out_parts.setdefault(service, {})
        for ep, spans in out_parts.items():
            d = dst_out.setdefault(ep, {})
            for s in spans:
                d.setdefault(s.GetId(), s)
        dst_pred = self.pred.setdefault(service, {})
        fresh_ids = {s.GetId() for s in fresh}
        for ep, amap in pred.items():
            d = dst_pred.setdefault(ep, {})
            for in_id, out_id in amap.items():
                if in_id in fresh_ids:
                    d[in_id] = out_id

    def finish(self) -> Dict:
        """Batch metrics over the merged streamed output."""
        from traceweaver_tpu_torch.metrics import (
            accuracy_end_to_end,
            accuracy_for_service,
            get_ground_truth,
        )

        per_service: Dict[str, float] = {}
        true_by: Dict[str, Dict] = {}
        pred_by: Dict[str, Dict] = {}
        in_spans_by: Dict[str, List[Span]] = {}
        for svc, in_parts in self._in_parts.items():
            if len(in_parts) != 1:
                # the service saw different upstream endpoints in
                # different windows; the batch metrics cannot grade it
                self.skipped_services.add(svc)
                continue
            out_parts = {
                ep: sorted(d.values(),
                           key=lambda s: (s.start_mus, s.end_mus))
                for ep, d in self._out_parts.get(svc, {}).items()
            }
            if not out_parts:
                self.skipped_services.add(svc)
                continue
            (in_ep, in_spans), = in_parts.items()
            in_spans = sorted(in_spans, key=lambda s: (s.start_mus,
                                                       s.end_mus))
            if not in_spans:
                continue
            truth = get_ground_truth({in_ep: in_spans}, out_parts)
            pred = self.pred.get(svc, {})
            pred = {ep: dict(pred.get(ep, {})) for ep in out_parts}
            per_service[svc] = accuracy_for_service(
                pred, truth, {in_ep: in_spans})
            true_by[svc] = truth
            pred_by[svc] = pred
            in_spans_by[svc] = in_spans
        if true_by:
            _, e2e = accuracy_end_to_end(pred_by, true_by, in_spans_by)
        else:
            e2e = 0.0
        return dict(per_service=per_service, e2e=e2e * 100.0,
                    skipped_services=sorted(self.skipped_services))
