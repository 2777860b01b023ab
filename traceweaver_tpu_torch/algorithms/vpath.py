"""Thread-based baselines (vPath, SOSP'09 lineage) (mirrors
``traceweaver_tpu/algorithms/vpath.py``).

- :class:`VPath` — flatten all spans to request/response events, sweep once
  in time order keeping the latest in-flight incoming span; client request
  events attach to it. Mimics inference for thread-serialized processing
  (reference: src/trace_reconstructor/ports/python/algorithms/vpath.py:36-89).
- :class:`VPathOld` — per-endpoint pointer sweep: the next outgoing span
  after each incoming span's start and before the next incoming span's start
  (reference: algorithms/vpath_old.py:1-31).
"""

from __future__ import annotations

from dataclasses import dataclass

from traceweaver_tpu_torch.spans import NA


@dataclass
class _Event:
    trace_id: str
    sid: str
    time_mus: float
    span_kind: str
    event_kind: str  # "request" | "response"
    ep: str
    sort_key: int


class VPath:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes

    def _parent_of(self, trace_id, in_span_partitions):
        for spans in in_span_partitions.values():
            for span in spans:
                if span.trace_id == trace_id:
                    return (span.trace_id, span.sid)
        return None

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments):
        assert len(in_span_partitions) == 1
        events = []
        for ep, spans in in_span_partitions.items():
            for s in spans:
                events.append(_Event(s.trace_id, s.sid, s.start_mus, s.span_kind, "request", ep, 1))
                events.append(_Event(s.trace_id, s.sid, s.start_mus + s.duration_mus, s.span_kind, "response", ep, 4))
        for ep, spans in out_span_partitions.items():
            for s in spans:
                events.append(_Event(s.trace_id, s.sid, s.start_mus, s.span_kind, "request", ep, 2))
                events.append(_Event(s.trace_id, s.sid, s.start_mus + s.duration_mus, s.span_kind, "response", ep, 3))
        events.sort(key=lambda e: (float(e.time_mus), e.sort_key))

        _, in_spans = next(iter(in_span_partitions.items()))
        all_assignments = {
            ep: {(s.trace_id, s.sid): NA for s in in_spans}
            for ep in out_span_partitions
        }

        latest_incoming = None
        for event in events:
            if event.span_kind == "server":
                if event.event_kind == "request":
                    latest_incoming = (event.trace_id, event.sid)
                else:
                    latest_incoming = None
            elif event.span_kind == "client":
                if event.event_kind == "request":
                    if latest_incoming is not None:
                        all_assignments[event.ep][latest_incoming] = (event.trace_id, event.sid)
                else:
                    parent = self._parent_of(event.trace_id, in_span_partitions)
                    if parent is not None:
                        latest_incoming = parent
        return all_assignments


class VPathOld:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments):
        assert len(in_span_partitions) == 1
        for part in in_span_partitions.values():
            part.sort(key=lambda s: float(s.start_mus))
        for part in out_span_partitions.values():
            part.sort(key=lambda s: float(s.start_mus))

        _, in_spans = next(iter(in_span_partitions.items()))
        all_assignments = {
            ep: {(s.trace_id, s.sid): NA for s in in_spans}
            for ep in out_span_partitions
        }

        for ep, out_spans in out_span_partitions.items():
            j = 0
            for i, in_span in enumerate(in_spans):
                while j < len(out_spans) and float(out_spans[j].start_mus) < float(in_span.start_mus):
                    j += 1
                if j >= len(out_spans):
                    break
                is_last = i == len(in_spans) - 1
                if float(out_spans[j].start_mus) >= float(in_span.start_mus) and (
                    is_last or float(out_spans[j].start_mus) < float(in_spans[i + 1].start_mus)
                ):
                    all_assignments[ep][in_span.GetId()] = out_spans[j].GetId()
                    j += 1
        return all_assignments
