"""Bounded per-tenant ring of recently emitted traces (mirrors
``traceweaver_tpu/serve/ring.py``).

The live query surface (``GET .../query/delay_culprit``, trace
fetch/list) runs against this ring, not against the sink file: a serving
deployment answers "who is slow right now" from the most recent traces,
and the ring bound is what keeps a tenant's query state O(ring), not
O(stream). Eviction is strictly oldest-first and counted
(``evicted``), so "the query window covers the last N traces" is an
auditable statement, not an approximation.

Records are plain JSON-serializable dicts (the HTTP layer returns them
verbatim and checkpoints pickle them), built by
:func:`build_trace_records` from a window's stitched traces plus the
tenant's live span store. Each span entry carries its *self* time —
duration minus its children's durations — which is what makes the
delay-culprit attribution charge latency to the service that spent it
rather than to every frontend that contained it
(:func:`traceweaver_tpu_torch.query.delay_culprit.live_delay_culprit`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional


class TraceRing:
    """Insertion-ordered bounded map of ``trace_id -> record``."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self.evicted = 0

    def add(self, record: dict) -> None:
        """Insert one emitted-trace record; a re-emitted trace id (a
        window re-solved across a resume splice) replaces its previous
        record in place instead of double-counting."""
        tid = record["trace_id"]
        if tid in self._records:
            del self._records[tid]
        self._records[tid] = record
        while len(self._records) > self.capacity:
            self._records.popitem(last=False)
            self.evicted += 1

    def get(self, trace_id: str) -> Optional[dict]:
        return self._records.get(trace_id)

    def ids(self) -> List[str]:
        """Trace ids, oldest first."""
        return list(self._records)

    def records(self) -> List[dict]:
        """Records, oldest first (the live query's input)."""
        return list(self._records.values())

    def load(self, records: List[dict]) -> None:
        """Bulk restore (checkpoint resume): replay through :meth:`add`
        so the bound and eviction accounting hold on the resumed ring."""
        for rec in records:
            self.add(rec)

    def __len__(self) -> int:
        return len(self._records)


def build_trace_records(traces: Dict[str, List], live,
                        window_k: int,
                        confidence: Optional[Dict] = None) -> List[dict]:
    """Turn one emitted window's stitched traces into ring records.

    ``traces`` is the window's ``trace_id -> [span ids]`` map
    (:meth:`~traceweaver_tpu_torch.stream.service.StreamingReconstructor._stitch`);
    ``live`` is the tenant's
    :class:`~traceweaver_tpu_torch.stream.state.LiveTraceStore`. Spans already
    pruned from the live store are skipped and the record marked
    ``complete: False`` so the query layer can exclude partial traces the
    same way the reference excludes traces with unreconstructed hops.

    ``confidence`` (``{span id: quality record}`` —
    :mod:`traceweaver_tpu_torch.obs.quality`) attaches each trace's
    ``tw.confidence`` summary, which the low-confidence query sorts by
    and the delay-culprit bracket can filter on.
    """
    from traceweaver_tpu_torch.obs import quality as _quality

    records = []
    for tid, span_ids in sorted(traces.items()):
        spans, missing = [], 0
        id_set = set(span_ids)
        for sid in span_ids:
            span = live.all_spans.get(sid)
            if span is None:
                missing += 1
                continue
            child_dur = sum(
                float(live.all_spans[c].duration_mus)
                for c in span.children_spans
                if c in id_set and c in live.all_spans
            )
            spans.append(dict(
                sid=list(sid),
                service=live.service_of(span) or "",
                kind=span.span_kind,
                start_us=float(span.start_mus),
                dur_us=float(span.duration_mus),
                self_us=max(0.0, float(span.duration_mus) - child_dur),
            ))
        if not spans:
            continue
        spans.sort(key=lambda s: (s["start_us"], s["sid"]))
        start = min(s["start_us"] for s in spans)
        end = max(s["start_us"] + s["dur_us"] for s in spans)
        rec = dict(
            trace_id=tid,
            window=window_k,
            root_start_us=start,
            e2e_us=end - start,
            n_spans=len(spans),
            complete=missing == 0,
            spans=spans,
        )
        if confidence:
            tconf = _quality.trace_confidence(span_ids, confidence)
            if tconf is not None:
                rec["tw.confidence"] = tconf
        records.append(rec)
    return records
