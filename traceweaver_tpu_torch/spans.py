"""Span data model (mirrors ``traceweaver_tpu/spans.py``).

- :class:`Span` — the per-span host record, with the wire-format id
  ``(trace_id, sid)`` and the reference's tree-navigation helpers.
- :class:`SpanArray` — the columnar partition the packed solve reads:
  float64 start/end columns plus an object id table.
- :class:`TraceStore` — every parsed span of a corpus and the per-trace
  process tables, with per-service columns built at load.

``SKIP`` and ``NA`` are the sentinel assignments shared with the
reference's result format.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SpanId = Tuple[str, str]  # (trace_id, span_id)

NA = ("NA", "NA")
SKIP = ("Skip", "Skip")


@dataclass(eq=False)
class Span:
    """One RPC span (the server or the client half of a call).

    Times are microseconds since epoch. ``eq=False`` keeps identity
    equality and hashing, as the algorithms key sets by span object.
    """

    trace_id: str
    sid: str
    start_mus: float
    duration_mus: float
    op_name: Optional[str]
    references: List[SpanId]
    process_id: str
    span_kind: Optional[str]  # "server" | "client"
    tags: object = None

    def __post_init__(self) -> None:
        self.children_spans: List[SpanId] = []
        self.ep: Optional[str] = None

    @classmethod
    def fast(cls, trace_id: str, sid: str, start_mus: float,
             duration_mus: float, op_name: Optional[str],
             references: List[SpanId], process_id: str,
             span_kind: Optional[str]) -> "Span":
        """The constructor with ``tags=None``, filling ``__dict__``
        directly."""
        s = cls.__new__(cls)
        s.__dict__ = {
            "trace_id": trace_id, "sid": sid, "start_mus": start_mus,
            "duration_mus": duration_mus, "op_name": op_name,
            "references": references, "process_id": process_id,
            "span_kind": span_kind, "tags": None,
            "children_spans": [], "ep": None}
        return s

    def GetId(self) -> SpanId:
        return (self.trace_id, self.sid)

    def IsRoot(self) -> bool:
        return len(self.references) == 0

    @property
    def end_mus(self) -> float:
        return self.start_mus + self.duration_mus

    def AddChild(self, child_span_id: SpanId) -> None:
        self.children_spans.append(child_span_id)

    def GetChildProcess(self, all_processes, all_spans) -> str:
        """Service at the callee end of a client span."""
        assert self.span_kind == "client"
        assert len(self.children_spans) == 1
        child = all_spans[self.children_spans[0]]
        return all_processes[self.trace_id][child.process_id]

    def GetParentProcess(self, all_processes, all_spans) -> str:
        """Service at the caller end of a server span; root spans get a
        synthetic ``client_<op>`` caller."""
        if self.IsRoot():
            return "client_" + str(self.op_name)
        assert len(self.references) == 1
        parent = all_spans[self.references[0]]
        return all_processes[self.trace_id][parent.process_id]

    def __lt__(self, other: "Span") -> bool:
        return self.start_mus < other.start_mus

    def __repr__(self) -> str:
        return "Span:(%s, %s, %s, %s, %s, %s)" % (
            self.trace_id, self.sid, self.op_name,
            self.start_mus, self.duration_mus, self.span_kind,
        )


def make_skip_span(sid: str) -> Span:
    """Placeholder for a skipped (cache-served) call: ``trace_id ==
    "None"`` marks it and the time fields are NaN."""
    return Span("None", sid, float("nan"), float("nan"), None, [], "None",
                None, None)


def is_skip_span(span: Span) -> bool:
    return span.trace_id == "None"


def skip_span_wire(span: Span) -> Dict[str, object]:
    """The reference's wire shape of a skip span: NaN times become the
    string ``"None"``."""
    def wire(v):
        return "None" if isinstance(v, float) and math.isnan(v) else v

    return dict(
        trace_id=span.trace_id, sid=span.sid,
        start_mus=wire(float(span.start_mus)),
        duration_mus=wire(float(span.duration_mus)),
        op_name=span.op_name, references=list(span.references),
        process_id=span.process_id, span_kind=span.span_kind,
    )


@dataclass
class SpanArray:
    """Columnar partition: ``start``/``end`` float64 microseconds and
    ``ids`` an object array of ``(trace_id, sid)`` tuples; ``service``
    (int32 indices into ``service_table``) is set by
    :meth:`TraceStore.build_columns`."""

    start: np.ndarray
    end: np.ndarray
    ids: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=object))
    service: Optional[np.ndarray] = None
    service_table: Optional[List[str]] = None

    @classmethod
    def from_spans(cls, spans: Sequence[Span]) -> "SpanArray":
        n = len(spans)
        start = np.fromiter((s.start_mus for s in spans),
                            dtype=np.float64, count=n)
        end = start + np.fromiter((s.duration_mus for s in spans),
                                  dtype=np.float64, count=n)
        ids = np.empty(n, dtype=object)
        ids[:] = [(s.trace_id, s.sid) for s in spans]
        return cls(start=start, end=end, ids=ids)

    @property
    def trace_ids(self) -> np.ndarray:
        out = np.empty(len(self), dtype=object)
        out[:] = [i[0] for i in self.ids]
        return out

    @property
    def sids(self) -> np.ndarray:
        out = np.empty(len(self), dtype=object)
        out[:] = [i[1] for i in self.ids]
        return out

    def _reordered(self, order: np.ndarray) -> "SpanArray":
        if np.array_equal(order, np.arange(len(self))):
            return self
        return self.take(order)

    def sorted_by_start(self) -> "SpanArray":
        """Stable ascending-start reorder (``sorted(spans, key=start)``)."""
        return self._reordered(np.argsort(self.start, kind="stable"))

    def sorted_by_start_end(self) -> "SpanArray":
        """Stable ``(start, end)`` reorder, the partition sort order."""
        return self._reordered(np.lexsort((self.end, self.start)))

    def take(self, idx: np.ndarray) -> "SpanArray":
        return SpanArray(
            start=self.start[idx], end=self.end[idx], ids=self.ids[idx],
            service=None if self.service is None else self.service[idx],
            service_table=self.service_table)

    def __len__(self) -> int:
        return int(self.start.shape[0])


class TraceStore:
    """Every parsed span of a corpus and the per-trace process tables
    (the reference executor's global ``all_spans`` / ``all_processes``)."""

    def __init__(self) -> None:
        self.all_spans: Dict[SpanId, Span] = {}
        # trace_id -> {process_id -> service name}
        self.all_processes: Dict[str, Dict[str, str]] = {}
        # service name -> [Span] (server spans / client spans)
        self.in_spans_by_process: Dict[str, List[Span]] = {}
        self.out_spans_by_process: Dict[str, List[Span]] = {}
        # synthetic "-loop" service -> original service (Alibaba self-calls)
        self.service_loop_map: Dict[str, str] = {}
        # ingest dead-letter counters (malformed spans, dropped traces)
        self.ingest_counters: Dict[str, int] = {}
        # which parser load_corpus ran: "native" (the C++ loader) or "python"
        self.ingest_front_end: Optional[str] = None
        # ground-truth-free invocation DAGs, discovered once per service
        # (process -> DAG), and each discovery's seconds and solves
        self.discovered_dags: Dict[str, object] = {}
        self.discovery_stats: Dict[str, Dict[str, float]] = {}
        # per service {"in": SpanArray, "out": SpanArray}, from build_columns
        self.columns: Dict[str, Dict[str, SpanArray]] = {}

    @property
    def ingest_malformed_spans(self) -> int:
        """Span records dropped as malformed during ingestion."""
        return self.ingest_counters.get("malformed_spans", 0)

    def services(self) -> List[str]:
        return list(self.out_spans_by_process.keys())

    def build_columns(self) -> Dict[str, Dict[str, SpanArray]]:
        """One ``{"in": ..., "out": ...}`` pair of columns per service, in
        list order, with the service id column attached."""
        service_table = sorted(set(self.in_spans_by_process)
                               | set(self.out_spans_by_process))
        sid_of = {s: i for i, s in enumerate(service_table)}
        self.columns = {}
        for svc in service_table:
            cols = {}
            for key, spans in (
                ("in", self.in_spans_by_process.get(svc, [])),
                ("out", self.out_spans_by_process.get(svc, [])),
            ):
                arr = SpanArray.from_spans(spans)
                arr.service = np.full(len(arr), sid_of[svc], dtype=np.int32)
                arr.service_table = service_table
                cols[key] = arr
            self.columns[svc] = cols
        return self.columns
