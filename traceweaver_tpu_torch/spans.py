"""Span data model (mirrors ``traceweaver_tpu/spans.py``).

- :class:`Span` — the per-span host record, with the wire-format id
  ``(trace_id, sid)`` and the reference's tree-navigation helpers.
- :class:`SpanArray` — the columnar partition the packed solve reads:
  float64 start/end columns plus an object id table.

``SKIP`` and ``NA`` are the sentinel assignments shared with the
reference's result format.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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


@dataclass
class SpanArray:
    """Columnar partition: ``start``/``end`` float64 microseconds and
    ``ids`` an object array of ``(trace_id, sid)`` tuples."""

    start: np.ndarray
    end: np.ndarray
    ids: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=object))

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

    def sorted_by_start(self) -> "SpanArray":
        """Stable ascending-start reorder (``sorted(spans, key=start)``)."""
        order = np.argsort(self.start, kind="stable")
        if np.array_equal(order, np.arange(len(self))):
            return self
        return SpanArray(start=self.start[order], end=self.end[order],
                         ids=self.ids[order])

    def __len__(self) -> int:
        return int(self.start.shape[0])
