"""Span event sources for the streaming reconstructor (mirrors
``traceweaver_tpu/stream/sources.py``).

A source is anything that yields :class:`SpanEvent` in *arrival* order.
:class:`ReplaySource` turns a recorded corpus (any directory
:func:`~traceweaver_tpu_torch.ingest.load_corpus` reads) into a
timestamped stream, optionally with deterministic out-of-order arrival
jitter, so the watermark and late-span paths run as a collector fan-in
would drive them; :class:`IterableSource` takes any list of events.

Replay is deterministic for a given ``(corpus, ooo_us, seed)``: the same
spec yields the same events in the same order. The checkpoints rely on
it: a resumed run skips the first ``consumed`` events instead of
persisting spans already folded into windows.

``collector:`` specs build the capture ingress
(:class:`~traceweaver_tpu_torch.collector.source.CollectorSource`): spans
recovered from ``strace`` captures of uninstrumented services. The port
adds ``synth:adapt-burst``, the shifted burst corpus of
:mod:`traceweaver_tpu_torch.synth.capture`, so the adaptation ladder runs
through the stream CLI.
"""

from __future__ import annotations

import random
import urllib.parse
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from traceweaver_tpu_torch.spans import Span, TraceStore


@dataclass
class SpanEvent:
    """One span arriving at the reconstructor.

    ``event_us`` is event time (the span's start, when the call
    happened); ``arrival_us`` is when the collector delivered it; the gap
    is what the watermark bounds. ``processes`` is the owning trace's
    ``process_id -> service`` table. ``capture_us`` is the raw capture
    stamp of a capture-derived span; None on replay sources.
    """

    span: Span
    event_us: float
    arrival_us: float
    trace_id: str
    processes: Dict[str, str]
    capture_us: Optional[float] = None


class ReplaySource:
    """Replay a loaded :class:`TraceStore` as an arrival-ordered stream.

    ``ooo_us > 0`` delays each span by a seeded uniform jitter in
    ``[0, ooo_us)`` and re-sorts by arrival: spans reach the service out
    of event-time order, bounded by ``ooo_us``, which a watermark with
    ``bound_us >= ooo_us`` covers.
    """

    def __init__(self, store: TraceStore, ooo_us: float = 0.0,
                 seed: int = 0) -> None:
        self.store = store
        self.ooo_us = float(ooo_us)
        self.seed = int(seed)
        self._events: List[SpanEvent] = self._build()

    def _build(self) -> List[SpanEvent]:
        spans = sorted(
            self.store.all_spans.values(),
            key=lambda s: (float(s.start_mus), s.trace_id, s.sid),
        )
        rng = np.random.default_rng(self.seed)
        jitter = (rng.uniform(0.0, self.ooo_us, size=len(spans))
                  if self.ooo_us > 0 else np.zeros(len(spans)))
        events = [
            SpanEvent(
                span=s,
                event_us=float(s.start_mus),
                arrival_us=float(s.start_mus) + float(j),
                trace_id=s.trace_id,
                processes=self.store.all_processes.get(s.trace_id, {}),
            )
            for s, j in zip(spans, jitter)
        ]
        events.sort(key=lambda e: (e.arrival_us, e.trace_id, e.span.sid))
        return events

    def __len__(self) -> int:
        return len(self._events)

    def events(self, skip: int = 0) -> Iterator[SpanEvent]:
        """Yield events in arrival order, skipping the first ``skip`` (a
        resume fast-forwards through the events already consumed)."""
        return iter(self._events[skip:])

    @classmethod
    def from_directory(cls, path: str, fix: int, max_traces: int = 1000,
                       ooo_us: float = 0.0, seed: int = 0,
                       strict: bool = False) -> "ReplaySource":
        from traceweaver_tpu_torch.ingest import load_corpus

        # the load must repeat across processes: Alibaba self-loops get
        # synthetic "<random>-loop" service names from the global RNG,
        # and a resumed process must mint the names its checkpoint holds
        # (the batch executor seeds 10 before its load too)
        random.seed(10)
        store = load_corpus(path, fix=fix, max_traces=max_traces,
                            cache=False, strict=strict)
        return cls(store, ooo_us=ooo_us, seed=seed)


class IterableSource:
    """Any iterable of SpanEvents, already in arrival order;
    ``events(skip=n)`` drops the first n (resume of a deterministic
    iterable)."""

    def __init__(self, events: Iterable[SpanEvent]) -> None:
        self._events = list(events)
        self.store: Optional[TraceStore] = None

    def __len__(self) -> int:
        return len(self._events)

    def events(self, skip: int = 0) -> Iterator[SpanEvent]:
        return iter(self._events[skip:])


#: ``synth:adapt-burst`` query keys
_ADAPT_BURST_KEYS = ("n_bursts", "shift_at", "n_req")


def parse_source_spec(spec: str, fix: int = 0, max_traces: int = 1000,
                      ooo_us: float = 0.0, seed: int = 0,
                      strict: bool = False):
    """Parse a ``--source`` spec into a source.

    ``replay:<dir>`` replays a recorded Jaeger-style corpus; query keys
    ``fix``, ``max_traces``, ``ooo_ms`` / ``ooo_us`` and ``seed``
    override the arguments::

        replay:/abs/path?fix=5&ooo_ms=50&seed=3

    ``collector:<path|fifo>`` is the capture ingress: ``<path>`` is one
    recorded ``strace -f -ttt`` log (one capture source), a directory of
    per-source logs (``*.log``/``*.txt``/``*.strace``, one clock each;
    cross-source skew is fitted and corrected), or a FIFO fed by a live
    ``strace`` (single-source incremental mode). Query key ``service``
    names a single file's service (default: the file stem). The replay
    arguments do not apply: arrival order comes from the capture.

    ``synth:adapt-burst?n_bursts=60&shift_at=30[&n_req=8]`` streams
    :func:`~traceweaver_tpu_torch.synth.capture.adapt_burst_events`.
    """
    if spec.startswith("collector:"):
        from traceweaver_tpu_torch.collector.source import CollectorSource

        path, _, query = spec[len("collector:"):].partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        return CollectorSource.from_spec(path, service=params.get("service"))
    if spec.startswith("synth:"):
        name, _, query = spec[len("synth:"):].partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        unknown = set(params) - set(_ADAPT_BURST_KEYS)
        if name != "adapt-burst" or unknown or not {"n_bursts", "shift_at"} <= set(params):
            raise ValueError(
                f"source {spec!r}: expected 'synth:adapt-burst?n_bursts=N&"
                "shift_at=K[&n_req=R]'")
        from traceweaver_tpu_torch.synth.capture import adapt_burst_events

        events, _ = adapt_burst_events(**{k: int(v) for k, v in params.items()})
        return IterableSource(events)
    if not spec.startswith("replay:"):
        raise ValueError(
            f"unknown source spec {spec!r}: expected 'replay:<corpus-dir>' "
            "(a recorded Jaeger corpus), 'collector:<strace-log|dir|fifo>' "
            "(the capture ingress) or 'synth:adapt-burst?...'; in-process "
            "streams plug in through stream.sources.IterableSource")
    rest = spec[len("replay:"):]
    path, _, query = rest.partition("?")
    params = dict(urllib.parse.parse_qsl(query))
    if "fix" in params:
        fix = int(params["fix"])
    if "max_traces" in params:
        max_traces = int(params["max_traces"])
    if "ooo_us" in params:
        ooo_us = float(params["ooo_us"])
    elif "ooo_ms" in params:
        ooo_us = float(params["ooo_ms"]) * 1000.0
    if "seed" in params:
        seed = int(params["seed"])
    return ReplaySource.from_directory(path, fix=fix, max_traces=max_traces,
                                       ooo_us=ooo_us, seed=seed, strict=strict)
