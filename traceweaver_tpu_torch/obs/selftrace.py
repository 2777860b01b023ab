"""Self-tracing: the pipeline's own journey as Jaeger JSON (mirrors
``traceweaver_tpu/obs/selftrace.py``).

Every window's journey through the stream (ingest, seal, pack,
dispatch, compaction fetch, redispatch, decode, emit, and any rung of
the solve supervisor: retry, bisect, host, quarantine) is recorded as
spans in the Jaeger-JSON shape the ingest parses
(``{"data": [{traceID, spans, processes}]}``), so the pipeline's own
telemetry can be loaded back with fix mode :data:`SELFTRACE_FIX` and
reconstructed by the solver itself.

Per window, one trace: a root *server* span in service ``tw-window``
covering the journey, and per stage one *client* span in ``tw-window``
calling a *server* span in service ``tw-<stage>``. The stages fan out
under the root instead of nesting, since their intervals follow each
other; so parent-contains-child holds by construction.

The window key travels host-side on ``FleetItem.trace_key`` through the
fleet's pack thread and flow workers, so a stage stamped from any
thread lands on its window's trace. The tracer is lock-guarded;
:func:`active` returns None when none is installed (the default), so a
hook costs one global read. The JAX package installs one from
``TW_SELFTRACE``; the port's stream CLI takes ``--selftrace PATH``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

#: the FIX mode ingest/jaeger.py maps to self-trace payloads
SELFTRACE_FIX = 6
#: required root-span operation name under SELFTRACE_FIX
ROOT_OP = "tw:window"
#: the root span's service (the window's "frontend")
ROOT_SERVICE = "tw-window"

#: canonical stage names, pipeline order (extra stages — ladder rungs —
#: are legal; this is the documentation/order reference)
STAGES = ("ingest", "seal", "pack", "dispatch", "compact-fetch",
          "redispatch", "decode", "emit")


def now_us() -> float:
    """Wall-clock microseconds (the self-trace event-time base: stage
    spans are about when the PIPELINE did the work, so event time and
    processing time coincide)."""
    return time.time() * 1e6


class PipelineTracer:
    """Collects per-window stage spans; builds the Jaeger payload."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> dict(first_us, end_us, stages=[(stage, t0, t1)])
        self._windows: Dict[str, Dict] = {}

    # -- recording --------------------------------------------------------
    def touch(self, key: str, t_us: Optional[float] = None) -> None:
        """First sight of a window (ingest start). Idempotent — only the
        first touch sets the clock."""
        key = str(key)
        with self._lock:
            if key not in self._windows:
                self._windows[key] = dict(
                    first_us=t_us if t_us is not None else now_us(),
                    end_us=None, stages=[])

    def stage(self, key: str, stage: str, t0_us: float,
              t1_us: Optional[float] = None) -> None:
        """Record one stage interval for a window (microseconds, wall).
        Unknown windows are created on the fly (batch callers have no
        ingest/seal phase)."""
        key = str(key)
        if t1_us is None:
            t1_us = now_us()
        t1_us = max(float(t1_us), float(t0_us))
        with self._lock:
            win = self._windows.get(key)
            if win is None:
                win = dict(first_us=float(t0_us), end_us=None, stages=[])
                self._windows[key] = win
            win["stages"].append((str(stage), float(t0_us), float(t1_us)))

    def seal(self, key: str, t_us: Optional[float] = None) -> None:
        """Window sealed: closes the ``ingest`` stage (first touch →
        now) and records the ``seal`` instant."""
        t1 = t_us if t_us is not None else now_us()
        self.touch(key, t1)
        with self._lock:
            first = self._windows[str(key)]["first_us"]
        self.stage(key, "ingest", first, t1)
        self.stage(key, "seal", t1, t1 + 1.0)

    def finish(self, key: str, t_us: Optional[float] = None) -> None:
        """Window emitted: records the ``emit`` instant and closes the
        root span's interval."""
        t1 = t_us if t_us is not None else now_us()
        self.stage(key, "emit", t1, t1 + 1.0)
        with self._lock:
            self._windows[str(key)]["end_us"] = t1 + 1.0

    # -- payload ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._windows)

    def payload(self) -> Dict:
        """The collected journeys as one Jaeger-JSON payload (the exact
        shape ``ingest.jaeger.parse_trace_payload`` takes, fix mode
        ``SELFTRACE_FIX``). Windows with no recorded stages are skipped;
        containment (root ⊇ every stage span, client ⊇ its server span)
        holds by construction."""
        with self._lock:
            windows = {k: (dict(v, stages=list(v["stages"])))
                       for k, v in self._windows.items()}
        data = []
        for key in sorted(windows):
            win = windows[key]
            if not win["stages"]:
                continue
            data.append(self._trace_json(key, win))
        return {"data": data}

    @staticmethod
    def _trace_json(key: str, win: Dict) -> Dict:
        trace_id = "twtrace-" + "".join(
            ch if ch.isalnum() or ch in "._-" else "-" for ch in key)
        # merge repeated stages (a window whose items ride N dispatch
        # groups packs N times; a retried dispatch re-enters) into ONE
        # span per stage name spanning first..last occurrence: the
        # journey stays one candidate per endpoint per window — the
        # well-posed reconstruction problem — while occurrence counts
        # live on the ladder counters/event sink, not the trace shape
        merged: Dict[str, List[float]] = {}
        order: List[str] = []
        for stage, t0, t1 in win["stages"]:
            if stage not in merged:
                merged[stage] = [t0, t1]
                order.append(stage)
            else:
                merged[stage][0] = min(merged[stage][0], t0)
                merged[stage][1] = max(merged[stage][1], t1)
        stages: List[Tuple[str, float, float]] = [
            (s, merged[s][0], merged[s][1]) for s in order]
        lo = min(t0 for _, t0, _ in stages)
        hi = max(t1 for _, _, t1 in stages)
        root_t0 = min(win["first_us"], lo) - 2.0
        root_t1 = (win["end_us"] if win["end_us"] is not None else hi) + 2.0
        root_t1 = max(root_t1, hi + 2.0)

        def span(sid, start, dur, op, refs, pid, kind):
            return dict(
                traceID=trace_id, spanID=sid,
                startTime=float(start), duration=float(max(dur, 1.0)),
                operationName=op,
                references=[{"traceID": trace_id, "spanID": r}
                            for r in refs],
                processID=pid,
                tags=[{"key": "span.kind", "value": kind}])

        spans = [span("root", root_t0, root_t1 - root_t0, ROOT_OP, [],
                      "p-window", "server")]
        processes = {"p-window": {"serviceName": ROOT_SERVICE}}
        for i, (stage, t0, t1) in enumerate(stages):
            pid = "p-" + stage
            processes[pid] = {"serviceName": "tw-" + stage}
            # the client wrapper strictly contains its server span, and
            # the root (padded ±2 µs) strictly contains the client
            spans.append(span(f"c{i}", t0 - 1.0, (t1 - t0) + 2.0,
                              "call-" + stage, ["root"], "p-window",
                              "client"))
            spans.append(span(f"s{i}", t0, t1 - t0, stage, [f"c{i}"],
                              pid, "server"))
        return dict(traceID=trace_id, spans=spans, processes=processes)

    def write(self, path: str) -> int:
        """Write the payload as JSON; returns the trace count."""
        import json
        import os

        payload = self.payload()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
        return len(payload["data"])


_ACTIVE: Optional[PipelineTracer] = None


def install(tracer: Optional[PipelineTracer]) -> Optional[PipelineTracer]:
    """Install (or clear, with None) the process-wide tracer. Returns
    the previous one so scopes can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def active() -> Optional[PipelineTracer]:
    return _ACTIVE
