"""Columnar wire ingest of the serve tier's span POSTs (mirrors
``traceweaver_tpu/ingest/wire.py``; ``TW_WIRE_COLUMNAR``, on by default
there, is the serve tier's ``columnar=True`` here).

An accepted Jaeger-JSON POST body is parsed straight into per-trace
column batches instead of one :class:`~traceweaver_tpu_torch.spans.Span`
per record up front:

- **native front end** (default): the body goes to the C++ loader's
  ``tw_parse_payload`` (``traceweaver_tpu_torch/native/src/loader.cc``),
  which returns interned struct-of-arrays span data with no Python JSON
  parse. The port's loader flags malformed records instead of failing
  the payload; a payload with any flagged record (or one the loader
  cannot parse at all) goes to the pure-Python front end below, as the
  JAX loader's fail-fast does, so dead-letter accounting has one
  implementation;
- **pure-Python front end** (a body the loader refused, or a dict
  payload): one ``json.loads`` and the object parser's own
  ``_record_from_json`` a span, the same acceptance and the same
  skip-and-count of malformed spans.

Both land in one assembler that replicates the object pipeline's
per-trace semantics (Alibaba ``.client`` rewrites, duplicate span ids in
dict-insertion order, time-containment drops, rootless drops) over plain
index arrays, and mints Span objects (:meth:`Span.fast`, ``tags=None``)
only for accepted traces (:meth:`WireTrace.materialize`).

:func:`parse_payload_wire` returns None (the caller runs the object
parser, counted ``path=object``) for a payload it does not carry: fix 0
or 1 (the repair shims walk Span objects), strict ingestion, Alibaba
converter records (any ``caller`` field: self-loop remapping draws
random ids in one place) and Alibaba mode with a non-empty
``self_loop_map``. Counters are committed only when the wire parse is
used. A failed build or ``dlopen`` of the loader raises, as everywhere
in the port.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from traceweaver_tpu_torch import native as native_mod
from traceweaver_tpu_torch.ingest.jaeger import (
    FIX_ROOT_OPS,
    MalformedSpan,
    RawSpan,
    _record_from_json,
)
from traceweaver_tpu_torch.obs.registry import serve_families
from traceweaver_tpu_torch.spans import Span, SpanId

#: which parse engine handled a columnar payload: either the native
#: loader engaged or the Python front end was counted
_OBS_WIRE_ENGINE = serve_families()["wire_engine"]


class WireTrace:
    """One accepted-shape wire trace, assembled but not materialized.

    Holds the post-rewrite per-record data (final span ids, references,
    process ids) plus the duplicate-resolved key order — everything the
    serve admission filter needs (:attr:`has_root`, :attr:`root_op`)
    without constructing a single Span. :meth:`materialize` builds the
    ``(trace_id, spans, processes)`` tuple the object parser would have
    returned, and is called only for traces that pass the root-op
    filter."""

    __slots__ = ("trace_id", "has_root", "root_op", "n_spans",
                 "_recs", "_final", "_idx_of", "_processes")

    def __init__(self, trace_id: str, recs: List[RawSpan],
                 final: List[Tuple[str, str, List[SpanId], str]],
                 idx_of: Dict[SpanId, int],
                 processes: Dict[str, str]) -> None:
        self.trace_id = trace_id
        self._recs = recs
        self._final = final
        self._idx_of = idx_of
        self._processes = processes
        self.n_spans = len(idx_of)
        # first final span in dict-insertion order with no references —
        # the exact span `next((s for s in spans.values() if s.IsRoot()),
        # None)` finds on the object path
        self.has_root = False
        self.root_op: Optional[str] = None
        for i in idx_of.values():
            if not final[i][2]:
                self.has_root = True
                self.root_op = recs[i].op_name
                break

    def materialize(self) -> Tuple[str, Dict[SpanId, Span],
                                   Dict[str, str]]:
        """Build the object parser's ``(trace_id, spans, processes)``
        for this trace — Span objects minted here and only here, via
        :meth:`Span.fast` (``tags=None``)."""
        spans: Dict[SpanId, Span] = {}
        recs, final = self._recs, self._final
        for key, i in self._idx_of.items():
            tid, sid, refs, pid = final[i]
            rec = recs[i]
            spans[key] = Span.fast(tid, sid, rec.start_mus,
                                   rec.duration_mus, rec.op_name, refs,
                                   pid, rec.span_kind)
        return self.trace_id, spans, self._processes


class _CorpusCols:
    """Whole-corpus Python-list views of a :class:`NativeCorpus` — one
    ``tolist`` per column, shared by every :class:`WireTraceCols` slice
    of the payload — plus the lazily grouped per-trace processes table
    (only accepted traces ever need it)."""

    __slots__ = ("strings", "start", "dur", "trace", "sid", "op", "pid",
                 "kind", "ref_offsets", "ref_trace", "ref_sid", "_nc",
                 "_procs")

    def __init__(self, nc) -> None:
        self.strings = nc.strings
        self.start = nc.start.tolist()
        self.dur = nc.duration.tolist()
        self.trace = nc.trace.tolist()
        self.sid = nc.sid.tolist()
        self.op = nc.op.tolist()
        self.pid = nc.process.tolist()
        self.kind = nc.kind.tolist()
        self.ref_offsets = nc.ref_offsets.tolist()
        self.ref_trace = nc.ref_trace.tolist()
        self.ref_sid = nc.ref_sid.tolist()
        self._nc = nc
        self._procs: Optional[Dict[int, Dict[str, str]]] = None

    def processes(self, t: int) -> Dict[str, str]:
        if self._procs is None:
            self._procs = self._nc.processes_by_trace()
        return self._procs.get(t, {})


class WireTraceCols:
    """Fast-path wire trace: a ``[lo, hi)`` slice view over the shared
    corpus columns, minted only after the whole payload passed the
    vectorized anomaly sweep (uniform per-trace ids, unique span ids,
    no missing ``processID``, non-Alibaba fix) — so no per-span Python
    work happened to build it. Same accepted-trace surface as
    :class:`WireTrace`; only rooted traces are constructed at all."""

    __slots__ = ("trace_id", "has_root", "root_op", "n_spans",
                 "_cols", "_t", "_lo", "_hi")

    def __init__(self, cols: _CorpusCols, t: int, lo: int, hi: int,
                 trace_id: str, root_op: Optional[str]) -> None:
        self.trace_id = trace_id
        self.has_root = True
        self.root_op = root_op
        self.n_spans = hi - lo
        self._cols = cols
        self._t = t
        self._lo = lo
        self._hi = hi

    def materialize(self) -> Tuple[str, Dict[SpanId, Span],
                                   Dict[str, str]]:
        c = self._cols
        strings = c.strings
        trace, sid_c, op_c = c.trace, c.sid, c.op
        pid_c, kind_c = c.pid, c.kind
        start, dur = c.start, c.dur
        ro, rt, rs = c.ref_offsets, c.ref_trace, c.ref_sid
        fast = Span.fast
        spans: Dict[SpanId, Span] = {}
        for i in range(self._lo, self._hi):
            tid = strings[trace[i]]
            sid = strings[sid_c[i]]
            opx, kx = op_c[i], kind_c[i]
            refs = [(strings[rt[j]], strings[rs[j]])
                    for j in range(ro[i], ro[i + 1])]
            spans[(tid, sid)] = fast(
                tid, sid, start[i], dur[i],
                strings[opx] if opx >= 0 else None, refs,
                strings[pid_c[i]], strings[kx] if kx >= 0 else None)
        return self.trace_id, spans, c.processes(self._t)


def _bump(counters: Dict[str, int], key: str) -> None:
    counters[key] = counters.get(key, 0) + 1


def _assemble_wire(
    trace_id: str,
    recs: List[RawSpan],
    alibaba: bool,
    raw_processes: Dict[str, str],
) -> Optional[WireTrace]:
    """The shared per-trace assembler: Alibaba client/server rewrites,
    duplicate-key resolution, containment validation — the column-path
    mirror of ``_records_to_spans`` + ``_assemble_trace`` for
    caller-free traces (converter payloads never reach here). Returns
    None when the trace is dropped on a containment violation."""
    overall: Optional[str] = None
    # key -> record index: first-occurrence position, last record wins —
    # the dict-insertion semantics of the object path's spans dict
    idx_of: Dict[SpanId, int] = {}
    final: List[Tuple[str, str, List[SpanId], str]] = []
    for i, rec in enumerate(recs):
        tid, sid = rec.trace_id, rec.sid
        refs: List[SpanId] = list(rec.refs)
        if overall is None:
            overall = tid
        elif tid != overall:
            raise ValueError(
                "Different trace ids for spans in the same trace")
        if alibaba:
            if rec.span_kind == "client":
                sid = sid + ".client"
            if rec.span_kind == "server" and len(refs) == 1:
                refs[0] = (refs[0][0], sid + ".client")
        idx_of[(tid, sid)] = i
        final.append((tid, sid, refs, rec.process_id))

    if alibaba and idx_of:
        # parent ⊇ child time containment from the first root, over the
        # FINAL (duplicate-resolved) spans — iterative, same verdict as
        # the object path's recursion
        children: Dict[SpanId, List[SpanId]] = {}
        for key, i in idx_of.items():
            refs = final[i][2]
            if refs and refs[0] in idx_of:
                children.setdefault(refs[0], []).append(key)
        root_key = next((k for k, i in idx_of.items() if not final[i][2]),
                        None)

        def check_containment(key: SpanId) -> bool:
            # raw-value comparisons in the object path's exact order
            # (string-typed times that float()-coerce still TypeError
            # here, same as Span.start_mus comparisons would)
            i = idx_of[key]
            s_start = recs[i].start_mus
            s_dur = recs[i].duration_mus
            for child_key in children.get(key, ()):
                j = idx_of[child_key]
                c_start = recs[j].start_mus
                c_dur = recs[j].duration_mus
                if not (s_start <= c_start
                        and s_start + s_dur >= c_start + c_dur):
                    return False
                if not check_containment(child_key):
                    return False
            return True

        if root_key is not None and not check_containment(root_key):
            return None  # dropped trace

    return WireTrace(trace_id, recs, final, idx_of, raw_processes)


def _entries_native_fast(nc, counters: Dict[str, int]
                         ) -> Optional[List[Optional[WireTraceCols]]]:
    """The zero-object fast path over a natively parsed non-Alibaba
    payload: a handful of whole-corpus numpy sweeps decide eligibility
    and find every trace's root, then one tiny Python loop mints slice
    views (:class:`WireTraceCols`) for the rooted traces — no per-span
    Python touches at all. Returns None when the payload shows any
    anomaly the object pipeline handles record-by-record (a span with
    ``processID`` missing, duplicate span ids, mixed trace ids inside
    one entry); the careful per-record assembler then takes over with
    its exact skip/raise semantics."""
    t = nc.n_traces
    if t == 0:
        return []
    n = nc.n_spans
    offs = nc.trace_offsets
    counts = np.diff(offs)
    if n:
        # per-entry trace-id uniformity: every span's traceID equals its
        # entry's first span's (the object path raises ValueError on the
        # first offending entry — the careful path owns that ordering)
        first = nc.trace[np.minimum(offs[:-1], n - 1)]
        if not np.array_equal(nc.trace,
                              np.repeat(first, counts)):
            return None
        # span-id uniqueness per entry: duplicates engage the object
        # path's dict-insertion (first position, last value wins) rules
        seg = np.repeat(np.arange(t, dtype=np.int64), counts)
        pair = seg * len(nc.strings) + nc.sid
        if np.unique(pair).size != n:
            return None
    # first reference-free span per entry, in record order — the exact
    # root the object path's next(s for s in spans.values() if IsRoot())
    # finds once ids are unique
    root_idx = np.full(t, -1, np.int64)
    if n:
        root_pos = np.flatnonzero(np.diff(nc.ref_offsets) == 0)
        seg_of_root = np.searchsorted(offs, root_pos, side="right") - 1
        segs, firsts = np.unique(seg_of_root, return_index=True)
        root_idx[segs] = root_pos[firsts]
        root_ops = np.where(root_idx >= 0,
                            nc.op[np.maximum(root_idx, 0)], -1).tolist()
    else:
        root_ops = [-1] * t
    root_idx_l = root_idx.tolist()
    offs_l = offs.tolist()
    tid_idx = nc.trace_id.tolist()
    strings = nc.strings
    cols = _CorpusCols(nc)
    entries: List[Optional[WireTraceCols]] = []
    n_rootless = 0
    for i in range(t):
        if root_idx_l[i] < 0:
            n_rootless += 1
            entries.append(None)
            continue
        ox = root_ops[i]
        entries.append(WireTraceCols(
            cols, i, offs_l[i], offs_l[i + 1], strings[tid_idx[i]],
            strings[ox] if ox >= 0 else None))
    if n_rootless:
        counters["rootless_traces"] = (
            counters.get("rootless_traces", 0) + n_rootless)
    return entries


def _entries_from_native(nc, fix: int, counters: Dict[str, int]
                         ) -> List[Optional[WireTrace]]:
    """Assemble every trace of a natively parsed payload that holds no
    flagged record (:func:`parse_payload_wire` routes any other to the
    Python front end)."""
    alibaba = FIX_ROOT_OPS[fix] is None
    if not alibaba:
        entries = _entries_native_fast(nc, counters)
        if entries is not None:
            return entries
    strings = nc.strings
    procs_by_trace = nc.processes_by_trace()
    entries: List[Optional[WireTrace]] = []
    ref_offsets = nc.ref_offsets.tolist()
    ref_trace = nc.ref_trace.tolist()
    ref_sid = nc.ref_sid.tolist()
    trace_offsets = nc.trace_offsets.tolist()
    for t in range(nc.n_traces):
        lo, hi = trace_offsets[t], trace_offsets[t + 1]
        starts = nc.start[lo:hi].tolist()
        durs = nc.duration[lo:hi].tolist()
        tids = nc.trace[lo:hi].tolist()
        sids = nc.sid[lo:hi].tolist()
        ops = nc.op[lo:hi].tolist()
        pids = nc.process[lo:hi].tolist()
        kinds = nc.kind[lo:hi].tolist()
        recs: List[RawSpan] = []
        for i in range(hi - lo):
            pidx = pids[i]
            rlo, rhi = ref_offsets[lo + i], ref_offsets[lo + i + 1]
            opx, kx = ops[i], kinds[i]
            recs.append(RawSpan(
                trace_id=strings[tids[i]], sid=strings[sids[i]],
                start_mus=starts[i], duration_mus=durs[i],
                op_name=strings[opx] if opx >= 0 else None,
                refs=tuple((strings[ref_trace[j]], strings[ref_sid[j]])
                           for j in range(rlo, rhi)),
                process_id=strings[pidx],
                span_kind=strings[kx] if kx >= 0 else None,
                caller=None, callee=None))
        wt = _assemble_wire(strings[nc.trace_id[t]], recs, alibaba,
                            procs_by_trace.get(t, {}))
        if wt is None:
            _bump(counters, "dropped_traces")
            entries.append(None)
        elif not wt.has_root:
            _bump(counters, "rootless_traces")
            entries.append(None)
        else:
            entries.append(wt)
    return entries


def _entries_from_dict(payload: dict, fix: int,
                       counters: Dict[str, int]
                       ) -> Optional[List[Optional[WireTrace]]]:
    """The pure-Python front-end: same scaffolding as
    ``parse_trace_payload`` (shape check, per-trace malformed counters)
    but assembling :class:`WireTrace` columns instead of Span objects.
    Returns None (fall back to the object parser) when a converter
    record (``caller`` field) shows up."""
    if not isinstance(payload, dict) or not isinstance(
            payload.get("data"), list):
        raise MalformedSpan(
            "payload is not a Jaeger-JSON trace object "
            "({'data': [{traceID, spans, processes}]})")
    alibaba = FIX_ROOT_OPS[fix] is None
    entries: List[Optional[WireTrace]] = []
    for trace_json in payload["data"]:
        try:
            trace_id = trace_json["traceID"]
            span_records = trace_json["spans"]
        except (KeyError, TypeError):
            _bump(counters, "malformed_traces")
            entries.append(None)
            continue
        recs: List[RawSpan] = []
        for rec in span_records:
            try:
                recs.append(_record_from_json(rec))
            except MalformedSpan:
                _bump(counters, "malformed_spans")
        if any(r.caller is not None for r in recs):
            return None  # converter payload: object parser owns it
        raw_processes = {
            pid: entry["serviceName"]
            for pid, entry in trace_json.get("processes", {}).items()
        }
        wt = _assemble_wire(trace_id, recs, alibaba, raw_processes)
        if wt is None:
            _bump(counters, "dropped_traces")
            entries.append(None)
        elif not wt.has_root:
            _bump(counters, "rootless_traces")
            entries.append(None)
        else:
            entries.append(wt)
    return entries


def parse_payload_wire(
    payload,
    fix: int,
    self_loop_map: Dict[str, List[str]],
    strict: bool = False,
    counters: Optional[Dict[str, int]] = None,
) -> Optional[List[Optional[WireTrace]]]:
    """Parse one posted Jaeger-JSON payload (``bytes`` straight off the
    wire, or an already-decoded dict) into :class:`WireTrace` entries —
    one per ``data`` element, ``None`` for dropped/rootless/malformed
    traces, mirroring ``parse_trace_payload``'s result shape.

    Returns ``None`` when the payload is not columnar-eligible (see
    module docstring); the caller then runs the object parser. Dead
    letters are accumulated locally and committed into ``counters``
    only when the wire parse is actually used, so a fallback never
    double-counts."""
    if strict or fix in (0, 1):
        return None
    alibaba = FIX_ROOT_OPS[fix] is None
    if alibaba and self_loop_map:
        return None

    local: Dict[str, int] = {}
    entries: Optional[List[Optional[WireTrace]]] = None
    engine = "python"
    try:
        if isinstance(payload, (bytes, bytearray)):
            raw = bytes(payload)
            nc = native_mod.parse_payload(raw)
            if nc is not None and (nc.span_malformed.any() or nc.trace_malformed.any()):
                # a flagged record: the Python front end owns dead letters
                # (the JAX loader fails such a payload outright)
                nc = None
            if nc is not None:
                if nc.caller.size and int(nc.caller.max()) >= 0:
                    return None  # converter payload
                engine = "native"
                entries = _entries_from_native(nc, fix, local)
            else:
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError as e:
                    raise MalformedSpan(f"invalid JSON: {e}") from None
                entries = _entries_from_dict(payload, fix, local)
        else:
            entries = _entries_from_dict(payload, fix, local)
    except Exception:
        # mixed trace ids, a malformed shape, or untyped-garbage time
        # fields mid-assembly: the object path commits counters
        # incrementally, so the dead letters counted before the raise
        # must land even though the parse failed
        if counters is not None:
            for k, v in local.items():
                counters[k] = counters.get(k, 0) + v
        raise
    if entries is None:
        return None
    if counters is not None:
        for k, v in local.items():
            counters[k] = counters.get(k, 0) + v
    _OBS_WIRE_ENGINE.inc(1.0, engine=engine)
    return entries
