"""Jaeger-JSON trace ingestion (mirrors ``traceweaver_tpu/ingest/jaeger.py``).

- per-file parsing of Jaeger's ``{"data": [{traceID, spans, processes}]}``
  into :class:`~traceweaver_tpu_torch.spans.Span` objects;
- the per-dataset ``FIX`` repair modes (0=nodejs, 1=media, 2/3=hotel,
  4=todo-app, 5=Alibaba, 6=the JAX package's self-trace);
- Alibaba-mode client/server span-id rewriting, self-loop remapping to
  synthetic ``*-loop`` services named by the global ``random`` (the
  JAX package's draws, in its order), and parent-contains-child time
  validation (violating traces dropped);
- the time-ordered directory listing with its on-disk cache (the same
  file name, so either package reads the other's);
- corpus assembly into a :class:`~traceweaver_tpu_torch.spans.TraceStore`.

Two parsing front ends feed one semantic core (:func:`_finish_trace`):
the C++ loader (:mod:`traceweaver_tpu_torch.native`, the default), which
parses files in parallel off the interpreter lock and hands back interned
arrays, and the pure-Python ``json`` path (``native=False``). The
repair shims and every step that draws from ``random`` stay in Python and
run in the same order on both, so their stores are equal. Malformed span
records are skipped and counted unless ``strict``, by either front end.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import string
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

from traceweaver_tpu_torch import native as native_mod
from traceweaver_tpu_torch.ingest import repair
from traceweaver_tpu_torch.spans import Span, SpanId, TraceStore

# FIX mode -> required root-span operation name. ``None`` (Alibaba) means
# "ingest every trace" (reference executor.py:756-762). Mode 6 takes the
# JAX package's self-trace payloads, rooted at a ``tw:window`` span with
# no repair and no Alibaba remapping.
FIX_ROOT_OPS: Dict[int, Optional[str]] = {
    0: "init-span",
    1: "ComposeReview",
    2: "HTTP GET /hotels",
    3: "HTTP GET /recommendations",
    4: "[Todo] CompleteTodoCommandHandler",
    5: None,
    6: "tw:window",
}


def _random_id(n: int = 16, suffix: str = "", rng=None) -> str:
    """A random id (the self-loop services' names), drawn from ``rng``
    (a :class:`random.Random`) or the global RNG."""
    alphabet = string.ascii_letters + string.digits
    choice = (rng or random).choice
    return "".join(choice(alphabet) for _ in range(n)) + suffix


class MalformedSpan(ValueError):
    """A span record that cannot be parsed (missing ids/timestamps/refs,
    non-numeric durations). By default malformed records are
    skipped-and-counted (``ingest_malformed_spans`` on the store — a
    dead-letter counter, so a flaky exporter cannot abort a whole corpus
    load mid-stream); ``strict=True`` (the CLI's ``--strict``) restores
    the raise."""


# ---------------------------------------------------------------------------
# Directory listing, time-ordered (reference executor.py:287-339)
# ---------------------------------------------------------------------------

def _root_start_time(path: str, native: bool = True) -> float:
    """The sort key of the time-ordered listing: the start time of the
    first trace's root span, +inf without one or when the file does not
    parse; from the C++ loader unless ``native`` is False."""
    if native:
        return native_mod.root_start_time(path)
    try:
        with open(path, "r") as f:
            data = json.load(f).get("data", [])
    except (json.JSONDecodeError, OSError):
        return float("inf")
    if not data:
        return float("inf")
    spans = data[0].get("spans", [])
    root = next((s for s in spans if len(s.get("references", [])) == 0), None)
    if root is None:
        return float("inf")
    return float(root["startTime"])


def time_ordered_trace_files(directory: str, clear_cache: bool = False,
                             cache: bool = True,
                             native: bool = True) -> List[str]:
    """List ``*.json`` files in ``directory`` sorted by root-span start time.

    With ``cache=True`` an existing ``time_order_filenames.pickle`` alongside
    the data is reused if its entries resolve on this machine (same cache
    file name as the reference, executor.py:320-339, so a cache the
    reference wrote is read here). ``clear_cache`` skips reading it. The
    port never writes the cache: loading does not mutate a dataset
    directory. ``native`` picks the front end of the sort key, as in
    :func:`load_corpus`; both give the same order.
    """
    _check_native(native)
    cache_path = Path(directory) / "time_order_filenames.pickle"
    if cache and not clear_cache and cache_path.exists():
        try:
            with open(cache_path, "rb") as f:
                files = pickle.load(f)
            # Shipped datasets carry caches with the original author's
            # absolute paths; only trust a cache whose entries exist here.
            if files and all(os.path.exists(f) for f in files[:3]):
                return files
        except (pickle.UnpicklingError, EOFError, OSError):
            pass

    files = sorted(
        os.path.join(os.path.abspath(directory), f)
        for f in os.listdir(directory)
        if f.endswith("json") and os.path.isfile(os.path.join(directory, f))
    )
    files.sort(key=lambda f: _root_start_time(f, native))
    return files


# ---------------------------------------------------------------------------
# Span-level parsing (reference executor.py:342-488)
# ---------------------------------------------------------------------------

class RawSpan(NamedTuple):
    """One span record, built from a JSON dict."""

    trace_id: str
    sid: str
    start_mus: float
    duration_mus: float
    op_name: Optional[str]
    refs: Tuple[SpanId, ...]    # full references list, in order
    process_id: str
    span_kind: Optional[str]    # "client" | "server" | None
    caller: Optional[str]       # Alibaba converter fields
    callee: Optional[str]
    tags: object = None


def _records_to_spans(
    records: List[RawSpan],
    self_loop_map: Dict[str, List[str]],
    service_loop_map: Dict[str, str],
    alibaba: bool,
    rng=None,
) -> Optional[Tuple[Dict[SpanId, Span], List[str]]]:
    """Build Span objects from one trace's records. Returns
    ``(spans, final_process_ids)`` — the per-record process ids after
    Alibaba self-loop remapping (they seed the identity process table) —
    or None if the trace is dropped.

    In Alibaba mode: client span ids get a ``.client`` suffix and server
    spans are re-parented onto the suffixed client id (executor.py:377-384);
    self-calls (caller==callee) are remapped onto a synthetic
    ``<random>-loop`` service shared across traces via ``self_loop_map``
    (executor.py:386-399); parent⊇child time containment is validated from
    the root and the whole trace is dropped on violation
    (executor.py:433-448).
    """
    spans: Dict[SpanId, Span] = {}
    final_pids: List[str] = []
    overall_trace_id = None

    for rec in records:
        trace_id = rec.trace_id
        sid = rec.sid
        process_id = rec.process_id
        references: List[SpanId] = list(rec.refs)

        if overall_trace_id is None:
            overall_trace_id = trace_id
        elif trace_id != overall_trace_id:
            raise ValueError("Different trace ids for spans in the same trace")

        if alibaba:
            if rec.span_kind == "client":
                sid = sid + ".client"
            if rec.span_kind == "server" and len(references) == 1:
                # The Alibaba converter emits a server+client record pair per
                # call sharing one spanID: the server half's parent is its own
                # id's client half (executor.py:382-384).
                references[0] = (references[0][0], sid + ".client")
            # Self-loop calls: remap the callee (and the server span's
            # process) onto a stable synthetic "-loop" service.
            if rec.caller is not None and rec.caller == rec.callee:
                sanitized = sid[:-7] if sid.endswith(".client") else sid
                if sanitized not in self_loop_map:
                    new_callee = _random_id(suffix="-loop", rng=rng)
                    self_loop_map[sanitized] = [rec.callee, new_callee]
                    service_loop_map[new_callee] = rec.callee
                if rec.span_kind == "server":
                    process_id = self_loop_map[sanitized][1]

        final_pids.append(process_id)
        spans[(trace_id, sid)] = Span(
            trace_id=trace_id,
            sid=sid,
            start_mus=rec.start_mus,
            duration_mus=rec.duration_mus,
            op_name=rec.op_name,
            references=references,
            process_id=process_id,
            span_kind=rec.span_kind,
            tags=rec.tags,
        )

    if not alibaba:
        return spans, final_pids

    # Alibaba mode: link children temporarily, validate containment, and
    # propagate self-loop process ids down to descendant client spans.
    children: Dict[SpanId, List[SpanId]] = {}
    for span_id, span in spans.items():
        if not span.IsRoot():
            children.setdefault(span.references[0], []).append(span_id)
    for parent_id, kids in children.items():
        if parent_id in spans:
            for kid in kids:
                spans[parent_id].AddChild(kid)

    def check_containment(span: Span) -> bool:
        for child_id in span.children_spans:
            child = spans[child_id]
            if not (span.start_mus <= child.start_mus
                    and span.end_mus >= child.end_mus):
                return False
            if not check_containment(child):
                return False
        return True

    root = next((s for s in spans.values() if s.IsRoot()), None)
    if root is not None and not check_containment(root):
        return None

    def update_descendant_clients(span: Span) -> None:
        for child_id in span.children_spans:
            child = spans[child_id]
            if child.span_kind == "client":
                child.process_id = spans[(span.trace_id, span.sid)].process_id
            update_descendant_clients(child)

    def walk(span: Span) -> None:
        sanitized = span.sid[:-7] if span.sid.endswith(".client") else span.sid
        if sanitized in self_loop_map:
            update_descendant_clients(span)
        for child_id in span.children_spans:
            walk(spans[child_id])

    if root is not None:
        walk(root)

    for span in spans.values():
        span.children_spans = []
    return spans, final_pids


def _record_from_json(rec: dict) -> RawSpan:
    span_kind = None
    for tag in rec.get("tags", []):
        if tag.get("key") == "span.kind":
            span_kind = tag.get("value")
    try:
        refs = tuple(
            (ref["traceID"], ref["spanID"])
            for ref in rec.get("references", [])
        )
        trace_id = rec["traceID"]
        sid = rec["spanID"]
        start_mus = rec["startTime"]
        duration_mus = rec["duration"]
        process_id = rec["processID"]
    except (KeyError, TypeError) as e:
        raise MalformedSpan(
            f"span record missing required field: {e}") from None
    try:
        float(start_mus)
        float(duration_mus)
    except (TypeError, ValueError):
        raise MalformedSpan(
            f"span {sid!r}: non-numeric startTime/duration "
            f"({start_mus!r}, {duration_mus!r})") from None
    return RawSpan(
        trace_id=trace_id,
        sid=sid,
        start_mus=start_mus,
        duration_mus=duration_mus,
        op_name=rec.get("requestType", rec.get("operationName")),
        refs=refs,
        process_id=process_id,
        span_kind=span_kind,
        caller=rec.get("caller"),
        callee=rec.get("callee"),
        tags=rec.get("tags"),
    )


def _assemble_trace(
    records: List[RawSpan],
    fix: int,
    self_loop_map: Dict[str, List[str]],
    service_loop_map: Dict[str, str],
    raw_processes: Dict[str, str],
    rng=None,
) -> Optional[Tuple[Dict[SpanId, Span], Dict[str, str], bool]]:
    """Post-parse pipeline for one trace: record→Span conversion, process-table construction, fix-mode repair,
    root detection. ``raw_processes`` is the file's pid→service table
    (ignored for Alibaba-format traces, whose process ids double as service
    names post self-loop remap, executor.py:484-488). Returns
    ``(spans, processes, has_root)`` or None when the trace is dropped.
    """
    alibaba = FIX_ROOT_OPS[fix] is None
    parsed = _records_to_spans(records, self_loop_map, service_loop_map,
                               alibaba, rng=rng)
    if parsed is None:
        return None
    spans, final_pids = parsed
    # The Alibaba converter emits caller/callee/requestType together
    # (reference real-parser.py:308-359), so caller presence detects the
    # converted format.
    alibaba_format = bool(records) and records[0].caller is not None
    if alibaba_format:
        processes = {pid: pid for pid in final_pids}
    else:
        processes = raw_processes
    if fix == 0:
        spans = repair.fix_nodejs(spans, processes)
    elif fix == 1:
        spans, processes = repair.fix_media(spans, processes)
    has_root = any(s.IsRoot() for s in spans.values())
    return spans, processes, has_root


# ---------------------------------------------------------------------------
# Trace-level parsing (reference executor.py:755-793)
# ---------------------------------------------------------------------------

def parse_trace_payload(
    payload: dict,
    fix: int,
    self_loop_map: Dict[str, List[str]],
    service_loop_map: Dict[str, str],
    strict: bool = False,
    counters: Optional[Dict[str, int]] = None,
    rng=None,
) -> List[Optional[Tuple[str, Dict[SpanId, Span], Dict[str, str]]]]:
    """Parse one Jaeger-JSON payload (``{"data": [...]}``), the core of
    :func:`parse_trace_file`.

    Returns one entry per ``data`` element: ``(trace_id, spans,
    processes)`` for a rooted trace, or None when the trace was dropped
    (time-containment violation in Alibaba mode, or no root span).
    Malformed span records (missing ids/refs/timestamps, non-numeric
    durations) are skipped and counted under
    ``counters["malformed_spans"]`` — a dead-letter counter, never a
    mid-stream crash; ``strict=True`` restores the raise. ``rng`` (a
    :class:`random.Random`) draws the Alibaba self-loop services' ids in
    place of the global RNG (the serve tier gives each tenant its own).
    """
    if not isinstance(payload, dict) or not isinstance(
            payload.get("data"), list):
        raise MalformedSpan(
            "payload is not a Jaeger-JSON trace object "
            "({'data': [{traceID, spans, processes}]})")
    results: List[Optional[Tuple[str, Dict[SpanId, Span],
                                 Dict[str, str]]]] = []
    for trace_json in payload["data"]:
        try:
            trace_id = trace_json["traceID"]
            span_records = trace_json["spans"]
        except (KeyError, TypeError):
            if strict:
                raise MalformedSpan(
                    "trace object missing traceID/spans") from None
            _count(counters, "malformed_traces")
            results.append(None)
            continue
        records = []
        for rec in span_records:
            try:
                records.append(_record_from_json(rec))
            except MalformedSpan:
                if strict:
                    raise
                _count(counters, "malformed_spans")
        raw_processes = {
            pid: entry["serviceName"]
            for pid, entry in trace_json.get("processes", {}).items()
        }
        results.append(_finish_trace(trace_id, records, raw_processes, fix,
                                     self_loop_map, service_loop_map,
                                     counters, rng=rng))
    return results


def _count(counters: Optional[Dict[str, int]], key: str) -> None:
    if counters is not None:
        counters[key] = counters.get(key, 0) + 1


def _finish_trace(trace_id, records, raw_processes, fix, self_loop_map,
                  service_loop_map, counters, rng=None):
    """One trace's parsed records through :func:`_assemble_trace`:
    ``(trace_id, spans, processes)``, or None for a dropped trace (an
    Alibaba-mode time-containment violation, counted apart from rootless
    traces: the file loader treats a drop as poisoning its whole file)
    or a rootless one."""
    assembled = _assemble_trace(records, fix, self_loop_map,
                                service_loop_map, raw_processes, rng=rng)
    if assembled is None:
        _count(counters, "dropped_traces")
        return None
    spans, processes, has_root = assembled
    if not has_root:
        _count(counters, "rootless_traces")
        return None
    return trace_id, spans, processes


def _file_result(parsed, counters, dropped_before: int, path: str):
    """A file's one rooted trace, or None when one of its traces was
    dropped (the reference's per-file semantics, executor.py:433-448)."""
    if counters.get("dropped_traces", 0) > dropped_before:
        return None
    results = [p for p in parsed if p is not None]
    assert len(results) == 1, f"expected exactly one rooted trace in {path}"
    return results[0]


def parse_trace_file(
    path: str,
    fix: int,
    self_loop_map: Dict[str, List[str]],
    service_loop_map: Dict[str, str],
    strict: bool = False,
    counters: Optional[Dict[str, int]] = None,
) -> Optional[Tuple[str, Dict[SpanId, Span], Dict[str, str]]]:
    """Parse one trace file. Returns (trace_id, spans, processes) or None
    if the trace was dropped (time-containment violation in Alibaba mode).

    Malformed span records (missing ids/refs/timestamps, non-numeric
    durations) are skipped and counted under ``counters["malformed_spans"]``
    — a dead-letter counter, never a mid-stream crash; ``strict=True``
    restores the raise (the CLI's ``--strict``).
    """
    with open(path, "r") as f:
        payload = json.load(f)

    c = counters if counters is not None else {}
    dropped_before = c.get("dropped_traces", 0)
    parsed = parse_trace_payload(payload, fix, self_loop_map,
                                 service_loop_map, strict=strict,
                                 counters=c)
    return _file_result(parsed, c, dropped_before, path)


# ---------------------------------------------------------------------------
# Corpus assembly (reference executor.py:798-874)
# ---------------------------------------------------------------------------

def ingest_trace(
    store: TraceStore,
    trace_id: str,
    spans: Dict[SpanId, Span],
    processes: Dict[str, str],
    fix: int,
) -> int:
    """Add one parsed trace to the store if its root matches the FIX mode's
    root operation. Returns 1 if ingested, else 0 (executor.py:798-849).
    """
    first_span = FIX_ROOT_OPS[fix]

    root_span_id = None
    for span_id, span in spans.items():
        if span.IsRoot():
            root_span_id = span_id
        for parent_id in span.references:
            spans[parent_id].AddChild(span.GetId())
    for span in spans.values():
        span.children_spans.sort(key=lambda cid: spans[cid].start_mus)

    if root_span_id is None:
        return 0
    if first_span is not None and spans[root_span_id].op_name != first_span:
        return 0

    def add_span(span_id: SpanId) -> None:
        span = spans[span_id]
        service = processes[span.process_id]
        if span.span_kind == "client":
            store.out_spans_by_process.setdefault(service, []).append(span)
        elif span.span_kind == "server":
            store.in_spans_by_process.setdefault(service, []).append(span)
        else:
            raise ValueError(f"span {span_id} has kind {span.span_kind!r}")
        for child in span.children_spans:
            add_span(child)

    add_span(root_span_id)
    store.all_spans.update(spans)
    store.all_processes[trace_id] = processes
    return 1


#: files parsed per native batch: bounds the DOM and corpus memory while
#: keeping the loader's thread pool busy
_NATIVE_CHUNK = 512


def _check_native(native: bool) -> None:
    # a JAX-style "auto"/"never" string would read as true: refuse it
    if not isinstance(native, bool):
        raise ValueError(f"native={native!r}: expected True or False")


def _native_file_traces(nc, paths, fix, self_loop_map, service_loop_map,
                        strict, counters):
    """Yield each file of a native corpus as :func:`parse_trace_file`
    returns it: ``(trace_id, spans, processes)``, or None for a file
    that lost a trace to a containment drop. Records the loader flagged
    malformed are skipped and counted (or raise under ``strict``) where
    the Python front end does, in the same order."""
    strings = nc.strings
    procs_by_trace = nc.processes_by_trace()
    per_file: List[List[int]] = [[] for _ in range(nc.n_files)]
    for t, f in enumerate(nc.trace_file.tolist()):
        per_file[f].append(t)
    # Python lists: one conversion, then plain indexing per span
    start, duration = nc.start.tolist(), nc.duration.tolist()
    trace, sid, process = nc.trace.tolist(), nc.sid.tolist(), nc.process.tolist()
    op, kind = nc.op.tolist(), nc.kind.tolist()
    caller, callee = nc.caller.tolist(), nc.callee.tolist()
    bad_span, bad_trace = nc.span_malformed.tolist(), nc.trace_malformed.tolist()
    offsets, trace_id = nc.trace_offsets.tolist(), nc.trace_id.tolist()
    ref_offsets = nc.ref_offsets.tolist()
    ref_pairs = [(strings[a], strings[b])
                 for a, b in zip(nc.ref_trace.tolist(), nc.ref_sid.tolist())]

    def opt(idx):
        return strings[idx] if idx >= 0 else None

    for file_idx, traces in enumerate(per_file):
        dropped_before = counters.get("dropped_traces", 0)
        parsed = []
        for t in traces:
            if bad_trace[t]:
                if strict:
                    raise MalformedSpan("trace object missing traceID/spans")
                _count(counters, "malformed_traces")
                parsed.append(None)
                continue
            records = []
            for i in range(offsets[t], offsets[t + 1]):
                if bad_span[i]:
                    if strict:
                        raise MalformedSpan(
                            f"span record {i - offsets[t]} of trace "
                            f"{strings[trace_id[t]]!r} in {paths[file_idx]}: "
                            "missing or non-numeric required field")
                    _count(counters, "malformed_spans")
                    continue
                records.append(RawSpan(
                    trace_id=strings[trace[i]],
                    sid=strings[sid[i]],
                    start_mus=int(start[i]),
                    duration_mus=int(duration[i]),
                    op_name=opt(op[i]),
                    refs=tuple(ref_pairs[ref_offsets[i]:ref_offsets[i + 1]]),
                    process_id=strings[process[i]],
                    span_kind=opt(kind[i]),
                    caller=opt(caller[i]),
                    callee=opt(callee[i]),
                ))
            parsed.append(_finish_trace(strings[trace_id[t]], records,
                                        procs_by_trace.get(t, {}), fix,
                                        self_loop_map, service_loop_map,
                                        counters))
        yield _file_result(parsed, counters, dropped_before, paths[file_idx])


def _parsed_files(files, fix, self_loop_map, store, strict, use_native,
                  budget):
    """Each file's :func:`parse_trace_file` result, in order. The native
    front end parses ``_NATIVE_CHUNK`` files at a time, and no more than
    ``budget()`` (the traces still wanted) plus slack, so ``max_traces``
    stops both front ends at the same trace."""
    counters = store.ingest_counters
    if not use_native:
        for path in files:
            yield parse_trace_file(path, fix, self_loop_map,
                                   store.service_loop_map, strict=strict,
                                   counters=counters)
        return
    start = 0
    while start < len(files):
        size = min(_NATIVE_CHUNK, max(budget() + 8, 16))
        chunk = files[start:start + size]
        start += size
        yield from _native_file_traces(
            native_mod.parse_files(chunk), chunk, fix, self_loop_map,
            store.service_loop_map, strict, counters)


def load_corpus(
    directory: str,
    fix: int,
    max_traces: int = 1000,
    clear_cache: bool = False,
    cache: bool = True,
    native: bool = True,
    strict: bool = False,
) -> TraceStore:
    """Load a directory of Jaeger-JSON traces into a TraceStore and build
    its per-service columns.

    ``max_traces`` is the reference's cap (``if cnt > 1000: break``: up
    to ``max_traces + 1`` traces ingested). ``native``: True (the
    default) parses with the C++ loader, False with Python's ``json``;
    both give equal stores, and ``store.ingest_front_end`` ("native" or
    "python") says which ran. The JAX package's ``"auto"`` falls back to
    Python; this one never does: a loader that fails to build or to
    parse raises :class:`~traceweaver_tpu_torch.native.NativeLoaderError`.
    ``strict``: malformed span records raise (:class:`MalformedSpan`)
    instead of the default skip-and-count; either way the count lands on
    ``store.ingest_malformed_spans``.
    """
    _check_native(native)
    store = TraceStore()
    store.ingest_front_end = "native" if native else "python"
    self_loop_map: Dict[str, List[str]] = {}
    files = time_ordered_trace_files(directory, clear_cache=clear_cache,
                                     cache=cache, native=native)
    cnt = 0
    for parsed in _parsed_files(files, fix, self_loop_map, store, strict,
                                native,
                                budget=lambda: max_traces + 1 - cnt):
        if parsed is None:
            continue
        trace_id, spans, processes = parsed
        cnt += ingest_trace(store, trace_id, spans, processes, fix)
        if cnt > max_traces:
            break
    store.build_columns()
    return store
