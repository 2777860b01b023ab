"""Capture ingress: the collector → stream bridge (docs/COLLECTOR.md).

Closes the capture-to-trace loop: recorded ``strace``
logs (or replayed eBPF event streams) from *uninstrumented* processes
run through the offline collector pipeline — syscall reassembly
(:mod:`.strace`), HTTP/2+HPACK replay (:mod:`.http2`) — incrementally,
and every completed request/response exchange becomes one timed span
event the streaming reconstructor consumes
(:class:`~traceweaver_tpu_torch.stream.sources.SpanEvent`). The stream CLI
reaches it as ``--source collector:<path|fifo>``; the serve layer as
``POST /api/v1/tenants/<id>/capture``.

Real capture is an adversarial input regime, and this module is the
hardening front-end between capture and windowing:

- **Clock skew** (:mod:`.skew`): every capture source (host) has its own
  clock; a per-source offset is fitted from cross-source request/response
  exchange pairs (NTP-style, median per edge) and subtracted from every
  timestamp *before* watermarking — skewed clocks otherwise break the
  parent⊇child containment the candidate enumeration assumes. The fitted
  offset is exported as ``tw_clock_skew_us{source}`` and each fit lands a
  ``clock_skew`` event.
- **Partial capture**: half-open exchanges (request observed, response
  lost), truncated frames, interrupted CONTINUATION sequences, and HPACK
  decode failures are counted per source in
  ``tw_capture_loss_total{source,reason}`` and handled under the
  ``TW_COLLECTOR_PARTIAL`` policy — ``synthetic`` closes a half-open
  exchange out as a counted synthetic span at the last observed activity;
  ``deadletter`` drops it with accounting. The observed loss rate
  discounts every emitted trace's confidence downstream
  (``stream/service.py``, the confidence path).
- **Connection churn**: an fd reused (or a peer reconnecting) without an
  observed ``close`` re-keys mid-capture — a fresh HTTP/2 preface on a
  connection that already carried bytes starts a NEW logical connection
  (counted in ``tw_capture_rekeyed_total``); exchanges stranded on the
  old one are closed out per the partial policy. Open exchanges awaiting
  their response live in a bounded per-source orphan buffer
  (``TW_COLLECTOR_ORPHANS``); past the bound the oldest is evicted and
  counted.

Chaos sites (``runtime/faults.py``): ``capture`` drops payload chunks
(and the remainder of that connection direction — an HTTP/2 byte stream
cannot be resynchronized after a gap); ``skew`` offsets a drawn source's
raw clock by ``TW_SKEW_CHAOS_US``, the stimulus the estimator must
correct. Both are drawn via ``plan.should_fail`` (state perturbations,
not raised errors). ``chip_smoke.py --capture`` drives all three legs on
the card.

Arrival semantics: a span *arrives* when its exchange completes (the
response closes it), so out-of-order arrival falls out of the capture
naturally — longer requests arrive later — and the watermark machinery
sees exactly the fan-in a live collector subscription would produce.
``SpanEvent.capture_us`` keeps the raw (pre-correction) capture
timestamp; ``event_us`` is solver event time (skew-corrected).

Mirrors ``traceweaver_tpu/collector/source.py``; the port keeps its own
copy. The JAX package's knobs are :class:`CaptureIngest` arguments with
the knobs' defaults (``partial_policy``, ``orphan_bound``,
``skew_chaos_us``), which :class:`CollectorSource`,
:meth:`CollectorSource.from_spec` and :func:`iter_live` forward; the skew
knobs are :class:`~.skew.SkewEstimator`'s.
"""

from __future__ import annotations

import ctypes
import os
import stat as _stat
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from traceweaver_tpu_torch.collector.http2 import (
    PREFACE,
    DirectionReplayer,
    looks_like_http2,
)
from traceweaver_tpu_torch.collector.skew import SkewEstimator
from traceweaver_tpu_torch.collector.strace import StraceParser
from traceweaver_tpu_torch.collector.threading_model import request_key
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.registry import capture_families
from traceweaver_tpu_torch.runtime import faults as _faults
from traceweaver_tpu_torch.spans import Span
from traceweaver_tpu_torch.stream.sources import SpanEvent

#: every capture-loss reason the ingress can count. Span-shaped reasons
#: (one count ≈ one lost/approximated span) feed the loss RATE that
#: discounts confidence; byte/line-level reasons are reported but do not
#: inflate the rate (their spans surface as half-open/truncated anyway).
LOSS_REASONS = (
    "dropped_chunk",        # capture fault site / post-gap discard (bytes)
    "truncated_stream",     # capture ended mid-frame
    "interrupted_headers",  # CONTINUATION sequence broken / re-keyed
    "decode_error",         # HPACK fragment undecodable (lost bootstrap)
    "half_open",            # request without response, synthetic closeout
    "half_open_dropped",    # request without response, dead-lettered
    "orphan_evicted",       # orphan-buffer bound hit
    "unmatched_lines",      # strace lines the tokenizer rejected
    "skew_clamped",         # fitted offset clamped at TW_SKEW_MAX_US
)
_SPAN_LOSS_REASONS = ("truncated_stream", "interrupted_headers",
                     "decode_error", "half_open", "half_open_dropped",
                     "orphan_evicted")

#: ``TW_COLLECTOR_PARTIAL``: what a half-open exchange becomes
PARTIAL_POLICIES = ("synthetic", "deadletter")
COLLECTOR_PARTIAL = "synthetic"
#: ``TW_COLLECTOR_ORPHANS``: open exchanges a source holds before eviction
COLLECTOR_ORPHANS = 256
#: ``TW_SKEW_CHAOS_US``: the raw-clock offset the ``skew`` fault site injects
SKEW_CHAOS_US = 250000.0

_OBS = capture_families()
_OBS_LOSS = _OBS["loss"]
_OBS_SPANS = _OBS["spans"]
_OBS_REKEYED = _OBS["rekeyed"]
_OBS_SKEW = _OBS["skew"]


class CaptureCounters:
    """Shared per-run capture ledger: plain dicts for the stats surface,
    mirrored 1:1 onto the obs registry (tw_capture_* families) and the
    structured event sink on every bump."""

    def __init__(self) -> None:
        self.loss: Dict[str, Dict[str, int]] = {}       # source -> reason
        self.delivered: Dict[str, int] = {}
        self.rekeyed: Dict[str, int] = {}
        self.synthetic: Dict[str, int] = {}

    def count_loss(self, source: str, reason: str, n: int = 1) -> None:
        if n <= 0:
            return
        by = self.loss.setdefault(source, {})
        by[reason] = by.get(reason, 0) + n
        _OBS_LOSS.inc(float(n), source=source, reason=reason)
        _events.emit("capture_loss", reason, source=source, n=by[reason])

    def count_span(self, source: str, n: int = 1) -> None:
        self.delivered[source] = self.delivered.get(source, 0) + n
        _OBS_SPANS.inc(float(n), source=source)

    def count_rekey(self, source: str) -> None:
        self.rekeyed[source] = self.rekeyed.get(source, 0) + 1
        _OBS_REKEYED.inc(1.0, source=source)
        _events.emit("capture_churn", "rekeyed", source=source,
                     n=self.rekeyed[source])

    def count_synthetic(self, source: str) -> None:
        self.synthetic[source] = self.synthetic.get(source, 0) + 1

    # -- rates -------------------------------------------------------------
    def span_losses(self, source: Optional[str] = None) -> int:
        srcs = [source] if source else list(self.loss)
        return sum(self.loss.get(s, {}).get(r, 0)
                   for s in srcs for r in _SPAN_LOSS_REASONS)

    def loss_rate(self, source: Optional[str] = None) -> float:
        lost = self.span_losses(source)
        got = (self.delivered.get(source, 0) if source
               else sum(self.delivered.values()))
        return lost / (lost + got) if (lost + got) else 0.0

    def snapshot(self, skew: Optional[SkewEstimator] = None) -> Dict:
        sources = sorted(set(self.loss) | set(self.delivered)
                         | set(self.rekeyed))
        total_loss: Dict[str, int] = {}
        for by in self.loss.values():
            for reason, n in by.items():
                total_loss[reason] = total_loss.get(reason, 0) + n
        out = dict(
            delivered_spans=sum(self.delivered.values()),
            synthetic_spans=sum(self.synthetic.values()),
            loss=dict(sorted(total_loss.items())),
            loss_rate=round(self.loss_rate(), 4),
            rekeyed_streams=sum(self.rekeyed.values()),
            per_source={
                s: dict(
                    delivered=self.delivered.get(s, 0),
                    loss=dict(sorted(self.loss.get(s, {}).items())),
                    loss_rate=round(self.loss_rate(s), 4),
                    rekeyed=self.rekeyed.get(s, 0),
                ) for s in sources},
        )
        if skew is not None:
            out["skew_us"] = {s: round(v, 1)
                              for s, v in sorted(skew.offsets().items())}
            out["skew_pairs"] = skew.n_pairs
            out["skew_fits"] = skew.fits
        return out


@dataclass
class CaptureRecord:
    """One completed (or closed-out) request/response exchange."""

    source: str
    fd: int
    gen: int
    stream_id: int
    direction: str              # "in" = server-side, "out" = client-side
    key: Optional[str]          # propagated tracing identity, if any
    authority: Optional[str]
    path: Optional[str]
    start_us: float             # RAW source clock (pre-skew-correction)
    end_us: float
    complete: bool              # False = half-open synthetic closeout
    open_seq: int = 0

    @property
    def sid(self) -> str:
        return "%s/%d.%d.%d%s" % (self.source, self.fd, self.gen,
                                  self.stream_id,
                                  "s" if self.direction == "in" else "c")


@dataclass
class _Exchange:
    stream_id: int
    req_dir: str
    start_us: float
    headers: List[Tuple[str, str]]
    key: Optional[str]
    authority: Optional[str]
    path: Optional[str]
    open_seq: int
    resp_started: bool = False
    resp_ts: Optional[float] = None


class _Conn:
    """One logical connection (fd generation after churn re-keying)."""

    __slots__ = ("fd", "gen", "replayers", "fed", "ts_offsets", "ts_vals",
                 "prelude", "decided", "dead", "exchanges", "last_ts")

    def __init__(self, fd: int, gen: int) -> None:
        self.fd = fd
        self.gen = gen
        self.replayers = {"in": DirectionReplayer(),
                          "out": DirectionReplayer()}
        self.fed = {"in": 0, "out": 0}
        # frame offsets -> capture ts lookup, per direction
        self.ts_offsets: Dict[str, List[int]] = {"in": [], "out": []}
        self.ts_vals: Dict[str, List[float]] = {"in": [], "out": []}
        # chunks buffered until the protocol sniff decides
        self.prelude: List[Tuple[str, bytes, float]] = []
        self.decided: Optional[bool] = None
        self.dead = {"in": False, "out": False}
        self.exchanges: Dict[int, _Exchange] = {}
        self.last_ts = 0.0

    def ts_at(self, direction: str, offset: int) -> float:
        offs = self.ts_offsets[direction]
        if not offs:
            return self.last_ts
        i = bisect_right(offs, offset) - 1
        return self.ts_vals[direction][max(i, 0)]


_OTHER = {"in": "out", "out": "in"}


class CaptureIngest:
    """One capture source's incremental pipeline: feed strace lines (or
    eBPF events); completed exchanges land in :attr:`records` (and fire
    ``on_record`` when set — the live/fifo mode hook)."""

    def __init__(self, name: str, counters: CaptureCounters,
                 estimator: Optional[SkewEstimator] = None,
                 service: Optional[str] = None,
                 on_record=None, partial_policy: str = COLLECTOR_PARTIAL,
                 orphan_bound: int = COLLECTOR_ORPHANS,
                 skew_chaos_us: float = SKEW_CHAOS_US) -> None:
        if partial_policy not in PARTIAL_POLICIES:
            raise ValueError(f"partial_policy {partial_policy!r} not in "
                             f"{PARTIAL_POLICIES}")
        self.name = name
        self.service = service or name
        self.counters = counters
        self.estimator = estimator
        self.on_record = on_record
        self.records: List[CaptureRecord] = []
        # request identities opened at this source, for in-source
        # parent joins: key -> [(start_ts, server-span sid)]
        self.in_requests_by_key: Dict[str, List[Tuple[float, str]]] = {}
        self.partial_policy = partial_policy
        self.orphan_bound = int(orphan_bound)
        self._parser = StraceParser()
        self._parser.payload_hook = self._on_payload
        self._parser.close_hook = self._on_close
        self._conns: Dict[Tuple[int, int], _Conn] = {}  # parser key -> conn
        self._gen_seq: Dict[int, int] = {}
        self._open_seq = 0
        self._n_open = 0
        self._ebpf_gen: Dict[int, int] = {}
        if estimator is not None:
            estimator.register_source(name)
        # chaos site "skew": a drawn source's raw clock is offset by
        # skew_chaos_us — the stimulus the estimator must correct
        self.ts_offset = 0.0
        plan = _faults.active()
        if plan is not None and plan.should_fail("skew"):
            self.ts_offset = float(skew_chaos_us)
            _events.emit("fault_injected", "skew", source=name,
                         offset_us=self.ts_offset, seed=plan.seed)

    # -- feeding -----------------------------------------------------------
    def feed_line(self, line: str) -> None:
        before = self._parser.unmatched_lines
        self._parser.feed_line(line)
        if self._parser.unmatched_lines > before:
            self.counters.count_loss(self.name, "unmatched_lines")

    def feed_ebpf(self, ev) -> None:
        """Fold one perf-buffer event (a :class:`~traceweaver_tpu_torch.
        collector.ebpf.DataEvent` or anything with ``fd``/``op``/
        ``ts_ns``/``len``/``buf``) into the same pipeline the strace
        front-end drives."""
        fd = int(ev.fd)
        if ev.op == 2:  # close
            key = (fd, self._ebpf_gen.get(fd, 0))
            self._ebpf_gen[fd] = key[1] + 1
            self._on_close(key)
            return
        if ev.op not in (0, 1):
            return
        direction = "in" if ev.op == 0 else "out"
        self._on_payload((fd, self._ebpf_gen.get(fd, 0)), direction,
                         _event_payload(ev), int(ev.ts_ns) / 1000)

    # -- per-chunk pipeline ------------------------------------------------
    def _on_payload(self, key: Tuple[int, int], direction: str,
                    payload: bytes, ts_us: float) -> bool:
        ts_us += self.ts_offset
        conn = self._conns.get(key)
        if conn is not None and payload.startswith(PREFACE) \
                and conn.fed[direction] > 0:
            # churn: a fresh client preface on a connection that already
            # carried bytes = fd reuse / reconnect without an observed
            # close. Re-key: strand the old logical connection (its open
            # exchanges close out per the partial policy) and start a new
            # one, so the two connections' bytes never concatenate.
            self.counters.count_rekey(self.name)
            self._finalize_conn(conn)
            conn = None
            self._conns.pop(key, None)
        if conn is None:
            gen = self._gen_seq.get(key[0], 0)
            self._gen_seq[key[0]] = gen + 1
            conn = self._conns[key] = _Conn(key[0], gen)
        if conn.dead[direction]:
            # post-gap bytes are unusable (no HTTP/2 resync after a hole)
            self.counters.count_loss(self.name, "dropped_chunk")
            return False
        plan = _faults.active()
        if plan is not None and plan.should_fail("capture"):
            _events.emit("fault_injected", "capture", source=self.name,
                         fd=conn.fd, seed=plan.seed)
            conn.dead[direction] = True
            self.counters.count_loss(self.name, "dropped_chunk")
            return False
        conn.last_ts = max(conn.last_ts, ts_us)
        if conn.decided is None:
            conn.prelude.append((direction, payload, ts_us))
            self._maybe_decide(conn, final=False)
        elif conn.decided:
            self._replay_chunk(conn, direction, payload, ts_us)
        return True

    def _maybe_decide(self, conn: _Conn, final: bool) -> None:
        heads = {"in": bytearray(), "out": bytearray()}
        for d, payload, _ in conn.prelude:
            heads[d].extend(payload)
        if not final and max(len(heads["in"]), len(heads["out"])) \
                < len(PREFACE):
            return
        conn.decided = looks_like_http2(bytes(heads["in"]),
                                        bytes(heads["out"]))
        if conn.decided:
            for d, payload, ts in conn.prelude:
                self._replay_chunk(conn, d, payload, ts)
        conn.prelude = []

    def _replay_chunk(self, conn: _Conn, direction: str, payload: bytes,
                      ts_us: float) -> None:
        conn.ts_offsets[direction].append(conn.fed[direction])
        conn.ts_vals[direction].append(ts_us)
        conn.fed[direction] += len(payload)
        for ev in conn.replayers[direction].feed(payload):
            self._handle_event(conn, direction, ev)

    # -- HTTP/2 event handling --------------------------------------------
    def _handle_event(self, conn: _Conn, direction: str, ev) -> None:
        ts = conn.ts_at(direction, ev.offset)
        if ev.kind == "request":
            old = conn.exchanges.get(ev.stream_id)
            if old is not None:
                self._close_out(conn, old, reason="half_open")
            h = {n.lower(): v for n, v in ev.headers}
            self._open_seq += 1
            exch = _Exchange(
                stream_id=ev.stream_id, req_dir=direction, start_us=ts,
                headers=ev.headers, key=request_key(ev.headers),
                authority=h.get(":authority"), path=h.get(":path"),
                open_seq=self._open_seq)
            conn.exchanges[ev.stream_id] = exch
            self._n_open += 1
            if direction == "in" and exch.key:
                self.in_requests_by_key.setdefault(exch.key, []).append(
                    (ts, CaptureRecord(
                        self.name, conn.fd, conn.gen, ev.stream_id,
                        "in", exch.key, exch.authority, exch.path,
                        ts, ts, True).sid))
            self._evict_orphans()
        elif ev.kind in ("response", "trailers"):
            exch = conn.exchanges.get(ev.stream_id)
            if exch is not None and direction == _OTHER[exch.req_dir]:
                exch.resp_started = True
                exch.resp_ts = ts
                if ev.end_stream:
                    self._complete(conn, exch, ts)
        elif ev.kind == "stream_end":
            exch = conn.exchanges.get(ev.stream_id)
            if exch is not None and direction == _OTHER[exch.req_dir] \
                    and exch.resp_started:
                self._complete(conn, exch, ts)

    def _emit_record(self, rec: CaptureRecord) -> None:
        self.records.append(rec)
        self.counters.count_span(self.name)
        if not rec.complete:
            self.counters.count_synthetic(self.name)
        if self.on_record is not None:
            self.on_record(rec)

    def _complete(self, conn: _Conn, exch: _Exchange, end_ts: float) -> None:
        conn.exchanges.pop(exch.stream_id, None)
        self._n_open -= 1
        self._emit_record(CaptureRecord(
            self.name, conn.fd, conn.gen, exch.stream_id, exch.req_dir,
            exch.key, exch.authority, exch.path,
            exch.start_us, max(end_ts, exch.start_us), True,
            open_seq=exch.open_seq))

    def _close_out(self, conn: _Conn, exch: _Exchange,
                   reason: str) -> None:
        """Half-open exchange disposal under the partial-capture policy."""
        conn.exchanges.pop(exch.stream_id, None)
        self._n_open -= 1
        self.counters.count_loss(self.name, reason)
        if reason == "half_open_dropped" \
                or self.partial_policy == "deadletter":
            if reason == "half_open":
                # counted above as half_open; the drop itself is the
                # policy outcome, counted under its own reason
                self.counters.count_loss(self.name, "half_open_dropped")
            return
        end = exch.resp_ts if exch.resp_ts is not None else conn.last_ts
        self._emit_record(CaptureRecord(
            self.name, conn.fd, conn.gen, exch.stream_id, exch.req_dir,
            exch.key, exch.authority, exch.path,
            exch.start_us, max(end, exch.start_us), False,
            open_seq=exch.open_seq))

    def _evict_orphans(self) -> None:
        while self._n_open > self.orphan_bound:
            oldest: Optional[Tuple[_Conn, _Exchange]] = None
            for conn in self._conns.values():
                for exch in conn.exchanges.values():
                    if oldest is None or exch.open_seq < oldest[1].open_seq:
                        oldest = (conn, exch)
            if oldest is None:
                break
            self._close_out(oldest[0], oldest[1], reason="orphan_evicted")

    # -- teardown ----------------------------------------------------------
    def _on_close(self, key: Tuple[int, int]) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            self._finalize_conn(conn)

    def _finalize_conn(self, conn: _Conn) -> None:
        if conn.decided is None:
            self._maybe_decide(conn, final=True)
        for exch in sorted(conn.exchanges.values(),
                           key=lambda e: e.open_seq):
            self._close_out(conn, exch, reason="half_open")
        if conn.decided:
            for d in ("in", "out"):
                rep = conn.replayers[d]
                if rep.pending_bytes and not conn.dead[d]:
                    self.counters.count_loss(self.name, "truncated_stream")
                self.counters.count_loss(self.name, "interrupted_headers",
                                         rep.dropped_header_blocks
                                         + int(rep.pending_headers))
                self.counters.count_loss(self.name, "decode_error",
                                         rep.decode_errors)

    def finish(self) -> None:
        for key in sorted(self._conns):
            self._finalize_conn(self._conns[key])
        self._conns.clear()


def _event_payload(ev) -> bytes:
    """An eBPF event's ``len`` payload bytes. A ``ctypes`` structure's
    ``char`` array field reads as bytes cut at the first NUL, and every
    HTTP/2 frame header holds one, so the bytes are taken from the
    structure's memory instead. (The JAX package's ``feed_ebpf`` reads
    the field and so recovers no HTTP/2 exchange from recorded events;
    it also divides the nanosecond stamp by a float, which rounds an epoch
    stamp to 256 ns first. ``feed_ebpf`` divides integers.)"""
    if isinstance(ev, ctypes.Structure):
        return ctypes.string_at(ctypes.addressof(ev) + type(ev).buf.offset, ev.len)
    return bytes(ev.buf[:ev.len])


# ---------------------------------------------------------------------------
# span synthesis + the stream-source contract
# ---------------------------------------------------------------------------

def _stub_process(authority: Optional[str]) -> Tuple[str, str]:
    """(process id, service name) of a synthesized downstream stub."""
    svc = (authority or "peer").split(":")[0]
    return "ext:" + svc, svc


class CollectorSource:
    """Adapt captured logs into the stream layer's span-event contract.

    ``captures`` maps source name (one capture host/process = one clock
    = one service) to its recorded ``strace -f [-ttt]`` log text. Parsing
    runs through the incremental :class:`CaptureIngest` machinery,
    cross-source exchanges fit the skew estimator, and the corrected,
    arrival-ordered event list replays deterministically —
    ``events(skip=n)`` resumes exactly like
    :class:`~traceweaver_tpu_torch.stream.sources.ReplaySource`.
    """

    def __init__(self, captures: Dict[str, str],
                 services: Optional[Dict[str, str]] = None,
                 ebpf_events: Optional[Dict[str, Iterable]] = None,
                 counters: Optional[CaptureCounters] = None,
                 estimator: Optional[SkewEstimator] = None,
                 **ingest_opts) -> None:
        # counters/estimator can be shared across sources (the serve
        # capture endpoint accumulates one ledger per tenant across
        # many posted logs)
        self.counters = counters if counters is not None \
            else CaptureCounters()
        self.estimator = estimator if estimator is not None \
            else SkewEstimator()
        self.store = None   # the replay-source attribute surface
        self._ingests: Dict[str, CaptureIngest] = {}
        services = services or {}
        names = sorted(set(captures) | set(ebpf_events or {}))
        for name in names:
            ing = CaptureIngest(name, self.counters,
                                estimator=self.estimator,
                                service=services.get(name), **ingest_opts)
            self._ingests[name] = ing
            for ev in (ebpf_events or {}).get(name, ()):
                ing.feed_ebpf(ev)
            for line in captures.get(name, "").splitlines():
                ing.feed_line(line)
            ing.finish()
        self._events: List[SpanEvent] = self._synthesize(
            [r for ing in self._ingests.values() for r in ing.records])

    # -- the source contract ----------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self, skip: int = 0) -> Iterator[SpanEvent]:
        return iter(self._events[skip:])

    def capture_quality(self) -> Dict:
        """The per-source capture ledger the stream layer's confidence
        discount and summary consume (docs/COLLECTOR.md)."""
        return self.counters.snapshot(skew=self.estimator)

    # -- synthesis ---------------------------------------------------------
    def _service_of(self, source: str) -> str:
        ing = self._ingests.get(source)
        return ing.service if ing is not None else source

    def _synthesize(self, records: List[CaptureRecord]) -> List[SpanEvent]:
        service_to_source = {self._service_of(n): n for n in self._ingests}
        ins = [r for r in records if r.direction == "in"]
        outs = [r for r in records if r.direction == "out"]

        # cross-source exchange join: an outgoing request at source A
        # matches the incoming request it became at source B, per
        # (tracing key, callee source), order-matched by open sequence
        ins_by: Dict[Tuple[str, str], List[CaptureRecord]] = {}
        for r in sorted(ins, key=lambda r: (r.open_seq, r.sid)):
            if r.key:
                ins_by.setdefault((r.key, r.source), []).append(r)
        joined_child: Dict[str, CaptureRecord] = {}   # out sid -> in rec
        joined_parent_of_in: Dict[str, str] = {}      # in sid -> out sid
        for o in sorted(outs, key=lambda r: (r.open_seq, r.sid)):
            if not o.key:
                continue
            callee_src = service_to_source.get(
                _stub_process(o.authority)[1])
            if callee_src is None or callee_src == o.source:
                continue
            cands = ins_by.get((o.key, callee_src), [])
            if not cands:
                continue
            child = cands.pop(0)
            joined_child[o.sid] = child
            joined_parent_of_in[child.sid] = o.sid
            if o.complete and child.complete \
                    and self.estimator is not None:
                self.estimator.observe_pair(
                    o.source, child.source,
                    o.start_us, child.start_us, child.end_us, o.end_us)

        if self.estimator.ready():
            offsets = self.estimator.fit()
            for src, off in sorted(offsets.items()):
                _OBS_SKEW.set(off, source=src)
            _events.emit(
                "clock_skew", "fit",
                offsets_us={s: round(v, 1)
                            for s, v in sorted(offsets.items())},
                pairs=self.estimator.n_pairs,
                reference=self.estimator.reference())
            self.counters.count_loss(
                self.estimator.reference() or "capture", "skew_clamped",
                self.estimator.clamped)

        spans: List[Tuple[Span, float, float]] = []  # span, arrival, raw
        processes: Dict[str, Dict[str, str]] = {}

        def corrected(source: str, t: float) -> float:
            return self.estimator.correct(source, t)

        def trace_of(rec: CaptureRecord) -> str:
            return rec.key or ("cap:" + rec.sid)

        def note_process(trace_id: str, pid: str, service: str) -> None:
            processes.setdefault(trace_id, {})[pid] = service

        # server spans from incoming requests
        for r in ins:
            tid = trace_of(r)
            refs = []
            parent_sid = joined_parent_of_in.get(r.sid)
            if parent_sid is not None:
                refs = [(tid, parent_sid)]
            start = corrected(r.source, r.start_us)
            dur = max(0.0, r.end_us - r.start_us)
            spans.append((Span(tid, r.sid, start, dur, r.path or "req",
                               refs, r.source, "server"),
                          start + dur, r.start_us))
            note_process(tid, r.source, self._service_of(r.source))

        # client spans from outgoing requests (+ downstream stubs where
        # the callee was not captured)
        for o in outs:
            tid = trace_of(o)
            refs = []
            if o.key:
                ing = self._ingests.get(o.source)
                opened = (ing.in_requests_by_key.get(o.key, [])
                          if ing is not None else [])
                # parent = the last request this source OPENED at or
                # before the outgoing call (raw clocks are comparable
                # within one source)
                best = None
                for ts, sid in opened:
                    if ts <= o.start_us and (best is None or ts >= best[0]):
                        best = (ts, sid)
                if best is None and opened:
                    best = opened[0]
                if best is not None:
                    refs = [(tid, best[1])]
            start = corrected(o.source, o.start_us)
            dur = max(0.0, o.end_us - o.start_us)
            spans.append((Span(tid, o.sid, start, dur, o.path or "call",
                               refs, o.source, "client"),
                          start + dur, o.start_us))
            note_process(tid, o.source, self._service_of(o.source))
            child = joined_child.get(o.sid)
            if child is None:
                # downstream not captured: synthesize the callee's server
                # half inside the client interval so the stream layer can
                # resolve the callee endpoint (child_service_of)
                pid, svc = _stub_process(o.authority)
                eps = min(1.0, dur / 4.0)
                spans.append((Span(tid, o.sid + "d", start + eps,
                                   max(0.0, dur - 2 * eps),
                                   o.path or "call", [(tid, o.sid)],
                                   pid, "server"),
                              start + dur, o.start_us))
                note_process(tid, pid, svc)

        events = [
            SpanEvent(span=s, event_us=float(s.start_mus),
                      arrival_us=max(arrival, float(s.start_mus)),
                      trace_id=s.trace_id,
                      processes=processes.get(s.trace_id, {}),
                      capture_us=raw)
            for s, arrival, raw in spans
        ]
        events.sort(key=lambda e: (e.arrival_us, e.trace_id, e.span.sid))
        return events

    # -- construction helpers ---------------------------------------------
    @classmethod
    def from_spec(cls, path: str, service: Optional[str] = None,
                  **ingest_opts) -> "CollectorSource":
        """Build from a filesystem spec: a single strace log file (one
        source; service name from ``service``, the JAX package's
        ``TW_COLLECTOR_SERVICE``, or the file stem), a directory of
        per-source logs (every ``*.log`` / ``*.txt`` / ``*.strace`` file
        is one source named by its stem), or a FIFO (live single-source
        mode — see :meth:`iter_live`). ``ingest_opts`` are
        :class:`CaptureIngest`'s policy arguments."""
        if os.path.isdir(path):
            captures = {}
            for fn in sorted(os.listdir(path)):
                if fn.rsplit(".", 1)[-1] not in ("log", "txt", "strace"):
                    continue
                stem = fn.rsplit(".", 1)[0]
                with open(os.path.join(path, fn)) as f:
                    captures[stem] = f.read()
            if not captures:
                raise ValueError(
                    f"collector:{path}: no *.log/*.txt/*.strace capture "
                    "files in the directory")
            return cls(captures, **ingest_opts)
        if not os.path.exists(path):
            raise ValueError(f"collector:{path}: no such file")
        name = service or os.path.basename(path).rsplit(".", 1)[0]
        if _stat.S_ISFIFO(os.stat(path).st_mode):
            return _LiveCollectorSource(path, name, **ingest_opts)
        with open(path) as f:
            return cls({name: f.read()}, **ingest_opts)


class _LiveCollectorSource:
    """Single-source live ingress over a FIFO: lines are parsed as the
    writer produces them and spans are emitted as their exchanges
    complete. Not checkpoint-resumable (``skip`` must be 0) — a FIFO
    cannot be replayed."""

    def __init__(self, path: str, name: str, **ingest_opts) -> None:
        self.path = path
        self.name = name
        self.ingest_opts = ingest_opts
        self.counters = CaptureCounters()
        self.estimator = SkewEstimator()
        self.store = None

    def capture_quality(self) -> Dict:
        return self.counters.snapshot(skew=self.estimator)

    def __len__(self) -> int:
        return 0

    def events(self, skip: int = 0) -> Iterator[SpanEvent]:
        if skip:
            raise ValueError(
                "collector FIFO sources cannot fast-forward (skip=%d): "
                "a live capture is not replayable; checkpoint/resume "
                "needs a recorded log" % skip)
        with open(self.path) as f:
            yield from iter_live(f, self.name, counters=self.counters,
                                 estimator=self.estimator, **self.ingest_opts)


def iter_live(lines: Iterable[str], name: str,
              counters: Optional[CaptureCounters] = None,
              estimator: Optional[SkewEstimator] = None,
              **ingest_opts) -> Iterator[SpanEvent]:
    """Incremental single-source ingress: feed strace lines as they
    arrive, yield span events as exchanges complete (arrival order ==
    completion order — exactly a collector subscription's fan-in).
    Downstream callees synthesize as stubs (a single live source has no
    cross-source joins, so the skew estimator stays inert at offset 0)."""
    counters = counters if counters is not None else CaptureCounters()
    completed: List[CaptureRecord] = []
    ing = CaptureIngest(name, counters, estimator=estimator,
                        on_record=completed.append, **ingest_opts)
    src = CollectorSource.__new__(CollectorSource)
    src.counters = counters
    src.estimator = estimator or SkewEstimator()
    src.store = None
    src._ingests = {name: ing}

    def drain() -> Iterator[SpanEvent]:
        if completed:
            batch = list(completed)
            del completed[:]
            yield from src._synthesize(batch)

    for line in lines:
        ing.feed_line(line)
        yield from drain()
    ing.finish()
    yield from drain()
