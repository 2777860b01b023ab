"""Shared-fleet tenancy: many tenants' windows, one dispatch stream
(mirrors ``traceweaver_tpu/serve/tenancy.py``).

Each tenant owns a whole reconstruction pipeline (watermark, windowing
engine, live span store, carried warm-start statistics, sink and
dead-letter files, a bounded ring of emitted traces) around an
externally pumped
:class:`~traceweaver_tpu_torch.stream.service.StreamingReconstructor`.
What tenants share is the card: the :class:`TenantService` collects
healthy tenants' sealed windows, builds their
:class:`~traceweaver_tpu_torch.algorithms.fleet.FleetItem` lists (tagged
with the tenant id, the id column the fleet carries through pack,
compaction and decode) and rides them through one
:func:`~traceweaver_tpu_torch.algorithms.fleet.solve_fleet` call, so
tenants with similar window geometry share padded shape classes and the
dispatch count stays O(shape classes), not O(tenants). On the card every
such call launches K1 and the block-assembly kernel, with the window
tensors gathered from the device-resident column rings
(:mod:`traceweaver_tpu_torch.ops.devcols`).

Isolation is per tenant: its own pending bound, spill queue and counted
shed; a tenant with a ``fault_spec`` solves in isolated dispatches under
its own fault plan; a quarantined window dead-letters into its own
tenant's sidecar and counters (emitted + dead-lettered == sealed
windows); its own checkpoint under ``state_dir/<tenant>/`` with the
open windows in it; and its own write-ahead log (:mod:`..stream.wal`):
a span POST's raw bytes are appended before the 200 goes out, so a
restart replays what the last checkpoint did not hold.

The JAX package's ``TW_SERVE_*``, ``TW_WAL*``, ``TW_WIRE_COLUMNAR``,
``TW_DEVCOLS*``, ``TW_CONFIDENCE`` and ``TW_CONF_LOW`` knobs are
:class:`ServeConfig` fields with the knobs' defaults, and
``precision_from_env`` is ``ServeConfig.precision``. ``TenantService(cfg,
device=None)`` means the card and raises without one; tests pass
``device="cpu"``.

One addition: the Alibaba self-loop services' ids, which the JAX package
draws from the process's global RNG, are drawn from a per-tenant RNG
seeded from the tenant id, whose state rides the tenant's checkpoint. A
tenant's sink then does not depend on how its neighbours' POSTs
interleave with its own, nor on a restart.

Capture ingestion (:meth:`TenantService.ingest_capture`, and
:meth:`TenantService.wal_ingest_capture` behind ``POST
/api/v1/tenants/<id>/capture``) runs posted ``strace`` logs through the
collector ingress (:mod:`traceweaver_tpu_torch.collector.source`) into
the tenant's stream; its WAL records are of kind ``capture`` and replay
through the same call. With ``ServeConfig.adapt`` each tenant's stream
carries a drift-to-adapt controller, whose refits
:meth:`TenantService.run_adaptations` runs after each pump or solve
retires (``TW_ADAPT`` and its knobs are ``ServeConfig`` fields).

Live migration (:meth:`TenantService.migrate_out` and
:meth:`TenantService.migrate_in`, driven by ``fleet_serve``) moves a
tenant between replicas: the source waits for the tenant's windows in
flight to retire, checkpoints it, hands over the CRC-verified checkpoint
with its sink and dead-letter bytes, drops its device-resident column
rings and leaves a durable tombstone (:data:`MIGRATED_MARKER`; requests
for the tenant answer 410 there, also after a restart); the destination
installs the bytes and resumes the tenant as a restart would, its rings
built afresh at its first solve. The source keeps its checkpoint and WAL
under the tombstone until the migration is settled:
:meth:`TenantService.migrate_commit` deletes them once the destination
holds the tenant, :meth:`TenantService.migrate_abort` resumes the tenant
from them when the destination refused it. (The JAX package deletes them
at ``migrate_out``, so a refused ``migrate_in`` loses the tenant.)
:func:`read_crashed_transfer` builds the
same transfer from a crashed replica's disk (checkpoint, ``.prev``
fallback, WAL tail) and :func:`tombstone_crashed_tenant` tombstones the
dead copy. The transfer holds the port's own checkpoint pickles and
crosses between the port's replicas only.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import random
import re
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch import ops as _ops
from traceweaver_tpu_torch.adapt.controller import (
    ADAPT_COOLDOWN_S,
    ADAPT_LOW_RATE,
    ADAPT_PROBATION,
    AdaptationController,
)
from traceweaver_tpu_torch.ingest import wire as _wire
from traceweaver_tpu_torch.ingest.jaeger import (
    FIX_ROOT_OPS,
    MalformedSpan,
    parse_trace_payload,
)
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs import quality as _quality
from traceweaver_tpu_torch.obs.registry import serve_families
from traceweaver_tpu_torch.ops import devcols as _devcols
from traceweaver_tpu_torch.ops.precision import validate_precision
from traceweaver_tpu_torch.query.delay_culprit import live_delay_culprit
from traceweaver_tpu_torch.runtime import faults
from traceweaver_tpu_torch.serve.ring import TraceRing, build_trace_records
from traceweaver_tpu_torch.stream import wal as _walmod
from traceweaver_tpu_torch.stream.checkpoint import (
    CheckpointCorrupt,
    load_checkpoint,
    read_checkpoint_bytes,
    save_checkpoint,
    verify_checkpoint_bytes,
    write_checkpoint_bytes,
)
from traceweaver_tpu_torch.stream.service import (
    StreamConfig,
    StreamingReconstructor,
    TraceSink,
)
from traceweaver_tpu_torch.stream.sources import SpanEvent

_TENANT_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")

#: durable migration tombstone, one per moved-out tenant dir: it survives a
#: restart, so :meth:`TenantService.resume` re-tombstones the tenant rather
#: than minting a forked twin from the files it left behind
MIGRATED_MARKER = "migrated_out.json"

#: client-seq dedup window depth per tenant: how many recently applied
#: client seqs a retried POST can be answered from without re-ingesting
WAL_DEDUP_WINDOW = 4096

#: seeds each tenant's self-loop id RNG with its tenant id (the batch
#: executor seeds its loads with 10 too)
SELF_LOOP_SEED = 10

# registry mirrors: per-tenant counters and the service's pump ledger.
# /metrics serves the per-tenant surface from TenantService.metrics_families
# (derived from the same stats() as /api/v1/stats), not from these mirrors
_OBS = serve_families()
_OBS_TENANT_LEDGER = _OBS["tenant_ledger"]
_OBS_PUMP = _OBS["pump"]
_OBS_DISPATCHER_DEGRADED = _OBS["dispatcher_degraded"]
_OBS_WIRE_INGEST = _OBS["wire_ingest"]
_OBS_INFLIGHT = _OBS["inflight"]
_OBS_OVERLAP = _OBS["overlap"]
_OBS_RETRY_AFTER = _OBS["retry_after"]


def _merge_stats(dst: Dict, src: Dict) -> None:
    """Fold a ticket's local fleet ledger into the shared one (under the
    service lock, so a concurrent ``stats()`` never iterates a dict the
    solver is growing): counters add, the high-water gauges take the
    max, ordered event lists extend, per-tenant buckets merge."""
    gauges = ("pipeline_depth", "fleet_group_cost_max")
    for k, v in src.items():
        if isinstance(v, list):
            dst.setdefault(k, []).extend(v)
        elif isinstance(v, dict):
            d = dst.setdefault(k, {})
            for kk, vv in v.items():
                d[kk] = d.get(kk, 0.0) + vv
        elif k in gauges:
            dst[k] = max(dst.get(k, 0.0), v)
        else:
            dst[k] = dst.get(k, 0.0) + v


class TenancyError(ValueError):
    """A tenancy-layer refusal (bad tenant id, tenant cap reached); the
    HTTP layer maps these to 4xx answers."""


@dataclass
class ServeConfig:
    """Multi-tenant service settings; the defaults are the JAX package's
    knob defaults (``knobs.py``), the serve CLI's continuous admission
    apart (the library default is the fixed pump, as there)."""

    # per-tenant stream geometry (event-time microseconds)
    window_us: float = 60e6
    overlap_us: float = 5e6
    ooo_bound_us: float = 2e6
    grace_us: float = 0.0
    fix: int = 5                   # ingest FIX mode of posted payloads
    strict: bool = False           # malformed span records raise (HTTP 400)
    warm_start: bool = True
    verbose: bool = False
    state_dir: Optional[str] = None  # per-tenant sinks, checkpoints, WALs
    checkpoint_every: int = 8
    max_tenants: int = 100         # TW_SERVE_MAX_TENANTS
    max_pending: int = 4           # TW_SERVE_PENDING
    spill_max: int = 64            # TW_SERVE_SPILL
    ring_size: int = 512           # TW_SERVE_RING: emitted traces a tenant
    drain_timeout_s: float = 30.0  # TW_SERVE_DRAIN_S
    pump_windows: int = 8          # TW_SERVE_PUMP_WINDOWS
    # continuous batching (serve/continuous.py): event-driven admission on
    # a dispatcher thread instead of the ingest-inline threshold pump; the
    # serve CLI turns it on (TW_SERVE_CONTINUOUS)
    continuous: bool = False
    slo_p99_ms: float = 2000.0     # TW_SERVE_SLO_P99_MS
    # dispatch-ring depth under the continuous dispatcher: tickets in
    # flight at once; 1 is the serial admit -> solve -> consume loop
    inflight: int = 2              # TW_SERVE_INFLIGHT
    wal: bool = True               # TW_WAL
    wal_sync: str = "batch"        # TW_WAL_SYNC: always | batch | off
    wal_segment_mb: int = 16       # TW_WAL_SEGMENT_MB
    columnar: bool = True          # TW_WIRE_COLUMNAR
    devcols: bool = True           # TW_DEVCOLS
    ring_capacity: int = _devcols.RING_CAPACITY  # TW_DEVCOLS_RING
    precision: str = "f32"         # TW_PRECISION
    confidence: bool = True        # TW_CONFIDENCE
    conf_low: float = _quality.CONF_LOW  # TW_CONF_LOW
    conf_drift_window: int = _quality.DRIFT_WINDOW  # TW_CONF_DRIFT_WINDOW
    faults_seed: int = 0           # TW_FAULTS_SEED
    # the drift-to-adapt ladder (adapt/), off by default
    adapt: bool = False            # TW_ADAPT
    adapt_cooldown_s: float = ADAPT_COOLDOWN_S  # TW_ADAPT_COOLDOWN_S
    adapt_probation: int = ADAPT_PROBATION      # TW_ADAPT_PROBATION
    adapt_low_rate: float = ADAPT_LOW_RATE      # TW_ADAPT_LOW_RATE

    def __post_init__(self) -> None:
        self.precision = validate_precision(self.precision)
        if self.wal_sync not in _walmod.SYNC_POLICIES:
            raise ValueError(f"wal_sync {self.wal_sync!r} not in "
                             f"{_walmod.SYNC_POLICIES}")
        if not 1 <= int(self.inflight) <= 8:
            raise ValueError(f"inflight {self.inflight} not in [1, 8]")


class Tenant:
    """One tenant's whole reconstruction pipeline (never shared)."""

    def __init__(self, tenant_id: str, cfg: ServeConfig, device=None) -> None:
        if not _TENANT_ID_RE.fullmatch(tenant_id):
            raise TenancyError(
                f"invalid tenant id {tenant_id!r}: expected "
                "[A-Za-z0-9][A-Za-z0-9._-]{0,63}")
        self.id = tenant_id
        self.cfg = cfg
        self.dir = os.path.join(cfg.state_dir, tenant_id) if cfg.state_dir else None
        self.ckpt_path = os.path.join(self.dir, "ckpt.pkl") if self.dir else None
        # the durable ingest log, opened at the first ledgered append or
        # resume replay, so wal=False never creates wal/
        self.wal_dir = os.path.join(self.dir, "wal") if self.dir else None
        self.wal: Optional[_walmod.WriteAheadLog] = None
        # client seq -> traces its original application ingested (echoed
        # on a dedup hit, so a retried POST's accounting matches the lost
        # ack's)
        self._wal_seen: "OrderedDict[int, int]" = OrderedDict()
        sink = TraceSink(os.path.join(self.dir, "traces.jsonl")) if self.dir else None
        stream_cfg = StreamConfig(
            window_us=cfg.window_us, overlap_us=cfg.overlap_us,
            ooo_bound_us=cfg.ooo_bound_us, grace_us=cfg.grace_us,
            max_pending=cfg.max_pending, spill_max=cfg.spill_max,
            warm_start=cfg.warm_start, grade=False,
            # the serve SLO rides the tenant's stream config for breach
            # telemetry; tenants are pumped from outside, so it never
            # changes the solve cadence
            slo_p99_ms=cfg.slo_p99_ms,
            # the tenant owns checkpointing (its checkpoint wraps the
            # service state with ring and counter bookkeeping)
            checkpoint_path=None, verbose=cfg.verbose)
        ctrl = (AdaptationController(
            low_rate=cfg.adapt_low_rate, probation=cfg.adapt_probation,
            cooldown_s=cfg.adapt_cooldown_s) if cfg.adapt else None)
        self.svc = StreamingReconstructor(None, stream_cfg, sink=sink, device=device,
                                          precision=cfg.precision,
                                          confidence=cfg.confidence, adapt=ctrl,
                                          drift_window=cfg.conf_drift_window)
        # self-trace keys of this tenant's windows are "<tenant>:<k>"
        self.svc.trace_prefix = tenant_id + ":"
        self.ring = TraceRing(cfg.ring_size)
        # Alibaba self-loop remap state, stable across payloads and a
        # resume like the batch loader's per-corpus map (rides the
        # checkpoint), and the RNG its new ids draw from
        self._self_loop_map: Dict[str, List[str]] = {}
        self._rng = random.Random(f"{SELF_LOOP_SEED}:{tenant_id}")
        self.ingest_counters: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        # a tenant under a fault storm (or operator quarantine) solves in
        # isolated dispatches; the parsed plan is kept, so its draw
        # position and counters persist across pumps
        self.fault_spec: Optional[str] = None
        self._fault_plan = None
        self._fault_plan_spec: Optional[str] = None
        # the per-tenant fleet ledger of isolated solves
        self.fleet_stats: Dict[str, float] = {}
        # windows taken off the queues by the dispatcher and solving
        # outside the service lock: retention pruning must not pass them
        self.in_flight: List = []
        # capture ingestion: the (CaptureCounters, SkewEstimator) pair
        # shared by every capture this tenant posts, made at the first
        self._capture = None

    # -- ingestion --------------------------------------------------------
    def ingest_payload(self, payload) -> Dict[str, int]:
        """Fold one posted Jaeger-JSON payload (the raw POST ``bytes`` on
        the columnar wire path, or a decoded dict) into the tenant's
        stream.

        With ``cfg.columnar`` eligible payloads parse through the
        columnar wire path (:mod:`traceweaver_tpu_torch.ingest.wire`);
        the others (and ``columnar=False``) through the batch loader's
        object parser. Both share the malformed-span counters. The FIX
        mode's root-operation filter applies, and every accepted span
        feeds as an event through watermark -> windowing -> scheduler,
        the stream's loop body; the parse time lands in ``parse_s``."""
        self._bump("posts")
        root_op = FIX_ROOT_OPS[self.cfg.fix]
        n_traces = n_spans = rejected = 0
        accepted = []
        t0 = time.perf_counter()
        entries = None
        if self.cfg.columnar:
            entries = _wire.parse_payload_wire(
                payload, self.cfg.fix, self._self_loop_map,
                strict=self.cfg.strict, counters=self.ingest_counters)
        if entries is not None:
            parse_s = time.perf_counter() - t0
            for wt in entries:
                if wt is None:
                    continue
                if root_op is not None and wt.root_op != root_op:
                    rejected += 1
                    continue
                t1 = time.perf_counter()
                accepted.append(wt.materialize())
                parse_s += time.perf_counter() - t1
            self.svc._bump("parse_s", parse_s)
            _OBS_WIRE_INGEST.inc(1.0, path="columnar")
            self._bump("wire_columnar_posts")
        else:
            if isinstance(payload, (bytes, bytearray)):
                try:
                    payload = json.loads(payload)
                except json.JSONDecodeError as e:
                    raise MalformedSpan(f"invalid JSON: {e}") from None
            parsed = parse_trace_payload(
                payload, self.cfg.fix, self._self_loop_map,
                self.svc.live.service_loop_map, strict=self.cfg.strict,
                counters=self.ingest_counters, rng=self._rng)
            self.svc._bump("parse_s", time.perf_counter() - t0)
            _OBS_WIRE_INGEST.inc(1.0, path="object")
            self._bump("wire_object_posts")
            for entry in parsed:
                if entry is None:
                    continue
                _, spans, _ = entry
                root = next((s for s in spans.values() if s.IsRoot()), None)
                if root is None or (root_op is not None and root.op_name != root_op):
                    rejected += 1
                    continue
                accepted.append(entry)
        for trace_id, spans, processes in accepted:
            n_traces += 1
            ordered = sorted(spans.values(), key=lambda s: (float(s.start_mus), s.sid))
            for span in ordered:
                self._ingest_event(SpanEvent(
                    span=span, event_us=float(span.start_mus),
                    arrival_us=float(span.start_mus), trace_id=trace_id,
                    processes=processes))
                n_spans += 1
        self._bump("ingested_traces", n_traces)
        self._bump("ingested_spans", n_spans)
        self._bump("rejected_traces", rejected)
        return dict(ingested_traces=n_traces, ingested_spans=n_spans,
                    rejected_traces=rejected,
                    malformed_spans=self.ingest_counters.get("malformed_spans", 0),
                    backlog=self.backlog)

    def ingest_capture(self, captures, source: Optional[str] = None) -> Dict[str, int]:
        """Fold one posted ``strace -f [-ttt]`` capture into the tenant's
        stream.

        ``captures`` is one log's text (one capture host, named by
        ``source``; callees it did not capture become stubs) or a
        ``{source name: log text}`` bundle of every host's capture of the
        same time window, so cross-source exchanges join and the skew fit
        sees its pairs. Every log runs through the collector ingress
        (HTTP/2 replay, skew correction, the partial-capture and churn
        rules) and every recovered span feeds the watermark -> windowing
        -> scheduler loop a Jaeger POST feeds. The loss, skew and churn
        ledgers accumulate across posts, and once a tenant has posted a
        capture its emitted confidences are discounted by the loss rate."""
        from traceweaver_tpu_torch.collector.skew import SkewEstimator
        from traceweaver_tpu_torch.collector.source import CaptureCounters, CollectorSource

        self._bump("capture_posts")
        if self._capture is None:
            counters, estimator = CaptureCounters(), SkewEstimator()
            self._capture = (counters, estimator)
            self.svc.capture_quality_ext = (
                lambda: counters.snapshot(skew=estimator))
        counters, estimator = self._capture
        if isinstance(captures, str):
            captures = {(source or "capture"): captures}
        src = CollectorSource(captures, counters=counters, estimator=estimator)
        n_spans = 0
        for ev in src.events():
            self._ingest_event(ev)
            n_spans += 1
        self._bump("capture_spans", n_spans)
        quality = src.capture_quality()
        return dict(
            ingested_spans=n_spans,
            capture_loss=quality["loss"],
            capture_loss_rate=quality["loss_rate"],
            rekeyed_streams=quality["rekeyed_streams"],
            skew_us=quality.get("skew_us", {}),
            backlog=self.backlog,
        )

    def _ingest_event(self, ev: SpanEvent) -> None:
        svc = self.svc
        svc.consumed += 1
        svc.watermark.observe(ev.event_us)
        span = svc.live.add(ev)
        svc.windower.add(span, ev.event_us)
        svc._trace_touch()
        sealed = svc.windower.poll(svc.watermark.value)
        svc._trace_seal(sealed)
        for buf in sealed:
            svc.scheduler.offer(buf)
        if sealed:
            self._prune()

    def _prune(self) -> None:
        # the stream's retention rule: two windows behind the watermark,
        # never past the oldest backlog window, nor past a window the
        # dispatcher is solving right now
        svc = self.svc
        backlog = (list(svc.scheduler.pending) + list(svc.scheduler.spill)
                   + list(self.in_flight))
        oldest = min((b.start_us for b in backlog), default=svc.watermark.value)
        horizon = min(svc.watermark.value - 2 * svc.cfg.window_us,
                      oldest - svc.cfg.window_us) - svc.cfg.grace_us
        svc.live.prune(horizon)

    def flush(self) -> int:
        """Seal every open window (the sealing frontier advances only to
        the last open window's end, not to infinity) and queue them for
        the next pump. Returns how many windows were sealed."""
        svc = self.svc
        if not svc.windower.open:
            return 0
        frontier = max(b.end_us for b in svc.windower.open.values()) \
            + svc.windower.grace_us
        sealed = svc.windower.poll(frontier)
        svc._trace_seal(sealed)
        for buf in sealed:
            svc.scheduler.offer(buf)
        return len(sealed)

    # -- the durable ingest log -------------------------------------------
    def _wal(self) -> Optional[_walmod.WriteAheadLog]:
        """The tenant's write-ahead log, opened lazily (None without a
        state dir, nothing to be durable on, and with ``wal=False``)."""
        if self.wal is None and self.wal_dir and self.cfg.wal:
            self.wal = _walmod.WriteAheadLog(
                self.wal_dir, segment_bytes=int(self.cfg.wal_segment_mb) << 20,
                sync=self.cfg.wal_sync)
        return self.wal

    def wal_seen(self, client_seq: Optional[int]) -> Optional[int]:
        """The original application's ingested count when this client seq
        was already applied, else None."""
        if client_seq is None:
            return None
        return self._wal_seen.get(int(client_seq))

    def wal_note(self, client_seq: Optional[int], n: int) -> None:
        """Record an applied client seq (a bounded window: the retry
        horizon of a lost ack)."""
        if client_seq is None:
            return
        self._wal_seen[int(client_seq)] = int(n)
        while len(self._wal_seen) > WAL_DEDUP_WINDOW:
            self._wal_seen.popitem(last=False)

    def wal_append(self, kind: str, body: bytes, client_seq: Optional[int] = None,
                   meta: Optional[Dict] = None) -> Optional[int]:
        """Append one accepted wire payload before the caller may answer
        2xx. The record is a small JSON head (kind, client seq) + NUL +
        the raw body, so replay re-drives the normal ingest path."""
        w = self._wal()
        if w is None:
            return None
        head = dict(k=kind)
        if client_seq is not None:
            head["seq"] = int(client_seq)
        if meta:
            head.update({k: v for k, v in meta.items() if v is not None})
        rec = json.dumps(head, separators=(",", ":")).encode("utf-8") + b"\0" + body
        seq = w.append(rec)
        self._bump("wal_appends")
        return seq

    def wal_sync(self) -> None:
        """Group commit (the ``batch`` policy's durability point) on the
        pump cadence. A failure is counted, not raised: the appends are
        already with the OS (process-death safe)."""
        if self.wal is None:
            return
        try:
            self.wal.sync()
        except (OSError, RuntimeError) as e:
            if not (isinstance(e, (OSError, faults.FaultError))
                    or faults.is_transient_fault(e)):
                raise
            self._bump("wal_sync_failures")

    def wal_replay(self, low_water: int) -> int:
        """Re-apply every record past the checkpoint's low-water mark
        through the normal ingest path, in append order. Torn tails were
        truncated at open; a record that fails to decode or apply is
        counted and skipped (its client was answered 4xx in the original
        run too). A ``capture`` record replays through
        :meth:`ingest_capture` with the source and body type its head
        kept."""
        w = self._wal()
        if w is None:
            return 0
        if w.torn_tails:
            self._bump("wal_torn_tail", w.torn_tails)
        n = 0
        for _seq, rec in w.replay(int(low_water)):
            head_b, _, body = rec.partition(b"\0")
            try:
                head = json.loads(head_b)
            except ValueError:
                self._bump("wal_replay_errors")
                continue
            kind = head.get("k")
            try:
                if kind == "capture":
                    captures = body.decode("utf-8", "replace")
                    if head.get("ctype") == "json":
                        # the record keeps the posted {"sources": ...} body
                        # (the JAX package hands the whole body on, and
                        # its replay of a bundle fails)
                        captures = json.loads(captures)["sources"]
                    summary = self.ingest_capture(captures, source=head.get("source"))
                    self.wal_note(head.get("seq"), summary.get("ingested_spans", 0))
                elif kind == "spans":
                    summary = self.ingest_payload(body)
                    self.wal_note(head.get("seq"), summary.get("ingested_traces", 0))
                else:
                    self._bump("wal_replay_errors")
                    continue
            except (MalformedSpan, ValueError, KeyError, TypeError):
                self._bump("wal_replay_errors")
                continue
            n += 1
        if n:
            self._bump("wal_replayed", n)
            _events.emit("serve", "wal_replayed", tenant=self.id, records=n,
                         low_water=int(low_water))
        return n

    # -- solve plumbing (driven by the TenantService) ---------------------
    @property
    def backlog(self) -> int:
        return self.svc.scheduler.backlog

    def pop_batch(self) -> List:
        return self.svc.scheduler.pop_batch()

    def emit_results(self, results) -> None:
        """Emit one batch's solved windows through the stream's batched
        emitter (sink and dead letters), add each emitted trace to the
        ring with its ``tw.confidence`` and count quarantined windows."""
        self.svc.emit_batch(results)
        for res in results:
            if res.poisoned:
                self._bump("quarantined_windows")
                self._bump("quarantined_services", max(1, len(res.quarantined_services)))
                continue
            conf_by_span: Dict = {}
            for recs in (res.confidence or {}).values():
                conf_by_span.update(recs)
            for rec in build_trace_records(res.traces, self.svc.live, res.buf.k,
                                           confidence=conf_by_span):
                self.ring.add(rec)
        self.svc.scheduler.solved_windows += len(results)

    # -- checkpoint / resume ----------------------------------------------
    def checkpoint(self) -> bool:
        """Write this tenant's checkpoint (service state, ring, counters,
        the WAL low-water mark and the self-loop RNG). A failed write is
        counted and the last good generation stays."""
        if not self.ckpt_path:
            return False
        state = self.svc.state_dict()
        state["serve"] = dict(
            tenant=self.id,
            ring=self.ring.records(),
            ring_evicted=self.ring.evicted,
            counters=dict(self.counters),
            ingest_counters=dict(self.ingest_counters),
            self_loop_map={k: list(v) for k, v in self._self_loop_map.items()},
            rng_state=self._rng.getstate(),
            fault_spec=self.fault_spec,
            fleet_stats=dict(self.fleet_stats),
            # appends apply to the service state synchronously under the
            # lock, so everything up to last_seq is inside this checkpoint
            wal=dict(low_water=self.wal.last_seq if self.wal is not None else 0,
                     seen=[(int(k), int(v)) for k, v in self._wal_seen.items()]),
        )
        try:
            if self.wal is not None:
                # the log is at least as durable as the checkpoint that
                # supersedes it
                self.wal.sync()
            save_checkpoint(self.ckpt_path, state)
        except (OSError, RuntimeError) as e:
            if not (isinstance(e, (OSError, faults.FaultError))
                    or faults.is_transient_fault(e)):
                raise
            self._bump("checkpoint_failures")
            return False
        self.svc._since_checkpoint = 0
        if self.wal is not None:
            self.wal.truncate_below(int(state["serve"]["wal"]["low_water"]))
        return True

    @classmethod
    def resume(cls, tenant_id: str, cfg: ServeConfig, device=None) -> "Tenant":
        tenant = cls(tenant_id, cfg, device=device)
        state = load_checkpoint(tenant.ckpt_path)
        if state.pop("_recovered_from_prev", False):
            tenant._bump("checkpoint_recovered")
        tenant.svc.apply_state(state)
        serve = state.get("serve", {})
        tenant.ring.load(serve.get("ring", []))
        tenant.ring.evicted = serve.get("ring_evicted", 0)
        tenant.counters.update(serve.get("counters", {}))
        tenant.ingest_counters.update(serve.get("ingest_counters", {}))
        tenant._self_loop_map.update(serve.get("self_loop_map", {}))
        if serve.get("rng_state") is not None:
            tenant._rng.setstate(serve["rng_state"])
        tenant.fault_spec = serve.get("fault_spec")
        tenant.fleet_stats.update(serve.get("fleet_stats", {}))
        wal_state = serve.get("wal") or {}
        for k, v in wal_state.get("seen", []):
            tenant._wal_seen[int(k)] = int(v)
        low_water = int(wal_state.get("low_water", 0))
        if cfg.wal:
            tenant.wal_replay(low_water)
            w = tenant._wal()
            if w is not None and w.last_seq < low_water:
                # a log that starts empty under an older checkpoint (a
                # migrated tenant's: its source's log does not travel)
                # numbers on from the checkpoint's mark, or a later replay
                # from that checkpoint would skip the new records
                w.last_seq = low_water
        return tenant

    @classmethod
    def recover(cls, tenant_id: str, cfg: ServeConfig, device=None) -> "Tenant":
        """:meth:`resume` that tolerates a missing checkpoint: a tenant
        that died before its first checkpoint recovers from its WAL
        alone."""
        probe = cls(tenant_id, cfg, device=device)
        if probe.ckpt_path and os.path.isfile(probe.ckpt_path):
            probe.close()
            return cls.resume(tenant_id, cfg, device=device)
        if cfg.wal:
            probe.wal_replay(0)
        return probe

    def fault_plan(self):
        """The tenant's parsed fault plan (None without a storm), rebuilt
        only when ``fault_spec`` changes."""
        if self._fault_plan_spec != self.fault_spec:
            self._fault_plan = (faults.parse_faults(self.fault_spec,
                                                    seed=self.cfg.faults_seed)
                                if self.fault_spec else None)
            self._fault_plan_spec = self.fault_spec
        return self._fault_plan

    def close(self) -> None:
        if self.svc.sink is not None:
            self.svc.sink.close()
        if self.svc.deadletter is not None:
            self.svc.deadletter.close()
        if self.wal is not None:
            self.wal.close()

    # -- accounting -------------------------------------------------------
    def _bump(self, key: str, n: float = 1) -> None:
        _OBS_TENANT_LEDGER.inc(n, tenant=self.id, key=key)
        self.counters[key] = self.counters.get(key, 0) + n

    def stats(self) -> Dict:
        svc = self.svc
        sched = svc.scheduler
        return dict(
            tenant=self.id,
            consumed=svc.consumed,
            emitted_windows=svc.emitted_windows,
            spans_emitted=int(svc.stats.get("spans_emitted", 0)),
            traces_emitted=int(svc.stats.get("traces_emitted", 0)),
            backlog=sched.backlog,
            solved_windows=sched.solved_windows,
            shed_spilled=sched.shed_spilled,
            shed_dropped_windows=sched.shed_dropped_windows,
            shed_dropped_spans=sched.shed_dropped_spans,
            late_rerouted=svc.windower.late_rerouted,
            late_dropped=svc.windower.late_dropped,
            deadletter_windows=int(svc.stats.get("deadletter_windows", 0)),
            deadletter_spans=int(svc.stats.get("deadletter_spans", 0)),
            low_confidence_traces=int(svc.stats.get("low_confidence_traces", 0)),
            seal_emit_p99_ms=round(svc.seal_emit_p99_ms() or 0.0, 2),
            parse_s=round(float(svc.stats.get("parse_s", 0.0)), 6),
            stitch_s=round(float(svc.stats.get("stitch_s", 0.0)), 6),
            emit_s=round(float(svc.stats.get("emit_s", 0.0)), 6),
            consume_s=round(float(svc.stats.get("consume_s", 0.0)), 6),
            slo_breaches=int(svc.stats.get("slo_breaches", 0)),
            adapt_refits=int(svc.stats.get("adapt_refits", 0)),
            adapt=(svc.adapt.summary() if svc.adapt is not None else None),
            quarantined_windows=int(self.counters.get("quarantined_windows", 0)),
            ring_traces=len(self.ring),
            ring_evicted=self.ring.evicted,
            fault_spec=self.fault_spec,
            counters=dict(self.counters),
            ingest=dict(self.ingest_counters),
            wal=self.wal.stats() if self.wal is not None else None,
            faults=dict(
                retries=int(self.fleet_stats.get("fault_retries", 0)),
                bisections=int(self.fleet_stats.get("fault_bisections", 0)),
                host_fallbacks=int(self.fleet_stats.get("fault_host_fallbacks", 0)),
                quarantined=int(self.fleet_stats.get("fault_quarantined", 0)),
                injected=int(self.fleet_stats.get("faults_injected", 0)),
            ),
        )


class _Ticket:
    """One dispatch-ring entry: an admitted batch taken off its tenants'
    queues (:meth:`TenantService.submit_admitted`), through the lock-free
    device phase (``_ring_dispatch``), to the FIFO locked consume
    (:meth:`TenantService.complete_ticket`). It carries what the phases
    hand each other, so per-tenant ``in_flight`` accounting retires
    exactly this ticket's windows."""

    __slots__ = ("seq", "taken", "shared", "isolated", "prepared", "items",
                 "quarantined", "confidences", "outs", "local_stats", "solve_s",
                 "via_ring")

    def __init__(self, seq: int) -> None:
        self.seq = seq
        self.taken: List[Tuple["Tenant", List]] = []
        self.shared: List[Tuple["Tenant", List]] = []
        self.isolated: List[Tuple["Tenant", List]] = []
        self.prepared: List = []
        self.items: List = []
        self.quarantined: List[int] = []
        self.confidences: Optional[List] = None
        self.outs: List = []
        self.local_stats: Dict[str, float] = {}
        self.solve_s = 0.0
        self.via_ring = False


class TenantService:
    """The multi-tenant reconstruction service (the HTTP layer's model).

    Every public method is thread-safe: one re-entrant lock serializes
    tenancy state, and the device phase of a solve runs outside it.

    The in-flight dispatch ring (``cfg.inflight``, default 2): under the
    continuous dispatcher, :meth:`solve_admitted`'s three phases split
    into :meth:`submit_admitted` (locked take and prepare, returns a
    ticket), the lock-free device dispatch on a small worker pool, and
    :meth:`complete_ticket` (locked FIFO consume and emit), so the
    dispatcher admits and packs batch N+1 while batch N runs on the
    card. Consumes retire in ticket order, which keeps each tenant's
    emission order the serial loop's; ``inflight=1`` runs the serial
    composition.

    ``device=None`` means the card and raises without one."""

    def __init__(self, cfg: Optional[ServeConfig] = None, device=None) -> None:
        from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device

        self.cfg = cfg or ServeConfig()
        self.device = resolve_device(device)
        if self.cfg.state_dir:
            os.makedirs(self.cfg.state_dir, exist_ok=True)
        self.tenants: Dict[str, Tenant] = {}
        self._lock = threading.RLock()
        self.precision = self.cfg.precision
        # drain-aware readiness: flipped by begin_drain() the instant a
        # drain starts, so /readyz stops advertising a dying replica
        # before the listener closes
        self.draining = False
        # live-migration tombstones: a tenant moved off this replica must not
        # come back to life here on a late POST (its stream would fork
        # across replicas); its requests answer 410, so a router re-resolves
        self.migrated_out: Dict[str, float] = {}
        # the shared-dispatch ledger; the tenant id column breaks its
        # totals down per tenant (tenant_windows_* buckets)
        self.fleet_stats: Dict[str, float] = {}
        self.stats_counters: Dict[str, float] = dict(
            shared_solves=0, tenant_batches=0, isolated_solves=0,
            pumped_windows=0, drain_timeouts=0)
        self.dispatcher = None
        # an uncaught exception on the dispatcher thread degrades serving
        # to the fixed pump instead of wedging every tenant
        self.dispatcher_degraded = False
        # the in-flight dispatch ring: outstanding tickets by seq;
        # _ring_done counts retired ones (a consume runs when its seq
        # equals it: FIFO). The condition shares the service lock
        self._ring_limit = max(1, int(self.cfg.inflight or 1))
        self._ring_cond = threading.Condition(self._lock)
        self._ring_seq = 0
        self._ring_done = 0
        self._ring_outstanding: Dict[int, _Ticket] = {}
        self._ring_exc: Optional[BaseException] = None
        self._ring_queue: Optional[queue.Queue] = None
        self._ring_workers: List[threading.Thread] = []
        # overlap accounting under its own mutex (updated in the lock-free
        # device phase): busy = sum of ticket device walls, union = wall
        # with at least one ticket dispatching
        self._ring_mutex = threading.Lock()
        self._ring_active = 0
        self._ring_active_since = 0.0
        self._ring_busy_s = 0.0
        self._ring_union_s = 0.0
        # recent ticket retirements (monotonic time, windows): the live
        # drain rate Retry-After derives from
        self._ring_completions: deque = deque(maxlen=32)
        if self.cfg.continuous:
            from traceweaver_tpu_torch.serve.continuous import ContinuousDispatcher

            if self._ring_limit > 1:
                self._ring_queue = queue.Queue()
                for i in range(self._ring_limit):
                    w = threading.Thread(target=self._ring_worker,
                                         name=f"tw-serve-ring-{i}", daemon=True)
                    w.start()
                    self._ring_workers.append(w)
            self.dispatcher = ContinuousDispatcher(
                self, slo_ms=self.cfg.slo_p99_ms).start()
            _OBS_DISPATCHER_DEGRADED.set(0.0)

    def _bump(self, key: str, n: float = 1) -> None:
        """The pump ledger's one write path (callers hold the lock)."""
        _OBS_PUMP.inc(n, key=key)
        self.stats_counters[key] = self.stats_counters.get(key, 0) + n

    # -- tenancy ----------------------------------------------------------
    def tenant(self, tenant_id: str, create: bool = True) -> Tenant:
        with self._lock:
            t = self.tenants.get(tenant_id)
            if t is None:
                if tenant_id in self.migrated_out:
                    raise TenancyError(
                        f"tenant {tenant_id!r} migrated out of this replica "
                        "(route to its new home)")
                if not create:
                    raise KeyError(tenant_id)
                if len(self.tenants) >= self.cfg.max_tenants:
                    raise TenancyError(
                        f"tenant cap reached ({self.cfg.max_tenants}, "
                        f"max_tenants): refusing new tenant {tenant_id!r}")
                t = Tenant(tenant_id, self.cfg, device=self.device)
                self.tenants[tenant_id] = t
            return t

    def ingest(self, tenant_id: str, payload) -> Dict[str, int]:
        """Ingest one payload (raw Jaeger-JSON POST bytes, or a decoded
        dict) for one tenant. Under continuous batching the POST only
        seals and kicks the dispatcher; the fixed pump solves inline once
        enough sealed windows are queued across tenants."""
        with self._lock:
            summary = self.tenant(tenant_id).ingest_payload(payload)
            if self.dispatcher is None and self.total_backlog() >= self.cfg.pump_windows:
                summary["pumped_windows"] = self.pump()
        if self.dispatcher is not None:
            self.dispatcher.kick()
        return summary

    def wal_ingest(self, tenant_id: str, payload, raw: bytes,
                   client_seq: Optional[int] = None) -> Dict[str, int]:
        """Ledgered ingest: the raw wire bytes are appended to the
        tenant's WAL before the payload touches tenant state, so by the
        time the caller answers 200 the spans survive a kill (durability
        per ``cfg.wal_sync``; with ``wal=False`` nothing is appended). A ``client_seq`` already in the dedup
        window is a retry of a lost ack, answered with the original
        accounting, with no second append or ingest."""
        with self._lock:
            t = self.tenant(tenant_id)
            seen = t.wal_seen(client_seq)
            if seen is not None:
                t._bump("wal_deduped")
                return dict(ingested_traces=seen, ingested_spans=0,
                            rejected_traces=0,
                            malformed_spans=t.ingest_counters.get("malformed_spans", 0),
                            backlog=t.backlog, deduped=True, seq=int(client_seq))
            t.wal_append("spans", raw, client_seq=client_seq)
            summary = t.ingest_payload(payload)
            t.wal_note(client_seq, summary.get("ingested_traces", 0))
            if client_seq is not None:
                summary["seq"] = int(client_seq)
            if self.dispatcher is None and self.total_backlog() >= self.cfg.pump_windows:
                summary["pumped_windows"] = self.pump()
        if self.dispatcher is not None:
            self.dispatcher.kick()
        return summary

    def ingest_capture(self, tenant_id: str, captures,
                       source: Optional[str] = None) -> Dict[str, int]:
        """Capture ingestion for one tenant: raw log text or a
        ``{source: text}`` bundle, with :meth:`ingest`'s pump and kick
        rules."""
        with self._lock:
            summary = self.tenant(tenant_id).ingest_capture(captures, source=source)
            if self.dispatcher is None and self.total_backlog() >= self.cfg.pump_windows:
                summary["pumped_windows"] = self.pump()
        if self.dispatcher is not None:
            self.dispatcher.kick()
        return summary

    def wal_ingest_capture(self, tenant_id: str, captures, raw: bytes,
                           ctype: Optional[str] = None,
                           source: Optional[str] = None,
                           client_seq: Optional[int] = None) -> Dict[str, int]:
        """Ledgered capture ingest, :meth:`wal_ingest`'s twin: the raw body
        is appended with its source and body type (``ctype``: ``json`` or
        ``text``) in the record's head before the capture touches tenant
        state, so a replay repeats the same :meth:`Tenant.ingest_capture`
        call."""
        with self._lock:
            t = self.tenant(tenant_id)
            seen = t.wal_seen(client_seq)
            if seen is not None:
                t._bump("wal_deduped")
                return dict(ingested_spans=seen, backlog=t.backlog,
                            deduped=True, seq=int(client_seq))
            t.wal_append("capture", raw, client_seq=client_seq,
                         meta=dict(source=source, ctype=ctype))
            summary = t.ingest_capture(captures, source=source)
            t.wal_note(client_seq, summary.get("ingested_spans", 0))
            if client_seq is not None:
                summary["seq"] = int(client_seq)
            if self.dispatcher is None and self.total_backlog() >= self.cfg.pump_windows:
                summary["pumped_windows"] = self.pump()
        if self.dispatcher is not None:
            self.dispatcher.kick()
        return summary

    def run_adaptations(self) -> int:
        """Run every tenant's pending refits of the adaptation ladder.
        Out of band: each refit is a ``solve_fleet`` call of its own,
        never merged into an admission or pump dispatch; the pump and the
        continuous dispatcher call this after a solve retires. Returns the
        refits that landed."""
        with self._lock:
            n = 0
            for tid in sorted(self.tenants):
                n += self.tenants[tid].svc.maybe_adapt()
            if n:
                self._bump("adapt_refits", n)
            return n

    def total_backlog(self) -> int:
        with self._lock:
            return sum(t.backlog for t in self.tenants.values())

    def reset_latency_window(self) -> None:
        """Start a fresh seal→emit latency window on every tenant."""
        with self._lock:
            for t in self.tenants.values():
                t.svc.seal_emit_lat_s.clear()

    def in_flight_windows(self) -> int:
        """Windows the dispatcher took off the queues and is solving now
        (0 in pump mode)."""
        with self._lock:
            return sum(len(t.in_flight) for t in self.tenants.values())

    def _on_dispatcher_death(self, exc: BaseException) -> None:
        """Crash containment for the continuous dispatcher thread: the
        crash is counted and evented, the degraded gauge flips, every
        later ingest, flush and drain runs the fixed pump, and the
        backlog the dispatcher stranded is pumped now."""
        with self._lock:
            self.dispatcher = None
            self.dispatcher_degraded = True
            self._bump("dispatcher_crashes")
            _OBS_DISPATCHER_DEGRADED.set(1.0)
            _events.emit("serve", "dispatcher_degraded",
                         error="%s: %s" % (type(exc).__name__, exc))
        self._ring_shutdown()
        try:
            with self._lock:
                self.pump()
        except Exception as drain_exc:  # noqa: BLE001 - best-effort drain
            with self._lock:
                self._bump("dispatcher_drain_errors")
            _events.emit("serve", "dispatcher_drain_error",
                         error="%s: %s" % (type(drain_exc).__name__, drain_exc))

    # -- the shared pump --------------------------------------------------
    def pump(self) -> int:
        """Solve every queued micro-batch: healthy tenants merged into one
        shared fleet call, fault-spec'd tenants in isolated calls under
        their own fault plans. Returns windows solved."""
        with self._lock:
            shared: List[Tuple[Tenant, List]] = []
            isolated: List[Tuple[Tenant, List]] = []
            for tid in sorted(self.tenants):
                t = self.tenants[tid]
                batch = t.pop_batch()
                while batch:
                    (isolated if t.fault_spec else shared).append((t, batch))
                    batch = t.pop_batch()
            n = 0
            if shared:
                n += self._solve_shared(shared)
            for t, batch in isolated:
                n += self._solve_isolated(t, batch)
            for tid in sorted(self.tenants):
                t = self.tenants[tid]
                # WAL group commit rides the pump cadence
                t.wal_sync()
                if t.ckpt_path and t.svc._since_checkpoint >= self.cfg.checkpoint_every:
                    t.checkpoint()
            self._bump("pumped_windows", n)
        # refits run after the pump retires, never inside its dispatch
        self.run_adaptations()
        return n

    def solve_admitted(self, plan: List[Tuple[Tenant, List]]) -> int:
        """Solve an admission batch (``[(tenant, [bufs])]``) serially:
        submit, dispatch on the calling thread, consume. The
        ``inflight=1`` path, the drain path and the reference the ring's
        overlapped composition is held to. The dispatch runs outside the
        service lock. Returns windows solved."""
        ticket = self.submit_admitted(plan)
        if ticket is None:
            return 0
        self._ring_dispatch(ticket)
        return self.complete_ticket(ticket)

    # -- the in-flight dispatch ring --------------------------------------
    # per-tenant in_flight lists change only here (submit extends,
    # complete and abort retire by ticket identity), under the lock
    def submit_admitted(self, plan: List[Tuple[Tenant, List]]) -> Optional[_Ticket]:
        """Phase 1, locked: take the admitted windows off their tenants'
        queues (identity-matched: at most once against a racing flush),
        split shared and isolated, mark every taken window in flight on
        its tenant and build the fleet items. None when a concurrent
        take already drained every window."""
        with self._lock:
            ticket = _Ticket(self._ring_seq)
            for t, bufs in plan:
                if self.tenants.get(t.id) is not t:
                    continue
                taken = t.svc.scheduler.take(bufs)
                if taken:
                    ticket.taken.append((t, taken))
                    (ticket.isolated if t.fault_spec else ticket.shared).append((t, taken))
            if not ticket.taken:
                return None
            self._ring_seq += 1
            for t, bufs in ticket.taken:
                t.in_flight.extend(bufs)
            ticket.prepared, ticket.items = self._prepare_shared(ticket.shared)
            if self.cfg.confidence:
                ticket.confidences = [None] * len(ticket.items)
            self._ring_outstanding[ticket.seq] = ticket
            self._bump("ring_submitted")
            _OBS_INFLIGHT.set(float(len(self._ring_outstanding)))
            _events.emit("serve", "ring_ticket_submitted", **_ticket_fields(ticket))
            return ticket

    def launch_ticket(self, ticket: _Ticket) -> None:
        """Hand a submitted ticket to the ring's workers (dispatch and
        FIFO complete run there); the dispatcher goes back to admitting."""
        ticket.via_ring = True
        q = self._ring_queue
        if q is None:  # the ring shut down meanwhile: serial
            self._ring_dispatch(ticket)
            self.complete_ticket(ticket)
            return
        q.put(ticket)

    def _ring_dispatch(self, ticket: _Ticket) -> None:
        """Phase 2, lock-free: the device dispatch. The fleet ledger goes
        to the ticket's local dict (merged at complete), and the overlap
        interval union is kept under its own mutex."""
        t_in = time.monotonic()
        with self._ring_mutex:
            if self._ring_active == 0:
                self._ring_active_since = t_in
            self._ring_active += 1
        try:
            t0 = time.perf_counter()
            ticket.outs = self._dispatch_shared(ticket.items, ticket.quarantined,
                                                ticket.confidences,
                                                stats=ticket.local_stats)
            ticket.solve_s = time.perf_counter() - t0
        finally:
            t_out = time.monotonic()
            with self._ring_mutex:
                self._ring_active -= 1
                self._ring_busy_s += t_out - t_in
                if self._ring_active == 0:
                    self._ring_union_s += t_out - self._ring_active_since

    def complete_ticket(self, ticket: _Ticket) -> int:
        """Phase 3, locked, FIFO: wait for the ticket's turn, merge its
        fleet ledger, consume and emit the shared results, retire its
        windows from their tenants' in-flight sets, run the isolated
        solves and checkpoint on cadence, skipping any tenant that still
        has windows in flight on another ticket (a checkpoint holds the
        queues, not windows in flight)."""
        n = 0
        with self._ring_cond:
            while self._ring_done < ticket.seq:
                self._ring_cond.wait(timeout=0.25)
            try:
                _merge_stats(self.fleet_stats, ticket.local_stats)
                if ticket.shared:
                    n = self._consume_shared(
                        ticket.prepared, len(ticket.items), len(ticket.shared),
                        ticket.outs, ticket.quarantined, ticket.confidences,
                        ticket.solve_s)
                self._ring_retire_locked(ticket)
                for t, bufs in ticket.isolated:
                    n += self._solve_isolated(t, bufs)
                for tid in sorted(self.tenants):
                    t = self.tenants[tid]
                    t.wal_sync()  # group commit on the consume cadence
                    if t.in_flight:
                        continue
                    if t.ckpt_path and t.svc._since_checkpoint >= self.cfg.checkpoint_every:
                        t.checkpoint()
                self._bump("pumped_windows", n)
                self._bump("continuous_dispatches")
                self._bump("ring_completed")
                _events.emit("serve", "ring_ticket_completed", **_ticket_fields(ticket))
                self._ring_completions.append((time.monotonic(), n))
                if ticket.via_ring and self.dispatcher is not None:
                    self.dispatcher.note_solve(ticket.solve_s, n)
            finally:
                # idempotent: an exception mid-consume must still advance
                # the ring, or FIFO waiters would wedge
                self._ring_retire_locked(ticket)
        return n

    def _ring_retire_locked(self, ticket: _Ticket) -> None:
        """Retire one ticket (idempotent). Every caller holds the service
        lock already; taking the re-entrant lock again keeps it so."""
        with self._lock:
            if self._ring_outstanding.pop(ticket.seq, None) is None:
                return
            for t, bufs in ticket.taken:
                drop = {id(b) for b in bufs}
                t.in_flight[:] = [b for b in t.in_flight if id(b) not in drop]
            self._ring_done = ticket.seq + 1
            _OBS_INFLIGHT.set(float(len(self._ring_outstanding)))
            _OBS_OVERLAP.set(self.overlap_pct())
            self._ring_cond.notify_all()

    def _ring_worker(self) -> None:
        """One ring worker: dispatch lock-free, then the FIFO locked
        complete. A dispatch error re-queues the ticket's windows (they
        never reached a sink); a complete error only retires (results may
        be partly emitted). Either way the error is raised on the
        dispatcher thread, whose crash containment degrades to the pump."""
        q = self._ring_queue
        while True:
            ticket = q.get()
            if ticket is None:
                return
            try:
                self._ring_dispatch(ticket)
            except Exception as e:  # noqa: BLE001 - containment
                self._ring_abort(ticket, e, requeue=True)
                continue
            try:
                self.complete_ticket(ticket)
            except Exception as e:  # noqa: BLE001 - containment
                self._ring_abort(ticket, e, requeue=False)

    def _ring_abort(self, ticket: _Ticket, exc: BaseException, requeue: bool) -> None:
        with self._ring_cond:
            while self._ring_done < ticket.seq and ticket.seq in self._ring_outstanding:
                self._ring_cond.wait(timeout=0.25)
            if requeue and ticket.seq in self._ring_outstanding:
                for t, bufs in ticket.taken:
                    if self.tenants.get(t.id) is t:
                        for b in bufs:
                            t.svc.scheduler.offer(b)
            self._ring_retire_locked(ticket)
            if self._ring_exc is None:
                self._ring_exc = exc
            self._bump("ring_aborted")
        _events.emit("serve", "ring_ticket_aborted", seq=ticket.seq, requeued=requeue,
                     error="%s: %s" % (type(exc).__name__, exc))

    @property
    def ring_enabled(self) -> bool:
        """True while the overlapped ring is live (``inflight`` > 1 and
        its workers running)."""
        return self._ring_queue is not None

    def ring_throttle(self) -> None:
        """Dispatcher-side back edge: block while the ring is full, then
        raise any worker error on the dispatcher thread."""
        with self._ring_cond:
            while self._ring_exc is None and len(self._ring_outstanding) >= self._ring_limit:
                self._ring_cond.wait(timeout=0.25)
        self.ring_raise_pending()

    def ring_raise_pending(self) -> None:
        """Re-raise (once) the first ring-worker error on the caller's
        thread."""
        with self._lock:
            exc, self._ring_exc = self._ring_exc, None
        if exc is not None:
            raise exc

    def wait_idle(self, timeout_s: Optional[float] = None) -> bool:
        """Barrier on every outstanding ticket. False on timeout."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._ring_cond:
            while self._ring_outstanding:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._ring_cond.wait(timeout=0.1)
        return True

    def overlap_pct(self) -> float:
        """Percent of ring device wall that overlapped another ticket,
        ``100*(1 - union/busy)``; 0 under the serial dispatcher."""
        with self._ring_mutex:
            busy, union = self._ring_busy_s, self._ring_union_s
        if busy <= 0.0:
            return 0.0
        return max(0.0, 100.0 * (1.0 - union / busy))

    def _ring_shutdown(self, timeout_s: float = 10.0) -> None:
        """Stop the ring's workers (a sentinel each; queued tickets ahead
        of them complete first)."""
        q, self._ring_queue = self._ring_queue, None
        if q is None:
            return
        for _ in self._ring_workers:
            q.put(None)
        for w in self._ring_workers:
            w.join(timeout=timeout_s)
        self._ring_workers = []

    # -- the shared solve, in three phases --------------------------------
    def _prepare_shared(self, batches: List[Tuple[Tenant, List]]):
        """Fleet items of a shared solve (the caller holds the lock)."""
        prepared = []
        items: List = []
        for t, bufs in batches:
            per_buf, t_items, t_owners = t.svc.prepare_batch_items(bufs, tenant=t.id)
            lo = len(items)
            items.extend(t_items)
            prepared.append((t, bufs, per_buf, t_owners, lo, len(items)))
        return prepared, items

    def _solve_fleet(self, items: List, stats: Dict, quarantined: List,
                     confidences: Optional[List], plan=None) -> List:
        from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

        return solve_fleet(items, stats=stats, precision=self.precision,
                           quarantined=quarantined, confidences=confidences,
                           faults=plan if plan is not None else faults.active(),
                           device=self.device, devcols=self.cfg.devcols,
                           ring_capacity=self.cfg.ring_capacity)

    def _dispatch_shared(self, items: List, quarantined: List,
                         confidences: Optional[List],
                         stats: Optional[Dict] = None) -> List:
        """The device phase: needs no service lock (``stats`` defaults to
        the shared ledger for locked callers; lock-free callers pass a
        local dict and merge after)."""
        if not items:
            return []
        return self._solve_fleet(items, self.fleet_stats if stats is None else stats,
                                 quarantined, confidences)

    def _consume_shared(self, prepared, n_items: int, n_batches: int, outs,
                        quarantined: List, confidences: Optional[List],
                        solve_s: float) -> int:
        """Decode and emit (the caller holds the lock)."""
        self._bump("shared_solves")
        self._bump("tenant_batches", n_batches)
        n = 0
        for t, bufs, per_buf, t_owners, lo, hi in prepared:
            share = solve_s * (hi - lo) / max(1, n_items)
            t.svc._bump("solve_s", share)
            results = t.svc.consume_batch_results(
                bufs, per_buf, t_owners, outs[lo:hi],
                [k - lo for k in quarantined if lo <= k < hi], share,
                confidences=confidences[lo:hi] if confidences is not None else None)
            t.emit_results(results)
            n += len(bufs)
        return n

    def _solve_shared(self, batches: List[Tuple[Tenant, List]]) -> int:
        t0 = time.perf_counter()
        prepared, items = self._prepare_shared(batches)
        quarantined: List[int] = []
        confidences = [None] * len(items) if self.cfg.confidence else None
        outs = self._dispatch_shared(items, quarantined, confidences)
        solve_s = time.perf_counter() - t0
        return self._consume_shared(prepared, len(items), len(batches), outs,
                                    quarantined, confidences, solve_s)

    def _solve_isolated(self, t: Tenant, bufs: List) -> int:
        """A fault-spec'd tenant's batch in its own dispatch under its own
        fault plan: the storm walks the supervisor's ladder inside this
        tenant's solve only."""
        t0 = time.perf_counter()
        per_buf, items, owners = t.svc.prepare_batch_items(bufs, tenant=t.id)
        quarantined: List[int] = []
        outs: List = []
        confidences = [None] * len(items) if self.cfg.confidence else None
        if items:
            plan = t.fault_plan()
            with faults.override_plan(plan):
                outs = self._solve_fleet(items, t.fleet_stats, quarantined,
                                         confidences, plan=plan)
        solve_s = time.perf_counter() - t0
        t.svc._bump("solve_s", solve_s)
        self._bump("isolated_solves")
        results = t.svc.consume_batch_results(bufs, per_buf, owners, outs,
                                              quarantined, solve_s,
                                              confidences=confidences)
        t.emit_results(results)
        return len(bufs)

    # -- flush / drain / resume -------------------------------------------
    def flush(self, tenant_id: Optional[str] = None) -> Dict[str, int]:
        """Seal every open window (one tenant's, or all) and solve the
        backlog: through the dispatcher's admission-sized chunks under
        continuous batching, in one pump otherwise."""
        with self._lock:
            targets = ([self.tenant(tenant_id, create=False)] if tenant_id
                       else list(self.tenants.values()))
            sealed = sum(t.flush() for t in targets)
        if self.dispatcher is not None:
            solved = self.dispatcher.drain_backlog()
            self.run_adaptations()
        else:
            with self._lock:
                solved = self.pump()
        return dict(sealed_windows=sealed, solved_windows=solved)

    def checkpoint_all(self, timeout_s: Optional[float] = None) -> Dict[str, int]:
        """Checkpoint every tenant within the drain budget, after a
        (bounded) barrier on the dispatch ring; a tenant still holding
        windows in flight is skipped (its last good checkpoint stays)."""
        budget = self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        t0 = time.monotonic()
        self.wait_idle(budget)
        done = skipped = timed_out = 0
        with self._lock:
            for tid in sorted(self.tenants):
                if self.tenants[tid].in_flight:
                    skipped += 1
                    continue
                if time.monotonic() - t0 > budget:
                    timed_out += 1
                    self._bump("drain_timeouts")
                    continue
                if self.tenants[tid].checkpoint():
                    done += 1
                else:
                    skipped += 1
        return dict(checkpointed=done, skipped=skipped, timed_out=timed_out)

    def begin_drain(self) -> None:
        """Mark the service draining: ``/readyz`` answers 503 from now on."""
        with self._lock:
            if self.draining:
                return
            self.draining = True
        _events.emit("serve", "draining")

    def retry_after(self, tenant_id: str) -> Optional[float]:
        """Suggested client back-off (seconds) when this tenant's sealed
        window queues are within a small headroom of their hard bound,
        else None: the queue position times the ring's live drain pace
        (falling back to the solve EWMA, then the tenant's seal→emit
        p99). Kicks the dispatcher."""
        with self._lock:
            t = self.tenants.get(tenant_id)
            if t is None:
                return None
            sched = t.svc.scheduler
            bound = sched.max_pending + sched.spill_max
            headroom = min(4, bound - 1)
            if sched.backlog < bound - headroom:
                return None
            self._bump("backpressure_429s")
            pace_s = self._drain_pace_locked(t)
            wait = min(max(0.1, sched.backlog * pace_s), self.cfg.drain_timeout_s)
        _OBS_RETRY_AFTER.observe(wait)
        if self.dispatcher is not None:
            self.dispatcher.kick()
        return round(wait, 2)

    def _drain_pace_locked(self, t: Tenant) -> float:
        """Seconds a window the drain is sustaining (the caller holds the
        lock)."""
        comps = [c for c in self._ring_completions if c[0] >= time.monotonic() - 30.0]
        if len(comps) >= 2:
            span = comps[-1][0] - comps[0][0]
            windows = sum(n for _, n in comps[1:])
            if span > 0.0 and windows > 0:
                return max(0.001, span / windows)
        if self.dispatcher is not None:
            fill = max(1, min(self.cfg.pump_windows, self.cfg.max_pending))
            return max(0.005, self.dispatcher.solve_ewma_s / fill)
        return max(0.05, (t.svc.seal_emit_p99_ms() or 1000.0) / 1000.0)

    # -- live migration ---------------------------------------------------
    def migrate_out(self, tenant_id: str) -> Dict[str, object]:
        """Source half of live migration: checkpoint the tenant (open and
        queued windows, ring, counters: nothing is sealed early), read back
        the CRC-verified checkpoint and the sink and dead-letter bytes its
        offset splice refers to, then remove and tombstone the tenant here.
        Returns the JSON transfer :meth:`migrate_in` installs.

        Windows a ticket has taken but not retired sit in no queue, so a
        checkpoint taken then would lose them: the migration waits for the
        tenant's in-flight windows to retire (each ticket's complete or
        abort retires its own, under the lock), within the drain budget."""
        deadline = time.monotonic() + self.cfg.drain_timeout_s
        while True:
            with self._lock:
                t = self.tenant(tenant_id, create=False)  # KeyError -> 404
                if not t.in_flight:
                    return self._migrate_out_locked(tenant_id, t)
            if time.monotonic() >= deadline:
                raise TenancyError(
                    f"tenant {tenant_id!r}: in-flight dispatch did not retire "
                    f"within the drain budget ({self.cfg.drain_timeout_s:.0f}s, "
                    "drain_timeout_s); migration aborted (tenant stays live here)")
            time.sleep(0.02)

    def _migrate_out_locked(self, tenant_id: str, t: Tenant) -> Dict[str, object]:
        """The checkpoint-and-tombstone half of :meth:`migrate_out`; the
        caller holds the lock and saw ``t.in_flight`` empty."""
        if not t.ckpt_path:
            raise TenancyError(
                "live migration needs a state dir (per-tenant checkpoints are "
                "the transfer unit); restart serve with --state-dir")
        if not t.checkpoint():
            raise RuntimeError(f"tenant {tenant_id!r}: checkpoint write failed; "
                               "migration aborted (tenant stays live here)")
        ckpt = read_checkpoint_bytes(t.ckpt_path)
        sink_b = b""
        if t.svc.sink is not None:
            t.svc.sink.close()
            with open(t.svc.sink.path, "rb") as f:
                sink_b = f.read()
        dlq_b = b""
        if t.svc.deadletter is not None:
            t.svc.deadletter.close()
            if os.path.exists(t.svc.deadletter.path):
                with open(t.svc.deadletter.path, "rb") as f:
                    dlq_b = f.read()
        # the checkpoint just written covers the whole WAL (appends apply
        # synchronously, nothing is in flight), so the log does not travel;
        # it stays here with the checkpoint, under the tombstone (which no
        # resume or crash failover reads past), until migrate_commit or
        # migrate_abort settles the migration
        t.close()
        del self.tenants[tenant_id]
        # its solves are over: its resident column rings go now, after
        # their last gather, so their slots leave the card
        _devcols.get_store().drop_tenant(tenant_id)
        now = time.time()
        # twlint: disable=TW005 — the caller (migrate_out) holds the service
        # lock across this whole helper
        self.migrated_out[tenant_id] = now
        _write_marker(t.dir, tenant_id, now)
        self._bump("migrations_out")
        _events.emit("fleet", "migrate_out", tenant=tenant_id,
                     checkpoint_bytes=len(ckpt), sink_bytes=len(sink_b))
        return dict(tenant=tenant_id,
                    checkpoint_b64=base64.b64encode(ckpt).decode("ascii"),
                    sink_b64=base64.b64encode(sink_b).decode("ascii"),
                    deadletter_b64=base64.b64encode(dlq_b).decode("ascii"))

    def migrate_in(self, tenant_id: str, transfer: Dict[str, object]) -> Dict[str, object]:
        """Destination half: install the transferred sink and dead-letter
        bytes, the verified checkpoint and (a crash failover's) WAL tail
        under this replica's state dir, then resume the tenant as a restart
        would. The checkpoint's offset splice truncates the sink back to
        the checkpointed byte, so the migrated tenant's output stays
        byte-identical to an unmigrated run. Its device-resident rings are
        built afresh at its first solve."""
        if not self.cfg.state_dir:
            raise TenancyError("live migration needs a state dir on the destination "
                               "replica too; restart serve with --state-dir")
        try:
            ckpt = base64.b64decode(transfer.get("checkpoint_b64", "") or "")
            sink_b = base64.b64decode(transfer.get("sink_b64", "") or "")
            dlq_b = base64.b64decode(transfer.get("deadletter_b64", "") or "")
            wal_b = base64.b64decode(transfer.get("wal_b64", "") or "")
        except (TypeError, ValueError, AttributeError) as e:
            raise TenancyError(f"malformed migration transfer: {e}") from None
        if not ckpt and not wal_b:
            raise TenancyError("malformed migration transfer: neither checkpoint_b64 "
                               "nor wal_b64 present")
        with self._lock:
            if tenant_id in self.tenants:
                raise TenancyError(f"tenant {tenant_id!r} already live on this replica: "
                                   "refusing migrate_in (forked state)")
            if len(self.tenants) >= self.cfg.max_tenants:
                raise TenancyError(
                    f"tenant cap reached ({self.cfg.max_tenants}, max_tenants): "
                    f"refusing migrated tenant {tenant_id!r}")
            if not _TENANT_ID_RE.fullmatch(tenant_id):
                raise TenancyError(f"invalid tenant id {tenant_id!r}")
            tdir = os.path.join(self.cfg.state_dir, tenant_id)
            if ckpt:
                try:
                    verify_checkpoint_bytes(ckpt)
                except CheckpointCorrupt as e:
                    raise TenancyError(f"torn migration transfer: {e}") from None
            # tombstoned until the install is whole: a crash midway leaves
            # no half-installed tenant for a resume to mint, and what an
            # earlier stay left here (an unsettled migrate_out) goes
            os.makedirs(tdir, exist_ok=True)
            now = time.time()
            _write_marker(tdir, tenant_id, now)
            try:
                _discard_tenant_state(tdir)
                if ckpt:
                    write_checkpoint_bytes(os.path.join(tdir, "ckpt.pkl"), ckpt)
                sink_path = os.path.join(tdir, "traces.jsonl")
                with open(sink_path, "wb") as f:
                    f.write(sink_b)
                with open(sink_path + ".deadletter.jsonl", "wb") as f:
                    f.write(dlq_b)
                if wal_b:
                    # a crash failover's WAL tail, installed before the
                    # resume replays it (a torn tail in the copy is cut here)
                    _walmod.install_bytes(os.path.join(tdir, "wal"), wal_b)
                # a tenant coming back starts from fresh rings
                _devcols.get_store().drop_tenant(tenant_id)
                t = Tenant.recover(tenant_id, self.cfg, device=self.device)
            except BaseException:
                # the tombstone stays on disk; answer for it as a restart would
                self.migrated_out.setdefault(tenant_id, now)
                raise
            os.remove(os.path.join(tdir, MIGRATED_MARKER))
            self.tenants[tenant_id] = t
            self.migrated_out.pop(tenant_id, None)
            self._bump("migrations_in")
            backlog = t.backlog
        if self.dispatcher is not None:
            self.dispatcher.kick()
        _events.emit("fleet", "migrate_in", tenant=tenant_id, backlog=backlog)
        return dict(tenant=tenant_id, backlog=backlog, ring_traces=len(t.ring))

    def migrate_commit(self, tenant_id: str) -> Dict[str, object]:
        """Settle a migration whose destination holds the tenant: delete
        the checkpoint generations and WAL that :meth:`migrate_out` left
        under the tombstone (idempotent)."""
        with self._lock:
            if tenant_id in self.tenants or tenant_id not in self.migrated_out:
                raise TenancyError(f"tenant {tenant_id!r} has no migration to "
                                   "commit on this replica")
            _discard_tenant_state(os.path.join(self.cfg.state_dir, tenant_id))
        _events.emit("fleet", "migrate_commit", tenant=tenant_id)
        return dict(tenant=tenant_id, committed=True)

    def migrate_abort(self, tenant_id: str) -> Dict[str, object]:
        """Undo :meth:`migrate_out` when the destination refused the
        tenant: resume it from the checkpoint and WAL left under the
        tombstone, as a restart would, and lift the tombstone. The
        tenant's slot was its own, so the tenant cap does not refuse it."""
        with self._lock:
            if tenant_id in self.tenants or tenant_id not in self.migrated_out:
                raise TenancyError(f"tenant {tenant_id!r} has no migration to "
                                   "abort on this replica")
            tdir = os.path.join(self.cfg.state_dir, tenant_id)
            if not os.path.isfile(os.path.join(tdir, "ckpt.pkl")):
                raise TenancyError(f"tenant {tenant_id!r}: its migration was "
                                   "committed; nothing to resume here")
            t = Tenant.recover(tenant_id, self.cfg, device=self.device)
            os.remove(os.path.join(tdir, MIGRATED_MARKER))
            self.tenants[tenant_id] = t
            self.migrated_out.pop(tenant_id, None)
            self._bump("migrations_aborted")
            backlog = t.backlog
        if self.dispatcher is not None:
            self.dispatcher.kick()
        _events.emit("fleet", "migrate_abort", tenant=tenant_id, backlog=backlog)
        return dict(tenant=tenant_id, backlog=backlog)

    def drain(self) -> Dict[str, int]:
        """Graceful drain (the SIGTERM path): stop the dispatcher, barrier
        on every outstanding ticket and retire the workers, checkpoint
        every tenant within the drain budget, then close sinks and logs.
        Open windows ride the checkpoints."""
        self.begin_drain()
        if self.dispatcher is not None:
            self.dispatcher.stop()
        self.wait_idle(self.cfg.drain_timeout_s)
        self._ring_shutdown()
        out = self.checkpoint_all()
        with self._lock:
            for t in self.tenants.values():
                t.close()
            return out

    @classmethod
    def resume(cls, cfg: ServeConfig, device=None) -> "TenantService":
        """Restart from ``cfg.state_dir``: a subdirectory with a checkpoint
        becomes a resumed tenant, one with only a WAL (killed before its
        first checkpoint) a recovered one, and one with a migration
        tombstone stays tombstoned (its requests keep answering 410)."""
        svc = cls(cfg, device=device)
        if cfg.state_dir and os.path.isdir(cfg.state_dir):
            for name in sorted(os.listdir(cfg.state_dir)):
                ckpt = os.path.join(cfg.state_dir, name, "ckpt.pkl")
                marker = os.path.join(cfg.state_dir, name, MIGRATED_MARKER)
                # the tombstone first: the state an unsettled migration
                # keeps beside it must not resume
                if os.path.isfile(marker):
                    try:
                        with open(marker) as f:
                            ts = float(json.load(f).get("migrated_unix", 0.0))
                    except (ValueError, OSError):
                        ts = 0.0
                    with svc._lock:
                        svc.migrated_out[name] = ts
                elif os.path.isfile(ckpt):
                    with svc._lock:
                        svc.tenants[name] = Tenant.resume(name, cfg, device=svc.device)
                elif cfg.wal and _walmod.list_segments(
                        os.path.join(cfg.state_dir, name, "wal")):
                    with svc._lock:
                        svc.tenants[name] = Tenant.recover(name, cfg, device=svc.device)
        return svc

    # -- queries ----------------------------------------------------------
    def query_delay_culprit(self, tenant_id: str, percentile: float = 0.95,
                            after_us: Optional[float] = None,
                            min_confidence: Optional[float] = None) -> Dict:
        with self._lock:
            t = self.tenant(tenant_id, create=False)
            return live_delay_culprit(t.ring.records(), percentile, after_us,
                                      min_confidence=min_confidence)

    def query_low_confidence(self, tenant_id: str, limit: int = 20,
                             max_conf: Optional[float] = None) -> Dict:
        """The ring's least-trusted reconstructions, ascending by
        confidence; ``max_conf`` defaults to ``cfg.conf_low``."""
        if max_conf is None:
            max_conf = self.cfg.conf_low
        with self._lock:
            records = self.tenant(tenant_id, create=False).ring.records()
        scored = [r for r in records if r.get("tw.confidence")]
        scored.sort(key=lambda r: (r["tw.confidence"]["conf"], r["trace_id"]))
        low = [r for r in scored if r["tw.confidence"]["conf"] <= max_conf]
        return dict(
            n_traces=len(records), n_scored=len(scored), n_low=len(low),
            max_conf=max_conf,
            traces=[dict(trace_id=r["trace_id"], confidence=r["tw.confidence"]["conf"],
                         mean_confidence=r["tw.confidence"].get("mean"),
                         window=r.get("window"), e2e_us=r.get("e2e_us"),
                         n_spans=r.get("n_spans"))
                    for r in low[:max(0, int(limit))]])

    def trace_ids(self, tenant_id: str) -> List[str]:
        with self._lock:
            return self.tenant(tenant_id, create=False).ring.ids()

    def trace(self, tenant_id: str, trace_id: str) -> Optional[Dict]:
        with self._lock:
            return self.tenant(tenant_id, create=False).ring.get(trace_id)

    #: per-tenant stats() fields exposed on /metrics, name for name
    _METRIC_TENANT_FIELDS = (
        "consumed", "emitted_windows", "spans_emitted", "traces_emitted",
        "backlog", "solved_windows", "shed_spilled",
        "shed_dropped_windows", "shed_dropped_spans", "late_rerouted",
        "late_dropped", "deadletter_windows", "deadletter_spans",
        "low_confidence_traces", "seal_emit_p99_ms", "slo_breaches",
        "adapt_refits", "quarantined_windows", "ring_traces",
        "ring_evicted", "parse_s", "stitch_s", "emit_s", "consume_s")

    def metrics_families(self) -> List:
        """Collector-style families for ``GET /metrics`` (``(name, kind,
        help, [(labels, value), ...])``), derived at scrape time from the
        same :meth:`stats` call ``/api/v1/stats`` serves, so the two
        agree by construction."""
        st = self.stats()
        tenants = st["tenants"]
        fams: List = [
            ("tw_serve_tenants", "gauge", "live tenant count",
             [({}, float(st["n_tenants"]))]),
            ("tw_serve_backlog_windows", "gauge",
             "sealed windows awaiting solve, all tenants",
             [({}, float(st["total_backlog"]))]),
            ("tw_serve_dispatch_total", "counter",
             "service-wide dispatch ledger (= /api/v1/stats .dispatch)",
             [({"kind": k}, float(v)) for k, v in sorted(st["dispatch"].items())]),
        ]
        fams.append((
            "tw_serve_tenant_total", "counter",
            "per-tenant window ledger (= /api/v1/stats .tenants.*)",
            [({"tenant": tid, "key": field}, float(t[field]))
             for tid, t in sorted(tenants.items())
             for field in self._METRIC_TENANT_FIELDS]))
        fams.append((
            "tw_serve_tenant_faults_total", "counter",
            "per-tenant solve-supervisor ladder (= /api/v1/stats .tenants.*.faults)",
            [({"tenant": tid, "rung": rung}, float(v))
             for tid, t in sorted(tenants.items())
             for rung, v in sorted(t["faults"].items())]))
        return fams

    def stats(self, tenant_id: Optional[str] = None) -> Dict:
        with self._lock:
            if tenant_id is not None:
                return self.tenant(tenant_id, create=False).stats()
            fleet = {k: v for k, v in self.fleet_stats.items()
                     if not isinstance(v, list)}
            sc = self.stats_counters
            return dict(
                precision=self.precision,
                device=str(self.device),
                n_tenants=len(self.tenants),
                max_tenants=self.cfg.max_tenants,
                total_backlog=sum(t.backlog for t in self.tenants.values()),
                dispatch=dict(
                    fleet_dispatches=int(self.fleet_stats.get("fleet_dispatches", 0)),
                    shared_solves=int(sc["shared_solves"]),
                    tenant_batches=int(sc["tenant_batches"]),
                    isolated_solves=int(sc["isolated_solves"]),
                    pumped_windows=int(sc["pumped_windows"]),
                    continuous_dispatches=int(sc.get("continuous_dispatches", 0)),
                    adapt_refits=int(sc.get("adapt_refits", 0)),
                    dispatcher_crashes=int(sc.get("dispatcher_crashes", 0)),
                    migrations_out=int(sc.get("migrations_out", 0)),
                    migrations_in=int(sc.get("migrations_in", 0)),
                    backpressure_429s=int(sc.get("backpressure_429s", 0)),
                ),
                draining=self.draining,
                migrated_out=sorted(self.migrated_out),
                dispatcher_degraded=self.dispatcher_degraded,
                continuous=(self.dispatcher.stats()
                            if self.dispatcher is not None else None),
                ring=dict(
                    inflight_limit=self._ring_limit,
                    enabled=self.ring_enabled,
                    outstanding=len(self._ring_outstanding),
                    submitted=int(sc.get("ring_submitted", 0)),
                    completed=int(sc.get("ring_completed", 0)),
                    aborted=int(sc.get("ring_aborted", 0)),
                    overlap_pct=round(self.overlap_pct(), 2),
                    busy_s=round(self._ring_busy_s, 6),
                    union_s=round(self._ring_union_s, 6),
                ),
                fleet=fleet,
                kernels=_ops.kernel_counts(),
                tenants={tid: t.stats() for tid, t in sorted(self.tenants.items())},
            )


def read_crashed_transfer(tenant_dir: str, tenant_id: str) -> Dict[str, object]:
    """A :meth:`TenantService.migrate_in` transfer built from a crashed
    replica's disk (the failover half of crash recovery,
    ``fleet_serve/manager.py``). No live service to quiesce: the
    checkpoint may be stale or absent (a tenant never checkpointed), and
    the WAL tail carries every payload acknowledged after it, which the
    destination's resume replays. A primary checkpoint that fails its CRC
    falls back to the rotated ``.prev``; sink bytes past the checkpointed
    offset are spliced off by the resume, as on a restart."""
    ckpt_b = b""
    ckpt_path = os.path.join(tenant_dir, "ckpt.pkl")
    for path in (ckpt_path, ckpt_path + ".prev"):
        if not os.path.isfile(path):
            continue
        try:
            ckpt_b = read_checkpoint_bytes(path)
            break
        except (CheckpointCorrupt, OSError):
            continue
    sink_b = dlq_b = b""
    sink_path = os.path.join(tenant_dir, "traces.jsonl")
    if os.path.isfile(sink_path):
        with open(sink_path, "rb") as f:
            sink_b = f.read()
    if os.path.isfile(sink_path + ".deadletter.jsonl"):
        with open(sink_path + ".deadletter.jsonl", "rb") as f:
            dlq_b = f.read()
    wal_b = _walmod.read_all_bytes(os.path.join(tenant_dir, "wal"))
    if not ckpt_b and not wal_b:
        raise TenancyError(f"tenant {tenant_id!r}: no recoverable state under "
                           f"{tenant_dir} (no readable checkpoint, empty WAL)")
    return dict(tenant=tenant_id,
                checkpoint_b64=base64.b64encode(ckpt_b).decode("ascii"),
                sink_b64=base64.b64encode(sink_b).decode("ascii"),
                deadletter_b64=base64.b64encode(dlq_b).decode("ascii"),
                wal_b64=base64.b64encode(wal_b).decode("ascii"))


def tombstone_crashed_tenant(tenant_dir: str, tenant_id: str) -> None:
    """After a failover, on the crashed replica's disk: the tenant lives on
    a survivor now, so a durable :data:`MIGRATED_MARKER` goes down and its
    checkpoint generations and WAL go; the dead replica, respawned with
    ``--resume``, re-tombstones it rather than minting a forked twin."""
    _write_marker(tenant_dir, tenant_id, time.time())
    _discard_tenant_state(tenant_dir)


def _ticket_fields(ticket: _Ticket) -> Dict[str, object]:
    """A ring ticket's event fields: its process and sequence, and each
    tenant's windows in it by index, so that the solve batches of a run
    can be read back (and replayed) from the event sink."""
    return dict(pid=os.getpid(), seq=ticket.seq,
                windows={t.id: [b.k for b in bufs] for t, bufs in ticket.taken})


def _write_marker(tenant_dir: str, tenant_id: str, ts: float) -> None:
    """Put down the tenant's :data:`MIGRATED_MARKER` (durably: it is what
    keeps a resume from reading the state beside it)."""
    path = os.path.join(tenant_dir, MIGRATED_MARKER)
    with open(path + ".tmp", "w") as f:
        json.dump({"tenant": tenant_id, "migrated_unix": ts}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def _discard_tenant_state(tenant_dir: str) -> None:
    """Delete a tombstoned tenant's checkpoint generations and WAL
    segments (its sink stays)."""
    ckpt_path = os.path.join(tenant_dir, "ckpt.pkl")
    for path in (ckpt_path, ckpt_path + ".prev"):
        if os.path.exists(path):
            os.remove(path)
    wal_dir = os.path.join(tenant_dir, "wal")
    for name in _walmod.list_segments(wal_dir):
        try:
            os.remove(os.path.join(wal_dir, name))
        except OSError:
            pass
