"""HTTP front door for the multi-tenant reconstruction service (mirrors
``traceweaver_tpu/serve/http.py``).

Stdlib only (``http.server.ThreadingHTTPServer``):
span ingestion is a Jaeger-JSON POST per tenant, queries are GETs over
the tenant's emitted-trace ring. One handler thread per connection; all
state mutation happens inside :class:`TenantService`'s lock.

Endpoints::

    POST /api/v1/tenants/<id>/spans                Jaeger-JSON {"data": [...]}
    POST /api/v1/tenants/<id>/capture              strace log text (?source=)
                                                   or {"sources": {name: text}}
    POST /api/v1/tenants/<id>/flush                seal+solve now (one tenant)
    POST /api/v1/tenants/<id>/migrate_out          live migration, source half:
                                                   checkpoint + sink bytes out,
                                                   the tenant tombstoned here
    POST /api/v1/tenants/<id>/migrate_in           live migration, destination
                                                   half: install and resume
    POST /api/v1/tenants/<id>/migrate_commit       settle it at the source: the
                                                   state kept there is deleted
    POST /api/v1/tenants/<id>/migrate_abort        undo it at the source: the
                                                   tenant resumes from that state
    POST /api/v1/flush                             seal+solve now (all)
    POST /api/v1/reset_latency_window              fresh seal→emit p99 window
    GET  /api/v1/tenants                           tenant list
    GET  /api/v1/tenants/<id>/traces               recent trace ids (ring)
    GET  /api/v1/tenants/<id>/traces/<trace_id>    one reconstructed trace
    GET  /api/v1/tenants/<id>/query/delay_culprit  ?percentile=&after_us=&min_conf=
    GET  /api/v1/tenants/<id>/query/low_confidence ?limit=&max_conf=
    GET  /api/v1/tenants/<id>/stats                per-tenant ledger
    GET  /api/v1/stats                             service-wide ledger
    GET  /metrics                                  Prometheus exposition
    GET  /healthz                                  liveness
    GET  /readyz                                   readiness (rolling restarts):
                                                   200, 503 once a drain began

``/readyz`` keeps the JAX package's ``TW_AOT=off`` answer
(``runtime/aot.py readiness``): 200 with ``{"aot": "off", "phase": "off",
"ready": true, ...}``, and 503 once a drain has begun. The port compiles
no programs at run time (its kernels are built by ``nvcc`` at first use),
so the JAX package's ahead-of-time shape lattice, which ``/readyz`` gates
on there, has no counterpart.

Error mapping: bad JSON / malformed payloads (strict mode) -> 400,
unknown tenant or trace -> 404, a migrated-out tenant -> 410 (the fleet
router re-resolves its pin), tenant cap / invalid tenant id or transfer
-> 429 / 400 (:class:`TenancyError`), saturated per-tenant queues ->
429 with a ``Retry-After`` header derived from the backlog and drain
pace, everything else -> 500 with the exception name (never a silent
hang).
"""

from __future__ import annotations

import json
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from traceweaver_tpu_torch.ingest.jaeger import MalformedSpan
from traceweaver_tpu_torch.obs.registry import serve_families
from traceweaver_tpu_torch.serve.tenancy import TenancyError, TenantService

_TENANT_PATH = re.compile(r"^/api/v1/tenants/([^/]+)(/.*)?$")

#: request body cap (64 MB): a runaway POST must not OOM the service
MAX_BODY_BYTES = 64 << 20

# rendered error-body cache: under load-campaign backpressure the same
# 429 body is serialized thousands of times per second on request
# threads — rendered bytes are reused by exact message. Bounded
# (clear-on-cap beats LRU bookkeeping at this size); the hit/render
# ledger on /metrics measures what the cache actually saves.
_OBS_ERROR_BODY = serve_families()["error_body"]

# the JAX package's /readyz answer with TW_AOT=off (runtime/aot.py
# readiness): the port has no ahead-of-time lattice to gate on
_READY = {"aot": "off", "phase": "off", "planned": 0, "compiled": 0, "ready": True}
_ERROR_BODY_LOCK = threading.Lock()
_ERROR_BODY_CACHE: dict = {}
_ERROR_BODY_CAP = 256


def _error_body(message: str) -> bytes:
    with _ERROR_BODY_LOCK:
        body = _ERROR_BODY_CACHE.get(message)
    if body is None:
        body = json.dumps({"error": message},
                          sort_keys=True).encode("utf-8")
        _OBS_ERROR_BODY.inc(1.0, event="render")
        with _ERROR_BODY_LOCK:
            if len(_ERROR_BODY_CACHE) >= _ERROR_BODY_CAP:
                _ERROR_BODY_CACHE.clear()
            _ERROR_BODY_CACHE[message] = body
    else:
        _OBS_ERROR_BODY.inc(1.0, event="hit")
    return body


class ServeHandler(BaseHTTPRequestHandler):
    """Routes requests onto the owning :class:`TenantService`."""

    server_version = "traceweaver-serve/1.0"
    protocol_version = "HTTP/1.1"

    # -- plumbing ---------------------------------------------------------
    @property
    def service(self) -> TenantService:
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # noqa: D102 — quiet by default
        if self.service.cfg.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self._send(code, body, headers)

    def _send(self, code: int, body: bytes,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str,
               headers: Optional[dict] = None) -> None:
        self._send(code, _error_body(message), headers=headers)

    def _tenancy_error(self, e: TenancyError) -> None:
        """TenancyError -> status: a migrated-out tenant is 410 Gone (the
        fleet router re-resolves the tenant's pin), the tenant cap is 429,
        everything else (a bad id, a bad header, a bad transfer) is 400."""
        msg = str(e)
        if "migrated out" in msg:
            self._error(410, msg)
        else:
            self._error(429 if "cap" in msg else 400, msg)

    def _read_body(self, expected: str) -> Optional[bytes]:
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._error(400, "bad Content-Length")
            return None
        if length > MAX_BODY_BYTES:
            self._error(413, f"body exceeds {MAX_BODY_BYTES} bytes")
            return None
        raw = self.rfile.read(length) if length else b""
        if not raw:
            self._error(400, f"empty body (expected {expected})")
            return None
        return raw

    def _read_json(self) -> Optional[dict]:
        raw = self._read_body("Jaeger JSON")
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return None

    def _client_seq(self) -> Optional[int]:
        """Optional ``X-TW-Seq`` idempotency header: the client's
        per-tenant retry cursor, echoed on ledgered ingest responses
        and deduplicated when a retry re-sends a seq whose ack was lost."""
        hdr = self.headers.get("X-TW-Seq")
        if hdr is None:
            return None
        try:
            return int(hdr)
        except ValueError:
            raise TenancyError(
                f"bad X-TW-Seq header: {hdr!r} (expected an integer)"
            ) from None

    def _tenant_route(self) -> Tuple[Optional[str], str, dict]:
        """(tenant_id | None, subpath, query) of the request path."""
        parsed = urlparse(self.path)
        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        m = _TENANT_PATH.match(parsed.path)
        if m:
            return m.group(1), (m.group(2) or ""), query
        return None, parsed.path, query

    def _drain_body(self) -> None:
        """Read a request body no route read: closing a connection over
        unread bytes resets it, which can destroy the reply before the
        client reads it (a large ``migrate_out`` transfer, a 429)."""
        if self._body_read:
            return
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return
        if 0 < length <= MAX_BODY_BYTES:
            self.rfile.read(length)

    # -- verbs ------------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        self._body_read = False
        try:
            self._post()
        finally:
            self._drain_body()

    def _post(self) -> None:
        tenant_id, sub, query = self._tenant_route()
        try:
            if tenant_id is not None and sub == "/spans":
                # explicit backpressure: a tenant whose pending+spill
                # queues are saturated would drop the next sealed window;
                # the POST is refused instead, with a Retry-After from the
                # backlog and the observed drain pace
                wait_s = self.service.retry_after(tenant_id)
                if wait_s is not None:
                    # fractional seconds: rounding sub-second waits up to
                    # 1 s would put closed-loop clients in lockstep
                    self._error(
                        429,
                        f"tenant {tenant_id!r} backpressured: sealed-"
                        "window queues full; retry after "
                        f"{wait_s:.2f}s",
                        headers={"Retry-After": f"{max(0.05, wait_s):.2f}"})
                    return
                # the raw body goes straight to the columnar wire parse;
                # columnar=False keeps the decoded-dict flow
                raw = self._read_body("Jaeger JSON")
                if raw is None:
                    return
                if self.service.cfg.columnar:
                    payload = raw
                else:
                    try:
                        payload = json.loads(raw)
                    except json.JSONDecodeError as e:
                        self._error(400, f"invalid JSON: {e}")
                        return
                # ack discipline: the 200 is written only after
                # wal_ingest appended the raw bytes (with wal=False it
                # appends nothing and is the plain ingest)
                self._reply(200, self.service.wal_ingest(
                    tenant_id, payload, raw=raw, client_seq=self._client_seq()))
            elif tenant_id is not None and sub == "/capture":
                # the capture ingress: raw strace -f [-ttt] log text
                # (?source= names the capture host; callees it did not
                # capture become stubs), or a JSON {"sources": {name:
                # text}} bundle of every host's capture of the window, so
                # cross-source exchanges join and the skew fit sees pairs
                raw = self._read_body('an strace log or {"sources": {...}}')
                if raw is None:
                    return
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                if ctype == "application/json":
                    try:
                        bundle = json.loads(raw)
                    except json.JSONDecodeError as e:
                        self._error(400, f"invalid JSON: {e}")
                        return
                    captures = (bundle or {}).get("sources") if isinstance(bundle, dict) else None
                    if not isinstance(captures, dict) or not captures:
                        self._error(400, 'expected {"sources": {name: strace log text}}')
                        return
                else:
                    captures = raw.decode("utf-8", "replace")
                # the /spans ack discipline: the raw body is WAL-appended
                # before the 200
                self._reply(200, self.service.wal_ingest_capture(
                    tenant_id, captures, raw=raw,
                    ctype="json" if ctype == "application/json" else "text",
                    source=query.get("source"), client_seq=self._client_seq()))
            elif tenant_id is not None and sub == "/flush":
                self.service.tenant(tenant_id, create=False)
                self._reply(200, self.service.flush(tenant_id))
            elif tenant_id is not None and sub == "/migrate_out":
                # live migration, source half: checkpoint and sink bytes
                # out, the tenant tombstoned here
                self._reply(200, self.service.migrate_out(tenant_id))
            elif tenant_id is not None and sub == "/migrate_in":
                transfer = self._read_json()
                if transfer is None:
                    return
                if not isinstance(transfer, dict):
                    self._error(400, "expected a migration transfer object")
                    return
                self._reply(200, self.service.migrate_in(tenant_id, transfer))
            elif tenant_id is not None and sub == "/migrate_commit":
                self._reply(200, self.service.migrate_commit(tenant_id))
            elif tenant_id is not None and sub == "/migrate_abort":
                self._reply(200, self.service.migrate_abort(tenant_id))
            elif tenant_id is None and sub == "/api/v1/flush":
                self._reply(200, self.service.flush())
            elif tenant_id is None and sub == "/api/v1/reset_latency_window":
                # a warmup boundary: the measured phase reports its own
                # seal->emit p99
                self.service.reset_latency_window()
                self._reply(200, {"ok": True})
            else:
                self._error(404, f"no such endpoint: POST {sub or self.path}")
        except TenancyError as e:
            self._tenancy_error(e)
        except MalformedSpan as e:
            self._error(400, f"malformed payload: {e}")
        except KeyError:
            self._error(404, f"unknown tenant {tenant_id!r}")
        except Exception as e:  # noqa: BLE001 — the 500 surface
            self._error(500, f"{type(e).__name__}: {e}")

    def do_GET(self) -> None:  # noqa: N802
        tenant_id, sub, query = self._tenant_route()
        try:
            if tenant_id is None:
                if sub == "/healthz":
                    self._reply(200, {"ok": True,
                                      "tenants": len(self.service.tenants)})
                elif sub == "/readyz":
                    # a draining server is never ready: the SIGTERM
                    # handler flips service.draining before the listener
                    # closes, so routers stop sending to a dying replica
                    if self.service.draining:
                        self._reply(503, {"ready": False, "draining": True,
                                          "reason": "drain in progress"})
                        return
                    self._reply(200, dict(_READY))
                elif sub == "/metrics":
                    # the process registry (fleet, stream, serve, WAL,
                    # wire and devcols families) plus the tenancy
                    # collector, derived from the same stats() dict
                    # /api/v1/stats serves, plus the device-memory gauges
                    # when profiling is on
                    from traceweaver_tpu_torch.obs import profile as _obs_profile
                    from traceweaver_tpu_torch.obs.exposition import (
                        CONTENT_TYPE,
                        render_metrics,
                    )

                    extra = (self.service.metrics_families()
                             + _obs_profile.device_memory_families())
                    self._reply_text(200, render_metrics(extra=extra),
                                     CONTENT_TYPE)
                elif sub == "/api/v1/stats":
                    self._reply(200, self.service.stats())
                elif sub == "/api/v1/tenants":
                    self._reply(200, {
                        "tenants": sorted(self.service.tenants)})
                else:
                    self._error(404, f"no such endpoint: GET {self.path}")
                return
            if sub == "/stats":
                self._reply(200, self.service.stats(tenant_id))
            elif sub == "/traces":
                ids = self.service.trace_ids(tenant_id)
                limit = int(query.get("limit", "100"))
                self._reply(200, {"n_traces": len(ids),
                                  "trace_ids": ids[-limit:]})
            elif sub.startswith("/traces/"):
                trace_id = sub[len("/traces/"):]
                rec = self.service.trace(tenant_id, trace_id)
                if rec is None:
                    self._error(404, f"trace {trace_id!r} not in the ring")
                else:
                    self._reply(200, rec)
            elif sub == "/query/delay_culprit":
                percentile = float(query.get("percentile", "0.95"))
                after = query.get("after_us")
                min_conf = query.get("min_conf")
                self._reply(200, self.service.query_delay_culprit(
                    tenant_id, percentile,
                    float(after) if after is not None else None,
                    min_confidence=(float(min_conf)
                                    if min_conf is not None else None)))
            elif sub == "/query/low_confidence":
                self._reply(200, self.service.query_low_confidence(
                    tenant_id,
                    limit=int(query.get("limit", "20")),
                    max_conf=(float(query["max_conf"])
                              if "max_conf" in query else None)))
            else:
                self._error(404, f"no such endpoint: GET {sub}")
        except KeyError:
            self._error(404, f"unknown tenant {tenant_id!r}")
        except TenancyError as e:
            self._tenancy_error(e)
        except ValueError as e:
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")


class ReconstructionServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one :class:`TenantService`."""

    daemon_threads = True

    def __init__(self, service: TenantService, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.service = service
        super().__init__((host, port), ServeHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def make_server(service: TenantService, host: str = "127.0.0.1",
                port: int = 0) -> ReconstructionServer:
    """Bind (port 0 = ephemeral, the test mode). Call ``serve_forever``
    on a thread; the tier-1 smoke does exactly that."""
    return ReconstructionServer(service, host, port)


def run_server(service: TenantService, host: str, port: int,
               verbose: bool = True) -> dict:
    """The CLI's blocking entry: serve until SIGTERM/SIGINT, then
    gracefully drain — stop accepting, checkpoint every tenant within
    the drain budget (``ServeConfig.drain_timeout_s``), close sinks.
    Returns the drain summary. The signal handlers need the main
    thread; :func:`make_server` on a thread of its own is the embedded
    form."""
    server = make_server(service, host, port)
    stop = threading.Event()

    def _signal(signum, _frame):
        if verbose:
            print(f"[serve] signal {signum}: draining "
                  f"({service.cfg.drain_timeout_s:.0f}s budget)")
        # readiness flips FIRST: /readyz answers 503 for every request
        # that still lands while the listener winds down, so a router's
        # health probe (or a rolling-restart gate) stops routing here
        # before the socket disappears
        service.begin_drain()
        stop.set()
        # shutdown() must run off the serve_forever thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev = {s: signal.signal(s, _signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        if verbose:
            print(f"[serve] listening on http://{host}:{server.port} "
                  f"(max {service.cfg.max_tenants} tenants, "
                  f"prec={service.precision}, device={service.device}) — "
                  "POST /api/v1/tenants/<id>/spans", flush=True)
        server.serve_forever(poll_interval=0.2)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        server.server_close()
    summary = service.drain()
    if verbose:
        st = service.stats()
        print("[serve] drained: %d tenants checkpointed, %d skipped, "
              "%d past the drain budget; %d windows solved in %d shared "
              "+ %d isolated fleet calls"
              % (summary["checkpointed"], summary["skipped"],
                 summary["timed_out"],
                 st["dispatch"]["pumped_windows"],
                 st["dispatch"]["shared_solves"],
                 st["dispatch"]["isolated_solves"]))
    return summary
