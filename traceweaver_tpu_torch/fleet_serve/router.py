"""Tenant-sharded HTTP router: the fleet tier's front door (mirrors
``traceweaver_tpu/fleet_serve/router.py``).

Standard library only, and torch-free: the router is a host process that
imports no CUDA; the card belongs to the replicas it fronts. One router
consistent-hashes tenant ids onto N replica serve processes (each a full
:mod:`traceweaver_tpu_torch.serve` server with its own state dir) and
owns the fleet's availability:

- **consistent hashing** (:class:`HashRing`): tenant -> replica by SHA-1
  points, ``vnodes`` virtual nodes a replica, so adding or removing a
  replica remaps about 1/N of the tenants. The ring also gives each
  tenant's preference order, the retry-on-next-replica sequence. It
  places tenants exactly as the JAX package's ring does.
- **health-checked routing**: a loop probes each replica's ``/readyz``
  every ``health_s``; a draining or cold replica (503) leaves routing
  before its socket closes, and so does one that refuses the probe. A
  probe that times out counts as a miss, and only ``breaker_fails``
  misses in a row take the replica out: a replica busy on the card or
  the host answers late, and routing around it would fork the stream of
  every tenant it holds onto another replica. (The JAX package takes a
  replica out at its first missed probe.)
- **circuit breaking** (:class:`CircuitBreaker`): ``breaker_fails``
  consecutive proxy failures open a replica's circuit for
  ``breaker_cooldown_s``; an open circuit is skipped like a failed probe.
- **counted retries**: a failed POST moves to the next replica in ring
  order, at most ``retry_max`` extra attempts, every hop counted
  (``tw_fleet_router_total{outcome=...}``), and a tenant POST that lands
  on a fallback replica pins the tenant there. The candidates are
  re-resolved before every attempt, so a failover or respawn landing
  mid-retry re-routes the next hop. A connection reset after the request
  was accepted (a replica killed mid-body) is counted apart
  (``reset_midbody``): that request may be half-applied, and the
  forwarded ``X-TW-Seq`` lets the replica's WAL dedup the retry.
- **migration pins**: :meth:`FleetRouter.migrate` holds the tenant's
  requests, runs the replicas' ``migrate_out`` / ``migrate_in`` pair,
  pins the tenant to its new home and then has the source delete the
  state it kept (``migrate_commit``); a destination that refuses the
  tenant has the source resume it (``migrate_abort``). (The JAX package's
  source deletes its state at ``migrate_out``, so a refused
  ``migrate_in`` loses the tenant.) A 410 from a replica ("migrated out")
  re-resolves the pin instead of failing the client, after waiting out the
  migration's hold (the JAX package re-resolves at once, and a request
  that passed the hold before it began then reaches a replica the tenant
  has not reached yet).
- **holds end in 503, never in a reroute**: a request held by a migration
  or a crash recovery waits up to ``migrate_timeout_s``; if the hold
  outlasts that (a respawn paying a cold start), the request is answered
  503 with ``Retry-After`` rather than routed while the tenant's state is
  in flight (the JAX package routes it then, and a survivor mints a twin
  of the tenant).

The JAX package's ``TW_FLEET_*`` knobs are constructor arguments with the
knobs' defaults and ranges (a value out of range raises ``ValueError``).

Router endpoints (everything else proxies to the owning replica)::

    GET  /healthz               router liveness + replica table
    GET  /readyz                200 while >= 1 replica is routable
    GET  /metrics               router-process Prometheus exposition
    GET  /api/v1/stats          per-replica /api/v1/stats + router view
    GET  /api/v1/tenants        union of replica tenant lists
    POST /api/v1/flush          fan-out seal+solve on every replica
    GET  /api/v1/fleet/stats    ring, pins, breaker and health states
    POST /api/v1/fleet/migrate  {"tenant": ..., "to": "<replica>"}
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import http.client
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib import error as urlerror
from urllib import request as urlrequest
from urllib.parse import urlparse

from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry

_TENANT_PATH = re.compile(r"^/api/v1/tenants/([^/]+)(/.*)?$")

#: the replica front door's runaway-POST cap
MAX_BODY_BYTES = 64 << 20

# the TW_FLEET_* knobs' defaults (traceweaver_tpu/runtime/knobs.py)
ROUTER_PORT = 8320
MIGRATE_TIMEOUT_S = 60.0
RETRY_MAX = 2
VNODES = 64
BREAKER_FAILS = 3
BREAKER_COOLDOWN_S = 5.0
HEALTH_S = 1.0
PROXY_TIMEOUT_S = 120.0

_OBS_ROUTER = _get_registry().counter(
    "tw_fleet_router_total",
    "router request outcomes (proxied/rerouted/retried/failed/held/"
    "hold_expired/rejected) and fleet operations (migrations and their "
    "aborts/restarts)",
    labels=("outcome",))
_OBS_READY = _get_registry().gauge(
    "tw_fleet_replicas_ready",
    "replicas currently routable (ready, not draining, breaker closed)")


def check_range(name: str, value, lo, hi=None):
    """A knob's range check: ``value`` in ``[lo, hi]`` (``hi`` None: no
    upper bound), else ``ValueError``."""
    if not (value >= lo and (hi is None or value <= hi)):
        raise ValueError(f"{name} {value!r} not in [{lo}, {'inf' if hi is None else hi}]")
    return value


def _stable_hash(key: str) -> int:
    """Process-stable 64-bit hash (Python's ``hash()`` is salted per
    process: useless for a ring two processes must agree on)."""
    return int.from_bytes(hashlib.sha1(key.encode("utf-8")).digest()[:8], "big")


def http_json(method: str, url: str, payload: Optional[dict] = None,
              timeout: float = 30.0) -> Tuple[int, dict]:
    """One JSON round trip: 4xx and 5xx return; connection-level failures
    raise ``URLError`` or ``OSError``, the retry and breaker signal."""
    data = json.dumps(payload).encode("utf-8") if payload is not None else None
    headers = {"Content-Type": "application/json"} if data else {}
    req = urlrequest.Request(url, data=data, method=method, headers=headers)
    try:
        with _peer_death_as_reset():
            with urlrequest.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
    except urlerror.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except (ValueError, OSError, http.client.HTTPException):
            body = {}
        return e.code, body


@contextlib.contextmanager
def _peer_death_as_reset():
    """A peer that dies between its status line and the end of its body
    (a replica SIGKILLed mid-reply) surfaces from ``http.client`` as an
    ``HTTPException`` such as ``IncompleteRead``, not an ``OSError``: raise
    it as the connection reset it is, so callers retry and count it. (The
    JAX package's router lets it escape the handler, and the client's
    connection is dropped without an answer.)"""
    try:
        yield
    except http.client.HTTPException as e:
        raise ConnectionResetError(f"{type(e).__name__}: {e}") from e


def _http_raw(method: str, url: str, body: Optional[bytes],
              content_type: Optional[str], timeout: float,
              extra: Optional[Dict[str, str]] = None,
              ) -> Tuple[int, Dict[str, str], bytes]:
    """The proxy's round trip, keeping bytes and headers. HTTP errors are
    answers (forwarded as they are); only connection-level failures
    raise."""
    headers = dict(extra or {})
    if content_type:
        headers["Content-Type"] = content_type
    req = urlrequest.Request(url, data=body, method=method, headers=headers)
    with _peer_death_as_reset():
        try:
            with urlrequest.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urlerror.HTTPError as e:
            return e.code, dict(e.headers or {}), e.read()


class HashRing:
    """Consistent hash ring over replica names (SHA-1 points, ``vnodes``
    virtual nodes a replica). ``preference(key)`` walks the ring
    clockwise from the key's point and yields each replica once: element
    0 is the owner, the rest the failover order."""

    def __init__(self, names: List[str], vnodes: int = VNODES) -> None:
        self.vnodes = check_range("vnodes", int(vnodes), 1, 4096)
        self.names = sorted(set(names))
        self._points = sorted((_stable_hash(f"{name}#{v}"), name)
                              for name in self.names for v in range(self.vnodes))
        self._keys = [p[0] for p in self._points]

    def preference(self, key: str) -> List[str]:
        if not self._points:
            return []
        out: List[str] = []
        seen = set()
        start = bisect.bisect_right(self._keys, _stable_hash(key))
        for j in range(len(self._points)):
            name = self._points[(start + j) % len(self._points)][1]
            if name not in seen:
                seen.add(name)
                out.append(name)
                if len(out) == len(self.names):
                    break
        return out

    def lookup(self, key: str) -> str:
        return self.preference(key)[0]


class CircuitBreaker:
    """Consecutive-failure breaker: ``fail_max`` straight failures open
    the circuit for ``cooldown_s``; any success closes it."""

    def __init__(self, fail_max: int = BREAKER_FAILS,
                 cooldown_s: float = BREAKER_COOLDOWN_S) -> None:
        self.fail_max = check_range("breaker_fails", int(fail_max), 1, 100)
        self.cooldown_s = check_range("breaker_cooldown_s", float(cooldown_s), 0.1, 600.0)
        self.fails = 0
        self.opened = 0          # lifetime open transitions (stats)
        self._open_until = 0.0

    def record(self, ok: bool) -> None:
        if ok:
            self.fails = 0
            self._open_until = 0.0
            return
        self.fails += 1
        if self.fails >= self.fail_max:
            self._open_until = time.monotonic() + self.cooldown_s
            self.opened += 1

    @property
    def open(self) -> bool:
        return time.monotonic() < self._open_until


class ReplicaRef:
    """The router's view of one replica process."""

    def __init__(self, name: str, base_url: str, breaker_fails: int = BREAKER_FAILS,
                 breaker_cooldown_s: float = BREAKER_COOLDOWN_S) -> None:
        self.name = name
        self.base_url = base_url.rstrip("/")
        # optimistic until the first probe answers: a fleet boots
        # routable, and the probe loop corrects within one period
        self.ready = True
        self.draining = False     # set during rolling restarts
        self.breaker = CircuitBreaker(breaker_fails, breaker_cooldown_s)
        self.requests = 0
        self.failures = 0

    @property
    def routable(self) -> bool:
        return self.ready and not self.draining and not self.breaker.open

    def view(self) -> Dict[str, object]:
        return dict(name=self.name, base_url=self.base_url, ready=self.ready,
                    draining=self.draining, breaker_open=self.breaker.open,
                    breaker_opened=self.breaker.opened, requests=self.requests,
                    failures=self.failures)


class RouterHandler(BaseHTTPRequestHandler):
    """Routes requests onto the owning :class:`FleetRouter`."""

    server_version = "traceweaver-fleet-router/1.0"
    protocol_version = "HTTP/1.1"

    @property
    def router(self) -> "FleetRouter":
        return self.server  # type: ignore[return-value]

    def log_message(self, fmt, *args):  # noqa: D102 — quiet by default
        if self.router.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self._reply_bytes(code, body, "application/json", headers)

    def _reply_bytes(self, code: int, body: bytes, content_type: str,
                     headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, headers: Optional[dict] = None) -> None:
        self._reply(code, {"error": message}, headers)

    def _read_body(self) -> Optional[bytes]:
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._error(400, "bad Content-Length")
            return None
        if length > MAX_BODY_BYTES:
            self._error(413, f"body exceeds {MAX_BODY_BYTES} bytes")
            return None
        return self.rfile.read(length) if length else b""

    def _drain_body(self) -> None:
        """Read a request body no route read: closing a connection over
        unread bytes resets it, which can destroy the reply in flight."""
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
        r = self.router
        path = urlparse(self.path).path
        m = _TENANT_PATH.match(path)
        try:
            if m:
                body = self._read_body()
                if body is None:
                    return
                self._proxy_tenant("POST", m.group(1), body)
            elif path == "/api/v1/flush":
                self._reply(200, r.flush_all())
            elif path == "/api/v1/fleet/migrate":
                body = self._read_body()
                if body is None:
                    return
                try:
                    req = json.loads(body or b"{}")
                except json.JSONDecodeError as e:
                    self._error(400, f"invalid JSON: {e}")
                    return
                tenant, dst = req.get("tenant"), req.get("to")
                if not tenant or not dst:
                    self._error(400, 'expected {"tenant": ..., "to": ...}')
                    return
                if dst not in r.replicas:
                    self._error(404, f"no such replica {dst!r}")
                    return
                self._reply(200, r.migrate(tenant, dst))
            else:
                self._error(404, f"no such endpoint: POST {path}")
        except (urlerror.URLError, OSError, RuntimeError) as e:
            self._error(502, f"{type(e).__name__}: {e}")

    def do_GET(self) -> None:  # noqa: N802
        r = self.router
        path = urlparse(self.path).path
        try:
            if path == "/healthz":
                self._reply(200, {"ok": True, "replicas": [ref.view() for ref in r.refs()]})
            elif path == "/readyz":
                n = sum(ref.routable for ref in r.refs())
                self._reply(200 if n else 503, {"ready": n > 0, "routable_replicas": n})
            elif path == "/metrics":
                from traceweaver_tpu_torch.obs.exposition import CONTENT_TYPE, render_metrics

                self._reply_bytes(200, render_metrics().encode("utf-8"), CONTENT_TYPE)
            elif path == "/api/v1/stats":
                self._reply(200, r.fleet_stats(include_replicas=True))
            elif path == "/api/v1/tenants":
                self._reply(200, {"tenants": r.tenant_union()})
            elif path == "/api/v1/fleet/stats":
                self._reply(200, r.fleet_stats())
            else:
                m = _TENANT_PATH.match(path)
                if m:
                    self._proxy_tenant("GET", m.group(1), None)
                else:
                    self._error(404, f"no such endpoint: GET {path}")
        except (urlerror.URLError, OSError, RuntimeError) as e:
            self._error(502, f"{type(e).__name__}: {e}")

    # -- the proxy path ---------------------------------------------------
    def _held_too_long(self, tenant: str) -> None:
        """The tenant's hold outlasted ``migrate_timeout_s``: its state is
        still in flight, so the client comes back later."""
        self.router.bump("hold_expired")
        self._error(503, f"tenant {tenant!r} is being moved or recovered",
                    {"Retry-After": "1"})

    def _proxy_tenant(self, method: str, tenant: str, body: Optional[bytes]) -> None:
        """Forward one tenant request to its replica, walking the ring's
        preference order on connection failure (a POST pins the tenant to
        the fallback replica it lands on) and re-resolving the pin once on
        a 410 (a migration landed between routing and dispatch)."""
        r = self.router
        target = self.path  # the full path with its query, verbatim
        content_type = self.headers.get("Content-Type")
        client_seq = self.headers.get("X-TW-Seq")
        extra = {"X-TW-Seq": client_seq} if client_seq else None
        if not r.wait_routable(tenant):
            self._held_too_long(tenant)
            return
        budget = 1 + (r.retry_max if method == "POST" else 1)
        attempts_left = budget
        tried: set = set()
        saw_410 = saw_candidates = False
        last_err: Optional[Exception] = None
        while attempts_left > 0:
            # re-resolved every attempt: a crash failover or respawn
            # landing mid-retry changes the routable set and the pins
            cands = r.candidates(tenant)
            ref = next((c for c in cands if c.name not in tried), None)
            if ref is None:
                break
            saw_candidates = True
            attempts_left -= 1
            # the attempt's process: a failure against a replica replaced
            # meanwhile (a respawn) counts against the old process's breaker
            with r._lock:
                base_url, breaker = ref.base_url, ref.breaker
            try:
                status, headers, payload = _http_raw(
                    method, base_url + target, body, content_type,
                    timeout=r.proxy_timeout_s, extra=extra)
            except (urlerror.URLError, OSError) as e:
                reason = getattr(e, "reason", e)
                if isinstance(reason, (ConnectionResetError, BrokenPipeError)):
                    # the replica died after accepting the connection: the
                    # request may be half-applied, and the WAL's client-seq
                    # dedup is what makes the retry safe
                    r.bump("reset_midbody")
                breaker.record(False)
                ref.failures += 1
                last_err = e
                tried.add(ref.name)
                r.bump("retried")
                if r.crash_grace_s > 0:
                    # a crash supervisor is attached: give it one detection
                    # period to strike the corpse from routing and hold its
                    # tenants, then resolve afresh (the next ring candidate
                    # would mint an empty twin of a tenant whose state sits
                    # on the crashed disk)
                    time.sleep(r.crash_grace_s)
                    if not r.wait_routable(tenant):
                        self._held_too_long(tenant)
                        return
                    tried.clear()
                continue
            breaker.record(True)
            ref.requests += 1
            if status == 410 and not saw_410:
                # migrated off this replica mid-flight: once the migration
                # releases its hold the pin table knows the new home;
                # re-resolve then, with a fresh budget (a second 410 goes to
                # the client). Resolving before the release would send the
                # request to a replica the tenant has not reached yet.
                if not r.wait_routable(tenant):
                    self._held_too_long(tenant)
                    return
                saw_410 = True
                tried.clear()
                tried.add(ref.name)
                attempts_left = budget
                r.bump("rerouted")
                r.bump("gone_410")
                continue
            if tried and method == "POST":
                # landed on a fallback replica: pin the tenant there so its
                # stream stays on one replica
                r.pin(tenant, ref.name)
                r.bump("rerouted")
            r.bump("proxied")
            fwd = {}
            if "Retry-After" in headers:
                fwd["Retry-After"] = headers["Retry-After"]
            self._reply_bytes(status, payload,
                              headers.get("Content-Type", "application/json"), fwd)
            return
        if not saw_candidates:
            # nothing routable (a replica down, the supervisor recovering
            # it): tell the client when to come back
            r.bump("rejected")
            self._error(503, "no routable replicas", {"Retry-After": "1"})
            return
        r.bump("failed")
        if last_err is not None:
            self._error(503, f"all replicas failed for tenant {tenant!r}: "
                             f"{type(last_err).__name__}: {last_err}",
                        {"Retry-After": "1"})
            return
        self._error(502, f"all replicas failed for tenant {tenant!r} (migration loop)")


class FleetRouter(ThreadingHTTPServer):
    """The fleet front door: hash ring, pins, health loop and breakers,
    bound to a :class:`RouterHandler` pool. ``start()`` runs the serve and
    health threads and returns self; ``stop()`` ends both."""

    daemon_threads = True

    def __init__(self, replicas: Dict[str, str], host: str = "127.0.0.1",
                 port: int = ROUTER_PORT, verbose: bool = False,
                 retry_max: int = RETRY_MAX, proxy_timeout_s: float = PROXY_TIMEOUT_S,
                 health_s: float = HEALTH_S, migrate_timeout_s: float = MIGRATE_TIMEOUT_S,
                 vnodes: int = VNODES, breaker_fails: int = BREAKER_FAILS,
                 breaker_cooldown_s: float = BREAKER_COOLDOWN_S) -> None:
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        check_range("port", int(port), 0, 65535)
        self.retry_max = check_range("retry_max", int(retry_max), 0, 16)
        self.proxy_timeout_s = check_range("proxy_timeout_s", float(proxy_timeout_s),
                                           0.1, 3600.0)
        self.health_period_s = check_range("health_s", float(health_s), 0.05, 60.0)
        self.migrate_timeout_s = check_range("migrate_timeout_s", float(migrate_timeout_s),
                                             0.1, 3600.0)
        self.breaker_fails = breaker_fails
        self.breaker_cooldown_s = breaker_cooldown_s
        self.replicas: Dict[str, ReplicaRef] = {
            name: ReplicaRef(name, url, breaker_fails, breaker_cooldown_s)
            for name, url in sorted(replicas.items())}
        self.ring = HashRing(list(self.replicas), vnodes=vnodes)
        self.pins: Dict[str, str] = {}
        self.verbose = verbose
        self.counters: Dict[str, int] = dict(
            proxied=0, rerouted=0, retried=0, failed=0, rejected=0, held=0,
            migrations=0, restarts=0, reset_midbody=0, gone_410=0, failovers=0,
            respawns=0, hold_expired=0, migrations_aborted=0)
        # > 0 only with a crash supervisor attached (FleetManager
        # supervise=True): how long a failed proxy attempt yields before
        # re-resolving, so crash detection and tenant holds win the race
        self.crash_grace_s = 0.0
        self._lock = threading.RLock()
        self._migrating: Dict[str, threading.Event] = {}
        self._stop = threading.Event()
        self._own_threads: List[threading.Thread] = []
        super().__init__((host, int(port)), RouterHandler)

    # -- lifecycle --------------------------------------------------------
    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def base_url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def start(self) -> "FleetRouter":
        for name, fn in (("tw-fleet-router", self.serve_forever),
                         ("tw-fleet-health", self._health_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._own_threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.shutdown()
        self.server_close()

    # -- routing state ----------------------------------------------------
    def refs(self) -> List[ReplicaRef]:
        with self._lock:
            return list(self.replicas.values())

    def bump(self, outcome: str, n: int = 1) -> None:
        with self._lock:
            self.counters[outcome] = self.counters.get(outcome, 0) + n
        _OBS_ROUTER.inc(n, outcome=outcome)

    def candidates(self, tenant: str) -> List[ReplicaRef]:
        """Routable replicas for a tenant in preference order: its pin
        first, then the ring's walk."""
        with self._lock:
            order = self.ring.preference(tenant)
            pin = self.pins.get(tenant)
            if pin and pin in self.replicas:
                order = [pin] + [n for n in order if n != pin]
            return [self.replicas[n] for n in order if self.replicas[n].routable]

    def pin(self, tenant: str, replica: str) -> None:
        with self._lock:
            self.pins[tenant] = replica

    def owner(self, tenant: str) -> str:
        """The replica responsible for a tenant (its pin, else the ring)."""
        with self._lock:
            return self.pins.get(tenant) or self.ring.lookup(tenant)

    def set_draining(self, name: str, flag: bool) -> None:
        with self._lock:
            self.replicas[name].draining = flag

    def update_replica(self, name: str, base_url: str) -> None:
        """Point a replica slot at a restarted process (a new port) with a
        fresh breaker: the new process owes no failures."""
        with self._lock:
            ref = self.replicas[name]
            ref.base_url = base_url.rstrip("/")
            ref.breaker = CircuitBreaker(self.breaker_fails, self.breaker_cooldown_s)
            ref.ready = True

    # -- migration --------------------------------------------------------
    @contextlib.contextmanager
    def hold_tenant(self, tenant: str):
        """Hold (not fail) the tenant's requests while its state is in
        flight between replicas; released on exit."""
        ev = threading.Event()
        with self._lock:
            self._migrating[tenant] = ev
        try:
            yield
        finally:
            with self._lock:
                self._migrating.pop(tenant, None)
            ev.set()

    def wait_routable(self, tenant: str) -> bool:
        """Block while the tenant's state is in flight between replicas
        (a migration or a crash recovery), at most ``migrate_timeout_s``.
        True when the tenant may be routed now; False when its hold is
        still on, and routing it would fork its stream."""
        with self._lock:
            ev = self._migrating.get(tenant)
        if ev is None:
            return True
        self.bump("held")
        return ev.wait(timeout=self.migrate_timeout_s)

    def migrate(self, tenant: str, dst: str) -> Dict[str, object]:
        """Live tenant migration: hold the tenant's requests,
        ``migrate_out`` on its replica, ``migrate_in`` on ``dst``
        (checkpoint and sink bytes, CRC-verified at both ends), pin the
        tenant to its new home, ``migrate_commit`` on the source, release.
        Open windows ride the checkpoint; requests held meanwhile go to the
        new home. A destination that refuses the tenant, or neither answers
        nor lists it afterwards, leaves it on the source: ``migrate_abort``
        resumes it there from the state the source kept, and this raises.
        (A destination that installed the tenant but answered neither call
        within ``migrate_timeout_s`` each would then hold a twin.)"""
        src = self.owner(tenant)
        if src == dst:
            return dict(tenant=tenant, src=src, dst=dst, noop=True)
        with self._lock:
            src_url = self.replicas[src].base_url
            dst_url = self.replicas[dst].base_url
        src_t = f"{src_url}/api/v1/tenants/{tenant}"
        t0 = time.monotonic()
        with self.hold_tenant(tenant):
            status, out = http_json("POST", src_t + "/migrate_out", {},
                                    timeout=self.migrate_timeout_s)
            if status != 200:
                raise RuntimeError(f"migrate_out {tenant!r} on {src}: HTTP {status} "
                                   f"{out.get('error', '')}")
            try:
                status, res = http_json("POST", f"{dst_url}/api/v1/tenants/{tenant}/migrate_in",
                                        out, timeout=self.migrate_timeout_s)
            except OSError as e:
                # installed with its answer lost, or not installed
                status = 200 if self._lists(dst_url, tenant) else None
                res = dict(error=f"no answer: {type(e).__name__}: {e}")
            if status != 200:
                try:
                    code, ab = http_json("POST", src_t + "/migrate_abort", {},
                                         timeout=self.migrate_timeout_s)
                except OSError as e:
                    code, ab = None, dict(error=f"{type(e).__name__}: {e}")
                self.bump("migrations_aborted")
                raise RuntimeError(
                    f"migrate_in {tenant!r} on {dst}: HTTP {status} {res.get('error', '')}; "
                    + (f"the tenant resumed on {src}" if code == 200 else
                       f"its abort on {src} answered {code} {ab.get('error', '')}: the "
                       f"tenant stays tombstoned there with its state, and POST "
                       f"{src_t}/migrate_abort resumes it"))
            self.pin(tenant, dst)
            try:
                code, cm = http_json("POST", src_t + "/migrate_commit", {},
                                     timeout=self.migrate_timeout_s)
            except OSError as e:
                code, cm = None, dict(error=f"{type(e).__name__}: {e}")
            if code != 200:
                # harmless: the state stays under the source's tombstone,
                # and a later migrate_in there replaces it
                _events.emit("fleet", "migrate_commit_failed", tenant=tenant, src=src,
                             status=code, error=cm.get("error", ""))
        self.bump("migrations")
        wall_s = time.monotonic() - t0
        _events.emit("fleet", "migrate", tenant=tenant, src=src, dst=dst,
                     wall_s=round(wall_s, 3), backlog=res.get("backlog"))
        out = dict(res)
        out.update(tenant=tenant, src=src, dst=dst, wall_s=round(wall_s, 3))
        return out

    def _lists(self, base_url: str, tenant: str) -> bool:
        """Whether a replica answers and lists the tenant as live."""
        try:
            status, out = http_json("GET", base_url + "/api/v1/tenants",
                                    timeout=self.migrate_timeout_s)
        except OSError:
            return False
        return status == 200 and tenant in out.get("tenants", [])

    # -- aggregate views --------------------------------------------------
    def fleet_stats(self, include_replicas: bool = False) -> Dict:
        with self._lock:
            out: Dict[str, object] = dict(
                router=dict(counters=dict(self.counters), pins=dict(self.pins),
                            vnodes=self.ring.vnodes, retry_max=self.retry_max),
                replicas={name: ref.view() for name, ref in self.replicas.items()},
            )
            refs = list(self.replicas.items())
        if include_replicas:
            per_replica = {}
            for name, ref in refs:
                try:
                    status, st = http_json("GET", ref.base_url + "/api/v1/stats",
                                           timeout=self.proxy_timeout_s)
                    per_replica[name] = st if status == 200 else dict(error=f"HTTP {status}")
                except (urlerror.URLError, OSError) as e:
                    per_replica[name] = dict(error=str(e))
            out["replica_stats"] = per_replica
        return out

    def tenant_union(self) -> List[str]:
        tenants = set()
        for ref in self.refs():
            if not ref.routable:
                continue
            try:
                status, out = http_json("GET", ref.base_url + "/api/v1/tenants",
                                        timeout=self.proxy_timeout_s)
            except (urlerror.URLError, OSError):
                continue
            if status == 200:
                tenants.update(out.get("tenants", []))
        return sorted(tenants)

    def flush_all(self) -> Dict[str, object]:
        """Fan-out seal and solve: ``POST /api/v1/flush`` on every
        routable replica, summed."""
        sealed = solved = 0
        per = {}
        for ref in self.refs():
            if not ref.routable:
                continue
            try:
                status, out = http_json("POST", ref.base_url + "/api/v1/flush", None,
                                        timeout=self.proxy_timeout_s)
            except (urlerror.URLError, OSError) as e:
                per[ref.name] = dict(status=0, error=str(e))
                continue
            if status == 200:
                sealed += int(out.get("sealed_windows", 0))
                solved += int(out.get("solved_windows", 0))
            per[ref.name] = dict(status=status, **out)
        return dict(sealed_windows=sealed, solved_windows=solved, replicas=per)

    # -- health loop ------------------------------------------------------
    def _health_loop(self) -> None:
        misses: Dict[str, int] = {}
        while not self._stop.wait(self.health_period_s):
            for ref in self.refs():
                url = ref.base_url
                try:
                    status, _ = http_json("GET", url + "/readyz",
                                          timeout=max(0.5, self.health_period_s))
                    now_ready = status == 200
                    misses[ref.name] = 0
                except (urlerror.URLError, OSError) as e:
                    now_ready = False
                    if isinstance(getattr(e, "reason", e), TimeoutError):
                        # a late answer: out only after breaker_fails in a row
                        misses[ref.name] = misses.get(ref.name, 0) + 1
                        now_ready = ref.ready and misses[ref.name] < self.breaker_fails
                if ref.base_url != url:
                    continue  # the slot took a new process meanwhile: not its answer
                if now_ready != ref.ready:
                    _events.emit("fleet", "replica_health", replica=ref.name,
                                 ready=now_ready)
                ref.ready = now_ready
            _OBS_READY.set(float(sum(r.routable for r in self.refs())))
