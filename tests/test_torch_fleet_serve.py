"""The port's replica fleet tier against the JAX package's
(``traceweaver_tpu_torch/fleet_serve``, ``campaign/ledger.py`` and
``campaign/compare.py``, the serve tier's live migration and crash
transfer, the ``fleet`` subcommand).

On the CPU (``device="cpu"``, replicas with ``--device cpu``), on the
JAX package's hotel fixture (``tests/test_serve.py``, copied into
``tests/test_torch_serve.py``):

- the hash ring places 1000 tenant ids as the JAX ring does at 2-5
  replicas, and a replica added remaps a bounded share, onto itself; the
  circuit breaker walks the JAX breaker's transitions;
- the router retries a dead replica and pins the fallback, counts a
  reset mid-body, and forwards ``X-TW-Seq`` so a retry dedups;
- a tenant live-migrated mid-stream between in-process replicas emits
  the port's unmigrated bytes and the JAX fleet's migrated bytes, also
  with its windows riding two tickets in flight; the tombstone answers
  410 and survives a resume; torn checkpoint bytes are refused;
- a destination that refuses a migrated tenant (its cap) or does not
  answer leaves the tenant live on its source with nothing lost, and an
  unsettled migration stays tombstoned across a restart until it is
  aborted or committed; a router hold that outlasts its timeout answers
  503, never a reroute; ring tickets name their windows in the event sink;
- a crash failover from the dead disk (the ``.prev`` generation, a
  tenant known only from its WAL) is byte-identical;
- a migration out and back leaves no stale device-column ring;
- the in-process wire campaign writes an artifact both packages read,
  and both packages' compare flag the same regression classes;
- out-of-range knob arguments raise; ``fleet serve`` with no card and no
  ``--device`` exits 1;
- two ``cli serve --device cpu`` replica processes under the crash
  supervisor take a rolling restart and a SIGKILL respawn, losing
  nothing.

The JAX package is imported only inside the tests that compare with it,
so the ``gpu`` test runs where JAX is not installed.
"""

import copy
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

from test_torch_serve import _alone, cfg, hotel_payload, http, raw
from traceweaver_tpu_torch.campaign import compare as port_compare
from traceweaver_tpu_torch.campaign import ledger as port_ledger
from traceweaver_tpu_torch.fleet_serve import (
    CircuitBreaker,
    FleetManager,
    FleetRouter,
    HashRing,
    InProcReplica,
    ReplicaProcess,
)
from traceweaver_tpu_torch.ops import devcols
from traceweaver_tpu_torch.serve import TenancyError, TenantService, make_server
from traceweaver_tpu_torch.serve import tenancy as port_tenancy
from traceweaver_tpu_torch.stream import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _fresh_rings():
    devcols.get_store().clear()
    yield
    devcols.get_store().clear()


def _jax():
    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu import serve as jserve
    from traceweaver_tpu.fleet_serve import manager as jmanager
    from traceweaver_tpu.fleet_serve import router as jrouter

    return jserve, jmanager, jrouter


def _jcfg(jserve, **kw):
    base = dict(fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False,
                pump_windows=10**9)
    base.update(kw)
    return jserve.ServeConfig(**base)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _window_payloads(n=4, per=6):
    """``n`` payloads of ``per`` traces, each in an event-time window of
    its own (61 s apart)."""
    return [hotel_payload(n_traces=per, prefix=f"w{k}-", base_us=10e6 + k * 61e6)
            for k in range(n)]


# ---------------------------------------------------------------------------
# hash ring and breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_hash_ring_places_tenants_as_jax(n):
    _, _, jrouter = _jax()
    names = [f"r{i}" for i in range(n)]
    ring, jring = HashRing(names, vnodes=64), jrouter.HashRing(names, vnodes=64)
    keys = [f"tenant-{i}" for i in range(1000)]
    for k in keys:
        assert ring.preference(k) == jring.preference(k)
        assert sorted(ring.preference(k)) == names
    assert HashRing(list(reversed(names))).preference("x") == ring.preference("x")
    grown = HashRing(names + [f"r{n}"], vnodes=64)
    moved = [k for k in keys if grown.lookup(k) != ring.lookup(k)]
    assert 0 < len(moved) < len(keys) * 0.5
    assert all(grown.lookup(k) == f"r{n}" for k in moved)
    jgrown = jrouter.HashRing(names + [f"r{n}"], vnodes=64)
    assert moved == [k for k in keys if jgrown.lookup(k) != jring.lookup(k)]


def test_circuit_breaker_transitions_match_jax():
    _, _, jrouter = _jax()
    cb, jcb = CircuitBreaker(fail_max=3, cooldown_s=1.0), jrouter.CircuitBreaker(3, 1.0)
    seen = []
    for step in (False, False, False, "sleep", True, False, False, False, True):
        if step == "sleep":
            time.sleep(1.2)
        else:
            cb.record(step)
            jcb.record(step)
        seen.append((cb.open, cb.fails, cb.opened))
        assert (cb.open, cb.fails, cb.opened) == (jcb.open, jcb.fails, jcb.opened)
    assert seen[2] == (True, 3, 1) and seen[3][0] is False
    assert seen[7] == (True, 3, 2) and seen[8] == (False, 0, 2)


# ---------------------------------------------------------------------------
# the router's proxy path
# ---------------------------------------------------------------------------

def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def test_router_retries_dead_replica_and_pins_fallback(tmp_path):
    live = InProcReplica("live", cfg(state_dir=str(tmp_path / "live")), device="cpu")
    router = FleetRouter({"dead": _dead_url(), "live": live.base_url}, port=0).start()
    try:
        tenant = next(f"t{i}" for i in range(200)
                      if HashRing(["dead", "live"]).lookup(f"t{i}") == "dead")
        code, out, _ = http("POST", f"{router.base_url}/api/v1/tenants/{tenant}/spans",
                            hotel_payload(n_traces=6, prefix="rt"))
        assert code == 200 and out["ingested_traces"] == 6, out
        assert router.counters["retried"] >= 1 and router.counters["rerouted"] >= 1
        assert router.pins[tenant] == "live"
        assert router.replicas["dead"].breaker.fails >= 1
        code, out, _ = http("GET", router.base_url + "/readyz")
        assert code == 200 and out["ready"] is True
        code, out, _ = http("GET", router.base_url + "/healthz")
        assert {r["name"] for r in out["replicas"]} == {"dead", "live"}
        code, text, _ = http("GET", router.base_url + "/metrics")
        assert b'tw_fleet_router_total{outcome="retried"}' in text
    finally:
        router.stop()
        live.stop()


@pytest.mark.parametrize("death", ["rst", "mid_reply"])
def test_router_classifies_reset_midbody_and_reroutes(tmp_path, death):
    """A replica that dies mid-request (a reset) or mid-reply (its status
    line and headers sent, its body not: ``IncompleteRead``) counts as a
    reset mid-body, and the POST goes on to the next replica."""
    live = InProcReplica("live", cfg(state_dir=str(tmp_path / "live")), device="cpu")
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(5)

    def rst_loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if death == "rst":
                # SO_LINGER(1, 0): close() sends RST mid-request
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            try:
                conn.recv(64)
                if death == "mid_reply":
                    # the whole request read (a close over unread bytes
                    # resets), then FIN after the headers, as a SIGKILLed
                    # replica's kernel sends it
                    conn.settimeout(0.3)
                    try:
                        while conn.recv(1 << 16):
                            pass
                    except socket.timeout:
                        pass
                    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                                 b"Content-Length: 116\r\n\r\n")
            except OSError:
                pass
            conn.close()

    threading.Thread(target=rst_loop, daemon=True).start()
    router = FleetRouter({"rst": f"http://127.0.0.1:{srv.getsockname()[1]}",
                          "live": live.base_url}, port=0).start()
    try:
        tenant = next(f"t{i}" for i in range(200)
                      if HashRing(["rst", "live"]).lookup(f"t{i}") == "rst")
        code, out, _ = http("POST", f"{router.base_url}/api/v1/tenants/{tenant}/spans",
                            hotel_payload(n_traces=6, prefix="rm"))
        assert code == 200 and out["ingested_traces"] == 6, out
        assert router.counters["reset_midbody"] >= 1 and router.counters["retried"] >= 1
        assert router.pins[tenant] == "live"
    finally:
        router.stop()
        live.stop()
        srv.close()


def test_router_forwards_client_seq_and_retry_dedups(tmp_path):
    rep = InProcReplica("solo", cfg(state_dir=str(tmp_path / "solo")), device="cpu")
    router = FleetRouter({"solo": rep.base_url}, port=0).start()
    try:
        url = f"{router.base_url}/api/v1/tenants/rt/spans"
        pay = hotel_payload(n_traces=6, prefix="sq")
        code, out, _ = http("POST", url, pay, headers={"X-TW-Seq": "11"})
        assert code == 200 and out["seq"] == 11 and out["ingested_traces"] == 6
        code, out, _ = http("POST", url, pay, headers={"X-TW-Seq": "11"})
        assert code == 200 and out.get("deduped") is True and out["ingested_traces"] == 6
        t = rep.service.tenant("rt")
        assert t.wal.stats()["appended"] == 1 and t.counters["wal_deduped"] == 1
    finally:
        router.stop()
        rep.stop()


def test_410_reresolves_after_the_migration_hold(tmp_path):
    """A POST that passed the router's hold check just before a migration
    began reaches the old home and gets 410: the router waits out the
    migration's hold, then re-resolves to the new home, rather than trying
    a replica the tenant has not reached yet (here one that still holds an
    older tombstone of it, which would answer 410 to the client)."""
    reps = [InProcReplica(f"r{i}", cfg(state_dir=str(tmp_path / f"r{i}")), device="cpu")
            for i in range(2)]
    a, b = (r.service for r in reps)
    a.ingest("x", raw(hotel_payload(n_traces=4, prefix="x")))
    b.migrate_in("x", a.migrate_out("x"))
    transfer = b.migrate_out("x")             # both replicas hold a tombstone now
    router = FleetRouter({r.name: r.base_url for r in reps}, port=0).start()
    router.pin("x", "r0")
    real_wait, calls = router.wait_routable, []

    def passed_before_the_hold(tenant):
        calls.append(tenant)
        return True if len(calls) == 1 else real_wait(tenant)

    router.wait_routable = passed_before_the_hold
    out = []
    try:
        with router.hold_tenant("x"):
            th = threading.Thread(target=lambda: out.append(http(
                "POST", f"{router.base_url}/api/v1/tenants/x/spans",
                hotel_payload(n_traces=2, prefix="y", base_us=9e6))), daemon=True)
            th.start()
            time.sleep(0.5)
            assert th.is_alive(), "the request did not wait for the migration"
            b.migrate_in("x", transfer)
            router.pin("x", "r1")
        th.join(timeout=30)
        assert out and out[0][0] == 200, out
        assert router.counters["gone_410"] == 1
        assert b.stats("x")["counters"]["ingested_traces"] == 6
    finally:
        router.stop()
        for r in reps:
            r.stop()


def test_health_probe_misses_and_refusals(tmp_path):
    """A replica whose ``/readyz`` answers late stays in routing until
    ``breaker_fails`` probes in a row time out (routing around a busy
    replica would fork its tenants' streams); one that refuses the probe
    leaves at once, and one that answers again comes back."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    slow = threading.Event()

    class Readyz(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if slow.is_set():
                time.sleep(0.8)
            body = b"{}"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Readyz)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    dead = _dead_url()
    router = FleetRouter({"busy": f"http://127.0.0.1:{srv.server_address[1]}",
                          "dead": dead}, port=0, health_s=0.05, breaker_fails=3).start()
    try:
        deadline = time.monotonic() + 10
        while router.replicas["dead"].ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not router.replicas["dead"].ready
        slow.set()
        seen = []
        for _ in range(30):
            seen.append(router.replicas["busy"].ready)
            if not seen[-1]:
                break
            time.sleep(0.1)
        # out, but only after more than one late probe (0.5 s each)
        assert seen[-1] is False and len(seen) >= 10
        slow.clear()
        deadline = time.monotonic() + 10
        while not router.replicas["busy"].ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.replicas["busy"].ready
    finally:
        router.stop()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("front", ["replica", "router"])
def test_body_no_route_reads_is_read_before_the_close(tmp_path, front):
    """A POST whose body its route does not read (the router's
    ``migrate_out`` sends ``{}``, after its headers): the server reads the
    body before it closes the connection. A close over unread bytes is a
    reset, which throws away the part of a large reply (a ``migrate_out``
    transfer) still in flight."""
    rep = InProcReplica("solo", cfg(state_dir=str(tmp_path / "solo")), device="cpu")
    router = FleetRouter({"solo": rep.base_url}, port=0).start()
    url = rep.base_url if front == "replica" else router.base_url
    host, port = url.rsplit("/", 1)[-1].split(":")
    try:
        with socket.create_connection((host, int(port)), timeout=30) as sock:
            sock.sendall(b"POST /api/v1/flush HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\nContent-Length: 2\r\n"
                         b"Connection: close\r\n\r\n")
            reply = b""
            while b"\r\n\r\n" not in reply or not reply.rstrip().endswith(b"}"):
                reply += sock.recv(65536)
            assert b" 200 " in reply.split(b"\r\n", 1)[0]
            # the reply is out, the body not yet sent: the server waits for it
            sock.settimeout(0.5)
            with pytest.raises(socket.timeout):
                sock.recv(1)
            sock.settimeout(30)
            sock.sendall(b"{}")
            assert sock.recv(1) == b""
    finally:
        router.stop()
        rep.stop()


# ---------------------------------------------------------------------------
# live migration
# ---------------------------------------------------------------------------

def _fleet_migration(root, make_replica, manager_cls, pay1, pay2):
    """Half the traffic to the tenant's ring owner through the router, a
    migration to the other replica, the rest through the router, a flush;
    returns the destination's sink and what was checked on the way."""
    reps = [make_replica(f"r{i}", str(root / f"r{i}")) for i in range(2)]
    fleet = manager_cls(reps, router_port=0)
    try:
        code, out, _ = http("POST", fleet.base_url + "/api/v1/tenants/mig/spans", pay1)
        assert code == 200 and out["ingested_traces"] == 12
        src = fleet.router.owner("mig")
        dst = "r1" if src == "r0" else "r0"
        res = fleet.migrate("mig", dst)
        assert (res["src"], res["dst"]) == (src, dst)
        assert fleet.router.counters["migrations"] == 1
        code, out, _ = http("POST", fleet.base_url + "/api/v1/tenants/mig/spans", pay2)
        assert code == 200 and out["ingested_traces"] == 12
        old = fleet.router.replicas[src].base_url
        code, out, _ = http("POST", old + "/api/v1/tenants/mig/spans", pay2)
        assert code == 410 and "migrated out" in out["error"]
        code, _, _ = http("POST", fleet.base_url + "/api/v1/flush")
        assert code == 200
        st = next(r for r in reps if r.name == dst).service.stats("mig")
        assert st["counters"]["ingested_traces"] == 24 and st["traces_emitted"] == 24
        assert st["shed_dropped_windows"] == st["deadletter_windows"] == 0
    finally:
        fleet.stop()
    return _read(root / dst / "mig" / "traces.jsonl")


def test_live_migration_mid_stream_byte_identical(tmp_path):
    """Half a tenant's traces on replica A with its window still open, a
    live migration through the router, the rest on replica B: B's sink
    equals the port's unmigrated run and the JAX fleet's migrated run."""
    jserve, jmanager, _ = _jax()
    pay1 = hotel_payload(n_traces=12, prefix="m")
    pay2 = hotel_payload(n_traces=12, prefix="n", base_us=9_000_000.0)
    base, _ = _alone(tmp_path, "mig", {"data": pay1["data"] + pay2["data"]})
    port = _fleet_migration(
        tmp_path / "port", lambda n, d: InProcReplica(n, cfg(state_dir=d), device="cpu"),
        FleetManager, pay1, pay2)
    jax = _fleet_migration(
        tmp_path / "jax", lambda n, d: jmanager.InProcReplica(n, _jcfg(jserve, state_dir=d)),
        jmanager.FleetManager, pay1, pay2)
    assert port == base == jax and port.count(b"\n") >= 1


@pytest.mark.parametrize("fault", ["cap", "silent"])
def test_refused_migration_keeps_the_tenant(tmp_path, fault):
    """A destination that refuses the tenant (its tenant cap) or does not
    answer at all: the source resumes the tenant from the checkpoint and
    WAL it kept under the tombstone (``migrate_abort``), so nothing it
    acknowledged is lost, and its sink equals the unmigrated run's. (The
    JAX package's source has deleted both by then.)"""
    pay1 = hotel_payload(n_traces=12, prefix="m")
    pay2 = hotel_payload(n_traces=12, prefix="n", base_us=9_000_000.0)
    base, _ = _alone(tmp_path, "mig", {"data": pay1["data"] + pay2["data"]})
    src = InProcReplica("src", cfg(state_dir=str(tmp_path / "src")), device="cpu")
    dst = None
    if fault == "cap":
        dst = InProcReplica("dst", cfg(state_dir=str(tmp_path / "dst"), max_tenants=1),
                            device="cpu")
        dst.service.ingest("other", raw(hotel_payload(n_traces=2, prefix="o")))
        dst_url = dst.base_url
    else:
        silent = socket.socket()          # accepts, never answers
        silent.bind(("127.0.0.1", 0))
        silent.listen(5)
        dst_url = f"http://127.0.0.1:{silent.getsockname()[1]}"
    router = FleetRouter({"src": src.base_url, "dst": dst_url}, port=0,
                         migrate_timeout_s=2.0).start()
    router.pin("mig", "src")
    url = f"{router.base_url}/api/v1/tenants/mig/spans"
    try:
        assert http("POST", url, pay1, headers={"X-TW-Seq": "0"})[0] == 200
        with pytest.raises(RuntimeError, match="the tenant resumed on src"):
            router.migrate("mig", "dst")
        assert router.owner("mig") == "src"
        assert router.counters["migrations"] == 0
        assert router.counters["migrations_aborted"] == 1
        st = src.service.stats()
        assert st["migrated_out"] == [] and st["dispatch"]["migrations_out"] == 1
        # a retry of the acknowledged POST dedups against the kept WAL
        code, out, _ = http("POST", url, pay1, headers={"X-TW-Seq": "0"})
        assert code == 200 and out.get("deduped") is True
        assert http("POST", url, pay2, headers={"X-TW-Seq": "1"})[0] == 200
        assert http("POST", router.base_url + "/api/v1/tenants/mig/flush")[0] == 200
        t = src.service.stats("mig")
        assert t["counters"]["ingested_traces"] == t["traces_emitted"] == 24
        if dst is not None:
            assert sorted(dst.service.tenants) == ["other"]
            assert not os.path.exists(tmp_path / "dst" / "mig" / "ckpt.pkl")
    finally:
        router.stop()
        src.stop()
        if dst is not None:
            dst.stop()
        else:
            silent.close()
    assert _read(tmp_path / "src" / "mig" / "traces.jsonl") == base


def test_unsettled_migration_stays_tombstoned_across_a_restart(tmp_path):
    """Between ``migrate_out`` and its settlement the source keeps the
    tenant's checkpoint and WAL, but a restart there resumes the tombstone,
    not the tenant; ``migrate_abort`` after the restart resumes it, and
    ``migrate_commit`` deletes the kept state."""
    cfg_a = cfg(state_dir=str(tmp_path / "a"))
    a = TenantService(cfg_a, device="cpu")
    body = raw(hotel_payload(n_traces=8, prefix="x"))
    a.wal_ingest("ten", body, raw=body, client_seq=0)
    a.migrate_out("ten")
    tdir = tmp_path / "a" / "ten"
    assert os.path.exists(tdir / "ckpt.pkl") and os.listdir(tdir / "wal")
    a.drain()
    a2 = TenantService.resume(cfg_a, device="cpu")
    assert "ten" in a2.migrated_out and "ten" not in a2.tenants
    with pytest.raises(TenancyError, match="migrated out"):
        a2.tenant("ten")
    assert a2.migrate_abort("ten")["tenant"] == "ten"
    a2.flush()
    assert a2.stats("ten")["traces_emitted"] == 8
    b = TenantService(cfg(state_dir=str(tmp_path / "b")), device="cpu")
    b.migrate_in("ten", a2.migrate_out("ten"))
    assert a2.migrate_commit("ten")["committed"] is True
    assert not os.path.exists(tdir / "ckpt.pkl") and not os.listdir(tdir / "wal")
    with pytest.raises(TenancyError, match="committed"):
        a2.migrate_abort("ten")
    assert b.stats("ten")["traces_emitted"] == 8
    a2.drain()
    b.drain()


def test_hold_outlasting_the_timeout_answers_503(tmp_path):
    """A request held past ``migrate_timeout_s`` (a respawn paying a cold
    start) is answered 503 with ``Retry-After``; it is not routed while the
    tenant's state is in flight, where a survivor would mint a twin."""
    reps = [InProcReplica(f"r{i}", cfg(state_dir=str(tmp_path / f"r{i}")), device="cpu")
            for i in range(2)]
    router = FleetRouter({r.name: r.base_url for r in reps}, port=0,
                         migrate_timeout_s=0.5).start()
    try:
        with router.hold_tenant("held"):
            code, out, hdr = http("POST", f"{router.base_url}/api/v1/tenants/held/spans",
                                  hotel_payload(n_traces=2, prefix="h"))
        assert code == 503 and hdr.get("Retry-After") == "1", out
        assert router.counters["hold_expired"] == 1 and router.counters["proxied"] == 0
        assert all("held" not in r.service.tenants for r in reps)
        code, out, _ = http("POST", f"{router.base_url}/api/v1/tenants/held/spans",
                            hotel_payload(n_traces=2, prefix="h"))
        assert code == 200 and out["ingested_traces"] == 2
    finally:
        router.stop()
        for r in reps:
            r.stop()


def test_ring_tickets_name_their_windows_in_the_event_sink(tmp_path):
    """Under continuous admission each ring ticket's submit and complete
    land in the event sink with its process, sequence and each tenant's
    windows, in order: the solve batches of a run, readable from outside
    its process."""
    import json

    from traceweaver_tpu_torch.obs import events

    log = events.EventLog(str(tmp_path / "events.jsonl"))
    prev = events.install(log)
    try:
        svc = TenantService(cfg(state_dir=str(tmp_path / "s"), continuous=True),
                            device="cpu")
        for p in _window_payloads(n=4):
            svc.ingest("a", raw(p))
        svc.flush()
        emitted = svc.stats("a")["emitted_windows"]
        svc.drain()
    finally:
        events.install(prev)
        log.close()
    with open(tmp_path / "events.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    ticks = [(r["event"], r["seq"], r["windows"]) for r in recs
             if r["event"].startswith("ring_ticket_")]
    assert ticks and all(r["pid"] == os.getpid() for r in recs
                         if r["event"].startswith("ring_ticket_"))
    subs = [t for t in ticks if t[0] == "ring_ticket_submitted"]
    assert [t[1:] for t in subs] == [t[1:] for t in ticks if t[0] == "ring_ticket_completed"]
    ks = [k for _, _, w in subs for k in w["a"]]
    assert sorted(ks) == list(range(len(ks))) and len(ks) == emitted > 1


def test_migration_under_overlap_byte_identical(tmp_path):
    """``migrate_out`` of a tenant whose windows ride two outstanding
    tickets waits for both to retire; the migrated output equals the
    unmigrated run's, the port's and the JAX package's."""
    jserve, _, _ = _jax()
    pays = _window_payloads()
    both = {"data": [t for p in pays for t in p["data"]]}
    base, _ = _alone(tmp_path, "mig", both)
    js = jserve.TenantService(_jcfg(jserve, state_dir=str(tmp_path / "jax")))
    js.ingest("mig", raw(both))
    js.flush()
    js.drain()
    assert _read(tmp_path / "jax" / "mig" / "traces.jsonl") == base

    src = TenantService(cfg(state_dir=str(tmp_path / "src")), device="cpu")
    dst = TenantService(cfg(state_dir=str(tmp_path / "dst")), device="cpu")
    for p in pays:
        src.ingest("mig", raw(p))
    with src._lock:
        t = src.tenants["mig"]
        ready = list(t.svc.scheduler.ready())
    assert len(ready) >= 2
    tk1 = src.submit_admitted([(t, ready[:1])])
    tk2 = src.submit_admitted([(t, ready[1:])])
    moved = []
    th = threading.Thread(target=lambda: moved.append(src.migrate_out("mig")), daemon=True)
    th.start()
    time.sleep(0.3)
    assert th.is_alive(), "migrate_out ran with tickets outstanding"
    src._ring_dispatch(tk1)
    src.complete_ticket(tk1)
    time.sleep(0.3)
    assert th.is_alive(), "migrate_out ran with ticket 2 outstanding"
    src._ring_dispatch(tk2)
    src.complete_ticket(tk2)
    th.join(timeout=30)
    assert moved
    dst.migrate_in("mig", moved[0])
    with pytest.raises(TenancyError, match="migrated out"):
        src.tenant("mig")
    dst.flush()
    assert dst.stats("mig")["traces_emitted"] == 24
    src.drain()
    dst.drain()
    assert _read(tmp_path / "dst" / "mig" / "traces.jsonl") == base


def test_tombstone_survives_resume_and_answers_410(tmp_path):
    cfg_a = cfg(state_dir=str(tmp_path / "a"))
    a = TenantService(cfg_a, device="cpu")
    b = TenantService(cfg(state_dir=str(tmp_path / "b")), device="cpu")
    a.ingest("ten", raw(hotel_payload(n_traces=8, prefix="x")))
    b.migrate_in("ten", a.migrate_out("ten"))
    assert a.stats()["migrated_out"] == ["ten"]
    assert a.stats()["dispatch"]["migrations_out"] == 1
    assert b.stats()["dispatch"]["migrations_in"] == 1
    with pytest.raises(TenancyError, match="migrated out"):
        a.tenant("ten")
    a.drain()
    a2 = TenantService.resume(cfg_a, device="cpu")
    assert "ten" in a2.migrated_out and "ten" not in a2.tenants
    server = make_server(a2, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, out, _ = http("POST", base + "/api/v1/tenants/ten/spans",
                            hotel_payload(n_traces=2, prefix="y"))
        assert code == 410 and "migrated out" in out["error"]
        code, out, _ = http("GET", base + "/api/v1/tenants/ten/traces")
        assert code == 410
    finally:
        server.shutdown()
        server.server_close()
    b.flush()
    assert b.stats("ten")["traces_emitted"] == 8
    a2.drain()
    b.drain()


@pytest.mark.parametrize("tear", ["crc", "truncated"])
def test_transfer_refuses_torn_checkpoint_bytes(tmp_path, tear):
    from traceweaver_tpu.stream import checkpoint as jax_ckpt

    path = str(tmp_path / "ckpt.pkl")
    port_ckpt.save_checkpoint(path, {"hello": "world"})
    good = port_ckpt.read_checkpoint_bytes(path)
    assert port_ckpt.verify_checkpoint_bytes(good) + good[-16:] == good
    torn = (bytes([good[0] ^ 0xFF]) + good[1:] if tear == "crc"
            else good[:1] + good[-16:])
    with pytest.raises(port_ckpt.CheckpointCorrupt,
                       match="CRC" if tear == "crc" else "truncated"):
        port_ckpt.write_checkpoint_bytes(str(tmp_path / "out.pkl"), torn)
    with pytest.raises(jax_ckpt.CheckpointCorrupt):
        jax_ckpt.verify_checkpoint_bytes(torn)
    assert not os.path.exists(tmp_path / "out.pkl")
    with open(path, "wb") as f:
        f.write(torn)
    with pytest.raises(port_ckpt.CheckpointCorrupt):
        port_ckpt.read_checkpoint_bytes(path)
    # the destination refuses a torn transfer and installs nothing
    import base64

    dst = TenantService(cfg(state_dir=str(tmp_path / "dst")), device="cpu")
    with pytest.raises(TenancyError, match="torn"):
        dst.migrate_in("ten", dict(checkpoint_b64=base64.b64encode(torn).decode()))
    assert "ten" not in dst.tenants


# ---------------------------------------------------------------------------
# crash failover from the dead disk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", ["prev", "wal_only"])
def test_crash_failover_from_disk_byte_identical(tmp_path, state):
    """A replica that dies without a drain: the failover transfer built
    from its disk (a torn primary checkpoint falls back to ``.prev``; a
    tenant never checkpointed is known only from its WAL) resumes on a
    survivor with the unmigrated run's bytes, and the dead copy is
    tombstoned."""
    pays = _window_payloads()
    base, _ = _alone(tmp_path, "mig", {"data": [t for p in pays for t in p["data"]]})
    cfg_a = cfg(state_dir=str(tmp_path / "a"))
    a = TenantService(cfg_a, device="cpu")
    for k, p in enumerate(pays):
        a.wal_ingest("mig", raw(p), raw=raw(p), client_seq=k)
        if state == "prev" and k < 2:
            assert a.tenants["mig"].checkpoint()
    tdir = tmp_path / "a" / "mig"
    if state == "prev":
        ck = _read(tdir / "ckpt.pkl")
        with open(tdir / "ckpt.pkl", "wb") as f:
            f.write(bytes([ck[0] ^ 0xFF]) + ck[1:])
    else:
        assert not os.path.exists(tdir / "ckpt.pkl")
    transfer = port_tenancy.read_crashed_transfer(str(tdir), "mig")
    assert bool(transfer["checkpoint_b64"]) == (state == "prev")
    assert transfer["wal_b64"]
    b = TenantService(cfg(state_dir=str(tmp_path / "b")), device="cpu")
    out = b.migrate_in("mig", transfer)
    assert out["backlog"] >= 1
    port_tenancy.tombstone_crashed_tenant(str(tdir), "mig")
    b.flush()
    st = b.stats("mig")
    assert st["counters"]["ingested_traces"] == 24 and st["traces_emitted"] == 24
    b.drain()
    assert _read(tmp_path / "b" / "mig" / "traces.jsonl") == base
    a2 = TenantService.resume(cfg_a, device="cpu")
    assert "mig" in a2.migrated_out and "mig" not in a2.tenants
    with pytest.raises(port_tenancy.TenancyError, match="no recoverable state"):
        port_tenancy.read_crashed_transfer(str(tdir), "mig")


# ---------------------------------------------------------------------------
# device-resident columns across a migration
# ---------------------------------------------------------------------------

def test_migration_out_and_back_leaves_no_stale_rings(tmp_path):
    """A tenant's resident rings leave with it, and back home it solves on
    fresh rings; the sink still equals the unmigrated run's."""
    pays = _window_payloads(n=6)
    store = devcols.get_store()
    base, _ = _alone(tmp_path, "mig", {"data": [t for p in pays for t in p["data"]]},
                     pump_windows=1)
    store.clear()

    def rings():
        return [r for r in store.rings() if r.key.startswith("mig/")]

    a = TenantService(cfg(state_dir=str(tmp_path / "a"), pump_windows=1), device="cpu")
    b = TenantService(cfg(state_dir=str(tmp_path / "b"), pump_windows=1), device="cpu")
    left = []    # every ring the tenant left behind, kept alive so ids stay unique
    for k, (home, nxt) in enumerate(((a, b), (b, a), (a, None))):
        for p in pays[2 * k:2 * k + 2]:
            home.ingest("mig", raw(p))
        if nxt is None:
            break
        assert rings(), "the tenant solved on resident rings"
        left += rings()
        nxt.migrate_in("mig", home.migrate_out("mig"))
        assert rings() == [], "migrate_out left the tenant's rings"
    a.flush()
    back = rings()
    assert back and not {id(r) for r in back} & {id(r) for r in left}
    a.drain()
    b.drain()
    assert _read(tmp_path / "a" / "mig" / "traces.jsonl") == base


# ---------------------------------------------------------------------------
# the wire campaign and the regression gate
# ---------------------------------------------------------------------------

def test_inproc_wire_campaign_artifact_read_by_both_packages(tmp_path):
    from traceweaver_tpu.campaign.compare import compare_artifacts as jax_compare
    from traceweaver_tpu.campaign.ledger import load_artifact as jax_load
    from traceweaver_tpu_torch.fleet_serve.campaign import run_fleet_campaign

    out = str(tmp_path / "CAMPAIGN_fleet_test.json")
    port_ledger.reset_for_tests()
    art = run_fleet_campaign(str(tmp_path / "state"), replica_counts=(1, 2), tenants=2,
                             seconds=1.0, traces_per_post=4, base_period_s=0.1,
                             mode="inproc", out=out, device="cpu")
    loaded = port_ledger.load_artifact(out)
    assert jax_load(out) == loaded and loaded["backend"] == "wire"
    assert [r["rung"] for r in loaded["rungs"]] == ["fleet-1", "fleet-2"]
    for r in loaded["rungs"]:
        assert r["fleet"]["zero_loss"] is True
        assert r["accuracy"]["e2e_pct"] == 100.0
        assert r["steady"]["spans_per_s"] > 0
        assert r["manifest"]["spans"] == r["manifest"]["traces"] * 5
        assert r["fleet"]["parse_s"] > 0.0
        assert r["steady"]["backend_compiles"] == 0 and r["steady"]["aot_misses"] == []
        assert all("fused_assign" in k for k in r["fleet"]["kernels_final"].values())
    assert loaded["rungs"][1]["fleet"]["migrations"] >= 1
    report = port_compare.format_report(loaded)
    assert "fleet-1" in report and "fleet-2" in report
    assert port_compare.compare_artifacts(art, loaded)["ok"]
    assert jax_compare(art, loaded, tol_pct=10.0, tol_acc=1.0)["ok"]
    text = "\n".join(port_ledger.scrape_snapshot()["samples"])
    assert 'tw_campaign_spans_per_s{rung="fleet-2"}' in text


def _fake_artifact():
    def rung(name, tp, acc, misses=(), compiles=0):
        return dict(rung=name, manifest=dict(spans=1000, regime_mix={"sequential": 3}),
                    steady=dict(spans_per_s=tp, backend_compiles=compiles,
                                aot_misses=list(misses), quarantined=0),
                    accuracy=dict(e2e_pct=acc, per_regime={}))

    return dict(schema=1, kind="campaign", name="t", created_unix=0.0, backend="cpu",
                devices_visible=2, plan=dict(devices=2, slices=2),
                rungs=[rung("r1", 1000.0, 99.0), rung("r2", 5000.0, 97.0)],
                metrics_scrape=None, wall_s=1.0)


def _edit_throughput(a):
    a["rungs"][1]["steady"]["spans_per_s"] = 4000.0


def _edit_accuracy(a):
    a["rungs"][0]["accuracy"]["e2e_pct"] = 97.5


def _edit_builds(a):
    a["rungs"][0]["steady"]["aot_misses"] = ["sinkhorn.cu"]
    a["rungs"][0]["steady"]["backend_compiles"] = 3


def _edit_missing(a):
    a["rungs"] = a["rungs"][:1]


def _edit_improved(a):
    a["rungs"][1]["steady"]["spans_per_s"] = 9000.0
    a["rungs"][1]["accuracy"]["e2e_pct"] = 99.5


def _edit_environment(a):
    a["devices_visible"] = 1


@pytest.mark.parametrize("edit,tol", [
    (_edit_throughput, (10.0, 1.0)), (_edit_throughput, (25.0, 1.0)),
    (_edit_accuracy, (10.0, 1.0)), (_edit_builds, (10.0, 1.0)),
    (_edit_missing, (10.0, 1.0)), (_edit_improved, (10.0, 1.0)),
    (_edit_environment, (10.0, 1.0)), (lambda a: None, (0.0, 0.0))])
def test_compare_flags_the_regression_classes_jax_flags(edit, tol):
    from traceweaver_tpu.campaign.compare import compare_artifacts as jax_compare

    base = _fake_artifact()
    cand = copy.deepcopy(base)
    edit(cand)
    got = port_compare.compare_artifacts(base, cand, tol_pct=tol[0], tol_acc=tol[1])
    want = jax_compare(base, cand, tol_pct=tol[0], tol_acc=tol[1])
    assert got["ok"] == want["ok"]
    assert [(r["rung"], r["field"]) for r in got["regressions"]] == \
        [(r["rung"], r["field"]) for r in want["regressions"]]
    assert got["rungs"] == want["rungs"] and got["tolerances"] == want["tolerances"]


# ---------------------------------------------------------------------------
# knobs and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: HashRing(["a"], vnodes=0),
    lambda: HashRing(["a"], vnodes=4097),
    lambda: CircuitBreaker(fail_max=0),
    lambda: CircuitBreaker(cooldown_s=0.05),
    lambda: FleetRouter({"a": "http://127.0.0.1:1"}, port=0, retry_max=17),
    lambda: FleetRouter({"a": "http://127.0.0.1:1"}, port=0, health_s=0.01),
    lambda: FleetRouter({"a": "http://127.0.0.1:1"}, port=0, proxy_timeout_s=0.0),
    lambda: FleetRouter({"a": "http://127.0.0.1:1"}, port=0, migrate_timeout_s=4000.0),
    lambda: FleetRouter({"a": "http://127.0.0.1:1"}, port=70000),
    lambda: FleetManager([], respawn_max=65),
    lambda: port_compare.compare_artifacts({}, {}, tol_pct=-1.0),
    lambda: port_compare.compare_artifacts({}, {}, tol_acc=-0.5),
])
def test_out_of_range_arguments_raise(make):
    with pytest.raises(ValueError, match="not in"):
        make()


def test_fleet_cli_without_card_or_device_exits_1(tmp_path):
    """With no card and no ``--device``, the replica exits 2 and ``fleet
    serve`` reports the ``ReplicaError`` and exits 1; out-of-range flags
    exit 2."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from traceweaver_tpu_torch.runtime import cli

    assert cli.main(["fleet", "serve", "--replicas", "65",
                     "--state-dir", str(tmp_path / "x")]) == 2
    out = subprocess.run(
        [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "fleet", "serve",
         "--replicas", "1", "--port", "0", "--state-dir", str(tmp_path / "f")],
        cwd=REPO, env=CPU_ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "ReplicaError" in out.stdout and "exit 2" in out.stdout


def test_replica_processes_rolling_restart_and_sigkill_respawn(tmp_path):
    """Two ``cli serve --device cpu`` replicas under the crash supervisor:
    traffic, a rolling restart of both, a SIGKILL of the replica holding
    a tenant and its ``--resume`` respawn (WAL replay), more traffic, a
    flush: every acknowledged trace emitted exactly once, and the killed
    tenant's sink equal to its unmigrated run's."""
    pays = _window_payloads(n=4)
    base, _ = _alone(tmp_path, "ta", {"data": [t for p in pays for t in p["data"]]})
    args = ["--fix", "2", "--watermark_s", "1", "--device", "cpu", "--no-continuous"]
    reps = [ReplicaProcess(f"r{i}", str(tmp_path / f"r{i}"), serve_args=args,
                           env=CPU_ENV).start() for i in range(2)]
    fleet = FleetManager(reps, router_port=0, supervise=True)
    url = fleet.base_url + "/api/v1/tenants/{}/spans"

    def post(k):
        for tid in ("ta", "tb"):
            code, out, _ = http("POST", url.format(tid), pays[k],
                                headers={"X-TW-Seq": str(k)})
            assert code == 200, out

    try:
        post(0)
        post(1)
        report = fleet.rolling_restart()
        assert sorted(report) == ["r0", "r1"]
        assert fleet.router.counters["restarts"] == 2
        # acknowledged on the tenants' new home, before any checkpoint
        # there: the respawn's WAL replay must bring it back
        post(2)
        victim = fleet.router.owner("ta")
        fleet.replicas[victim].proc.send_signal(signal.SIGKILL)
        deadline = time.monotonic() + 120
        while fleet.router.counters["respawns"] < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert fleet.router.counters["respawns"] == 1
        assert fleet.recoveries and fleet.recoveries[0]["mode"] == "respawn"
        post(3)
        code, _, _ = http("POST", fleet.base_url + "/api/v1/flush")
        assert code == 200
        code, st, _ = http("GET", fleet.base_url + "/api/v1/stats")
        tenants = {tid: t for s in st["replica_stats"].values()
                   for tid, t in s["tenants"].items()}
        assert sorted(tenants) == ["ta", "tb"]
        for t in tenants.values():
            assert t["counters"]["ingested_traces"] == t["traces_emitted"] == 24
        for s in st["replica_stats"].values():
            # CPU replicas launch no kernel and build none
            k = s["kernels"]
            assert (k["fused_assign"], k["sinkhorn"], k["assemble_block"], k["built"]) \
                == (0, 0, 0, [])
        owner = fleet.router.owner("ta")
    finally:
        fleet.stop()
    assert all(r.proc.returncode == 0 for r in reps)
    assert _read(tmp_path / owner / "ta" / "traces.jsonl") == base


@pytest.mark.gpu
def test_migration_between_card_replicas(tmp_path):
    """Two ``cli serve`` replicas on the card: a tenant migrated mid-stream
    emits its unmigrated bytes, and each replica launched K1 and the
    assembly kernel at least as often (no block built another way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # ten windows a replica: the fixed pump (eight windows) solves on both
    pays = _window_payloads(n=20)
    args = ["--fix", "2", "--watermark_s", "1", "--no-continuous"]
    env = {**os.environ, "PYTHONPATH": REPO}
    reps = [ReplicaProcess(f"r{i}", str(tmp_path / f"r{i}"), serve_args=args,
                           env=env).start() for i in range(2)]
    fleet = FleetManager(reps, router_port=0)
    url = fleet.base_url + "/api/v1/tenants/mig/spans"
    try:
        for p in pays[:10]:
            assert http("POST", url, p)[0] == 200
        dst = "r1" if fleet.router.owner("mig") == "r0" else "r0"
        fleet.migrate("mig", dst)
        for p in pays[10:]:
            assert http("POST", url, p)[0] == 200
        assert http("POST", fleet.base_url + "/api/v1/flush")[0] == 200
        st = http("GET", fleet.base_url + "/api/v1/stats")[1]
        for s in st["replica_stats"].values():
            k = s["kernels"]
            # every K1 launch solved a block the assembly kernel built
            assert k["assemble_block"] >= k["fused_assign"] > 0
    finally:
        fleet.stop()
    # the serve CLI's settings under --no-continuous: the pump of eight
    ref = TenantService(cfg(state_dir=str(tmp_path / "alone"), pump_windows=8))
    for p in pays:
        ref.ingest("mig", raw(p))
    ref.flush()
    ref.drain()
    assert _read(tmp_path / dst / "mig" / "traces.jsonl") == \
        _read(tmp_path / "alone" / "mig" / "traces.jsonl")
