"""The port's multi-tenant serve tier against the JAX package's
(``traceweaver_tpu_torch/serve``, the ``serve`` subcommand).

Two tenants POST the JAX package's hotel fixture (``tests/test_serve.py``:
frontend -> search -> geo, fix 2, the culprit planted in ``search``) over
HTTP on loopback into the port's service on the CPU:

- each tenant's sink equals its alone run byte for byte and the JAX
  package's sink on the same payloads; the shared solve takes fewer
  fleet dispatches than the tenant-serial sum; the live delay-culprit
  query names the planted culprit; the tenant id column conserves;
- per-tenant backpressure (shed counted, 429 with ``Retry-After``), the
  tenant cap and id validation, malformed spans and strict mode, a fault
  storm kept to its own tenant;
- ``/readyz`` turns 503 on drain, ``/metrics`` equals ``/api/v1/stats``,
  the live-migration routes answer (410 for a migrated-out tenant);
- no card and no ``device``: the service and the CLI refuse;
- the ``serve --device cpu`` subprocess drains on SIGTERM and resumes;
- a tenant replayed alone with the shared run's batches emits the
  shared run's bytes (the CPU contract the card is held to at 0.99).

The JAX package is imported only inside the tests that compare with it,
so the ``gpu`` test runs where JAX is not installed.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from traceweaver_tpu_torch.ops import devcols
from traceweaver_tpu_torch.serve import (
    ServeConfig,
    TenancyError,
    TenantService,
    make_server,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hotel_trace(i, prefix, base_us=1_000_000.0, spacing_us=10_000.0, slow_every=6):
    """One fix-2 trace of the JAX package's hotel fixture
    (``tests/test_serve.py``): every ``slow_every``-th spends its latency
    in ``search``'s self time."""
    T = base_us + i * spacing_us
    slow = (i % slow_every) == slow_every - 1
    s1_dur = 5000.0 if slow else 600.0
    c1_dur = s1_dur + 500.0
    root_dur = c1_dur + 400.0
    tid = f"{prefix}{i:03d}"

    def span(sid, start, dur, op, refs, pid, kind):
        return dict(traceID=tid, spanID=sid, startTime=start, duration=dur,
                    operationName=op,
                    references=[{"traceID": tid, "spanID": r} for r in refs],
                    processID=pid, tags=[{"key": "span.kind", "value": kind}])

    spans = [
        span("root", T, root_dur, "HTTP GET /hotels", [], "p1", "server"),
        span("c1", T + 200, c1_dur, "call-search", ["root"], "p1", "client"),
        span("s1", T + 300, s1_dur, "search", ["c1"], "p2", "server"),
        span("c2", T + 400, 300.0, "call-geo", ["s1"], "p2", "client"),
        span("s2", T + 450, 200.0, "geo", ["c2"], "p3", "server"),
    ]
    return dict(traceID=tid, spans=spans,
                processes=dict(p1={"serviceName": "frontend"},
                               p2={"serviceName": "search"},
                               p3={"serviceName": "geo"}))


def hotel_payload(n_traces=24, prefix="t", base_us=1_000_000.0, spacing_us=10_000.0,
                  slow_every=6):
    return {"data": [hotel_trace(i, prefix, base_us, spacing_us, slow_every)
                     for i in range(n_traces)]}


def raw(payload) -> bytes:
    return json.dumps(payload).encode("utf-8")


def cfg(**kw):
    base = dict(fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False,
                pump_windows=10**9)
    base.update(kw)
    return ServeConfig(**base)


def http(method, url, payload=None, headers=None, timeout=120):
    data = raw(payload) if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            return resp.status, (json.loads(body) if body[:1] in b"{[" else body), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@pytest.fixture(autouse=True)
def _fresh_rings():
    devcols.get_store().clear()
    yield
    devcols.get_store().clear()


def _jax_serve():
    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu import serve as jserve

    return jserve


def _sink(state, tid):
    with open(os.path.join(state, tid, "traces.jsonl"), "rb") as f:
        return f.read()


def _alone(tmp_path, name, payload, **kw):
    state = str(tmp_path / f"alone-{name}")
    svc = TenantService(cfg(state_dir=state, **kw), device="cpu")
    svc.ingest(name, raw(payload))
    svc.flush()
    dispatches = int(svc.fleet_stats.get("fleet_dispatches", 0))
    svc.drain()
    return _sink(state, name), dispatches


def test_multi_tenant_http_end_to_end(tmp_path):
    pay_a = hotel_payload(prefix="a")
    pay_b = hotel_payload(prefix="b", base_us=9_000_000.0)
    state = str(tmp_path / "mt")
    service = TenantService(cfg(state_dir=state), device="cpu")
    server = make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, out, _ = http("POST", base + "/api/v1/tenants/alpha/spans", pay_a)
        assert code == 200 and out["ingested_traces"] == 24 and out["malformed_spans"] == 0
        code, out, _ = http("POST", base + "/api/v1/tenants/beta/spans", pay_b)
        assert code == 200 and out["ingested_spans"] == 120
        code, out, _ = http("POST", base + "/api/v1/flush")
        assert code == 200 and out["solved_windows"] == 2
        code, st, _ = http("GET", base + "/api/v1/stats")
        assert st["dispatch"]["shared_solves"] == 1 and st["dispatch"]["tenant_batches"] == 2
        assert st["tenants"]["alpha"]["seal_emit_p99_ms"] > 0.0
        assert st["fleet"]["tenant_windows_packed"] == st["fleet"]["tenant_windows_decoded"]
        assert st["fleet"]["h2d_bytes_ring"] > 0 and not st["fleet"].get("devcols_fallbacks")
        shared_dispatches = st["dispatch"]["fleet_dispatches"]
        for tid in ("alpha", "beta"):
            code, q, _ = http("GET", base + f"/api/v1/tenants/{tid}/query/delay_culprit"
                                            "?percentile=0.8")
            assert code == 200 and not q["empty"] and q["worst_service"] == "search"
        code, q, _ = http("GET", base + "/api/v1/tenants/alpha/query/low_confidence")
        assert code == 200 and q["n_traces"] == 24
        code, tr, _ = http("GET", base + "/api/v1/tenants/alpha/traces")
        assert code == 200 and tr["n_traces"] == 24
        code, rec, _ = http("GET", base + f"/api/v1/tenants/alpha/traces/{tr['trace_ids'][0]}")
        assert code == 200 and rec["complete"] and rec["n_spans"] == 5
        assert {s["service"] for s in rec["spans"]} == {"frontend", "search", "geo"}
        code, out, _ = http("GET", base + "/api/v1/tenants/nobody/traces")
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
    service.drain()
    got_a, got_b = _sink(state, "alpha"), _sink(state, "beta")
    solo_a, disp_a = _alone(tmp_path, "alpha", pay_a)
    solo_b, disp_b = _alone(tmp_path, "beta", pay_b)
    assert got_a == solo_a and got_b == solo_b
    assert b'"b' not in got_a and b'"a0' not in got_b
    assert shared_dispatches < disp_a + disp_b

    # the JAX package's service on the same payloads emits the same bytes
    jserve = _jax_serve()
    jstate = str(tmp_path / "jax")
    js = jserve.TenantService(jserve.ServeConfig(
        fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False,
        pump_windows=10**9, state_dir=jstate))
    js.ingest("alpha", raw(pay_a))
    js.ingest("beta", raw(pay_b))
    js.flush()
    js.drain()
    assert _sink(jstate, "alpha") == got_a and _sink(jstate, "beta") == got_b


def test_shared_batches_replayed_alone_emit_the_same_bytes(tmp_path):
    """The contract ``chip_smoke.py`` holds the card to at 0.99 of the
    rows: a tenant served alone with the batches the shared run gave it
    (its ticket submits and completes in the shared run's order) emits
    the shared run's bytes. Multi-window traffic under continuous
    admission with two tickets in flight."""
    sys.path.insert(0, REPO)
    import chip_smoke as CS

    pays = [hotel_payload(n_traces=60, prefix=p, base_us=b, spacing_us=1e6)
            for p, b in (("a", 1e6), ("b", 2e6))]
    state = str(tmp_path / "shared")
    svc = TenantService(cfg(state_dir=state, continuous=True, window_us=20e6,
                            overlap_us=4e6, pump_windows=2), device="cpu")
    events = []
    CS._record_batches(svc, events)
    for tid, pay in zip(("t0", "t1"), pays):
        for k in range(0, 60, 10):
            body = raw(dict(data=pay["data"][k:k + 10]))
            svc.wal_ingest(tid, body, raw=body)
    svc.flush()
    svc.drain()
    assert events and svc.stats()["dispatch"]["tenant_batches"] >= 2
    bodies = [raw(dict(data=pays[0]["data"][k:k + 10])) for k in range(0, 60, 10)]
    real = CS.SERVE_SETTINGS
    CS.SERVE_SETTINGS = dict(real, fix=2, window_us=20e6, overlap_us=4e6,
                             ooo_bound_us=1e6)
    try:
        path, _, _, _ = CS.serve_alone(bodies, str(tmp_path / "replay"), "cpu",
                                       plan=events)
    finally:
        CS.SERVE_SETTINGS = real
    with open(path, "rb") as f:
        assert f.read() == _sink(state, "t0")


def test_tenant_id_column_conserves_through_pack_and_decode():
    svc = TenantService(cfg(), device="cpu")
    svc.ingest("t-a", raw(hotel_payload(prefix="a")))
    svc.ingest("t-b", raw(hotel_payload(prefix="b", base_us=9e6)))
    svc.flush()
    packed = svc.fleet_stats.get("tenant_windows_packed", {})
    assert set(packed) == {"t-a", "t-b"} and all(v > 0 for v in packed.values())
    assert packed == svc.fleet_stats.get("tenant_windows_decoded", {})


def test_isolation_under_dispatch_fault_storm():
    svc = TenantService(cfg(window_us=20e6, overlap_us=4e6, pump_windows=1), device="cpu")
    svc.tenant("t0").fault_spec = "dispatch:0.5"
    for i, tid in enumerate(("t0", "t1", "t2")):
        svc.ingest(tid, raw(hotel_payload(prefix=tid[-1], base_us=(i + 1) * 1e6,
                                          spacing_us=5e6)))
    svc.flush()
    st = svc.stats()
    assert st["dispatch"]["isolated_solves"] > 0
    t0 = st["tenants"]["t0"]
    assert t0["emitted_windows"] + t0["deadletter_windows"] == t0["solved_windows"]
    assert t0["faults"]["injected"] > 0
    for tid in ("t1", "t2"):
        t = st["tenants"][tid]
        assert t["emitted_windows"] == t["solved_windows"] > 0
        assert t["deadletter_windows"] == t["quarantined_windows"] == 0
        assert all(v == 0 for v in t["faults"].values()), t["faults"]


def test_per_tenant_backpressure_and_retry_after(tmp_path):
    svc = TenantService(cfg(window_us=2e6, overlap_us=0.0, ooo_bound_us=1e5,
                            max_pending=1, spill_max=1), device="cpu")
    svc.ingest("burst", raw(hotel_payload(n_traces=40, prefix="x", spacing_us=3e6)))
    svc.ingest("quiet", raw(hotel_payload(n_traces=4, prefix="q", base_us=2e6,
                                          spacing_us=1e5)))
    b = svc.tenant("burst").svc.scheduler
    assert b.shed_spilled > 0 and b.shed_dropped_windows > 0
    q = svc.tenant("quiet").svc.scheduler
    assert q.shed_spilled == 0 and q.shed_dropped_windows == 0
    # the saturated tenant's next POST is refused with a Retry-After
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, out, hdr = http("POST", base + "/api/v1/tenants/burst/spans",
                              hotel_payload(n_traces=1, prefix="y", base_us=300e6))
        assert code == 429 and "backpressured" in out["error"]
        assert float(hdr["Retry-After"]) >= 0.05
        code, _, _ = http("POST", base + "/api/v1/tenants/quiet/spans",
                          hotel_payload(n_traces=1, prefix="z", base_us=3e6))
        assert code == 200
    finally:
        server.shutdown()
        server.server_close()
    svc.flush()
    st = svc.stats()
    assert st["dispatch"]["backpressure_429s"] >= 1
    assert st["tenants"]["quiet"]["emitted_windows"] > 0
    assert st["tenants"]["burst"]["emitted_windows"] > 0


def test_tenant_cap_and_id_validation():
    svc = TenantService(cfg(max_tenants=2), device="cpu")
    svc.tenant("a")
    svc.tenant("b")
    with pytest.raises(TenancyError, match="cap"):
        svc.tenant("c")
    for bad in ("no/slashes", "", "-lead"):
        with pytest.raises(TenancyError, match="invalid tenant id"):
            TenantService(cfg(), device="cpu").tenant(bad)


def test_malformed_spans_counted_like_jax_and_strict_mode():
    from traceweaver_tpu_torch.ingest.jaeger import MalformedSpan

    jserve = _jax_serve()
    payload = hotel_payload(n_traces=4, prefix="m")
    payload["data"][0]["spans"][1] = {"spanID": "broken"}
    payload["data"][1]["spans"][2]["startTime"] = "soon"
    got = TenantService(cfg(), device="cpu").ingest("t", raw(payload))
    want = jserve.TenantService(jserve.ServeConfig(
        fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False,
        pump_windows=10**9)).ingest("t", raw(payload))
    assert got == want and got["malformed_spans"] == 2
    with pytest.raises(MalformedSpan):
        TenantService(cfg(strict=True), device="cpu").ingest("t", raw(payload))


def test_readyz_metrics_and_not_ported_routes(tmp_path):
    """``/readyz``, ``/metrics`` against ``/api/v1/stats``, and the routes
    that answered 501 until live migration was ported: ``migrate_out``
    hands a tenant's transfer out and tombstones it (its requests answer
    410), ``migrate_in`` refuses a bad transfer and installs a good one."""
    svc = TenantService(cfg(state_dir=str(tmp_path / "s")), device="cpu")
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, ready, _ = http("GET", base + "/readyz")
        assert code == 200 and ready["aot"] == "off" and ready["ready"] is True
        for tid in ("a", "b"):
            http("POST", base + f"/api/v1/tenants/{tid}/spans",
                 hotel_payload(prefix=tid, base_us=1e6 if tid == "a" else 9e6))
        http("POST", base + "/api/v1/flush")
        code, metrics, _ = http("GET", base + "/metrics")
        metrics = metrics.decode()
        code, st, _ = http("GET", base + "/api/v1/stats")
        for tid, t in st["tenants"].items():
            for key in ("consumed", "emitted_windows", "solved_windows", "spans_emitted"):
                line = f'tw_serve_tenant_total{{key="{key}",tenant="{tid}"}}'
                assert any(ln.startswith(line + " ") and float(ln.split()[-1]) == t[key]
                           for ln in metrics.splitlines()), (line, t[key])
        for fam in ("tw_devcols_ring_fill", "tw_serve_tenant_ledger_total",
                    'key="wal_appends"', "tw_tenant_windows_total"):
            assert fam in metrics, fam
        code, out, _ = http("POST", base + "/api/v1/tenants/a/migrate_in", {"x": 1})
        assert code == 400 and "transfer" in out["error"]
        code, transfer, _ = http("POST", base + "/api/v1/tenants/b/migrate_out", {})
        assert code == 200 and transfer["tenant"] == "b" and transfer["checkpoint_b64"]
        code, out, _ = http("POST", base + "/api/v1/tenants/b/spans",
                            hotel_payload(prefix="b", base_us=9e6))
        assert code == 410 and "migrated out" in out["error"]
        code, out, _ = http("POST", base + "/api/v1/tenants/b/migrate_in", transfer)
        assert code == 200 and out["tenant"] == "b" and out["ring_traces"] == 24
        code, out, _ = http("POST", base + "/api/v1/tenants/nobody/migrate_out", {})
        assert code == 404
        # the capture route is ported: a JSON body without a sources
        # bundle is the client's error
        code, out, _ = http("POST", base + "/api/v1/tenants/a/capture", {"x": 1})
        assert code == 400 and "sources" in out["error"]
        svc.begin_drain()
        code, out, _ = http("GET", base + "/readyz")
        assert code == 503 and out["draining"] is True
    finally:
        server.shutdown()
        server.server_close()
    svc.drain()


def test_no_card_and_no_device_refuses(monkeypatch):
    from traceweaver_tpu_torch.runtime import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantService(cfg())
    assert cli.main(["serve", "--port", "0"]) == 2


def _start(argv, env):
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "listening on http://" in line:
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return proc, line.split("listening on ")[1].split()[0]
    proc.wait()
    raise AssertionError("".join(lines))


def test_serve_cli_drains_on_sigterm_and_resumes(tmp_path):
    """``serve --device cpu`` in a subprocess: POST, SIGTERM drains with
    exit 0 and a checkpoint; ``--resume`` brings the tenant back with
    its open window, and the flush after it emits the alone run's
    bytes."""
    state = str(tmp_path / "state")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "serve",
            "--port", "0", "--state-dir", state, "--fix", "2", "--watermark_s", "1",
            "--device", "cpu", "--no-continuous"]
    pay = hotel_payload(prefix="a")
    proc, base = _start(argv, env)
    try:
        code, out, _ = http("POST", base + "/api/v1/tenants/ten/spans", pay,
                            headers={"X-TW-Seq": "1"})
        assert code == 200 and out["ingested_traces"] == 24 and out["seq"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    assert os.path.isfile(os.path.join(state, "ten", "ckpt.pkl"))
    proc, base = _start(argv + ["--resume"], env)
    try:
        code, out, _ = http("POST", base + "/api/v1/tenants/ten/spans", pay,
                            headers={"X-TW-Seq": "1"})
        assert code == 200 and out.get("deduped") is True
        code, out, _ = http("POST", base + "/api/v1/flush")
        assert code == 200 and out["solved_windows"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    want, _ = _alone(tmp_path, "ten", pay)
    assert _sink(state, "ten") == want


@pytest.mark.gpu
def test_serve_t0_first_two_windows_on_card(tmp_path):
    """Tenant ``t0`` of config ``serve-cg-4t``, its first two windows'
    worth of bodies, served on the card under a pump of one window (as
    the smoke's CPU rerun is: a pump of several cold windows meets
    exact-mass ties that flip whole windows, ROADMAP C.3): K1 and the
    assembly kernel launch, the rings take the columns with no host
    fallback, and the sink equals the CPU run's on >= 99% of every
    service's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ops import cuda_sinkhorn, scores

    (d,) = synthesize_corpus(str(tmp_path / "cg"), n_graphs=1, traces_per_graph=2048,
                             seed=10, base_gap_ms=20)
    bodies = CS.serve_bodies(d)[:7]   # 36 s of event time: two windows and a part
    truth = CS.serve_truth(d)
    cuda_sinkhorn.reset_launches()
    scores.reset_launches()
    card_path, card_st, _, _ = CS.serve_alone(bodies, str(tmp_path / "card"), "cuda",
                                              pump_windows=1)
    assert cuda_sinkhorn.LAUNCHES["fused_assign"] > 0
    assert scores.LAUNCHES["assemble_block"] > 0
    assert not card_st["fleet"].get("devcols_fallbacks")
    assert card_st["fleet"]["h2d_bytes_ring"] > 0
    cpu_path, _, _, _ = CS.serve_alone(bodies, str(tmp_path / "cpu"), "cpu", pump_windows=1)
    rows = CS.rows_agreement(CS.serve_sink_accuracy(card_path, truth),
                             CS.serve_sink_accuracy(cpu_path, truth))
    assert rows and min(rows.values()) >= 0.99, rows
