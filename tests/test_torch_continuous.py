"""Continuous admission and the in-flight ticket ring of the port
(``traceweaver_tpu_torch/serve/continuous.py``, ``serve/tenancy.py``)
against the JAX package's.

- admission units: ``ready``/``take``, an SLO-at-risk window jumps the
  queue, one size class a dispatch, round-robin fill, waiting below the
  fill target; on the same queues the port admits what the JAX package
  admits;
- continuous admission emits exactly what the fixed pump emits, and
  ``inflight=1`` and ``inflight=2`` emit the fixed pump's bytes;
- tickets consume in FIFO order when dispatched out of order; a
  checkpoint skips a tenant with a ticket outstanding; a drain cut with
  a ticket outstanding resumes byte-identical;
- a dead dispatcher degrades to the fixed pump, counted and evented.
"""

import json
import os
import threading
import time

import pytest

from traceweaver_tpu_torch.serve import ServeConfig, TenantService
from traceweaver_tpu_torch.serve.continuous import ContinuousDispatcher
from traceweaver_tpu_torch.stream.scheduler import MicroBatchScheduler
from traceweaver_tpu_torch.stream.window import WindowBuffer


def _trace(i, prefix, base_us):
    T = base_us + i * 10_000.0
    tid = f"{prefix}{i:04d}"

    def span(sid, start, dur, op, refs, pid, kind):
        return dict(traceID=tid, spanID=sid, startTime=start, duration=dur,
                    operationName=op,
                    references=[{"traceID": tid, "spanID": r} for r in refs],
                    processID=pid, tags=[{"key": "span.kind", "value": kind}])

    return dict(traceID=tid, spans=[
        span("root", T, 1500.0, "HTTP GET /hotels", [], "p1", "server"),
        span("c1", T + 200, 1100.0, "call-search", ["root"], "p1", "client"),
        span("s1", T + 300, 600.0, "search", ["c1"], "p2", "server"),
        span("c2", T + 400, 300.0, "call-geo", ["s1"], "p2", "client"),
        span("s2", T + 450, 200.0, "geo", ["c2"], "p3", "server"),
    ], processes=dict(p1={"serviceName": "frontend"}, p2={"serviceName": "search"},
                      p3={"serviceName": "geo"}))


def _cfg(**kw):
    base = dict(fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False)
    base.update(kw)
    return ServeConfig(**base)


def _feed(svc, n_tenants=3, chunks=3, traces=3):
    """Chunk k+1's event times move the watermark past chunk k, so earlier
    windows seal during ingest."""
    for chunk in range(chunks):
        for i in range(n_tenants):
            svc.ingest(f"t{i:02d}", {"data": [
                _trace(k, f"u{i}c{chunk}", base_us=(chunk + 1) * 200e6)
                for k in range(traces)]})


def _buf(k, n_spans, sealed_ago_s=0.0):
    buf = WindowBuffer(k, float(k), float(k) + 1.0)
    buf.spans = [None] * n_spans
    buf.sealed_wall = time.monotonic() - sealed_ago_s
    return buf


def test_scheduler_ready_and_take():
    sched = MicroBatchScheduler(lambda b: [None] * len(b), max_pending=2, spill_max=8)
    bufs = [_buf(k, 4) for k in range(5)]
    for b in bufs:
        sched.offer(b)
    assert sched.ready() == bufs
    assert sched.take([bufs[3], bufs[1]]) == [bufs[3], bufs[1]]
    assert sched.ready() == [bufs[0], bufs[2], bufs[4]]
    assert sched.take([bufs[1]]) == []


def _admission_service(n_tenants=3):
    svc = TenantService(_cfg(pump_windows=10**9), device="cpu")
    for i in range(n_tenants):
        svc.tenant(f"t{i:02d}")
    return svc


def _admit(svc, disp):
    with svc._lock:
        plan, wait = disp._admit()
    return plan, wait


def test_admission_urgent_jumps_queue():
    svc = _admission_service()
    disp = ContinuousDispatcher(svc, slo_ms=10_000.0, fill_target=4)
    for k in range(6):
        svc.tenant("t00").svc.scheduler.offer(_buf(k, 8))
    svc.tenant("t02").svc.scheduler.offer(_buf(99, 8, sealed_ago_s=60.0))
    plan, wait = _admit(svc, disp)
    assert plan is not None and wait == 0.0 and plan[0][0].id == "t02"
    assert disp.urgent_dispatches == 1


def test_admission_is_class_coherent_and_defers_outliers():
    svc = _admission_service()
    disp = ContinuousDispatcher(svc, slo_ms=60_000.0, fill_target=8)
    for k in range(8):
        svc.tenant("t00").svc.scheduler.offer(_buf(k, 7))
    svc.tenant("t01").svc.scheduler.offer(_buf(50, 1000))
    plan, _ = _admit(svc, disp)
    assert {disp._size_class(b) for _, bufs in plan for b in bufs} == {8}


def test_admission_fill_round_robins_tenants():
    svc = _admission_service(n_tenants=4)
    disp = ContinuousDispatcher(svc, slo_ms=60_000.0, fill_target=4)
    for k in range(16):
        svc.tenant("t00").svc.scheduler.offer(_buf(k, 8))
    for i in (1, 2, 3):
        svc.tenant(f"t{i:02d}").svc.scheduler.offer(_buf(100 + i, 8))
    plan, _ = _admit(svc, disp)
    per = {t.id: len(b) for t, b in plan}
    assert set(per) == {"t00", "t01", "t02", "t03"}
    assert per["t01"] == per["t02"] == per["t03"] == 1
    n = sum(per.values())
    assert 4 <= n <= 16 and n & (n - 1) == 0


def test_admission_waits_when_below_fill_and_no_urgency():
    svc = _admission_service()
    disp = ContinuousDispatcher(svc, slo_ms=60_000.0, fill_target=8)
    svc.tenant("t00").svc.scheduler.offer(_buf(0, 8))
    plan, wait = _admit(svc, disp)
    assert plan is None and 0.0 < wait <= 0.25


def test_admission_matches_jax_on_the_same_queues():
    """Seeded queues of mixed sizes, ages and tenants: the port and the
    JAX package admit the same windows in the same order."""
    import random

    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu.serve import ServeConfig as JCfg
    from traceweaver_tpu.serve import TenantService as JService
    from traceweaver_tpu.serve.continuous import ContinuousDispatcher as JDisp
    from traceweaver_tpu.stream.window import WindowBuffer as JBuf

    rng = random.Random(7)
    for trial in range(20):
        port = _admission_service(n_tenants=4)
        jsvc = JService(JCfg(fix=2, verbose=False, pump_windows=10**9))
        now = time.monotonic()
        for i in range(4):
            for k in range(rng.randint(0, 9)):
                n, age = rng.choice([5, 7, 9, 60, 130]), rng.choice([0.0, 0.5, 30.0])
                for svc, cls in ((port, WindowBuffer), (jsvc, JBuf)):
                    buf = cls(100 * i + k, float(k), float(k) + 1.0)
                    buf.spans = [None] * n
                    buf.sealed_wall = now - age
                    svc.tenant(f"t{i:02d}").svc.scheduler.offer(buf)
        fill = rng.choice([2, 4, 8])
        got, _ = _admit(port, ContinuousDispatcher(port, slo_ms=10_000.0, fill_target=fill))
        with jsvc._lock:
            want, _ = JDisp(jsvc, slo_ms=10_000.0, fill_target=fill)._admit()

        def keys(plan):
            return None if plan is None else [(t.id, [b.k for b in bufs])
                                              for t, bufs in plan]

        assert keys(got) == keys(want), trial


def _totals(svc):
    return {tid: (t["emitted_windows"], t["spans_emitted"], t["traces_emitted"])
            for tid, t in svc.stats()["tenants"].items()}


def _quiesce(svc, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while (svc.total_backlog() or svc.in_flight_windows()) and time.time() < deadline:
        time.sleep(0.02)


def _sink_bytes(state_dir):
    out = {}
    for ten in sorted(os.listdir(state_dir)):
        p = os.path.join(state_dir, ten, "traces.jsonl")
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[ten] = f.read()
    return out


def test_continuous_and_both_ring_depths_emit_the_pumps_bytes(tmp_path):
    """Continuous admission emits what the fixed pump emits, and its
    sinks are the pump's bytes with one ticket in flight and with two
    (FIFO consume keeps each tenant's emission order)."""
    def run(tag, **kw):
        d = str(tmp_path / tag)
        svc = TenantService(_cfg(state_dir=d, pump_windows=4, **kw), device="cpu")
        _feed(svc, n_tenants=2, chunks=3, traces=3)
        svc.flush()
        _quiesce(svc)
        st, totals = svc.stats(), _totals(svc)
        svc.drain()
        return _sink_bytes(d), st, totals

    pump, _, pump_totals = run("pump")
    serial, ser_st, ser_totals = run("serial", continuous=True, slo_p99_ms=30_000.0,
                                     inflight=1)
    ring, ring_st, ring_totals = run("ring", continuous=True, slo_p99_ms=30_000.0,
                                     inflight=2)
    assert pump and serial == pump and ring == pump
    assert ser_totals == pump_totals == ring_totals
    assert ser_st["ring"]["enabled"] is False and ser_st["ring"]["inflight_limit"] == 1
    assert ring_st["ring"]["enabled"] is True
    assert ring_st["ring"]["submitted"] == ring_st["ring"]["completed"] > 0
    assert ring_st["ring"]["outstanding"] == ring_st["ring"]["aborted"] == 0


def test_lone_window_dispatches_without_flush():
    svc = TenantService(_cfg(continuous=True, slo_p99_ms=500.0, pump_windows=64),
                        device="cpu")
    svc.ingest("t00", {"data": [_trace(k, "a", base_us=200e6) for k in range(3)]})
    svc.ingest("t00", {"data": [_trace(k, "b", base_us=400e6) for k in range(3)]})
    deadline = time.time() + 30
    while time.time() < deadline and \
            svc.stats()["tenants"]["t00"]["emitted_windows"] < 1:
        time.sleep(0.05)
    st = svc.stats()
    svc.drain()
    assert st["tenants"]["t00"]["emitted_windows"] >= 1
    assert st["continuous"]["dispatches"] >= 1


def _manual_service(tmp_path, tag):
    svc = TenantService(_cfg(state_dir=str(tmp_path / tag), pump_windows=10**9),
                        device="cpu")
    _feed(svc, n_tenants=1, chunks=3, traces=3)
    return svc


def _ready_halves(svc, tid="t00"):
    with svc._lock:
        t = svc.tenants[tid]
        ready = list(t.svc.scheduler.ready())
    assert len(ready) >= 2
    half = len(ready) // 2
    return t, [ready[:half], ready[half:]]


def test_ticket_fifo_consume_and_out_of_order_dispatch(tmp_path):
    serial = _manual_service(tmp_path, "serial")
    t, plans = _ready_halves(serial)
    for p in plans:
        assert serial.solve_admitted([(t, p)]) >= 1
    serial.drain()

    over = _manual_service(tmp_path, "overlap")
    t, plans = _ready_halves(over)
    tk1 = over.submit_admitted([(t, plans[0])])
    tk2 = over.submit_admitted([(t, plans[1])])
    assert len(t.in_flight) == len(plans[0]) + len(plans[1])
    over._ring_dispatch(tk2)
    over._ring_dispatch(tk1)
    done = []
    th = threading.Thread(target=lambda: done.append(over.complete_ticket(tk2)),
                          daemon=True)
    th.start()
    time.sleep(0.25)
    assert th.is_alive(), "ticket 2 consumed before ticket 1"
    assert over.complete_ticket(tk1) >= 1
    th.join(timeout=30)
    assert done and done[0] >= 1 and not t.in_flight
    st = over.stats()["ring"]
    assert st["outstanding"] == 0 and st["submitted"] == st["completed"] == 2
    over.drain()
    assert _sink_bytes(str(tmp_path / "overlap")) == _sink_bytes(str(tmp_path / "serial"))


def test_checkpoint_skips_tenant_with_outstanding_ticket(tmp_path):
    svc = _manual_service(tmp_path, "ckpt")
    t, plans = _ready_halves(svc)
    tk = svc.submit_admitted([(t, plans[0] + plans[1])])
    out = svc.checkpoint_all(timeout_s=0.3)
    assert out["skipped"] >= 1 and out["checkpointed"] == 0
    svc._ring_dispatch(tk)
    assert svc.complete_ticket(tk) >= 1
    out = svc.checkpoint_all(timeout_s=10.0)
    assert out["checkpointed"] == 1 and out["skipped"] == 0
    svc.drain()


def test_drain_with_ticket_outstanding_resumes_byte_identical(tmp_path):
    ref = _manual_service(tmp_path, "ref")
    ref.flush()
    ref.drain()
    svc = _manual_service(tmp_path, "cut")
    t, plans = _ready_halves(svc)
    tk = svc.submit_admitted([(t, plans[0] + plans[1])])

    def finish():
        time.sleep(0.3)
        svc._ring_dispatch(tk)
        svc.complete_ticket(tk)

    th = threading.Thread(target=finish, daemon=True)
    th.start()
    t0 = time.monotonic()
    out = svc.drain()
    th.join(timeout=30)
    assert time.monotonic() - t0 >= 0.25
    assert out["checkpointed"] == 1 and out["skipped"] == 0
    resumed = TenantService.resume(_cfg(state_dir=str(tmp_path / "cut"),
                                        pump_windows=10**9), device="cpu")
    resumed.flush()
    resumed.drain()
    assert _sink_bytes(str(tmp_path / "cut")) == _sink_bytes(str(tmp_path / "ref"))


@pytest.mark.parametrize("inflight", [1, 2])
def test_dispatcher_crash_degrades_to_fixed_pump(tmp_path, inflight):
    from traceweaver_tpu_torch.obs import events as obs_events
    from traceweaver_tpu_torch.obs.registry import get_registry

    log = obs_events.EventLog(str(tmp_path / "events.jsonl"))
    prev = obs_events.install(log)
    svc = TenantService(_cfg(continuous=True, slo_p99_ms=50.0, pump_windows=1,
                             inflight=inflight), device="cpu")
    real_solve, real_submit = svc.solve_admitted, svc.submit_admitted

    def boom(plan):
        raise RuntimeError("boom: deliberate dispatcher crash")

    svc.solve_admitted = svc.submit_admitted = boom
    try:
        _feed(svc, n_tenants=2, chunks=2, traces=2)
        deadline = time.time() + 30
        while svc.dispatcher is not None and time.time() < deadline:
            svc.dispatcher.kick()
            time.sleep(0.02)
        assert svc.dispatcher is None, "dispatcher crash not contained"
        st = svc.stats()
        assert st["dispatcher_degraded"] is True
        assert st["dispatch"]["dispatcher_crashes"] == 1
        assert get_registry().snapshot().get("tw_serve_dispatcher_degraded") == 1.0
        svc.solve_admitted, svc.submit_admitted = real_solve, real_submit
        _feed(svc, n_tenants=2, chunks=2, traces=2)
        svc.flush()
        assert sum(t["emitted_windows"] for t in svc.stats()["tenants"].values()) > 0
    finally:
        obs_events.install(prev)
        svc.drain()
    recs = [json.loads(line) for line in open(log.path) if line.strip()]
    degraded = [r for r in recs if r["kind"] == "serve"
                and r["event"] == "dispatcher_degraded"]
    assert len(degraded) == 1 and "boom" in degraded[0]["error"]
