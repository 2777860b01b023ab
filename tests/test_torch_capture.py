"""The port's capture ingress against the JAX package's
(``tests/test_capture.py``): the skew estimator with its clamp and
min-pairs gate, ``CollectorSource``'s span events (stub synthesis, churn
re-keying, both partial-capture policies, the orphan bound), the
``capture`` and ``skew`` fault sites under one seed, ``collector:`` specs
and ``iter_live``, the capture-quality discount of emitted confidence
through ``cli stream``, and the serve tier's ``/capture`` route with a
WAL replay of a ``capture`` record. The JAX package's knobs are set in
the environment for its side; the port's are arguments. CPU only."""

import json
import os
import sys
import threading
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from traceweaver_tpu_torch.collector.skew import SkewEstimator  # noqa: E402
from traceweaver_tpu_torch.collector.source import (  # noqa: E402
    CaptureCounters,
    CaptureIngest,
    CollectorSource,
    iter_live,
)
from traceweaver_tpu_torch.runtime import faults as t_faults  # noqa: E402
from traceweaver_tpu_torch.synth.capture import capture_workload  # noqa: E402

#: stream geometry of the JAX package's capture leg (bench.py run_capture_leg)
LEG_ARGS = ["--window_s", "0.2", "--overlap_s", "0.05", "--watermark_s", "0.02"]
#: capture-8k's (stream-cg-8k's) geometry
CG_ARGS = ["--window_s", "20", "--overlap_s", "4", "--watermark_s", "2"]


def _jax():
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.collector import source
    from traceweaver_tpu.runtime import faults

    faults.reset()
    return source, faults


def event_keys(src):
    """Every field of a source's span events, in order."""
    out = []
    for e in src.events():
        s = e.span
        out.append((s.trace_id, s.sid, float(s.start_mus), float(s.duration_mus),
                    s.op_name, [tuple(r) for r in s.references], s.process_id,
                    s.span_kind, e.event_us, e.arrival_us, e.capture_us,
                    dict(e.processes)))
    return out


def test_skew_estimator_equals_jax_with_clamp_and_gate():
    from traceweaver_tpu.collector.skew import SkewEstimator as JEst

    for min_pairs, max_us in ((3, 10e6), (3, 50_000.0), (7, 30e6)):
        t, j = SkewEstimator(min_pairs, max_us), JEst(min_pairs=min_pairs, max_us=max_us)
        for est in (t, j):
            for i in range(5):
                t0 = 1000.0 + i * 1e4
                est.observe_pair("a", "b", t0, t0 + 100_000 + 200,
                                 t0 + 100_000 + 1200, t0 + 1800)
                est.observe_pair("b", "c", t0, t0 - 40_000 + 150,
                                 t0 - 40_000 + 900, t0 + 1300)
            est.observe_pair("a", "b", 0, 9e6, 9e6, 10)
            est.register_source("lonely")
        assert t.ready() == j.ready() == (10 >= min_pairs or 11 >= min_pairs)
        assert t.fit() == j.fit()
        assert (t.clamped, t.fits, t.n_pairs, t.reference()) == (
            j.clamped, j.fits, j.n_pairs, j.reference())
        assert t.correct("c", 5.0) == j.correct("c", 5.0)
    # the clamp bit at 50 ms: b's fitted +100 ms is held to the bound
    assert SkewEstimator(3, 50_000.0).min_pairs == 3
    gate = SkewEstimator(min_pairs=4)
    gate.observe_pair("a", "b", 0, 10, 20, 30)
    assert not gate.ready() and gate.offset_us("b") == 0.0


@pytest.mark.parametrize("case", ["linked", "stub", "churn", "synthetic", "deadletter"])
def test_collector_source_events_equal_jax(case, monkeypatch):
    j_source, _ = _jax()
    opts = {}
    if case == "linked":
        logs = capture_workload(6, churn_at=3)
    elif case == "churn":
        logs = capture_workload(30, churn_at=11)
    elif case == "stub":
        logs = capture_workload(3, churn_at=99)
        del logs["search"]  # callee host not captured
    else:
        logs = capture_workload(6, churn_at=99)
        logs["search"] = "\n".join(logs["search"].splitlines()[:-3])
        monkeypatch.setenv("TW_COLLECTOR_PARTIAL", case)
        opts["partial_policy"] = case
    t_src, j_src = CollectorSource(logs, **opts), j_source.CollectorSource(logs)
    assert event_keys(t_src) == event_keys(j_src)
    assert t_src.capture_quality() == j_src.capture_quality()
    q = t_src.capture_quality()
    if case == "stub":
        assert any(e.span.process_id == "ext:search" for e in t_src.events())
    if case in ("linked", "churn"):
        assert q["rekeyed_streams"] == 1 and q["loss"] == {}
    if case == "synthetic":
        assert q["synthetic_spans"] >= 1 and "half_open_dropped" not in q["loss"]
    if case == "deadletter":
        assert q["synthetic_spans"] == 0 and q["loss"]["half_open_dropped"] >= 1


def _orphan_ingest(ingest_cls, counters, **kw):
    from traceweaver_tpu_torch.collector.hpack import Encoder
    from traceweaver_tpu_torch.collector.http2 import FLAG_END_HEADERS, PREFACE, SETTINGS

    def frame(ftype, flags, stream_id, payload):
        return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                + stream_id.to_bytes(4, "big") + payload)

    enc = Encoder()
    ing = ingest_cls("svc", counters, **kw)
    blob = PREFACE + frame(SETTINGS, 0, 0, b"")
    for sid in (1, 3, 5, 7, 9):
        blob += frame(0x1, FLAG_END_HEADERS, sid, enc.encode([
            (":method", "GET"), (":path", "/x"), (":authority", "y")]))
    ing._on_payload((4, 0), "in", blob, 1000.0)
    ing.finish()
    return counters.loss["svc"], [(r.sid, r.start_us, r.end_us, r.complete)
                                  for r in ing.records]


def test_orphan_bound_equals_jax(monkeypatch):
    j_source, _ = _jax()
    monkeypatch.setenv("TW_COLLECTOR_ORPHANS", "2")
    got = _orphan_ingest(CaptureIngest, CaptureCounters(), orphan_bound=2)
    want = _orphan_ingest(j_source.CaptureIngest, j_source.CaptureCounters())
    assert got == want
    assert got[0]["orphan_evicted"] == 3 and got[0]["half_open"] == 2


@pytest.mark.parametrize("spec,seed", [("skew:1.0:max=1", 1), ("capture:0.04", 1),
                                       ("capture:0.5,skew:1.0:max=1", 2)])
def test_capture_and_skew_fault_sites_equal_jax(spec, seed):
    j_source, j_faults = _jax()
    logs = capture_workload(40)
    with t_faults.override(spec, seed=seed) as plan:
        t_src = CollectorSource(logs)
    with j_faults.override(spec, seed=seed) as j_plan:
        j_src = j_source.CollectorSource(logs)
    j_faults.reset()
    assert plan.injected == {k: v for k, v in j_plan.injected.items() if k in plan.injected}
    assert event_keys(t_src) == event_keys(j_src)
    q = t_src.capture_quality()
    assert q == j_src.capture_quality()
    if spec == "skew:1.0:max=1":
        assert q["skew_us"]["search"] == -250050.0
    if spec == "capture:0.04":
        assert q["loss"] == {"dropped_chunk": 180, "half_open": 18}
        assert q["loss_rate"] == 0.3396


def test_fault_sites_are_legal_and_seeded():
    assert {"capture", "skew"} <= set(t_faults.SITES)
    plan = t_faults.parse_faults("capture:0.5,skew:1.0:max=1", seed=2)
    assert plan.should_fail("skew") and not plan.should_fail("skew")


def test_collector_specs_and_iter_live_equal_jax(tmp_path):
    j_source, _ = _jax()
    from traceweaver_tpu.stream.sources import parse_source_spec as j_spec

    from traceweaver_tpu_torch.stream.sources import parse_source_spec

    logs = capture_workload(5, churn_at=99)
    path = tmp_path / "frontend.log"
    path.write_text(logs["frontend"])
    d = tmp_path / "caps"
    d.mkdir()
    for name, text in logs.items():
        (d / f"{name}.log").write_text(text)
    for spec in (f"collector:{path}?service=frontend", f"collector:{path}",
                 f"collector:{d}"):
        got, want = parse_source_spec(spec), j_spec(spec)
        assert isinstance(got, CollectorSource)
        assert event_keys(got) == event_keys(want)
    assert sorted(parse_source_spec(f"collector:{d}")._ingests) == ["frontend", "search"]
    with pytest.raises(ValueError, match="no such file"):
        parse_source_spec("collector:/nowhere/missing.log")
    with pytest.raises(ValueError, match="collector:"):
        parse_source_spec("bogus:/nowhere")
    lines = logs["frontend"].splitlines()
    got = [(e.span.sid, e.arrival_us, e.event_us) for e in iter_live(iter(lines), "frontend")]
    want = [(e.span.sid, e.arrival_us, e.event_us)
            for e in j_source.iter_live(iter(lines), "frontend")]
    assert got == want and len(got) == 15


def test_live_fifo_source(tmp_path):
    """A FIFO spec is the live single-source mode: read once, no resume."""
    from traceweaver_tpu_torch.stream.sources import parse_source_spec

    fifo = tmp_path / "live.fifo"
    os.mkfifo(fifo)
    text = capture_workload(3, churn_at=99)["frontend"]
    writer = threading.Thread(target=lambda: fifo.write_text(text), daemon=True)
    writer.start()
    src = parse_source_spec(f"collector:{fifo}?service=frontend")
    assert len(list(src.events())) == 9
    writer.join(5)
    with pytest.raises(ValueError, match="fast-forward"):
        next(src.events(skip=1))


def _cli_stream(tmp_path, name, logs, extra=(), geometry=LEG_ARGS):
    from traceweaver_tpu_torch.runtime import cli

    d = tmp_path / f"{name}-logs"
    d.mkdir()
    for src, text in logs.items():
        (d / f"{src}.log").write_text(text)
    sink = tmp_path / f"{name}.jsonl"
    events = tmp_path / f"{name}.events.jsonl"
    rc = cli.main(["stream", "--source", f"collector:{d}", *geometry,
                   "--checkpoint_every", "10000", "--device", "cpu",
                   "--out", str(sink), "--events", str(events), *extra])
    assert rc == 0
    return ([json.loads(x) for x in sink.read_text().splitlines()],
            [json.loads(x) for x in events.read_text().splitlines()])


def _jax_leg(logs, spec, windows):
    """The JAX package's stream on the same capture (bench.py's leg)."""
    import tempfile

    j_source, j_faults = _jax()
    from traceweaver_tpu.stream.service import StreamConfig, StreamingReconstructor, TraceSink

    if spec:
        with j_faults.override(spec, seed=1):
            src = j_source.CollectorSource(logs)
    else:
        src = j_source.CollectorSource(logs)
    j_faults.reset()
    with tempfile.TemporaryDirectory() as tmp:
        sink = os.path.join(tmp, "out.jsonl")
        summary = StreamingReconstructor(src, StreamConfig(
            checkpoint_every=10_000, verbose=False, **windows),
            sink=TraceSink(sink)).run()
        with open(sink) as f:
            recs = [json.loads(x) for x in f]
    return summary, recs


@pytest.mark.parametrize("geometry", ["leg", "capture-8k"])
@pytest.mark.parametrize("spec", [None, "skew:1.0:max=1", "capture:0.04"])
def test_cli_stream_collector_legs_equal_jax(tmp_path, capsys, spec, geometry):
    """``cli stream --source collector:`` at 40 traces, clean, skewed and
    lossy: the port's sink records (assignments, traces, the discounted
    confidences and their capture block) equal the JAX package's stream,
    and so do the accuracy, the detected skew and the loss counters."""
    args, windows = ((LEG_ARGS, dict(window_us=0.2e6, overlap_us=0.05e6,
                                     ooo_bound_us=0.02e6))
                     if geometry == "leg" else
                     (CG_ARGS, dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6)))
    logs = capture_workload(40)
    extra = ["--faults", spec, "--faults_seed", "1"] if spec else []
    recs, events = _cli_stream(tmp_path, "leg", logs, extra, args)
    printed = capsys.readouterr().out
    summary, want = _jax_leg(logs, spec, windows)
    assert recs == want
    acc = float(printed.split("streamed end-to-end accuracy: ")[1].split("%")[0])
    assert acc == pytest.approx(summary["accuracy"]["e2e"], abs=1e-3)
    cap = summary["capture"]
    assert "[stream] capture: %d spans delivered" % cap["delivered_spans"] in printed
    kinds = {e["kind"] for e in events}
    assert {"capture_churn", "clock_skew"} <= kinds
    if spec == "capture:0.04":
        assert "capture_loss" in kinds
        discounts = {r["tw.confidence"]["capture"]["discount"] for r in recs
                     if r.get("tw.confidence")}
        assert discounts == {round(1 - cap["loss_rate"], 4)}
        assert "loss rate 33.96%" in printed
    if spec == "skew:1.0:max=1":
        assert "'search': '-250050us'" in printed


def test_confidence_discount_leaves_the_drift_watcher_raw(tmp_path):
    """The payload's confidences fall with the loss rate; the drift
    watcher reads the solver's own records, so capture loss cannot walk
    the adaptation ladder."""
    from traceweaver_tpu_torch.stream import StreamConfig, StreamingReconstructor, TraceSink

    logs = capture_workload(6, churn_at=99)
    logs["search"] = "\n".join(logs["search"].splitlines()[:-3])
    src = CollectorSource(logs)
    rate = src.capture_quality()["loss_rate"]
    assert rate > 0
    seen = []
    svc = StreamingReconstructor(
        src, StreamConfig(window_us=0.2e6, overlap_us=0.05e6, ooo_bound_us=0.02e6,
                          verbose=False, checkpoint_every=10_000),
        sink=TraceSink(str(tmp_path / "out.jsonl")), device="cpu")
    real = svc.drift.update
    svc.drift.update = lambda key, vals: seen.extend(vals) or real(key, vals)
    summary = svc.run()
    assert summary["capture"]["loss_rate"] == rate
    recs = [json.loads(x) for x in (tmp_path / "out.jsonl").read_text().splitlines()]
    confs = [t["conf"] for r in recs for t in r["tw.confidence"]["traces"].values() if t]
    assert confs and max(confs) <= round(1 - rate, 4) + 1e-9
    assert max(seen) > max(confs)


# ---------------------------------------------------------------------------
# the serve tier's /capture route
# ---------------------------------------------------------------------------

def _serve(tmp_path, name, **kw):
    from traceweaver_tpu_torch.serve import ServeConfig, TenantService, make_server

    svc = TenantService(ServeConfig(
        window_us=0.2e6, overlap_us=0.05e6, ooo_bound_us=0.02e6, verbose=False,
        pump_windows=10 ** 9, state_dir=str(tmp_path / name), **kw), device="cpu")
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return svc, server, f"http://127.0.0.1:{server.port}"


def _call(base, method, path, data=None, ctype="application/json"):
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_serve_capture_route_roundtrip_and_wal_replay(tmp_path):
    """The bundle and text forms of ``POST .../capture`` (the JAX
    package's test), then a kill before any checkpoint: the recovered
    tenant replays the ``capture`` record from its WAL, with no replay
    error, into the same sink bytes as the uninterrupted server."""
    from traceweaver_tpu_torch.serve import ServeConfig, TenantService

    logs = capture_workload(6, churn_at=3)
    bundle = json.dumps({"sources": logs}).encode()
    svc, server, base = _serve(tmp_path, "a")
    try:
        out = _call(base, "POST", "/api/v1/tenants/cap/capture", bundle)
        assert out["ingested_spans"] == 18 and out["rekeyed_streams"] == 1
        assert _call(base, "POST", "/api/v1/tenants/cap/flush")["solved_windows"] >= 1
        traces = _call(base, "GET", "/api/v1/tenants/cap/traces")
        assert traces["n_traces"] == 6
        rec = _call(base, "GET", f"/api/v1/tenants/cap/traces/{traces['trace_ids'][0]}")
        assert rec["n_spans"] == 3
        out2 = _call(base, "POST", "/api/v1/tenants/cap2/capture?source=frontend",
                     logs["frontend"].encode(), ctype="text/plain")
        assert out2["ingested_spans"] == 18
        stats = _call(base, "GET", "/api/v1/tenants/cap/stats")
        assert stats["counters"]["capture_posts"] == 1
        assert stats["counters"]["wal_appends"] == 1
    finally:
        server.shutdown()
        server.server_close()
    svc.drain()
    want = (tmp_path / "a" / "cap" / "traces.jsonl").read_bytes()

    # killed after the ack: the WAL holds the capture, no checkpoint exists
    svc_b, server_b, base_b = _serve(tmp_path, "b")
    try:
        _call(base_b, "POST", "/api/v1/tenants/cap/capture", bundle)
    finally:
        server_b.shutdown()
        server_b.server_close()
    for t in svc_b.tenants.values():
        t.close()
    resumed = TenantService.resume(ServeConfig(
        window_us=0.2e6, overlap_us=0.05e6, ooo_bound_us=0.02e6, verbose=False,
        pump_windows=10 ** 9, state_dir=str(tmp_path / "b")), device="cpu")
    t = resumed.tenants["cap"]
    assert t.counters.get("wal_replayed") == 1
    assert not t.counters.get("wal_replay_errors")
    resumed.flush("cap")
    resumed.drain()
    assert (tmp_path / "b" / "cap" / "traces.jsonl").read_bytes() == want


def test_serve_capture_equals_jax_tenant(tmp_path):
    """One bundle through the port's and the JAX package's tenants: the
    same ingest summary and the same sink records."""
    import traceweaver_tpu.runtime.executor  # noqa: F401
    from traceweaver_tpu.serve import ServeConfig as JCfg
    from traceweaver_tpu.serve import TenantService as JService

    from traceweaver_tpu_torch.serve import ServeConfig, TenantService

    logs = capture_workload(20, churn_at=7)
    geo = dict(window_us=0.2e6, overlap_us=0.05e6, ooo_bound_us=0.02e6, verbose=False,
               pump_windows=10 ** 9)
    t_svc = TenantService(ServeConfig(state_dir=str(tmp_path / "t"), **geo), device="cpu")
    j_svc = JService(JCfg(state_dir=str(tmp_path / "j"), **geo))
    got = t_svc.ingest_capture("cap", logs)
    want = j_svc.ingest_capture("cap", logs)
    assert got == want
    t_svc.flush("cap")
    j_svc.flush("cap")
    t_svc.drain()
    j_svc.drain()

    def recs(root):
        return [json.loads(x) for x in (root / "cap" / "traces.jsonl").read_text().splitlines()]

    assert recs(tmp_path / "t") == recs(tmp_path / "j")


@pytest.mark.gpu
def test_capture_stream_on_card(tmp_path):
    """The capture workload's 40-trace logs through ``cli stream --source
    collector:`` on the card: K1 and the assembly kernel launch, and the
    sink records equal the CPU run's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.runtime import cli

    d = tmp_path / "logs"
    d.mkdir()
    for src, text in capture_workload(40).items():
        (d / f"{src}.log").write_text(text)
    sinks = {}
    for device in ("cuda", "cpu"):
        sinks[device] = tmp_path / f"{device}.jsonl"
        assert cli.main(["stream", "--source", f"collector:{d}", *CG_ARGS,
                         "--device", device, "--out", str(sinks[device])]) == 0
    assert sinks["cuda"].read_bytes() == sinks["cpu"].read_bytes()
