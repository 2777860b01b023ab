"""The port's observability base against the JAX package's (CPU).

- ``render_metrics`` text equals JAX's after the same counter, gauge and
  histogram updates, the series cap's overflow series included;
- ``EventLog`` records equal JAX's apart from the timestamp, and
  ``tail_main`` (the ``cli events`` subcommand) prints the same lines;
- a CPU ``solve_fleet`` with profiling enabled yields a
  ``torch.profiler`` trace holding a ``tw:fleet:*`` range on every host
  stage (the pack thread's and the flow workers' too) and a per-service
  solve the ``tw:solve:dispatch`` range; with profiling off there are none;
- the registry's ledger deltas equal the fleet's stats dict with the
  pipelined flow, and the fault ladder's counter and event records
  follow an injected dispatch fault;
- the exporter serves ``/metrics`` on loopback, and the CLI's
  ``--metrics_port`` / ``--events`` start and stop it;
- :func:`device_timeline` on hand-made intervals.

The ``gpu`` test takes the profiler trace of a fleet solve on the card
(run with ``--noconftest``: this module imports JAX only inside its CPU
tests).
"""

import json
import re
import urllib.request

import pytest
import torch

from traceweaver_tpu_torch.obs import events as t_events
from traceweaver_tpu_torch.obs import exposition as t_expo
from traceweaver_tpu_torch.obs import profile as t_profile
from traceweaver_tpu_torch.obs import registry as t_reg

torch.set_num_threads(1)
gpu = pytest.mark.gpu


def _updates(reg):
    c = reg.counter("tw_test_total", "a counter", labels=("key",))
    g = reg.gauge("tw_test_gauge", "a gauge\nover two lines", labels=("key",))
    h = reg.histogram("tw_test_seconds", "a histogram", labels=("stage",),
                      buckets=(0.01, 0.5, 2.0))
    plain = reg.counter("tw_plain_total")
    for i in range(5):
        c.inc(1.5 * i, key=f"k{i % 3}")
        g.set_max(float(i * i % 7), key="depth")
        h.observe(0.004 * (i + 1) ** 3, stage="dispatch" if i % 2 else 'say "x"')
    g.set(3.25, key="x\\y")
    plain.inc(2)
    reg.counter("tw_empty_total", "declared, never moved", labels=("key",))


def test_render_metrics_equals_jax():
    from traceweaver_tpu.obs import exposition as j_expo
    from traceweaver_tpu.obs import registry as j_reg

    jr, tr = j_reg.MetricsRegistry(), t_reg.MetricsRegistry()
    _updates(jr)
    _updates(tr)
    text = t_expo.render_metrics(tr)
    assert text == j_expo.render_metrics(jr)
    assert 'tw_test_total{key="k1"} 7.5' in text
    assert tr.snapshot() == jr.snapshot()


def test_series_cap_overflow_equals_jax(monkeypatch):
    from traceweaver_tpu.obs import exposition as j_expo
    from traceweaver_tpu.obs import registry as j_reg

    monkeypatch.setenv("TW_METRICS_MAX_SERIES", "2")
    jr, tr = j_reg.MetricsRegistry(), t_reg.MetricsRegistry(max_series=2)
    for reg in (jr, tr):
        c = reg.counter("tw_many_total", labels=("tenant",))
        for t in range(5):
            c.inc(t + 1, tenant=f"t{t}")
    assert t_expo.render_metrics(tr) == j_expo.render_metrics(jr)
    assert 'tw_many_total{overflow="1"} 12' in t_expo.render_metrics(tr)
    with pytest.raises(t_reg.MetricError):
        tr.gauge("tw_many_total", labels=("tenant",))
    with pytest.raises(t_reg.MetricError):
        tr.counter("tw_many_total", labels=("tenant",)).inc(-1, tenant="t0")


def _strip_ts(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


def _emit_all(mod, path):
    log = mod.EventLog(str(path))
    prev = mod.install(log)
    try:
        mod.emit("fault_injected", "dispatch", n=1, seed=7)
        mod.emit("fault_ladder", "retry")
        mod.emit("fault_ladder", "quarantine", service=("a", 2))
    finally:
        mod.install(prev)
        log.close()
    return log


def test_event_log_records_equal_jax(tmp_path):
    from traceweaver_tpu.obs import events as j_events

    jl = _emit_all(j_events, tmp_path / "j.jsonl")
    tl = _emit_all(t_events, tmp_path / "t.jsonl")
    assert _strip_ts(tmp_path / "t.jsonl") == _strip_ts(tmp_path / "j.jsonl")
    assert (tl.records, tl.offset > 0) == (jl.records, True)
    t_events.emit("fault_ladder", "retry")  # nothing installed: a no-op
    assert t_events.active() is None


def test_tail_prints_the_same_lines(tmp_path, capsys):
    from traceweaver_tpu.obs import events as j_events

    path = tmp_path / "e.jsonl"
    log = t_events.EventLog(str(path))
    for i, (kind, event) in enumerate([("fault_injected", "dispatch"),
                                       ("fault_ladder", "retry"),
                                       ("fault_ladder", "host")]):
        log.emit(kind, event, ts=1754300000.0 + i, n=i)
    log.close()
    with open(path, "a") as f:
        f.write("not json\n\n")
    for argv in ([str(path)], [str(path), "-n", "2"],
                 [str(path), "--kind", "fault_ladder"]):
        assert j_events.tail_main(argv) == 0
        want = capsys.readouterr().out
        assert t_events.tail_main(argv) == 0
        assert capsys.readouterr().out == want
    assert "fault_ladder/retry" in want or "fault_ladder" in want
    assert t_events.tail_main([str(tmp_path / "absent")]) == 2


# ---------------------------------------------------------------------------
# the fleet's hooks
# ---------------------------------------------------------------------------

def _fleet_items(n=48):
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem
    from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc

    probs = synth_fleet_8svc(n)
    return [FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                      p["dag"]) for p in probs[3:6]]


def _ledger(snapshot, family="tw_fleet_ledger_total"):
    pat = re.compile(r'^%s\{key="([^"]+)"\}$' % family)
    return {m.group(1): v for k, v in snapshot.items() if (m := pat.match(k))}


def _ladder(snapshot):
    pat = re.compile(r'^tw_fault_ladder_events_total\{key="([^"]+)",rung="([^"]+)"\}$')
    return {(m.group(1), m.group(2)): v for k, v in snapshot.items()
            if (m := pat.match(k))}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


def test_registry_ledger_deltas_equal_fleet_stats():
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

    reg = t_reg.get_registry()
    before = reg.snapshot()
    stats = {}
    solve_fleet(_fleet_items(), stats=stats, device="cpu", pipeline=True)
    after = reg.snapshot()
    # high-water marks mirror into the gauge, every other key into the
    # ledger counter
    gauges = _ledger(after, "tw_fleet_gauge")
    counted = {k: v for k, v in stats.items()
               if isinstance(v, float) and k not in gauges and v}
    assert _delta(_ledger(after), _ledger(before)) == pytest.approx(
        counted, rel=1e-9, abs=1e-12)
    assert stats["pipeline_groups"] >= 1 and counted["fleet_dispatches"] >= 1
    assert {"pipeline_depth", "fleet_group_cost_max"} <= set(gauges)
    assert all(gauges[k] >= stats[k] for k in gauges if k in stats)


def test_fault_ladder_reaches_registry_and_event_log(tmp_path, capsys):
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.runtime import cli
    from traceweaver_tpu_torch.runtime.faults import parse_faults

    reg = t_reg.get_registry()
    before = reg.snapshot()
    path = tmp_path / "events.jsonl"
    log = t_events.EventLog(str(path))
    t_events.install(log)
    stats = {}
    try:
        solve_fleet(_fleet_items(), stats=stats, device="cpu",
                    faults=parse_faults("dispatch:1.0:max=1", seed=3),
                    retry_backoff_s=0.0)
    finally:
        t_events.install(None)
        log.close()
    ladder = stats["fault_ladder"]
    assert ladder and stats["faults_injected"] == 1.0
    got = _delta(_ladder(reg.snapshot()), _ladder(before))
    want = {}
    for rung in ladder:
        want[("fault_ladder", rung)] = want.get(("fault_ladder", rung), 0) + 1
    assert got == want
    records = [json.loads(line) for line in open(path)]
    assert [(r["kind"], r["event"]) for r in records] == (
        [("fault_injected", "dispatch")] + [("fault_ladder", r) for r in ladder])
    assert cli.main(["events", str(path)]) == 0
    out = capsys.readouterr().out
    assert "fault_injected/dispatch" in out and "fault_ladder/retry" in out


def _range_names(prof):
    return {r[0] for r in t_profile.trace_intervals(prof)[1]}


def test_profiler_trace_holds_fleet_and_solve_ranges():
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k

    items = _fleet_items(24)
    prob = synth_async_8k(32)
    with t_profile.trace() as off:
        solve_fleet(items, device="cpu", pipeline=True)
    assert not _range_names(off)
    with t_profile.profiling(), t_profile.trace() as on:
        solve_fleet(items, device="cpu", pipeline=True)
        WeaverTorch({}, {}, device="cpu").FindAssignments(
            "MaxScoreBatchSubsetWithSkips", "svc", prob["in_parts"],
            prob["out_parts"], False, [], prob["truth"], prob["dag"])
    assert not t_profile.enabled()
    device, ranges = t_profile.trace_intervals(on)
    assert {"tw:fleet:dispatch", "tw:fleet:warm-dispatch", "tw:fleet:flag-fetch",
            "tw:fleet:plan", "tw:fleet:window-plan", "tw:fleet:group",
            "tw:fleet:pack", "tw:fleet:fetch", "tw:fleet:decode",
            "tw:solve:dispatch"} <= {r[0] for r in ranges}
    assert not device and all(lo <= hi for _, lo, hi in ranges)
    # the nested ranges sit inside their group's dispatch range, the flag
    # fetch's fetch inside the flag fetch
    outer = [r for r in ranges if r[0] == "tw:fleet:dispatch"]
    flag = [r for r in ranges if r[0] == "tw:fleet:flag-fetch"]
    for name, lo, hi in ranges:
        if name in ("tw:fleet:warm-dispatch", "tw:fleet:flag-fetch"):
            assert any(o[1] <= lo and hi <= o[2] for o in outer)
    assert all(any(r[0] == "tw:fleet:fetch" and f[1] <= r[1] and r[2] <= f[2]
                   for r in ranges) for f in flag)
    # the host stages before the first dispatch follow one another
    first = {name: min(r[1] for r in ranges if r[0] == name)
             for name in ("tw:fleet:plan", "tw:fleet:window-plan", "tw:fleet:group",
                          "tw:fleet:dispatch")}
    assert sorted(first, key=first.get) == list(first)


def test_device_timeline():
    kernels = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k3", 50.0, 55.0),
               ("k4", 95.0, 120.0)]
    ranges = [("tw:fleet:dispatch", 0.0, 60.0), ("tw:fleet:flag-fetch", 40.0, 45.0),
              ("tw:solve:dispatch", 70.0, 100.0)]
    r = t_profile.device_timeline(kernels, ranges, 0.0, 100.0, top=2)
    assert r["device_busy"] == 20.0 + 5.0 + 5.0
    assert r["idle_share"] == pytest.approx(0.7)
    assert [g["dur"] for g in r["longest_gaps"]] == [40.0, 20.0]
    # the innermost range open at the gap's midpoint
    assert [g["host_range"] for g in r["longest_gaps"]] == ["tw:solve:dispatch",
                                                           "tw:fleet:flag-fetch"]
    assert [o["name"] for o in r["longest_ops"]] == ["k4", "k2"]
    assert r["longest_gaps"][1]["start"] == 30.0
    with pytest.raises(ValueError):
        t_profile.device_timeline(kernels, ranges, 5.0, 5.0)


# ---------------------------------------------------------------------------
# exporter and CLI flags
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode()


def test_exporter_serves_metrics_on_loopback():
    reg = t_reg.MetricsRegistry()
    _updates(reg)
    exporter = t_expo.start_metrics_server(0, registry=reg)
    try:
        status, ctype, body = _get(f"http://127.0.0.1:{exporter.port}/metrics")
        assert status == 200 and ctype == t_expo.CONTENT_TYPE
        assert body == t_expo.render_metrics(reg)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{exporter.port}/other")
        assert e.value.code == 404
    finally:
        exporter.shutdown()
        exporter.server_close()


def test_cli_obs_flags_start_and_stop(tmp_path, monkeypatch):
    """``--metrics_port 0`` serves the process registry while the run
    lasts, and ``--events`` installs a sink for the run only."""
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.runtime import cli

    (d,) = synthesize_corpus(str(tmp_path / "c"), n_graphs=1, traces_per_graph=40,
                             seed=10)
    seen = {}
    real_finish = cli._obs_finish

    def finish(exporter, log):
        seen["active"] = t_events.active() is log
        seen["body"] = _get(f"http://127.0.0.1:{exporter.port}/metrics")[2]
        real_finish(exporter, log)
        seen["port"] = exporter.port

    monkeypatch.setattr(cli, "_obs_finish", finish)
    events = tmp_path / "run.jsonl"
    assert cli.main(["--absolute_path", d, "--fix", "5", "--cache_rate", "0",
                     "--execute_parallel", "0", "--predictor_indices", "4,10",
                     "--results_directory", str(tmp_path / "out"), "--device", "cpu",
                     "--metrics_port", "0", "--events", str(events)]) == 0
    assert seen["active"] and t_events.active() is None and events.exists()
    assert "tw_fleet_ledger_total" in seen["body"]
    assert "tw_fault_ladder_events_total" in seen["body"]
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{seen['port']}/metrics")


@gpu
def test_profiler_trace_on_card():
    """On the card the trace holds device kernels and the fleet ranges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

    items = _fleet_items()
    solve_fleet(items, device="cuda")
    with t_profile.profiling(), t_profile.trace() as prof:
        solve_fleet(items, device="cuda")
        torch.cuda.synchronize()
    device, ranges = t_profile.trace_intervals(prof)
    assert device and "tw:fleet:dispatch" in {r[0] for r in ranges}
    lo = min(r[1] for r in ranges)
    hi = max(r[2] for r in ranges)
    report = t_profile.device_timeline(device, ranges, lo, hi)
    assert 0.0 <= report["idle_share"] < 1.0
