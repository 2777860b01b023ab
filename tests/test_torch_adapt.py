"""The port's drift-to-adapt ladder against the JAX package's
(``tests/test_adapt.py``): the controller's transitions on the same
``observe`` sequences and its state round trip, every actuation evented
and counted, adaptation off leaving the stream's sink as it was,
``adapt-burst-60``'s recovery story with per-window accuracies equal to
JAX's through ``cli stream --adapt``, a kill during probation and a resume
with no duplicate refit and no lost fallback, and the serve tier's
``run_adaptations``. The JAX package's ``TW_ADAPT`` knobs are set in the
environment for its side. CPU only."""

import json
import os
import random
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from traceweaver_tpu_torch.adapt import AdaptationController  # noqa: E402
from traceweaver_tpu_torch.obs import events as obs_events  # noqa: E402
from traceweaver_tpu_torch.synth.capture import (  # noqa: E402
    adapt_burst_events,
    adapt_window_accuracies,
)

BASE = dict(psi_threshold=0.25, low_rate=0.5, probation=2, cooldown_s=1000.0)
ADAPT_ARGS = ["--window_s", "1", "--overlap_s", "0", "--watermark_s", "0.001",
              "--conf_drift_window", "64", "--checkpoint_every", "10000"]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _jax_ctrl_cls():
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.adapt import AdaptationController as J

    return J


def _script(kind):
    """An ``observe``/``begin_refit``/``refit_done``/clock script."""
    if kind == "recovery":
        return [("obs", "k", 0.6, 0.0), ("obs", "k", 0.6, 0.0), ("begin", "k"),
                ("begin", "k"), ("done", "k", True), ("obs", "k", 0.6, None),
                ("obs", "k", 0.05, None), ("obs", "k", 0.9, None), ("tick", 2000.0),
                ("obs", "k", 0.9, None)]
    if kind == "fallback":
        return [("obs", "k", 0.6, None), ("begin", "k"), ("done", "k", True),
                ("obs", "k", None, 0.9), ("obs", "k", None, 0.9),
                ("obs", "k", 0.05, 0.0), ("obs", "k", 0.7, None)]
    if kind == "retry":
        return [("obs", "k", 0.6, None), ("begin", "k"), ("done", "k", False),
                ("obs", "k", 0.6, None), ("tick", 1001.0), ("obs", "k", 0.6, None),
                ("begin", "k"), ("done", "k", True), ("obs", "k", 0.1, 0.1)]
    rng = random.Random(int(kind))
    out = []
    for _ in range(200):
        key = rng.choice("ab")
        r = rng.random()
        if r < 0.55:
            out.append(("obs", key, rng.choice([None, 0.05, 0.3, 0.9]),
                        rng.choice([None, 0.0, 0.6])))
        elif r < 0.7:
            out.append(("begin", key))
        elif r < 0.85:
            out.append(("done", key, rng.random() < 0.7))
        else:
            out.append(("tick", rng.choice([10.0, 600.0, 1500.0])))
    return out


def _play(ctrl, clock, script):
    trail = []
    for step in script:
        if step[0] == "obs":
            trail.append(ctrl.observe(step[1], psi=step[2], low_rate=step[3]))
        elif step[0] == "begin":
            trail.append(ctrl.begin_refit(step[1]))
        elif step[0] == "done":
            ctrl.refit_done(step[1], ok=step[2])
            trail.append(ctrl.fallback_active(step[1]))
        else:
            clock.t += step[1]
        trail.append((ctrl.pending_refits(), ctrl.warm_dists(step[1] if step[0] != "tick"
                                                             else "k", {"e": 1})))
    return trail


@pytest.mark.parametrize("kind", ["recovery", "fallback", "retry", "1", "2", "3"])
def test_controller_transitions_equal_jax(kind):
    J = _jax_ctrl_cls()
    tc, jc = _Clock(), _Clock()
    t = AdaptationController(clock=tc, **BASE)
    j = J(clock=jc, **BASE)
    script = _script(kind)
    assert _play(t, tc, script) == _play(j, jc, script)
    assert t.summary() == j.summary()
    assert t.state() == j.state()
    if kind == "recovery":
        assert t.recoveries == 1 and t.refits_done == 1
        assert t.summary()["rungs"]["k"] == "refit_pending"
    if kind == "fallback":
        assert t.fallbacks == 1 and t.restores == 1


def test_controller_defaults_are_the_knobs():
    c = AdaptationController()
    assert (c.psi_threshold, c.low_rate, c.probation, c.cooldown_s) == (0.25, 0.5, 6, 60.0)


def test_controller_state_roundtrip_restamps_clocks():
    J = _jax_ctrl_cls()
    for cls in (AdaptationController, J):
        clock = _Clock()
        c = cls(clock=clock, **dict(BASE, cooldown_s=50.0))
        c.observe("a", psi=0.9)
        c.begin_refit("a")                   # refitting: saves as pending
        c.observe("b", psi=0.9)
        c.begin_refit("b")
        c.refit_done("b", ok=True)           # probation
        c.observe("f", psi=0.9)
        c.begin_refit("f")
        c.refit_done("f", ok=False)          # fallback, retry in 50 s
        clock.t += 20.0
        clock2 = _Clock()
        c2 = cls.from_state(c.state(), clock=clock2)
        assert c2.summary()["rungs"] == {"a": "refit_pending", "b": "probation",
                                         "f": "fallback"}
        assert c2.fallback_active("f") and not c2.fallback_active("b")
        assert c2.observe("f", psi=0.9) == "fallback"
        clock2.t += 31.0
        assert c2.observe("f", psi=0.9) == "refit_pending"
        assert c2.summary()["generations"] == {"b": 1}
    # the port's state loads into the JAX controller and back
    t = AdaptationController(**BASE)
    t.observe("x", psi=0.9)
    assert J.from_state(t.state()).summary() == \
        AdaptationController.from_state(t.state()).summary()


def test_every_actuation_is_evented_and_counted(tmp_path):
    from traceweaver_tpu_torch.obs.registry import get_registry

    log = obs_events.EventLog(str(tmp_path / "events.jsonl"))
    prev = obs_events.install(log)
    invalidated = []
    try:
        c = AdaptationController(**dict(BASE, probation=1))
        c.invalidate_cb = invalidated.append
        c.observe("svcA", psi=0.9)
        c.begin_refit("svcA")
        c.refit_done("svcA", ok=True)
        c.observe("svcA", low_rate=1.0)            # probation expiry: fallback
        c.observe("svcA", psi=0.0, low_rate=0.0)   # restore
    finally:
        obs_events.install(prev)
        log.close()
    recs = [json.loads(line) for line in open(log.path) if line.strip()]
    assert [r["event"] for r in recs if r["kind"] == "adapt"] == [
        "refit", "refit_done", "fallback", "restore"]
    assert invalidated == ["svcA", "svcA"]  # the refit and the fallback
    fam = {tuple(sorted(labels.items())): v for labels, v in
           get_registry().counter("tw_adapt_actions_total", labels=("service", "rung"))
           .samples()}
    for rung in ("refit", "refit_done", "fallback", "restore"):
        assert fam.get((("rung", rung), ("service", "svcA")), 0) >= 1
    assert "adapt" in obs_events.KNOWN_KINDS


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def _port_stream(events, adapt=None, sink=None, ckpt=None, drift_window=64):
    from traceweaver_tpu_torch.stream import (
        IterableSource,
        StreamConfig,
        StreamingReconstructor,
        TraceSink,
    )

    cfg = StreamConfig(window_us=1e6, overlap_us=0.0, ooo_bound_us=1e3,
                       checkpoint_path=ckpt, checkpoint_every=10_000, verbose=False)
    return StreamingReconstructor(IterableSource(events), cfg,
                                  sink=TraceSink(sink) if sink else None, device="cpu",
                                  adapt=adapt, drift_window=drift_window)


def _jax_stream(monkeypatch, events, adapt_on, sink):
    import traceweaver_tpu.runtime.executor  # noqa: F401
    from traceweaver_tpu.stream.service import StreamConfig, StreamingReconstructor, TraceSink
    from traceweaver_tpu.stream.sources import IterableSource

    monkeypatch.setenv("TW_ADAPT", "1" if adapt_on else "0")
    monkeypatch.setenv("TW_CONF_DRIFT_WINDOW", "64")
    monkeypatch.setenv("TW_RETRY_BACKOFF_S", "0")
    svc = StreamingReconstructor(IterableSource(events), StreamConfig(
        window_us=1e6, overlap_us=0.0, ooo_bound_us=1e3, checkpoint_every=10_000,
        verbose=False), sink=TraceSink(sink))
    return svc, svc.run()


@pytest.mark.parametrize("adapt_on", [False, True])
def test_adapt_burst_60_story_through_cli_equals_jax(tmp_path, capsys, monkeypatch, adapt_on):
    """``adapt-burst-60`` (JAX's recorded leg) through ``cli stream``: the
    port's per-window accuracies and sink records equal the JAX package's
    stream on the same corpus, with and without ``--adapt``; with it the
    drift alert fires, a refit lands, the tail returns to the pre-shift
    accuracy and the gauge re-arms, and without it the tail stays
    degraded."""
    from traceweaver_tpu_torch.runtime import cli

    sink = tmp_path / "port.jsonl"
    rc = cli.main(["stream", "--source", "synth:adapt-burst?n_bursts=60&shift_at=30",
                   *ADAPT_ARGS, "--device", "cpu", "--out", str(sink)]
                  + (["--adapt"] if adapt_on else []))
    assert rc == 0
    printed = capsys.readouterr().out
    events, n_req = adapt_burst_events(60, 30)
    jsink = tmp_path / "jax.jsonl"
    jsvc, jsum = _jax_stream(monkeypatch, events, adapt_on, str(jsink))
    got = [json.loads(x) for x in sink.read_text().splitlines()]
    want = [json.loads(x) for x in jsink.read_text().splitlines()]
    assert got == want
    accs = adapt_window_accuracies(sink.read_text().splitlines(), n_req)
    assert accs == adapt_window_accuracies(jsink.read_text().splitlines(), n_req)
    keys = sorted(accs)
    pre = sum(accs[k] for k in keys if k < 30) / 30
    tail = sum(accs[k] for k in keys[-10:]) / 10
    assert len(keys) == 60 and pre == 1.0
    if adapt_on:
        assert tail >= pre - 0.01
        assert "[stream] adapt: 1 refits scheduled, 1 landed" in printed
        assert "2 drift alerts" in printed
        assert jsum["adapt"]["refits_done"] == 1
        assert jsvc.drift.last_psi("frontend") <= 0.25
    else:
        assert tail == 0.0
        assert "[stream] adapt:" not in printed


def test_adaptation_off_leaves_the_checkpoint_and_old_checkpoints_resume(tmp_path):
    """Off (the default): no controller, a summary that says so, and a
    checkpoint whose ``adapt`` key is None; a checkpoint without the key
    (as written before adaptation came) resumes, with or without a
    controller."""
    from traceweaver_tpu_torch.stream import IterableSource, StreamingReconstructor
    from traceweaver_tpu_torch.stream.checkpoint import load_checkpoint, save_checkpoint

    events, _ = adapt_burst_events(12, 6)
    a = _port_stream(events, sink=str(tmp_path / "a.jsonl"), ckpt=str(tmp_path / "a.ck"))
    summary = a.run()
    a.sink.close()
    assert a.adapt is None and summary["adapt"] == {"enabled": False}
    state = load_checkpoint(str(tmp_path / "a.ck"))
    assert state["adapt"] is None
    del state["adapt"]
    state.pop("_recovered_from_prev", None)
    old = str(tmp_path / "old.ck")
    save_checkpoint(old, state)
    for ctrl in (None, AdaptationController(**BASE)):
        resumed = StreamingReconstructor.resume(old, IterableSource(events), device="cpu",
                                                adapt=ctrl)
        assert resumed.consumed == a.consumed
        assert resumed.adapt is ctrl
        assert resumed.run()["emitted_windows"] == summary["emitted_windows"]
        resumed.sink.close()


def test_adaptation_off_sink_equals_jax_on_a_window_drift(tmp_path, monkeypatch):
    """With adaptation off the port's sink records equal the JAX
    package's with ``TW_ADAPT=0`` on a shifted corpus where the drift
    watcher alerts (the sensors run, nothing actuates)."""
    events, _ = adapt_burst_events(40, 20)
    svc = _port_stream(events, sink=str(tmp_path / "p.jsonl"))
    s = svc.run()
    svc.sink.close()
    _, js = _jax_stream(monkeypatch, events, False, str(tmp_path / "j.jsonl"))
    assert s["confidence"]["drift_alerts"] == js["confidence"]["drift_alerts"] >= 1
    assert (tmp_path / "p.jsonl").read_text().splitlines() == \
        (tmp_path / "j.jsonl").read_text().splitlines()


def test_refit_installs_fresh_statistics_out_of_band():
    events, _ = adapt_burst_events(8, shift_at=99)
    svc = _port_stream(events, adapt=AdaptationController())
    svc.run()
    assert "frontend" in svc.adapt_material
    before = svc.carried.get("frontend")
    assert before is not None
    svc.adapt.observe("frontend", psi=9.9, low_rate=1.0)
    assert svc.maybe_adapt() == 1
    assert svc.stats.get("adapt_refits") == 1
    after = svc.carried.get("frontend")
    assert after is not None and after is not before
    assert svc.adapt.summary()["rungs"]["frontend"] == "probation"
    assert svc.maybe_adapt() == 0


def test_kill_mid_probation_resume_no_duplicate_refit_no_lost_fallback(tmp_path):
    from traceweaver_tpu_torch.runtime import faults
    from traceweaver_tpu_torch.stream import IterableSource, StreamingReconstructor

    ckpt = str(tmp_path / "ckpt.pkl")
    events, _ = adapt_burst_events(8, shift_at=99)
    svc = _port_stream(events, adapt=AdaptationController(), ckpt=ckpt)
    svc.run()
    svc.adapt.observe("frontend", psi=9.9)
    assert svc.maybe_adapt() == 1                       # the refit lands
    assert svc.adapt.summary()["rungs"]["frontend"] == "probation"
    svc.adapt.observe("ghost", psi=9.9)
    svc.adapt.begin_refit("ghost")
    svc.adapt.refit_done("ghost", ok=False)             # fallback
    refits_before = svc.adapt.refits_done
    with faults.override("checkpoint:0.2", seed=3):
        for _ in range(6):   # some writes fail, counted; one lands
            svc._checkpoint()
    assert os.path.exists(ckpt)
    resumed = StreamingReconstructor.resume(ckpt, IterableSource(events), device="cpu",
                                            adapt=AdaptationController())
    rungs = resumed.adapt.summary()["rungs"]
    assert rungs["frontend"] == "probation"
    assert rungs["ghost"] == "fallback"
    assert resumed.adapt.fallback_active("ghost")
    assert resumed.adapt.warm_dists("ghost", {"e": 1}) == {}
    assert resumed.adapt.refits_done == refits_before
    assert resumed.adapt.pending_refits() == []
    assert resumed.maybe_adapt() == 0
    assert resumed.drift.state()["ref"].keys() == svc.drift.state()["ref"].keys()
    assert resumed.adapt.invalidate_cb == resumed._plan_invalidate


def test_kill_and_resume_mid_stream_equals_the_uninterrupted_sink(tmp_path):
    """``--adapt`` on ``adapt-burst-60``: stopped after the refit landed
    (in probation), resumed from its checkpoint in a new service, the
    sink is byte-identical to the uninterrupted run's."""
    from traceweaver_tpu_torch.stream import IterableSource, StreamingReconstructor

    events, _ = adapt_burst_events(60, 30)

    def cfg_svc(name, ckpt=None):
        svc = _port_stream(events, adapt=AdaptationController(),
                           sink=str(tmp_path / name), ckpt=ckpt)
        svc.cfg.checkpoint_every = 2
        return svc

    whole = cfg_svc("whole.jsonl")
    whole.run()
    whole.sink.close()
    ckpt = str(tmp_path / "k.ck")
    killed = cfg_svc("killed.jsonl", ckpt)
    killed.run(max_windows=47)
    assert killed.adapt.summary()["rungs"]["frontend"] in ("probation", "healthy")
    killed.sink.close()
    resumed = StreamingReconstructor.resume(ckpt, IterableSource(events), device="cpu",
                                            adapt=AdaptationController(),
                                            drift_window=64)
    resumed.run()
    resumed.sink.close()
    assert resumed.adapt.refits_done == whole.adapt.refits_done == 1
    assert (tmp_path / "killed.jsonl").read_bytes() == (tmp_path / "whole.jsonl").read_bytes()


def test_serve_run_adaptations_fills_the_tenant_stats(tmp_path):
    from traceweaver_tpu_torch.serve import ServeConfig, TenantService
    from traceweaver_tpu_torch.stream.sources import SpanEvent

    off = TenantService(ServeConfig(state_dir=str(tmp_path / "off")), device="cpu")
    t_off = off.tenant("t")
    assert off.stats("t")["adapt"] is None and off.stats("t")["adapt_refits"] == 0
    assert t_off.svc.adapt is None

    svc = TenantService(ServeConfig(
        window_us=1e6, overlap_us=0.0, ooo_bound_us=1e3, pump_windows=10 ** 9,
        state_dir=str(tmp_path / "on"), adapt=True, conf_drift_window=64,
        adapt_probation=3), device="cpu")
    t = svc.tenant("t")
    assert t.svc.adapt.probation == 3 and t.svc.drift.window == 64
    events, _ = adapt_burst_events(8, shift_at=99)
    for ev in events:
        t._ingest_event(SpanEvent(span=ev.span, event_us=ev.event_us,
                                  arrival_us=ev.arrival_us, trace_id=ev.trace_id,
                                  processes=ev.processes))
    svc.flush("t")
    assert svc.stats("t")["adapt_refits"] == 0
    t.svc.adapt.observe("t:frontend", psi=9.9, low_rate=1.0)
    assert svc.run_adaptations() == 1
    st = svc.stats("t")
    assert st["adapt_refits"] == 1
    assert st["adapt"]["refits_done"] == 1 and st["adapt"]["rungs"] == {"t:frontend": "probation"}
    assert svc.stats()["dispatch"]["adapt_refits"] == 1
    assert svc.run_adaptations() == 0
    svc.drain()
    off.drain()


def test_adapt_burst_events_equal_bench_generator():
    import bench

    for args, kw in (((60, 30), {}), ((4, 2), dict(n_req=1024)), ((6, 3), dict(seed=3))):
        got, n = adapt_burst_events(*args, **kw)
        want, m = bench._adapt_burst_events(*args, **kw)
        assert n == m and len(got) == len(want)
        for a, b in zip(got, want):
            sa, sb = a.span, b.span
            assert (sa.trace_id, sa.sid, sa.start_mus, sa.duration_mus, sa.op_name,
                    list(sa.references), sa.process_id, sa.span_kind, a.event_us,
                    a.arrival_us, a.trace_id, a.processes, a.capture_us) == (
                sb.trace_id, sb.sid, sb.start_mus, sb.duration_mus, sb.op_name,
                list(sb.references), sb.process_id, sb.span_kind, b.event_us,
                b.arrival_us, b.trace_id, b.processes, b.capture_us)


@pytest.mark.gpu
def test_adapt_refit_on_card():
    """The refit rung on the card: its solve launches K1 and the assembly
    kernel on the service's device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.ops import cuda_sinkhorn, scores
    from traceweaver_tpu_torch.stream import (
        IterableSource,
        StreamConfig,
        StreamingReconstructor,
    )

    events, _ = adapt_burst_events(8, shift_at=99)
    svc = StreamingReconstructor(IterableSource(events), StreamConfig(
        window_us=1e6, overlap_us=0.0, ooo_bound_us=1e3, verbose=False),
        adapt=AdaptationController(), drift_window=64)
    svc.run()
    svc.adapt.observe("frontend", psi=9.9, low_rate=1.0)
    k1, asm = cuda_sinkhorn.LAUNCHES["fused_assign"], scores.LAUNCHES["assemble_block"]
    assert svc.maybe_adapt() == 1
    assert cuda_sinkhorn.LAUNCHES["fused_assign"] > k1
    assert scores.LAUNCHES["assemble_block"] > asm


def test_cli_serve_adapt_flags_arm_every_tenant(tmp_path, monkeypatch):
    """``cli serve --adapt`` (with its knobs) builds a service whose
    tenants carry a controller; without the flag none does."""
    import traceweaver_tpu_torch.serve as serve_pkg
    from traceweaver_tpu_torch.runtime import cli

    served = []
    monkeypatch.setattr(serve_pkg, "run_server",
                        lambda service, host, port, verbose=True: served.append(service))
    base = ["serve", "--port", "0", "--device", "cpu", "--quiet", "--no-continuous"]
    assert cli.main(base + ["--state-dir", str(tmp_path / "a"), "--adapt",
                            "--adapt_probation", "3", "--adapt_cooldown_s", "5",
                            "--adapt_low_rate", "0.4", "--conf_drift_window", "64"]) == 0
    assert cli.main(base + ["--state-dir", str(tmp_path / "b")]) == 0
    on, off = served
    t = on.tenant("t")
    assert on.cfg.adapt and t.svc.drift.window == 64
    assert (t.svc.adapt.probation, t.svc.adapt.cooldown_s, t.svc.adapt.low_rate) == (3, 5.0, 0.4)
    assert off.tenant("t").svc.adapt is None and not off.cfg.adapt
    on.drain()
    off.drain()
