"""The port's streaming reconstructor against the JAX package's (CPU).

Without the solver, on the same seeded inputs: the watermark, the
windowing engine (ownership, covering windows, late reroute and drop,
grace), the scheduler's backpressure, the checkpoint file format (CRC
trailer, ``.prev`` fallback, corruption), the ``checkpoint`` and
``source`` fault sites; counters and window keys must match exactly,
checkpoint bytes too.

With the solver, on JAX's own 40-trace fixture (the synthesized Alibaba
corpus, seed 7, fix 5): the same windows and ``consumed`` / ``late_*`` /
``shed_*`` counters, >= 99% equal assignment rows
(``ops/compare.pair_agreement``), streamed end-to-end accuracy within
0.5 pt of JAX's, kill/resume byte identity of the port's sink, a
checkpoint resumed under the other precision, the ``stream`` CLI with
``--device cpu``, and the port's streamed accuracy at least its batch
accuracy less 2 pt (the JAX package's own bar).

The ``gpu`` test runs the first two windows of config ``stream-cg-8k``
on the card (run with ``--noconftest``: this module imports JAX only
inside the CPU tests).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.spans import Span

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
gpu = pytest.mark.gpu


def _jax():
    """The JAX package's stream modules (its executor first: a cold
    ``traceweaver_tpu.ingest`` import is circular)."""
    import traceweaver_tpu.runtime.executor  # noqa: F401
    import traceweaver_tpu.stream as js

    return js


def _spans(mod_span, times, kind="server"):
    return [mod_span(f"t{i}", f"s{i}", float(t), 10.0, None, [], "p", kind)
            for i, t in enumerate(times)]


# ---------------------------------------------------------------------------
# windowing, watermark, scheduler, checkpoint, faults (no solver)
# ---------------------------------------------------------------------------

def test_watermark_matches_jax():
    from traceweaver_tpu_torch.stream import WatermarkTracker

    js = _jax()
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0, 100, 500)) + rng.uniform(-300, 300, 500)
    ours, ref = WatermarkTracker(bound_us=120.0), js.WatermarkTracker(bound_us=120.0)
    assert ours.value == ref.value == float("-inf")
    for t in times:
        assert ours.observe(float(t)) == ref.observe(float(t))
        assert ours.value == ref.value
        assert ours.delay_of(float(t) - 50) == ref.delay_of(float(t) - 50)
    assert (ours.n_events, ours.n_late, ours.max_skew_us) == (
        ref.n_events, ref.n_late, ref.max_skew_us)
    assert ours.n_late > 0


def _drive_windows(engine_cls, span_cls, wm_cls, events, size, overlap, grace, bound):
    eng = engine_cls(size_us=size, overlap_us=overlap, grace_us=grace)
    wm = wm_cls(bound_us=bound)
    outcomes, sealed = [], []
    for i, t in events:
        wm.observe(t)
        outcomes.append(eng.add(span_cls(f"t{i}", f"s{i}", t, 10.0, None, [],
                                         "p", "server"), t))
        sealed.extend(eng.poll(wm.value))
    sealed.extend(eng.flush())
    wins = [(b.k, b.start_us, b.end_us, b.n_spans, sorted(b.owned_ids),
             b.seal_delay_us, [s.GetId() for s in b.roots]) for b in sealed]
    return outcomes, wins, (eng.late_rerouted, eng.late_dropped)


@pytest.mark.parametrize("overlap,grace,bound,jitter", [
    (200.0, 0.0, 100.0, 100.0),     # jitter within the watermark bound
    (0.0, 0.0, 10.0, 600.0),        # tight watermark: late reroutes and drops
    (300.0, 400.0, 10.0, 2000.0),   # grace keeps windows open past the mark
])
def test_windowing_matches_jax(overlap, grace, bound, jitter):
    """Seeded out-of-order arrivals through both engines: the same
    outcome per span, the same sealed windows (key, range, spans, owned
    ids, seal delay, owned roots) and the same late counters."""
    from traceweaver_tpu_torch.stream import WatermarkTracker, WindowingEngine

    js = _jax()
    from traceweaver_tpu.spans import Span as JSpan

    rng = np.random.default_rng(int(overlap + grace + bound))
    t = np.arange(0, 6000, 25, dtype=np.float64)
    arrival = t + rng.uniform(0, jitter, t.size)
    events = [(int(i), float(t[i])) for i in np.argsort(arrival, kind="stable")]
    ours = _drive_windows(WindowingEngine, Span, WatermarkTracker, events,
                          1000.0, overlap, grace, bound)
    ref = _drive_windows(js.WindowingEngine, JSpan, js.WatermarkTracker, events,
                         1000.0, overlap, grace, bound)
    assert ours == ref
    outcomes, wins, late = ours
    owned = sum(len(w[4]) for w in wins)
    assert owned + late[1] == len(events)  # conservation
    if jitter > bound:
        assert sum(late) > 0


def test_geometry_matches_jax():
    from traceweaver_tpu_torch.stream import WindowingEngine

    js = _jax()
    ours = WindowingEngine(size_us=1000.0, overlap_us=200.0)
    ref = js.WindowingEngine(size_us=1000.0, overlap_us=200.0)
    for t in np.random.default_rng(0).uniform(0, 1e5, 200):
        assert ours.owner_of(t) == ref.owner_of(t)
        assert ours.covering(t) == ref.covering(t)
    assert ours.covering(850.0) == [0, 1] and ours.owner_of(850.0) == 1
    with pytest.raises(ValueError):
        WindowingEngine(size_us=1000.0, overlap_us=1000.0)


def test_late_reroute_drop_and_grace():
    """The JAX package's unit sequence (``tests/test_stream.py``) on the
    port's engine: reroute into the earliest open window, drop with
    nothing open, and grace keeps a window open past the watermark."""
    from traceweaver_tpu_torch.stream import WindowingEngine

    def sp(i, t):
        return Span(f"t{i}", f"s{i}", t, 10.0, None, [], "p", "server")

    eng = WindowingEngine(size_us=1000.0, overlap_us=0.0)
    eng.add(sp(0, 100.0), 100.0)
    eng.add(sp(1, 1500.0), 1500.0)
    assert [b.k for b in eng.poll(1400.0)] == [0]
    assert eng.add(sp(2, 50.0), 50.0) == "late_rerouted"
    assert ("t2", "s2") in eng.open[1].owned_ids
    assert [b.k for b in eng.poll(5000.0)] == [1]
    assert eng.add(sp(3, 60.0), 60.0) == "late_dropped"
    assert (eng.late_rerouted, eng.late_dropped) == (1, 1)

    eng = WindowingEngine(size_us=1000.0, overlap_us=0.0, grace_us=500.0)
    eng.add(sp(0, 100.0), 100.0)
    assert eng.poll(1400.0) == []
    assert eng.add(sp(1, 200.0), 200.0) == "ok"
    sealed = eng.poll(1600.0)
    assert [b.k for b in sealed] == [0] and sealed[0].n_owned == 2


def _offer_pump(sched_cls, buf_cls, span_cls, sizes, throttle):
    solved = []

    def solve(batch):
        solved.append([b.k for b in batch])
        return [b.k for b in batch]

    sched = sched_cls(solve, max_pending=2, spill_max=3)
    outcomes = []
    for k, n in enumerate(sizes):
        b = buf_cls(k, 0.0, 1.0)
        for i in range(n):
            b.add(span_cls(f"t{k}_{i}", "s", float(i), 1.0, None, [], "p",
                           "server"), owned=True)
        outcomes.append(sched.offer(b))
        if throttle and k % 3 == 2:
            outcomes.append(sched.pump(max_batches=1))
    outcomes.append(sched.pump())
    return (outcomes, solved, sched.shed_spilled, sched.shed_dropped_windows,
            sched.shed_dropped_spans, sched.solved_windows, sched.backlog)


@pytest.mark.parametrize("throttle", [False, True])
def test_backpressure_matches_jax(throttle):
    """Spill and drop accounting of a throttled consumer, offer by offer."""
    from traceweaver_tpu_torch.stream import MicroBatchScheduler, WindowBuffer

    js = _jax()
    from traceweaver_tpu.spans import Span as JSpan

    sizes = list(np.random.default_rng(5).integers(1, 9, 12))
    ours = _offer_pump(MicroBatchScheduler, WindowBuffer, Span, sizes, throttle)
    ref = _offer_pump(js.MicroBatchScheduler, js.WindowBuffer, JSpan, sizes,
                      throttle)
    assert ours == ref
    assert ours[3] > 0  # something was dropped, counted


def test_scheduler_poisons_after_retries():
    """A batch whose solve keeps failing transiently is handed to the
    poison constructor after the retry budget; a bug propagates."""
    from traceweaver_tpu_torch.runtime import faults
    from traceweaver_tpu_torch.stream import MicroBatchScheduler, WindowBuffer

    def failing(batch):
        raise faults.FaultError("injected")

    sched = MicroBatchScheduler(failing, max_pending=2, solve_retries=2,
                                poison_fn=lambda bs, e: [("poison", b.k) for b in bs])
    sched.offer(WindowBuffer(0, 0.0, 1.0))
    sched.offer(WindowBuffer(1, 0.0, 1.0))
    assert sched.pump() == [("poison", 0), ("poison", 1)]
    assert (sched.solve_retried, sched.poisoned_windows) == (2, 2)

    def buggy(batch):
        raise TypeError("a bug")

    sched = MicroBatchScheduler(buggy, poison_fn=lambda bs, e: [])
    sched.offer(WindowBuffer(0, 0.0, 1.0))
    with pytest.raises(TypeError):
        sched.pump()


def test_checkpoint_format_matches_jax(tmp_path):
    """The same state writes the same bytes (pickle plus CRC trailer);
    the ``.prev`` rotation, the fallback on a corrupt or truncated
    primary, the fatal double corruption and a version-1 file behave as
    the JAX package's."""
    from traceweaver_tpu_torch.stream import checkpoint as ck

    js = _jax()
    from traceweaver_tpu.stream import checkpoint as jck

    state = dict(consumed=17, stats={"a": 1.5}, arr=np.arange(5.0))
    ours, ref = str(tmp_path / "ours.pkl"), str(tmp_path / "ref.pkl")
    for gen in (1, 2):
        ck.save_checkpoint(ours, dict(state, gen=gen))
        jck.save_checkpoint(ref, dict(state, gen=gen))
    for suffix in ("", ".prev"):
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read()
    assert ck.load_checkpoint(ours)["gen"] == 2
    # flip a byte of the primary: CRC mismatch, fallback to .prev, flagged
    raw = bytearray(open(ours, "rb").read())
    raw[10] ^= 0xFF
    open(ours, "wb").write(bytes(raw))
    got = ck.load_checkpoint(ours)
    assert got["gen"] == 1 and got["_recovered_from_prev"]
    with pytest.raises(ck.CheckpointCorrupt):
        ck.verify_checkpoint_bytes(bytes(raw))
    # truncated primary: the trailer is gone and the pickle cannot load
    open(ours, "wb").write(bytes(raw[:40]))
    assert ck.load_checkpoint(ours)["gen"] == 1
    # both generations bad: fatal
    open(ours + ".prev", "wb").write(b"garbage")
    with pytest.raises(ck.CheckpointCorrupt):
        ck.load_checkpoint(ours)
    # version 1: a bare pickle with no trailer
    v1 = str(tmp_path / "v1.pkl")
    with open(v1, "wb") as f:
        pickle.dump(dict(state, version=1), f)
    assert ck.load_checkpoint(v1)["consumed"] == 17
    assert (ck.CHECKPOINT_VERSION, ck._TRAILER.size) == (
        jck.CHECKPOINT_VERSION, jck._TRAILER.size)


def test_fault_sites_and_overrides():
    """``checkpoint`` and ``source`` are sites; ``override`` and
    ``override_plan`` put a plan in force and restore the one before;
    one plan kept across entries keeps its draw position."""
    from traceweaver_tpu_torch.runtime import faults
    from traceweaver_tpu_torch.stream import checkpoint as ck

    assert {"checkpoint", "source"} <= set(faults.SITES)
    assert faults.active() is None
    with faults.override("checkpoint:1.0:max=1") as plan:
        assert faults.active() is plan
        with pytest.raises(faults.FaultError):
            ck.save_checkpoint("/nonexistent/never/written.pkl", {})
        assert plan.injected == {"checkpoint": 1}
    assert faults.active() is None
    plan = faults.parse_faults("source:0.5", seed=3)
    draws = []
    for _ in range(4):
        with faults.override_plan(plan):
            draws.append(plan.should_fail("source"))
    ref = faults.parse_faults("source:0.5", seed=3)
    assert draws == [ref.should_fail("source") for _ in range(4)]


def _server_only_events(mod):
    """A no-solve stream (server spans only: no service has calls to
    reconstruct), for the source fault site."""
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0, 50e6, 300))
    return [mod.SpanEvent(span=s, event_us=s.start_mus, arrival_us=s.start_mus,
                          trace_id=s.trace_id, processes={"p": "svc"})
            for s in _spans(mod_span_of(mod), t)]


def mod_span_of(mod):
    if mod.__name__.startswith("traceweaver_tpu_torch"):
        return Span
    from traceweaver_tpu.spans import Span as JSpan

    return JSpan


def test_source_fault_site_matches_jax():
    """Injected source-read faults retry the same position: the same
    seeded plan gives the port the JAX package's retry count, and every
    event is consumed once."""
    from traceweaver_tpu_torch.runtime import faults
    from traceweaver_tpu_torch.stream import (
        IterableSource,
        StreamConfig,
        StreamingReconstructor,
    )
    import traceweaver_tpu_torch.stream.sources as ps

    js = _jax()
    from traceweaver_tpu.runtime import faults as jfaults
    import traceweaver_tpu.stream.sources as jsrc

    cfg = dict(window_us=10e6, overlap_us=2e6, ooo_bound_us=0.0, verbose=False)
    with faults.override("source:0.3", seed=4):
        ours = StreamingReconstructor(IterableSource(_server_only_events(ps)),
                                      StreamConfig(**cfg), device="cpu").run()
    with jfaults.override("source:0.3", seed=4):
        ref = js.StreamingReconstructor(
            jsrc.IterableSource(_server_only_events(jsrc)),
            js.StreamConfig(**cfg)).run()
    assert ours["faults"]["source_read_retries"] > 0
    for key in ("consumed", "emitted_windows", "late_rerouted", "late_dropped"):
        assert ours[key] == ref[key], key
    assert ours["faults"]["source_read_retries"] == ref["faults"]["source_read_retries"]
    assert ours["consumed"] == 300


# ---------------------------------------------------------------------------
# the service on JAX's 40-trace fixture (solver in the loop)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    root = tmp_path_factory.mktemp("stream_corpus")
    (d,) = synthesize_corpus(str(root / "cg"), n_graphs=1, traces_per_graph=40,
                             seed=7)
    return d


def _cfg(mod, **kw):
    base = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=1e6, grace_us=0.0,
                checkpoint_every=10_000, verbose=False)
    base.update(kw)
    return mod.StreamConfig(**base)


def _source(mod, d):
    return mod.parse_source_spec(f"replay:{d}?fix=5&max_traces=40&ooo_ms=50&seed=1")


def _port_run(d, sink=None, **kw):
    import traceweaver_tpu_torch.stream as ps

    svc = ps.StreamingReconstructor(_source(ps, d), _cfg(ps, **kw),
                                    sink=ps.TraceSink(sink) if sink else None,
                                    device="cpu")
    summary = svc.run()
    if svc.sink:
        svc.sink.close()
    return svc, summary


@pytest.fixture(scope="module")
def both_runs(corpus, tmp_path_factory):
    """One JAX run and one port run of the fixture, with their sinks."""
    js = _jax()
    out = tmp_path_factory.mktemp("sinks")
    jsvc = js.StreamingReconstructor(_source(js, corpus), _cfg(js),
                                     sink=js.TraceSink(str(out / "jax.jsonl")))
    jsum = jsvc.run()
    jsvc.sink.close()
    _, psum = _port_run(corpus, str(out / "port.jsonl"))
    return (jsum, str(out / "jax.jsonl")), (psum, str(out / "port.jsonl"))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_stream_matches_jax(both_runs):
    """Same windows and counters, >= 99% equal assignment rows, streamed
    accuracy within 0.5 pt."""
    from traceweaver_tpu_torch.ops.compare import pair_agreement

    (jsum, jpath), (psum, ppath) = both_runs
    for key in ("consumed", "emitted_windows", "late_rerouted", "late_dropped",
                "shed_spilled", "shed_dropped_windows", "shed_dropped_spans",
                "deadletter_windows"):
        assert psum[key] == jsum[key], key
    assert psum["stats"]["spans_emitted"] == jsum["stats"]["spans_emitted"]
    jrec, prec = _records(jpath), _records(ppath)
    assert [r["window"] for r in prec] == [r["window"] for r in jrec]
    assert len(prec) >= 4

    def rows(recs):
        out = {}
        for r in recs:
            for svc, eps in r["services"].items():
                for ep, pairs in eps.items():
                    for i, o in pairs:
                        out.setdefault(f"{svc}|{ep}", {})[tuple(i)] = tuple(o)
        return out

    assert pair_agreement(rows(prec), rows(jrec)) >= 0.99
    assert [sorted(r["traces"]) for r in prec] == [sorted(r["traces"]) for r in jrec]
    assert abs(psum["accuracy"]["e2e"] - jsum["accuracy"]["e2e"]) <= 0.5
    assert psum["accuracy"]["skipped_services"] == jsum["accuracy"]["skipped_services"]
    # every emitted trace carries its confidence summary
    assert all("tw.confidence" in r for r in prec if r["traces"])
    assert psum["launches"] == {"fused_assign": 0, "assemble_block": 0}  # the CPU
    assert psum["stats"]["micro_batches"] == jsum["stats"]["micro_batches"]


def test_conservation_under_lateness(corpus):
    """Heavy out-of-order arrival against a tight watermark: every span
    is emitted once or counted late-dropped."""
    _, s = _port_run(corpus, overlap_us=0.0, ooo_bound_us=1e4)
    assert s["consumed"] == 600
    assert s["stats"].get("spans_emitted", 0) + s["late_dropped"] == s["consumed"]


def test_kill_resume_byte_identical(corpus, both_runs, tmp_path):
    """Kill after three windows (beyond the checkpoint at two), resume in
    a fresh object from the checkpoint: the sink equals the
    uninterrupted run's byte for byte, and so does the accuracy."""
    import traceweaver_tpu_torch.stream as ps

    (_, _), (golden_sum, golden_path) = both_runs
    golden = open(golden_path, "rb").read()
    ckpt, out = str(tmp_path / "ck.pkl"), str(tmp_path / "out.jsonl")
    svc = ps.StreamingReconstructor(
        _source(ps, corpus), _cfg(ps, checkpoint_path=ckpt, checkpoint_every=2),
        sink=ps.TraceSink(out), device="cpu")
    partial = svc.run(max_windows=3)
    svc.sink.close()
    assert not partial["final"] and os.path.exists(ckpt)
    assert 0 < os.path.getsize(out) < len(golden)
    resumed = ps.StreamingReconstructor.resume(ckpt, _source(ps, corpus),
                                               device="cpu")
    summary = resumed.run()
    resumed.sink.close()
    assert open(out, "rb").read() == golden
    assert summary["accuracy"] == golden_sum["accuracy"]


def test_checkpoint_precision_portable(corpus, both_runs, tmp_path):
    """An f32 checkpoint resumes under bf16 and a bf16 one under f32:
    the runs finish, conserve spans and stay within 2 pt of f32."""
    import traceweaver_tpu_torch.stream as ps

    (_, _), (golden, _) = both_runs
    for first, second in (("f32", "bf16"), ("bf16", "f32")):
        ckpt = str(tmp_path / f"{first}.pkl")
        svc = ps.StreamingReconstructor(
            _source(ps, corpus), _cfg(ps, checkpoint_path=ckpt, checkpoint_every=2),
            sink=ps.TraceSink(str(tmp_path / f"{first}.jsonl")), device="cpu",
            precision=first)
        svc.run(max_windows=3)
        svc.sink.close()
        resumed = ps.StreamingReconstructor.resume(
            ckpt, _source(ps, corpus), device="cpu", precision=second)
        s = resumed.run()
        resumed.sink.close()
        assert s["final"] and s["precision"] == second
        assert s["stats"].get("spans_emitted", 0) + s["late_dropped"] == s["consumed"]
        assert (s["consumed"], s["emitted_windows"]) == (
            golden["consumed"], golden["emitted_windows"])
        assert s["accuracy"]["e2e"] >= golden["accuracy"]["e2e"] - 2.0


def test_streamed_vs_batch_and_warm_start(corpus, both_runs):
    """The port's streamed accuracy is at least its batch executor's
    (predictor 10, same store) less 2 pt, and later windows warm-start
    (single-pass groups)."""
    import traceweaver_tpu_torch.stream as ps
    from traceweaver_tpu_torch.runtime.cli import batch_accuracy
    from traceweaver_tpu_torch.runtime.executor import ExecutorConfig, run_experiment

    (_, _), (psum, _) = both_runs
    source = _source(ps, corpus)
    batch = run_experiment(ExecutorConfig(
        data_path="", results_directory="", fix=5, cache_rate=0.0,
        test_name="streamcmp", predictor_indices=[10], device="cpu"),
        store=source.store).accuracy_overall["MaxScoreBatchSubsetWithSkips"]
    # what ``stream --compare_batch`` prints
    assert batch_accuracy(source.store, 5, "cpu", "f32") == batch
    assert psum["accuracy"]["e2e"] >= batch - 2.0
    assert psum["fleet"].get("fleet_dynamism_dispatches", 0) > 0


def test_cli_stream_cpu(corpus, tmp_path):
    """``cli stream --device cpu`` end to end in a subprocess, with a
    checkpoint, the self-trace and the batch comparison."""
    out, journey = str(tmp_path / "cli.jsonl"), str(tmp_path / "journey.json")
    res = subprocess.run(
        [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "stream",
         "--source", f"replay:{corpus}?fix=5", "--max_traces", "40",
         "--window_s", "20", "--overlap_s", "4", "--watermark_s", "1",
         "--ooo_ms", "50", "--out", out, "--checkpoint", str(tmp_path / "ck.pkl"),
         "--checkpoint_every", "2", "--selftrace", journey, "--device", "cpu",
         "--compare_batch"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert "[stream] win=" in res.stdout and "prec=f32" in res.stdout
    assert "[stream] done [f32]:" in res.stdout
    assert "streamed end-to-end accuracy" in res.stdout
    assert "[stream] batch executor on identical input:" in res.stdout
    lines = open(out).readlines()
    assert len(lines) >= 4
    json.loads(lines[0])
    payload = json.load(open(journey))
    assert len(payload["data"]) == len(lines)
    stages = {s["operationName"] for t in payload["data"] for s in t["spans"]}
    assert {"ingest", "seal", "pack", "dispatch", "decode", "emit"} <= stages


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_no_card_and_collector_raise(monkeypatch, corpus):
    import traceweaver_tpu_torch.stream as ps
    from traceweaver_tpu_torch.runtime import cli

    with pytest.raises(ValueError, match="collector"):
        ps.parse_source_spec("collector:/tmp/x.log")
    with pytest.raises(ValueError, match="unknown source"):
        ps.parse_source_spec("kafka:topic")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.StreamingReconstructor(ps.IterableSource([]))
    assert cli.main(["stream", "--source", f"replay:{corpus}?fix=5"]) != 0
    assert cli.main(["stream", "--source", "collector:/tmp/x.log",
                     "--device", "cpu"]) != 0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@gpu
def test_stream_cg8k_two_windows_on_card(tmp_path):
    """The first two windows of config ``stream-cg-8k`` on the card: K1
    and the assembly kernel launch, and the assignments agree with the
    same two windows on the CPU on >= 99% of the pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import traceweaver_tpu_torch.stream as ps
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ops.compare import pair_agreement

    (d,) = synthesize_corpus(str(tmp_path / "cg"), n_graphs=1,
                             traces_per_graph=8192, seed=10, base_gap_ms=20)
    spec = f"replay:{d}?fix=5&max_traces=8192&ooo_ms=50&seed=1"
    cfg = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6, grace_us=0.0,
               max_pending=4, verbose=False)
    preds = {}
    for device in ("cuda", "cpu"):
        svc = ps.StreamingReconstructor(ps.parse_source_spec(spec),
                                        ps.StreamConfig(**cfg), device=device)
        s = svc.run(max_windows=2)
        assert s["emitted_windows"] == 2
        if device == "cuda":
            assert s["launches"]["fused_assign"] > 0
            assert s["launches"]["assemble_block"] > 0
        preds[device] = {f"{svc_}|{ep}": m for svc_, by_ep in svc.grader.pred.items()
                         for ep, m in by_ep.items()}
    assert pair_agreement(preds["cuda"], preds["cpu"]) >= 0.99
